// Hopper (sm_90a) top-W vocab head of one beam decode step of the
// adaptive-attention captioner. Built with fused_step.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_step.py::beam_head_topk, whose plain twin
// beam_head_topk_plain defines the arithmetic.
//
// 4. head_topk_mma_kernel (bf16) or head_topk_kernel (fp32), then
//    head_topk_reduce, replace adaptive_tpu/ops/pallas/fused_step.py::
//    beam_head_topk (body _head_topk_kernel): for each row, the top-W values
//    and vocab ids of (chat + h) @ W + b over the real vocab, equal values
//    ranked by the lower id (as lax.top_k), and the row's logsumexp; the
//    logits are never stored.
//    Bound on an H100 SXM at 3072 rows (batch 1024, beam 3), bf16: 32.2 GFLOP
//    -> ~33 us at the bf16 tensor peak (989 TFLOP/s), against ~10.5 MB of
//    weight and ~3 MB of rows, which the bytes bound far below.
//    Design (bf16): the TPU kernel carries a running top-W list and
//    logsumexp across a sequential grid of 1280-wide chunks. Hopper's blocks
//    run in no order, so a block owns a band of rows and a split of the
//    vocab (24 bands of 128 rows x 5 splits of 2048 columns at 3072 rows:
//    one wave of the 132 SMs), forms z = chat + h once for its band, and
//    walks over its split's 128-column tiles with the tensor-core band of
//    kernel_common.cuh (wgmma by two warpgroups of 64 rows on a 4-stage ring
//    that a producer warp fills with bulk asynchronous copies of the tiled
//    weight). After a tile's last k-block the warpgroup's selection runs on
//    its accumulators, under the other warpgroup's products, and what it
//    carries across the split's tiles is, a row:
//      * (max, sum exp(v - max)) of each thread's own columns, folded over
//        the row's four lanes only at the end;
//      * the running top-W list, sorted in the order of better(), in shared
//        memory. A tile's values enter it by extraction: the four lanes find
//        the best value left in the tile; if it ranks above the list's last
//        entry it is inserted at its rank (entries below move down one, four
//        a turn from the end) and struck from the tile; the warp goes on
//        until no row of its 16 has such a value. Ids are distinct, so the
//        order is total and the list is exactly a stable descending sort's
//        first W of the columns seen so far, whatever the split.
//    One list and one (max, sum) a row and split go to device memory. Pass 2
//    gives each row one warp, which folds the logsumexp partials (m' =
//    max(m, m_t), s' = s e^(m - m') + s_t e^(m_t - m')) and selects the
//    row's top-W from the splits' lists by rounds: round k takes the best
//    (value, id) ranked below round k-1's pick.
//    The band's z (128 KB at H = 512 and 128 rows) and the ring leave room
//    for lists up to W = 32 at 128 rows; wider lists (W <= 128, a 128-column
//    tile fills one) run the same kernel with one warpgroup and 64 rows a
//    block. fp32 has no exact tensor-core product: its instance keeps the
//    SIMT tile with one list a row and tile, bounded by the CUDA cores'
//    67 TFLOP/s (0.48 ms at 3072 rows), and is not on the bf16 main path.

#include "kernel_common.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;  // pass 2: one warp per row

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (v, i) ranks below the previous pick (pv, pi) and above the best so far
__device__ __forceinline__ void take_next(float v, int i, float pv, int pi, float& bv,
                                          int& bi) {
  if (better(pv, pi, v, i) && better(v, i, bv, bi)) { bv = v; bi = i; }
}

// pass 1, SIMT instance: per (row, tile) the tile's top-Wk list and
// logsumexp partial
template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
head_topk_kernel(const T* __restrict__ chat, const T* __restrict__ h,  // [B, H]
                 const T* __restrict__ W,                              // [H, Vp]
                 const T* __restrict__ bias,                           // [Vp]
                 float* __restrict__ part_v,   // [B, Vp/BN, Wk]
                 int* __restrict__ part_i,     // [B, Vp/BN, Wk]
                 float* __restrict__ part_ms,  // [B, Vp/BN, 2] (max, sum exp)
                 int B, int H, int Vp, int vocab_len, int Wk) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 4 rows x 8 cols each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ntiles = Vp / BN;
  float acc[4][8];
  head_tile_product<T>(chat, h, W, B, H, Vp, m0, n0, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const bool write = tx == 0 && row < B;
    const size_t part = (size_t)row * ntiles + blockIdx.y;
    float v[8];
    float m = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + tx + 16 * j;
      v[j] = col < vocab_len ? acc[i][j] + to_f(bias[col]) : NEG;
      m = fmaxf(m, v[j]);
    }
    // the 16 threads that share this row are one half-warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += expf(v[j] - m);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (write) {
      part_ms[2 * part] = m;
      part_ms[2 * part + 1] = s;
    }

    float pv = pos_inf();
    int pi = -1;
    for (int k = 0; k < Wk; ++k) {
      float bv = -pos_inf();
      int bi = NO_ID;
#pragma unroll
      for (int j = 0; j < 8; ++j) take_next(v[j], n0 + tx + 16 * j, pv, pi, bv, bi);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        float ov = __shfl_xor_sync(FULL, bv, o);
        int oi = __shfl_xor_sync(FULL, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (write) {
        part_v[part * Wk + k] = bv;
        part_i[part * Wk + k] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

// ------------------------------------------------ tensor-core instance
constexpr int TOPK_STAGES = 4;

// list stride a row: odd, so that a warp's 8 rows fall in different banks
__host__ __device__ inline int list_stride(int Wk) { return Wk | 1; }

struct TopkEpilogue {
  const __nv_bfloat16* bias;
  int vocab_len, Wk, stride, q;  // q: the thread's place among its rows' 4 lanes
  float* Lv;  // the thread's two rows' lists: Lv[r * 8 * stride + k] (row r is
  int* Li;    // 8 rows below row 0), sorted by better()
  float m[2], s[2];

  // the quad inserts (xv, xi) into row r's list where take is set; every
  // lane of the warp runs this, since the quads meet in __syncwarp
  __device__ __forceinline__ void insert(int r, float xv, int xi, bool take) {
    float* lv = Lv + r * 8 * stride;
    int* li = Li + r * 8 * stride;
    int pos = 0;
    for (int k = q; k < Wk; k += 4) pos += better(lv[k], li[k], xv, xi);
    pos += __shfl_xor_sync(FULL, pos, 1);
    pos += __shfl_xor_sync(FULL, pos, 2);
    for (int base = (Wk - 1) & ~3; base >= 0; base -= 4) {
      const int k = base + q;
      const bool mv = take && k < Wk && k > pos;
      float tv = 0.f;
      int ti = 0;
      if (mv) { tv = lv[k - 1]; ti = li[k - 1]; }
      __syncwarp();
      if (mv) { lv[k] = tv; li[k] = ti; }
      __syncwarp();
    }
    if (take && q == 0) { lv[pos] = xv; li[pos] = xi; }
    __syncwarp();
  }

  __device__ __forceinline__ void tile(float (&acc)[64], int n0) {
    // logits of the tile in place: + bias, -1e30 past the real vocab
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 b = load2(bias + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = col + e < vocab_len;
        const float be = e ? b.y : b.x;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          acc[4 * j + 2 * r + e] = real ? acc[4 * j + 2 * r + e] + be : NEG;
      }
    }
    // the thread's own (max, sum exp) a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tm = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        tm = fmaxf(tm, fmaxf(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
      const float nm = fmaxf(m[r], tm);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sum += __expf(acc[4 * j + 2 * r] - nm) + __expf(acc[4 * j + 2 * r + 1] - nm);
      s[r] = s[r] * __expf(m[r] - nm) + sum;
      m[r] = nm;
    }
    // extraction: the tile's best value left, while some row's ranks above
    // its list's last entry
    float lastv[2];
    int lasti[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lastv[r] = Lv[r * 8 * stride + Wk - 1];
      lasti[r] = Li[r * 8 * stride + Wk - 1];
    }
    for (;;) {
      float bv[2];
      int bi[2];
      bool take[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bv[r] = -pos_inf();
        bi[r] = NO_ID;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // columns ascend: > keeps the lower id
            const float v = acc[4 * j + 2 * r + e];
            if (v > bv[r]) { bv[r] = v; bi[r] = n0 + 8 * j + 2 * q + e; }
          }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ov = __shfl_xor_sync(FULL, bv[r], o);
          const int oi = __shfl_xor_sync(FULL, bi[r], o);
          if (better(ov, oi, bv[r], bi[r])) { bv[r] = ov; bi[r] = oi; }
        }
        take[r] = better(bv[r], bi[r], lastv[r], lasti[r]);
      }
      if (!__any_sync(FULL, take[0] || take[1])) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        insert(r, bv[r], bi[r], take[r]);
        if (take[r]) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)  // struck by the lane that holds it
              if (n0 + 8 * j + 2 * q + e == bi[r]) acc[4 * j + 2 * r + e] = -pos_inf();
        }
        lastv[r] = Lv[r * 8 * stride + Wk - 1];
        lasti[r] = Li[r * 8 * stride + Wk - 1];
      }
    }
  }
};

// pass 1, tensor-core instance: per (row, split) the split's top-Wk list
// and logsumexp partial; NWG warpgroups, 64 NWG rows a block
template <int NWG>
__global__ void __launch_bounds__(NWG * WG_THREADS + PRODUCER_THREADS, 1)
head_topk_mma_kernel(const __nv_bfloat16* __restrict__ chat,
                     const __nv_bfloat16* __restrict__ h,     // [B, H]
                     const __nv_bfloat16* __restrict__ Wtiles,  // [Vp/128, KB, 128, 64]
                     const __nv_bfloat16* __restrict__ bias,  // [Vp]
                     float* __restrict__ part_v,   // [B, nsplit, Wk]
                     int* __restrict__ part_i,     // [B, nsplit, Wk]
                     float* __restrict__ part_ms,  // [B, nsplit, 2] (max, sum exp)
                     int B, int H, int vocab_len, int Wk, int ntiles, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int BAND = NWG * WG_ROWS;
  uint8_t* smem = align_1024(smem_raw);
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int m0 = blockIdx.y * BAND;
  const int tile0 = split * tiles_per_split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane & 3;
  const int stride = list_stride(Wk);
  // lists behind the band's z and the ring: values, then ids, [BAND][stride]
  float* lists_v = reinterpret_cast<float*>(smem + head_mma_smem_bytes(H, NWG, TOPK_STAGES) - 1024);
  int* lists_i = reinterpret_cast<int*>(lists_v + BAND * stride);
  // the thread's first row in the band (the producer warp has none)
  const int lrow = min(warp, NWG * 4 - 1) * 16 + (lane >> 2);
  TopkEpilogue epi{bias, vocab_len, Wk, stride, q, lists_v + lrow * stride,
                   lists_i + lrow * stride, {NEG, NEG}, {0.f, 0.f}};
  // a quad owns its two rows' lists from here to the end
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int k = q; k < Wk && warp < NWG * 4; k += 4) {
      epi.Lv[r * 8 * stride + k] = -pos_inf();
      epi.Li[r * 8 * stride + k] = NO_ID;
    }
  __syncwarp();
  if (!head_mma_band<NWG, TOPK_STAGES>(chat, h, Wtiles, B, H, m0, tile0,
                                       min(tiles_per_split, ntiles - tile0), smem, epi))
    return;  // the producer warp
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = epi.m[r], s = epi.s[r];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(FULL, m, o);
      const float os = __shfl_xor_sync(FULL, s, o);
      const float nm = fmaxf(m, om);
      s = s * expf(m - nm) + os * expf(om - nm);
      m = nm;
    }
    const int row = m0 + lrow + 8 * r;
    if (row >= B) continue;
    const size_t part = (size_t)row * nsplit + split;
    if (q == 0) {
      part_ms[2 * part] = m;
      part_ms[2 * part + 1] = s;
    }
    for (int k = q; k < Wk; k += 4) {
      part_v[part * Wk + k] = epi.Lv[r * 8 * stride + k];
      part_i[part * Wk + k] = epi.Li[r * 8 * stride + k];
    }
  }
}

// pass 2: one warp per row folds the logsumexp and selects the top-Wk
__global__ void __launch_bounds__(REDUCE_THREADS)
head_topk_reduce(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 const float* __restrict__ part_ms, float* __restrict__ topv,
                 int* __restrict__ topi, float* __restrict__ lse, int B, int nparts,
                 int Wk) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (REDUCE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp

  // logsumexp: lane l folds partials l, l + 32, ... in vocab order, then the
  // lanes' fold by a butterfly (exp(NEG - m) = 0 drops masked partials)
  float m = NEG, s = 0.f;
  for (int t = lane; t < nparts; t += 32) {
    const float* p = part_ms + 2 * ((size_t)row * nparts + t);
    float nm = fmaxf(m, p[0]);
    s = s * expf(m - nm) + p[1] * expf(p[0] - nm);
    m = nm;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float om = __shfl_xor_sync(FULL, m, o);
    float os = __shfl_xor_sync(FULL, s, o);
    float nm = fmaxf(m, om);
    s = s * expf(m - nm) + os * expf(om - nm);
    m = nm;
  }
  if (lane == 0) lse[row] = logf(s) + m;

  const size_t base = (size_t)row * nparts * Wk;
  const int n = nparts * Wk;
  float pv = pos_inf();
  int pi = -1;
  for (int k = 0; k < Wk; ++k) {
    float bv = -pos_inf();
    int bi = NO_ID;
    for (int c = lane; c < n; c += 32) take_next(part_v[base + c], part_i[base + c], pv, pi, bv, bi);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(FULL, bv, o);
      int oi = __shfl_xor_sync(FULL, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) {
      topv[(size_t)row * Wk + k] = bv;
      topi[(size_t)row * Wk + k] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

int launch_reduce(void* part_v, void* part_i, void* part_ms, void* topv, void* topi,
                  void* lse, int B, int nparts, int Wk, cudaStream_t stream) {
  const int rows_per_block = REDUCE_THREADS / 32;
  head_topk_reduce<<<(B + rows_per_block - 1) / rows_per_block, REDUCE_THREADS, 0, stream>>>(
      (const float*)part_v, (const int*)part_i, (const float*)part_ms, (float*)topv,
      (int*)topi, (float*)lse, B, nparts, Wk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_topk(const void* chat, const void* h, const void* W, const void* b,
                void* part_v, void* part_i, void* part_ms, void* topv, void* topi,
                void* lse, int B, int H, int Vp, int vocab_len, int Wk,
                cudaStream_t stream) {
  dim3 grid((B + BM - 1) / BM, Vp / BN);
  head_topk_kernel<T><<<grid, HEAD_THREADS, 0, stream>>>(
      (const T*)chat, (const T*)h, (const T*)W, (const T*)b, (float*)part_v,
      (int*)part_i, (float*)part_ms, B, H, Vp, vocab_len, Wk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part_v, part_i, part_ms, topv, topi, lse, B, Vp / BN, Wk, stream);
}

template <int NWG>
int launch_topk_mma(const void* chat, const void* h, const void* Wtiles, const void* b,
                    void* part_v, void* part_i, void* part_ms, void* topv, void* topi,
                    void* lse, int B, int H, int Vp, int vocab_len, int Wk, int nsplit,
                    int tiles_per_split, cudaStream_t stream) {
  constexpr int BAND = NWG * WG_ROWS;
  const size_t smem = head_mma_smem_bytes(H, NWG, TOPK_STAGES) +
                      (size_t)BAND * list_stride(Wk) * (sizeof(float) + sizeof(int));
  cudaError_t err = allow_smem((const void*)head_topk_mma_kernel<NWG>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nsplit, (B + BAND - 1) / BAND);
  head_topk_mma_kernel<NWG><<<grid, NWG * WG_THREADS + PRODUCER_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)chat, (const __nv_bfloat16*)h, (const __nv_bfloat16*)Wtiles,
      (const __nv_bfloat16*)b, (float*)part_v, (int*)part_i, (float*)part_ms, B, H,
      vocab_len, Wk, Vp / MMA_BN, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part_v, part_i, part_ms, topv, topi, lse, B, nsplit, Wk, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. B rows, Wk in [1, 128] (checked by the
// wrapper). Wtiles given: the tensor-core instance (bf16 only) over the tiled
// weight [Vp / 128, KB, 128, 64] with band_rows (128 or 64) rows a block and
// nsplit vocab splits of tiles_per_split 128-column tiles; Wtiles null: the
// SIMT instance over W [H, Vp], a split a tile (nsplit = Vp / 128). Partials
// [B, nsplit, ...]. Returns cudaGetLastError() after the two launches.
int head_topk_launch(int dtype, const void* chat, const void* h, const void* W,
                     const void* Wtiles, const void* b, void* part_v, void* part_i,
                     void* part_ms, void* topv, void* topi, void* lse, int B, int H,
                     int Vp, int vocab_len, int Wk, int nsplit, int tiles_per_split,
                     int band_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Wtiles != nullptr) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (band_rows == 2 * WG_ROWS)
      return launch_topk_mma<2>(chat, h, Wtiles, b, part_v, part_i, part_ms, topv, topi, lse,
                                B, H, Vp, vocab_len, Wk, nsplit, tiles_per_split, st);
    if (band_rows == WG_ROWS)
      return launch_topk_mma<1>(chat, h, Wtiles, b, part_v, part_i, part_ms, topv, topi, lse,
                                B, H, Vp, vocab_len, Wk, nsplit, tiles_per_split, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch_topk<float>(chat, h, W, b, part_v, part_i, part_ms, topv, topi, lse,
                              B, H, Vp, vocab_len, Wk, st);
  return launch_topk<__nv_bfloat16>(chat, h, W, b, part_v, part_i, part_ms, topv, topi,
                                    lse, B, H, Vp, vocab_len, Wk, st);
}

}  // extern "C"
