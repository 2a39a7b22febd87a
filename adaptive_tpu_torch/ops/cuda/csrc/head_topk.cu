// Hopper (sm_90a) top-W vocab head of one beam decode step of the
// adaptive-attention captioner. Built with fused_step.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_step.py::beam_head_topk, whose plain twin
// beam_head_topk_plain defines the arithmetic.
//
// 4. head_topk_kernel + head_topk_reduce replace adaptive_tpu/ops/pallas/
//    fused_step.py::beam_head_topk (body _head_topk_kernel): for each row,
//    the top-W values and vocab ids of (chat + h) @ W + b over the real
//    vocab, equal values ranked by the lower id (as lax.top_k), and the
//    row's logsumexp; the logits are never stored.
//    Bound on an H100 SXM at 3072 rows (batch 1024, beam 3), bf16: 32.2 GFLOP
//    -> ~33 us at the bf16 tensor peak (989 TFLOP/s), against ~10.5 MB of
//    weight and ~3 MB of rows, which the bytes bound far below.
//    Design: the TPU kernel carries a running top-W list and logsumexp across
//    a sequential grid of 1280-wide chunks. Hopper's blocks run in no order,
//    so it is built like the greedy head (fused_step.cu, kernel 2):
//    pass 1 tiles the product (64 rows x 128 vocab columns a block, fp32 FMAs
//    on the CUDA cores, the same tile as kernel 2) and writes, for each row
//    and tile, the tile's top-W (value, id) list in rank order and the tile's
//    (max, sum exp(v - max)); pass 2 gives each row one warp, which folds the
//    logsumexp partials (m' = max(m, m_t), s' = s e^(m - m') + s_t e^(m_t - m'))
//    and selects the row's top-W from the tiles' lists. Both passes select by
//    rounds: round k takes the best (value, id) ranked below round k-1's
//    pick in the order (value desc, id asc). Ids are distinct, so that order
//    is total and the result is exactly a stable descending sort's first W,
//    whatever order the lists are scanned in. A tile holds 128 columns, so
//    W <= 128 (the wrapper refuses more). The SIMT product is far from the
//    tensor-core bound; mma/wgmma is later work.

#include "kernel_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ID = 0x7fffffff;
constexpr int REDUCE_THREADS = 256;  // pass 2: one warp per row

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (v, i) ranks below the previous pick (pv, pi) and above the best so far
__device__ __forceinline__ void take_next(float v, int i, float pv, int pi, float& bv,
                                          int& bi) {
  if (better(pv, pi, v, i) && better(v, i, bv, bi)) { bv = v; bi = i; }
}

// pass 1: per (row, tile) the tile's top-Wk list and logsumexp partial
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

// pass 2: one warp per row folds the logsumexp and selects the top-Wk
__global__ void __launch_bounds__(REDUCE_THREADS)
head_topk_reduce(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 const float* __restrict__ part_ms, float* __restrict__ topv,
                 int* __restrict__ topi, float* __restrict__ lse, int B, int ntiles,
                 int Wk) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (REDUCE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp

  // logsumexp: lane l folds tiles l, l + 32, ... in vocab order, then the
  // lanes' partials fold by a butterfly (exp(NEG - m) = 0 drops masked tiles)
  float m = NEG, s = 0.f;
  for (int t = lane; t < ntiles; t += 32) {
    const float* p = part_ms + 2 * ((size_t)row * ntiles + t);
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

  const size_t base = (size_t)row * ntiles * Wk;
  const int n = ntiles * Wk;
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
  const int rows_per_block = REDUCE_THREADS / 32;
  head_topk_reduce<<<(B + rows_per_block - 1) / rows_per_block, REDUCE_THREADS, 0, stream>>>(
      (const float*)part_v, (const int*)part_i, (const float*)part_ms, (float*)topv,
      (int*)topi, (float*)lse, B, Vp / BN, Wk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. B rows, Wk in [1, 128] (checked by the
// wrapper). Returns cudaGetLastError() after the two launches.
int head_topk_launch(int dtype, const void* chat, const void* h, const void* W,
                     const void* b, void* part_v, void* part_i, void* part_ms,
                     void* topv, void* topi, void* lse, int B, int H, int Vp,
                     int vocab_len, int Wk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_topk<float>(chat, h, W, b, part_v, part_i, part_ms, topv, topi, lse,
                              B, H, Vp, vocab_len, Wk, st);
  return launch_topk<__nv_bfloat16>(chat, h, W, b, part_v, part_i, part_ms, topv, topi,
                                    lse, B, H, Vp, vocab_len, Wk, st);
}

}  // extern "C"
