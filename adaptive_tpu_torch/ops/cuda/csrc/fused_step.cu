// Hopper (sm_90a) kernels of one greedy or beam decode step of the
// adaptive-attention captioner (the beam head's top-W is in head_topk.cu).
// Built by adaptive_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC
// and called through ctypes from adaptive_tpu_torch/ops/fused_step.py, whose
// plain PyTorch twins define the arithmetic these kernels must reproduce.
//
// 1. The decode cell replaces adaptive_tpu/ops/pallas/fused_step.py::
//    adaptive_decode_cell_fused (body _cell_kernel): the LSTM recurrence,
//    the visual sentinel and adaptive attention over K slots, for W = 1
//    (kernel 1) and for beam-major rows (kernel 3, W > 1: row r belongs to
//    image r / W, and V and pv come untiled, one copy per image).
//    bf16 with H and E2 multiples of 64 (ops/fused_step.py::cell_instance
//    "mma"): two kernels of cell_mma.cuh, started back to back by one call.
//    Stage 1 (cell_gates_kernel) runs h_in W_hh and [x | h_prev] [W_x; W_hs]
//    on the tensor cores (mma.sync, bf16 in, fp32 sums), a block a band of
//    64 rows and a slice of 32 hidden units over weights reordered once per
//    checkpoint, so that each thread holds all five pre-activations of its
//    units and the cell's epilogue runs on the accumulators; h' and s go to
//    fp32 scratch. Stage 2 (cell_attend_kernel) runs the attention, a block
//    a group of whole images with all their W rows: each image's V and pv
//    are read from device memory once and feed its W rows; h' Wg, s Ws and
//    alpha V keep their fp32 left operands (fp32 FMAs). Bound at 3,072 rows
//    (beam 3), bf16: ~107 MB of device bytes (0.032 ms at 3.35 TB/s)
//    against ~9.7 GFLOP of tensor products (0.010 ms at 989 TFLOP/s); at
//    1,024 rows (greedy) ~75 MB, 0.0225 ms. The images of a stage-2 block
//    come from ops/fused_step.py::cell_plan.
//    fp32, and bf16 at other widths ("simt"): adaptive_cell_kernel below,
//    one block of ROWS = 8 rows with fp32 FMAs on the CUDA cores throughout
//    (bound by their 67 TFLOP/s at ~3.4 GFLOP a greedy step); an image's W
//    rows may straddle two of its blocks. It is the exact path of the fp32
//    card-against-CPU checks.
//
// 2. head_argmax_mma_kernel (bf16) or head_argmax_kernel (fp32), then
//    head_argmax_reduce, replace fused_step.py::greedy_head_argmax (body
//    _head_argmax_kernel): argmax over the real vocab of (chat + h) @ W + b,
//    first max on ties, logits never stored.
//    Bound at batch 1024, bf16: 10.7 GFLOP -> ~11 us at the bf16 tensor peak
//    (989 TFLOP/s), against 10.5 MB of weight, which fits in the 50 MB L2.
//    Design (bf16): blocks cannot carry a running best across a sequential
//    grid as the TPU kernel does, so a block owns a band of 128 rows and a
//    split of the vocab (8 bands x 16 splits of 640 columns at batch 1024:
//    one wave of the 132 SMs). It forms z = chat + h once for its band,
//    keeps it in shared memory, and walks over its split's 128-column tiles
//    with the tensor-core band of kernel_common.cuh (wgmma by two
//    warpgroups of 64 rows on a 6-stage ring that a producer warp fills with
//    bulk asynchronous copies of the tiled weight). The selection runs on the
//    accumulators: a thread carries the running first max of its two rows
//    across the split's tiles (strictly larger wins, so the first column
//    stays), the four lanes that share a row fold in the order of better(),
//    and one (value, index) partial a row and split is written. Pass 2 walks
//    each row's splits in vocab order and keeps a strictly larger value, so
//    ties go to the first index exactly as jnp.argmax does.
//    fp32 has no exact tensor-core product: its instance keeps the SIMT tile
//    (64 rows x 128 columns a block, one partial a row and tile), bounded by
//    the CUDA cores' 67 TFLOP/s (0.16 ms), and is not on the bf16 main path.

#include "cell_mma.cuh"
#include "kernel_common.cuh"

namespace {

constexpr int ROWS = 8;       // rows of the batch one cell block owns
constexpr int CELL_THREADS = 256;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---------------------------------------------------------------- decode cell
// kBeam: row r reads image r / W of V and pv; false (W == 1) compiles the
// greedy kernel with no division in its slot reads.
template <typename T, bool kBeam>
__global__ void __launch_bounds__(CELL_THREADS)
adaptive_cell_kernel(const float* __restrict__ gx,   // [B, 4H] fp32
                     const T* __restrict__ h_in,     // [B, H]
                     const T* __restrict__ c_in,     // [B, H]
                     const T* __restrict__ x,        // [B, E2]
                     const T* __restrict__ h_prev,   // [B, H]
                     const T* __restrict__ pv,       // [B / W, K, D]
                     const T* __restrict__ V,        // [B / W, K, H]
                     const T* __restrict__ whh,      // [H, 4H]
                     const T* __restrict__ bhh,      // [4H]
                     const T* __restrict__ wx,       // [E2, H]
                     const T* __restrict__ whs,      // [H, H]
                     const T* __restrict__ wg,       // [H, D]
                     const T* __restrict__ ws,       // [H, D]
                     const T* __restrict__ wh,       // [D]
                     T* __restrict__ h_out, T* __restrict__ c_out,
                     T* __restrict__ chat_out,
                     float* __restrict__ alpha_out,  // [B, K]
                     float* __restrict__ beta_out,   // [B]
                     int B, int W, int H, int E2, int K, int D) {
  extern __shared__ float smem[];
  float* hs = smem;                 // [ROWS][H]  h_in
  float* xs = hs + ROWS * H;        // [ROWS][E2] x
  float* hps = xs + ROWS * E2;      // [ROWS][H]  h_prev
  float* hn = hps + ROWS * H;       // [ROWS][H]  h_new
  float* sn = hn + ROWS * H;        // [ROWS][H]  sentinel s
  float* phs = sn + ROWS * H;       // [ROWS][D]  h_new @ Wg
  float* sxs = phs + ROWS * D;      // [ROWS][D]  s @ Ws
  float* zs = sxs + ROWS * D;       // [ROWS][K]  logits, then alpha
  float* zss = zs + ROWS * K;       // [ROWS]     sentinel logit
  float* betas = zss + ROWS;        // [ROWS]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - r0);

  for (int i = tid; i < ROWS * H; i += blockDim.x) {
    int r = i / H, k = i - r * H;
    bool ok = r < nrows;
    hs[i] = ok ? to_f(h_in[(size_t)(r0 + r) * H + k]) : 0.f;
    hps[i] = ok ? to_f(h_prev[(size_t)(r0 + r) * H + k]) : 0.f;
  }
  for (int i = tid; i < ROWS * E2; i += blockDim.x) {
    int r = i / E2, k = i - r * E2;
    xs[i] = r < nrows ? to_f(x[(size_t)(r0 + r) * E2 + k]) : 0.f;
  }
  __syncthreads();

  // phase 1: gates (i, f, g, o) and sentinel pre-activation for units u, u+1
  const int H4 = 4 * H;
  for (int u = 2 * tid; u < H; u += 2 * blockDim.x) {
    float2 acc[ROWS][4];
    float2 sen[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      sen[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = make_float2(0.f, 0.f);
    }
    for (int k = 0; k < H; ++k) {
      float2 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = load2(whh + (size_t)k * H4 + g * H + u);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float hk = hs[r * H + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g].x = fmaf(hk, w[g].x, acc[r][g].x);
          acc[r][g].y = fmaf(hk, w[g].y, acc[r][g].y);
        }
      }
    }
    for (int k = 0; k < E2; ++k) {
      float2 w = load2(wx + (size_t)k * H + u);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float xk = xs[r * E2 + k];
        sen[r].x = fmaf(xk, w.x, sen[r].x);
        sen[r].y = fmaf(xk, w.y, sen[r].y);
      }
    }
    for (int k = 0; k < H; ++k) {
      float2 w = load2(whs + (size_t)k * H + u);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float pk = hps[r * H + k];
        sen[r].x = fmaf(pk, w.x, sen[r].x);
        sen[r].y = fmaf(pk, w.y, sen[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) break;
      const size_t row = (size_t)(r0 + r);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int uu = u + e;
        float gt[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float a = e ? acc[r][g].y : acc[r][g].x;
          gt[g] = gx[row * H4 + g * H + uu] + a + to_f(bhh[g * H + uu]);
        }
        float ig = sigmoidf_(gt[0]), fg = sigmoidf_(gt[1]);
        float gg = tanhf(gt[2]), og = sigmoidf_(gt[3]);
        float cell = fg * to_f(c_in[row * H + uu]) + ig * gg;
        float tc = tanhf(cell);
        float hnew = og * tc;
        float s = sigmoidf_(e ? sen[r].y : sen[r].x) * tc;
        hn[r * H + uu] = hnew;
        sn[r * H + uu] = s;
        h_out[row * H + uu] = from_f<T>(hnew);
        c_out[row * H + uu] = from_f<T>(cell);
      }
    }
  }
  __syncthreads();

  // phase 2: ph = h_new @ Wg and sx = s @ Ws, one thread per (row, column)
  for (int i = tid; i < nrows * D; i += blockDim.x) {
    int r = i / D, j = i - r * D;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < H; ++k) {
      a = fmaf(hn[r * H + k], to_f(wg[(size_t)k * D + j]), a);
      b = fmaf(sn[r * H + k], to_f(ws[(size_t)k * D + j]), b);
    }
    phs[r * D + j] = a;
    sxs[r * D + j] = b;
  }
  __syncthreads();

  // phase 3: z[r, i] = sum_j wh[j] tanh(pv[r, i, j] + ph[r, j]); sentinel z_s
  for (int i = tid; i < nrows * K; i += blockDim.x) {
    int r = i / K, s = i - r * K;
    const int img = kBeam ? (r0 + r) / W : r0 + r;
    const T* p = pv + ((size_t)img * K + s) * D;
    float z = 0.f;
    for (int j = 0; j < D; ++j) z = fmaf(tanhf(to_f(p[j]) + phs[r * D + j]), to_f(wh[j]), z);
    zs[r * K + s] = z;
  }
  for (int r = tid; r < nrows; r += blockDim.x) {
    float z = 0.f;
    for (int j = 0; j < D; ++j) z = fmaf(tanhf(sxs[r * D + j] + phs[r * D + j]), to_f(wh[j]), z);
    zss[r] = z;
  }
  __syncthreads();

  // phase 4: softmax over K (alpha) and the sentinel share of the K+1 softmax
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    float m = NEG;
    for (int s = lane; s < K; s += 32) m = fmaxf(m, zs[r * K + s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float denom = 0.f;
    for (int s = lane; s < K; s += 32) denom += expf(zs[r * K + s] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) denom += __shfl_xor_sync(0xffffffffu, denom, o);
    __syncwarp();
    for (int s = lane; s < K; s += 32) {
      float a = expf(zs[r * K + s] - m) / denom;
      zs[r * K + s] = a;
      alpha_out[(size_t)(r0 + r) * K + s] = a;
    }
    if (lane == 0) {
      float zsent = zss[r];
      float m2 = fmaxf(m, zsent);
      float denom2 = denom * expf(m - m2) + expf(zsent - m2);
      float beta = expf(zsent - m2) / denom2;
      betas[r] = beta;
      beta_out[r0 + r] = beta;
    }
  }
  __syncthreads();

  // phase 5: c_hat = beta s + (1 - beta) alpha @ V, units u, u+1 per thread
  for (int u = 2 * tid; u < H; u += 2 * blockDim.x) {
    float2 ctx[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ctx[r] = make_float2(0.f, 0.f);
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          float a = zs[r * K + s];
          const int img = kBeam ? (r0 + r) / W : r0 + r;
          float2 v = load2(V + ((size_t)img * K + s) * H + u);
          ctx[r].x = fmaf(a, v.x, ctx[r].x);
          ctx[r].y = fmaf(a, v.y, ctx[r].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) break;
      const float beta = betas[r];
      const size_t o = (size_t)(r0 + r) * H + u;
      chat_out[o] = from_f<T>(beta * sn[r * H + u] + (1.0f - beta) * ctx[r].x);
      chat_out[o + 1] = from_f<T>(beta * sn[r * H + u + 1] + (1.0f - beta) * ctx[r].y);
    }
  }
}

// ------------------------------------------------------------- head argmax
template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
head_argmax_kernel(const T* __restrict__ chat, const T* __restrict__ h,  // [B, H]
                   const T* __restrict__ W,                              // [H, Vp]
                   const T* __restrict__ bias,                           // [Vp]
                   float* __restrict__ part_v, int* __restrict__ part_i, // [B, Vp/BN]
                   int B, int H, int Vp, int vocab_len) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 4 rows x 8 cols each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][8];
  head_tile_product<T>(chat, h, W, B, H, Vp, m0, n0, acc);

  const int ntiles = Vp / BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv = NEG;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + tx + 16 * j;
      float v = col < vocab_len ? acc[i][j] + to_f(bias[col]) : NEG;
      if (better(v, col, bv, bi)) { bv = v; bi = col; }
    }
    // reduce over the 16 threads that share this row (one half-warp)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    int row = m0 + ty * 4 + i;
    if (tx == 0 && row < B) {
      part_v[(size_t)row * ntiles + blockIdx.y] = bv;
      part_i[(size_t)row * ntiles + blockIdx.y] = bi;
    }
  }
}

// tensor-core instance: one block a (split, band); epilogue on the accumulators
constexpr int ARGMAX_STAGES = 6;
constexpr int ARGMAX_THREADS = 2 * WG_THREADS + PRODUCER_THREADS;

struct ArgmaxEpilogue {
  const __nv_bfloat16* bias;
  int vocab_len, q;  // q: the thread's place among the 4 lanes of its rows
  float bv[2];
  int bi[2];
  __device__ __forceinline__ void tile(float (&acc)[64], int n0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 b = load2(bias + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e < vocab_len) {  // columns ascend with (j, e): > keeps the first
          const float be = e ? b.y : b.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float v = acc[4 * j + 2 * r + e] + be;
            if (v > bv[r]) { bv[r] = v; bi[r] = col + e; }
          }
        }
      }
    }
  }
};

__global__ void __launch_bounds__(ARGMAX_THREADS, 1)
head_argmax_mma_kernel(const __nv_bfloat16* __restrict__ chat,
                       const __nv_bfloat16* __restrict__ h,      // [B, H]
                       const __nv_bfloat16* __restrict__ Wtiles, // [Vp/128, KB, 128, 64]
                       const __nv_bfloat16* __restrict__ bias,   // [Vp]
                       float* __restrict__ part_v, int* __restrict__ part_i,  // [B, nsplit]
                       int B, int H, int vocab_len, int ntiles, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int m0 = blockIdx.y * 2 * WG_ROWS;
  const int tile0 = split * tiles_per_split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ArgmaxEpilogue epi{bias, vocab_len, lane & 3, {NEG, NEG}, {NO_ID, NO_ID}};
  if (!head_mma_band<2, ARGMAX_STAGES>(chat, h, Wtiles, B, H, m0, tile0,
                                       min(tiles_per_split, ntiles - tile0),
                                       align_1024(smem_raw), epi))
    return;  // the producer warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float bv = epi.bv[r];
    int bi = epi.bi[r];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes that share the row
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    const int row = m0 + warp * 16 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < B) {
      part_v[(size_t)row * nsplit + split] = bv;
      part_i[(size_t)row * nsplit + split] = bi;
    }
  }
}

// pass 2: partials in vocab order, strictly larger wins (first max on ties)
__global__ void head_argmax_reduce(const float* __restrict__ part_v,
                                   const int* __restrict__ part_i,
                                   int* __restrict__ out, int B, int nparts) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float best = NEG;
  int arg = 0;
  for (int t = 0; t < nparts; ++t) {
    float v = part_v[(size_t)row * nparts + t];
    if (v > best) { best = v; arg = part_i[(size_t)row * nparts + t]; }
  }
  out[row] = arg;
}

size_t cell_smem_bytes(int H, int E2, int K, int D) {
  return sizeof(float) * ((size_t)ROWS * (4 * H + E2 + 2 * D + K) + 2 * ROWS);
}

template <typename T>
int launch_cell(const void* gx, const void* h, const void* c, const void* x,
                const void* hp, const void* pv, const void* V, const void* whh,
                const void* bhh, const void* wx, const void* whs, const void* wg,
                const void* ws, const void* wh, void* h_out, void* c_out,
                void* chat_out, void* alpha, void* beta, int B, int W, int H,
                int E2, int K, int D, cudaStream_t stream) {
  size_t smem = cell_smem_bytes(H, E2, K, D);
  auto kernel = W == 1 ? adaptive_cell_kernel<T, false> : adaptive_cell_kernel<T, true>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + ROWS - 1) / ROWS);
  kernel<<<grid, CELL_THREADS, smem, stream>>>(
      (const float*)gx, (const T*)h, (const T*)c, (const T*)x, (const T*)hp,
      (const T*)pv, (const T*)V, (const T*)whh, (const T*)bhh, (const T*)wx,
      (const T*)whs, (const T*)wg, (const T*)ws, (const T*)wh, (T*)h_out,
      (T*)c_out, (T*)chat_out, (float*)alpha, (float*)beta, B, W, H, E2, K, D);
  return (int)cudaGetLastError();
}

int launch_cell_mma(const void* gx, const void* h, const void* c, const void* x, const void* hp,
                    const void* pv, const void* V, const void* bhh, const void* wh, void* h_out,
                    void* c_out, void* chat_out, void* alpha, void* beta, const void* whh_t,
                    const void* wsen_t, const void* watt_t, void* hn32, void* s32, int dtype,
                    int B, int W, int H, int E2, int K, int D, int images, int stages,
                    cudaStream_t stream) {
  if (dtype != 1 || H % CELL_CK || E2 % CELL_CK || W < 1 || B % W || images < 1 ||
      (stages & 3) == 0)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (stages & 1) {
    using L = CellTile<CELL_BM, CELL_NU>;
    auto kernel = cell_gates_kernel<CELL_BM, CELL_NU>;
    cudaError_t err = allow_smem((const void*)kernel, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((B + CELL_BM - 1) / CELL_BM, H / CELL_NU), L::THREADS, L::SMEM, stream>>>(
        (const float*)gx, (const bf*)h, (const bf*)c, (const bf*)x, (const bf*)hp,
        (const bf*)whh_t, (const bf*)wsen_t, (const bf*)bhh, (bf*)h_out, (bf*)c_out,
        (float*)hn32, (float*)s32, B, H, E2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    const size_t smem = attend_smem_bytes(images, W, H, K, D);
    cudaError_t err = allow_smem((const void*)cell_attend_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int nimg = B / W;
    cell_attend_kernel<<<(nimg + images - 1) / images, ATT_THREADS, smem, stream>>>(
        (const float*)hn32, (const float*)s32, (const bf*)pv, (const bf*)V, (const bf*)watt_t,
        (const bf*)wh, (bf*)chat_out, (float*)alpha, (float*)beta, B, W, H, K, D, images);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename T>
int launch_head(const void* chat, const void* h, const void* W, const void* b,
                void* part_v, void* part_i, void* out, int B, int H, int Vp,
                int vocab_len, cudaStream_t stream) {
  dim3 grid((B + BM - 1) / BM, Vp / BN);
  head_argmax_kernel<T><<<grid, HEAD_THREADS, 0, stream>>>(
      (const T*)chat, (const T*)h, (const T*)W, (const T*)b, (float*)part_v,
      (int*)part_i, B, H, Vp, vocab_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_argmax_reduce<<<(B + 255) / 256, 256, 0, stream>>>(
      (const float*)part_v, (const int*)part_i, (int*)out, B, Vp / BN);
  return (int)cudaGetLastError();
}

int launch_head_mma(const void* chat, const void* h, const void* Wtiles, const void* b,
                    void* part_v, void* part_i, void* out, int B, int H, int Vp,
                    int vocab_len, int nsplit, int tiles_per_split, cudaStream_t stream) {
  const size_t smem = head_mma_smem_bytes(H, 2, ARGMAX_STAGES);
  cudaError_t err = allow_smem((const void*)head_argmax_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nsplit, (B + 2 * WG_ROWS - 1) / (2 * WG_ROWS));
  head_argmax_mma_kernel<<<grid, ARGMAX_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)chat, (const __nv_bfloat16*)h, (const __nv_bfloat16*)Wtiles,
      (const __nv_bfloat16*)b, (float*)part_v, (int*)part_i, B, H, vocab_len, Vp / MMA_BN,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_argmax_reduce<<<(B + 255) / 256, 256, 0, stream>>>(
      (const float*)part_v, (const int*)part_i, (int*)out, B, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. B rows, W beam rows per image of V/pv
// (1 = one image per row). whh_t null: the SIMT kernel. whh_t, wsen_t,
// watt_t given (cell_kernel_tiles; bf16, H and E2 multiples of 64): the two
// stages of cell_mma.cuh, `images` whole images a stage-2 block, with h'
// and s in the fp32 scratch hn32, s32 [B, H]; stages: 1 stage 1 alone, 2
// stage 2 alone (on the scratch an earlier launch wrote), 3 both. Returns cudaGetLastError() after the launches.
int adaptive_cell_launch(int dtype, const void* gx, const void* h, const void* c,
                         const void* x, const void* hp, const void* pv,
                         const void* V, const void* whh, const void* bhh,
                         const void* wx, const void* whs, const void* wg,
                         const void* ws, const void* wh, void* h_out, void* c_out,
                         void* chat_out, void* alpha, void* beta, const void* whh_t,
                         const void* wsen_t, const void* watt_t, void* hn32, void* s32, int B, int W,
                         int H, int E2, int K, int D, int images, int stages,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (whh_t != nullptr)
    return launch_cell_mma(gx, h, c, x, hp, pv, V, bhh, wh, h_out, c_out, chat_out, alpha, beta,
                           whh_t, wsen_t, watt_t, hn32, s32, dtype, B, W, H, E2, K, D, images,
                           stages, st);
  if (dtype == 0)
    return launch_cell<float>(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws,
                              wh, h_out, c_out, chat_out, alpha, beta, B, W, H,
                              E2, K, D, st);
  return launch_cell<__nv_bfloat16>(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg,
                                    ws, wh, h_out, c_out, chat_out, alpha, beta, B,
                                    W, H, E2, K, D, st);
}

// Wtiles given: the tensor-core instance (bf16 only) over the tiled weight
// [Vp / 128, KB, 128, 64] (kernel_common.cuh), nsplit vocab splits of
// tiles_per_split 128-column tiles; Wtiles null: the SIMT instance over W
// [H, Vp], a split a tile (nsplit = Vp / 128). Partials [B, nsplit].
int head_argmax_launch(int dtype, const void* chat, const void* h, const void* W,
                       const void* Wtiles, const void* b, void* part_v, void* part_i,
                       void* out, int B, int H, int Vp, int vocab_len, int nsplit,
                       int tiles_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Wtiles != nullptr) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_head_mma(chat, h, Wtiles, b, part_v, part_i, out, B, H, Vp, vocab_len,
                           nsplit, tiles_per_split, st);
  }
  if (dtype == 0)
    return launch_head<float>(chat, h, W, b, part_v, part_i, out, B, H, Vp,
                              vocab_len, st);
  return launch_head<__nv_bfloat16>(chat, h, W, b, part_v, part_i, out, B, H, Vp,
                                    vocab_len, st);
}

#ifdef CELL_CLOCKS
// The seven cell_clocks counters into out, then zeroed.
int cell_clocks_read(unsigned long long* out) {
  const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, cell_clocks, sizeof zero);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(cell_clocks, zero, sizeof zero);
  return (int)err;
}
#endif

}  // extern "C"
