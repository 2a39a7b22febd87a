// Hopper (sm_90a) decode step of a Mamba-2 layer. Built with the other
// csrc/*.cu into one library by adaptive_tpu_torch/ops/cuda/build.py and
// called through ctypes from adaptive_tpu_torch/ops/ssm_step.py::ssm_step,
// whose plain twin ssm_step_plain defines the arithmetic.
//
// 8. ssm_state_step_kernel replaces no TPU kernel: the JAX package has no
//    state-space model. It is the decode step of every Mamba-2 layer of the
//    granite_h_micro caption decoder (models/hybrid_lm.py): for one row,
//      w    = [conv_state, xbc]                     (the last K raw inputs)
//      xa   = silu(conv_b + sum_k conv_w[:, k] w_k) -> x [H, P], B, C [G, N]
//      dt'  = softplus(dt + dt_bias),  dA = exp(dt' A)
//      S_h  = dA_h S_h + (dt'_h x_h) B_g^T,  y_h = S_h C_g + D_h x_h
//    with conv_state shifted and S written back in place, fp32 inside.
//    Bound on an H100 SXM: bytes. At batch 1,024 and granite-4.0-h-micro's
//    widths (H 64, P 64, N 128, C 4,352, K 4) a launch reads and writes
//    1.07 GB of bf16 state and 27 MB of conv state: 0.66 ms at 3.35 TB/s.
//    Design: one block a row, since a row's B and C are shared by all its
//    heads and its conv state is read and shifted once. Phase 1 convolves
//    the row's C channels, a thread a channel (coalesced over the channels
//    of each tap; each thread reads its channel's taps before it shifts
//    them, so no other thread's read races its write), and keeps the
//    activated row and each head's dt' and dA in shared memory. Phase 2
//    streams the state: a row (h, p) of N elements is N / L lanes of one
//    warp, each with one 16-byte vector (L = 8 bf16 or 4 fp32), so a warp
//    reads and writes whole rows; each thread issues the loads of U = 4 rows
//    before it computes any, keeping enough bytes in flight to hide the
//    latency, updates its vector in fp32, and the row's lanes sum their
//    parts of S_h C_g with shuffles. 1,024 blocks of 256 threads are about
//    two waves of the 132 SMs at 4 blocks each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int SSM_THREADS = 256;
constexpr int SSM_MAX_CONV = 4;  // d_conv at most
constexpr int SSM_UNROLL = 4;  // state rows a thread has in flight

template <typename T> struct Lanes;  // elements of T in 16 bytes
template <> struct Lanes<float> { static constexpr int n = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack(const int4& raw, float (&v)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = f[i];
}
__device__ __forceinline__ void unpack(const int4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ int4 pack(const float (&v)[4]) {
  int4 raw;
  float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = v[i];
  return raw;
}
__device__ __forceinline__ int4 pack(const float (&v)[8]) {
  int4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

// torch's softplus (threshold 20) and silu
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// grid: one block a row. Shared memory: the activated row [C], dt' [H], dA [H].
template <typename T>
__global__ void __launch_bounds__(SSM_THREADS)
ssm_state_step_kernel(const T* __restrict__ xbc, long long xbc_stride,
                      const T* __restrict__ dt, long long dt_stride, T* __restrict__ conv_state,
                      const T* __restrict__ conv_w, const T* __restrict__ conv_b,
                      const float* __restrict__ dt_bias, const float* __restrict__ A,
                      const float* __restrict__ D, T* __restrict__ state, T* __restrict__ y,
                      int C, int K, int H, int P, int N, int G) {
  extern __shared__ float sh[];
  float* xa = sh;  // [C]
  float* sdt = sh + C;  // [H]
  float* sdA = sdt + H;  // [H]
  const long long b = blockIdx.x;

  // phase 1: the conv of the row's channels, its shift, dt' and dA
  const T* xrow = xbc + b * xbc_stride;
  T* cs = conv_state + b * (long long)(K - 1) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T newest = xrow[c];
    float taps[SSM_MAX_CONV];
#pragma unroll
    for (int k = 0; k < SSM_MAX_CONV; ++k)
      taps[k] = k < K - 1 ? to_f(cs[(long long)k * C + c]) : (k == K - 1 ? to_f(newest) : 0.f);
    float acc = to_f(conv_b[c]);
#pragma unroll
    for (int k = 0; k < SSM_MAX_CONV; ++k)
      if (k < K) acc = fmaf(to_f(conv_w[(long long)c * K + k]), taps[k], acc);
    xa[c] = silu(acc);
#pragma unroll
    for (int k = 0; k < SSM_MAX_CONV - 2; ++k)
      if (k < K - 2) cs[(long long)k * C + c] = from_f<T>(taps[k + 1]);  // exact: T's values
    cs[(long long)(K - 2) * C + c] = newest;
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const float d = softplus(to_f(dt[b * dt_stride + h]) + dt_bias[h]);
    sdt[h] = d;
    sdA[h] = expf(d * A[h]);
  }
  __syncthreads();

  // phase 2: the state, a (h, p) row of N elements per R lanes of a warp
  constexpr int L = Lanes<T>::n;
  const int R = N / L;
  const int rows_per_warp = 32 / R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / R, q = lane % R;
  const int rows_per_pass = (blockDim.x / 32) * rows_per_warp;
  const int HP = H * P, heads_per_group = H / G;
  const float* Bs = xa + HP;
  const float* Cs = Bs + G * N;
  T* srow = state + b * (long long)HP * N;
  T* yrow = y + b * (long long)HP;
  for (int base = warp * rows_per_warp; base < HP; base += SSM_UNROLL * rows_per_pass) {
    int4 raw[SSM_UNROLL];
#pragma unroll
    for (int u = 0; u < SSM_UNROLL; ++u) {
      const int r = base + sub + u * rows_per_pass;
      if (r < HP) raw[u] = *reinterpret_cast<const int4*>(srow + (long long)r * N + q * L);
    }
#pragma unroll
    for (int u = 0; u < SSM_UNROLL; ++u) {
      const int r = base + sub + u * rows_per_pass;
      const bool valid = r < HP;
      float part = 0.f;
      if (valid) {
        const int h = r / P, g = h / heads_per_group;
        const float dA = sdA[h], dtx = sdt[h] * xa[r];
        // this lane's L values of B_g and C_g, as 16-byte shared loads
        const float4* B4 = reinterpret_cast<const float4*>(Bs + g * N + q * L);
        const float4* C4 = reinterpret_cast<const float4*>(Cs + g * N + q * L);
        float s[L];
        unpack(raw[u], s);
#pragma unroll
        for (int i = 0; i < L / 4; ++i) {
          const float4 bv = B4[i], cv = C4[i];
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w}, cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[4 * i + j] = fmaf(dA, s[4 * i + j], dtx * bb[j]);
            part = fmaf(s[4 * i + j], cc[j], part);
          }
        }
        *reinterpret_cast<int4*>(srow + (long long)r * N + q * L) = pack(s);
      }
      for (int off = R / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (valid && q == 0) {
        const int h = r / P;
        yrow[r] = from_f<T>(fmaf(D[h], xa[r], part));
      }
    }
  }
}

template <typename T>
int launch_step(const void* xbc, long long xbc_stride, const void* dt, long long dt_stride,
                void* conv_state, const void* conv_w, const void* conv_b, const float* dt_bias,
                const float* A, const float* D, void* state, void* y, int B, int C, int K,
                int H, int P, int N, int G, cudaStream_t st) {
  constexpr int L = Lanes<T>::n;
  const int R = N / L;
  if (N % L || R < 1 || R > 32 || (R & (R - 1)) || K < 2 || K > SSM_MAX_CONV || G < 1 ||
      H % G || C != H * P + 2 * G * N || (H * P) % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)C + 2 * (size_t)H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_state_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssm_state_step_kernel<T><<<B, SSM_THREADS, smem, st>>>(
      (const T*)xbc, xbc_stride, (const T*)dt, dt_stride, (T*)conv_state, (const T*)conv_w,
      (const T*)conv_b, dt_bias, A, D, (T*)state, (T*)y, C, K, H, P, N, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of xbc, dt, conv_state, conv_w, conv_b,
// state and y; dt_bias, A and D float32. xbc [B, C] and dt [B, H] with row
// strides in elements; conv_state [B, K - 1, C], conv_w [C, K], conv_b [C],
// dt_bias, A, D [H], state [B, H, P, N] (16-byte aligned) and y [B, H * P]
// contiguous (checked by the wrapper); C = H * P + 2 * G * N with H * P a
// multiple of 4, N / (16 / sizeof(dtype)) a power of two at most 32,
// 2 <= K <= 4. Updates conv_state
// and state, writes y. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for sizes outside these.
int ssm_step_launch(int dtype, const void* xbc, long long xbc_stride, const void* dt,
                    long long dt_stride, void* conv_state, const void* conv_w,
                    const void* conv_b, const void* dt_bias, const void* A, const void* D,
                    void* state, void* y, int B, int C, int K, int H, int P, int N, int G,
                    void* stream) {
  if (B < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *bias = (const float*)dt_bias, *a = (const float*)A, *d = (const float*)D;
  if (dtype == 0)
    return launch_step<float>(xbc, xbc_stride, dt, dt_stride, conv_state, conv_w, conv_b, bias,
                              a, d, state, y, B, C, K, H, P, N, G, st);
  return launch_step<__nv_bfloat16>(xbc, xbc_stride, dt, dt_stride, conv_state, conv_w, conv_b,
                                    bias, a, d, state, y, B, C, K, H, P, N, G, st);
}

}  // extern "C"
