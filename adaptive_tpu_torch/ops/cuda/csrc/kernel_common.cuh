// Helpers shared by the decode kernels in fused_step.cu and head_topk.cu:
// dtype conversions, the (value, index) order of the vocab heads, and the
// SIMT product tile that both vocab heads compute their logits with.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two consecutive elements (p must be aligned to two elements)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// (value, index) order of the heads: larger value first, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Head product tile: BM rows x BN vocab columns a block, 256 threads as
// 16 x 16, each thread 4 rows (ty * 4 + i) x 8 columns (tx + 16 * j).
constexpr int BM = 64, BN = 128, BK = 32, HEAD_THREADS = 256;

// acc[i][j] = sum_k z[m0 + ty*4 + i, k] * W[k, n0 + tx + 16 j], where
// z = (chat + h) rounded to the weight dtype, fp32 FMAs in k order, the
// operands staged in shared memory. Rows past B contribute zeros.
template <typename T>
__device__ __forceinline__ void head_tile_product(const T* __restrict__ chat,
                                                  const T* __restrict__ h,
                                                  const T* __restrict__ W, int B, int H,
                                                  int Vp, int m0, int n0,
                                                  float (&acc)[4][8]) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    // A tile: z = (chat + h) rounded to the weight dtype, stored k-major
    for (int e = tid; e < BM * BK; e += HEAD_THREADS) {
      int m = e / BK, kk = e - m * BK;
      int row = m0 + m, k = k0 + kk;
      float z = 0.f;
      if (row < B && k < H) {
        size_t o = (size_t)row * H + k;
        z = to_f(from_f<T>(to_f(chat[o]) + to_f(h[o])));
      }
      As[kk][m] = z;
    }
    for (int e = tid; e < BK * BN; e += HEAD_THREADS) {
      int kk = e / BN, n = e - kk * BN;
      int k = k0 + kk;
      Bs[kk][n] = k < H ? to_f(W[(size_t)k * Vp + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace
