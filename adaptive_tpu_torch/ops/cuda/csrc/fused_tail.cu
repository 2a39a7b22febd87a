// Hopper (sm_90a) fused bottleneck tail + next block's conv1 of the int8
// encoder. Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_tail.py::tail_conv1_int8, whose plain twin
// tail_conv1_int8_plain defines the arithmetic.
//
// 6. tail_conv1_kernel replaces adaptive_tpu/ops/pallas/fused_tail.py::
//    tail_conv1_int8 (body _kernel): for the carry rows [N, C] of blocks
//    (i, i+1),
//      out = requant(relu(z2 @ w3 * sc3 + b3 + x * s_in), s_out)     (M -> C)
//      z1  = requant(relu(out @ w1 * sc1 + b1), s_next)              (C -> M2)
//    Bound on an H100 SXM at batch 1024: 2.1e11 int8 operations at every
//    layer boundary of ResNet-152 (N C M is the same in each layer), against
//    N (2 C + M + M2) bytes (x, z2 read; out, z1 written): layer3 (N =
//    200,704, C 1024, M = M2 = 256) 0.51 GB -> 0.153 ms (bytes); layer1
//    (N = 3,211,264, C 256, M = M2 = 64) 2.06 GB -> 0.615 ms (bytes).
//    Design: both products are row-wise, so one block owns TR = 64 carry
//    rows. Stage 1 computes conv3 + residual for its rows, writes the s8
//    carry to device memory (block i+1 reads it as its residual) and keeps
//    it in shared memory; stage 2 computes conv1 of block i+1 from that
//    shared tile, so the carry is never read back from device memory, which
//    is the point of the fusion. Products are mma.sync m16n8k32 s8 with int32
//    accumulation (int8_common.cuh), weights read from L2 through L1.

#include "int8_common.cuh"

namespace {

constexpr int TR = 64;  // carry rows a block owns

__global__ void __launch_bounds__(I8_THREADS)
tail_conv1_kernel(const int8_t* __restrict__ x,    // [N, C] block i's input carry
                  const int8_t* __restrict__ z2,   // [N, M] block i's conv2 output
                  const int8_t* __restrict__ w3,   // [C, M]
                  const float* __restrict__ sc3, const float* __restrict__ b3,  // [C]
                  const int8_t* __restrict__ w1,   // [M2, C]
                  const float* __restrict__ sc1, const float* __restrict__ b1,  // [M2]
                  int8_t* __restrict__ out,        // [N, C]
                  int8_t* __restrict__ z1,         // [N, M2]
                  float s_in, float s_out, float s_next, int N, int C, int M, int M2) {
  extern __shared__ __align__(16) int8_t carry[];  // [TR, C + SMEM_PAD]
  const int ld = C + SMEM_PAD;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, N - r0);
  const int warp = threadIdx.x >> 5;
  int acc[NF][4];

  // stage 1: conv3 + dequantised residual + relu + requant -> the carry
  auto a3 = [&](int p, int) -> const int8_t* {
    return p < rows ? z2 + (size_t)(r0 + p) * M : nullptr;
  };
  int tn = (C + TILE_N - 1) / TILE_N;
  int tiles = (rows + 15) / 16 * tn;
  for (int tile = warp; tile < tiles; tile += I8_WARPS) {
    const int p0 = tile / tn * 16, n0 = tile % tn * TILE_N;
    warp_tile(a3, p0, 1, M, w3, M, n0, C, acc);
    for_each_pair(acc, p0, n0, C, [&](int p, int n, int v0, int v1) {
      if (p >= rows) return;
      const size_t o = (size_t)(r0 + p) * C + n;
      const float q0 = __fmul_rn((float)x[o], s_in), q1 = __fmul_rn((float)x[o + 1], s_in);
      const int8_t c0 = requant(relu(__fadd_rn(affine(v0, sc3[n], b3[n]), q0)), s_out);
      const int8_t c1 = requant(relu(__fadd_rn(affine(v1, sc3[n + 1], b3[n + 1]), q1)), s_out);
      store2(out + o, c0, c1);
      store2(carry + (size_t)p * ld + n, c0, c1);
    });
  }
  __syncthreads();

  // stage 2: block i+1's conv1 + relu + requant from the shared carry
  auto a1 = [&](int p, int) -> const int8_t* {
    return p < rows ? carry + (size_t)p * ld : nullptr;
  };
  tn = (M2 + TILE_N - 1) / TILE_N;
  tiles = (rows + 15) / 16 * tn;
  for (int tile = warp; tile < tiles; tile += I8_WARPS) {
    const int p0 = tile / tn * 16, n0 = tile % tn * TILE_N;
    warp_tile(a1, p0, 1, C, w1, C, n0, M2, acc);
    for_each_pair(acc, p0, n0, M2, [&](int p, int n, int v0, int v1) {
      if (p >= rows) return;
      store2(z1 + (size_t)(r0 + p) * M2 + n, requant(relu(affine(v0, sc1[n], b1[n])), s_next),
             requant(relu(affine(v1, sc1[n + 1], b1[n + 1])), s_next));
    });
  }
}

}  // namespace

extern "C" {

// N rows; C, M, M2 multiples of 8 (checked by the wrapper). Returns
// cudaGetLastError() after the launch.
int tail_conv1_launch(const void* x, const void* z2, const void* w3, const void* sc3,
                      const void* b3, const void* w1, const void* sc1, const void* b1, void* out,
                      void* z1, float s_in, float s_out, float s_next, int N, int C, int M,
                      int M2, void* stream) {
  const size_t smem = (size_t)TR * (C + SMEM_PAD);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_conv1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_conv1_kernel<<<(N + TR - 1) / TR, I8_THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)z2, (const int8_t*)w3, (const float*)sc3,
      (const float*)b3, (const int8_t*)w1, (const float*)sc1, (const float*)b1, (int8_t*)out,
      (int8_t*)z1, s_in, s_out, s_next, N, C, M, M2);
  return (int)cudaGetLastError();
}

}  // extern "C"
