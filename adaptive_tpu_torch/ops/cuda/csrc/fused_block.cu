// Hopper (sm_90a) fused int8 identity bottleneck block of the int8 encoder.
// Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_block.py::bottleneck_identity_int8, whose
// plain twin bottleneck_identity_int8_plain defines the arithmetic.
//
// 5. bottleneck_block_kernel replaces adaptive_tpu/ops/pallas/fused_block.py::
//    bottleneck_identity_int8 (body _kernel): on the s8 carry x [B*H*W, C],
//      z1 = requant(relu(x @ w1 * sc1 + b1), s2)            (1x1, C -> M)
//      z2 = requant(relu(conv3x3(z1) * sc2 + b2), s3)       (3x3, zero padding)
//      out = requant(relu(z2 @ w3 * sc3 + b3 + x * s_in), s_out)   (1x1, M -> C)
//    Bound on an H100 SXM at batch 1024: 4.47e11 int8 operations in every
//    layer of ResNet-152, against 2 N C bytes (x read, out written): layer1
//    (56x56, C 256, M 64) 1.64 GB -> 0.49 ms (bytes); layer2 0.82 GB ->
//    0.245 ms (bytes); layer3 and layer4 0.226 ms (operations, at 1,979 TOPS).
//    Design: the TPU kernel runs the 3x3 conv as nine rolls of a flattened
//    image group with edge masks. Here one block owns a band of R whole image
//    rows of one image. Stage 1 computes conv1 for the band and a one-row
//    halo above and below into shared memory as s8 (halo rows outside the
//    image are stored as zeros: the 3x3 conv's padding). Stage 2 computes the
//    3x3 conv from shared memory, each tap a shifted row of the band, a tap
//    whose column leaves the image a zero row; its s8 output stays in shared
//    memory. Stage 3 computes conv3, adds the residual read from x and writes
//    the s8 carry. Only x is read and out written in device memory; z1 and z2
//    never leave the SM. Products are mma.sync m16n8k32 s8 with int32
//    accumulation (int8_common.cuh), A and B fragments loaded as 4-byte words
//    (activations from shared memory or x, weights from L2 through L1). The
//    halo costs (R + 2) / R of conv1's work. wgmma, TMA and weight tiles
//    staged in shared memory are later work.

#include <algorithm>

#include "int8_common.cuh"

namespace {

__global__ void __launch_bounds__(I8_THREADS)
bottleneck_block_kernel(const int8_t* __restrict__ x,     // [B*H*W, C]
                        const int8_t* __restrict__ w1,    // [M, C]
                        const int8_t* __restrict__ w2,    // [M, 9*M], (ky, kx, in)
                        const int8_t* __restrict__ w3,    // [C, M]
                        const float* __restrict__ sc1, const float* __restrict__ b1,  // [M]
                        const float* __restrict__ sc2, const float* __restrict__ b2,  // [M]
                        const float* __restrict__ sc3, const float* __restrict__ b3,  // [C]
                        int8_t* __restrict__ out,         // [B*H*W, C]
                        float s2, float s3, float s_in, float s_out,
                        int H, int W, int C, int M, int R) {
  extern __shared__ __align__(16) int8_t smem[];
  const int ld = M + SMEM_PAD;
  const int bands = (H + R - 1) / R;
  const int img = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * R;
  const int rows = min(R, H - y0);            // image rows this block writes
  const int P1 = (rows + 2) * W;               // stage 1 rows: the band and its halo
  const int P2 = rows * W;                     // stage 2 and 3 rows: the band
  int8_t* z1s = smem;                          // [P1, ld]
  int8_t* z2s = smem + (size_t)P1 * ld;        // [P2, ld]
  const int8_t* xb = x + (size_t)img * H * W * C;
  const int8_t* xband = xb + (size_t)y0 * W * C;
  int8_t* oband = out + ((size_t)img * H * W + (size_t)y0 * W) * C;
  const int warp = threadIdx.x >> 5;
  int acc[NF][4];

  // stage 1: conv1 (1x1) on image rows y0 - 1 .. y0 + rows
  auto a1 = [&](int p, int) -> const int8_t* {
    if (p >= P1) return nullptr;
    const int y = y0 - 1 + p / W;
    return (y < 0 || y >= H) ? nullptr : xb + ((size_t)y * W + p % W) * C;
  };
  int tn = (M + TILE_N - 1) / TILE_N;
  int tiles = (P1 + 15) / 16 * tn;
  for (int tile = warp; tile < tiles; tile += I8_WARPS) {
    const int p0 = tile / tn * 16, n0 = tile % tn * TILE_N;
    warp_tile(a1, p0, 1, C, w1, C, n0, M, acc);
    for_each_pair(acc, p0, n0, M, [&](int p, int n, int v0, int v1) {
      if (p >= P1) return;
      const int y = y0 - 1 + p / W;
      int8_t q0 = 0, q1 = 0;  // halo rows outside the image: the 3x3 conv's zero padding
      if (y >= 0 && y < H) {
        q0 = requant(relu(affine(v0, sc1[n], b1[n])), s2);
        q1 = requant(relu(affine(v1, sc1[n + 1], b1[n + 1])), s2);
      }
      store2(z1s + (size_t)p * ld + n, q0, q1);
    });
  }
  __syncthreads();

  // stage 2: conv2 (3x3, stride 1) from shared memory; segment s is tap
  // (ky, kx) = (s / 3, s % 3), reading band row ly + ky (halo included)
  auto a2 = [&](int p, int s) -> const int8_t* {
    if (p >= P2) return nullptr;
    const int ly = p / W, c = p % W + s % 3 - 1;
    return (c < 0 || c >= W) ? nullptr : z1s + ((size_t)(ly + s / 3) * W + c) * ld;
  };
  tiles = (P2 + 15) / 16 * tn;
  for (int tile = warp; tile < tiles; tile += I8_WARPS) {
    const int p0 = tile / tn * 16, n0 = tile % tn * TILE_N;
    warp_tile(a2, p0, 9, M, w2, 9 * M, n0, M, acc);
    for_each_pair(acc, p0, n0, M, [&](int p, int n, int v0, int v1) {
      if (p >= P2) return;
      store2(z2s + (size_t)p * ld + n, requant(relu(affine(v0, sc2[n], b2[n])), s3),
             requant(relu(affine(v1, sc2[n + 1], b2[n + 1])), s3));
    });
  }
  __syncthreads();

  // stage 3: conv3 (1x1) + dequantised residual + relu + requant
  auto a3 = [&](int p, int) -> const int8_t* {
    return p < P2 ? z2s + (size_t)p * ld : nullptr;
  };
  tn = (C + TILE_N - 1) / TILE_N;
  tiles = (P2 + 15) / 16 * tn;
  for (int tile = warp; tile < tiles; tile += I8_WARPS) {
    const int p0 = tile / tn * 16, n0 = tile % tn * TILE_N;
    warp_tile(a3, p0, 1, M, w3, M, n0, C, acc);
    for_each_pair(acc, p0, n0, C, [&](int p, int n, int v0, int v1) {
      if (p >= P2) return;
      const size_t o = (size_t)p * C + n;
      const float r0 = __fmul_rn((float)xband[o], s_in);
      const float r1 = __fmul_rn((float)xband[o + 1], s_in);
      store2(oband + o, requant(relu(__fadd_rn(affine(v0, sc3[n], b3[n]), r0)), s_out),
             requant(relu(__fadd_rn(affine(v1, sc3[n + 1], b3[n + 1]), r1)), s_out));
    });
  }
}

}  // namespace

extern "C" {

// Shared memory of a band of R rows: (R + 2) W + R W rows of M + SMEM_PAD bytes.
static size_t block_smem(int R, int W, int M) {
  return (size_t)(2 * R + 2) * W * (M + SMEM_PAD);
}

// B images of H x W; C, M multiples of 8 (checked by the wrapper). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue where no band
// of one image row fits in shared memory).
int bottleneck_block_launch(const void* x, const void* w1, const void* w2, const void* w3,
                            const void* sc1, const void* b1, const void* sc2, const void* b2,
                            const void* sc3, const void* b3, void* out, float s2, float s3,
                            float s_in, float s_out, int B, int H, int W, int C, int M,
                            void* stream) {
  // a band of about 128 pixels (whole rows), cut so the bands are even
  int R = std::min(H, std::max(1, (128 + W - 1) / W));
  const int bands = (H + R - 1) / R;
  R = (H + bands - 1) / bands;
  while (R > 1 && block_smem(R, W, M) > (size_t)MAX_SMEM) --R;
  const size_t smem = block_smem(R, W, M);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = B * ((H + R - 1) / R);
  bottleneck_block_kernel<<<grid, I8_THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w1, (const int8_t*)w2, (const int8_t*)w3,
      (const float*)sc1, (const float*)b1, (const float*)sc2, (const float*)b2,
      (const float*)sc3, (const float*)b3, (int8_t*)out, s2, s3, s_in, s_out, H, W, C, M, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
