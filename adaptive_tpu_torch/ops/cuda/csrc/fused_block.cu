// Hopper (sm_90a) fused int8 identity bottleneck block of the int8 encoder.
// Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_block.py::bottleneck_identity_int8, whose
// plain twin bottleneck_identity_int8_plain defines the arithmetic and whose
// block_plan picks the launch plan passed in here.
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
//    image group with edge masks. Here a block owns P output rows, a band
//    of whole image rows of one image or G whole images (block_plan), and
//    runs three products one after the other through
//    int8_common.cuh::ring_product: each [NT x KT] weight chunk is copied
//    once a block into a ring of shared-memory slots by cp.async and read by
//    all 8 warps with ldmatrix into mma.sync m16n8k32 s8 (int32 sums, exact
//    in any order), so the weights cross L2 once a block, not once a 16-row
//    tile. Stage 1 computes conv1 for the block's rows and the one-row halo
//    above and below that lies inside the image, its x rows staged in the
//    same ring slot as the weight chunk; z1 stays in shared memory as s8.
//    Stage 2 computes the 3x3 conv from there: for tap (ky, kx) the lane
//    that feeds row p of a fragment points ldmatrix at z1's row
//    p + (ky - 1) W + (kx - 1), or at a zero row in shared memory where the
//    tap leaves p's image (left, right, top and bottom edges, also between
//    the images of a group), so no halo row outside an image is computed or
//    stored; z2 stays in shared memory. Stage 3 computes conv3; the residual
//    x tile comes through the ring with the chunk's last K step, the s8
//    carry is formed in its place and written back in 16-byte stores. Only
//    x is read and out written in device memory.
//    What bounds it on the card: the epilogues (an IEEE division a value,
//    whose fast path needs a normal dividend, so relu's zeros skip it:
//    requant_relu) and the latency of each ring step, not the tensor rate.
//    So a block takes the 8 warps' m16 tiles only as far as its rows go, the
//    kernel is built for two blocks an SM (registers capped at 128 a
//    thread), and block_plan prefers plans whose shared bytes (~113 KB) let
//    two blocks share an SM, whose warps hide each other's latencies; a
//    larger plan runs the same code one block an SM. wgmma, TMA and
//    clusters are later work; PERF.md has the measured times against the
//    bound.

#include "int8_common.cuh"

namespace {

// Block b's rows, from the plan (R image rows a band, G images a block; G > 1
// only with R = H): output rows [o0, o0 + P2) of the carry and stage-1 rows
// [i0, i0 + P1), the band with the halo rows that lie inside its image.
struct BlockRows {
  int o0, P2, i0, P1;
};

__device__ __forceinline__ BlockRows block_rows(int b, int B, int H, int W, int R, int G) {
  const int nbands = (H + R - 1) / R;
  const int img = b / nbands * G, y0 = b % nbands * R;
  const int rows = min(R, H - y0), nimg = min(G, B - img);
  const int above = y0 > 0 ? W : 0, below = y0 + rows < H ? W : 0;
  BlockRows r;
  r.o0 = (img * H + y0) * W;
  r.P2 = ((nimg - 1) * H + rows) * W;
  r.i0 = r.o0 - above;
  r.P1 = r.P2 + above + below;
  return r;
}

// Stage 1 reads its A rows from the ring (ring_product's xa); no row state.
struct NoRows {};

// Stage 2: the 3x3 taps of output row p as rows of z1 (row q = o0 + p - i0
// is p's own pixel), or the zero row where a tap leaves p's image.
struct TapRows {
  uint32_t z1, zero;
  int ld, H, W, HW, o0, i0, P;
  int q[RING_MI], yx[RING_MI];  // yx = y << 16 | x of the pixel, -1 past P
  __device__ __forceinline__ void prep(int i, int p) {
    if (p >= P) {
      yx[i] = -1;
      return;
    }
    const int r = o0 + p, pix = r % HW, y = pix / W;
    q[i] = r - i0;
    yx[i] = (y << 16) | (pix - y * W);
  }
  __device__ __forceinline__ uint32_t addr(int i, int s) const {
    const int dy = s / 3 - 1, dx = s % 3 - 1;
    const int y = (yx[i] >> 16) + dy, x = (yx[i] & 0xffff) + dx;
    const bool in = yx[i] >= 0 && (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
    return in ? z1 + (uint32_t)((q[i] + dy * W + dx) * ld) : zero;
  }
};

// P1max, P2max: the most stage-1 and output rows a block holds.
__host__ __device__ __forceinline__ void plan_rows(int H, int W, int R, int G, int& P1max,
                                                   int& P2max) {
  P2max = G > 1 ? G * H * W : R * W;
  P1max = G > 1 ? P2max : (R + 2 < H ? R + 2 : H) * W;
}

// Registers for two blocks an SM (at most 128 a thread): block_plan's plans
// at ResNet-152's layers leave shared bytes for two.
template <int WC, int VEC>
__global__ void __launch_bounds__(I8_THREADS, 2)
bottleneck_block_kernel(const int8_t* __restrict__ x,     // [B*H*W, C]
                        const int8_t* __restrict__ w1,    // [M, C]
                        const int8_t* __restrict__ w2,    // [M, 9*M], (ky, kx, in)
                        const int8_t* __restrict__ w3,    // [C, M]
                        const float* __restrict__ sc1, const float* __restrict__ b1,  // [M]
                        const float* __restrict__ sc2, const float* __restrict__ b2,  // [M]
                        const float* __restrict__ sc3, const float* __restrict__ b3,  // [C]
                        int8_t* __restrict__ out,         // [B*H*W, C]
                        float s2, float s3, float s_in, float s_out,
                        int B, int H, int W, int C, int M, int R, int G, int KT) {
  extern __shared__ __align__(16) int8_t smem[];
  const BlockRows br = block_rows(blockIdx.x, B, H, W, R, G);
  int P1max, P2max;
  plan_rows(H, W, R, G, P1max, P2max);
  const int ld = act_ld(M), sbytes = slot_bytes(WC * RING_NF * 8, KT, P1max);
  int8_t* z1s = smem;                          // [P1, ld]: stage-1 rows i0 ..
  int8_t* z2s = z1s + (size_t)P1max * ld;      // [P2, ld]: output rows o0 ..
  int8_t* zero = z2s + (size_t)P2max * ld;     // [ld] zeros: a tap outside the image
  int8_t* ring = zero + ld;                    // [RING_STAGES, sbytes]
  for (int i = threadIdx.x; i < ld / 16; i += I8_THREADS)
    reinterpret_cast<int4*>(zero)[i] = make_int4(0, 0, 0, 0);  // seen after stage 1's barriers
  RING_CLOCK_START(t0);

  // stage 1: conv1 (1x1) on the band and its halo rows inside the image
  NoRows none;
  ring_product<WC, VEC, true, false, TO_SHARED>(ring, sbytes, KT, br.P1, M, 1, C, w1,
                                                x + (size_t)br.i0 * C, none, sc1, b1, s2, z1s,
                                                ld, nullptr, 0.f, nullptr);
  RING_CLOCK(0, t0);

  // stage 2: conv2 (3x3, stride 1, zero padding) from shared memory
  TapRows taps;
  taps.z1 = smem_u32(z1s);
  taps.zero = smem_u32(zero);
  taps.ld = ld, taps.H = H, taps.W = W, taps.HW = H * W;
  taps.o0 = br.o0, taps.i0 = br.i0, taps.P = br.P2;
  ring_product<WC, VEC, false, false, TO_SHARED>(ring, sbytes, KT, br.P2, M, 9, M, w2, nullptr,
                                                 taps, sc2, b2, s3, z2s, ld, nullptr, 0.f,
                                                 nullptr);
  RING_CLOCK(1, t0);

  // stage 3: conv3 (1x1) + dequantised residual + relu + requant, to the carry
  PlainRows z2rows;
  z2rows.base = smem_u32(z2s);
  z2rows.ld = ld, z2rows.P = br.P2;
  ring_product<WC, VEC, false, true, TO_DEVICE>(ring, sbytes, KT, br.P2, C, 1, M, w3, nullptr,
                                                z2rows, sc3, b3, s_out, nullptr, 0,
                                                x + (size_t)br.o0 * C, s_in,
                                                out + (size_t)br.o0 * C);
  RING_CLOCK(2, t0);
}

}  // namespace

extern "C" {

// Shared bytes of a plan: z1 [P1max, ld], z2 [P2max, ld], the zero row and
// the ring. ops/fused_block.py::block_smem mirrors it.
static size_t block_smem(int H, int W, int M, int R, int G, int nt, int kt) {
  int P1max, P2max;
  plan_rows(H, W, R, G, P1max, P2max);
  return (size_t)(P1max + P2max + 1) * act_ld(M) + (size_t)RING_STAGES * slot_bytes(nt, kt, P1max);
}

// B images of H x W; C, M multiples of 8 and the tensors 16-byte aligned
// (checked by the wrapper). The plan (ops/fused_block.py::block_plan): R
// image rows or G images a block, a column chunk of nt = 64 or 128, a K
// chunk of kt = 64 or 128 (128 with nt = 128: stage 3 stages an nt-wide
// residual tile in kt + 16-byte rows), smem bytes, and vec = 16-byte
// copies (C and M multiples of 16) or 8-byte ones. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// outside these values or whose smem disagrees with block_smem.
int bottleneck_block_launch(const void* x, const void* w1, const void* w2, const void* w3,
                            const void* sc1, const void* b1, const void* sc2, const void* b2,
                            const void* sc3, const void* b3, void* out, float s2, float s3,
                            float s_in, float s_out, int B, int H, int W, int C, int M, int R,
                            int G, int nt, int kt, int smem, int vec, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C % 8 || M % 8 || R < 1 || R > H || G < 1 ||
      (G > 1 && R != H) || (nt != 64 && nt != 128) || (kt != 64 && kt != 128) || kt + 16 < nt ||
      (vec != 8 && vec != 16) || (vec == 16 && (C % 16 || M % 16)))
    return (int)cudaErrorInvalidValue;
  const size_t need = block_smem(H, W, M, R, G, nt, kt);
  if (need != (size_t)smem || need > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool v16 = vec == 16;  // 16-byte copies need rows of 16-byte multiples
  auto kernel = v16 ? &bottleneck_block_kernel<2, 16> : &bottleneck_block_kernel<2, 8>;
  if (nt == 128) kernel = v16 ? &bottleneck_block_kernel<4, 16> : &bottleneck_block_kernel<4, 8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + G - 1) / G * ((H + R - 1) / R);
  kernel<<<grid, I8_THREADS, need, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w1, (const int8_t*)w2, (const int8_t*)w3,
      (const float*)sc1, (const float*)b1, (const float*)sc2, (const float*)b2,
      (const float*)sc3, (const float*)b3, (int8_t*)out, s2, s3, s_in, s_out, B, H, W, C, M, R,
      G, kt);
  return (int)cudaGetLastError();
}

#ifdef FUSED_BLOCK_CLOCKS
// The four ring_clocks counters into out, then zeroed.
int fused_block_clocks(unsigned long long* out) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, ring_clocks, sizeof zero);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ring_clocks, zero, sizeof zero);
  return (int)err;
}
#endif

}  // extern "C"
