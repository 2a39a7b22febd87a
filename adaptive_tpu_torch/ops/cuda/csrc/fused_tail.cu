// Hopper (sm_90a) fused bottleneck tail + next block's conv1 of the int8
// encoder. Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/fused_tail.py::tail_conv1_int8, whose plain twin
// tail_conv1_int8_plain defines the arithmetic and whose tail_plan picks the
// launch plan passed in here.
//
// 6. tail_conv1_kernel replaces adaptive_tpu/ops/pallas/fused_tail.py::
//    tail_conv1_int8 (body _kernel): for the carry rows [N, C] of blocks
//    (i, i+1),
//      out = requant(relu(z2 @ w3 * sc3 + b3 + x * s_in), s_out)     (M -> C)
//      z1  = requant(relu(out @ w1 * sc1 + b1), s_next)              (C -> M2)
//    Bound on an H100 SXM at batch 1024: 2 N C (M + M2) int8 operations,
//    2.1e11 at M2 = M in every layer of ResNet-152 (N C M is the same in
//    each), against N (2 C + M + M2) bytes (x, z2 read; out, z1 written):
//    layer3 (N = 200,704, C 1024, M = M2 = 256) 0.51 GB -> 0.153 ms; layer1
//    (N = 3,211,264, C 256, M = M2 = 64) 2.06 GB -> 0.615 ms: bytes in every
//    layer.
//    Design: both products are row-wise, so a block owns P carry rows (a
//    multiple of 16, tail_plan; the last block ragged) and runs two products
//    one after the other through int8_common.cuh::ring_product, as kernel 5
//    does: each [NT x KT] weight chunk is copied once a block into a ring of
//    shared-memory slots by cp.async and read by all 8 warps with ldmatrix
//    into mma.sync m16n8k32 s8, so w3 and w1 cross L2 once a block (2 N C M
//    / P bytes a launch), not once a 16-row warp tile. The block's z2 rows
//    are copied once into shared memory. Stage 1 computes conv3: the x tile
//    comes through the ring with a column chunk's last K step, the s8 carry
//    is formed in its place and written to device memory (block i+1 reads
//    it as its residual) in VEC-byte stores and to a shared carry tile.
//    Stage 2 computes conv1 of block i+1 from that tile (K = C), so the
//    carry is never read back from device memory, which is the point of
//    the fusion, and writes z1 through the ring slot in VEC-byte stores.
//    What bounds it on the card, as for kernel 5: the epilogues (an IEEE
//    division a value; relu's zeros skip it, requant_relu) and the latency
//    of each ring step, not the tensor rate; so the kernel is built for two
//    blocks an SM (registers capped at 128 a thread) and tail_plan prefers
//    plans whose shared bytes let two blocks share an SM. PERF.md has the
//    measured times against the bound.

#include "int8_common.cuh"

namespace {

// Registers for two blocks an SM (at most 128 a thread), as kernel 5's.
template <int WC, int VEC>
__global__ void __launch_bounds__(I8_THREADS, 2)
tail_conv1_kernel(const int8_t* __restrict__ x,    // [N, C] block i's input carry
                  const int8_t* __restrict__ z2,   // [N, M] block i's conv2 output
                  const int8_t* __restrict__ w3,   // [C, M]
                  const float* __restrict__ sc3, const float* __restrict__ b3,  // [C]
                  const int8_t* __restrict__ w1,   // [M2, C]
                  const float* __restrict__ sc1, const float* __restrict__ b1,  // [M2]
                  int8_t* __restrict__ out,        // [N, C]
                  int8_t* __restrict__ z1,         // [N, M2]
                  float s_in, float s_out, float s_next, int N, int C, int M, int M2, int P,
                  int KT) {
  extern __shared__ __align__(16) int8_t smem[];
  const int r0 = blockIdx.x * P, rows = min(P, N - r0);
  const int ldm = act_ld(M), ldc = act_ld(C), sbytes = slot_bytes(WC * RING_NF * 8, KT, P);
  int8_t* z2s = smem;                          // [P, ldm]: z2 rows r0 ..
  int8_t* carry = z2s + (size_t)P * ldm;       // [P, ldc]: the new carry's rows r0 ..
  int8_t* ring = carry + (size_t)P * ldc;      // [RING_STAGES, sbytes]
  RING_CLOCK_START(t0);

  // the block's z2 rows, one cp.async group: complete at stage 1's first wait
  const int units = M / VEC;
  const int8_t* src = z2 + (size_t)r0 * M;
  for (int i = threadIdx.x; i < rows * units; i += I8_THREADS) {
    const int r = i / units, c = (i - r * units) * VEC;
    cp_async<VEC>(smem_u32(z2s + r * ldm + c), src + (size_t)r * M + c, true);
  }
  cp_async_commit();

  // stage 1: conv3 (1x1) + dequantised residual + relu + requant, to the
  // carry in device memory and in shared memory
  PlainRows z2rows;
  z2rows.base = smem_u32(z2s);
  z2rows.ld = ldm, z2rows.P = rows;
  ring_product<WC, VEC, false, true, TO_BOTH>(ring, sbytes, KT, rows, C, 1, M, w3, nullptr,
                                              z2rows, sc3, b3, s_out, carry, ldc,
                                              x + (size_t)r0 * C, s_in, out + (size_t)r0 * C);
  RING_CLOCK(0, t0);

  // stage 2: block i+1's conv1 (1x1) + relu + requant from the shared carry
  PlainRows crows;
  crows.base = smem_u32(carry);
  crows.ld = ldc, crows.P = rows;
  ring_product<WC, VEC, false, false, TO_DEVICE>(ring, sbytes, KT, rows, M2, 1, C, w1, nullptr,
                                                 crows, sc1, b1, s_next, nullptr, 0, nullptr,
                                                 0.f, z1 + (size_t)r0 * M2);
  RING_CLOCK(1, t0);
}

}  // namespace

extern "C" {

// Shared bytes of a plan: z2 [P, act_ld(M)], the carry [P, act_ld(C)] and
// the ring. ops/fused_tail.py::tail_smem mirrors it.
static size_t tail_smem(int C, int M, int P, int nt, int kt) {
  return (size_t)P * (act_ld(M) + act_ld(C)) + (size_t)RING_STAGES * slot_bytes(nt, kt, P);
}

// N rows; C, M, M2 multiples of 8 and the tensors 16-byte aligned (checked
// by the wrapper). The plan (ops/fused_tail.py::tail_plan): P rows a block
// (a multiple of 16), a column chunk of nt = 64 or 128, a K chunk of kt =
// 64 or 128 (kt + 16 >= nt: stage 1 stages an nt-wide residual tile in
// kt + 16-byte rows), smem bytes, and vec = 16-byte copies (C, M and M2
// multiples of 16) or 8-byte ones. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan outside these values or whose
// smem disagrees with tail_smem.
int tail_conv1_launch(const void* x, const void* z2, const void* w3, const void* sc3,
                      const void* b3, const void* w1, const void* sc1, const void* b1, void* out,
                      void* z1, float s_in, float s_out, float s_next, int N, int C, int M,
                      int M2, int P, int nt, int kt, int smem, int vec, void* stream) {
  if (N < 1 || C < 8 || M < 8 || M2 < 8 || C % 8 || M % 8 || M2 % 8 || P < 16 || P % 16 ||
      (nt != 64 && nt != 128) || (kt != 64 && kt != 128) || kt + 16 < nt ||
      (vec != 8 && vec != 16) || (vec == 16 && (C % 16 || M % 16 || M2 % 16)))
    return (int)cudaErrorInvalidValue;
  const size_t need = tail_smem(C, M, P, nt, kt);
  if (need != (size_t)smem || need > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool v16 = vec == 16;  // 16-byte copies need rows of 16-byte multiples
  auto kernel = v16 ? &tail_conv1_kernel<2, 16> : &tail_conv1_kernel<2, 8>;
  if (nt == 128) kernel = v16 ? &tail_conv1_kernel<4, 16> : &tail_conv1_kernel<4, 8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + P - 1) / P, I8_THREADS, need, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)z2, (const int8_t*)w3, (const float*)sc3,
      (const float*)b3, (const int8_t*)w1, (const float*)sc1, (const float*)b1, (int8_t*)out,
      (int8_t*)z1, s_in, s_out, s_next, N, C, M, M2, P, kt);
  return (int)cudaGetLastError();
}

#ifdef FUSED_BLOCK_CLOCKS
// The four ring_clocks counters (stage 1, stage 2, -, the epilogues) into
// out, then zeroed.
int fused_tail_clocks(unsigned long long* out) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, ring_clocks, sizeof zero);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ring_clocks, zero, sizeof zero);
  return (int)err;
}
#endif

}  // extern "C"
