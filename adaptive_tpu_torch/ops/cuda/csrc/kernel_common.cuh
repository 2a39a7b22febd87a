// Helpers shared by the decode kernels in fused_step.cu and head_topk.cu:
// dtype conversions, the (value, index) order of the vocab heads, and the
// two product tiles that both vocab heads compute their logits with: the
// bf16 tensor-core band (head_mma_band: wgmma on a ring of shared-memory
// tiles that bulk asynchronous copies fill) and the fp32 SIMT tile
// (head_tile_product).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr float NEG = -1e30f;

// Lets `kernel` launch with `bytes` of dynamic shared memory on the current
// device. cudaFuncSetAttribute runs once per kernel, device and larger size,
// not on every launch: the decode step's kernels are short, so the host time
// of each launch shows beside them.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

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

// ------------------------------------------ tensor-core product band (bf16)
// One block owns a band of 64 * NWG rows (NWG consumer warpgroups of 64 rows
// each, and one producer warp) and walks over ntile vocab tiles of 128
// columns, in vocab order:
//   * each warpgroup forms z = (chat + h), rounded once to bf16, once for
//     its 64 rows and keeps it in shared memory, k-block by k-block
//     ([kb][row][64 k], 128 bytes a row) in the 128-byte swizzle that
//     wgmma's descriptors name;
//   * the weight comes tiled: [Vp / 128][KB][128 vocab rows][64 k], each
//     16 KB tile stored as its shared-memory image (K-major, the same
//     swizzle, k zero-filled up to KB * 64), so one thread of the producer
//     warp brings a tile with one bulk asynchronous copy (the TMA engine,
//     cp.async.bulk) into a ring of STAGES tiles, and an mbarrier a stage
//     (full) counts its bytes in;
//   * a warpgroup waits for a stage, starts wgmma.m64n128k16 (bf16 x bf16
//     -> fp32, both operands from shared memory) four times, keeps one step's
//     products in flight, and arrives at the stage's second mbarrier (empty)
//     once the products that read it are done; the producer refills a stage
//     when every warpgroup has;
//   * after a vocab tile's last k-block the warpgroup hands its 64 fp32
//     accumulators a thread to the epilogue, which selects on them (argmax,
//     or top-W and logsumexp). Nothing but the ring ties the warpgroups, so
//     one's epilogue runs under the other's products.
// Rows past B are zeros. H % 8 == 0 keeps z's 16-byte loads aligned.
constexpr int MMA_BN = 128;                  // vocab columns a tile (= BN)
constexpr int MMA_BK = 64;                   // k a ring tile: one swizzle row
constexpr int MMA_ROW_BYTES = MMA_BK * 2;    // 128
constexpr int MMA_TILE_BYTES = MMA_BN * MMA_ROW_BYTES;  // 16 KB of weight a stage
constexpr int WG_ROWS = 64, WG_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ID = 0x7fffffff;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory from its first 1024-byte boundary (the swizzle is a
// function of address bits 4..9; the launch asks for 1024 bytes more)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// mbarriers (8 bytes of shared memory each)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// waits until the barrier has left the phase of this parity; a barrier
// that never does (a fault in the pipeline) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}
// bytes (a multiple of 16) global -> shared by the TMA engine; the bytes
// count in at the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy, through which wgmma reads its operands
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major operand tile in the 128-byte swizzle: rows of
// 128 bytes, groups of 8 rows 1024 bytes apart (SBO), start address in
// 16-byte units, LBO unused at one swizzle row of k, layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (+)= A[64 x 16] B[128 x 16]^T; thread t of the warpgroup holds, for
// j < 16 and e < 2, d[4j + e] = D[16 (t / 32) + (t % 32) / 4][8j + 2 (t % 4) + e]
// and d[4j + 2 + e] = the same column of the row 8 below.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

constexpr int PRODUCER_THREADS = 32;

__host__ __device__ inline size_t head_mma_smem_bytes(int H, int nwg, int stages) {
  const int kb = (H + MMA_BK - 1) / MMA_BK;
  return 1024 + (size_t)kb * nwg * WG_ROWS * MMA_ROW_BYTES + (size_t)stages * MMA_TILE_BYTES +
         (size_t)stages * 16;  // full and empty mbarriers
}

// Called by every thread of a block of NWG * 128 + 32 threads; smem is
// 1024-byte aligned and holds head_mma_smem_bytes(H, NWG, STAGES) - 1024
// bytes. Rows m0 .. m0 + 64 NWG of the batch, vocab tiles tile0 .. tile0 +
// ntile of Wtiles. epi.tile(acc, n0) is called once a vocab tile (n0 its
// first column) by every consumer thread, with the thread's accumulators as
// laid out above. Returns false in the producer warp.
template <int NWG, int STAGES, typename Epi>
__device__ __forceinline__ bool head_mma_band(const __nv_bfloat16* __restrict__ chat,
                                              const __nv_bfloat16* __restrict__ h,
                                              const __nv_bfloat16* __restrict__ Wtiles, int B,
                                              int H, int m0, int tile0, int ntile,
                                              uint8_t* smem, Epi& epi) {
  constexpr int BAND = NWG * WG_ROWS;
  constexpr int A_KB_BYTES = BAND * MMA_ROW_BYTES;  // one k-block of the band
  const int tid = threadIdx.x;
  const int KB = (H + MMA_BK - 1) / MMA_BK;
  const uint32_t ring_base = smem_u32(smem) + KB * A_KB_BYTES;
  const uint32_t full_bar = ring_base + STAGES * MMA_TILE_BYTES;  // [STAGES], then
  const uint32_t empty_bar = full_bar + STAGES * 8;               // [STAGES]
  const int steps = ntile * KB;  // one ring tile a step

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + s * 8, 1);      // the producer's arrival, with the bytes
      mbar_init(empty_bar + s * 8, NWG);   // one thread a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * WG_THREADS) {  // the producer warp: one thread feeds the ring
    if (tid == NWG * WG_THREADS) {
      const __nv_bfloat16* src = Wtiles + (size_t)tile0 * KB * (MMA_TILE_BYTES / 2);
      for (int step = 0; step < steps; ++step) {
        const int stage = step % STAGES;
        // the stage's previous tile has been read by every warpgroup; the
        // first pass over the ring finds the barriers in their first phase
        mbar_wait(empty_bar + stage * 8, ((step / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full_bar + stage * 8, MMA_TILE_BYTES);
        bulk_copy(ring_base + stage * MMA_TILE_BYTES,
                  src + (size_t)step * (MMA_TILE_BYTES / 2), MMA_TILE_BYTES,
                  full_bar + stage * 8);
      }
    }
    return false;
  }

  // z of this warpgroup's 64 rows, formed once: 16 bytes (8 values) of chat
  // and h a thread and turn, Z_UNROLL turns' loads in flight together
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int r0 = wg * WG_ROWS;  // the warpgroup's first row in the band
  constexpr int Z_UNROLL = 8;
  const int row_chunks = KB * 8, wg_chunks = WG_ROWS * row_chunks;
  for (int e0 = wtid; e0 < wg_chunks; e0 += WG_THREADS * Z_UNROLL) {
    uint4 a[Z_UNROLL], b[Z_UNROLL];
#pragma unroll
    for (int u = 0; u < Z_UNROLL; ++u) {
      const int e = e0 + u * WG_THREADS;
      const int row = r0 + e / row_chunks, cc = e % row_chunks;
      a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < wg_chunks && m0 + row < B && cc * 8 < H) {
        const size_t o = (size_t)(m0 + row) * H + cc * 8;
        a[u] = *reinterpret_cast<const uint4*>(chat + o);
        b[u] = *reinterpret_cast<const uint4*>(h + o);
      }
    }
#pragma unroll
    for (int u = 0; u < Z_UNROLL; ++u) {
      const int e = e0 + u * WG_THREADS;
      if (e >= wg_chunks) break;
      const int row = r0 + e / row_chunks, cc = e % row_chunks;
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a[u]);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b[u]);
      uint4 z;
      __nv_bfloat162* z2 = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a2[i]), fb = __bfloat1622float2(b2[i]);
        z2[i] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
      }
      *reinterpret_cast<uint4*>(smem + (cc >> 3) * A_KB_BYTES + row * MMA_ROW_BYTES +
                                (((cc & 7) ^ (row & 7)) << 4)) = z;
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");

  // Step s: wait for its tile, start its products, wait only for step
  // s - 1's and hand that stage back: the tensor cores go on while this
  // warpgroup turns round. Only after a vocab tile's last step does it wait
  // for everything. The k loop holds nothing but products, so that the
  // compiler keeps them in flight across its back edge.
  const uint32_t a_base = smem_u32(smem) + r0 * MMA_ROW_BYTES;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int step = 0;
  for (int t = 0; t < ntile; ++t) {
    int held = -1;  // the stage whose products may still be in flight
    fence_operand(acc);
    for (int kb = 0; kb < KB; ++kb, ++step) {
      const int stage = step % STAGES;
      mbar_wait(full_bar + stage * 8, (step / STAGES) & 1);
      const uint32_t a = a_base + kb * A_KB_BYTES;
      const uint32_t b = ring_base + stage * MMA_TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < MMA_BK / 16; ++k16)
        wgmma_m64n128k16(acc, sw128_desc(a + k16 * 32), sw128_desc(b + k16 * 32),
                         (kb | k16) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (wtid == 0 && held >= 0) mbar_arrive(empty_bar + held * 8);
      held = stage;
    }
    wgmma_wait<0>();
    fence_operand(acc);
    if (wtid == 0) mbar_arrive(empty_bar + held * 8);
    epi.tile(acc, (tile0 + t) * MMA_BN);
  }
  return true;
}

// ------------------------------------------------- SIMT product tile (fp32)
// The tensor cores take fp32 inputs only as TF32 (about three decimal
// digits), so the fp32 instances of both heads keep this tile: exact fp32
// FMAs on the CUDA cores, bounded by their 67 TFLOP/s. A bf16 head whose
// hidden size the tensor-core band does not take (H % 8 != 0 or H > 512)
// runs it too.
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
