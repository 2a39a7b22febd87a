// Hopper (sm_90a) stride-1 1x1 convolution of the BN-folded bf16 encoder
// with its epilogue. Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/conv1x1.py::conv1x1_epilogue, whose plain twin
// conv1x1_epilogue_plain defines the arithmetic.
//
// 9. conv1x1_fprop_epilogue_kernel replaces no TPU kernel: XLA fused each
//    convolution of adaptive_tpu/models/infer.py with its bias, residual add
//    and relu, so the JAX package has no Pallas kernel here. On the card the
//    conv1 and conv3 of every bottleneck (stride 1, 1x1) is a GEMM over the
//    NHWC rows, x [M, K] times the folded kernel W [N, K] (channels_last
//    OIHW: K-major rows), and this kernel applies kernel 7's epilogue to the
//    fp32 accumulators before the one bf16 store:
//      y = relu((x W^T + bias) + r),  r = 0 | residual | (residual + res_bias)
//    with __fadd_rn in kernel 7's association, so that only the rounding of
//    the conv's output to bf16 before the epilogue goes.
//    Bound on an H100 SXM: mostly bytes. A ResNet-152 encode at batch 1,024
//    runs 100 launches (50 conv1 with bias + relu, 50 conv3 with the block
//    input or the downsample's raw output and its bias) over 95.5 GB (x, W,
//    the residual and y, each once), 28.5 ms at 3.35 TB/s, and 10.8 TFLOP,
//    10.9 ms at 989 TFLOP/s; layer 3's conv1 (K 1,024, N 256) and layer 4's
//    need ~70% of the tensor-core peak to stay bytes-bound.
//    Design: a persistent grid, one block an SM, walks 128-row output tiles
//    of BN = 64, 128 or 256 columns, the N tiles of one row band next to
//    each other so that x's band is read from HBM once and from L2 the
//    rest. Four roles a block:
//      * a load warp: one thread brings x's [128 x 64] k-blocks (and W's [BN
//        x 64], unless the whole W stays resident, loaded once) by TMA into
//        a ring of shared-memory stages, in the 128-byte swizzle that
//        wgmma's descriptors name, with a full and an empty mbarrier a
//        stage; TMA zero-fills the rows past M;
//      * two consumer warpgroups, 64 rows each, run wgmma (bf16 x bf16 ->
//        fp32, both operands from shared memory), one instruction for the
//        tile's columns, a k-block's products in flight past the next one's
//        start where the ring outlasts a tile's k-blocks (else each stage
//        goes back as soon as its products are done, so that the loads run
//        further ahead), then the epilogue: bias (and the residual's bias) from
//        L1, the residual tile from shared memory, relu, bf16, written back
//        over the residual in place;
//      * a store warp: one thread loads a tile's residual by TMA into an
//        epilogue buffer ([BN / 64][128 rows][128 bytes], swizzled, so the
//        consumers' 4-byte accesses meet no bank conflict) and, once the
//        consumers have written the tile, stores it by TMA (rows past M are
//        dropped); as each 64-column box of the store has been read out,
//        the residual of the buffer's next tile goes into its place. With a
//        residual two buffers take the tiles in turn, so that one tile's
//        residual arrives while the other's store drains.
//    So the epilogue's traffic (89% of a conv3's bytes) overlaps the
//    products, and x, W, the residual and y cross HBM once. The tile
//    width, the buffers, the stages and the resident W follow M, K and N
//    and the 227 KB of shared memory (plan): no table of shapes.
//    Measured (PERF.md, phase 2f): W's reads from L2 did not bound it (two
//    blocks of a cluster sharing each W tile by TMA multicast were 2%
//    slower); the wait of the next tile's residual for the store of the
//    last did, at one buffer.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "kernel_common.cuh"

namespace {

constexpr int C1_BM = 128;                         // rows a tile: two warpgroups of 64
constexpr int C1_BK = 64;                          // k a ring step: one swizzle row
constexpr int C1_ROW_BYTES = C1_BK * 2;            // 128
constexpr int C1_A_BYTES = C1_BM * C1_ROW_BYTES;   // 16 KB of x a stage
constexpr int C1_BOX_COLS = 64;                    // output columns a TMA box
constexpr int C1_BOX_BYTES = C1_BM * C1_ROW_BYTES;  // 16 KB
constexpr int C1_CONSUMERS = 2 * WG_THREADS;
constexpr int C1_THREADS = C1_CONSUMERS + 64;      // + the load warp and the store warp
constexpr int C1_MAX_STAGES = 8;
constexpr int C1_MIN_STAGES = 2;
constexpr int C1_RESIDENT_MIN_STAGES = 4;  // x stages that a resident W must leave room for
constexpr int C1_FEED_STAGES = 4;  // stages that keep the products fed where K allows
constexpr int C1_SMEM = 232448;            // shared memory a block can use

struct C1Args {
  const __nv_bfloat16* bias;      // [N]
  const __nv_bfloat16* res_bias;  // [N] (MODE 2)
  int n_tiles, tiles, kb, stages, n;
  int resident;                   // the whole W resident in shared memory, loaded once
  int bufs;                       // epilogue buffers (1 or 2), taken in turn
  int overlap;                    // a k-block's products in flight past the next one's start
};

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most n of this thread's store groups still read shared memory
__device__ __forceinline__ void bulk_wait_read(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory"); break;
  }
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma
// d (+)= A[64 x 16] B[64 x 16]^T, laid out as wgmma_m64n128k16's d
// (kernel_common.cuh) over 8 column groups
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A[64 x 16] B[256 x 16]^T, laid out as wgmma_m64n128k16's d
// (kernel_common.cuh) over 32 column groups: A is read once for all 256
// columns
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// acc (+)= A[64 x 16] B[BN x 16]^T; a, b: the operands' shared addresses.
// acc[4j + 2h + e] = D[row + 8h][8j + 2 (t % 4) + e] for column group j.
// One instruction for the tile's columns, so that A is read once (two of
// 128 columns at BN = 256 took 0.4-7% longer at the encode's shapes).
template <int BN>
__device__ __forceinline__ void tile_mma(float (&acc)[BN / 2], uint32_t a, uint32_t b,
                                         int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64k16(acc, sw128_desc(a), sw128_desc(b), scale_d);
  else if constexpr (BN == 128)
    wgmma_m64n128k16(acc, sw128_desc(a), sw128_desc(b), scale_d);
  else
    wgmma_m64n256k16(acc, sw128_desc(a), sw128_desc(b), scale_d);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN kept

// MODE 0: bias + relu; 1: + residual; 2: + (residual + res_bias).
template <int BN, int MODE>
__global__ void __launch_bounds__(C1_THREADS, 1)
conv1x1_fprop_epilogue_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_w,
                              const __grid_constant__ CUtensorMap map_r,
                              const __grid_constant__ CUtensorMap map_y, const C1Args args) {
  constexpr int NBOX = BN / C1_BOX_COLS;
  constexpr int W_BYTES = BN * C1_ROW_BYTES;  // W's k-block of one tile
  constexpr int E_BYTES = NBOX * C1_BOX_BYTES;  // an epilogue buffer
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int tid = threadIdx.x;
  const int S = args.stages, KB = args.kb, NE = args.bufs;
  const uint32_t wk_bytes = (uint32_t)args.n * C1_ROW_BYTES;  // a resident k-block of W
  const uint32_t res_bytes = args.resident ? (uint32_t)KB * wk_bytes : 0u;
  const uint32_t stage_bytes = C1_A_BYTES + (args.resident ? 0 : W_BYTES);
  const uint32_t ebuf = smem_u32(smem);           // [NE][NBOX][128 rows][128 bytes]
  const uint32_t wres = ebuf + NE * E_BYTES;       // [KB][N rows][128 bytes]
  const uint32_t ring = wres + res_bytes;          // [S] of (x [128][128 B], W [BN][128 B])
  const uint32_t full_bar = ring + S * stage_bytes;  // [S]
  const uint32_t empty_bar = full_bar + S * 8;       // [S]
  const uint32_t w_bar = empty_bar + S * 8;          // the resident W arrived
  const uint32_t efull_bar = w_bar + 8;              // [2] a tile's residual arrived (buffer free)
  const uint32_t ewritten_bar = efull_bar + 16;      // [2] a tile's output written to the buffer

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + s * 8, 1);   // the load thread's arrival, with the bytes
      mbar_init(empty_bar + s * 8, 2);  // one thread a warpgroup
    }
    mbar_init(w_bar, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(efull_bar + b * 8, 1);
      mbar_init(ewritten_bar + b * 8, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp == C1_CONSUMERS / 32) {  // the load warp
    if (lane == 0) {
      if (args.resident) {  // in [BN x 64] boxes
        mbar_arrive_expect_tx(w_bar, res_bytes);
        for (int kb = 0; kb < KB; ++kb)
          for (int n0 = 0; n0 < args.n; n0 += BN)
            tma_load(wres + kb * wk_bytes + n0 * C1_ROW_BYTES, &map_w, kb * C1_BK, n0, w_bar);
      }
      int step = 0;
      for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
        const int m0 = tile / args.n_tiles * C1_BM, n0 = tile % args.n_tiles * BN;
        for (int kb = 0; kb < KB; ++kb, ++step) {
          const int s = step % S;
          const uint32_t st = ring + s * stage_bytes;
          mbar_wait(empty_bar + s * 8, ((step / S) & 1) ^ 1);
          mbar_arrive_expect_tx(full_bar + s * 8, stage_bytes);
          tma_load(st, &map_x, kb * C1_BK, m0, full_bar + s * 8);
          if (!args.resident) tma_load(st + C1_A_BYTES, &map_w, kb * C1_BK, n0, full_bar + s * 8);
        }
      }
    }
    return;
  }
  if (warp == C1_CONSUMERS / 32 + 1) {  // the store warp
    if (lane == 0) {
      // the residual of `tile` into buffer b, each box once the store that
      // held its place has read it out (stored: the buffer's last tile was
      // just stored)
      auto fetch = [&](int tile, int b, bool stored) {
        const uint32_t full = efull_bar + b * 8, buf = ebuf + b * E_BYTES;
        if (MODE == 0) {
          if (stored) bulk_wait_read(0);
          return mbar_arrive(full);
        }
        const int m0 = tile / args.n_tiles * C1_BM, n0 = tile % args.n_tiles * BN;
        mbar_arrive_expect_tx(full, E_BYTES);
        for (int c = 0; c < NBOX; ++c) {
          if (stored) bulk_wait_read(NBOX - 1 - c);
          tma_load(buf + c * C1_BOX_BYTES, &map_r, n0 + c * C1_BOX_COLS, m0, full);
        }
      };
      for (int b = 0; b < NE; ++b)
        if ((int)blockIdx.x + b * (int)gridDim.x < args.tiles)
          fetch(blockIdx.x + b * gridDim.x, b, false);
      int t = 0;
      for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x, ++t) {
        const int m0 = tile / args.n_tiles * C1_BM, n0 = tile % args.n_tiles * BN;
        const int b = t % NE;
        mbar_wait(ewritten_bar + b * 8, (t / NE) & 1);
        for (int c = 0; c < NBOX; ++c) {
          tma_store(&map_y, ebuf + b * E_BYTES + c * C1_BOX_BYTES, n0 + c * C1_BOX_COLS, m0);
          bulk_commit();
        }
        const int next = tile + NE * gridDim.x;
        if (next < args.tiles) fetch(next, b, true);
      }
      bulk_wait_all();
    }
    return;
  }

  // the consumer warpgroups
  const int wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int q = lane & 3, g = lane >> 2;         // column pair, row within 8
  const int row = wg * 64 + (wtid / 32) * 16 + g;  // the tile row of acc[4j + e]; +8 for 4j+2+e
  if (args.resident) mbar_wait(w_bar, 0);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int step = 0, t = 0;
  for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x, ++t) {
    const int n0 = tile % args.n_tiles * BN;
    int held = -1;  // the stage whose products may still be in flight
    fence_acc(acc);
    for (int kb = 0; kb < KB; ++kb, ++step) {
      const int s = step % S;
      const uint32_t st = ring + s * stage_bytes;
      mbar_wait(full_bar + s * 8, (step / S) & 1);
      const uint32_t a = st + wg * 64 * C1_ROW_BYTES;
      const uint32_t b = args.resident ? wres + kb * wk_bytes + n0 * C1_ROW_BYTES
                                       : st + C1_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < C1_BK / 16; ++k16)
        tile_mma<BN>(acc, a + k16 * 32, b + k16 * 32, (kb | k16) != 0);
      wgmma_commit();
      if (args.overlap) {  // hand back the last k-block's stage
        wgmma_wait<1>();
        if (wtid == 0 && held >= 0) mbar_arrive(empty_bar + held * 8);
        held = s;
      } else {  // this one's, a k-block sooner
        wgmma_wait<0>();
        if (wtid == 0) mbar_arrive(empty_bar + s * 8);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (wtid == 0 && held >= 0) mbar_arrive(empty_bar + held * 8);

    const int eb = t % NE;
    mbar_wait(efull_bar + eb * 8, (t / NE) & 1);
    uint8_t* const buf = smem + eb * E_BYTES;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(args.bias + n0 + col));
      float2 rb = make_float2(0.f, 0.f);
      if (MODE == 2)
        rb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.res_bias + n0 + col));
      // box j / 8, 16-byte unit j % 8 of the row, swizzled by row % 8 (= g)
      uint8_t* base = buf + (j / 8) * C1_BOX_BYTES + (((j % 8) ^ g) << 4) + 4 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(base + (row + 8 * h) * C1_ROW_BYTES);
        float y0 = __fadd_rn(acc[4 * j + 2 * h], b.x), y1 = __fadd_rn(acc[4 * j + 2 * h + 1], b.y);
        if (MODE != 0) {
          float2 r = __bfloat1622float2(*p);
          if (MODE == 2) r = make_float2(__fadd_rn(r.x, rb.x), __fadd_rn(r.y, rb.y));
          y0 = __fadd_rn(y0, r.x), y1 = __fadd_rn(y1, r.y);
        }
        *p = __floats2bfloat162_rn(relu(y0), relu(y1));
      }
    }
    fence_proxy_async();  // the writes, to the TMA store's async proxy
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG_THREADS) : "memory");
    if (wtid == 0) mbar_arrive(ewritten_bar + eb * 8);
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once (the library links
// only the runtime)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  });
  return fn;
}

// a bf16 [outer, inner] row-major tensor in boxes of [box_outer][64] in the
// 128-byte swizzle; reads past `outer` fill zeros, writes past it drop
bool tensor_map(CUtensorMap* map, const void* base, long long outer, int inner, int box_outer) {
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  cuuint32_t box[2] = {(cuuint32_t)C1_BK, (cuuint32_t)box_outer};
  cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (n[dev] == 0) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// The launch plan of a shape: tile width, resident W, ring stages,
// epilogue buffers, shared bytes.
struct C1Plan {
  int bn, resident, stages, bufs;
  size_t smem;
};

// Resident W, stages and shared bytes for p.bn and p.bufs: W stays resident
// where it leaves room for C1_RESIDENT_MIN_STAGES stages of x. Returns the
// stages.
int fill(C1Plan& p, int K, int N) {
  const size_t fixed = 1024 + (size_t)p.bufs * p.bn * C1_BM * 2 + (2 * C1_MAX_STAGES + 5) * 8;
  const size_t w_all = (size_t)N * K * 2;
  p.resident = fixed + w_all + C1_RESIDENT_MIN_STAGES * C1_A_BYTES <= C1_SMEM;
  const size_t stage = C1_A_BYTES + (p.resident ? 0 : (size_t)p.bn * C1_ROW_BYTES);
  const size_t used = fixed + (p.resident ? w_all : 0);
  const size_t room = C1_SMEM > used ? C1_SMEM - used : 0;
  p.stages = (int)(room / stage < (size_t)C1_MAX_STAGES ? room / stage : C1_MAX_STAGES);
  p.smem = used + (size_t)p.stages * stage;
  return p.stages;
}

// The widest tile (256, 128 or 64 columns) that divides N and still gives
// half the SMs a tile (narrower tiles of few rows, serving's batch in
// layer 4, cost more than idle SMs). With a residual the epilogue moves
// most of the bytes, and one buffer leaves the next tile's residual to
// wait for this tile's store: two buffers where they leave a stage for
// each k-block up to 4 (the products need no more to stay fed), at half
// the width if need be. (Phase 2f of chip_smoke.py times each shape; at
// batch 1,024 this rule came within 0.4% of the best of the six widths and
// buffer counts at each shape.)
C1Plan plan(long long M, int K, int N, bool residual, int sms) {
  C1Plan p;
  const long long m_tiles = (M + C1_BM - 1) / C1_BM;
  p.bn = C1_BOX_COLS;
  for (int bn = 256; bn > C1_BOX_COLS; bn /= 2)
    if (N % bn == 0 && 2 * m_tiles * (N / bn) >= sms) {
      p.bn = bn;
      break;
    }
  const int want = K / C1_BK < C1_FEED_STAGES ? K / C1_BK : C1_FEED_STAGES;
  for (int bn = p.bn; residual && bn >= p.bn / 2 && bn >= C1_BOX_COLS; bn /= 2) {
    C1Plan q = p;
    q.bn = bn, q.bufs = 2;
    if (fill(q, K, N) >= (want > C1_MIN_STAGES ? want : C1_MIN_STAGES)) return q;
  }
  p.bufs = 1;
  fill(p, K, N);
  return p;
}

template <int BN, int MODE>
int launch_mode(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mr,
                const CUtensorMap& my, const C1Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kernel = &conv1x1_fprop_epilogue_kernel<BN, MODE>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C1_THREADS, smem, st>>>(mx, mw, mr, my, a);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_bn(int mode, const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mr,
              const CUtensorMap& my, const C1Args& a, int grid, size_t smem, cudaStream_t st) {
  if (mode == 0) return launch_mode<BN, 0>(mx, mw, mr, my, a, grid, smem, st);
  if (mode == 1) return launch_mode<BN, 1>(mx, mw, mr, my, a, grid, smem, st);
  return launch_mode<BN, 2>(mx, mw, mr, my, a, grid, smem, st);
}

int launch_plan(const void* x, const void* w, const void* bias, const void* residual,
                const void* res_bias, void* y, long long M, int K, int N, const C1Plan& p,
                int sms, cudaStream_t st) {
  if (p.stages < C1_MIN_STAGES) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (M + C1_BM - 1) / C1_BM, tiles = m_tiles * (N / p.bn);
  if (tiles > 0x7fffffffLL || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw, mr, my;
  if (!tensor_map(&mx, x, M, K, C1_BM) ||
      !tensor_map(&mw, w, N, K, p.bn) ||
      !tensor_map(&my, y, M, N, C1_BM) ||
      !tensor_map(&mr, residual ? residual : y, M, N, C1_BM))
    return (int)cudaErrorInvalidValue;
  C1Args a;
  a.bias = (const __nv_bfloat16*)bias;
  a.res_bias = (const __nv_bfloat16*)res_bias;
  a.n_tiles = N / p.bn, a.tiles = (int)tiles, a.kb = K / C1_BK, a.stages = p.stages, a.n = N;
  a.resident = p.resident, a.bufs = p.bufs;
  // where the ring is shorter than a tile's k-blocks, a stage handed back a
  // k-block sooner lets the loads run a stage further ahead, which gained
  // more (up to 4% at the encode's shapes) than the products' overlap
  a.overlap = p.stages > a.kb;
  const int grid = (int)(tiles < sms ? tiles : sms);
  const int mode = residual == nullptr ? 0 : res_bias == nullptr ? 1 : 2;
  if (p.bn == 256) return launch_bn<256>(mode, mx, mw, mr, my, a, grid, p.smem, st);
  if (p.bn == 128) return launch_bn<128>(mode, mx, mw, mr, my, a, grid, p.smem, st);
  return launch_bn<64>(mode, mx, mw, mr, my, a, grid, p.smem, st);
}

bool takes(long long M, int K, int N, const void* residual, const void* res_bias) {
  return M >= 0 && K >= C1_BK && N >= C1_BOX_COLS && K % C1_BK == 0 && N % C1_BOX_COLS == 0 &&
         (residual || !res_bias);
}

}  // namespace

extern "C" {

// x [M, K], w [N, K], y and residual [M, N], bias and res_bias [N], all
// bf16, contiguous and 16-byte aligned (checked by the wrapper); K and N
// multiples of 64; residual null: none; res_bias null: none. Writes y.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// shape outside these or a res_bias without a residual, or
// cudaErrorNotSupported where libcuda gives no tensor-map encoder.
int conv1x1_epilogue_launch(const void* x, const void* w, const void* bias, const void* residual,
                            const void* res_bias, void* y, long long M, int K, int N,
                            void* stream) {
  if (!takes(M, K, N, residual, res_bias)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  return launch_plan(x, w, bias, residual, res_bias, y, M, K, N,
                     plan(M, K, N, residual != nullptr, sms), sms, (cudaStream_t)stream);
}

// The plan conv1x1_epilogue_launch takes for x [M, K] and w [N, K], with or
// without a residual, for the probes: out = {tile columns, W resident, ring
// stages, shared bytes, epilogue buffers}.
int conv1x1_epilogue_plan(long long M, int K, int N, int residual, int* out) {
  if (!takes(M, K, N, nullptr, nullptr)) return (int)cudaErrorInvalidValue;
  const C1Plan p = plan(M, K, N, residual != 0, sm_count());
  out[0] = p.bn, out[1] = p.resident, out[2] = p.stages, out[3] = (int)p.smem, out[4] = p.bufs;
  return (int)cudaSuccess;
}

}  // extern "C"
