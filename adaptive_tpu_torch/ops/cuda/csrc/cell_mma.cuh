// The bf16 decode cell on Hopper's tensor cores (kernels 1 and 3: the
// instance "mma" of ops/fused_step.py::cell_instance), in two kernels that
// one call of adaptive_cell_launch starts back to back on one stream.
//
// Stage 1, cell_gates_kernel<BM, NU>: the LSTM gates and the sentinel's
// pre-activation as two bf16 products with fp32 sums on mma.sync.m16n8k16,
//   gates = h_in . W_hh                 (K = H,      N = 4H)
//   pre_s = [x | h_prev] . [W_x; W_hs]  (K = E2 + H, N = H)
// then the cell's epilogue on the accumulators. A block owns a band of BM
// rows and a slice of NU hidden units (launched at CELL_BM = 64 by CELL_NU =
// 32, two or three blocks an SM). The weights come reordered once per
// checkpoint (fused_step.py::cell_kernel_tiles): whh_t [4H][H] holds at row
// 32a + 8g + t the column g H + 8a + t of W_hh (gate g of unit 8a + t), and
// wsen_t [H][E2 + H] at row u the column u of W_x over W_hs, both K-major.
// So an n8 tile of the gate product is one gate of 8 units, and the four
// gate tiles and the sentinel tile of the same 8 units land in the same
// lanes: the thread that holds accumulator column 2q + e holds i, f, g, o
// and s of one unit, and c', h' and s need no exchange. Each K step of 64
// copies the band's [BM x 64] A chunk (h_in, x or h_prev) and the slice's
// [N x 64] weight chunk into a ring of CELL_STAGES slots (cp.async, 128-byte
// rows in an XOR swizzle of their 16-byte chunks, so ldmatrix reads 8 rows
// from 8 bank groups); a warp multiplies 32 rows by 16 units (8 gate tiles
// and 2 sentinel tiles: 80 fp32 accumulators a thread). bf16 x bf16 is exact
// in fp32, so only the order of the sums differs from the twin. The ring,
// once free, takes the tile's gx and c_in for the epilogue. h' and s are
// written in fp32 to scratch for stage 2, h' and c' in bf16 to the outputs.
//
// Stage 2, cell_attend_kernel: adaptive attention, one block per group of
// `images` whole images and all their W beam rows (no image straddles two
// blocks). h'.Wg and s.Ws keep fp32 left operands, as in the TPU kernel
// (fp32 FMAs, no operand rounded): a thread a column, the rows' h' and s and
// [Wg | Ws] (k-blocked) staged in shared memory chunk by chunk, so the
// weights cross L2 once a block. The K x D tanh logits read each pv row
// from shared memory once for the image's W rows; both softmaxes; alpha.V
// with each 16-byte V load feeding the image's W rows. V and pv cross
// device memory once a step.
//
// Bound at 3,072 rows (beam 3, 1,024 images), bf16: ~107 MB of device
// bytes (V 51 MB, gx 25 MB, states, pv, weights and outputs; 0.032 ms at
// 3.35 TB/s) against ~9.7 GFLOP of tensor products (0.010 ms at 989
// TFLOP/s); at 1,024 rows (greedy) ~75 MB, 0.0225 ms. What
// holds it instead: stage 1 reads its operands from L2 once a block (the
// band's A by all H / NU slices, the slice's weights by all R / BM bands:
// ~295 MB at 64 x 32 for beam 3) through ldmatrix and mma.sync, and stage
// 2's fp32 products h'.Wg and s.Ws are bound by shared-memory reads (two
// 16-byte reads of a broadcast row a thread and 8 multiply-adds), its
// accurate tanhf by the SFU, and alpha.V by the HBM stream of V.
#pragma once

#include "kernel_common.cuh"

namespace {

constexpr int CELL_CK = 64;          // k of a ring chunk: one 128-byte row of bf16
constexpr int CELL_ROW_BYTES = 128;
constexpr int CELL_STAGES = 3;       // ring slots: two chunks in flight while one is multiplied
constexpr int CELL_BM = 64;          // rows of a stage-1 block (ops/fused_step.py CELL_BAND_ROWS)
constexpr int CELL_NU = 32;          // hidden units of a stage-1 block (CELL_UNITS)

template <int BM, int NU>
struct CellTile {
  static constexpr int WM = BM / 32, WN = NU / 16;  // warps down the band, across the slice
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int NG = 4 * NU;                 // gate columns of the slice
  static constexpr int SLOT = (BM + NG) * CELL_ROW_BYTES;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // at most 128 registers a thread
  // the epilogue's operands, staged where the ring was once it is free: gx
  // [BM][4][NU] fp32 (a row GX_LD floats: 8 more than 4 NU, so that the 8
  // rows a warp reads at once fall on two bank offsets a pair) and c_in
  // [BM][NU] bf16
  static constexpr int GX_LD = 4 * NU + 8;
  static constexpr int EPI = BM * GX_LD * 4 + BM * NU * 2;
  static constexpr int SMEM = CELL_STAGES * SLOT > EPI ? CELL_STAGES * SLOT : EPI;
};

__device__ __forceinline__ void cell_cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cell_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cell_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// swizzled address of 16-byte chunk c of row r of a chunk of 128-byte rows
__device__ __forceinline__ uint32_t cell_swz(uint32_t base, int r, int c) {
  return base + r * CELL_ROW_BYTES + (((c ^ r) & 7) << 4);
}

// rows x 64 bf16 from src (row stride ld, columns k0..k0+63) into a ring
// chunk; rows at or past `valid` are zero-filled (nothing is read)
__device__ __forceinline__ void cell_stage_rows(uint32_t dst, const __nv_bfloat16* src, int ld,
                                                int k0, int rows, int valid, int tid,
                                                int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < valid;
    cell_cp16(cell_swz(dst, r, c), src + (size_t)(ok ? r : 0) * ld + k0 + c * 8, ok);
  }
}

__device__ __forceinline__ void cell_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A (16 x 16, row-major) B (16 x 8, column-major), bf16 in, fp32 sums.
// Lane (g = lane / 4, q = lane % 4) holds d0, d1 = D[g][2q, 2q + 1] and
// d2, d3 = D[g + 8][2q, 2q + 1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float cell_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

#ifdef CELL_CLOCKS  // tools/torch_cell_probe.py --clocks: SM cycles, summed over blocks
// [0] stage 1's ring, [1] its epilogue; [2] stage 2's prologue, [3..6] its phases a-d
__device__ unsigned long long cell_clocks[7];
#define CELL_CLOCK_START(t0) long long t0 = clock64()
#define CELL_CLOCK(i, t0)                                      \
  if (threadIdx.x == 0) {                                      \
    const long long t1 = clock64();                            \
    atomicAdd(&cell_clocks[i], (unsigned long long)(t1 - t0)); \
    t0 = t1;                                                   \
  }
#else
#define CELL_CLOCK_START(t0)
#define CELL_CLOCK(i, t0)
#endif

// ------------------------------------------------------------------ stage 1
template <int BM, int NU>
__global__ void __launch_bounds__(CellTile<BM, NU>::THREADS, CellTile<BM, NU>::MIN_BLOCKS)
cell_gates_kernel(const float* __restrict__ gx,            // [R, 4H] fp32
                  const __nv_bfloat16* __restrict__ h_in,  // [R, H]
                  const __nv_bfloat16* __restrict__ c_in,  // [R, H]
                  const __nv_bfloat16* __restrict__ x,     // [R, E2]
                  const __nv_bfloat16* __restrict__ hp,    // [R, H]
                  const __nv_bfloat16* __restrict__ whh_t,   // [4H, H], reordered
                  const __nv_bfloat16* __restrict__ wsen_t,  // [H, E2 + H]
                  const __nv_bfloat16* __restrict__ bhh,     // [4H]
                  __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ c_out,
                  float* __restrict__ hn32, float* __restrict__ s32,  // [R, H] fp32
                  int R, int H, int E2) {
  using L = CellTile<BM, NU>;
  extern __shared__ __align__(128) uint8_t cell_smem[];
  const uint32_t sbase = smem_u32(cell_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int m0 = blockIdx.x * BM, u0 = blockIdx.y * NU;
  const int valid = min(BM, R - m0);
  const int KS = E2 + H;
  const int kg = H / CELL_CK, kx = E2 / CELL_CK;
  const int steps = kg + KS / CELL_CK;

  // step st < kg: h_in and W_hh's gate rows; then x, h_prev and the sentinel rows
  auto load = [&](int st) {
    const uint32_t a = sbase + (st % CELL_STAGES) * L::SLOT;
    const uint32_t b = a + BM * CELL_ROW_BYTES;
    if (st < kg) {
      cell_stage_rows(a, h_in + (size_t)m0 * H, H, st * CELL_CK, BM, valid, tid, L::THREADS);
      cell_stage_rows(b, whh_t + (size_t)u0 * 4 * H, H, st * CELL_CK, L::NG, L::NG, tid,
                      L::THREADS);
    } else {
      const int ks = st - kg;
      if (ks < kx)
        cell_stage_rows(a, x + (size_t)m0 * E2, E2, ks * CELL_CK, BM, valid, tid, L::THREADS);
      else
        cell_stage_rows(a, hp + (size_t)m0 * H, H, (ks - kx) * CELL_CK, BM, valid, tid,
                        L::THREADS);
      cell_stage_rows(b, wsen_t + (size_t)u0 * KS, KS, ks * CELL_CK, NU, NU, tid, L::THREADS);
    }
  };

  CELL_CLOCK_START(t0);
  float accg[2][8][4], accs[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[mi][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accs[mi][j][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < CELL_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cell_commit();
  }
  // the lane's ldmatrix rows: A (m16 x k16: rows lane % 16, chunk lane / 16)
  // and B (two n8 tiles x k16: rows lane % 8 + 8 (lane / 16), chunk (lane / 8) % 2)
  const int a_row = wm * 32 + (lane & 15), a_chunk = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;
  for (int st = 0; st < steps; ++st) {
    cell_wait<CELL_STAGES - 2>();
    __syncthreads();  // the chunk of step st is in; the slot of step st - 1 is free
    if (st + CELL_STAGES - 1 < steps) load(st + CELL_STAGES - 1);
    cell_commit();
    const uint32_t a = sbase + (st % CELL_STAGES) * L::SLOT;
    const uint32_t b = a + BM * CELL_ROW_BYTES;
    if (st < kg) {
#pragma unroll
      for (int kk = 0; kk < CELL_CK / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          cell_ldsm_x4(af[mi], cell_swz(a, a_row + 16 * mi, 2 * kk + a_chunk));
#pragma unroll
        for (int p = 0; p < 4; ++p) {  // gate tiles 2p, 2p + 1: rows 64 wn + 16 p
          uint32_t bf[4];
          cell_ldsm_x4(bf, cell_swz(b, 64 * wn + 16 * p + b_row, 2 * kk + b_chunk));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16_16816(accg[mi][2 * p], af[mi], bf[0], bf[1]);
            mma_bf16_16816(accg[mi][2 * p + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < CELL_CK / 16; ++kk) {
        uint32_t af[2][4], bf[4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          cell_ldsm_x4(af[mi], cell_swz(a, a_row + 16 * mi, 2 * kk + a_chunk));
        cell_ldsm_x4(bf, cell_swz(b, 16 * wn + b_row, 2 * kk + b_chunk));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(accs[mi][0], af[mi], bf[0], bf[1]);
          mma_bf16_16816(accs[mi][1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cell_wait<0>();
  __syncthreads();  // the ring is free: it takes the tile's gx and c_in, one copy in flight
  {
    const uint32_t gxs = sbase, cs = sbase + BM * L::GX_LD * 4;
    const int gp = NU / 4, cp = NU / 8;  // 16-byte pieces of a gate's units, of c_in's
    for (int i = tid; i < BM * 4 * gp; i += L::THREADS) {
      const int r = i / (4 * gp), g = (i / gp) % 4, p = i % gp;
      const bool ok = r < valid;
      cell_cp16(gxs + (r * L::GX_LD + g * NU + 4 * p) * 4,
                gx + (size_t)(m0 + (ok ? r : 0)) * 4 * H + g * H + u0 + 4 * p, ok);
    }
    for (int i = tid; i < BM * cp; i += L::THREADS) {
      const int r = i / cp, p = i % cp;
      const bool ok = r < valid;
      cell_cp16(cs + (r * NU + 8 * p) * 2, c_in + (size_t)(m0 + (ok ? r : 0)) * H + u0 + 8 * p,
                ok);
    }
    cell_commit();
    cell_wait<0>();
    __syncthreads();
  }
  CELL_CLOCK(0, t0);

  // epilogue: the lane holds units u, u + 1 of rows g and g + 8 of each m16 tile
  const int q = lane & 3, g8 = lane >> 2;
  const float* gxs = reinterpret_cast<const float*>(cell_smem);
  const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(gxs + BM * L::GX_LD);
  float2 bv[2][4];  // b_hh of the lane's units, the same for every row
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int g = 0; g < 4; ++g) bv[jj][g] = load2(bhh + g * H + u0 + 8 * (2 * wn + jj) + 2 * q);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = wm * 32 + 16 * mi + g8 + 8 * hh, row = m0 + rl;
      if (row >= R) continue;
      const size_t rH = (size_t)row * H;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int ul = 8 * (2 * wn + jj) + 2 * q, u = u0 + ul;
        float2 gxv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gxv[g] = *reinterpret_cast<const float2*>(gxs + rl * L::GX_LD + g * NU + ul);
        const float2 cv = load2(cs + rl * NU + ul);
        float hn[2], cn[2], sn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float gt[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gt[g] = (e ? gxv[g].y : gxv[g].x) + accg[mi][4 * jj + g][2 * hh + e] +
                    (e ? bv[jj][g].y : bv[jj][g].x);
          const float ig = cell_sigmoid(gt[0]), fg = cell_sigmoid(gt[1]);
          const float gg = tanhf(gt[2]), og = cell_sigmoid(gt[3]);
          const float cell = fg * (e ? cv.y : cv.x) + ig * gg;
          const float tc = tanhf(cell);
          hn[e] = og * tc;
          cn[e] = cell;
          sn[e] = cell_sigmoid(accs[mi][jj][2 * hh + e]) * tc;
        }
        *reinterpret_cast<__nv_bfloat162*>(h_out + rH + u) = __floats2bfloat162_rn(hn[0], hn[1]);
        *reinterpret_cast<__nv_bfloat162*>(c_out + rH + u) = __floats2bfloat162_rn(cn[0], cn[1]);
        *reinterpret_cast<float2*>(hn32 + rH + u) = make_float2(hn[0], hn[1]);
        *reinterpret_cast<float2*>(s32 + rH + u) = make_float2(sn[0], sn[1]);
      }
    }
  }
  CELL_CLOCK(1, t0);
}

// ------------------------------------------------------------------ stage 2
constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_GROUP = 128;  // threads a column group of h'.Wg / s.Ws: one column a thread
constexpr int ATT_RB = 6;       // rows a thread of a column group sums at once
constexpr int ATT_WB = 4;       // beam rows of an image a pass of the logits and alpha.V
constexpr int ATT_SG = 4;       // lanes that split an (image, 8 units) item's slots
constexpr int ATT_SLOTS = 13;   // slots a lane loads at once in alpha.V (4 x 13 >= K = 49)

constexpr int ATT_KC = 64;       // k of a staged chunk of [Wg | Ws] in phase a

// rows of a pass of phase a: its h' and s rows are staged in shared memory
__host__ __device__ inline int attend_pass_rows(int images, int W) {
  return images * W < 2 * ATT_RB ? images * W : 2 * ATT_RB;
}

__host__ __device__ inline size_t attend_smem_bytes(int images, int W, int H, int K, int D) {
  const size_t rows = (size_t)images * W;
  return sizeof(float) * (2 * (size_t)attend_pass_rows(images, W) * H + rows * (2 * D + K + 2) + D) +
         sizeof(__nv_bfloat16) * (2 * (ATT_KC / 8) * ATT_GROUP * 8 +
                                  (((size_t)images * K * D + 1) & ~(size_t)1));
}

__global__ void __launch_bounds__(ATT_THREADS)
cell_attend_kernel(const float* __restrict__ hn32, const float* __restrict__ s32,  // [R, H]
                   const __nv_bfloat16* __restrict__ pv,      // [R / W, K, D]
                   const __nv_bfloat16* __restrict__ V,       // [R / W, K, H]
                   const __nv_bfloat16* __restrict__ watt_t,  // [H / 8, 2D, 8]: [Wg | Ws]
                   const __nv_bfloat16* __restrict__ wh,      // [D]
                   __nv_bfloat16* __restrict__ chat_out,
                   float* __restrict__ alpha_out,  // [R, K]
                   float* __restrict__ beta_out,   // [R]
                   int R, int W, int H, int K, int D, int images) {
  extern __shared__ __align__(16) float att_smem[];
  const int img0 = blockIdx.x * images;
  const int nimg = min(images, R / W - img0);
  const int N = nimg * W, r0 = img0 * W;  // the block's rows
  const int maxN = images * W, xr = attend_pass_rows(images, W);
  float* xh = att_smem;         // [xr][H] the pass's h' rows (phase a)
  float* xsn = xh + xr * H;     // [xr][H] its s rows
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(xsn + xr * H);  // [2][KC / 8][128][8]
  float* phs = reinterpret_cast<float*>(wbuf + 2 * (ATT_KC / 8) * ATT_GROUP * 8);  // [N][D] h'.Wg
  float* sxs = phs + maxN * D;  // [N][D] s.Ws
  float* zs = sxs + maxN * D;   // [N][K] logits, then alpha
  float* zss = zs + maxN * K;   // [N] sentinel logit
  float* betas = zss + maxN;    // [N]
  float* whf = betas + maxN;    // [D]
  __nv_bfloat16* pvs = reinterpret_cast<__nv_bfloat16*>(whf + D);  // [nimg][K][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  CELL_CLOCK_START(t0);

  // the block's pv and wh to shared memory
  {
    const __nv_bfloat16* pb = pv + (size_t)img0 * K * D;
    const int n = nimg * K * D;
#pragma unroll 8
    for (int i = tid; i < n; i += ATT_THREADS) pvs[i] = pb[i];
  }
  for (int j = tid; j < D; j += ATT_THREADS) whf[j] = to_f(wh[j]);
#ifdef CELL_CLOCKS
  __syncthreads();
#endif
  CELL_CLOCK(2, t0);

  // phase a: ph = h' Wg, sx = s Ws in fp32. Two groups of 128 threads, a
  // column of [Wg | Ws] a thread, the rows 2 i + group of a pass of xr rows.
  // The pass's h' and s rows and [Wg | Ws] in chunks of ATT_KC k (k-blocked:
  // a thread's 8 k are 16 bytes beside its neighbours') are copied into
  // shared memory, the next chunk while this one is summed; every lane of a
  // warp reads the same row (a broadcast), and each thread sums k in order.
  const int grp = tid / ATT_GROUP, lt = tid % ATT_GROUP, nch = H / ATT_KC;
  constexpr int WCH = (ATT_KC / 8) * ATT_GROUP * 8;  // bf16 of a chunk buffer
  for (int cb = 0; cb < 2 * D; cb += ATT_GROUP) {
    const int c = cb + lt, ncol = min(ATT_GROUP, 2 * D - cb);
    const float* xsrc = c < D ? xh : xsn;
    float* dst = c < D ? phs + c : sxs + (c - D);
    auto stage_w = [&](int ci) {
      const uint32_t base = smem_u32(wbuf + (ci & 1) * WCH);
      for (int i = tid; i < (ATT_KC / 8) * ncol; i += ATT_THREADS) {
        const int kl = i / ncol, col = i - kl * ncol;
        cell_cp16(base + (kl * ATT_GROUP + col) * 16,
                  watt_t + ((size_t)(ci * (ATT_KC / 8) + kl) * 2 * D + cb + col) * 8, true);
      }
    };
    for (int rc = 0; rc < N; rc += xr) {
      const int nr = min(xr, N - rc);
      for (int i = tid; i < nr * H / 4; i += ATT_THREADS) {
        const size_t o = (size_t)(r0 + rc) * H + 4 * i;
        cell_cp16(smem_u32(xh + 4 * i), hn32 + o, true);
        cell_cp16(smem_u32(xsn + 4 * i), s32 + o, true);
      }
      stage_w(0);
      cell_commit();
      float acc[ATT_RB];
#pragma unroll
      for (int i = 0; i < ATT_RB; ++i) acc[i] = 0.f;
      for (int ci = 0; ci < nch; ++ci) {
        if (ci + 1 < nch) {  // its buffer was last read before the barrier that ended ci - 1
          stage_w(ci + 1);
          cell_commit();
          cell_wait<1>();
        } else {
          cell_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* wb = wbuf + (ci & 1) * WCH + lt * 8;
#pragma unroll 2
        for (int kl = 0; kl < ATT_KC / 8; ++kl) {
          const uint4 raw = *reinterpret_cast<const uint4*>(wb + kl * ATT_GROUP * 8);
          const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float w[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(w2[e]);
            w[2 * e] = f.x;
            w[2 * e + 1] = f.y;
          }
          const int k = ci * ATT_KC + kl * 8;
#pragma unroll
          for (int i = 0; i < ATT_RB; ++i) {
            const int r = 2 * i + grp;
            if (r < nr) {
              const float4 a = *reinterpret_cast<const float4*>(xsrc + r * H + k);
              const float4 b = *reinterpret_cast<const float4*>(xsrc + r * H + k + 4);
              const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[i] = fmaf(xv[e], w[e], acc[i]);
            }
          }
        }
        __syncthreads();
      }
      if (lt < ncol) {
#pragma unroll
        for (int i = 0; i < ATT_RB; ++i) {
          const int r = 2 * i + grp;
          if (r < nr) dst[(rc + r) * D] = acc[i];
        }
      }
    }
  }
  __syncthreads();
  CELL_CLOCK(3, t0);

  // phase b: z[r, i] = sum_j wh[j] tanh(pv[img, i, j] + ph[r, j]), a pv row
  // applied to the image's W rows; the sentinel's z_s[r]
  for (int it = tid; it < nimg * K; it += ATT_THREADS) {
    const int gi = it / K, i = it - gi * K;
    const __nv_bfloat16* p = pvs + (gi * K + i) * D;
    for (int w0 = 0; w0 < W; w0 += ATT_WB) {
      const int nw = min(ATT_WB, W - w0);
      const float* ph = phs + (gi * W + w0) * D;
      float z[ATT_WB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 7
      for (int j = 0; j < D; ++j) {
        const float pj = to_f(p[j]), whj = whf[j];
#pragma unroll
        for (int w = 0; w < ATT_WB; ++w)
          if (w < nw) z[w] = fmaf(tanhf(pj + ph[w * D + j]), whj, z[w]);
      }
#pragma unroll
      for (int w = 0; w < ATT_WB; ++w)
        if (w < nw) zs[(gi * W + w0 + w) * K + i] = z[w];
    }
  }
  for (int r = tid; r < N; r += ATT_THREADS) {
    float z = 0.f;
#pragma unroll 7
    for (int j = 0; j < D; ++j) z = fmaf(tanhf(sxs[r * D + j] + phs[r * D + j]), whf[j], z);
    zss[r] = z;
  }
  __syncthreads();
  CELL_CLOCK(4, t0);

  // phase c: softmax over K (alpha) and the sentinel share of the K + 1 softmax
  for (int r = warp; r < N; r += ATT_WARPS) {
    float m = NEG;
    for (int s = lane; s < K; s += 32) m = fmaxf(m, zs[r * K + s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    float denom = 0.f;
    for (int s = lane; s < K; s += 32) denom += expf(zs[r * K + s] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) denom += __shfl_xor_sync(FULL, denom, o);
    __syncwarp();
    for (int s = lane; s < K; s += 32) {
      const float a = expf(zs[r * K + s] - m) / denom;
      zs[r * K + s] = a;
      alpha_out[(size_t)(r0 + r) * K + s] = a;
    }
    if (lane == 0) {
      const float zsent = zss[r];
      const float m2 = fmaxf(m, zsent);
      const float beta = expf(zsent - m2) / (denom * expf(m - m2) + expf(zsent - m2));
      betas[r] = beta;
      beta_out[r0 + r] = beta;
    }
  }
  __syncthreads();
  CELL_CLOCK(5, t0);

  // phase d: c_hat = beta s + (1 - beta) alpha V. An item is (image, 8 units);
  // its ATT_SG lanes split the slots (s = sg, sg + 4, ...), load up to
  // ATT_SLOTS 16-byte V rows at once, each feeding the image's W rows, and
  // sum across the lanes; lane sg writes row w0 + sg.
  const int uc = H / 8, sg = tid % ATT_SG;
  for (int it = tid / ATT_SG; it < nimg * uc; it += ATT_THREADS / ATT_SG) {
    const int gi = it / uc, u = (it - gi * uc) * 8;
    const __nv_bfloat16* vp = V + (size_t)(img0 + gi) * K * H + u;
    for (int w0 = 0; w0 < W; w0 += ATT_WB) {
      const int nw = min(ATT_WB, W - w0);
      const float* al = zs + (gi * W + w0) * K;
      float acc[ATT_WB][8];
#pragma unroll
      for (int w = 0; w < ATT_WB; ++w)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[w][e] = 0.f;
      for (int s0 = sg; s0 < K; s0 += ATT_SG * ATT_SLOTS) {
        uint4 raw[ATT_SLOTS];
#pragma unroll
        for (int j = 0; j < ATT_SLOTS; ++j) {
          const int s = s0 + ATT_SG * j;
          raw[j] = s < K ? __ldg(reinterpret_cast<const uint4*>(vp + (size_t)s * H))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < ATT_SLOTS; ++j) {
          const int s = s0 + ATT_SG * j;
          if (s < K) {
            const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
            float v[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(v2[e]);
              v[2 * e] = f.x;
              v[2 * e + 1] = f.y;
            }
#pragma unroll
            for (int w = 0; w < ATT_WB; ++w) {
              if (w < nw) {
                const float a = al[w * K + s];
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[w][e] = fmaf(a, v[e], acc[w][e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int w = 0; w < ATT_WB; ++w)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int o = 1; o < ATT_SG; o <<= 1)
            acc[w][e] += __shfl_xor_sync(FULL, acc[w][e], o);
      if (sg < nw) {
        float ctx[8];
#pragma unroll
        for (int w = 0; w < ATT_WB; ++w)
          if (w == sg)
#pragma unroll
            for (int e = 0; e < 8; ++e) ctx[e] = acc[w][e];
        const int rl = gi * W + w0 + sg;
        const size_t o = (size_t)(r0 + rl) * H + u;
        const float beta = betas[rl];
        const float4 sa = __ldg(reinterpret_cast<const float4*>(s32 + o));
        const float4 sb = __ldg(reinterpret_cast<const float4*>(s32 + o + 4));
        const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        uint4 outv;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&outv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o2[e] = __floats2bfloat162_rn(beta * sv[2 * e] + (1.0f - beta) * ctx[2 * e],
                                        beta * sv[2 * e + 1] + (1.0f - beta) * ctx[2 * e + 1]);
        *reinterpret_cast<uint4*>(chat_out + o) = outv;
      }
    }
  }
#ifdef CELL_CLOCKS
  __syncthreads();
#endif
  CELL_CLOCK(6, t0);
}

}  // namespace
