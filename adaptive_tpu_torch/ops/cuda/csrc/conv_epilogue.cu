// Hopper (sm_90a) epilogue of the BN-folded float encoder's convolutions.
// Built with the other csrc/*.cu into one library by
// adaptive_tpu_torch/ops/cuda/build.py and called through ctypes from
// adaptive_tpu_torch/ops/conv_epilogue.py::folded_epilogue, whose plain twin
// folded_epilogue_plain defines the arithmetic.
//
// 7. folded_epilogue_elementwise_kernel replaces no TPU kernel: XLA fused
//    these epilogues into the convolutions of adaptive_tpu/models/infer.py,
//    so the JAX package has no Pallas kernel here. On the card each
//    convolution of models/infer.py::resnet_apply_folded runs without its
//    bias, and this one pass over its NHWC output rows [N, C] computes
//      y = relu((acc + bias) + r),  r = 0 | residual | (residual + res_bias)
//    in fp32 with one rounding to T, written in place into acc (the conv's
//    own output, which has no other reader). The adds are __fadd_rn in the
//    association of the separate PyTorch passes it replaces (the conv's bias
//    add_, the downsample's bias add_, z + sc, relu), so fp32 gives their
//    bits; in bf16 only their intermediate roundings go.
//    Bound on an H100 SXM: bytes. A ResNet-152 encode at batch 1,024 runs
//    151 launches: the stem and every conv1 and conv2 (bias + relu: 7.90 M
//    elements an image read and written), and every conv3 (+ the block
//    input or the downsample's raw output: 13.15 M elements an image, two
//    read and one written): 55.2 M bf16 elements an image, 113 GB a batch,
//    33.8 ms at 3.35 TB/s, against 259 GB for the separate passes.
//    Design: no data is reused, so the kernel only has to keep the bytes
//    flowing. A thread owns one 16-byte vector of channels (8 bf16 or 4
//    fp32) of one row: one 16-byte load of acc (and of the residual), its
//    bias (and the residual's) converted to fp32 in registers, one 16-byte
//    store. A block is the row's channel groups times enough rows for ~256
//    threads, and the grid covers the rows once: at every width the SMs
//    then hold full blocks of warps, each with its loads in flight, and the
//    bias vectors stay in L1. At the encode's 16 shapes this took 37.2 ms
//    (PERF.md §6); walking the rows grid-stride from one full wave of
//    blocks, with 2, 4 or 8 rows' loads issued together, took 39.7-40.1 ms,
//    and streaming loads (ld.global.cs) 0.5 ms more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int EPI_THREADS = 256;  // threads a block, where the channel groups allow
constexpr int EPI_MAX_GROUPS = 512;  // 16-byte channel groups a row at most: the block's width

template <typename T> struct Lanes;  // elements of T in 16 bytes
template <> struct Lanes<float> { static constexpr int n = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int n = 8; };

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

// relu as torch.relu: negatives to 0, NaN kept
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// MODE 0: bias + relu; 1: + residual; 2: + (residual + res_bias).
// blockDim = (G channel groups, rows a block); acc, residual [rows, G * lanes].
template <typename T, int MODE>
__global__ void __launch_bounds__(EPI_MAX_GROUPS)
folded_epilogue_elementwise_kernel(T* __restrict__ acc, const T* __restrict__ bias,
                                   const T* __restrict__ residual,
                                   const T* __restrict__ res_bias, long long rows) {
  constexpr int L = Lanes<T>::n;
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int g = threadIdx.x;
  const size_t off = ((size_t)r * blockDim.x + g) * L;
  float v[L], b[L], s[L], rb[L];
  unpack(*reinterpret_cast<const int4*>(acc + off), v);
  if (MODE != 0) unpack(*reinterpret_cast<const int4*>(residual + off), s);
  unpack(*reinterpret_cast<const int4*>(bias + (size_t)g * L), b);
  if (MODE == 2) unpack(*reinterpret_cast<const int4*>(res_bias + (size_t)g * L), rb);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float y = __fadd_rn(v[i], b[i]);
    if (MODE == 1) y = __fadd_rn(y, s[i]);
    if (MODE == 2) y = __fadd_rn(y, __fadd_rn(s[i], rb[i]));
    v[i] = relu(y);
  }
  *reinterpret_cast<int4*>(acc + off) = pack(v);
}

template <typename T>
int launch_epilogue(void* acc, const void* bias, const void* residual, const void* res_bias,
                    long long rows, int C, cudaStream_t st) {
  constexpr int L = Lanes<T>::n;
  if (C % L || C / L > EPI_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  const int G = C / L;
  const dim3 block(G, G >= EPI_THREADS ? 1 : EPI_THREADS / G);
  auto kernel = residual == nullptr   ? &folded_epilogue_elementwise_kernel<T, 0>
                : res_bias == nullptr ? &folded_epilogue_elementwise_kernel<T, 1>
                                      : &folded_epilogue_elementwise_kernel<T, 2>;
  const long long blocks = (rows + block.y - 1) / block.y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, block, 0, st>>>((T*)acc, (const T*)bias, (const T*)residual,
                                             (const T*)res_bias, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. acc, residual [rows, C] (residual null:
// no residual; res_bias null: none), bias and res_bias [C], all of one dtype,
// contiguous and 16-byte aligned (checked by the wrapper); C a multiple of 8
// (bf16) or 4 (fp32), at most 512 16-byte groups. Writes into acc. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or dtype outside these values or a res_bias without a residual.
int folded_epilogue_launch(int dtype, void* acc, const void* bias, const void* residual,
                           const void* res_bias, long long rows, int C, void* stream) {
  if (rows < 0 || C < 1 || (dtype != 0 && dtype != 1) || (res_bias && !residual))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_epilogue<float>(acc, bias, residual, res_bias, rows, C, st);
  return launch_epilogue<__nv_bfloat16>(acc, bias, residual, res_bias, rows, C, st);
}

}  // extern "C"
