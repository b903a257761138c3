// Per-channel scale, bias and activation over a (M, C) row-major tensor:
//     y[m, c] = act(x[m, c] * k[c] + b[c])
// with the math in float32 and y written in x's type (float32 or bfloat16).
//
// Replaces the TPU kernel triplegan_tpu/ops/pallas_fused.py::_kernel
// (launched by _pallas_rows). On the serving path it is every batch-norm
// epilogue of the Generator and Classifier and the Generator's weight-norm
// + tanh output.
//
// Bound: bytes. Each element is read once and written once and takes three
// flops, far below the card's ratio of flops to bytes, so the least time is
// (bytes of x + bytes of y) / 3.35 TB/s.
//
// Design: one grid-stride loop over the elements, channel = index mod C.
// Where C and the pointers allow, each thread moves 16 bytes at a time
// (4 floats or 8 bfloat16s), which all fall in one row because C is a
// multiple of the vector width. k and b are tiny and stay in L1/L2.
// Products and sums use __fmul_rn/__fadd_rn so the compiler does not
// contract them into an FMA: the result then rounds exactly as the plain
// PyTorch version (a multiply, then an add) does. tanh is the accurate
// tanhf, not a fast approximation.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Act { kLinear = 0, kRelu = 1, kLeakyRelu = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float apply(float x, float k, float b, float slope) {
  float z = __fadd_rn(__fmul_rn(x, k), b);
  if (ACT == kRelu) return z < 0.f ? 0.f : z;  // NaN passes through
  if (ACT == kLeakyRelu) return z >= 0.f ? z : __fmul_rn(slope, z);
  if (ACT == kTanh) return tanhf(z);
  return z;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One element per iteration.
template <typename T, int ACT>
__global__ void sba_scalar(const T* __restrict__ x, const T* __restrict__ k,
                           const T* __restrict__ b, T* __restrict__ y,
                           int64_t n, int c, float slope) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int ch = (int)(i % c);
    y[i] = from_f<T>(apply<ACT>(to_f(x[i]), to_f(k[ch]), to_f(b[ch]), slope));
  }
}

// 16 bytes per iteration: V = 16 / sizeof(T) elements of one row
// (requires c % V == 0 and 16-byte aligned x and y).
template <typename T, int ACT>
__global__ void sba_vec16(const T* __restrict__ x, const T* __restrict__ k,
                          const T* __restrict__ b, T* __restrict__ y,
                          int64_t nvec, int c, float slope) {
  constexpr int V = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int ch0 = (int)((i * V) % c);
    uint4 in = xv[i];
    uint4 out;
    const T* xe = reinterpret_cast<const T*>(&in);
    T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ye[j] = from_f<T>(apply<ACT>(to_f(xe[j]), to_f(k[ch0 + j]), to_f(b[ch0 + j]), slope));
    }
    yv[i] = out;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // enough to fill every SM; the loop covers the rest

template <typename T, int ACT>
void launch(const void* x, const void* k, const void* b, void* y, int64_t m, int c,
            float slope, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t n = m * (int64_t)c;
  const bool vec = (c % V == 0) && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  const int64_t work = vec ? n / V : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(k);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (vec) {
    sba_vec16<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(xt, kt, bt, yt, work, c, slope);
  } else {
    sba_scalar<T, ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(xt, kt, bt, yt, work, c, slope);
  }
}

template <typename T>
void dispatch_act(int act, const void* x, const void* k, const void* b, void* y,
                  int64_t m, int c, float slope, cudaStream_t s) {
  switch (act) {
    case kLinear: launch<T, kLinear>(x, k, b, y, m, c, slope, s); break;
    case kRelu: launch<T, kRelu>(x, k, b, y, m, c, slope, s); break;
    case kLeakyRelu: launch<T, kLeakyRelu>(x, k, b, y, m, c, slope, s); break;
    default: launch<T, kTanh>(x, k, b, y, m, c, slope, s); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 linear, 1 relu, 2 leaky_relu, 3 tanh.
// Returns a cudaError_t as int: 0 on a good launch, cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int scale_bias_act_launch(const void* x, const void* k, const void* b, void* y,
                                     long long m, int c, int dtype, int act, float slope,
                                     void* stream) {
  if (m <= 0 || c <= 0 || act < 0 || act > 3 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch_act<float>(act, x, k, b, y, (int64_t)m, c, slope, s);
  } else {
    dispatch_act<__nv_bfloat16>(act, x, k, b, y, (int64_t)m, c, slope, s);
  }
  return (int)cudaGetLastError();
}
