// Per-channel scale, bias and activation over a (M, C) row-major tensor,
//     y[m, c] = act(x[m, c] * k[c] + b[c]),
// and its gradient, the custom VJP of the JAX package:
//     z = x·k + b,  t = g·act'(z),  dx = t·k,  dk = Σ_m t·x,  db = Σ_m t.
//
// Replaces the TPU kernel triplegan_tpu/ops/pallas_fused.py::_kernel
// (launched by _pallas_rows) and its custom VJP _bwd (pallas_fused.py:117),
// which is jnp there because XLA fuses it into the surrounding backward
// graph; eager PyTorch fuses nothing, so here it is one kernel (plus a small
// fixed-order reduce of the per-block sums). It follows every conv of the
// three networks: batch norm folded into (k, b) in C and G, the weight-norm
// scale g/|v| in D's convs and G's output deconv, 1/sigma in the spectrally
// normalised convs. Its per-sample variant (the cbn_* kernels), with k and b
// given per sample, is the class-conditional batch norm of the ResNet G.
// The bnm_* kernels compute the train-mode batch-norm moments that k and b
// are folded from, and their gradient (their own notes are below). The
// mod_* kernels are StyleGAN2's modulated-conv epilogue, a per-sample scale
// with a per-pixel term and a clamp (their notes are below too).
//
// Bound: bytes. The forward reads x and writes y once; the backward reads x
// and g and writes dx once (dk and db are C values). A few flops an element,
// far below the card's ratio of flops to bytes, so the least time is those
// bytes / 3.35 TB/s.
//
// Design, for this card:
// - No division in any loop. A thread owns a fixed group of channels for the
//   whole launch: in the row kernels one unit of W channels (W = 16 bytes
//   of elements where C is a multiple of W and x is 16-byte aligned, else
//   W = 1) and walks rows by addition; at C = 3 (the Generator's RGB
//   output) a thread owns whole groups of three 16-byte vectors, 3·W
//   elements or W rows, whose channel pattern is the same in every group
//   and known at compile time. k and b are read once per thread into
//   registers.
// - One row (group) a thread and iteration, but U = 4 rows in flight in the
//   float32 backward, whose small shapes would otherwise need many blocks,
//   and so many partial sums. Plain loads and stores: a streaming hint on
//   the loads of x and g measured 2-5% slower at the wide shapes on an H100
//   (tools/sba_breakdown.py).
// - The grid sweeps the tensor together: thread t of the grid takes rows
//   (groups) t, t + T, t + 2T, ... (T threads in the grid), so every
//   thread's share is within one row of every other's and the whole grid
//   reads one region of memory at a time. The grid is one wave of the card
//   at the occupancy the kernel reaches, or fewer blocks where the tensor
//   has fewer rows; the backward's also so few that its partial sums stay
//   under 1/16 of the bytes it streams. The backward's grid is chosen here
//   alone (bwd_plan), and the caller sizes the workspace by asking for it.
// - Rounding. The forward computes in float32 with __fmul_rn/__fadd_rn (no
//   FMA contraction) and the accurate tanhf, and rounds y once to x's type:
//   bit-identical to the plain version. The backward rounds each
//   intermediate to x's type exactly where the plain backward (which, like
//   _bwd, computes in x's dtype) rounds it, so dx is bit-identical to it;
//   dk and db are float32 sums rounded once, differing from the plain ones
//   only by summation order.
// - Deterministic. Each block sums its rows in a fixed order (a fixed tree
//   across its threads) into its own row of a float32 workspace; a second
//   launch adds those rows in block order. No float atomics: two runs are
//   bitwise equal.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

enum Act { kLinear = 0, kRelu = 1, kLeakyRelu = 2, kTanh = 3 };
enum Need { kDx = 1, kDk = 2, kDb = 4 };

constexpr int kThreads = 256;
// Rows in flight per thread and iteration of the backward's row kernel.
template <typename T> constexpr int bwd_unroll() { return sizeof(T) == 4 ? 4 : 1; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T (the identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// W consecutive elements of T at p as floats; one 16-byte load where
// W·sizeof(T) == 16 (p then 16-byte aligned).
template <typename T, int W>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[W]) {
  if constexpr (W == 1 && sizeof(T) == 4) {
    f[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (W == 1) {
    f[0] = __bfloat162float(__ushort_as_bfloat16(*reinterpret_cast<const unsigned short*>(p)));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(W == 4, "a 16-byte unit");
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    static_assert(W == 8, "a 16-byte unit");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], 4);
      const float2 t = __bfloat1622float2(h);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// f rounded to T and stored as W consecutive elements at p.
template <typename T, int W>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// act(x·k + b) in float32, a multiply then an add, as the plain version.
template <int ACT>
__device__ __forceinline__ float apply(float x, float k, float b, float slope) {
  const float z = __fadd_rn(__fmul_rn(x, k), b);
  if (ACT == kRelu) return z < 0.f ? 0.f : z;  // NaN passes through
  if (ACT == kLeakyRelu) return z >= 0.f ? z : __fmul_rn(slope, z);
  if (ACT == kTanh) return tanhf(z);
  return z;
}

// t = g·act'(z) with z = x·k + b, every step rounded to T where the plain
// backward rounds it (x*k, +b, tanh, t*t, 1-, g*); slope_t is the slope
// rounded to T, as full_like makes it.
template <typename T, int ACT>
__device__ __forceinline__ float grad_t(float x, float g, float k, float b, float slope_t) {
  if (ACT == kLinear) return g;
  const float z = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, k)), b));
  float a;
  if (ACT == kRelu) {
    a = z >= 0.f ? 1.f : 0.f;
  } else if (ACT == kLeakyRelu) {
    a = z >= 0.f ? 1.f : slope_t;
  } else {
    const float th = rnd<T>(tanhf(z));
    a = rnd<T>(__fsub_rn(1.f, rnd<T>(__fmul_rn(th, th))));
  }
  return rnd<T>(__fmul_rn(g, a));
}

// ---------------------------------------------------------------------------
// Row kernels: (M, C) as rows of C/W units of W channels. Block (ux, ry):
// thread (tx, ty) owns unit tx (and tx + ux, ... where C/W > ux) and walks
// the rows blockIdx.x·ry + ty + i·gridDim.x·ry.
// ---------------------------------------------------------------------------

template <typename T, int W, int ACT>
__global__ void __launch_bounds__(kThreads)
sba_fwd_rows(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
             T* __restrict__ y, long long m, int c, float slope) {
  const int units = c / W;
  const long long rs = (long long)gridDim.x * blockDim.y;  // rows between a thread's rows
  const long long estep = rs * c;                          // elements between them
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ch = u * W;
    float kf[W], bf[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      kf[i] = to_f(k[ch + i]);
      bf[i] = to_f(b[ch + i]);
    }
    long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    for (long long off = r * c + ch; r < m; r += rs, off += estep) {
      float v[W];
      load<T, W>(x + off, v);
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = apply<ACT>(v[i], kf[i], bf[i], slope);
      store<T, W>(y + off, v);
    }
  }
}

// The backward over the same layout, U rows an iteration. Each thread sums
// t·x and t for its channels over its rows, in order; the block adds its
// threads' sums over ty in order and writes them to its row of `part` (dk
// sums, then db sums).
template <typename T, int W, int ACT, int U>
__global__ void __launch_bounds__(kThreads)
sba_bwd_rows(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
             const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
             long long m, int c, float slope, int flags) {
  __shared__ float red[2 * kThreads * W];
  const bool want_dx = flags & kDx;
  const bool want_sums = flags & (kDk | kDb);
  const float slope_t = rnd<T>(slope);
  const int units = c / W;
  const int ry = blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long rs = (long long)gridDim.x * ry;
  const long long estep = rs * c;
  for (int u0 = 0; u0 < units; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    float sk[W], sb[W];
#pragma unroll
    for (int i = 0; i < W; ++i) sk[i] = sb[i] = 0.f;
    if (u < units) {
      const int ch = u * W;
      float kf[W], bf[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        kf[i] = to_f(k[ch + i]);
        bf[i] = to_f(b[ch + i]);
      }
      long long r = (long long)blockIdx.x * ry + threadIdx.y;
      for (long long off = r * c + ch; r < m; r += U * rs, off += U * estep) {
        float xv[U][W], gv[U][W];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (r + j * rs < m) {
            load<T, W>(x + off + j * estep, xv[j]);
            load<T, W>(g + off + j * estep, gv[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (r + j * rs < m) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const float t = grad_t<T, ACT>(xv[j][i], gv[j][i], kf[i], bf[i], slope_t);
              sk[i] = __fadd_rn(sk[i], rnd<T>(__fmul_rn(t, xv[j][i])));
              sb[i] = __fadd_rn(sb[i], t);
              gv[j][i] = rnd<T>(__fmul_rn(t, kf[i]));
            }
            if (want_dx) store<T, W>(dx + off + j * estep, gv[j]);
          }
        }
      }
    }
    if (want_sums) {
      const int cw = min((int)blockDim.x, units - u0) * W;  // channels of this pass
      float* rk = red;
      float* rb = red + ry * cw;
      if (u < units) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          rk[threadIdx.y * cw + threadIdx.x * W + i] = sk[i];
          rb[threadIdx.y * cw + threadIdx.x * W + i] = sb[i];
        }
      }
      __syncthreads();
      for (int l = tid; l < 2 * cw; l += nthreads) {
        const int which = l >= cw ? 1 : 0;
        const int col = l - which * cw;
        const float* src = (which ? rb : rk) + col;
        float s = 0.f;
        for (int r = 0; r < ry; ++r) s = __fadd_rn(s, src[r * cw]);
        part[(long long)blockIdx.x * 2 * c + which * c + u0 * W + col] = s;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// C = 3: a group of 3 16-byte vectors holds L = 3·W elements, L/3 whole rows,
// element e of every group in channel e mod 3. Thread t of the grid owns the
// groups t, t + T, ...; the elements after the last whole group (fewer than
// L) go to the last block's thread 0.
// ---------------------------------------------------------------------------

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
sba_fwd_c3(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
           T* __restrict__ y, long long n, long long groups, float slope) {
  constexpr int W = 16 / sizeof(T), L = 3 * W;
  float kf[3], bf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    kf[i] = to_f(k[i]);
    bf[i] = to_f(b[i]);
  }
  const long long qs = (long long)gridDim.x * blockDim.x;  // groups between a thread's groups
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long off = q * L; q < groups; q += qs, off += qs * L) {
    float v[3][W];
#pragma unroll
    for (int s = 0; s < 3; ++s) load<T, W>(x + off + s * W, v[s]);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int ch = (s * W + i) % 3;  // constant once unrolled
        v[s][i] = apply<ACT>(v[s][i], kf[ch], bf[ch], slope);
      }
      store<T, W>(y + off + s * W, v[s]);
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const long long base = groups * L;
#pragma unroll
    for (int e = 0; e < L; ++e) {
      if (base + e < n) y[base + e] = from_f<T>(apply<ACT>(to_f(x[base + e]), kf[e % 3], bf[e % 3], slope));
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
sba_bwd_c3(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
           const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
           long long n, long long groups, float slope, int flags) {
  constexpr int W = 16 / sizeof(T), L = 3 * W;
  __shared__ float red[kThreads / 32][6];
  const bool want_dx = flags & kDx;
  const float slope_t = rnd<T>(slope);
  float kf[3], bf[3], sk[3], sb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    kf[i] = to_f(k[i]);
    bf[i] = to_f(b[i]);
    sk[i] = sb[i] = 0.f;
  }
  const long long qs = (long long)gridDim.x * blockDim.x;  // groups between a thread's groups
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long off = q * L; q < groups; q += qs, off += qs * L) {
    float xv[3][W], gv[3][W];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      load<T, W>(x + off + s * W, xv[s]);
      load<T, W>(g + off + s * W, gv[s]);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int ch = (s * W + i) % 3;
        const float t = grad_t<T, ACT>(xv[s][i], gv[s][i], kf[ch], bf[ch], slope_t);
        sk[ch] = __fadd_rn(sk[ch], rnd<T>(__fmul_rn(t, xv[s][i])));
        sb[ch] = __fadd_rn(sb[ch], t);
        gv[s][i] = rnd<T>(__fmul_rn(t, kf[ch]));
      }
      if (want_dx) store<T, W>(dx + off + s * W, gv[s]);
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const long long base = groups * L;
#pragma unroll
    for (int e = 0; e < L; ++e) {
      if (base + e < n) {
        const float xe = to_f(x[base + e]);
        const float t = grad_t<T, ACT>(xe, to_f(g[base + e]), kf[e % 3], bf[e % 3], slope_t);
        sk[e % 3] = __fadd_rn(sk[e % 3], rnd<T>(__fmul_rn(t, xe)));
        sb[e % 3] = __fadd_rn(sb[e % 3], t);
        if (want_dx) dx[base + e] = from_f<T>(__fmul_rn(t, kf[e % 3]));
      }
    }
  }
  if (flags & (kDk | kDb)) {
    // a fixed xor tree across the warp, then the warps in order
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sk[i] = __fadd_rn(sk[i], __shfl_xor_sync(0xffffffffu, sk[i], o));
        sb[i] = __fadd_rn(sb[i], __shfl_xor_sync(0xffffffffu, sb[i], o));
      }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        red[warp][i] = sk[i];
        red[warp][3 + i] = sb[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < 6) {
      float s = 0.f;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) s = __fadd_rn(s, red[w][threadIdx.x]);
      part[(long long)blockIdx.x * 6 + threadIdx.x] = s;  // dk0 dk1 dk2 db0 db1 db2
    }
  }
}

// dk[c] = Σ_p part[p][c], db[c] = Σ_p part[p][C + c] over the p blocks, in a
// fixed order: thread (tx, ty) of a (32, 8) block adds the rows p ≡ ty
// (mod 8) of column 32·blockIdx.x + tx in order, then row ty = 0 adds the 8.
template <typename T>
__global__ void __launch_bounds__(256)
sba_bwd_reduce(const float* __restrict__ part, int p, int c, T* __restrict__ dk, T* __restrict__ db) {
  __shared__ float s[8][33];
  const int width = 2 * c;
  const int col = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f;
  if (col < width) {
    for (int q = threadIdx.y; q < p; q += 8) a = __fadd_rn(a, part[(long long)q * width + col]);
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t = __fadd_rn(t, s[r][threadIdx.x]);
    if (col < c) {
      if (dk) dk[col] = from_f<T>(t);
    } else if (db) {
      db[col - c] = from_f<T>(t);
    }
  }
}

// ---------------------------------------------------------------------------
// Per-sample scale and bias (class-conditional batch norm): x is (N, HW, C)
// and k, b are (N, C), y[n, r, c] = act(x[n, r, c]·k[n, c] + b[n, c]); the
// backward's dk[n, c] = Σ_r t·x and db[n, c] = Σ_r t sum over sample n's HW
// rows alone. Own names (cbn_*), so that a trace tells them from the
// per-channel kernels. Grid (bx, N): blockIdx.y is the sample, so a thread
// loads its sample's k and b once and walks that sample's rows by addition,
// as the row kernels above walk theirs; no division by HW anywhere.
// ---------------------------------------------------------------------------

template <typename T, int W, int ACT>
__global__ void __launch_bounds__(kThreads)
cbn_fwd_rows(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
             T* __restrict__ y, long long hw, int c, float slope) {
  const int units = c / W;
  const long long rs = (long long)gridDim.x * blockDim.y;
  const long long estep = rs * c;
  const long long base = (long long)blockIdx.y * hw * c;
  const T* ks = k + (long long)blockIdx.y * c;
  const T* bs = b + (long long)blockIdx.y * c;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ch = u * W;
    float kf[W], bf[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      kf[i] = to_f(ks[ch + i]);
      bf[i] = to_f(bs[ch + i]);
    }
    long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    for (long long off = base + r * c + ch; r < hw; r += rs, off += estep) {
      float v[W];
      load<T, W>(x + off, v);
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = apply<ACT>(v[i], kf[i], bf[i], slope);
      store<T, W>(y + off, v);
    }
  }
}

// sba_bwd_rows over one sample's rows: block (blockIdx.x, n) writes its sums
// to row n·gridDim.x + blockIdx.x of `part`.
template <typename T, int W, int ACT, int U>
__global__ void __launch_bounds__(kThreads)
cbn_bwd_rows(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
             const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
             long long hw, int c, float slope, int flags) {
  __shared__ float red[2 * kThreads * W];
  const bool want_dx = flags & kDx;
  const bool want_sums = flags & (kDk | kDb);
  const float slope_t = rnd<T>(slope);
  const int units = c / W;
  const int ry = blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long rs = (long long)gridDim.x * ry;
  const long long estep = rs * c;
  const long long base = (long long)blockIdx.y * hw * c;
  const T* ks = k + (long long)blockIdx.y * c;
  const T* bs = b + (long long)blockIdx.y * c;
  float* prow = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c;
  for (int u0 = 0; u0 < units; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    float sk[W], sb[W];
#pragma unroll
    for (int i = 0; i < W; ++i) sk[i] = sb[i] = 0.f;
    if (u < units) {
      const int ch = u * W;
      float kf[W], bf[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        kf[i] = to_f(ks[ch + i]);
        bf[i] = to_f(bs[ch + i]);
      }
      long long r = (long long)blockIdx.x * ry + threadIdx.y;
      for (long long off = base + r * c + ch; r < hw; r += U * rs, off += U * estep) {
        float xv[U][W], gv[U][W];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (r + j * rs < hw) {
            load<T, W>(x + off + j * estep, xv[j]);
            load<T, W>(g + off + j * estep, gv[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (r + j * rs < hw) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const float t = grad_t<T, ACT>(xv[j][i], gv[j][i], kf[i], bf[i], slope_t);
              sk[i] = __fadd_rn(sk[i], rnd<T>(__fmul_rn(t, xv[j][i])));
              sb[i] = __fadd_rn(sb[i], t);
              gv[j][i] = rnd<T>(__fmul_rn(t, kf[i]));
            }
            if (want_dx) store<T, W>(dx + off + j * estep, gv[j]);
          }
        }
      }
    }
    if (want_sums) {
      const int cw = min((int)blockDim.x, units - u0) * W;
      float* rk = red;
      float* rb = red + ry * cw;
      if (u < units) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          rk[threadIdx.y * cw + threadIdx.x * W + i] = sk[i];
          rb[threadIdx.y * cw + threadIdx.x * W + i] = sb[i];
        }
      }
      __syncthreads();
      for (int l = tid; l < 2 * cw; l += nthreads) {
        const int which = l >= cw ? 1 : 0;
        const int col = l - which * cw;
        const float* src = (which ? rb : rk) + col;
        float s = 0.f;
        for (int r = 0; r < ry; ++r) s = __fadd_rn(s, src[r * cw]);
        prow[which * c + u0 * W + col] = s;
      }
      __syncthreads();
    }
  }
}

// sba_bwd_reduce for each sample: block (x, n) adds the p rows of sample
// n's part into dk[n, :] and db[n, :], in the same fixed order.
template <typename T>
__device__ __forceinline__ void per_sample_reduce(const float* __restrict__ part, int p, int c,
                                                  T* __restrict__ dk, T* __restrict__ db) {
  __shared__ float s[8][33];
  const int width = 2 * c;
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* ps = part + (long long)blockIdx.y * p * width;
  float a = 0.f;
  if (col < width) {
    for (int q = threadIdx.y; q < p; q += 8) a = __fadd_rn(a, ps[(long long)q * width + col]);
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t = __fadd_rn(t, s[r][threadIdx.x]);
    const long long at = (long long)blockIdx.y * c;
    if (col < c) {
      if (dk) dk[at + col] = from_f<T>(t);
    } else if (db) {
      db[at + col - c] = from_f<T>(t);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
cbn_bwd_reduce(const float* __restrict__ part, int p, int c, T* __restrict__ dk, T* __restrict__ db) {
  per_sample_reduce<T>(part, p, c, dk, db);
}

// ---------------------------------------------------------------------------
// The modulated conv's epilogue (mod_*), float32: x is (N, HW, C), k (N, C)
// a sample's per-channel scale (StyleGAN2's demodulation coefficients), b
// (C,) a per-channel bias and q (N, HW) a per-pixel term (the noise plane
// times its strength), y[n, r, c] = clamp(act(x·k[n, c] + b[c] + q[n, r]),
// ±L). The backward, with t = g·act'(z)·[−L ≤ act(z) ≤ L]: dx = t·k,
// dk[n, c] = Σ_r t·x and the per-sample db[n, c] = Σ_r t (reduced as the
// cbn_* backward's sums: partial rows a block, then mod_bwd_reduce), and
// dq[n, r] = Σ_c t, the sum over a row's channels. A row's units are one
// whole warp or more (C/W a multiple of 32, at most kThreads), so each
// warp holds channels of one row and sums them by a fixed xor tree, and a
// block sums its warps in order: no atomics, so two calls are bitwise
// equal. The grid and its walk are cbn_*'s: (blocks a sample, N), a
// thread walks its sample's rows by addition, U rows in flight; every
// thread of a block takes the same number of iterations, as the row sums
// meet at a barrier.
// ---------------------------------------------------------------------------

constexpr int kModU = 4;  // rows in flight a thread

template <int ACT>
__device__ __forceinline__ float mod_apply(float x, float k, float b, float q, float slope, float lim) {
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(x, k), b), q);
  float o = z;
  if (ACT == kRelu) o = z < 0.f ? 0.f : z;
  if (ACT == kLeakyRelu) o = z >= 0.f ? z : __fmul_rn(slope, z);
  if (ACT == kTanh) o = tanhf(z);
  return fminf(fmaxf(o, -lim), lim);
}

template <int W, int ACT>
__global__ void __launch_bounds__(kThreads)
mod_fwd_rows(const float* __restrict__ x, const float* __restrict__ k, const float* __restrict__ b,
             const float* __restrict__ q, float* __restrict__ y, long long hw, int c, float slope, float lim) {
  const int units = c / W;
  const long long rs = (long long)gridDim.x * blockDim.y;
  const long long estep = rs * c;
  const long long base = (long long)blockIdx.y * hw * c;
  const float* ks = k + (long long)blockIdx.y * c;
  const float* qs = q + (long long)blockIdx.y * hw;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ch = u * W;
    float kf[W], bf[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      kf[i] = ks[ch + i];
      bf[i] = b[ch + i];
    }
    long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    for (long long off = base + r * c + ch; r < hw; r += rs, off += estep) {
      const float qr = qs[r];
      float v[W];
      load<float, W>(x + off, v);
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = mod_apply<ACT>(v[i], kf[i], bf[i], qr, slope, lim);
      store<float, W>(y + off, v);
    }
  }
}

// Block (ux, ry), ux = C/W threads a row (a multiple of 32); block
// (blockIdx.x, n) writes its Σt·x and Σt to row n·gridDim.x + blockIdx.x of
// `part`, as cbn_bwd_rows does.
template <int W, int ACT>
__global__ void __launch_bounds__(kThreads)
mod_bwd_rows(const float* __restrict__ x, const float* __restrict__ k, const float* __restrict__ b,
             const float* __restrict__ q, const float* __restrict__ g, float* __restrict__ dx,
             float* __restrict__ dq, float* __restrict__ part, long long hw, int c, float slope, float lim,
             int flags) {
  __shared__ float red[2 * kThreads * W];
  __shared__ float rowsum[kModU][kThreads / 32];
  const bool want_dx = flags & kDx;
  const bool want_sums = flags & (kDk | kDb);
  const bool want_dq = flags & 8;
  const int ux = blockDim.x, ry = blockDim.y;
  const int warps = ux / 32;  // warps a row
  const int tid = threadIdx.y * ux + threadIdx.x;
  const long long rs = (long long)gridDim.x * ry;
  const long long estep = rs * c;
  const long long base = (long long)blockIdx.y * hw * c;
  const int ch = threadIdx.x * W;
  const float* ks = k + (long long)blockIdx.y * c;
  const float* qs = q + (long long)blockIdx.y * hw;
  float* dqs = dq ? dq + (long long)blockIdx.y * hw : nullptr;
  float kf[W], bf[W], sk[W], sb[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    kf[i] = ks[ch + i];
    bf[i] = b[ch + i];
    sk[i] = sb[i] = 0.f;
  }
  for (long long r0 = (long long)blockIdx.x * ry; r0 < hw; r0 += kModU * rs) {
    const long long r = r0 + threadIdx.y;
    const long long off = base + r * c + ch;
    float xv[kModU][W], gv[kModU][W], tq[kModU];
#pragma unroll
    for (int j = 0; j < kModU; ++j) {
      tq[j] = 0.f;
      if (r + j * rs < hw) {
        load<float, W>(x + off + j * estep, xv[j]);
        load<float, W>(g + off + j * estep, gv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kModU; ++j) {
      if (r + j * rs < hw) {
        const float qr = qs[r + j * rs];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float z = __fadd_rn(__fadd_rn(__fmul_rn(xv[j][i], kf[i]), bf[i]), qr);
          float o = z, a = 1.f;
          if (ACT == kRelu) { o = z < 0.f ? 0.f : z; a = z >= 0.f ? 1.f : 0.f; }
          if (ACT == kLeakyRelu) { o = z >= 0.f ? z : __fmul_rn(slope, z); a = z >= 0.f ? 1.f : slope; }
          if (ACT == kTanh) { o = tanhf(z); a = __fsub_rn(1.f, __fmul_rn(o, o)); }
          const float t = (o >= -lim && o <= lim) ? __fmul_rn(gv[j][i], a) : 0.f;
          sk[i] = __fadd_rn(sk[i], __fmul_rn(t, xv[j][i]));
          sb[i] = __fadd_rn(sb[i], t);
          tq[j] = __fadd_rn(tq[j], t);
          gv[j][i] = __fmul_rn(t, kf[i]);
        }
        if (want_dx) store<float, W>(dx + off + j * estep, gv[j]);
      }
    }
    if (want_dq) {
#pragma unroll
      for (int j = 0; j < kModU; ++j) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) tq[j] = __fadd_rn(tq[j], __shfl_xor_sync(0xffffffffu, tq[j], m));
      }
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int j = 0; j < kModU; ++j) rowsum[j][threadIdx.y * warps + threadIdx.x / 32] = tq[j];
      }
      __syncthreads();
      if (threadIdx.x < kModU) {
        const int j = threadIdx.x;
        if (r + j * rs < hw) {
          float s = 0.f;
          for (int w = 0; w < warps; ++w) s = __fadd_rn(s, rowsum[j][threadIdx.y * warps + w]);
          dqs[r + j * rs] = s;
        }
      }
      __syncthreads();
    }
  }
  if (want_sums) {
    float* prow = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c;
    float* rk = red;
    float* rb = red + ry * c;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      rk[threadIdx.y * c + ch + i] = sk[i];
      rb[threadIdx.y * c + ch + i] = sb[i];
    }
    __syncthreads();
    const int nthreads = ux * ry;
    for (int l = tid; l < 2 * c; l += nthreads) {
      const int which = l >= c ? 1 : 0;
      const int col = l - which * c;
      const float* src = (which ? rb : rk) + col;
      float s = 0.f;
      for (int rr = 0; rr < ry; ++rr) s = __fadd_rn(s, src[rr * c]);
      prow[which * c + col] = s;
    }
  }
}

// cbn_bwd_reduce under this family's name, so that a trace tells the two
// apart.
__global__ void __launch_bounds__(256)
mod_bwd_reduce(const float* __restrict__ part, int p, int c, float* __restrict__ dk, float* __restrict__ db) {
  per_sample_reduce<float>(part, p, c, dk, db);
}

// ---------------------------------------------------------------------------
// Batch-norm moments (bnm_*): the train-mode mean and mean of squares per
// channel that every batch norm folds into the epilogue's k and b, and their
// gradient. Replaces no TPU kernel: the JAX package computes them in jnp,
// which XLA fuses into one pass; eager PyTorch takes a column reduce of x, a
// full write of x² and a second column reduce, and its autograd some dozen
// passes over the map backward. Own names (bnm_*), so that no epilogue or
// conv pattern of the benchmark counts them.
//
// Bound: bytes. The forward reads x once (its partial sums are under 1/8 of
// that); the backward, dx = dmean/N + x·(2·dmean_sq/N), reads x and writes
// dx once. The layout is the row kernels' above: a thread owns a unit of W
// channels (a 16-byte load where C is a multiple of W and x is 16-byte
// aligned, else W = 1), walks rows by addition and keeps U rows in flight.
// (On an H100 the forward streams a 105 MB float32 map at ≈70% of 3.35 TB/s
// cold, whether U is 2, 4 or 8, with the next U rows' loads started before
// the current U are added, with blocks on contiguous chunks of rows, or with
// read-only loads; the backward, which also writes, at ≈90%: PERF.md §6.)
//
// The forward sums in float64: each square of a float is exact there, and
// sums of up to ~10^7 terms lose nothing a float32 mean can show, so mean
// and mean_sq are the exact moments rounded once to float32, whatever the
// order of the sums. float64 adds run at half the float32 rate, far above
// what the stream needs.
// The order is fixed (a thread's rows, its block's threads over ty, then the
// blocks in order in bnm_reduce): no atomics, so two calls are bitwise equal.
// ---------------------------------------------------------------------------

constexpr int kBnmU = 4;  // rows in flight a thread

// Σx and Σx² per channel over the block's rows, written to its row of
// `part` (the Σx of each channel, then the Σx²). Block (ux, ry) as the row
// kernels': thread (tx, ty) owns unit tx (and tx + ux, ...).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
bnm_fwd_rows(const T* __restrict__ x, double* __restrict__ part, long long m, int c) {
  __shared__ double red[2 * kThreads * W];
  const int units = c / W;
  const int ry = blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long rs = (long long)gridDim.x * ry;
  const long long estep = rs * c;
  for (int u0 = 0; u0 < units; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    double s1[W], s2[W];
#pragma unroll
    for (int i = 0; i < W; ++i) s1[i] = s2[i] = 0;
    if (u < units) {
      long long r = (long long)blockIdx.x * ry + threadIdx.y;
      for (long long off = r * c + u * W; r < m; r += kBnmU * rs, off += kBnmU * estep) {
        float v[kBnmU][W];
#pragma unroll
        for (int j = 0; j < kBnmU; ++j) {
          if (r + j * rs < m) load<T, W>(x + off + j * estep, v[j]);
        }
#pragma unroll
        for (int j = 0; j < kBnmU; ++j) {
          if (r + j * rs < m) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const double a = v[j][i];
              s1[i] = __dadd_rn(s1[i], a);
              s2[i] = __dadd_rn(s2[i], __dmul_rn(a, a));
            }
          }
        }
      }
    }
    const int cw = min((int)blockDim.x, units - u0) * W;  // channels of this pass
    double* r1 = red;
    double* r2 = red + ry * cw;
    if (u < units) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        r1[threadIdx.y * cw + threadIdx.x * W + i] = s1[i];
        r2[threadIdx.y * cw + threadIdx.x * W + i] = s2[i];
      }
    }
    __syncthreads();
    for (int l = tid; l < 2 * cw; l += nthreads) {
      const int which = l >= cw ? 1 : 0;
      const int col = l - which * cw;
      const double* src = (which ? r2 : r1) + col;
      double t = 0;
      for (int q = 0; q < ry; ++q) t = __dadd_rn(t, src[q * cw]);
      part[(long long)blockIdx.x * 2 * c + which * c + u0 * W + col] = t;
    }
    __syncthreads();
  }
}

// mean[c] = Σ_p part[p][c] / m and mean_sq[c] = Σ_p part[p][C + c] / m
// over the p blocks, rounded once to float32, in a fixed order: thread
// (tx, ty) of a (32, R) block adds the rows p ≡ ty (mod R) of column
// 32·blockIdx.x + tx in order, then row ty = 0 adds the R.
constexpr int kBnmReduceRows = 32;

__global__ void __launch_bounds__(32 * kBnmReduceRows)
bnm_reduce(const double* __restrict__ part, int p, int c, long long m,
           float* __restrict__ mean, float* __restrict__ mean_sq) {
  __shared__ double s[kBnmReduceRows][33];
  const int width = 2 * c;
  const int col = blockIdx.x * 32 + threadIdx.x;
  double a = 0;
  if (col < width) {
#pragma unroll 4
    for (int q = threadIdx.y; q < p; q += kBnmReduceRows) a = __dadd_rn(a, part[(long long)q * width + col]);
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    double t = 0;
#pragma unroll
    for (int r = 0; r < kBnmReduceRows; ++r) t = __dadd_rn(t, s[r][threadIdx.x]);
    const float v = __double2float_rn(__ddiv_rn(t, (double)m));
    if (col < c) {
      mean[col] = v;
    } else {
      mean_sq[col - c] = v;
    }
  }
}

// dx[m, c] = dmean[c]/M + x[m, c]·(2·dmean_sq[c]/M), in float32 and
// rounded once to T; a null cotangent counts as zero.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
bnm_bwd_rows(const T* __restrict__ x, const float* __restrict__ dmean, const float* __restrict__ dmean_sq,
             T* __restrict__ dx, long long m, int c) {
  const int units = c / W;
  const float mf = (float)m;
  const long long rs = (long long)gridDim.x * blockDim.y;
  const long long estep = rs * c;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int ch = u * W;
    float a[W], b[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      a[i] = dmean ? __fdiv_rn(dmean[ch + i], mf) : 0.f;
      b[i] = dmean_sq ? __fdiv_rn(__fmul_rn(2.f, dmean_sq[ch + i]), mf) : 0.f;
    }
    long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
    for (long long off = r * c + ch; r < m; r += kBnmU * rs, off += kBnmU * estep) {
      float v[kBnmU][W];
#pragma unroll
      for (int j = 0; j < kBnmU; ++j) {
        if (r + j * rs < m) load<T, W>(x + off + j * estep, v[j]);
      }
#pragma unroll
      for (int j = 0; j < kBnmU; ++j) {
        if (r + j * rs < m) {
#pragma unroll
          for (int i = 0; i < W; ++i) v[j][i] = __fadd_rn(a[i], __fmul_rn(v[j][i], b[i]));
          store<T, W>(dx + off + j * estep, v[j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename K>
int blocks_per_sm(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return n > 0 ? n : 1;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Blocks for `items` rows (groups), `per_block` of them a block and an
// iteration: at most `cap` (one wave of the card), at least 1.
unsigned grid(long long items, long long per_block, long long cap) {
  long long blocks = ceil_div(items, per_block);
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// Block (ux, ry) of the row kernels for rows of `units` units.
dim3 row_block(int units) {
  const int ux = units < kThreads ? units : kThreads;
  return dim3(ux, kThreads / ux);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// f(T*, integral_constant<ACT>) for the run-time dtype and act.
template <typename T, typename F>
void with_act(int act, F&& f) {
  switch (act) {
    case kLinear: f((T*)nullptr, std::integral_constant<int, kLinear>()); break;
    case kRelu: f((T*)nullptr, std::integral_constant<int, kRelu>()); break;
    case kLeakyRelu: f((T*)nullptr, std::integral_constant<int, kLeakyRelu>()); break;
    default: f((T*)nullptr, std::integral_constant<int, kTanh>()); break;
  }
}

// f(T*) for the run-time dtype: 0 float32, else bfloat16.
template <typename F>
void with_dtype(int dtype, F&& f) {
  if (dtype == 0) {
    f((float*)nullptr);
  } else {
    f((__nv_bfloat16*)nullptr);
  }
}

template <typename F>
void with_types(int dtype, int act, F&& f) {
  with_dtype(dtype, [&](auto* t) { with_act<std::remove_pointer_t<decltype(t)>>(act, f); });
}

template <typename T, int ACT>
void fwd(const T* x, const T* k, const T* b, T* y, long long m, int c, float slope, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long cap = (long long)sm_count();
  if (aligned16(x) && aligned16(y) && c % V == 0) {
    static const int occ = blocks_per_sm(sba_fwd_rows<T, V, ACT>);
    const dim3 blk = row_block(c / V);
    sba_fwd_rows<T, V, ACT><<<grid(m, blk.y, cap * occ), blk, 0, s>>>(x, k, b, y, m, c, slope);
  } else if (aligned16(x) && aligned16(y) && c == 3) {
    static const int occ = blocks_per_sm(sba_fwd_c3<T, ACT>);
    const long long n = m * 3, groups = n / (3 * V);
    sba_fwd_c3<T, ACT><<<grid(groups, kThreads, cap * occ), kThreads, 0, s>>>(x, k, b, y, n, groups, slope);
  } else {
    static const int occ = blocks_per_sm(sba_fwd_rows<T, 1, ACT>);
    const dim3 blk = row_block(c);
    sba_fwd_rows<T, 1, ACT><<<grid(m, blk.y, cap * occ), blk, 0, s>>>(x, k, b, y, m, c, slope);
  }
}

enum Layout { kRowsVec = 0, kGroups3 = 1, kRowsScalar = 2 };

struct BwdPlan {
  Layout layout;
  dim3 block;
  unsigned blocks;  // of the pass, and rows of the workspace it fills
  long long depth;  // the most float32 additions on any term's way into dk or db
};

// The backward's grid: one wave of the card at the kernel's occupancy, or
// fewer blocks where each thread would otherwise sum so few rows that the
// blocks' 2·c partial sums exceed 1/16 of the bytes they stream (x, g, dx:
// 3·sizeof(T) a channel).
template <typename T, int ACT>
BwdPlan bwd_plan(long long m, int c, int flags, bool aligned) {
  constexpr int V = 16 / sizeof(T), U = bwd_unroll<T>();
  const long long cap = (long long)sm_count();
  const bool sums = flags & (kDk | kDb);
  const auto min_rows = [&](int ry) {
    const long long r = ceil_div(16 * 2 * 4, 3LL * ry * (long long)sizeof(T));
    return sums && r > U ? r : (long long)U;
  };
  BwdPlan p;
  long long chain;  // additions in the pass: a thread's own, then its block's
  if (aligned && (c % V == 0 || c == 3)) {
    if (c % V == 0) {
      static const int occ = blocks_per_sm(sba_bwd_rows<T, V, ACT, U>);
      p.layout = kRowsVec;
      p.block = row_block(c / V);
      p.blocks = grid(m, p.block.y * min_rows(p.block.y), cap * occ);
      chain = ceil_div(m, (long long)p.blocks * p.block.y) + p.block.y;
    } else {
      static const int occ = blocks_per_sm(sba_bwd_c3<T, ACT>);
      const long long groups = m / V;  // m·3 elements, 3·V a group
      p.layout = kGroups3;
      p.block = dim3(kThreads);
      p.blocks = grid(groups, kThreads, cap * occ);
      // V terms a channel and group, the tail's fewer than V more, the
      // warp's xor tree, the warps in order
      chain = (ceil_div(groups, (long long)p.blocks * kThreads) + 1) * V + 5 + kThreads / 32;
    }
  } else {
    static const int occ = blocks_per_sm(sba_bwd_rows<T, 1, ACT, U>);
    p.layout = kRowsScalar;
    p.block = row_block(c);
    p.blocks = grid(m, p.block.y * min_rows(p.block.y), cap * occ);
    chain = ceil_div(m, (long long)p.blocks * p.block.y) + p.block.y;
  }
  // the reduce: each of 8 threads adds every 8th block's row in order, then the 8
  p.depth = sums ? chain + ceil_div(p.blocks, 8) + 8 : 0;
  return p;
}

template <typename T, int ACT>
int bwd(const T* x, const T* k, const T* b, const T* g, T* dx, T* dk, T* db, float* ws,
        int ws_blocks, long long m, int c, float slope, int flags, cudaStream_t s) {
  constexpr int U = bwd_unroll<T>();
  const bool sums = flags & (kDk | kDb);
  const bool aligned = aligned16(x) && aligned16(g) && (!(flags & kDx) || aligned16(dx));
  const BwdPlan p = bwd_plan<T, ACT>(m, c, flags, aligned);
  if (sums && (long long)p.blocks > ws_blocks) return (int)cudaErrorInvalidValue;
  if (p.layout == kRowsVec) {
    sba_bwd_rows<T, 16 / sizeof(T), ACT, U><<<p.blocks, p.block, 0, s>>>(x, k, b, g, dx, ws, m, c, slope, flags);
  } else if (p.layout == kGroups3) {
    const long long n = m * 3;
    sba_bwd_c3<T, ACT><<<p.blocks, p.block, 0, s>>>(x, k, b, g, dx, ws, n, n / (3 * (16 / sizeof(T))), slope,
                                                     flags);
  } else {
    sba_bwd_rows<T, 1, ACT, U><<<p.blocks, p.block, 0, s>>>(x, k, b, g, dx, ws, m, c, slope, flags);
  }
  if (sums) {
    const unsigned cols = (unsigned)ceil_div(2LL * c, 32);
    sba_bwd_reduce<T><<<cols, dim3(32, 8), 0, s>>>(ws, (int)p.blocks, c, (flags & kDk) ? dk : nullptr,
                                                  (flags & kDb) ? db : nullptr);
  }
  return (int)cudaGetLastError();
}

bool bad_args(long long m, int c, int dtype, int act) {
  return m <= 0 || c <= 0 || act < 0 || act > 3 || dtype < 0 || dtype > 1;
}

// The per-sample kernels: grid.y is the sample, at most 65535 of them.
bool bad_cond_args(long long n, long long hw, int c, int dtype, int act) {
  return n <= 0 || n > 65535 || bad_args(hw, c, dtype, act);
}

// Blocks a sample for the per-sample kernels: the per-channel kernels' one
// wave of the card shared out over the n samples.
long long cond_cap(long long n, long long cap) { return cap / n > 0 ? cap / n : 1; }

template <typename T, int ACT>
void cond_fwd(const T* x, const T* k, const T* b, T* y, long long n, long long hw, int c, float slope,
              cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long cap = (long long)sm_count();
  if (aligned16(x) && aligned16(y) && c % V == 0) {
    static const int occ = blocks_per_sm(cbn_fwd_rows<T, V, ACT>);
    const dim3 blk = row_block(c / V);
    const dim3 grd(grid(hw, blk.y, cond_cap(n, cap * occ)), (unsigned)n);
    cbn_fwd_rows<T, V, ACT><<<grd, blk, 0, s>>>(x, k, b, y, hw, c, slope);
  } else {
    static const int occ = blocks_per_sm(cbn_fwd_rows<T, 1, ACT>);
    const dim3 blk = row_block(c);
    const dim3 grd(grid(hw, blk.y, cond_cap(n, cap * occ)), (unsigned)n);
    cbn_fwd_rows<T, 1, ACT><<<grd, blk, 0, s>>>(x, k, b, y, hw, c, slope);
  }
}

// The per-sample backward's grid: bwd_plan's rules over each sample's hw
// rows, the wave shared out over the samples. `blocks` is a sample's.
template <typename T, int ACT>
BwdPlan cond_bwd_plan(long long n, long long hw, int c, int flags, bool aligned) {
  constexpr int V = 16 / sizeof(T), U = bwd_unroll<T>();
  const long long cap = (long long)sm_count();
  const bool sums = flags & (kDk | kDb);
  const auto min_rows = [&](int ry) {
    const long long r = ceil_div(16 * 2 * 4, 3LL * ry * (long long)sizeof(T));
    return sums && r > U ? r : (long long)U;
  };
  BwdPlan p;
  int occ;
  if (aligned && c % V == 0) {
    static const int o = blocks_per_sm(cbn_bwd_rows<T, V, ACT, U>);
    occ = o;
    p.layout = kRowsVec;
    p.block = row_block(c / V);
  } else {
    static const int o = blocks_per_sm(cbn_bwd_rows<T, 1, ACT, U>);
    occ = o;
    p.layout = kRowsScalar;
    p.block = row_block(c);
  }
  p.blocks = grid(hw, p.block.y * min_rows(p.block.y), cond_cap(n, cap * occ));
  const long long chain = ceil_div(hw, (long long)p.blocks * p.block.y) + p.block.y;
  p.depth = sums ? chain + ceil_div(p.blocks, 8) + 8 : 0;
  return p;
}

template <typename T, int ACT>
int cond_bwd(const T* x, const T* k, const T* b, const T* g, T* dx, T* dk, T* db, float* ws,
             long long ws_blocks, long long n, long long hw, int c, float slope, int flags, cudaStream_t s) {
  constexpr int U = bwd_unroll<T>();
  const bool sums = flags & (kDk | kDb);
  const bool aligned = aligned16(x) && aligned16(g) && (!(flags & kDx) || aligned16(dx));
  const BwdPlan p = cond_bwd_plan<T, ACT>(n, hw, c, flags, aligned);
  if (sums && (long long)p.blocks * n > ws_blocks) return (int)cudaErrorInvalidValue;
  const dim3 grd(p.blocks, (unsigned)n);
  if (p.layout == kRowsVec) {
    cbn_bwd_rows<T, 16 / sizeof(T), ACT, U><<<grd, p.block, 0, s>>>(x, k, b, g, dx, ws, hw, c, slope, flags);
  } else {
    cbn_bwd_rows<T, 1, ACT, U><<<grd, p.block, 0, s>>>(x, k, b, g, dx, ws, hw, c, slope, flags);
  }
  if (sums) {
    const dim3 red((unsigned)ceil_div(2LL * c, 32), (unsigned)n);
    cbn_bwd_reduce<T><<<red, dim3(32, 8), 0, s>>>(ws, (int)p.blocks, c, (flags & kDk) ? dk : nullptr,
                                                 (flags & kDb) ? db : nullptr);
  }
  return (int)cudaGetLastError();
}

// The modulated conv's epilogue: cbn_*'s grid (one wave of the card shared
// out over the n samples, the row layout of 16-byte units where c is a
// multiple of 4 and the tensors are 16-byte aligned, else of single
// channels).
template <int ACT>
void mod_fwd(const float* x, const float* k, const float* b, const float* q, float* y, long long n, long long hw,
             int c, float slope, float lim, cudaStream_t s) {
  const long long cap = (long long)sm_count();
  if (aligned16(x) && aligned16(y) && c % 4 == 0) {
    static const int occ = blocks_per_sm(mod_fwd_rows<4, ACT>);
    const dim3 blk = row_block(c / 4);
    const dim3 grd(grid(hw, blk.y, cond_cap(n, cap * occ)), (unsigned)n);
    mod_fwd_rows<4, ACT><<<grd, blk, 0, s>>>(x, k, b, q, y, hw, c, slope, lim);
  } else {
    static const int occ = blocks_per_sm(mod_fwd_rows<1, ACT>);
    const dim3 blk = row_block(c);
    const dim3 grd(grid(hw, blk.y, cond_cap(n, cap * occ)), (unsigned)n);
    mod_fwd_rows<1, ACT><<<grd, blk, 0, s>>>(x, k, b, q, y, hw, c, slope, lim);
  }
}

// The backward's grid: a row's units are whole warps, at most a block
// (else `ok` is false); blocks a sample by cond_bwd_plan's rules.
struct ModPlan {
  bool ok, vec;
  dim3 block;
  unsigned blocks;  // a sample's
  long long depth;  // the most float32 additions on any term's way into dk or db
};

template <int ACT>
ModPlan mod_bwd_plan(long long n, long long hw, int c, int flags, bool aligned) {
  ModPlan p;
  p.vec = aligned && c % 4 == 0;
  const int units = p.vec ? c / 4 : c;
  p.ok = units % 32 == 0 && units <= kThreads;
  p.block = dim3(units > 0 ? units : 1, units > 0 ? kThreads / (units > 0 ? units : 1) : 1);
  p.blocks = 1;
  p.depth = 0;
  if (!p.ok) return p;
  int occ;
  if (p.vec) {
    static const int o = blocks_per_sm(mod_bwd_rows<4, ACT>);
    occ = o;
  } else {
    static const int o = blocks_per_sm(mod_bwd_rows<1, ACT>);
    occ = o;
  }
  const bool sums = flags & (kDk | kDb);
  const long long cap = (long long)sm_count();
  const long long r = ceil_div(16 * 2 * 4, 3LL * p.block.y * 4);
  const long long min_rows = sums && r > kModU ? r : (long long)kModU;
  p.blocks = grid(hw, p.block.y * min_rows, cond_cap(n, cap * occ));
  const long long chain = ceil_div(hw, (long long)p.blocks * p.block.y) + p.block.y;
  p.depth = sums ? chain + ceil_div(p.blocks, 8) + 8 : 0;
  return p;
}

template <int ACT>
int mod_bwd(const float* x, const float* k, const float* b, const float* q, const float* g, float* dx, float* dq,
            float* dk, float* db, float* ws, long long ws_blocks, long long n, long long hw, int c, float slope,
            float lim, int flags, cudaStream_t s) {
  const bool sums = flags & (kDk | kDb);
  const bool aligned = aligned16(x) && aligned16(g) && (!(flags & kDx) || aligned16(dx));
  const ModPlan p = mod_bwd_plan<ACT>(n, hw, c, flags, aligned);
  if (!p.ok || (sums && (long long)p.blocks * n > ws_blocks)) return (int)cudaErrorInvalidValue;
  const dim3 grd(p.blocks, (unsigned)n);
  if (p.vec) {
    mod_bwd_rows<4, ACT><<<grd, p.block, 0, s>>>(x, k, b, q, g, dx, dq, ws, hw, c, slope, lim, flags);
  } else {
    mod_bwd_rows<1, ACT><<<grd, p.block, 0, s>>>(x, k, b, q, g, dx, dq, ws, hw, c, slope, lim, flags);
  }
  if (sums) {
    const dim3 red((unsigned)ceil_div(2LL * c, 32), (unsigned)n);
    mod_bwd_reduce<<<red, dim3(32, 8), 0, s>>>(ws, (int)p.blocks, c, (flags & kDk) ? dk : nullptr,
                                             (flags & kDb) ? db : nullptr);
  }
  return (int)cudaGetLastError();
}

// The moments' grid for m rows of c channels: the row layout of 16-byte
// units where c is a multiple of V and x (and dx) 16-byte aligned, else of
// single channels (W = 1); one wave of the card at the kernel's occupancy,
// or fewer blocks where a thread would otherwise take fewer than U rows or,
// in the forward, so few that the blocks' 2·c float64 partial sums exceed
// 1/8 of the bytes they read.
struct BnmPlan {
  bool vec;
  dim3 block;
  unsigned blocks;
};

template <typename T>
BnmPlan bnm_plan(long long m, int c, bool aligned, bool fwd) {
  constexpr int V = 16 / sizeof(T);
  BnmPlan p;
  p.vec = aligned && c % V == 0;
  int occ;
  if (p.vec) {
    static const int of = blocks_per_sm(bnm_fwd_rows<T, V>), ob = blocks_per_sm(bnm_bwd_rows<T, V>);
    occ = fwd ? of : ob;
    p.block = row_block(c / V);
  } else {
    static const int of = blocks_per_sm(bnm_fwd_rows<T, 1>), ob = blocks_per_sm(bnm_bwd_rows<T, 1>);
    occ = fwd ? of : ob;
    p.block = row_block(c);
  }
  long long rows = kBnmU;
  if (fwd) {
    const long long r = ceil_div(8 * 2 * (long long)sizeof(double), (long long)p.block.y * (long long)sizeof(T));
    if (r > rows) rows = r;
  }
  p.blocks = grid(m, p.block.y * rows, (long long)sm_count() * occ);
  return p;
}

template <typename T>
int bnm_fwd(const T* x, double* ws, int ws_blocks, float* mean, float* mean_sq, long long m, int c,
            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const BnmPlan p = bnm_plan<T>(m, c, aligned16(x), true);
  if ((long long)p.blocks > ws_blocks) return (int)cudaErrorInvalidValue;
  if (p.vec) {
    bnm_fwd_rows<T, V><<<p.blocks, p.block, 0, s>>>(x, ws, m, c);
  } else {
    bnm_fwd_rows<T, 1><<<p.blocks, p.block, 0, s>>>(x, ws, m, c);
  }
  const unsigned cols = (unsigned)ceil_div(2LL * c, 32);
  bnm_reduce<<<cols, dim3(32, kBnmReduceRows), 0, s>>>(ws, (int)p.blocks, c, m, mean, mean_sq);
  return (int)cudaGetLastError();
}

template <typename T>
int bnm_bwd(const T* x, const float* dmean, const float* dmean_sq, T* dx, long long m, int c, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const BnmPlan p = bnm_plan<T>(m, c, aligned16(x) && aligned16(dx), false);
  if (p.vec) {
    bnm_bwd_rows<T, V><<<p.blocks, p.block, 0, s>>>(x, dmean, dmean_sq, dx, m, c);
  } else {
    bnm_bwd_rows<T, 1><<<p.blocks, p.block, 0, s>>>(x, dmean, dmean_sq, dx, m, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y = act(x·k + b) over m rows of c channels. dtype: 0 = float32,
// 1 = bfloat16 (x, k, b and y all of it). act: 0 linear, 1 relu,
// 2 leaky_relu, 3 tanh. Returns a cudaError_t as int: 0 on a good launch,
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int scale_bias_act_launch(const void* x, const void* k, const void* b, void* y,
                                     long long m, int c, int dtype, int act, float slope,
                                     void* stream) {
  if (bad_args(m, c, dtype, act) || !x || !k || !b || !y) return (int)cudaErrorInvalidValue;
  with_types(dtype, act, [&](auto* t, auto a) {
    using T = std::remove_pointer_t<decltype(t)>;
    fwd<T, decltype(a)::value>(static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(b),
                               static_cast<T*>(y), m, c, slope, static_cast<cudaStream_t>(stream));
  });
  return (int)cudaGetLastError();
}

// The backward's grid for m rows of c channels, the flags below, and
// whether x, g and dx are all 16-byte aligned: `blocks`, the rows of 2·c
// floats the workspace needs where dk or db is asked for, and `depth`, the
// most float32 additions any term goes through on its way into dk or db
// (for an error bound of the sums). Returns a cudaError_t as int.
extern "C" int scale_bias_act_bwd_plan(long long m, int c, int dtype, int act, int flags, int aligned,
                                       int* blocks, long long* depth) {
  if (bad_args(m, c, dtype, act) || flags <= 0 || flags > 7 || !blocks || !depth) {
    return (int)cudaErrorInvalidValue;
  }
  with_types(dtype, act, [&](auto* t, auto a) {
    const BwdPlan p = bwd_plan<std::remove_pointer_t<decltype(t)>, decltype(a)::value>(m, c, flags, aligned != 0);
    *blocks = (int)p.blocks;
    *depth = p.depth;
  });
  return (int)cudaGetLastError();
}

// The backward for the output cotangent g (all of x's dtype): flags say
// which of dx (1), dk (2) and db (4) to write; dk and db need a float32
// workspace `ws` of ws_blocks rows of 2·c floats, at least the blocks that
// scale_bias_act_bwd_plan reports. Returns a cudaError_t as int, as above.
extern "C" int scale_bias_act_bwd_launch(const void* x, const void* k, const void* b, const void* g,
                                         void* dx, void* dk, void* db, void* ws, int ws_blocks,
                                         long long m, int c, int dtype, int act, float slope,
                                         int flags, void* stream) {
  if (bad_args(m, c, dtype, act) || flags <= 0 || flags > 7 || !x || !k || !b || !g ||
      ((flags & kDx) && !dx) || ((flags & kDk) && !dk) || ((flags & kDb) && !db) ||
      ((flags & (kDk | kDb)) && (!ws || ws_blocks < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = 0;
  with_types(dtype, act, [&](auto* t, auto a) {
    using T = std::remove_pointer_t<decltype(t)>;
    rc = bwd<T, decltype(a)::value>(static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(b),
                                    static_cast<const T*>(g), static_cast<T*>(dx), static_cast<T*>(dk),
                                    static_cast<T*>(db), static_cast<float*>(ws), ws_blocks, m, c, slope, flags,
                                    static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// The per-sample forward: x and y are (n, hw, c), k and b (n, c), all of
// dtype; y[s, r, :] = act(x[s, r, :]·k[s, :] + b[s, :]). Returns a
// cudaError_t as int, as above.
extern "C" int scale_bias_act_cond_launch(const void* x, const void* k, const void* b, void* y, long long n,
                                          long long hw, int c, int dtype, int act, float slope, void* stream) {
  if (bad_cond_args(n, hw, c, dtype, act) || !x || !k || !b || !y) return (int)cudaErrorInvalidValue;
  with_types(dtype, act, [&](auto* t, auto a) {
    using T = std::remove_pointer_t<decltype(t)>;
    cond_fwd<T, decltype(a)::value>(static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(b),
                                    static_cast<T*>(y), n, hw, c, slope, static_cast<cudaStream_t>(stream));
  });
  return (int)cudaGetLastError();
}

// The per-sample backward's grid: `blocks`, a sample's blocks (the
// workspace needs n·blocks rows of 2·c floats where dk or db is asked for),
// and `depth`, as scale_bias_act_bwd_plan's.
extern "C" int scale_bias_act_cond_bwd_plan(long long n, long long hw, int c, int dtype, int act, int flags,
                                            int aligned, int* blocks, long long* depth) {
  if (bad_cond_args(n, hw, c, dtype, act) || flags <= 0 || flags > 7 || !blocks || !depth) {
    return (int)cudaErrorInvalidValue;
  }
  with_types(dtype, act, [&](auto* t, auto a) {
    const BwdPlan p =
        cond_bwd_plan<std::remove_pointer_t<decltype(t)>, decltype(a)::value>(n, hw, c, flags, aligned != 0);
    *blocks = (int)p.blocks;
    *depth = p.depth;
  });
  return (int)cudaGetLastError();
}

// The per-sample backward: dx (n, hw, c), dk and db (n, c), the flags as
// scale_bias_act_bwd_launch's; ws holds ws_blocks rows of 2·c floats, at
// least n times the blocks that scale_bias_act_cond_bwd_plan reports.
extern "C" int scale_bias_act_cond_bwd_launch(const void* x, const void* k, const void* b, const void* g,
                                              void* dx, void* dk, void* db, void* ws, long long ws_blocks,
                                              long long n, long long hw, int c, int dtype, int act, float slope,
                                              int flags, void* stream) {
  if (bad_cond_args(n, hw, c, dtype, act) || flags <= 0 || flags > 7 || !x || !k || !b || !g ||
      ((flags & kDx) && !dx) || ((flags & kDk) && !dk) || ((flags & kDb) && !db) ||
      ((flags & (kDk | kDb)) && (!ws || ws_blocks < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = 0;
  with_types(dtype, act, [&](auto* t, auto a) {
    using T = std::remove_pointer_t<decltype(t)>;
    rc = cond_bwd<T, decltype(a)::value>(static_cast<const T*>(x), static_cast<const T*>(k),
                                         static_cast<const T*>(b), static_cast<const T*>(g), static_cast<T*>(dx),
                                         static_cast<T*>(dk), static_cast<T*>(db), static_cast<float*>(ws),
                                         ws_blocks, n, hw, c, slope, flags, static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// The modulated conv's epilogue, float32: x and y (n, hw, c), k (n, c),
// b (c,), q (n, hw); y = clamp(act(x·k[s] + b + q[s, r]), ±lim). Returns a
// cudaError_t as int, as above.
extern "C" int mod_epilogue_launch(const void* x, const void* k, const void* b, const void* q, void* y,
                                   long long n, long long hw, int c, int act, float slope, float lim,
                                   void* stream) {
  if (bad_cond_args(n, hw, c, 0, act) || !x || !k || !b || !q || !y) return (int)cudaErrorInvalidValue;
  with_act<float>(act, [&](auto*, auto a) {
    mod_fwd<decltype(a)::value>(static_cast<const float*>(x), static_cast<const float*>(k),
                                static_cast<const float*>(b), static_cast<const float*>(q), static_cast<float*>(y),
                                n, hw, c, slope, lim, static_cast<cudaStream_t>(stream));
  });
  return (int)cudaGetLastError();
}

// The backward's grid for flags as below and whether x, g and dx are all
// 16-byte aligned: `blocks`, a sample's blocks (the workspace needs
// n·blocks rows of 2·c floats where dk or db is asked for), and `depth`, as
// scale_bias_act_bwd_plan's. cudaErrorInvalidValue where c is not whole
// warps of units (c/4 aligned, else c, a multiple of 32 and at most 256).
extern "C" int mod_epilogue_bwd_plan(long long n, long long hw, int c, int act, int flags, int aligned,
                                     int* blocks, long long* depth) {
  if (bad_cond_args(n, hw, c, 0, act) || flags <= 0 || flags > 15 || !blocks || !depth) {
    return (int)cudaErrorInvalidValue;
  }
  bool ok = true;
  with_act<float>(act, [&](auto*, auto a) {
    const ModPlan p = mod_bwd_plan<decltype(a)::value>(n, hw, c, flags, aligned != 0);
    ok = p.ok;
    *blocks = (int)p.blocks;
    *depth = p.depth;
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The backward for the output cotangent g: flags say which of dx (1), dk
// (2, (n, c)), the per-sample db (4, (n, c)) and dq (8, (n, hw)) to write;
// dk and db need ws of ws_blocks rows of 2·c floats, at least n times the
// blocks that mod_epilogue_bwd_plan reports. Returns a cudaError_t as int.
extern "C" int mod_epilogue_bwd_launch(const void* x, const void* k, const void* b, const void* q, const void* g,
                                       void* dx, void* dq, void* dk, void* db, void* ws, long long ws_blocks,
                                       long long n, long long hw, int c, int act, float slope, float lim, int flags,
                                       void* stream) {
  if (bad_cond_args(n, hw, c, 0, act) || flags <= 0 || flags > 15 || !x || !k || !b || !q || !g ||
      ((flags & kDx) && !dx) || ((flags & 8) && !dq) || ((flags & kDk) && !dk) || ((flags & kDb) && !db) ||
      ((flags & (kDk | kDb)) && (!ws || ws_blocks < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = 0;
  with_act<float>(act, [&](auto*, auto a) {
    rc = mod_bwd<decltype(a)::value>(static_cast<const float*>(x), static_cast<const float*>(k),
                                     static_cast<const float*>(b), static_cast<const float*>(q),
                                     static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(dq),
                                     static_cast<float*>(dk), static_cast<float*>(db), static_cast<float*>(ws),
                                     ws_blocks, n, hw, c, slope, lim, flags, static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// The batch-norm moments' forward grid for m rows of c channels and
// whether x is 16-byte aligned: `blocks`, the rows of 2·c float64 values its
// workspace needs, and `depth`, the most float64 additions any term goes
// through on its way into a sum (a thread's rows, its block's threads, the
// reduce's two levels). Returns a cudaError_t as int.
extern "C" int bn_moments_plan(long long m, int c, int dtype, int aligned, int* blocks, long long* depth) {
  if (bad_args(m, c, dtype, 0) || !blocks || !depth) return (int)cudaErrorInvalidValue;
  with_dtype(dtype, [&](auto* t) {
    const BnmPlan p = bnm_plan<std::remove_pointer_t<decltype(t)>>(m, c, aligned != 0, true);
    *blocks = (int)p.blocks;
    *depth = ceil_div(m, (long long)p.blocks * p.block.y) + p.block.y + ceil_div(p.blocks, kBnmReduceRows) +
             kBnmReduceRows;
  });
  return (int)cudaGetLastError();
}

// mean[c] = Σ_m x[m, c] / m and mean_sq[c] = Σ_m x[m, c]² / m, float32
// (c,) each, for x of m rows of c channels (dtype 0 float32, 1 bfloat16);
// ws holds ws_blocks rows of 2·c float64 values, at least the blocks
// bn_moments_plan reports. Returns a cudaError_t as int, as above.
extern "C" int bn_moments_launch(const void* x, void* ws, int ws_blocks, void* mean, void* mean_sq, long long m,
                                 int c, int dtype, void* stream) {
  if (bad_args(m, c, dtype, 0) || !x || !ws || !mean || !mean_sq) return (int)cudaErrorInvalidValue;
  int rc = 0;
  with_dtype(dtype, [&](auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    rc = bnm_fwd<T>(static_cast<const T*>(x), static_cast<double*>(ws), ws_blocks, static_cast<float*>(mean),
                    static_cast<float*>(mean_sq), m, c, static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// The moments' gradient: dx = dmean/m + x·(2·dmean_sq/m), in x's dtype, for
// the float32 (c,) cotangents dmean and dmean_sq (either null: zero).
// Returns a cudaError_t as int, as above.
extern "C" int bn_moments_bwd_launch(const void* x, const void* dmean, const void* dmean_sq, void* dx, long long m,
                                     int c, int dtype, void* stream) {
  if (bad_args(m, c, dtype, 0) || !x || !dx) return (int)cudaErrorInvalidValue;
  int rc = 0;
  with_dtype(dtype, [&](auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    rc = bnm_bwd<T>(static_cast<const T*>(x), static_cast<const float*>(dmean), static_cast<const float*>(dmean_sq),
                    static_cast<T*>(dx), m, c, static_cast<cudaStream_t>(stream));
  });
  return rc;
}
