// 3x3 stride-1 convolution of NHWC activations, forward (also used for the
// input gradient) and filter gradient, float32 or bfloat16 in, float32
// accumulation.
//
// Replaces the TPU kernels of triplegan_tpu/ops/pallas_conv.py:
//   conv3x3_fwd   <- _fwd_kernel    (launched by conv3x3_nopad)
//   conv3x3_wgrad <- _wgrad_kernel  (launched by conv3x3_wgrad)
//
// Semantics. x is (N, Hin, Win, Cin) row-major; it is read with a zero halo
// of `pad` pixels (0, 1 or 2) on every side, checked per element, so that
// pad 0 on a pre-padded input is JAX's conv3x3_nopad and pad p on the raw
// input equals JAX's pad-then-VALID. Ho = Hin + 2*pad - 2, Wo likewise.
//   forward: y[n,h,w,co] = sum_{dy,dx,ci} xh[n,h+dy,w+dx,ci] * W[dy,dx,ci,co]
//     W is HWIO (3, 3, Cin, Cout) row-major, i.e. a (9*Cin, Cout) matrix
//     whose row k = (dy*3 + dx)*Cin + ci; y is written in x's type.
//   wgrad:   dW[dy,dx,ci,co] = sum_{n,h,w} xh[n,h+dy,w+dx,ci] * g[n,h,w,co]
//     g is (N, Ho, Wo, Cout); dW is float32 (3, 3, Cin, Cout).
//
// Bound: operations at the shapes of the training step (arithmetic
// intensity of hundreds of flops per byte at Cin >= 42), bytes only for
// the Cin = 3 and 13 first layers.
//
// Design: an implicit GEMM on the CUDA cores, M = N*Ho*Wo output pixels,
// N = Cout, K = 9*Cin. A block computes a BM x BN tile of the output with
// 256 threads, each holding a TM x TN float32 accumulator in registers.
// Tiles of BK = 16 along K are staged in shared memory as float32 (bf16 is
// widened on load); the next tile is loaded into registers while the
// current one is multiplied. The im2col gather is never materialized: each
// block keeps the (pixel offset, h, w) of its BM output rows in shared
// memory, each thread decodes its K column into (dy, dx, ci) once per
// tile, and out-of-image taps read as zero. Offsets are 64-bit.
// wgrad is the same GEMM with the roles swapped (rows K, columns Cout,
// reduction over M). It is deterministic: the M reduction is split over
// `splits` blocks along grid z, each writes its partial tile to a float32
// workspace, and a second kernel sums the partials in a fixed order. No
// float atomics, so two runs give the same bits.
// Tensor cores (wgmma), TMA and a deeper pipeline are later work.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // K depth (forward) or M depth (wgrad) of a tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int n, hin, win, cin, cout, pad, ho, wo, k;
  long long m;
};

constexpr int kFar = -(1 << 29);  // an h or w that fails every bounds check

// Multiply the staged tiles: acc[i][j] += A[kk][ty*TM+i] * B[kk][tx*TN+j].
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void mma_tile(float (*As)[BM + 4], float (*Bs)[BN],
                                         int ty, int tx, float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<float4*>(&As[kk][ty * TM + i]);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
    if constexpr (TN == 4) {
      const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(&Bs[kk][tx * TN]);
      b[0] = v.x; b[1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: y = conv(xh, W)
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, Shape s) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  static_assert(TM % 4 == 0 && (TN == 4 || TN == 2), "vector loads from shared memory");
  constexpr int kAPass = kThreads / kBK;   // rows of A loaded per pass
  constexpr int kARows = BM / kAPass;      // A elements per thread
  constexpr int kBPass = kThreads / BN;    // rows of B loaded per pass
  constexpr int kBRows = kBK / kBPass;     // B elements per thread
  static_assert(kBRows >= 1 && kBK % kBPass == 0, "B tile split");

  __shared__ __align__(16) float As[kBK][BM + 4];
  __shared__ __align__(16) float Bs[kBK][BN];
  __shared__ long long sBase[BM];  // x offset of (n, h, w, 0) for output row m
  __shared__ int sH[BM], sW[BM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw = s.ho * s.wo;

  for (int r = tid; r < BM; r += kThreads) {
    const long long m = m0 + r;
    if (m < s.m) {
      const int nn = (int)(m / hw);
      const int rem = (int)(m - (long long)nn * hw);
      const int h = rem / s.wo;
      const int ww = rem - h * s.wo;
      sBase[r] = (((long long)nn * s.hin + h) * s.win + ww) * s.cin;
      sH[r] = h;
      sW[r] = ww;
    } else {
      sBase[r] = 0;
      sH[r] = kFar;
      sW[r] = kFar;
    }
  }
  __syncthreads();

  const int akk = tid % kBK, ar = tid / kBK;   // A: column akk, rows ar + kAPass*i
  const int bc = tid % BN, br = tid / BN;      // B: column bc, rows br + kBPass*i
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  float ra[kARows], rb[kBRows];
  auto load = [&](int k0) {
    const int k = k0 + akk;
    int dyp = kFar, dxp = kFar, koff = 0;
    if (k < s.k) {
      const int tap = k / s.cin;
      const int ci = k - tap * s.cin;
      const int dy = tap / 3;
      dyp = dy - s.pad;
      dxp = tap - 3 * dy - s.pad;
      koff = (dyp * s.win + dxp) * s.cin + ci;
    }
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = ar + kAPass * i;
      const int hi = sH[r] + dyp, wi = sW[r] + dxp;
      const bool ok = (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
      ra[i] = ok ? to_f(x[sBase[r] + koff]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int kr = k0 + br + kBPass * i;
      const int col = n0 + bc;
      rb[i] = (kr < s.k && col < s.cout) ? to_f(w[(long long)kr * s.cout + col]) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kARows; ++i) As[akk][ar + kAPass * i] = ra[i];
#pragma unroll
    for (int i = 0; i < kBRows; ++i) Bs[br + kBPass * i][bc] = rb[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < s.k; k0 += kBK) {
    const bool more = k0 + kBK < s.k;
    if (more) load(k0 + kBK);
    mma_tile<BM, BN, TM, TN>(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= s.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < s.cout) y[m * s.cout + col] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: partial dW over the M range of this block's split
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
             Shape s, long long chunk) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  static_assert(TM % 4 == 0 && (TN == 4 || TN == 2), "vector loads from shared memory");
  constexpr int kAK = BM / kBK;         // A elements per thread (one m, kAK k's)
  constexpr int kGPass = kThreads / BN;  // m rows of g loaded per pass
  constexpr int kGRows = kBK / kGPass;   // g elements per thread
  static_assert(kGRows >= 1 && kBK % kGPass == 0, "g tile split");

  __shared__ __align__(16) float As[kBK][BM + 4];  // [m][k]: patch values
  __shared__ __align__(16) float Gs[kBK][BN];      // [m][co]
  __shared__ int sKoff[BM], sKdy[BM], sKdx[BM];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < s.m ? mbeg + chunk : s.m;

  for (int r = tid; r < BM; r += kThreads) {
    const int k = k0 + r;
    if (k < s.k) {
      const int tap = k / s.cin;
      const int ci = k - tap * s.cin;
      const int dy = tap / 3;
      sKdy[r] = dy - s.pad;
      sKdx[r] = tap - 3 * dy - s.pad;
      sKoff[r] = (sKdy[r] * s.win + sKdx[r]) * s.cin + ci;
    } else {
      sKdy[r] = kFar;
      sKdx[r] = kFar;
      sKoff[r] = 0;
    }
  }
  __syncthreads();

  // A: this thread's row am of the tile and columns ak + kBK*j.
  const int am = tid / kBK, ak = tid % kBK;
  // g: column gc and rows gr + kGPass*i.
  const int gc = tid % BN, gr = tid / BN;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  // Output pixel of this thread's A row, advanced by kBK per tile.
  long long m = mbeg + am;
  int pn, ph, pw;
  {
    const int hw = s.ho * s.wo;
    pn = (int)(m / hw);
    const int rem = (int)(m - (long long)pn * hw);
    ph = rem / s.wo;
    pw = rem - ph * s.wo;
  }

  float ra[kAK], rg[kGRows];
  long long mt = mbeg;  // first m of the tile being loaded
  auto load = [&]() {
    const long long base = (((long long)pn * s.hin + ph) * s.win + pw) * s.cin;
    const bool mok = m < mend;
#pragma unroll
    for (int j = 0; j < kAK; ++j) {
      const int r = ak + kBK * j;
      const int hi = ph + sKdy[r], wi = pw + sKdx[r];
      const bool ok = mok && (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
      ra[j] = ok ? to_f(x[base + sKoff[r]]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGRows; ++i) {
      const long long mm = mt + gr + kGPass * i;
      const int col = n0 + gc;
      rg[i] = (mm < mend && col < s.cout) ? to_f(g[mm * s.cout + col]) : 0.f;
    }
    // advance this thread's A pixel and the tile start by kBK
    m += kBK;
    mt += kBK;
    pw += kBK;
    ph += pw / s.wo;
    pw %= s.wo;
    pn += ph / s.ho;
    ph %= s.ho;
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kAK; ++j) As[am][ak + kBK * j] = ra[j];
#pragma unroll
    for (int i = 0; i < kGRows; ++i) Gs[gr + kGPass * i][gc] = rg[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (mbeg < mend) {
    load();
    stage();
    __syncthreads();
    for (long long t0 = mbeg; t0 < mend; t0 += kBK) {
      const bool more = t0 + kBK < mend;
      if (more) load();
      mma_tile<BM, BN, TM, TN>(As, Gs, ty, tx, acc);
      __syncthreads();
      if (more) {
        stage();
        __syncthreads();
      }
    }
  }

  float* out = ws + (long long)blockIdx.z * s.k * s.cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty * TM + i;
    if (k >= s.k) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < s.cout) out[(long long)k * s.cout + col] = acc[i][j];
    }
  }
}

// out[i] = sum over z = 0 .. splits-1, in that order, of ws[z][i].
__global__ void reduce_splits(const float* __restrict__ ws, float* __restrict__ out,
                              long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += ws[(long long)z * n + i];
    out[i] = sum;
  }
}

bool make_shape(int n, int hin, int win, int cin, int cout, int pad, Shape* s) {
  if (n <= 0 || cin <= 0 || cout <= 0 || pad < 0 || pad > 2) return false;
  s->n = n; s->hin = hin; s->win = win; s->cin = cin; s->cout = cout; s->pad = pad;
  s->ho = hin + 2 * pad - 2;
  s->wo = win + 2 * pad - 2;
  if (s->ho <= 0 || s->wo <= 0) return false;
  if ((long long)9 * cin > (1LL << 30)) return false;
  s->k = 9 * cin;
  s->m = (long long)n * s->ho * s->wo;
  // per-tap offsets are 32-bit: (2*win + 2) * cin must fit
  if ((long long)(2 * win + 3) * cin >= (1LL << 31)) return false;
  return true;
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_fwd(const void* x, const void* w, void* y, const Shape& s, cudaStream_t st) {
  const long long gx = (s.m + BM - 1) / BM;
  dim3 grid((unsigned)gx, (unsigned)((s.cout + BN - 1) / BN));
  fwd_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), s);
}

template <typename T>
void dispatch_fwd(const void* x, const void* w, void* y, const Shape& s, cudaStream_t st) {
  if (s.cout <= 32) launch_fwd<T, 128, 32, 8, 2>(x, w, y, s, st);
  else launch_fwd<T, 128, 64, 8, 4>(x, w, y, s, st);
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_wgrad(const void* x, const void* g, float* ws, const Shape& s, int splits,
                  long long chunk, cudaStream_t st) {
  dim3 grid((unsigned)((s.k + BM - 1) / BM), (unsigned)((s.cout + BN - 1) / BN), (unsigned)splits);
  wgrad_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ws, s, chunk);
}

template <typename T>
void dispatch_wgrad(const void* x, const void* g, float* ws, const Shape& s, int splits,
                    long long chunk, cudaStream_t st) {
  if (s.cout <= 32) launch_wgrad<T, 128, 32, 8, 2>(x, g, ws, s, splits, chunk, st);
  else launch_wgrad<T, 64, 64, 4, 4>(x, g, ws, s, splits, chunk, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y all of it).
// Returns a cudaError_t as int: 0 on a good launch, cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int conv3x3_fwd_launch(const void* x, const void* w, void* y, int n, int hin,
                                  int win, int cin, int cout, int pad, int dtype,
                                  void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s) || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((s.m + 127) / 128 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) dispatch_fwd<float>(x, w, y, s, st);
  else dispatch_fwd<__nv_bfloat16>(x, w, y, s, st);
  return (int)cudaGetLastError();
}

// x: (n, hin, win, cin); g: (n, ho, wo, cout) of the same dtype; out: the
// float32 (3, 3, cin, cout) filter gradient. The M = n*ho*wo reduction is
// split into `splits` ranges of `chunk` pixels (chunk a multiple of 16,
// splits * chunk >= M); ws holds splits * 9*cin*cout floats, or is out
// itself when splits == 1.
extern "C" int conv3x3_wgrad_launch(const void* x, const void* g, float* ws, float* out,
                                    int n, int hin, int win, int cin, int cout, int pad,
                                    int splits, long long chunk, int dtype, void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s) || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || splits > 65535 || chunk <= 0 || chunk % kBK != 0 ||
      (long long)splits * chunk < s.m || (long long)(splits - 1) * chunk >= s.m ||
      (splits == 1 && ws != out) || (splits > 1 && ws == out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) dispatch_wgrad<float>(x, g, ws, s, splits, chunk, st);
  else dispatch_wgrad<__nv_bfloat16>(x, g, ws, s, splits, chunk, st);
  if (splits > 1) {
    const long long total = (long long)s.k * s.cout;
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    reduce_splits<<<(unsigned)blocks, 256, 0, st>>>(ws, out, total, splits);
  }
  return (int)cudaGetLastError();
}
