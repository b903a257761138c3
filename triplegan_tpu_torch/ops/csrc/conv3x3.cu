// 3x3 stride-1 convolution of NHWC float32 activations on Hopper's CUDA
// cores: the forward (also used for the input gradient) and the filter
// gradient, in full float32 (fmaf only: no TF32, no tensor cores).
//
// Replaces, for float32, the TPU kernels of triplegan_tpu/ops/pallas_conv.py:
//   fwd_kernel   <- _fwd_kernel    (launched by conv3x3_nopad)
//   wino_*       <- _fwd_kernel    (launched by conv3x3_nopad for the wide
//                                   convs: Winograd F(2x2, 3x3), below)
//   wgrad_kernel <- _wgrad_kernel  (launched by conv3x3_wgrad)
// bfloat16 calls go to conv3x3_sm90.cu. tconv2_kernel (launched by
// tconv3x3_s2: StyleGAN2's up-convs and the input gradients of its stride-2
// convs) replaces no TPU kernel: the JAX package leaves those convs to XLA.
//
// Semantics. x is (N, Hin, Win, Cin) row-major; it is read with a zero halo
// of `pad` pixels (0, 1 or 2) on every side, checked per copy, so that
// pad 0 on a pre-padded input is JAX's conv3x3_nopad and pad p on the raw
// input equals JAX's pad-then-VALID. Ho = Hin + 2*pad - 2, Wo likewise.
//   forward: y[n,h,w,co] = sum_{dy,dx,ci} xh[n,h+dy,w+dx,ci] * W[dy,dx,ci,co]
//     W is HWIO (3, 3, Cin, Cout) row-major, i.e. a (9*Cin, Cout) matrix
//     whose row k = (dy*3 + dx)*Cin + ci.
//   wgrad:   dW[dy,dx,ci,co] = sum_{n,h,w} xh[n,h+dy,w+dx,ci] * g[n,h,w,co]
//     g is (N, Ho, Wo, Cout); dW is (3, 3, Cin, Cout).
//
// Bound: operations (67 TFLOP/s float32 on an H100 SXM) at the training
// step's shapes, hundreds of flops per byte at Cin >= 42; bytes only for
// the Cin = 3 and 13 first layers. Measured (H100 SXM at 700 W,
// tools/conv_sm90_breakdown.py, C's (100,32,32,128)->128): the forward at
// 41.5 TFLOP/s and the wgrad at 42.9, both drawing about 600 W at the full
// 1980 MHz clock; with their copies removed 42.8 and 43.1; cuBLAS's
// full-float32 SGEMM of the same size 42.3, held to 1860 MHz by the 700 W
// limit. At (100,16,16,256)->256, whose last 136 tiles run stream-K, the
// forward reaches 39.0.
//
// Design: an implicit GEMM, M = N*Ho*Wo output pixels, N = Cout, K = 9*Cin
// (wgrad: rows K, columns Cout, the reduction over M). A block of 256
// threads computes a BM x BN tile, two blocks to an SM, so a thread has
// 128 registers; it keeps a TM x TN float32 accumulator (up to 8 x 8) in
// them and reads its operands from shared memory as float4s: for each k,
// its TM values of A and TN of B, then their outer product
// (tile_products), 4 vector reads for 64 FMAs at 8 x 8, each output's
// fmaf chain in ascending k.
// - Tiles of kBK = 16 along the reduction arrive through a ring of kStages
//   slots in dynamic shared memory, issued kStages-1 tiles ahead of the
//   products, with one __syncthreads per tile.
// - Copies are 16 bytes (four channels) where the channel count is a
//   multiple of 4 and the base 16-byte aligned, else 4 bytes per element;
//   a halo tap, a row past M or a column past K or Cout copies zeros
//   (src-size 0). No padded copy of any operand is made.
// - forward: A is the im2col tile, B W's [k][co] tile. Blocks are
//   128 x 128, 128 x 64, 256 x 32 or 256 x 16 by Cout. In all but 256 x 16
//   A is k-major ([k][m], rows padded by 4 floats), as the wgrad's tiles
//   are, so the forward runs the wgrad's product loop. Read m-major ([m][k],
//   four k of a row at once), A takes 32 registers of a thread beside its
//   64 accumulators, and at 128 x 128 ptxas spills (132 bytes stored, 328
//   loaded a thread) and the loop runs at 35 TFLOP/s. Four channels of a
//   pixel lie along k, so with 16-byte reads a thread stages them in
//   registers: it reads its pixels' float4s when the tile is issued and,
//   after the products of the tile before, writes them to the four k rows
//   as one 2- or 4-pixel vector each; 4-byte copies go to their element. The 256 x 16 block keeps A m-major: its 4 x 4 threads hold
//   few operands, and its short product loop does not hide staged reads.
//   Each block keeps the (pixel offset, h, w) of its rows in shared
//   memory, and each copying thread walks K tap-major, carrying (dy, dx,
//   ci) from tile to tile by additions: no division after the block's
//   first decode. Whole waves of output tiles run one block a tile; the
//   tiles left over, which would fill only part of a last wave, are shared
//   out stream-K: their K tiles are cut into equal runs, one block a run,
//   each writing a partial tile per output tile it touches, and a second
//   kernel sums each tile's partials in block order.
// - wgrad: A is [pixel][k], G is g's [pixel][co]; blocks are 128 rows of
//   K by 32, 64 or 128 of Cout, or 32 x 128 where K <= 32. The taps of the
//   block's K rows are decoded once, and each copying thread carries its
//   pixels' (n, h, w) from tile to tile by additions. The M reduction is
//   split over grid z into a float32 workspace (splits * K * Cout) and a
//   second kernel sums the partials in a fixed order.
// - Winograd (wino_*): with the product loop at the card's FMA rate (cuBLAS's
//   float32 SGEMM reaches 42.3 TFLOP/s at 700 W), only fewer operations are
//   faster. F(2x2, 3x3) does a wide conv's forward in 16 products of depth
//   Cin where the direct conv does 36 multiply-adds a 2x2 output: four
//   kernels (filter, input and output transforms through device memory,
//   and 16 independent products on the wgrad's loop). Measured on the
//   card (H100 SXM, 700 W) at the two training cells' calls: the
//   products at 41-44 TFLOP/s, each call 0.52-0.83 of the forward kernel's
//   time where Cin >= 64 and Cout >= 32; the caller takes the forward
//   kernel below those widths, where the transforms cost more than the
//   products save (ops/conv3x3.py f32_wino_plan).
// - tconv2 (below): the VALID stride-2 transposed 3x3 conv, bound by
//   operations too (9*C1*C2*2 flops a low-resolution pixel, 512 wide:
//   hundreds of flops a byte). Scattering each input pixel's nine taps
//   (col2im), or a GEMM over the zero-inserted input, does 4x the products
//   or adds in device memory; split by output parity into four phases, it
//   is four dense implicit GEMMs of K = 4, 2, 2 and 1 times C1 on the
//   forward kernel's product loop, whose only waste is the border rows of
//   the even phases (8.5% at 16x16 -> 33x33).
// All kernels are deterministic: the caller plans the splits from the
// shapes alone, and no float atomics are used, so two runs give the same
// bits. Offsets into x, g and y are 64-bit.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() (or the error of cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;       // reduction depth of a tile: K (forward) or pixels (wgrad)
constexpr int kStages = 4;    // ring slots
constexpr int kMinBlocks = 2; // blocks per SM that the register budget is cut for
constexpr int kFar = -(1 << 29);  // an h or w that fails every bounds check

// vec flags: which operands move in 16-byte pieces
constexpr int kVecX = 1;  // x: Cin % 4 == 0 and 16-byte aligned
constexpr int kVecB = 2;  // W (forward) or g (wgrad): Cout % 4 == 0 and aligned
constexpr int kVecY = 4;  // y (forward) or the workspace (wgrad): float4 stores

struct Shape {
  int n, hin, win, cin, cout, pad, ho, wo, k;
  long long m;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 or 4 bytes global -> shared; src-size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Moves (dy, dx, ci), a position in K = 9*Cin walked tap-major, `by` steps on.
__device__ __forceinline__ void k_advance(int& dy, int& dx, int& ci, int by, int cin) {
  ci += by;
  while (ci >= cin) {
    ci -= cin;
    if (++dx == 3) {
      dx = 0;
      ++dy;
    }
  }
}

// The T values a thread owns of a width-W tile row: float4s at 4*t and,
// for T = 8, at W/2 + 4*t (so that eight neighbouring threads read 128
// consecutive bytes). col_of gives the column of value j.
template <int W, int T>
__device__ __forceinline__ int col_of(int t, int j) {
  return j < 4 ? 4 * t + j : W / 2 + 4 * t + (j - 4);
}
template <int W, int T>
__device__ __forceinline__ void read_owned(const float* row, int t, float (&v)[T]) {
  static_assert(T == 4 || T == 8, "owned values come in float4s");
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(row + col_of<W, T>(t, 4 * q));
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
}

// Writes P = 2 or 4 values to dst as one vector (dst aligned to 4·P bytes).
template <int P>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[P]) {
  if constexpr (P == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(P == 2, "2 or 4 values");
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// Writes a thread's TN values of one output row (columns from col_of, from
// n0 on) where they lie inside Cout.
template <int BN, int TN>
__device__ __forceinline__ void store_row(float* row, const float (&v)[TN], int n0, int tx,
                                          int cout, bool vec) {
#pragma unroll
  for (int q = 0; q < TN / 4; ++q) {
    const int col = n0 + col_of<BN, TN>(tx, 4 * q);
    if (vec) {
      if (col < cout) {
        *reinterpret_cast<float4*>(row + col) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < cout) row[col + e] = v[4 * q + e];
      }
    }
  }
}

// acc[i][j] += A[k][col_of(ty, i)] * B[k][col_of(tx, j)] over a tile's kBK
// steps k, A's rows AS floats apart and B's BN: each step reads the
// thread's TM + TN operands as float4s and runs their outer product, so
// each output's fmaf chain runs in ascending k.
template <int BM, int BN, int TM, int TN, int AS>
__device__ __forceinline__ void tile_products(const float* sa, const float* sb, int ty, int tx,
                                              float (&acc)[TM][TN]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[TM], b[TN];
    read_owned<BM, TM>(sa + k * AS, ty, a);
    read_owned<BN, TN>(sb + k * BN, tx, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward: y = conv(xh, W)
// ---------------------------------------------------------------------------

// A forward stage holds A, the im2col tile, then B, W's [k][co] tile. A is
// k-major ([k][m], rows BM + 4 floats apart) where a thread owns TM = 8
// rows of the output tile, m-major ([m][k], rows kBK + 4 floats apart)
// where it owns 4: the 256 x 16 block.
template <int TM>
__host__ __device__ constexpr bool fwd_k_major() { return TM == 8; }

template <int BM, int TM>
__host__ __device__ constexpr int fwd_a_floats() {
  return fwd_k_major<TM>() ? kBK * (BM + 4) : BM * (kBK + 4);
}

template <int BM, int BN, int TM>
__host__ __device__ constexpr int fwd_stage_floats() { return fwd_a_floats<BM, TM>() + kBK * BN; }

// Output row (of BM) of a forward thread's accumulator row i: the rows of
// its float4 reads (k-major A), or rows BM / TM apart, so that the threads
// of a warp read neighbouring rows of A (m-major A: no two in one bank at
// the 16-wide tile).
template <int BM, int TM>
__device__ __forceinline__ int fwd_row(int ty, int i) {
  return fwd_k_major<TM>() ? col_of<BM, TM>(ty, i) : i * (BM / TM) + ty;
}

// acc[i][j] += A[fwd_row(ty, i)][k] * B[k][col_of(tx, j)] over the tile's
// kBK k, A m-major.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void m_major_products(const float* sa, const float* sb, int ty, int tx,
                                                 float (&acc)[TM][TN]) {
  constexpr int kAS = kBK + 4;
#pragma unroll
  for (int kq = 0; kq < kBK; kq += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(sa + fwd_row<BM, TM>(ty, i) * kAS + kq);
      a[i][0] = f.x; a[i][1] = f.y; a[i][2] = f.z; a[i][3] = f.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[TN];
      read_owned<BN, TN>(sb + (kq + e) * BN, tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][e], b[j], acc[i][j]);
    }
  }
}

// Shared memory of a forward block beside its ring: the x offset of tap
// (0, 0), channel 0, of each output row of the tile, and its h and w with
// the halo applied.
template <int BM>
struct FwdRows {
  long long base[BM];
  int h[BM], w[BM];
};

// One output tile (row-major over (M / BM, Cout / BN)) summed over K tiles
// kt0 .. kt1-1: into y if part is null, else the whole BM x BN partial
// tile into part.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void fwd_segment(const float* __restrict__ x, const float* __restrict__ w,
                                            float* __restrict__ y, float* __restrict__ part,
                                            const Shape& s, int vec, int tile, int kt0, int kt1,
                                            float* smem, FwdRows<BM>& rows) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  constexpr bool kKM = fwd_k_major<TM>();
  constexpr int kAS = kKM ? BM + 4 : kBK + 4;  // A's row stride (floats): a k, or a pixel
  constexpr int kAFloats = fwd_a_floats<BM, TM>();
  constexpr int kStage = fwd_stage_floats<BM, BN, TM>();
  constexpr int kAChunks = kBK / 4;            // chunks of four k (channels) of a pixel
  constexpr int kAPass = kThreads / kAChunks;
  constexpr int kAPix = BM / kAPass;           // pixels (rows of A) each thread copies
  constexpr int kBChunks = kBK * BN / 4;

  const int tid = threadIdx.x;
  const int ntn = (s.cout + BN - 1) / BN;
  const long long m0 = (long long)(tile / ntn) * BM;
  const int n0 = (tile % ntn) * BN;
  {
    const int hw = s.ho * s.wo;
    for (int r = tid; r < BM; r += kThreads) {
      const long long m = m0 + r;
      if (m < s.m) {
        const int nn = (int)(m / hw);
        const int rem = (int)(m - (long long)nn * hw);
        const int h = rem / s.wo;
        const int ww = rem - h * s.wo;
        rows.base[r] = (((long long)nn * s.hin + h - s.pad) * s.win + ww - s.pad) * s.cin;
        rows.h[r] = h - s.pad;
        rows.w[r] = ww - s.pad;
      } else {
        rows.base[r] = 0;
        rows.h[r] = rows.w[r] = kFar;
      }
    }
  }
  __syncthreads();

  // This thread copies chunk ac (k = 4*ac .. 4*ac+3 of each tile) of kAPix
  // rows, walking K from tile kt0 in steps of kBK: rows ar + kAPass*p, so
  // that a warp's copies cover neighbouring pixels; with 16-byte reads into
  // k-major A, rows ar*kAPix + p, which this thread writes as one vector a k.
  const int ac = tid % kAChunks, ar = tid / kAChunks;
  int dy, dx, ci;
  {
    const int k = kt0 * kBK + 4 * ac;
    const int tap = k / s.cin;
    ci = k - tap * s.cin;
    dy = tap / 3;
    dx = tap - 3 * dy;
  }
  const bool vx = vec & kVecX, vb = vec & kVecB;

  // k-major A with vx: a tile's chunks pass through registers, read as one
  // float4 a pixel when the tile is issued and written after the products
  // of the tile before it. Every other copy is a cp.async.
  float ra[kAPix][4];
  auto put = [&](int slot) {
    float* sa4 = smem + slot * kStage + 4 * ac * kAS + ar * kAPix;  // k row 4*ac, from row ar*kAPix
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[kAPix];
#pragma unroll
      for (int p = 0; p < kAPix; ++p) v[p] = ra[p][e];
      store_vec(sa4 + e * kAS, v);
    }
  };
  auto load = [&](int kt, int slot) {
    float* sa = smem + slot * kStage;
    float* sb = sa + kAFloats;
    if (vx) {
      const int koff = (dy * s.win + dx) * s.cin + ci;
#pragma unroll
      for (int p = 0; p < kAPix; ++p) {
        const int r = kKM ? ar * kAPix + p : ar + kAPass * p;
        const int hi = rows.h[r] + dy, wi = rows.w[r] + dx;
        const bool ok = dy < 3 && (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
        if constexpr (kKM) {
          const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(x + rows.base[r] + koff))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          ra[p][0] = f.x; ra[p][1] = f.y; ra[p][2] = f.z; ra[p][3] = f.w;
        } else {
          cp_async16(sa + r * kAS + 4 * ac, ok ? x + rows.base[r] + koff : x, ok);
        }
      }
    } else {
      int edy = dy, edx = dx, eci = ci;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int koff = (edy * s.win + edx) * s.cin + eci;
        const int k = 4 * ac + e;
#pragma unroll
        for (int p = 0; p < kAPix; ++p) {
          const int r = ar + kAPass * p;
          const int hi = rows.h[r] + edy, wi = rows.w[r] + edx;
          const bool ok = edy < 3 && (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
          cp_async4(sa + (kKM ? k * kAS + r : r * kAS + k), ok ? x + rows.base[r] + koff : x, ok);
        }
        k_advance(edy, edx, eci, 1, s.cin);
      }
    }
    k_advance(dy, dx, ci, kBK, s.cin);
    // B: W rows k0 .. k0+15, columns n0 .. n0+BN-1
    const int k0 = kt * kBK;
#pragma unroll
    for (int c = 0; c < (kBChunks + kThreads - 1) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      if (kBChunks % kThreads != 0 && idx >= kBChunks) break;
      const int kr = idx / (BN / 4), cc = idx % (BN / 4);
      const int k = k0 + kr, col = n0 + 4 * cc;
      const float* src = w + (long long)k * s.cout + col;
      if (vb) {
        const bool ok = k < s.k && col < s.cout;
        cp_async16(sb + kr * BN + 4 * cc, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < s.k && col + e < s.cout;
          cp_async4(sb + kr * BN + 4 * cc + e, ok ? src + e : w, ok);
        }
      }
    }
  };
  const bool staged = kKM && vx;

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring: K tile kt0 + t sits in slot t % kStages, issued kStages-1
  // tiles ahead.
  const int nt = kt1 - kt0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) {
      load(kt0 + t, t);
      if (staged) put(t);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's, and their stores; the products of tile t-1 are done
    const int nk = t + kStages - 1;
    if (nk < nt) load(kt0 + nk, nk % kStages);  // refills the slot of tile t-1
    cp_async_commit();
    const float* sa = smem + (t % kStages) * kStage;
    if constexpr (kKM) {
      tile_products<BM, BN, TM, TN, kAS>(sa, sa + kAFloats, ty, tx, acc);
    } else {
      m_major_products<BM, BN, TM, TN>(sa, sa + kAFloats, ty, tx, acc);
    }
    if (staged && nk < nt) put(nk % kStages);
  }

  if (part == nullptr) {
    const bool vy = vec & kVecY;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + fwd_row<BM, TM>(ty, i);
      if (m < s.m) store_row<BN, TN>(y + m * s.cout, acc[i], n0, tx, s.cout, vy);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      store_row<BN, TN>(part + fwd_row<BM, TM>(ty, i) * BN, acc[i], 0, tx, BN, true);
    }
  }
}

// Partial tiles a stream-K block may write: its `per` K tiles of 16 touch
// at most this many output tiles of ktiles each.
__host__ __device__ inline int sk_segments(int per, int ktiles) { return (per + ktiles - 1) / ktiles + 1; }

// Blocks below `full` compute whole output tiles, one each. The tiles
// after them, which would fill only part of a last wave, are shared out
// stream-K: their K tiles, taken tile by tile, are cut into runs of `per`
// and block full + b computes run b, one partial tile for each output
// tile the run touches, at ws[(b * segments + j) * BM * BN] for its j-th.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fwd_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
           float* __restrict__ ws, Shape s, int vec, int full, int per) {
  extern __shared__ __align__(16) float smem[];
  __shared__ FwdRows<BM> rows;
  const int ktiles = (s.k + kBK - 1) / kBK;
  if ((int)blockIdx.x < full) {
    fwd_segment<BM, BN, TM, TN>(x, w, y, nullptr, s, vec, blockIdx.x, 0, ktiles, smem, rows);
    return;
  }
  const int ntn = (s.cout + BN - 1) / BN;
  const long long tiles = (s.m + BM - 1) / BM * ntn;
  const long long total = (tiles - full) * ktiles;
  const int b = blockIdx.x - full;
  const int segments = sk_segments(per, ktiles);
  long long it = (long long)b * per;
  const long long end = min(total, it + per);
  for (int j = 0; it < end; ++j) {
    const int t = (int)(it / ktiles);
    const int k0 = (int)(it - (long long)t * ktiles);
    const int k1 = (int)min((long long)ktiles, k0 + (end - it));
    fwd_segment<BM, BN, TM, TN>(x, w, y, ws + ((long long)b * segments + j) * BM * BN, s, vec,
                                full + t, k0, k1, smem, rows);
    it += k1 - k0;
    __syncthreads();  // before the next segment reuses shared memory
  }
}

// y's tiles after `full`: each the sum, in block order, of the partial
// tiles that the stream-K blocks whose runs touch it wrote.
__global__ void reduce_stream_k(const float* __restrict__ ws, float* __restrict__ y, Shape s,
                                int bm, int bn, int full, int per) {
  const int ntn = (s.cout + bn - 1) / bn;
  const int ktiles = (s.k + kBK - 1) / kBK;
  const int segments = sk_segments(per, ktiles);
  const long long tsize = (long long)bm * bn;
  const long long n = tsize * ((s.m + bm - 1) / bm * ntn - full);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int t = (int)(i / tsize);
    const int rc = (int)(i - (long long)t * tsize);
    const int tile = full + t;
    const long long m = (long long)(tile / ntn) * bm + rc / bn;
    const int col = (tile % ntn) * bn + rc % bn;
    if (m >= s.m || col >= s.cout) continue;
    const long long it0 = (long long)t * ktiles, it1 = it0 + ktiles;
    float sum = 0.f;
    for (long long b = it0 / per; b * per < it1; ++b) {
      const int j = t - (int)(b * per / ktiles);
      sum += ws[(b * segments + j) * tsize + rc];
    }
    y[m * s.cout + col] = sum;
  }
}

// ---------------------------------------------------------------------------
// wgrad: partial dW over the pixel range of this block's split
// ---------------------------------------------------------------------------

template <int BM, int BN>
__host__ __device__ constexpr int wgrad_stage_floats() { return kBK * (BM + BN); }

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ ws,
             Shape s, long long chunk, int vec) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  constexpr int kStage = wgrad_stage_floats<BM, BN>();
  constexpr int kAChunks = BM / 4;             // 16-byte chunks of an A row (one pixel)
  constexpr int kAPass = kThreads / kAChunks;  // pixels copied per pass (kBK at most)
  constexpr int kAPix = kAPass <= kBK ? kBK / kAPass : 1;  // pixels each thread copies
  constexpr int kGChunks = kBK * BN / 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ int sKdy[BM], sKdx[BM], sKoff[BM];  // tap of each K row, halo applied

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
      sKdy[r] = sKdx[r] = kFar;
      sKoff[r] = 0;
    }
  }
  __syncthreads();

  // This thread copies chunk ac (rows 4*ac .. 4*ac+3 of the block's K) of
  // pixels ap + kAPass*i of each tile (none if ap >= kBK); their (n, h, w)
  // advance by kBK pixels a tile.
  const int ac = tid % kAChunks, ap = tid / kAChunks;
  const bool copies_a = kAPass <= kBK || ap < kBK;
  const int dyp = sKdy[4 * ac], dxp = sKdx[4 * ac], koff = sKoff[4 * ac];
  int pn[kAPix], ph[kAPix], pw[kAPix];
  const int q = kBK / s.wo;
  const int step_w = kBK - q * s.wo, step_h = q % s.ho, step_n = q / s.ho;
  {
    const int hw = s.ho * s.wo;
#pragma unroll
    for (int i = 0; i < kAPix; ++i) {
      const long long m = mbeg + ap + kAPass * i;
      pn[i] = (int)(m / hw);
      const int rem = (int)(m - (long long)pn[i] * hw);
      ph[i] = rem / s.wo;
      pw[i] = rem - ph[i] * s.wo;
    }
  }
  const bool vx = vec & kVecX, vg = vec & kVecB;

  auto load = [&](long long mt, int slot) {
    float* sa = smem + slot * kStage;
    float* sg = sa + kBK * BM;
#pragma unroll
    for (int i = 0; i < kAPix && copies_a; ++i) {
      const int p = ap + kAPass * i;
      const bool mok = mt + p < mend;
      const long long base = (((long long)pn[i] * s.hin + ph[i]) * s.win + pw[i]) * s.cin;
      if (vx) {
        const int hi = ph[i] + dyp, wi = pw[i] + dxp;
        const bool ok = mok && (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
        cp_async16(sa + p * BM + 4 * ac, ok ? x + base + koff : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * ac + e;
          const int hi = ph[i] + sKdy[r], wi = pw[i] + sKdx[r];
          const bool ok = mok && (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
          cp_async4(sa + p * BM + r, ok ? x + base + sKoff[r] : x, ok);
        }
      }
      pw[i] += step_w;
      const int cw = pw[i] >= s.wo;
      pw[i] -= cw ? s.wo : 0;
      ph[i] += step_h + cw;
      const int ch = ph[i] >= s.ho;
      ph[i] -= ch ? s.ho : 0;
      pn[i] += step_n + ch;
    }
    // G: pixels mt .. mt+15, columns n0 .. n0+BN-1
#pragma unroll
    for (int c = 0; c < (kGChunks + kThreads - 1) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      if (kGChunks % kThreads != 0 && idx >= kGChunks) break;
      const int p = idx / (BN / 4), cc = idx % (BN / 4);
      const long long mm = mt + p;
      const int col = n0 + 4 * cc;
      const float* src = g + mm * s.cout + col;
      if (vg) {
        const bool ok = mm < mend && col < s.cout;
        cp_async16(sg + p * BN + 4 * cc, ok ? src : g, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = mm < mend && col + e < s.cout;
          cp_async4(sg + p * BN + 4 * cc + e, ok ? src + e : g, ok);
        }
      }
    }
  };

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring as in fwd_segment.
  const int tiles = mend > mbeg ? (int)((mend - mbeg + kBK - 1) / kBK) : 0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load(mbeg + (long long)t * kBK, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < tiles) load(mbeg + (long long)nt * kBK, nt % kStages);
    cp_async_commit();
    const float* sa = smem + (t % kStages) * kStage;
    tile_products<BM, BN, TM, TN, BM>(sa, sa + kBK * BM, ty, tx, acc);
  }

  float* out = ws + (long long)blockIdx.z * s.k * s.cout;
  const bool vo = vec & kVecY;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + col_of<BM, TM>(ty, i);
    if (k < s.k) store_row<BN, TN>(out + (long long)k * s.cout, acc[i], n0, tx, s.cout, vo);
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

// ---------------------------------------------------------------------------
// Winograd F(2x2, 3x3): the forward kernel's role (forward and input
// gradient) for the wide convs, as four kernels
// ---------------------------------------------------------------------------
//
// Output tile (ty, tx) of image n, its 2x2 outputs at rows 2ty, 2ty+1 and
// columns 2tx, 2tx+1, reads the 4x4 patch of xh from (2ty, 2tx); tiles are
// T = N * th * tw, th = ceil(Ho / 2), tw = ceil(Wo / 2), t = (n*th + ty)*tw +
// tx. With U = G w G^T and V = B^T d B for a filter w and a patch d,
// y = A^T (U . V) A over Cin, so the conv becomes 16 independent products
// M[p] = V[p] (T x Cin) . U[p] (Cin x Cout), one per position p = 4i + j of
// the 4x4 Winograd domain: 16 * Cin multiply-adds per 2x2 outputs and
// output channel where the direct conv does 36 * Cin. The transforms'
// constants are 0, +-1 and +-1/2, so every value is a float32 sum or
// difference of float32 values (U is summed in float64 and rounded once).
// Workspaces, float32, 16-byte aligned (cp = Cout and tp = T rounded up to
// multiples of 4, so that every row starts on 16 bytes):
//   U (16, Cin, cp): wino_filter, zeros in columns Cout .. cp-1;
//   V (16, Cin, tp): wino_input, k-major (the products' reduction runs
//     along rows), zeros in columns T .. tp-1;
//   M (16, T, cp): wino_gemm, rows of output tiles.
// wino_gemm is the filter gradient's product loop over two k-major tiles
// fed by 16-byte cp.async copies (tile_products), blockIdx.y the position;
// wino_output applies A^T . A and writes y, masking the second row or
// column of a tile that lies past an odd Ho or Wo. Every sum runs in a fixed
// order and no atomics are used, so two runs give the same bits.

struct WinoShape {
  int hin, win, cin, cout, pad, ho, wo, th, tw, cp;
  long long t, tp;
};

// U[p][ci][co] = (G w[.,.,ci,co] G^T)[p / 4][p % 4], G = [[1,0,0], [1/2,1/2,1/2],
// [1/2,-1/2,1/2], [0,0,1]]: summed in float64, rounded once.
__global__ void wino_filter(const float* __restrict__ w, float* __restrict__ u, WinoShape s) {
  const long long total = (long long)s.cin * s.cp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int ci = (int)(i / s.cp), co = (int)(i - (long long)ci * s.cp);
    double g[3][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        g[dy][dx] = co < s.cout ? (double)w[((long long)(dy * 3 + dx) * s.cin + ci) * s.cout + co] : 0.0;
    double gt[4][3];  // G g
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gt[0][c] = g[0][c];
      gt[1][c] = 0.5 * (g[0][c] + g[1][c] + g[2][c]);
      gt[2][c] = 0.5 * (g[0][c] - g[1][c] + g[2][c]);
      gt[3][c] = g[2][c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // (G g) G^T
      const double row[4] = {gt[r][0], 0.5 * (gt[r][0] + gt[r][1] + gt[r][2]),
                             0.5 * (gt[r][0] - gt[r][1] + gt[r][2]), gt[r][2]};
#pragma unroll
      for (int c = 0; c < 4; ++c) u[((long long)(4 * r + c) * s.cin + ci) * s.cp + co] = (float)row[c];
    }
  }
}

// V[p][c][t] = (B^T d B)[p / 4][p % 4] for the 4x4 patch d of channel c of
// tile t, B^T = [[1,0,-1,0], [0,1,1,0], [0,-1,1,0], [0,1,0,-1]]; zeros for
// t >= T. A thread takes VW channels of one tile (VW = 4: float4 reads,
// Cin % 4 == 0 and x 16-byte aligned). A block of 256 takes 32 tiles
// (blockIdx.x, a lane each, so that each store of a warp writes 32
// consecutive t) by 8 groups of VW channels (blockIdx.y, a warp each, so
// that the block's reads of a pixel fill whole 32-byte sectors, which the
// warps share through L1 with the overlapping patches of their tiles).
template <int VW>
__global__ void __launch_bounds__(256) wino_input(const float* __restrict__ x, float* __restrict__ v, WinoShape s) {
  const long long t = (long long)blockIdx.x * 32 + threadIdx.x % 32;
  const int c = (blockIdx.y * 8 + threadIdx.x / 32) * VW;
  if (t < s.tp && c < s.cin) {
    float d[4][4][VW];
    if (t < s.t) {
      const int per_n = s.th * s.tw;
      const int nn = (int)(t / per_n);
      const int rem = (int)(t - (long long)nn * per_n);
      const int ty = rem / s.tw;
      const int h0 = 2 * ty - s.pad, w0 = 2 * (rem - ty * s.tw) - s.pad;
      const float* base = x + (long long)nn * s.hin * s.win * s.cin + c;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const bool ok = (unsigned)(h0 + a) < (unsigned)s.hin && (unsigned)(w0 + b) < (unsigned)s.win;
          const float* src = base + ((long long)(h0 + a) * s.win + (w0 + b)) * s.cin;
          if constexpr (VW == 4) {
            const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.f, 0.f, 0.f, 0.f);
            d[a][b][0] = f.x; d[a][b][1] = f.y; d[a][b][2] = f.z; d[a][b][3] = f.w;
          } else {
            d[a][b][0] = ok ? __ldg(src) : 0.f;
          }
        }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < VW; ++e) d[a][b][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      float bd[4][4];  // B^T d
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bd[0][b] = d[0][b][e] - d[2][b][e];
        bd[1][b] = d[1][b][e] + d[2][b][e];
        bd[2][b] = d[2][b][e] - d[1][b][e];
        bd[3][b] = d[1][b][e] - d[3][b][e];
      }
      float* out = v + (long long)(c + e) * s.tp + t;
      const long long pstride = (long long)s.cin * s.tp;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (B^T d) B
        out[(4 * r + 0) * pstride] = bd[r][0] - bd[r][2];
        out[(4 * r + 1) * pstride] = bd[r][1] + bd[r][2];
        out[(4 * r + 2) * pstride] = bd[r][2] - bd[r][1];
        out[(4 * r + 3) * pstride] = bd[r][1] - bd[r][3];
      }
    }
  }
}

template <int BM, int BN>
__host__ __device__ constexpr int wino_stage_floats() { return kBK * (BM + BN); }

// M[p] rows m0 .. m0+BM-1, columns n0 .. n0+BN-1, of V[p]^T (T x Cin) . U[p]
// (Cin x cp), p = blockIdx.y: both operands' k-major tiles of kBK rows
// arrive through the ring by 16-byte copies (zeros past Cin and past tp),
// and every output's fmaf chain runs in ascending k.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wino_gemm(const float* __restrict__ v, const float* __restrict__ u, float* __restrict__ m, WinoShape s) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  constexpr int kStage = wino_stage_floats<BM, BN>();
  constexpr int kAChunks = kBK * BM / 4, kBChunks = kBK * BN / 4;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int ntn = (s.cp + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / ntn) * BM;
  const int n0 = (blockIdx.x % ntn) * BN;
  const float* vp = v + (long long)p * s.cin * s.tp;
  const float* up = u + (long long)p * s.cin * s.cp;

  auto load = [&](int kt, int slot) {
    float* sa = smem + slot * kStage;
    float* sb = sa + kBK * BM;
    const int k0 = kt * kBK;
#pragma unroll
    for (int c = 0; c < (kAChunks + kThreads - 1) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      if (kAChunks % kThreads != 0 && idx >= kAChunks) break;
      const int kr = idx / (BM / 4), cc = idx % (BM / 4);
      const int k = k0 + kr;
      const long long col = m0 + 4 * cc;
      const bool ok = k < s.cin && col < s.tp;
      cp_async16(sa + kr * BM + 4 * cc, ok ? vp + (long long)k * s.tp + col : v, ok);
    }
#pragma unroll
    for (int c = 0; c < (kBChunks + kThreads - 1) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      if (kBChunks % kThreads != 0 && idx >= kBChunks) break;
      const int kr = idx / (BN / 4), cc = idx % (BN / 4);
      const int k = k0 + kr, col = n0 + 4 * cc;
      const bool ok = k < s.cin && col < s.cp;
      cp_async16(sb + kr * BN + 4 * cc, ok ? up + (long long)k * s.cp + col : u, ok);
    }
  };

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring as in fwd_segment.
  const int tiles = (s.cin + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < tiles) load(nt, nt % kStages);
    cp_async_commit();
    const float* sa = smem + (t % kStages) * kStage;
    tile_products<BM, BN, TM, TN, BM>(sa, sa + kBK * BM, ty, tx, acc);
  }

  float* mp = m + (long long)p * s.t * s.cp;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = m0 + col_of<BM, TM>(ty, i);
    if (row < s.t) store_row<BN, TN>(mp + row * s.cp, acc[i], n0, tx, s.cp, true);
  }
}

// y's 2x2 outputs of tile t, channels c .. c+3: A^T M A, A^T = [[1,1,1,0],
// [0,1,-1,-1]], from M[p][t][c .. c+3] (float4 reads; channels fastest
// across threads). Outputs past Ho, Wo or Cout are not written; VY: float4
// stores (Cout % 4 == 0 and y 16-byte aligned).
template <bool VY>
__global__ void wino_output(const float* __restrict__ m, float* __restrict__ y, WinoShape s) {
  const int cq = s.cp / 4;
  const long long total = s.t * cq;
  const long long pstride = s.t * s.cp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / cq;
    const int c = (int)(i - t * cq) * 4;
    float mv[4][4][4];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float4 f = *reinterpret_cast<const float4*>(m + p * pstride + t * s.cp + c);
      mv[p / 4][p % 4][0] = f.x; mv[p / 4][p % 4][1] = f.y; mv[p / 4][p % 4][2] = f.z; mv[p / 4][p % 4][3] = f.w;
    }
    const int per_n = s.th * s.tw;
    const int nn = (int)(t / per_n);
    const int rem = (int)(t - (long long)nn * per_n);
    const int ty = rem / s.tw, tx = rem - ty * s.tw;
    float out[2][2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float am[2][4];  // A^T M
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        am[0][j] = mv[0][j][e] + mv[1][j][e] + mv[2][j][e];
        am[1][j] = mv[1][j][e] - mv[2][j][e] - mv[3][j][e];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {  // (A^T M) A
        out[a][0][e] = am[a][0] + am[a][1] + am[a][2];
        out[a][1][e] = am[a][1] - am[a][2] - am[a][3];
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int h = 2 * ty + a;
      if (h >= s.ho) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int w = 2 * tx + b;
        if (w >= s.wo) continue;
        float* dst = y + (((long long)nn * s.ho + h) * s.wo + w) * s.cout + c;
        if constexpr (VY) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[a][b][0], out[a][b][1], out[a][b][2], out[a][b][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < s.cout) dst[e] = out[a][b][e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tconv2: the VALID stride-2 transposed 3x3 conv, as four phase GEMMs
// ---------------------------------------------------------------------------
//
// y (N, 2h+1, 2w+1, C2) from x (N, h, w, C1) and W (3, 3, C1, C2), HWIO:
//   y[n, 2i+a, 2j+b, c2] += x[n, i, j, c1] * W[a, b, c1, c2]
// An output row 2p + py takes the kernel rows a = py (mod 2): for py = 0
// (p in 0..h) a = 0 from input row p and a = 2 from row p - 1; for py = 1
// (p in 0..h-1) a = 1 from row p. Columns likewise. So the output splits
// into four phase grids (py, px), each an implicit GEMM with no product on
// a zero tap, M = N x (the grid), N = C2, K = (its taps) x C1:
//   phase 0 (0,0): (h+1) x (w+1), taps {0,2} x {0,2}, K = 4*C1
//   phase 1 (0,1): (h+1) x w,     taps {0,2} x {1},   K = 2*C1
//   phase 2 (1,0): h x (w+1),     taps {1} x {0,2},   K = 2*C1
//   phase 3 (1,1): h x w,         tap (1,1),          K = C1
// An input pixel outside [0,h) x [0,w) (a border of phases 0-2) reads zero.
// The four phases are one launch, their blocks in phase order, so the
// blocks with the longest K start first. A block computes one BM x BN
// output tile of its phase over the whole K, on the forward kernel's
// product loop (A k-major, staged through registers, tile_products), and
// stores it straight to its phase's rows of y: every output element is
// written once, by one block, its fmaf chain in ascending k (tap-major),
// with no atomics and no workspace, so two runs give the same bits.
// C1 % 16 == 0, so each K tile of 16 lies within one tap; C2 % 4 == 0 and
// x, W, y 16-byte aligned (the caller checks).

struct TconvShape {
  int n, h, w, c1, c2, ho, wo;
  int ntn;       // column tiles: ceil(C2 / BN)
  int first[5];  // the first block of each phase; first[4] = all blocks
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tconv2_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y, TconvShape s) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one accumulator tile per thread");
  static_assert(TM == 8, "A k-major, as the forward kernel's 8-row threads read it");
  constexpr int kAS = BM + 4;
  constexpr int kAFloats = kBK * kAS;
  constexpr int kStage = kAFloats + kBK * BN;
  constexpr int kAChunks = kBK / 4;            // chunks of four channels of a pixel
  constexpr int kAPass = kThreads / kAChunks;
  constexpr int kAPix = BM / kAPass;           // pixels (rows of A) each thread copies
  constexpr int kBChunks = kBK * BN / 4;
  extern __shared__ __align__(16) float smem[];
  // each row of the tile: x's offset of its pixel (p, q), p and q, and y's
  // offset of its output (-1 past the phase's rows)
  __shared__ long long sBase[BM], sOut[BM];
  __shared__ int sP[BM], sQ[BM];

  const int tid = threadIdx.x;
  int ph = 0;
  while (ph < 3 && (int)blockIdx.x >= s.first[ph + 1]) ++ph;
  const int py = ph >> 1, px = ph & 1;
  const int hp = s.h + 1 - py, wp = s.w + 1 - px;
  const int ntx = 2 - px;  // taps along w
  const long long mph = (long long)s.n * hp * wp;
  const int tile = blockIdx.x - s.first[ph];
  const long long m0 = (long long)(tile / s.ntn) * BM;
  const int n0 = (tile % s.ntn) * BN;
  for (int r = tid; r < BM; r += kThreads) {
    const long long m = m0 + r;
    if (m < mph) {
      const int nn = (int)(m / (hp * wp));
      const int rem = (int)(m - (long long)nn * hp * wp);
      const int p = rem / wp, q = rem - p * wp;
      sBase[r] = (((long long)nn * s.h + p) * s.w + q) * s.c1;
      sOut[r] = (((long long)nn * s.ho + 2 * p + py) * s.wo + 2 * q + px) * s.c2;
      sP[r] = p;
      sQ[r] = q;
    } else {
      sBase[r] = 0;
      sOut[r] = -1;
      sP[r] = sQ[r] = kFar;
    }
  }
  __syncthreads();

  // This thread copies chunk ac (k = 4*ac .. 4*ac+3 of each tile) of rows
  // ar*kAPix .. ar*kAPix + kAPix-1, through registers, as fwd_segment's
  // staged copies do. The K walk, one tile a load: channels ci0 ..
  // ci0+15 of tap `tap` (row-major over the phase's taps).
  const int ac = tid % kAChunks, ar = tid / kAChunks;
  int tap = 0, ci0 = 0;
  float ra[kAPix][4];
  auto put = [&](int slot) {
    float* sa4 = smem + slot * kStage + 4 * ac * kAS + ar * kAPix;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[kAPix];
#pragma unroll
      for (int p = 0; p < kAPix; ++p) v[p] = ra[p][e];
      store_vec(sa4 + e * kAS, v);
    }
  };
  auto load = [&](int slot) {
    float* sb = smem + slot * kStage + kAFloats;
    const int ti = tap / ntx, tj = tap - ti * ntx;
    const int di = py ? 0 : -ti, dj = px ? 0 : -tj;    // input row p + di, column q + dj
    const int a = py ? 1 : 2 * ti, b = px ? 1 : 2 * tj;  // the kernel's tap
    const long long koff = (long long)(di * s.w + dj) * s.c1 + ci0 + 4 * ac;
#pragma unroll
    for (int p = 0; p < kAPix; ++p) {
      const int r = ar * kAPix + p;
      const int hi = sP[r] + di, wi = sQ[r] + dj;
      const bool ok = (unsigned)hi < (unsigned)s.h && (unsigned)wi < (unsigned)s.w;
      const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(x + sBase[r] + koff))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[p][0] = f.x; ra[p][1] = f.y; ra[p][2] = f.z; ra[p][3] = f.w;
    }
    // B: W's rows (a, b, ci0 .. ci0+15), columns n0 .. n0+BN-1
    const float* wrow = w + ((long long)(a * 3 + b) * s.c1 + ci0) * s.c2;
#pragma unroll
    for (int c = 0; c < (kBChunks + kThreads - 1) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      if (kBChunks % kThreads != 0 && idx >= kBChunks) break;
      const int kr = idx / (BN / 4), cc = idx % (BN / 4);
      const int col = n0 + 4 * cc;
      const bool ok = col < s.c2;
      cp_async16(sb + kr * BN + 4 * cc, ok ? wrow + (long long)kr * s.c2 + col : w, ok);
    }
    ci0 += kBK;
    if (ci0 == s.c1) {
      ci0 = 0;
      ++tap;
    }
  };

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The ring as in fwd_segment: K tile t sits in slot t % kStages.
  const int nt = (4 >> (py + px)) * (s.c1 / kBK);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) {
      load(t);
      put(t);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = t + kStages - 1;
    if (nk < nt) load(nk % kStages);
    cp_async_commit();
    const float* sa = smem + (t % kStages) * kStage;
    tile_products<BM, BN, TM, TN, kAS>(sa, sa + kAFloats, ty, tx, acc);
    if (nk < nt) put(nk % kStages);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long off = sOut[col_of<BM, TM>(ty, i)];
    if (off >= 0) store_row<BN, TN>(y + off, acc[i], n0, tx, s.c2, true);
  }
}

template <int BM, int BN, int TM, int TN>
int launch_tconv(const float* x, const float* w, float* y, const TconvShape& s, cudaStream_t st) {
  constexpr int smem = kStages * (kBK * (BM + 4) + kBK * BN) * (int)sizeof(float);
  const auto kernel = tconv2_kernel<BM, BN, TM, TN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)s.first[4], kThreads, smem, st>>>(x, w, y, s);
  return (int)cudaGetLastError();
}

// Blocks for an elementwise pass over `total` items: 256 threads, at most
// 16 waves of the card's 132 SMs (the kernels stride over the rest).
unsigned elementwise_blocks(long long total) {
  long long blocks = (total + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

template <int BM, int BN, int TM, int TN>
int launch_wino_gemm(const float* v, const float* u, float* m, const WinoShape& s, cudaStream_t st) {
  constexpr int smem = kStages * wino_stage_floats<BM, BN>() * (int)sizeof(float);
  const auto kernel = wino_gemm<BM, BN, TM, TN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (s.t + BM - 1) / BM * ((s.cp + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, 16), kThreads, smem, st>>>(v, u, m, s);
  return (int)cudaGetLastError();
}

bool make_shape(int n, int hin, int win, int cin, int cout, int pad, Shape* s) {
  if (n <= 0 || hin <= 0 || win <= 0 || cin <= 0 || cout <= 0 || pad < 0 || pad > 2) return false;
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BM, int BN, int TM, int TN>
int launch_fwd(const float* x, const float* w, float* y, float* ws, const Shape& s, int vec,
               int full, int per, cudaStream_t st) {
  constexpr int smem = kStages * fwd_stage_floats<BM, BN, TM>() * (int)sizeof(float);
  const long long tiles = (s.m + BM - 1) / BM * ((s.cout + BN - 1) / BN);
  const long long ktiles = (s.k + kBK - 1) / kBK;
  const long long sk = full < tiles && per > 0 ? ((tiles - full) * ktiles + per - 1) / per : 0;
  if (full < 0 || full > tiles || (full == tiles) != (per == 0) || per < 0 ||
      full + sk > 0x7fffffffLL || (sk > 0 && (ws == nullptr || !aligned16(ws)))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = fwd_kernel<BM, BN, TM, TN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(full + sk), kThreads, smem, st>>>(x, w, y, ws, s, vec, full, per);
  if (sk == 0) return (int)cudaGetLastError();
  const long long total = (tiles - full) * BM * BN;
  long long rblocks = (total + 255) / 256;
  if (rblocks > 132 * 8) rblocks = 132 * 8;
  reduce_stream_k<<<(unsigned)rblocks, 256, 0, st>>>(ws, y, s, BM, BN, full, per);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TM, int TN>
int launch_wgrad(const float* x, const float* g, float* ws, const Shape& s, int splits,
                 long long chunk, int vec, cudaStream_t st) {
  constexpr int smem = kStages * wgrad_stage_floats<BM, BN>() * (int)sizeof(float);
  const auto kernel = wgrad_kernel<BM, BN, TM, TN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((s.k + BM - 1) / BM), (unsigned)((s.cout + BN - 1) / BN), (unsigned)splits);
  kernel<<<grid, kThreads, smem, st>>>(x, g, ws, s, chunk, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward blocks by bn, the block's width in columns of Cout (the caller
// picks it from Cout): 16 -> 256 x 16 rows/columns, 4 x 4 per thread, A
// m-major; 32 -> 256 x 32, 8 x 4; 64 -> 128 x 64, 8 x 4; 128 -> 128 x 128,
// 8 x 8, A k-major. Rings of 49 to 84 KB, two blocks to an SM.

// x: (n, hin, win, cin); w: (3, 3, cin, cout); y: (n, ho, wo, cout); all
// float32. The first `full` output tiles (row-major over (M / BM, Cout /
// bn)) are computed whole, one block each; the K tiles (of 16) of the
// later ones are cut into runs of `per`, one block each, whose partial
// tiles go to ws (blocks x sk_segments(per, K tiles) x BM x bn floats,
// 16-byte aligned) and are summed into y in a fixed order. per == 0
// exactly when full is every tile; ws is then unused. Returns a
// cudaError_t as int: 0 on a good launch, cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int conv3x3_fwd_launch(const float* x, const float* w, float* y, float* ws, int n,
                                  int hin, int win, int cin, int cout, int pad, int bn, int full,
                                  int per, void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s) || (s.m + 127) / 128 > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = (cin % 4 == 0 && aligned16(x) ? kVecX : 0) |
                  (cout % 4 == 0 && aligned16(w) ? kVecB : 0) |
                  (cout % 4 == 0 && aligned16(y) ? kVecY : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch_fwd<256, 16, 4, 4>(x, w, y, ws, s, vec, full, per, st);
    case 32: return launch_fwd<256, 32, 8, 4>(x, w, y, ws, s, vec, full, per, st);
    case 64: return launch_fwd<128, 64, 8, 4>(x, w, y, ws, s, vec, full, per, st);
    case 128: return launch_fwd<128, 128, 8, 8>(x, w, y, ws, s, vec, full, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: (n, hin, win, cin); g: (n, ho, wo, cout); out: the (3, 3, cin, cout)
// filter gradient; all float32. Blocks of bm rows of K by bn columns of
// Cout: 128 x 32 (4 x 4 per thread), 128 x 64 (8 x 4), 128 x 128 (8 x 8),
// or 32 x 128 (4 x 4, for K = 9*cin <= 32). The M =
// n*ho*wo reduction is split into `splits` ranges of `chunk` pixels (chunk
// a multiple of 16, splits * chunk >= M > (splits - 1) * chunk); ws holds
// splits * 9*cin*cout floats, or is out itself when splits == 1.
extern "C" int conv3x3_wgrad_launch(const float* x, const float* g, float* ws, float* out,
                                    int n, int hin, int win, int cin, int cout, int pad, int bm,
                                    int bn, int splits, long long chunk, void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s)) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || chunk <= 0 || chunk % kBK != 0 ||
      (long long)splits * chunk < s.m || (long long)(splits - 1) * chunk >= s.m ||
      (splits == 1 && ws != out) || (splits > 1 && ws == out)) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = (cin % 4 == 0 && aligned16(x) ? kVecX : 0) |
                  (cout % 4 == 0 && aligned16(g) ? kVecB : 0) |
                  (cout % 4 == 0 && aligned16(ws) ? kVecY : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (bm * 1000 + bn) {
    case 128032: rc = launch_wgrad<128, 32, 4, 4>(x, g, ws, s, splits, chunk, vec, st); break;
    case 128064: rc = launch_wgrad<128, 64, 8, 4>(x, g, ws, s, splits, chunk, vec, st); break;
    case 128128: rc = launch_wgrad<128, 128, 8, 8>(x, g, ws, s, splits, chunk, vec, st); break;
    case 32128: rc = launch_wgrad<32, 128, 4, 4>(x, g, ws, s, splits, chunk, vec, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  const long long total = (long long)s.k * s.cout;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_splits<<<(unsigned)blocks, 256, 0, st>>>(ws, out, total, splits);
  return (int)cudaGetLastError();
}

// Winograd F(2x2, 3x3) in the forward kernel's role: y = conv(xh, w) as
// above, through wino_filter, wino_input, wino_gemm and wino_output. ws
// holds U, V and M one after the other: 16 * (cin * cp + cin * tp + T * cp)
// floats, 16-byte aligned, cp = cout and tp = T = n * ceil(ho / 2) *
// ceil(wo / 2) rounded up to multiples of 4. bn, the product blocks' width
// in columns of cp: 64 (128 x 64, 8 x 4 a thread) or 128 (128 x 128, 8 x 8).
// Returns a cudaError_t as int, as conv3x3_fwd_launch does.
extern "C" int conv3x3_wino_launch(const float* x, const float* w, float* ws, float* y, int n, int hin,
                                   int win, int cin, int cout, int pad, int bn, void* stream) {
  Shape sh;
  if (!make_shape(n, hin, win, cin, cout, pad, &sh) || !aligned16(ws) || (bn != 64 && bn != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  WinoShape s;
  s.hin = hin; s.win = win; s.cin = cin; s.cout = cout; s.pad = pad;
  s.ho = sh.ho; s.wo = sh.wo;
  s.th = (s.ho + 1) / 2; s.tw = (s.wo + 1) / 2;
  s.cp = (cout + 3) / 4 * 4;
  s.t = (long long)n * s.th * s.tw;
  s.tp = (s.t + 3) / 4 * 4;
  if ((long long)s.th * s.tw > 0x7fffffffLL || (s.tp + 31) / 32 > 0x7fffffffLL || (cin + 7) / 8 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  float* u = ws;
  float* v = u + 16LL * cin * s.cp;
  float* m = v + 16LL * cin * s.tp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wino_filter<<<elementwise_blocks((long long)cin * s.cp), 256, 0, st>>>(w, u, s);
  const unsigned tile_groups = (unsigned)((s.tp + 31) / 32);
  if (cin % 4 == 0 && aligned16(x)) {
    wino_input<4><<<dim3(tile_groups, (cin / 4 + 7) / 8), 256, 0, st>>>(x, v, s);
  } else {
    wino_input<1><<<dim3(tile_groups, (cin + 7) / 8), 256, 0, st>>>(x, v, s);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc = bn == 128 ? launch_wino_gemm<128, 128, 8, 8>(v, u, m, s, st)
                           : launch_wino_gemm<128, 64, 8, 4>(v, u, m, s, st);
  if (rc != 0) return rc;
  if (cout % 4 == 0 && aligned16(y)) {
    wino_output<true><<<elementwise_blocks(s.t * (s.cp / 4)), 256, 0, st>>>(m, y, s);
  } else {
    wino_output<false><<<elementwise_blocks(s.t * (s.cp / 4)), 256, 0, st>>>(m, y, s);
  }
  return (int)cudaGetLastError();
}

// The VALID stride-2 transposed 3x3 conv (tconv2_kernel): x (n, h, w, c1),
// w (3, 3, c1, c2) HWIO, y (n, 2h+1, 2w+1, c2), all float32, 16-byte
// aligned, c1 a multiple of 16 and c2 of 4. bn, the blocks' width in
// columns of c2: 64 (128 x 64, 8 x 4 a thread) or 128 (128 x 128, 8 x 8).
// Returns a cudaError_t as int, as conv3x3_fwd_launch does.
extern "C" int tconv3x3_s2_launch(const float* x, const float* w, float* y, int n, int h, int wd, int c1,
                                  int c2, int bn, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c1 <= 0 || c2 <= 0 || c1 % kBK != 0 || c2 % 4 != 0 ||
      (bn != 64 && bn != 128) || !aligned16(x) || !aligned16(w) || !aligned16(y) ||
      (long long)(h + 1) * (wd + 1) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  TconvShape s;
  s.n = n; s.h = h; s.w = wd; s.c1 = c1; s.c2 = c2;
  s.ho = 2 * h + 1;
  s.wo = 2 * wd + 1;
  s.ntn = (c2 + bn - 1) / bn;
  long long blocks = 0;
  for (int ph = 0; ph < 4; ++ph) {
    s.first[ph] = (int)blocks;
    const long long m = (long long)n * (h + 1 - (ph >> 1)) * (wd + 1 - (ph & 1));
    blocks += (m + 127) / 128 * s.ntn;  // both blocks are 128 rows
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  s.first[4] = (int)blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bn == 128 ? launch_tconv<128, 128, 8, 8>(x, w, y, s, st) : launch_tconv<128, 64, 8, 4>(x, w, y, s, st);
}
