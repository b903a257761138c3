// 3x3 stride-1 convolution of NHWC bfloat16 activations on Hopper's tensor
// cores: the forward (also used for the input gradient) and the filter
// gradient, float32 accumulation.
//
// Replaces, for bfloat16, the TPU kernels of triplegan_tpu/ops/pallas_conv.py:
//   fwd_kernel   <- _fwd_kernel    (launched by conv3x3_nopad)
//   wgrad_kernel <- _wgrad_kernel  (launched by conv3x3_wgrad)
// float32 calls keep to conv3x3.cu. Semantics as there: x is (N, Hin, Win,
// C) row-major, read with a zero halo of `pad` pixels (0, 1 or 2);
// Ho = Hin + 2*pad - 2, Wo likewise; K = 9*C, row k = (dy*3 + dx)*C + ci.
//   forward: y (M = N*Ho*Wo, Cout) = im2col(x) (M, K) . W (K, Cout), in bf16
//   wgrad:   dW (K, Cout) = im2col(x)^T (K, M) . g (M, Cout), in float32
//
// Bound: operations at the training step's shapes (989 TFLOP/s bf16 peak;
// hundreds of flops per byte at C >= 42); bytes only for the first layers.
// Measured (H100, chip_smoke.py and tools/conv_sm90_breakdown.py): the
// per-thread cp.async work of the im2col gather and the L2 traffic of
// re-read tiles keep the wide shapes at 33-45% of the peak; a TMA im2col
// load with a warp-specialized producer is the next step.
//
// Design: an implicit GEMM on wgmma (sm_90a), bf16 operands in shared
// memory, float32 accumulators in registers. A block is two warpgroups and
// 128 rows; each warpgroup issues m64nBNk16 products on its 64 rows, and
// two blocks share an SM, so one block's loads overlap the other's
// products. Operands arrive through a ring of STAGES tiles in dynamic
// shared memory, loaded STAGES-1 tiles ahead of the products; each tile
// row is 128 bytes (64 bf16) with the 128-byte swizzle that wgmma's
// descriptors name (16-byte chunk c of row r lands at chunk c ^ (r % 8);
// tiles 1024-byte aligned).
// - forward: A is the im2col tile, 128 output pixels x 64 of K, K-major:
//   each 16-byte chunk is 8 channels of one tap of one pixel, copied by the
//   threads with cp.async, or zero-filled (src-size 0) where the tap falls
//   in the halo or past K. No padded copy of x is made. B is the weight,
//   packed by the caller into a K-major (Np, Kp) bf16 matrix (Cout padded
//   to the tile width, K to a multiple of 64, zeros in the padding), one
//   TMA box a stage.
// - wgrad: rows are K, columns Cout, the reduction runs over pixels, 64 a
//   stage. Both operands are MN-major: A holds, for each of 64 pixels, 128
//   consecutive k (8-channel chunks of the taps; cp.async), and g's tile 64
//   pixels x BN channels (TMA boxes of 64 x 64). The M reduction is split
//   over grid z into a float32 workspace and summed by a second kernel in
//   a fixed order: no float atomics, so two runs give the same bits.
// A stage is ready when each thread's cp.async group has landed, each
// thread has fenced those copies into the async proxy (fence.proxy.async),
// and the stage's mbarrier has seen its TMA bytes; then one __syncthreads
// also tells everyone that the previous stage's products are done, and
// its slot is refilled while this stage's products run.
// The caller pads C (and, for wgrad, g's Cout) to a multiple of 8 with
// zeros and aligns x and g to 16 bytes, so every chunk is a 16-byte copy;
// results are written only for the real channels. Pixel offsets are 64-bit.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() (or the error of the tensor-map encoder
// or of cudaFuncSetAttribute).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kBM = 128;                      // block rows: 64 per warpgroup
constexpr int kBK = 64;                       // reduction depth of a stage
constexpr int kRow = 128;                     // bytes of a tile row (64 bf16)
constexpr int kHalf = 64 * kRow;              // 64 rows: one warpgroup's share
constexpr int kFar = -(1 << 29);              // an h or w that fails every bounds check

struct Shape {
  int n, hin, win, cin, cout, pad, ho, wo, k;  // cin: x's channels, a multiple of 8
  long long m;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src-size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// One arrival that also announces `bytes` of copies to complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
// TMA: the box at (c0, c1) (c0 the inner coordinate) of a 2-D tensor map
// into shared memory, completing on the barrier; zeros outside the tensor.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kRow + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
// K-major: rows of 128 bytes, SBO = 1024 (8 rows to the next 8), LBO unused.
// MN-major: each 128-byte row is 64 consecutive M (or N) values of one k;
// SBO = 1024 (8 k to the next 8), LBO = the step to the next 64 M or N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x N, float32, in registers) += A (64 x 16) . B (16 x N), bf16 from
// shared memory. TA / TB = 1: the operand is MN-major. Thread t of the
// warpgroup holds d[4j + 2h + e] = D[16*(t/32) + (t%32)/4 + 8h][8j + 2*(t%4) + e].
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<32, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// forward: y = conv(xh, W)
// ---------------------------------------------------------------------------

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Shape s, int kp,
           const __grid_constant__ CUtensorMap wmap) {
  constexpr int kPass = kThreads / 8;
  constexpr int kStage = (kBM + BN) * kRow;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // B tile of a slot has landed
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_addr(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid >> 7;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // A: this thread copies chunk ac (channels 8*ac.. of the stage's K
  // range) of rows ar + kPass*i; each row's pixel is decoded once.
  const int ac = tid & 7, ar = tid >> 3;
  long long pix[4];
  int ph[4], pw[4];
  {
    const int hw = s.ho * s.wo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ar + kPass * i;
      if (m < s.m) {
        const int nn = (int)(m / hw);
        const int rem = (int)(m - (long long)nn * hw);
        const int h = rem / s.wo;
        const int w = rem - h * s.wo;
        pix[i] = (((long long)nn * s.hin + h) * s.win + w) * s.cin;
        ph[i] = h;
        pw[i] = w;
      } else {
        pix[i] = 0;
        ph[i] = pw[i] = kFar;
      }
    }
  }

  auto load = [&](int kt, int slot) {
    const uint32_t sa = base + slot * kStage;
    const uint32_t sb = sa + kBM * kRow;
    if (tid == 0) {  // B: one TMA box of BN rows x 64 of K
      const uint32_t bar = smem_addr(&full[slot]);
      mbar_expect_tx(bar, BN * kRow);
      tma_load_2d(sb, &wmap, kt * kBK, n0, bar);
    }
    const int k = kt * kBK + ac * 8;
    int dyp = kFar, dxp = kFar, koff = 0;
    if (k < s.k) {
      const int tap = k / s.cin;
      const int dy = tap / 3;
      dyp = dy - s.pad;
      dxp = tap - 3 * dy - s.pad;
      koff = (dyp * s.win + dxp) * s.cin + (k - tap * s.cin);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hi = ph[i] + dyp, wi = pw[i] + dxp;
      const bool ok = (unsigned)hi < (unsigned)s.hin && (unsigned)wi < (unsigned)s.win;
      cp_async16(sa + swz(ar + kPass * i, ac), ok ? x + pix[i] + koff : x, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The ring: tile t sits in slot t % STAGES; copies run kAhead tiles in
  // front of the products.
  constexpr int kAhead = STAGES - 1;
  const int ktiles = kp / kBK;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < ktiles) load(t, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    mbar_wait(smem_addr(&full[kt % STAGES]), (kt / STAGES) & 1);
    __syncthreads();  // everyone's; and the products of tile kt-1 are done
    const uint32_t sa = base + (kt % STAGES) * kStage;
    const uint32_t sb = sa + kBM * kRow;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Wgmma<BN, 0, 0>::mma(acc, desc(sa + wg * kHalf + kk * 32, 16, 1024),
                           desc(sb + kk * 32, 16, 1024));
    }
    wgmma_commit();
    // refill the slot of tile kt-1 while the products run
    const int nk = kt + kAhead;
    if (nk < ktiles) load(nk, nk % STAGES);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const long long row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  const bool pairs = (s.cout & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = row0 + 8 * h;
    if (m >= s.m) continue;
    bf16* out = y + m * s.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < s.cout) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < s.cout) out[col] = __float2bfloat16_rn(v0);
        if (col + 1 < s.cout) out[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: partial dW over the pixel range of this block's split
// ---------------------------------------------------------------------------

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const bf16* __restrict__ x, float* __restrict__ ws, Shape s, int cin_out,
             int cout_out, long long chunk, const __grid_constant__ CUtensorMap gmap) {
  constexpr int kStage = (kBM + BN) * kRow;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // g tile of a slot has landed
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_addr(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid >> 7;
  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const long long mbeg = (long long)blockIdx.z * chunk;
  const long long mend = mbeg + chunk < s.m ? mbeg + chunk : s.m;

  // A: this thread copies k = k0 + 8*kc .. +7 (one tap, 8 channels) for
  // pixels ap + 16*i of each stage; the tap is decoded once.
  const int kc = tid & 15, ap = tid >> 4;
  int dyp = kFar, dxp = kFar, koff = 0;
  {
    const int k = k0 + 8 * kc;
    if (k < s.k) {
      const int tap = k / s.cin;
      const int dy = tap / 3;
      dyp = dy - s.pad;
      dxp = tap - 3 * dy - s.pad;
      koff = (dyp * s.win + dxp) * s.cin + (k - tap * s.cin);
    }
  }
  const uint32_t a_off = (kc >> 3) * kHalf;  // which warpgroup's 64 rows of K
  // (n, h, w) of this thread's pixels, advanced by kBK pixels a stage
  int pn[4], ph[4], pw[4];
  const int q = kBK / s.wo;
  const int step_w = kBK - q * s.wo, step_h = q % s.ho, step_n = q / s.ho;
  {
    const int hw = s.ho * s.wo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = mbeg + ap + 16 * i;
      pn[i] = (int)(m / hw);
      const int rem = (int)(m - (long long)pn[i] * hw);
      ph[i] = rem / s.wo;
      pw[i] = rem - ph[i] * s.wo;
    }
  }

  auto load = [&](long long mt, int slot) {
    const uint32_t sa = base + slot * kStage;
    const uint32_t sg = sa + kBM * kRow;
    if (tid == 0) {  // g: BN/64 TMA boxes of 64 pixels x 64 channels
      const uint32_t bar = smem_addr(&full[slot]);
      mbar_expect_tx(bar, BN * kRow);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) tma_load_2d(sg + j * kHalf, &gmap, n0 + 64 * j, (int)mt, bar);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ap + 16 * i;
      const int hi = ph[i] + dyp, wi = pw[i] + dxp;
      const bool ok = mt + p < mend && (unsigned)hi < (unsigned)s.hin &&
                      (unsigned)wi < (unsigned)s.win;
      const long long off = (((long long)pn[i] * s.hin + ph[i]) * s.win + pw[i]) * s.cin + koff;
      cp_async16(sa + a_off + swz(p, kc & 7), ok ? x + off : x, ok);
      pw[i] += step_w;
      const int cw = pw[i] >= s.wo;
      pw[i] -= cw ? s.wo : 0;
      ph[i] += step_h + cw;
      const int ch = ph[i] >= s.ho;
      ph[i] -= ch ? s.ho : 0;
      pn[i] += step_n + ch;
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The ring as in fwd_kernel. A warpgroup whose rows all lie past K (in
  // the last tile of K) issues no products.
  constexpr int kAhead = STAGES - 1;
  const bool active = k0 + wg * 64 < s.k;
  const int tiles = mend > mbeg ? (int)((mend - mbeg + kBK - 1) / kBK) : 0;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < tiles) load(mbeg + (long long)t * kBK, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    mbar_wait(smem_addr(&full[t % STAGES]), (t / STAGES) & 1);
    __syncthreads();
    const uint32_t sa = base + (t % STAGES) * kStage;
    const uint32_t sg = sa + kBM * kRow;
    if (active) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 pixels = 2 groups of 8 rows
        Wgmma<BN, 1, 1>::mma(acc, desc(sa + wg * kHalf + kk * 2048, kHalf, 1024),
                             desc(sg + kk * 2048, kHalf, 1024));
      }
      wgmma_commit();
    }
    const int nt = t + kAhead;
    if (nt < tiles) load(mbeg + (long long)nt * kBK, nt % STAGES);
    cp_async_commit();
    if (active) {
      wgmma_wait_all();
      fence_regs(acc);
    }
  }

  // rows are padded K (tap*cin + ci); write the real ones of the real Cout
  float* out = ws + (long long)blockIdx.z * 9 * cin_out * cout_out;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int col0 = n0 + 2 * (lane & 3);
  const bool pairs = (cout_out & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (k >= s.k) continue;
    const int tap = k / s.cin, ci = k - tap * s.cin;
    if (ci >= cin_out) continue;
    float* row = out + (long long)(tap * cin_out + ci) * cout_out;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < cout_out) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
      } else {
        if (col < cout_out) row[col] = v0;
        if (col + 1 < cout_out) row[col + 1] = v1;
      }
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
  if (n <= 0 || hin <= 0 || win <= 0 || cin <= 0 || cin % 8 != 0 || cout <= 0 || pad < 0 ||
      pad > 2) {
    return false;
  }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (so this
// library does not link libcuda); null where it is missing.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major 2-D bf16 tensor (rows of d0 elements, d1 rows, 16-byte
// aligned) read in boxes of b0 x b1 with the 128-byte swizzle. Returns a
// cudaError_t as int.
int tensor_map_2d(CUtensorMap* map, const void* base, unsigned long long d0,
                  unsigned long long d1, unsigned b0, unsigned b1) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || d0 % 8 != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * sizeof(bf16)};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a ring: STAGES tiles of kBM + BN rows of 128
// bytes, and 1 KB to align the ring to 1024 bytes.
template <int BN, int STAGES>
constexpr int ring_bytes() { return STAGES * (kBM + BN) * kRow + 1024; }

template <int BN, int STAGES>
int launch_fwd(const void* x, const void* wp, void* y, const Shape& s, int np, int kp,
               cudaStream_t st) {
  constexpr int smem = ring_bytes<BN, STAGES>();
  const auto kernel = fwd_kernel<BN, STAGES>;
  CUtensorMap wmap;
  const int rc = tensor_map_2d(&wmap, wp, kp, np, kBK, BN);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((s.m + kBM - 1) / kBM), (unsigned)(np / BN));
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(x), static_cast<bf16*>(y), s, kp,
                                       wmap);
  return (int)cudaGetLastError();
}

template <int BN, int STAGES>
int launch_wgrad(const void* x, const void* g, float* ws, const Shape& s, int cin_out,
                 int cout_out, int splits, long long chunk, cudaStream_t st) {
  constexpr int smem = ring_bytes<BN, STAGES>();
  const auto kernel = wgrad_kernel<BN, STAGES>;
  CUtensorMap gmap;
  const int rc = tensor_map_2d(&gmap, g, s.cout, s.m, kBK, kBK);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((s.k + kBM - 1) / kBM), (unsigned)((s.cout + BN - 1) / BN),
            (unsigned)splits);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(x), ws, s, cin_out, cout_out,
                                       chunk, gmap);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of 128 rows by bn columns, two to an SM (rings of 73 to 97 KB):
// bn 16, 32 or 64 with 4 stages, 128 with 3.

// x: (n, hin, win, cin) bf16, cin a multiple of 8; wp: the packed weight,
// (np, kp) bf16 K-major, kp = 9*cin rounded up to 64, np a multiple of
// bn >= cout; y: (n, ho, wo, cout) bf16.
// Returns a cudaError_t as int: 0 on a good launch, cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int conv3x3_fwd_sm90_launch(const void* x, const void* wp, void* y, int n, int hin,
                                       int win, int cin, int cout, int pad, int bn, int np,
                                       int kp, void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      kp != (s.k + kBK - 1) / kBK * kBK || bn <= 0 || np < cout || np % bn != 0 ||
      np / bn > 65535 || (s.m + kBM - 1) / kBM > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch_fwd<16, 4>(x, wp, y, s, np, kp, st);
    case 32: return launch_fwd<32, 4>(x, wp, y, s, np, kp, st);
    case 64: return launch_fwd<64, 4>(x, wp, y, s, np, kp, st);
    case 128: return launch_fwd<128, 3>(x, wp, y, s, np, kp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: (n, hin, win, cin) bf16, g: (n, ho, wo, cout) bf16, cin and cout
// multiples of 8 (zero-padded by the caller from cin_out and cout_out);
// out: the float32 (3, 3, cin_out, cout_out) filter gradient. The M =
// n*ho*wo reduction is split into `splits` ranges of `chunk` pixels (chunk
// a multiple of 64, splits * chunk >= M > (splits - 1) * chunk); ws holds
// splits * 9*cin_out*cout_out floats, or is out itself when splits == 1.
// bn, the block's width in columns of Cout: 64 or 128.
extern "C" int conv3x3_wgrad_sm90_launch(const void* x, const void* g, float* ws, float* out,
                                         int n, int hin, int win, int cin, int cout,
                                         int cin_out, int cout_out, int pad, int bn, int splits,
                                         long long chunk, void* stream) {
  Shape s;
  if (!make_shape(n, hin, win, cin, cout, pad, &s) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      cout % 8 != 0 || cin_out <= 0 || cin_out > cin || cin - cin_out >= 8 || cout_out <= 0 ||
      cout_out > cout || cout - cout_out >= 8 || s.m >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || splits > 65535 || chunk <= 0 || chunk % kBK != 0 ||
      (long long)splits * chunk < s.m || (long long)(splits - 1) * chunk >= s.m ||
      (splits == 1 && ws != out) || (splits > 1 && ws == out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (bn) {
    case 64: rc = launch_wgrad<64, 4>(x, g, ws, s, cin_out, cout_out, splits, chunk, st); break;
    case 128: rc = launch_wgrad<128, 3>(x, g, ws, s, cin_out, cout_out, splits, chunk, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  const long long total = 9LL * cin_out * cout_out;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  reduce_splits<<<(unsigned)blocks, 256, 0, st>>>(ws, out, total, splits);
  return (int)cudaGetLastError();
}
