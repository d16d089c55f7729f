// Halo-consuming stride-1 VALID convolution for Hopper (sm_90a): kernels
// K1 and K2 of the PyTorch port, bound to Python through ctypes
// (mpi4dl_tpu_torch/ops/halo_conv.py).
//
// K1 replaces mpi4dl_tpu/ops/pallas_conv.py::_kernel (launched by the
// pallas_call at pallas_conv.py:346):
//     out[n, y, x, :] = sum_{dy, dx} X[n, y + dy, x + dx, :] @ W[dy, dx]
// with X = relu(x) when `relu` is set, fp32 accumulation, cast to the
// output type.  K2 replaces pallas_conv.py::_kernel_stats (pallas_call at
// :364): the same conv plus fp32 per-channel sum and sum of squares of the
// CAST output over the static window [h0, h1) x [w0, w1) (output coords).
// K2 is a kernel below with `psum`/`psumsq` set; K1 is it with them null.
//
// Bound on an H100 SXM: at the main path's shapes (1x7 and 7x1 convs,
// m = Cin = Cout in {52, 104, 208, 416}, bf16) one call is 2.48 GFLOP,
// 2.5 us at the 989 TFLOP/s bf16 tensor-core peak, and moves 4-14 MB,
// 1.3-4.1 us at 3.35 TB/s: compute-bound at the deep layers, bytes-bound
// at the 256x256 one.
//
// bf16 in (the main path): an implicit GEMM on the tensor cores.
//   * GEMM: rows = output pixels (n, y, x) flattened, columns = Cout,
//     depth k = (dy, dx, c).  For one dy the (dx, c) run of a pixel is
//     contiguous in x (kw * Cin elements from x[n, y + dy, x, 0]) and the
//     weight rows are contiguous in k, so the depth is walked in BK = 64
//     slices of the flat k = 0 .. kh*kw*Cin: the A offset of k is
//     k + (k / (kw*Cin)) * (Wp - kw) * Cin from the pixel's base.  A 7x1
//     conv at Cin 52 is 6 slices (364 deep), not 7 x 4.
//   * Math: mma.sync.m16n8k16 bf16 x bf16 -> fp32, fragments read from
//     shared memory by ldmatrix (.trans for the [k][n] weight tile).  Each
//     warp owns a 32 x (8*NI) output tile: 2 x NI MMAs per k16 step.
//     mma.sync, not wgmma: at the 32x32 layers M is 1,024 pixels and each
//     call's bound is 2.5-4.2 us, so the loss of the earlier CUDA-core loop
//     came from scalar FMAs, unoverlapped loads and an under-filled card,
//     which mma.sync with a cp.async ring removes; wgmma's 64-row
//     warpgroup tiles would leave the small layers fewer blocks still.
//   * Operands stay bf16 in shared memory, in a 3-stage cp.async ring
//     (cp.async.wait_group 1 + one __syncthreads per slice): the copies of
//     slices k+1 and k+2 are in flight while slice k's MMAs run.  Rows are
//     padded by 8 elements (A 144 B, B 144, 272 or 80 B), so the 8 row
//     addresses of each ldmatrix fall in distinct banks.
//   * ReLU is applied to the A fragments in registers after ldmatrix (bf16
//     max(v, 0), exact; NaN propagates as in torch.relu).
//   * Tiles (tc::plan chooses one per launch), all run two blocks an SM:
//     128x64 or 128x128 (8 warps of 32x32 / 32x64), and 64x64 or 64x32 with
//     each 32-row warp tile shared by 2 warps that take alternate halves of
//     every slice (8 warps; their sums meet in shared memory in a fixed
//     order) and the fragments of k16 step j+1 read while step j's MMAs run.
//     The plan minimises whole waves of 2 x (the card's SMs) blocks times
//     the tile's edge (a block's time grows with the bytes it copies per
//     slice); grids smaller than a wave take the 64x32 tile.  Grids at the
//     main path's shapes on 132 SMs (pixel tiles x channel tiles), K2's
//     forward H x H / K1's dx H x (H+6):
//       256 m=52 : 128x64  512 x 1   / 128x64  524 x 1
//       128 m=104: 128x64  128 x 2   / 128x128 134 x 1
//        64 m=208:  64x64   64 x 4   / 128x64   35 x 4
//        32 m=416:  64x32   16 x 13  /  64x32   19 x 13
//     The shared memory (43-112 KB, opted into once per kernel and device)
//     does not depend on Cin, Cout or the kernel size: every stride-1 conv
//     fits.  K2's scratch has one row per pixel tile of the launch;
//     halo_conv2d_stat_rows reports that count, and a launch given another
//     is refused.
//   * Alignment: a pixel row at Cin 52 is 104 bytes, so every other row
//     starts 8 bytes off a 16-byte boundary; weight rows at Cout 52 too.
//     Copies are 16 bytes when Cin, Cout and both base pointers allow it,
//     else 8 bytes, else one element at a time (plain loads; channel
//     counts that are not a multiple of 4).  104, 208 and 416 take 16-byte
//     copies.
//   * Zero fill: depth past kh*kw*Cin, pixels past N*H*W and channels past
//     Cout are copied with src-size 0 (A and B both), so no stale shared-
//     memory bits (a NaN times a zero weight is NaN) reach an MMA.  Warps
//     whose 8-column MMA tiles lie wholly past Cout skip them.
//   * Epilogue: the fp32 fragments are cast to the output type and stored;
//     K2 folds the cast values inside the window into per-column sums in a
//     fixed order (each thread's rows, then the 8 row groups of a warp by
//     xor shuffles, then the warps of a column in shared memory), and
//     writes one partial per (pixel tile, channel) into a [tiles, Cout]
//     scratch that the wrapper sums.  No float atomics: two launches give
//     bitwise-identical y, sum and sum of squares.
//
// fp32 in (the kernel registry's ragged case, the autograd test): the
// exact fp32 arithmetic of a CUDA-core loop, 64x64 tiles of 4x4 per thread.
// TF32 tensor cores would keep 10 mantissa bits and break the 8-scaled-ULP
// contract that the fp32 checks hold it to.
//
// The TPU-only parts of the Pallas kernel (128-lane Cin pad, 8-aligned
// window, VMEM th-halving, vmap over N) have no counterpart here.  PERF.md
// holds the measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BM = 64;                            // output pixels per block
constexpr int BN = 64;                            // output channels per block
constexpr int BK = 16;                            // input channels per chunk
constexpr int TM = 4;                             // pixels per thread
constexpr int TN = 4;                             // channels per thread
constexpr int TY = BM / TM;                       // 16 pixel groups
constexpr int TX = BN / TN;                       // 16 channel groups
constexpr int THREADS = TY * TX;                  // 256
constexpr int A_PER_T = BM * BK / THREADS;        // 4 A loads per thread
constexpr int B_PER_T = BN * BK / THREADS;        // 4 B loads per thread
constexpr int A_LD = BM + 4;                      // padded A row (banks)

template <typename Tout>
__global__ void __launch_bounds__(THREADS)
    halo_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                Tout* __restrict__ y, float* __restrict__ psum,
                float* __restrict__ psumsq, int n, int hp, int wp, int cin,
                int kh, int kw, int cout, int relu, int h0, int h1, int w0,
                int w1) {
  __shared__ __align__(16) float As[BK][A_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red_s[TY][BN];
  __shared__ float red_ss[TY][BN];

  const int h = hp - kh + 1;
  const int wd = wp - kw + 1;
  const long long hw = (long long)h * wd;
  const long long m_total = (long long)n * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // The pixels this thread loads into the A tile: element e = tid + i *
  // THREADS of the [BM][BK] tile holds channel e % BK of pixel e / BK, so
  // neighbouring threads read neighbouring channels of one pixel.
  long long a_base[A_PER_T];
  bool a_ok[A_PER_T];
  int a_k[A_PER_T], a_m[A_PER_T];
#pragma unroll
  for (int i = 0; i < A_PER_T; ++i) {
    const int e = tid + i * THREADS;
    a_k[i] = e % BK;
    a_m[i] = e / BK;
    const long long p = m0 + a_m[i];
    a_ok[i] = p < m_total;
    a_base[i] = 0;
    if (a_ok[i]) {
      const long long nn = p / hw;
      const long long rem = p % hw;
      const long long oy = rem / wd;
      const long long ox = rem % wd;
      a_base[i] = ((nn * hp + oy) * wp + ox) * cin;
    }
  }
  // B tile element e holds output channel e % BN of input channel e / BN.
  int b_k[B_PER_T], b_n[B_PER_T];
#pragma unroll
  for (int i = 0; i < B_PER_T; ++i) {
    const int e = tid + i * THREADS;
    b_n[i] = e % BN;
    b_k[i] = e / BN;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {
      const long long tap_off = ((long long)dy * wp + dx) * cin;
      const float* wtap = w + (long long)(dy * kw + dx) * cin * cout;
      for (int c0 = 0; c0 < cin; c0 += BK) {
#pragma unroll
        for (int i = 0; i < A_PER_T; ++i) {
          const int c = c0 + a_k[i];
          float v = 0.f;
          if (a_ok[i] && c < cin) {
            v = x[a_base[i] + tap_off + c];
            if (relu) v = fmaxf(v, 0.f);
          }
          As[a_k[i]][a_m[i]] = v;
        }
#pragma unroll
        for (int i = 0; i < B_PER_T; ++i) {
          const int c = c0 + b_k[i];
          const int co = co0 + b_n[i];
          float v = 0.f;
          if (c < cin && co < cout) v = wtap[(long long)c * cout + co];
          Bs[b_k[i]][b_n[i]] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
          const float av[TM] = {a.x, a.y, a.z, a.w};
          const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // Epilogue: cast and store; K2 also folds the cast values into per-
  // channel partial sums over the stat window.
  float s_part[TN], ss_part[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) s_part[j] = ss_part[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long p = m0 + ty * TM + i;
    if (p >= m_total) continue;
    const long long rem = p % hw;
    const int oy = (int)(rem / wd);
    const int ox = (int)(rem % wd);
    const bool in_win = oy >= h0 && oy < h1 && ox >= w0 && ox < w1;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tx * TN + j;
      if (co >= cout) continue;
      const Tout o = from_f<Tout>(acc[i][j]);
      y[p * cout + co] = o;
      if (in_win) {
        const float v = to_f(o);
        s_part[j] += v;
        ss_part[j] += v * v;
      }
    }
  }
  if (psum != nullptr) {  // uniform over the block
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red_s[ty][tx * TN + j] = s_part[j];
      red_ss[ty][tx * TN + j] = ss_part[j];
    }
    __syncthreads();
    if (tid < BN && co0 + tid < cout) {
      float s = 0.f, ss = 0.f;
      for (int r = 0; r < TY; ++r) {
        s += red_s[r][tid];
        ss += red_ss[r][tid];
      }
      const long long o = (long long)blockIdx.x * cout + co0 + tid;
      psum[o] = s;
      psumsq[o] = ss;
    }
  }
}

template <typename Tout>
int launch(const void* x, const void* w, void* y, float* psum, float* psumsq,
           int n, int hp, int wp, int cin, int kh, int kw, int cout, int relu,
           int h0, int h1, int w0, int w1, cudaStream_t stream) {
  const long long m_total = (long long)n * (hp - kh + 1) * (wp - kw + 1);
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (cout + BN - 1) / BN);
  halo_conv_kernel<Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<Tout*>(y), psum, psumsq, n, hp, wp, cin, kh, kw, cout, relu,
      h0, h1, w0, w1);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by a cp.async ring.
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;  // cp.async, ldmatrix, mma.sync (sm90_mma.cuh)

constexpr int BK = 64;       // depth per pipeline slice (4 k16 MMA steps)
constexpr int STAGES = 3;    // slices in the shared-memory ring
constexpr int PAD = 8;       // elements of row padding (bank spread)
constexpr int A_LD = BK + PAD;

// WARPS_M x WARPS_N warps of (16*MI) x (8*NI) outputs; KS warps share each
// output tile, each taking 1/KS of every slice's k16 steps.
template <int WARPS_M_, int WARPS_N_, int MI_, int NI_, int KS_>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int MI = MI_, NI = NI_, KS = KS_;
  static constexpr int BM = WARPS_M * MI * 16;
  static constexpr int BN = WARPS_N * NI * 8;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N * KS;
  static constexpr int B_LD = BN + PAD;
  static constexpr int A_STAGE = BM * A_LD;  // elements
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2  // bf16 ring
                              + 2 * WARPS_M * BN * 4;           // K2 partials
};

// ReLU of two packed bf16 values: max(v, 0) that propagates NaN.
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0u));
  return r;
}

#ifdef HALO_CONV_CLOCKS
// Built so only by mpi4dl_tpu_torch/benchmarks/halo_conv_clocks.py: thread
// 0 of every block adds the clock64() cycles of its main loop to these
// counters: [0] waiting for a slice's copies (cp.async.wait_group and the
// barrier), [1] issuing the copies of a later slice, [2] whole slices; [3]
// counts the slices.  A slice's remaining cycles go to its ldmatrix and MMA
// issue.
__device__ unsigned long long g_clocks[4];
#endif

// The main loop's cycle split; a no-op unless built with HALO_CONV_CLOCKS.
struct SliceClocks {
#ifdef HALO_CONV_CLOCKS
  unsigned long long c[3] = {0, 0, 0};
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add(int i, long long since) {
    c[i] += clock64() - since;
  }
  __device__ __forceinline__ void flush(int slices) const {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 3; ++i) atomicAdd(&g_clocks[i], c[i]);
    atomicAdd(&g_clocks[3], (unsigned long long)slices);
  }
#else
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void flush(int) const {}
#endif
};

__device__ __forceinline__ void store2(float* p, float a, float b,
                                       bool paired) {
  if (paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b, bool paired) {
  if (paired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

template <int WARPS_M, int WARPS_N, int MI, int NI, int KS, int VEC,
          typename Tout>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N * KS, 2)
    halo_conv_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w, Tout* __restrict__ y,
                     float* __restrict__ psum, float* __restrict__ psumsq,
                     int n, int hp, int wp, int cin, int kh, int kw, int cout,
                     int relu, int h0, int h1, int w0, int w1) {
  using C = Cfg<WARPS_M, WARPS_N, MI, NI, KS>;
  constexpr int BM = C::BM, BN = C::BN, THREADS = C::THREADS;
  // Fragment double-buffering where a block has fewer than 8 output warps
  // (the main loop says more); k16 steps of one warp per slice.
  constexpr bool DB = WARPS_M * WARPS_N < 8;
  constexpr int STEPS = BK / 16 / KS;
  static_assert(KS == 1 || KS == 2, "one or two warps per output tile");
  static_assert(!DB || STEPS >= 2, "copies are issued over two k16 steps");
  constexpr int B_LD = C::B_LD;
  // Loader maps: each thread copies one VEC-wide column of the A and B
  // slices, at a fixed column and every ROWS-th row.
  constexpr int A_VPR = BK / VEC;
  constexpr int A_ROWS = THREADS / A_VPR;
  constexpr int A_PASSES = BM / A_ROWS;
  constexpr int B_VPR = BN / VEC;
  constexpr int B_ROWS = THREADS / B_VPR;
  static_assert(THREADS % A_VPR == 0 && BM % A_ROWS == 0, "A loader map");
  static_assert(THREADS % B_VPR == 0 && BK % B_ROWS == 0, "B loader map");
  static_assert(NI % 2 == 0, "B fragments load in pairs of n8 tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * C::A_STAGE;
  float* red_s = reinterpret_cast<float*>(Bs + STAGES * C::B_STAGE);
  float* red_ss = red_s + WARPS_M * BN;

  // Pixel indices fit in 32 bits (the launcher checks n * h * w < 2^31).
  const int h = hp - kh + 1;
  const int wd = wp - kw + 1;
  const unsigned hw = (unsigned)h * wd;
  const unsigned m_total = (unsigned)n * hw;
  const unsigned m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wk = warp / (WARPS_M * WARPS_N);  // k slice of this warp
  const int wm = (warp % (WARPS_M * WARPS_N)) / WARPS_N;
  const int wn = (warp % (WARPS_M * WARPS_N)) % WARPS_N;

  const int kwc = kw * cin;
  const int k_total = kh * kwc;
  const long long row_skip = (long long)(wp - kw) * cin;
  const int num_k = (k_total + BK - 1) / BK;
  const int a_col = (tid % A_VPR) * VEC;
  const int a_row = tid / A_VPR;
  const int b_col = (tid % B_VPR) * VEC;
  const int b_row = tid / B_VPR;
  const bool b_col_ok = co0 + b_col < cout;

  // Offset in x of the pixel at (dy, dx, c) = 0 of each row this thread
  // copies; -1 past the last pixel.
  long long a_base[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const unsigned p = m0 + a_row + i * A_ROWS;
    a_base[i] = -1;
    if (p < m_total) {
      const unsigned nn = p / hw;
      const unsigned rem = p - nn * hw;
      const unsigned oy = rem / wd;
      const unsigned ox = rem - oy * wd;
      a_base[i] = (((long long)nn * hp + oy) * wp + ox) * cin;
    }
  }
  // This thread's depth column: k = slice * BK + a_col = dy * kwc + a_rem.
  int a_dy = min(a_col / kwc, kh);
  int a_rem = a_col - a_dy * kwc;
  SliceClocks clk;

  // Slice kt's copies into `slot`; load_a is called for kt = 0, 1, ... in
  // order (the depth column advances by BK a call).
  auto load_a = [&](int slot, int kt) {
    const long long t = clk.now();
    const int ka = kt * BK + a_col;
    const bool ka_ok = ka < k_total;
    const long long a_off = (long long)a_dy * row_skip + ka;
    __nv_bfloat16* a_dst = As + slot * C::A_STAGE + a_row * A_LD + a_col;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const bool ok = ka_ok && a_base[i] >= 0;
      copy<VEC>(a_dst + i * A_ROWS * A_LD, ok ? x + a_base[i] + a_off : x, ok);
    }
    a_rem += BK;
    while (a_rem >= kwc && a_dy < kh) {
      a_rem -= kwc;
      ++a_dy;
    }
    clk.add(1, t);
  };
  auto load_b = [&](int slot, int kt) {
    const long long t = clk.now();
    const int k0 = kt * BK;
    __nv_bfloat16* b_dst = Bs + slot * C::B_STAGE + b_row * B_LD + b_col;
    const __nv_bfloat16* b_src = w + (long long)(k0 + b_row) * cout + co0 + b_col;
#pragma unroll
    for (int i = 0; i < BK / B_ROWS; ++i) {
      const bool ok = b_col_ok && k0 + b_row + i * B_ROWS < k_total;
      copy<VEC>(b_dst + i * B_ROWS * B_LD,
                ok ? b_src + (long long)i * B_ROWS * cout : w, ok);
    }
    clk.add(1, t);
  };

  // Shared-memory byte addresses of this lane's ldmatrix rows in slot 0.
  uint32_t a_frag[MI], b_frag[NI / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    a_frag[mi] = smem_addr(As + (wm * MI * 16 + mi * 16 + (lane & 15)) * A_LD +
                           (lane >> 4) * 8);
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj)
    b_frag[nj] = smem_addr(Bs + ((lane & 7) + ((lane >> 3) & 1) * 8) * B_LD +
                           wn * NI * 8 + nj * 16 + (lane >> 4) * 8);
  // The fragments of k16 step `kk` of the slice at byte offsets (a_s, b_s).
  auto load_frags = [&](uint32_t (&af)[MI][4], uint32_t (&bf)[NI / 2][4],
                        uint32_t a_s, uint32_t b_s, int kk) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      ldsm_x4(af[mi], a_frag[mi] + a_s + kk * 2);
      if (relu) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[mi][e] = relu2(af[mi][e]);
      }
    }
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj)
      ldsm_x4_trans(bf[nj], b_frag[nj] + b_s + kk * B_LD * 2);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // 8-column MMA tiles wholly past Cout are skipped (warp-uniform).
  int live_ni = (cout - (co0 + wn * NI * 8) + 7) / 8;
  live_ni = live_ni < 0 ? 0 : (live_ni > NI ? NI : live_ni);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < num_k) {
      load_a(s, s);
      load_b(s, s);
    }
    cp_async_commit();
  }

  // 8-warp blocks issue the copies of slice kt + STAGES - 1 right after the
  // barrier and leave load latency to the other warps.  Smaller blocks
  // issue them between the MMAs of their first two k16 steps, and read the
  // fragments of step j + 1 while step j's MMAs run.
  auto mma_step = [&](const uint32_t (&a)[MI][4], const uint32_t (&b)[NI / 2][4]) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (ni >= live_ni) break;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma(acc[mi][ni], a[mi], b[ni / 2][(ni & 1) * 2], b[ni / 2][(ni & 1) * 2 + 1]);
    }
  };
  uint32_t af[DB ? 2 : 1][MI][4], bf[DB ? 2 : 1][NI / 2][4];
  int slot = 0;
  for (int kt = 0; kt < num_k; ++kt) {
    // Slice kt has landed; every warp is done with slice kt - 1, whose slot
    // the next copies overwrite.
    const long long t_slice = clk.now();
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    clk.add(0, t_slice);
    const int nk = kt + STAGES - 1;
    const int nslot = slot == 0 ? STAGES - 1 : slot - 1;
    const uint32_t a_s = slot * C::A_STAGE * 2;
    const uint32_t b_s = slot * C::B_STAGE * 2;
    if constexpr (DB) {
      load_frags(af[0], bf[0], a_s, b_s, wk * STEPS * 16);
    } else {
      if (nk < num_k) {
        load_a(nslot, nk);
        load_b(nslot, nk);
      }
      cp_async_commit();
    }
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int kk = (wk * STEPS + st) * 16;
      if constexpr (DB) {
        if (st == 0 && nk < num_k) load_a(nslot, nk);
        if (st == 1) {
          if (nk < num_k) load_b(nslot, nk);
          cp_async_commit();
        }
        if (st + 1 < STEPS)
          load_frags(af[(st + 1) & 1], bf[(st + 1) & 1], a_s, b_s, kk + 16);
        mma_step(af[st & 1], bf[st & 1]);
      } else {
        // Fresh registers each step, so the next step's ldmatrix need not
        // wait for this step's MMAs to read theirs.
        uint32_t a1[MI][4], b1[NI / 2][4];
        load_frags(a1, b1, a_s, b_s, kk);
        mma_step(a1, b1);
      }
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    clk.add(2, t_slice);
  }
  cp_async_wait<0>();
  clk.flush(num_k);

  constexpr int PER_T = MI * NI * 4;  // fragment floats of a thread
  const bool owner = wk == 0;         // holds the block's sums from here
  if constexpr (KS == 2) {
    // The k-slice-1 warps hand their sums to the k-slice-0 warps through
    // the drained ring: acc(slice 0) + acc(slice 1), a fixed order.
    float* red = reinterpret_cast<float*>(smem) + (tid % (THREADS / 2)) * PER_T;
    __syncthreads();
    if (!owner) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          *reinterpret_cast<float4*>(red + (mi * NI + ni) * 4) =
              make_float4(acc[mi][ni][0], acc[mi][ni][1], acc[mi][ni][2],
                          acc[mi][ni][3]);
    }
    __syncthreads();
    if (owner) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float4 v = *reinterpret_cast<const float4*>(red + (mi * NI + ni) * 4);
          acc[mi][ni][0] += v.x;
          acc[mi][ni][1] += v.y;
          acc[mi][ni][2] += v.z;
          acc[mi][ni][3] += v.w;
        }
    }
  }

  // Epilogue.  Fragment (mi, ni) of lane (g, t4) holds rows g and g + 8 of
  // the m16 tile, columns 2*t4 and 2*t4 + 1 of the n8 tile.
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool stats = psum != nullptr;  // uniform over the block
  const bool paired = (cout & 1) == 0;
  float cs[NI][2], css[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    cs[ni][0] = cs[ni][1] = css[ni][0] = css[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const unsigned p = m0 + wm * MI * 16 + mi * 16 + half * 8 + g;
      if (!owner || p >= m_total) continue;
      bool in_win = false;
      if (stats) {
        const unsigned rem = p % hw;
        const int oy = (int)(rem / wd);
        const int ox = (int)(rem - oy * wd);
        in_win = oy >= h0 && oy < h1 && ox >= w0 && ox < w1;
      }
      Tout* yrow = y + (long long)p * cout;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = co0 + wn * NI * 8 + ni * 8 + 2 * t4;
        if (c >= cout) continue;
        const Tout o0 = from_f<Tout>(acc[mi][ni][2 * half]);
        const Tout o1 = from_f<Tout>(acc[mi][ni][2 * half + 1]);
        if (c + 1 < cout) {
          store2(yrow + c, o0, o1, paired);
        } else {
          yrow[c] = o0;
        }
        if (in_win) {
          const float v0 = to_f(o0);
          cs[ni][0] += v0;
          css[ni][0] += v0 * v0;
          if (c + 1 < cout) {
            const float v1 = to_f(o1);
            cs[ni][1] += v1;
            css[ni][1] += v1 * v1;
          }
        }
      }
    }
  }
  if (!stats) return;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = cs[ni][j], ss = css[ni][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (owner && g == 0) {
        const int col = wn * NI * 8 + ni * 8 + 2 * t4 + j;
        red_s[wm * BN + col] = s;
        red_ss[wm * BN + col] = ss;
      }
    }
  }
  __syncthreads();
  for (int col = tid; col < BN; col += THREADS) {
    const int co = co0 + col;
    if (co >= cout) continue;
    float s = 0.f, ss = 0.f;
    for (int r = 0; r < WARPS_M; ++r) {
      s += red_s[r * BN + col];
      ss += red_ss[r * BN + col];
    }
    const long long o = (long long)blockIdx.x * cout + co;
    psum[o] = s;
    psumsq[o] = ss;
  }
}

// Widest copy (elements) that Cin, Cout and both base pointers allow.
int vec_width(const void* x, const void* w, int cin, int cout) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aw = reinterpret_cast<uintptr_t>(w);
  const int widths[2] = {8, 4};
  for (int v : widths)
    if (cin % v == 0 && cout % v == 0 && ax % (2 * v) == 0 && aw % (2 * v) == 0)
      return v;
  return 1;
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  float* psum;
  float* psumsq;
  int n, hp, wp, cin, kh, kw, cout, relu, h0, h1, w0, w1;
  cudaStream_t stream;
};

// Tile configurations (pixels x channels per block), by index:
using Tile0 = Cfg<4, 2, 2, 4, 1>;  // 128 x 64, 8 warps of 32 x 32
using Tile1 = Cfg<4, 2, 2, 8, 1>;  // 128 x 128, 8 warps of 32 x 64
using Tile2 = Cfg<2, 2, 2, 4, 2>;  // 64 x 64, 4 warp tiles of 32 x 32, each
                                   // k16 step split over 2 warps
using Tile3 = Cfg<2, 2, 2, 2, 2>;  // 64 x 32, 4 warp tiles of 32 x 16, the same
constexpr int NUM_TILES = 4;
constexpr int TILE_M[NUM_TILES] = {Tile0::BM, Tile1::BM, Tile2::BM, Tile3::BM};
constexpr int TILE_N[NUM_TILES] = {Tile0::BN, Tile1::BN, Tile2::BN, Tile3::BN};

// The tile for m output pixels and cout channels on a card of `sms` SMs.
// Every tile runs two blocks an SM, so a grid runs in waves of 2 * sms
// blocks, and a block's time grows with its tile's edge (the bytes it
// copies per slice): the tile that minimises waves x (pixels + channels) is
// taken, the earlier on a tie.  A grid one block past a wave costs a whole
// wave; a grid within one wave takes the smallest tile.
int plan(long long m, int cout, int sms) {
  int best = 0;
  long long best_cost = -1;
  for (int c = 0; c < NUM_TILES; ++c) {
    const long long blocks =
        ((m + TILE_M[c] - 1) / TILE_M[c]) * ((cout + TILE_N[c] - 1) / TILE_N[c]);
    const long long waves = (blocks + 2LL * sms - 1) / (2LL * sms);
    const long long cost = waves * (TILE_M[c] + TILE_N[c]);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <typename C, int VEC, typename Tout>
int launch_cfg(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};  // one per kernel
  const cudaError_t err = opt_in_smem(
      halo_conv_kernel<C::WARPS_M, C::WARPS_N, C::MI, C::NI, C::KS, VEC, Tout>,
      C::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long m_total =
      (long long)a.n * (a.hp - a.kh + 1) * (a.wp - a.kw + 1);
  const dim3 grid((unsigned)((m_total + C::BM - 1) / C::BM),
                  (a.cout + C::BN - 1) / C::BN);
  halo_conv_kernel<C::WARPS_M, C::WARPS_N, C::MI, C::NI, C::KS, VEC, Tout>
      <<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w), static_cast<Tout*>(a.y), a.psum,
      a.psumsq, a.n, a.hp, a.wp, a.cin, a.kh, a.kw, a.cout, a.relu, a.h0, a.h1,
      a.w0, a.w1);
  return (int)cudaGetLastError();
}

template <int VEC, typename Tout>
int launch_vec(int cfg, const Args& a) {
  switch (cfg) {
    case 0: return launch_cfg<Tile0, VEC, Tout>(a);
    case 1: return launch_cfg<Tile1, VEC, Tout>(a);
    case 2: return launch_cfg<Tile2, VEC, Tout>(a);
    default: return launch_cfg<Tile3, VEC, Tout>(a);
  }
}

template <typename Tout>
int launch(int cfg, const Args& a) {
  if ((long long)a.n * (a.hp - a.kh + 1) * (a.wp - a.kw + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  switch (vec_width(a.x, a.w, a.cin, a.cout)) {
    case 8: return launch_vec<8, Tout>(cfg, a);
    case 4: return launch_vec<4, Tout>(cfg, a);
    default: return launch_vec<1, Tout>(cfg, a);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Rows of K2's partial-statistics scratch for a launch: one per pixel tile
// of the tile that the launch takes on a card of `sms` SMs (64 pixels for
// fp32 input).
long long halo_conv2d_stat_rows(int n, int hp, int wp, int kh, int kw,
                                int cout, int in_bf16, int sms) {
  const long long m_total = (long long)n * (hp - kh + 1) * (wp - kw + 1);
  if (m_total <= 0) return 0;
  const int bm = in_bf16 ? tc::TILE_M[tc::plan(m_total, cout, sms)] : simt::BM;
  return (m_total + bm - 1) / bm;
}

// Launches K1 (psum == psumsq == NULL) or K2 on `stream`; returns the
// cudaGetLastError() code after the launch (0 = success).  Tensors are
// contiguous: x [n, hp, wp, cin] and w [kh, kw, cin, cout] of one type,
// y [n, hp-kh+1, wp-kw+1, cout], psum/psumsq [stat_rows, cout] fp32, where
// stat_rows must be halo_conv2d_stat_rows(...) of the same launch (else
// cudaErrorInvalidValue, and nothing runs).  Types: 0 = float32, 1 =
// bfloat16.  bf16 input takes the tensor-core kernel with the tile that
// tc::plan picks for `sms` SMs; fp32 input the CUDA-core kernel.
int halo_conv2d_launch(const void* x, const void* w, void* y, void* psum,
                       void* psumsq, int n, int hp, int wp, int cin, int kh,
                       int kw, int cout, int in_bf16, int out_bf16, int relu,
                       int h0, int h1, int w0, int w1, long long stat_rows,
                       int sms, void* stream) {
  if (sms <= 0 ||
      (psum != nullptr &&
       stat_rows != halo_conv2d_stat_rows(n, hp, wp, kh, kw, cout, in_bf16, sms)))
    return (int)cudaErrorInvalidValue;
  const long long m_total = (long long)n * (hp - kh + 1) * (wp - kw + 1);
  if (m_total <= 0 || cout <= 0) return (int)cudaSuccess;
  float* ps = static_cast<float*>(psum);
  float* pss = static_cast<float*>(psumsq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    const tc::Args a{x,  w,  y,    ps,   pss, n,  hp, wp, cin,
                     kh, kw, cout, relu, h0,  h1, w0, w1, st};
    const int cfg = tc::plan(m_total, cout, sms);
    return out_bf16 ? tc::launch<__nv_bfloat16>(cfg, a)
                    : tc::launch<float>(cfg, a);
  }
  if (out_bf16)
    return simt::launch<__nv_bfloat16>(x, w, y, ps, pss, n, hp, wp, cin, kh,
                                       kw, cout, relu, h0, h1, w0, w1, st);
  return simt::launch<float>(x, w, y, ps, pss, n, hp, wp, cin, kh, kw, cout,
                             relu, h0, h1, w0, w1, st);
}

const char* halo_conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef HALO_CONV_CLOCKS
// Copies tc::g_clocks into out[4] and zeroes it (after a synchronize).
int halo_conv2d_take_clocks(unsigned long long* out) {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, tc::g_clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tc::g_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // extern "C"
