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
// K2 is this kernel with `psum`/`psumsq` set; K1 is it with them null.
//
// Bound on an H100 SXM: at the main path's shapes (1x7 and 7x1 convs,
// m = Cin = Cout in {52, 104, 208, 416}, bf16) one call is 2.48 GFLOP,
// 2.5 us at the 989 TFLOP/s bf16 tensor-core peak, and moves 4-14 MB,
// 1.3-4.1 us at 3.35 TB/s: compute-bound at the deep layers, bytes-bound
// at the 256x256 one.
//
// Design (first version: right and simple, not yet fast):
//   * implicit GEMM: rows = output pixels (n, y, x) flattened, columns =
//     output channels, depth = (tap dy, tap dx, input channel);
//   * one block per (64-pixel tile, 64-channel tile), 256 threads, each
//     thread accumulating a 4x4 fp32 register tile with scalar FMAs on the
//     CUDA cores (bf16 products are exact in fp32, so the sum differs from
//     a tensor-core sum only in order);
//   * the depth streams through shared memory in 16-channel chunks per
//     tap, so the footprint (~16.6 KB) does not depend on Cin, Cout or
//     the kernel size: every stride-1 conv fits, and no TPU VMEM cap
//     carries over;
//   * ragged pixel and channel edges are masked on load and store;
//   * K2's statistics are reduced in the block in a fixed order and written
//     as one partial per (pixel tile, channel) into a [tiles, Cout] fp32
//     scratch that the wrapper sums: deterministic, no float atomics.
// The TPU-only parts of the Pallas kernel (128-lane Cin pad, 8-aligned
// window, VMEM th-halving, vmap over N) have no counterpart here.
// Tensor-core (mma.sync / wgmma) tiles and TMA loads are later work;
// PERF.md holds this version's measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
    halo_conv_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                     Tout* __restrict__ y, float* __restrict__ psum,
                     float* __restrict__ psumsq, int n, int hp, int wp,
                     int cin, int kh, int kw, int cout, int relu, int h0,
                     int h1, int w0, int w1) {
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
      const Tin* wtap = w + (long long)(dy * kw + dx) * cin * cout;
      for (int c0 = 0; c0 < cin; c0 += BK) {
#pragma unroll
        for (int i = 0; i < A_PER_T; ++i) {
          const int c = c0 + a_k[i];
          float v = 0.f;
          if (a_ok[i] && c < cin) {
            v = to_f(x[a_base[i] + tap_off + c]);
            if (relu) v = fmaxf(v, 0.f);
          }
          As[a_k[i]][a_m[i]] = v;
        }
#pragma unroll
        for (int i = 0; i < B_PER_T; ++i) {
          const int c = c0 + b_k[i];
          const int co = co0 + b_n[i];
          float v = 0.f;
          if (c < cin && co < cout) v = to_f(wtap[(long long)c * cout + co]);
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

template <typename Tin, typename Tout>
int launch(const void* x, const void* w, void* y, float* psum, float* psumsq,
           int n, int hp, int wp, int cin, int kh, int kw, int cout, int relu,
           int h0, int h1, int w0, int w1, cudaStream_t stream) {
  const long long m_total = (long long)n * (hp - kh + 1) * (wp - kw + 1);
  if (m_total <= 0 || cout <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (cout + BN - 1) / BN);
  halo_conv_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<Tout*>(y), psum, psumsq, n, hp, wp, cin, kh, kw, cout, relu,
      h0, h1, w0, w1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output pixels per block: the row count of K2's partial-statistics scratch
// is ceil(N * H * W / halo_conv2d_tile_m()).
int halo_conv2d_tile_m() { return BM; }

// Launches K1 (psum == psumsq == NULL) or K2 on `stream`; returns the
// cudaGetLastError() code after the launch (0 = success).  Tensors are
// contiguous: x [n, hp, wp, cin] and w [kh, kw, cin, cout] of one type,
// y [n, hp-kh+1, wp-kw+1, cout], psum/psumsq [tiles, cout] fp32.
// Types: 0 = float32, 1 = bfloat16.
int halo_conv2d_launch(const void* x, const void* w, void* y, void* psum,
                       void* psumsq, int n, int hp, int wp, int cin, int kh,
                       int kw, int cout, int in_bf16, int out_bf16, int relu,
                       int h0, int h1, int w0, int w1, void* stream) {
  float* ps = static_cast<float*>(psum);
  float* pss = static_cast<float*>(psumsq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, ps, pss, n, hp, wp,
                                                  cin, kh, kw, cout, relu, h0,
                                                  h1, w0, w1, st);
    return launch<__nv_bfloat16, float>(x, w, y, ps, pss, n, hp, wp, cin, kh,
                                        kw, cout, relu, h0, h1, w0, w1, st);
  }
  if (out_bf16)
    return launch<float, __nv_bfloat16>(x, w, y, ps, pss, n, hp, wp, cin, kh,
                                        kw, cout, relu, h0, h1, w0, w1, st);
  return launch<float, float>(x, w, y, ps, pss, n, hp, wp, cin, kh, kw, cout,
                              relu, h0, h1, w0, w1, st);
}

const char* halo_conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
