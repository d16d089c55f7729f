// Block flash attention for Hopper (sm_90a): kernel K3 of the PyTorch port
// and its backward, bound to Python through ctypes
// (mpi4dl_tpu_torch/ops/flash_attention.py).
//
// K3 replaces mpi4dl_tpu/ops/pallas_attention.py::_kernel (launched by the
// pallas_call at pallas_attention.py:165).  For one attention block it
// returns the UNNORMALISED flash state, all fp32:
//     s     = scale * q k^T
//     m     = rowmax(s)          [BH, Tq]
//     o_hat = exp(s - m) v       [BH, Tq, D]
//     l     = rowsum(exp(s - m)) [BH, Tq]
// Masked scores are -1e30 (never -inf), set after scaling: keys past Tk,
// and under `causal` every key whose GLOBAL position k_off + j exceeds the
// query's q_off + i.  A score counts only where s > -1e30 / 2, so a fully
// masked row gives p = 0 and (o_hat, m, l) = (0, -1e30, 0), the identity
// of the ring merge.  q_off and k_off are runtime arguments: one build
// serves every ring hop.
//
// The backward replaces the JAX package's blockwise backward
// (pallas_attention.py:243-311, a lax.scan of einsum tiles, not a Pallas
// kernel).  With P = exp(s - m), m held constant, the same mask and guard:
//     dP = do v^T + dl 1^T;  dS = P * dP
//     dq = scale dS k;  dk = scale dS^T q;  dv = P^T do
// (the cotangent of m is ignored, as there), written in fp32.
//
// Two routes, chosen by type (never by failure):
//
// bf16 q, k and v (the long-context slice): FlashAttention-2 on the tensor
// cores, mma.sync.m16n8k16 bf16 x bf16 -> fp32 with ldmatrix fragments and
// the cp.async copies of sm90_mma.cuh.
//   * Bound on an H100 SXM: at the slice's call (BH 8, T 16384, D 128,
//     causal) the forward is 4 BH D pairs = 5.5e11 FLOP, 0.56 ms at the
//     989 TFLOP/s bf16 peak, against 34 MB of bytes (0.01 ms): operation-
//     bound; the backward's 10 BH D pairs are 1.4 ms.
//   * Precision.  q, k and v are exact bf16 MMA operands, and `scale` is
//     applied to the fp32 accumulator of q k^T (a product of two bf16 is
//     exact in fp32), so s keeps fp32 accuracy.  Every fp32 operand of a
//     later product (P in the forward; P, dS and do in the backward) is
//     split into two bf16 values x = hi + lo (x - hi is exact in fp32, lo
//     rounds it), and the products run as hi and lo MMAs: each operand
//     then carries a relative error of about 2^-17 instead of 2^-9, which
//     keeps the forward within the fp32 kernel's bound of 1e-5 max(1,
//     max|ref|) on m and o/l and rtol 1e-5 on l (l is summed from the
//     unrounded fp32 P), and the backward within rtol 1e-4 / atol 1e-5
//     max|ref| of its fp32 plain version (the JAX gradient test's
//     tolerance).  dv drops the lo x lo product (2^-18).  The MMAs of one
//     key (or query) tile start from zero and are added to the fp32
//     accumulators with round-to-nearest adds (add_tile below): a chain of
//     1,024 accumulating k16 steps truncates too much.  exp is one
//     ex2.approx of x log2(e) (exp_le0 below).
//   * Forward: one block of 4 warps per (bh, 64-row q tile); each warp owns
//     16 query rows.  q's A fragments are read from device memory into
//     registers once; K and V tiles of 64 keys go into separate
//     double-buffered cp.async rings, so tile j+1 loads while tile j
//     computes.  The S accumulators (16 x 64 per warp) take the online
//     softmax in registers: the row max and sum across a row's 4 lanes by
//     xor shuffles, l kept per lane and summed at the end.  P is re-packed
//     from the S accumulators into A fragments in registers (no shared-
//     memory round trip).  O (16 x 128 per warp) stays in registers.
//   * Backward, deterministic (no float atomics), as three launches: do is
//     split into bf16 hi and lo arrays; (a) the dK/dV pass, one block per
//     (bh, 64-key tile) holding K and V in shared memory and looping over
//     32-row q tiles (under `causal` from the first q tile that sees the
//     key tile), recomputes S^T = K q^T and P^T, dP^T = V do^T + dl and
//     dS^T in registers and accumulates dv = P^T do and dk = dS^T q; (b)
//     the dQ pass, one block per (bh, 64-row q tile) looping over key tiles
//     up to its last visible key, recomputes S, P and dS and accumulates
//     dq = dS k.  Each output is written once.
//   * Causal work: key loops stop at the block's last visible key (a
//     skipped tile would be masked for every row and change nothing), the
//     dK/dV pass starts at the first q tile that sees its keys, only tiles
//     that cross the diagonal or the Tq/Tk tails evaluate the mask, and the
//     q tiles launch heaviest-first (the grid's slow dimension runs over the
//     q tiles in reverse), so the longest blocks do not end up in the last
//     wave.
//   * Traps.  D is a runtime value up to 128 (the depth is padded to 64 or
//     128 in shared memory; the pad is zero-filled in every operand):
//     copies are 16 bytes when D % 8 == 0 and the pointers allow, 8 bytes
//     when D % 4 == 0 (D = 100: 200-byte rows), else one element at a
//     time.  Rows past Tq and keys past Tk are zero-filled too, since a
//     stale shared-memory NaN times a zero is NaN.  A block with no
//     visible key ("hop future") writes (0, -1e30, 0), or zero gradients,
//     without reading its inputs.
//   * mma.sync, not wgmma/TMA: the kernel's first tensor-core version
//     reuses the repository's mma.sync building blocks, and the hi/lo
//     splits need P and dS as register A operands, which mma.sync takes
//     directly; wgmma and TMA are later work (PERF.md holds the times
//     beside the bound).
//
// fp32 (the kernel registry's fp32 case, fp32 ring hops and the fp32
// reduced-depth step): the exact fp32 arithmetic of a CUDA-core loop, q
// arriving scaled in fp32 and bf16 k/v converted exactly on load.  One
// block of 256 threads per (bh, 64-row q tile) keeps acc, m and l in
// registers; each thread owns 4 rows x 4 keys of the score tile; the q
// tile, one k or v tile and the p tile live in shared memory (87,040 B).
// Its backward stays in PyTorch ops (flash_attention.py): the JAX package's
// backward is not a Pallas kernel, and fp32 is not the slice's path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int D_MAX = 128;              // largest head dimension
constexpr int TX = 16;                  // threads across a row's keys
constexpr int TY = 16;                  // threads down the rows
constexpr int THREADS = TX * TY;        // 256
constexpr int RM = BQ / TY;             // 4 rows per thread
constexpr int CN = BK / TX;             // 4 keys per thread
constexpr int LD = BQ + 4;              // padded row of a transposed tile
constexpr int QT_FLOATS = D_MAX * LD;   // qt[d][row]
constexpr int KV_FLOATS = D_MAX * LD;   // kt[d][key], or v[key][d] (64x128)
constexpr int PT_FLOATS = BK * LD;      // pt[key][row]
constexpr size_t SMEM_BYTES =
    (size_t)(QT_FLOATS + KV_FLOATS + PT_FLOATS) * sizeof(float);
static_assert(BK * D_MAX <= KV_FLOATS, "v tile must fit the k/v buffer");
static_assert(BK <= LD, "kt row must hold a k tile");

template <typename Tkv>
__global__ void __launch_bounds__(THREADS)
    block_flash_kernel(const float* __restrict__ q, const Tkv* __restrict__ k,
                       const Tkv* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int tq, int tk, int d, int causal, int q_off,
                       int k_off) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kv = qt + QT_FLOATS;
  float* pt = kv + KV_FLOATS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, tq - q0);
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const float* qb = q + ((long long)bh * tq + q0) * d;
  const Tkv* kb = k + (long long)bh * tk * d;
  const Tkv* vb = v + (long long)bh * tk * d;

  // The q tile, transposed; rows past Tq and columns past D read as zero.
  for (int e = tid; e < BQ * D_MAX; e += THREADS) {
    const int r = e / D_MAX;
    const int c = e % D_MAX;
    qt[c * LD + r] = (r < rows && c < d) ? qb[(long long)r * d + c] : 0.f;
  }

  // Keys [0, k_end) can be visible to some row of this block.
  int k_end = tk;
  if (causal) {
    const long long lim = (long long)q_off + q0 + rows - k_off;
    k_end = (int)max(0LL, min((long long)tk, lim));
  }

  float acc[RM][8];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers of kv and pt are done
    for (int e = tid; e < BK * D_MAX; e += THREADS) {
      const int j = e / D_MAX;
      const int c = e % D_MAX;
      kv[c * LD + j] =
          (k0 + j < tk && c < d) ? to_f(kb[(long long)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[c * LD + ty * RM]);
      const float4 b = *reinterpret_cast<const float4*>(&kv[c * LD + tx * CN]);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      const float bv[CN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each row (pallas_attention.py
    // :96-121): m' = max(m, rowmax s), c = exp(m - m'), l' = l c + rowsum p,
    // acc' = acc c + p v.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long qpos = (long long)q_off + q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = k0 + tx * CN + j;
        bool ok = col < tk;
        if (causal) ok = ok && qpos >= (long long)k_off + col;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = s[i][j] > NEG_INF * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * CN + j) * LD + ty * RM]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // kt is read; pt is written

    for (int e = tid; e < BK * D_MAX; e += THREADS) {
      const int j = e / D_MAX;
      const int c = e % D_MAX;
      kv[j * D_MAX + c] =
          (k0 + j < tk && c < d) ? to_f(vb[(long long)(k0 + j) * d + c]) : 0.f;
    }
    __syncthreads();

    // acc[i][0:4] holds columns 4 tx + (0..3), acc[i][4:8] columns
    // 64 + 4 tx + (0..3).
    const int kt_len = min(BK, tk - k0);
    for (int j = 0; j < kt_len; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pt[j * LD + ty * RM]);
      const float4 v0 = *reinterpret_cast<const float4*>(&kv[j * D_MAX + tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&kv[j * D_MAX + 64 + tx * 4]);
      const float pv[RM] = {p4.x, p4.y, p4.z, p4.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= tq) continue;
    const long long row = (long long)bh * tq + r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
      if (col < d) o[row * d + col] = acc[i][c];
    }
    if (tx == 0) {
      m_out[row] = m_i[i];
      l_out[row] = l_i[i];
    }
  }
}

template <typename Tkv>
int launch(const float* q, const void* k, const void* v, float* o, float* m,
           float* l, int bh, int tq, int tk, int d, int causal, int q_off,
           int k_off, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_flash_kernel<Tkv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((tq + BQ - 1) / BQ), (unsigned)bh);
  block_flash_kernel<Tkv><<<grid, THREADS, SMEM_BYTES, stream>>>(
      q, static_cast<const Tkv*>(k), static_cast<const Tkv*>(v), o, m, l, tq,
      tk, d, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 q, k, v: tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows of a forward / dQ block
constexpr int BK = 64;          // keys of a tile (and of a dK/dV block)
constexpr int BQB = 32;         // query rows of a dK/dV pass tile

// exp(x) for x <= 0 (a score minus its row max) as one MUFU.EX2 of
// x log2(e), relative error about 2^-22: expf's longer range reduction
// made the kernels measurably slower, since the softmax's ALU work competes
// with the MMAs on every tile.  A masked score gives exp(-1e30 - m) = 0
// exactly (ftz).
__device__ __forceinline__ float exp_le0(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// Depth padded to 16 KD (KD = 4: D <= 64; KD = 8: D <= 128).  A shared-
// memory row is padded by 8 elements (16 bytes), so the 8 row addresses of
// each ldmatrix fall in distinct banks.
template <int KD>
struct Dims {
  static constexpr int LD = 16 * KD + 8;
  static constexpr int TILE = BK * LD;   // elements of a 64-row tile
  static constexpr int HALF = BQB * LD;  // elements of a 32-row tile
  static constexpr int FWD_SMEM = 4 * TILE * 2;                 // K, V x 2
  static constexpr int KV_SMEM = (2 * TILE + 2 * 3 * HALF) * 2  // K, V;
                                 + 2 * 2 * BQB * 4;             // q,do x 2
  static constexpr int DQ_SMEM = 6 * TILE * 2;  // do hi, lo; K, V x 2
};

// Rows [row0, row0 + ROWS) of a [n_rows][d] bf16 array into a [ROWS][LD]
// shared tile, in VEC-element copies; rows past n_rows and the depth from d
// to 16 KD are zero-filled.
template <int KD, int VEC, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_rows, int d) {
  constexpr int LD = Dims<KD>::LD;
  constexpr int CPR = 16 * KD / VEC;  // copies per row
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR;
    const int c = (e % CPR) * VEC;
    const bool ok = row0 + r < n_rows && c < d;
    copy<VEC>(dst + r * LD + c, ok ? src + (long long)(row0 + r) * d + c : src,
              ok);
  }
}

// Two bf16 of one row (columns c, c + 1) packed as an MMA fragment register;
// zero past the row's end or for a missing row.
__device__ __forceinline__ uint32_t ld_pair(const bf16* row, int c, int d,
                                            bool row_ok) {
  const bf16 zero = __float2bfloat16(0.f);
  __nv_bfloat162 h;
  h.x = (row_ok && c < d) ? row[c] : zero;
  h.y = (row_ok && c + 1 < d) ? row[c + 1] : zero;
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments of the 16 rows [row0, row0 + 16) of a [n_rows][d] bf16
// array, over the whole padded depth, read from device memory.
template <int KD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KD][4],
                                             const bf16* base, int row0,
                                             int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
  const bf16* p0 = base + (long long)r0 * d;
  const bf16* p1 = base + (long long)r1 * d;
  const bool ok0 = r0 < n_rows, ok1 = r1 < n_rows;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * (lane & 3);
    f[kd][0] = ld_pair(p0, c, d, ok0);
    f[kd][1] = ld_pair(p1, c, d, ok1);
    f[kd][2] = ld_pair(p0, c + 8, d, ok0);
    f[kd][3] = ld_pair(p1, c + 8, d, ok1);
  }
}

// x, y (fp32) -> packed bf16 pairs hi and lo with x ~= hi.x + lo.x: x - hi
// is exact in fp32 and rounds once to lo.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The A fragments (hi and lo) of the k16 step over accumulator n8 tiles
// 2j and 2j + 1 (see sm90_mma.cuh for the layouts).
__device__ __forceinline__ void acc_to_a(const float (&t0)[4],
                                         const float (&t1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(t0[0], t0[1], hi[0], lo[0]);
  split2(t0[2], t0[3], hi[1], lo[1]);
  split2(t1[0], t1[1], hi[2], lo[2]);
  split2(t1[2], t1[3], hi[3], lo[3]);
}

// acc0 += t[0], acc1 += t[1] in fp32, and t = 0.  A long chain of MMAs
// accumulating into one register set loses accuracy: the tensor cores
// align each step's products to the running sum and truncate (at T 16384 a
// chain of 1,024 k16 steps put dk 3x outside the backward's tolerance), so
// every output tile sums one key (or query) tile's products from zero and
// adds them to its fp32 accumulator with round-to-nearest adds.
__device__ __forceinline__ void add_tile(float (&acc0)[4], float (&acc1)[4],
                                         float (&t)[2][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc0[e] += t[0][e];
    acc1[e] += t[1][e];
    t[0][e] = t[1][e] = 0.f;
  }
}

// ldmatrix addresses (bytes, shared space) of this lane, relative to a
// tile's row `r0`, for a [rows][LD] bf16 tile at `t`:
//   a_addr: A fragments of rows r0..r0+15, k from column `col`;
//   bn_addr: B fragments of two n8 tiles stored [n][k] (n from r0);
//   bt_addr: B fragments of two n8 tiles stored [k][n] (k from r0, n from
//     column `col`).
template <int KD>
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int r0, int col) {
  const int lane = threadIdx.x & 31;
  return smem_addr(t + (r0 + (lane & 15)) * Dims<KD>::LD + col + (lane >> 4) * 8);
}
template <int KD>
__device__ __forceinline__ uint32_t bn_addr(const bf16* t, int r0, int col) {
  const int lane = threadIdx.x & 31;
  return smem_addr(t + (r0 + (lane & 7) + (lane >> 4) * 8) * Dims<KD>::LD +
                   col + ((lane >> 3) & 1) * 8);
}
template <int KD>
__device__ __forceinline__ uint32_t bt_addr(const bf16* t, int r0, int col) {
  const int lane = threadIdx.x & 31;
  return smem_addr(t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Dims<KD>::LD +
                   col + (lane >> 4) * 8);
}

// Keys [0, k_end) can be visible to some query of rows [q0, q0 + rows).
__device__ __forceinline__ int key_end(int tk, int causal, int q_off, int q0,
                                       int rows, int k_off) {
  if (!causal) return tk;
  const long long lim = (long long)q_off + q0 + rows - k_off;
  return (int)max(0LL, min((long long)tk, lim));
}

// Whether any (query, key) pair of rows [q0, q0 + nq) x keys [k0, k0 + nk)
// is masked: a tail or a tile crossing the causal diagonal.
__device__ __forceinline__ bool tile_edge(int q0, int nq, int tq, int k0,
                                          int nk, int tk, int causal,
                                          int q_off, int k_off) {
  return q0 + nq > tq || k0 + nk > tk ||
         (causal && (long long)q_off + q0 < (long long)k_off + k0 + nk - 1);
}

__device__ __forceinline__ bool visible(int i, int j, int tq, int tk,
                                        int causal, int q_off, int k_off) {
  return i < tq && j < tk &&
         (!causal || (long long)q_off + i >= (long long)k_off + j);
}

// S = q k^T over one 64-key tile for this warp's 16 rows: s[n8 tile][4].
template <int KD>
__device__ __forceinline__ void qk_tile(float (&s)[8][4],
                                        const uint32_t (&qf)[KD][4],
                                        const bf16* kt) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bn_addr<KD>(kt, np * 16, kd * 16));
      mma(s[2 * np], qf[kd], b[0], b[1]);
      mma(s[2 * np + 1], qf[kd], b[2], b[3]);
    }
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------
template <int KD, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    block_flash_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int tq, int tk, int d,
                           int causal, int q_off, int k_off, float scale) {
  using Dm = Dims<KD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][TILE]
  bf16* vs = ks + 2 * Dm::TILE;                   // [2][TILE]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const bf16* kb = k + (long long)bh * tk * d;
  const bf16* vb = v + (long long)bh * tk * d;
  const int k_end = key_end(tk, causal, q_off, q0, min(BQ, tq - q0), k_off);
  const int n_tiles = (k_end + BK - 1) / BK;

  if (n_tiles > 0) {
    load_tile<KD, VEC, BK>(ks, kb, 0, tk, d);
    load_tile<KD, VEC, BK>(vs, vb, 0, tk, d);
    cp_async_commit();
  }
  const int wr = q0 + warp * 16;  // this warp's first row
  uint32_t qf[KD][4];
  if (n_tiles > 0) load_a_frags<KD>(qf, q + (long long)bh * tq * d, wr, tq, d);

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<KD, VEC, BK>(ks + (st ^ 1) * Dm::TILE, kb, (t + 1) * BK, tk, d);
      load_tile<KD, VEC, BK>(vs + (st ^ 1) * Dm::TILE, vb, (t + 1) * BK, tk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * Dm::TILE;
    const bf16* vt = vs + st * Dm::TILE;
    const int k0 = t * BK;

    float s[8][4];
    qk_tile<KD>(s, qf, kt);
    const bool edge = tile_edge(q0, BQ, tq, k0, BK, tk, causal, q_off, k_off);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge && !visible(wr + g + (e >> 1) * 8, k0 + n * 8 + c2 + (e & 1),
                             tq, tk, causal, q_off, k_off))
          x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // Online softmax (pallas_attention.py:96-121): m' = max(m, rowmax s),
    // c = exp(m - m'), l' = l c + rowsum p, acc' = acc c + p v.
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = exp_le0(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x > NEG_INF * 0.5f ? exp_le0(x - m_r[e >> 1]) : 0.f;
        s[n][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + ls[r];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += (P_hi + P_lo) V, P's A fragments straight from s; the tile's
    // products are summed from zero and added to acc in fp32 (add_tile).
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_to_a(s[2 * j], s[2 * j + 1], ph[j], pl[j]);
#pragma unroll
    for (int np = 0; np < KD; ++np) {
      float t[2][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_addr<KD>(vt, j * 16, np * 16));
        mma(t[0], ph[j], b[0], b[1]);
        mma(t[0], pl[j], b[0], b[1]);
        mma(t[1], ph[j], b[2], b[3]);
        mma(t[1], pl[j], b[2], b[3]);
      }
      add_tile(acc[2 * np], acc[2 * np + 1], t);
    }
    __syncthreads();  // this stage is read before tile t + 2 lands in it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = wr + g + r * 8;
    if (row >= tq) continue;
    const long long ri = (long long)bh * tq + row;
    float* orow = o + ri * d;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      const int col = n * 8 + c2;
      if (col < d) orow[col] = acc[n][2 * r];
      if (col + 1 < d) orow[col + 1] = acc[n][2 * r + 1];
    }
    if ((lane & 3) == 0) {
      m_out[ri] = m_r[r];
      l_out[ri] = l_r[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// do -> its bf16 hi and lo parts (n elements).
__global__ void block_flash_split_kernel(const float* __restrict__ x,
                                         bf16* __restrict__ hi,
                                         bf16* __restrict__ lo, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    const bf16 h = __float2bfloat16(v);
    hi[i] = h;
    lo[i] = __float2bfloat16(v - __bfloat162float(h));
  }
}

// (a) dK and dV of one 64-key tile; warp w owns keys 16w .. 16w + 15.
template <int KD, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    block_flash_bwd_kv_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ do_hi,
        const bf16* __restrict__ do_lo, const float* __restrict__ m,
        const float* __restrict__ dl, float* __restrict__ dk,
        float* __restrict__ dv, int tq, int tk, int d, int causal, int q_off,
        int k_off, float scale) {
  using Dm = Dims<KD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Dm::TILE;
  bf16* stage0 = vs + Dm::TILE;  // per stage: q, do hi, do lo [32][LD]
  float* mf0 = reinterpret_cast<float*>(stage0 + 2 * 3 * Dm::HALF);  // m, dl

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // key tile 0, the heaviest, first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const long long qbase = (long long)bh * tq;
  const bf16* qb = q + qbase * d;
  const bf16* hb = do_hi + qbase * d;
  const bf16* lb = do_lo + qbase * d;
  // The first query that sees key k0.
  int q_start = 0;
  if (causal)
    q_start = (int)max(0LL, min((long long)tq, (long long)k_off + k0 - q_off));
  const int t_first = q_start / BQB;
  const int t_end = q_start < tq ? (tq + BQB - 1) / BQB : t_first;

  auto load_stage = [&](int s, int t) {
    bf16* base = stage0 + s * 3 * Dm::HALF;
    const int r0 = t * BQB;
    load_tile<KD, VEC, BQB>(base, qb, r0, tq, d);
    load_tile<KD, VEC, BQB>(base + Dm::HALF, hb, r0, tq, d);
    load_tile<KD, VEC, BQB>(base + 2 * Dm::HALF, lb, r0, tq, d);
    float* mf = mf0 + s * 2 * BQB;
    for (int i = threadIdx.x; i < BQB; i += THREADS) {
      const bool ok = r0 + i < tq;
      mf[i] = ok ? m[qbase + r0 + i] : 0.f;
      mf[BQB + i] = ok ? dl[qbase + r0 + i] : 0.f;
    }
  };
  if (t_first < t_end) {
    load_tile<KD, VEC, BK>(ks, k + (long long)bh * tk * d, k0, tk, d);
    load_tile<KD, VEC, BK>(vs, v + (long long)bh * tk * d, k0, tk, d);
    load_stage(0, t_first);
    cp_async_commit();
  }

  float dka[2 * KD][4], dva[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int wk = k0 + warp * 16;  // this warp's first key

  for (int t = t_first; t < t_end; ++t) {
    const int st = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_stage(st ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stage0 + st * 3 * Dm::HALF;
    const bf16* hs = qs + Dm::HALF;
    const bf16* lsm = qs + 2 * Dm::HALF;
    const float* mf = mf0 + st * 2 * BQB;
    const int qb0 = t * BQB;

    // S^T = K q^T and dP^T = V (do_hi + do_lo)^T: 16 keys x 32 queries.
    float sT[4][4], dpT[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_addr<KD>(ks, warp * 16, kd * 16));
      ldsm_x4(av, a_addr<KD>(vs, warp * 16, kd * 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4], bh_[4], bl[4];
        ldsm_x4(b, bn_addr<KD>(qs, np * 16, kd * 16));
        ldsm_x4(bh_, bn_addr<KD>(hs, np * 16, kd * 16));
        ldsm_x4(bl, bn_addr<KD>(lsm, np * 16, kd * 16));
        mma(sT[2 * np], ak, b[0], b[1]);
        mma(sT[2 * np + 1], ak, b[2], b[3]);
        mma(dpT[2 * np], av, bh_[0], bh_[1]);
        mma(dpT[2 * np], av, bl[0], bl[1]);
        mma(dpT[2 * np + 1], av, bh_[2], bh_[3]);
        mma(dpT[2 * np + 1], av, bl[2], bl[3]);
      }
    }
    // P^T = exp(s - m) under the mask and guard; dS^T = P^T (dP^T + dl).
    const bool edge = tile_edge(qb0, BQB, tq, k0, BK, tk, causal, q_off, k_off);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + c2 + (e & 1);
        float x = sT[n][e] * scale;
        if (edge && !visible(qb0 + qc, wk + g + (e >> 1) * 8, tq, tk, causal,
                             q_off, k_off))
          x = NEG_INF;
        const float p = x > NEG_INF * 0.5f ? exp_le0(x - mf[qc]) : 0.f;
        sT[n][e] = p;
        dpT[n][e] = p * (dpT[n][e] + mf[BQB + qc]);
      }
    // dv += P^T do (hi x hi, lo x hi, hi x lo); dk += dS^T q; each q
    // tile's products summed from zero, then added in fp32 (add_tile).
    uint32_t ph[2][4], pl[2][4], sh[2][4], sl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc_to_a(sT[2 * j], sT[2 * j + 1], ph[j], pl[j]);
      acc_to_a(dpT[2 * j], dpT[2 * j + 1], sh[j], sl[j]);
    }
#pragma unroll
    for (int np = 0; np < KD; ++np) {
      float t[2][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bh_[4], bl[4];
        ldsm_x4_trans(bh_, bt_addr<KD>(hs, j * 16, np * 16));
        ldsm_x4_trans(bl, bt_addr<KD>(lsm, j * 16, np * 16));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(t[h], ph[j], bh_[2 * h], bh_[2 * h + 1]);
          mma(t[h], pl[j], bh_[2 * h], bh_[2 * h + 1]);
          mma(t[h], ph[j], bl[2 * h], bl[2 * h + 1]);
        }
      }
      add_tile(dva[2 * np], dva[2 * np + 1], t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, bt_addr<KD>(qs, j * 16, np * 16));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(t[h], sh[j], bq[2 * h], bq[2 * h + 1]);
          mma(t[h], sl[j], bq[2 * h], bq[2 * h + 1]);
        }
      }
      add_tile(dka[2 * np], dka[2 * np + 1], t);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wk + g + r * 8;
    if (key >= tk) continue;
    const long long ri = ((long long)bh * tk + key) * d;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      const int col = n * 8 + c2;
      if (col < d) {
        dk[ri + col] = dka[n][2 * r] * scale;
        dv[ri + col] = dva[n][2 * r];
      }
      if (col + 1 < d) {
        dk[ri + col + 1] = dka[n][2 * r + 1] * scale;
        dv[ri + col + 1] = dva[n][2 * r + 1];
      }
    }
  }
}

// (b) dQ of one 64-row q tile; warp w owns rows 16w .. 16w + 15.
template <int KD, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
    block_flash_bwd_q_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ do_hi,
        const bf16* __restrict__ do_lo, const float* __restrict__ m,
        const float* __restrict__ dl, float* __restrict__ dq, int tq, int tk,
        int d, int causal, int q_off, int k_off, float scale) {
  using Dm = Dims<KD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // do hi [64][LD]
  bf16* lsm = hs + Dm::TILE;                      // do lo
  bf16* ks = lsm + Dm::TILE;                      // [2][TILE]
  bf16* vs = ks + 2 * Dm::TILE;                   // [2][TILE]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const long long qbase = (long long)bh * tq;
  const bf16* kb = k + (long long)bh * tk * d;
  const bf16* vb = v + (long long)bh * tk * d;
  const int k_end = key_end(tk, causal, q_off, q0, min(BQ, tq - q0), k_off);
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wr = q0 + warp * 16;

  if (n_tiles > 0) {
    load_tile<KD, VEC, BQ>(hs, do_hi + qbase * d, q0, tq, d);
    load_tile<KD, VEC, BQ>(lsm, do_lo + qbase * d, q0, tq, d);
    load_tile<KD, VEC, BK>(ks, kb, 0, tk, d);
    load_tile<KD, VEC, BK>(vs, vb, 0, tk, d);
    cp_async_commit();
  }
  uint32_t qf[KD][4];
  float m_r[2], dl_r[2];
  if (n_tiles > 0) {
    load_a_frags<KD>(qf, q + qbase * d, wr, tq, d);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g + r * 8;
      m_r[r] = row < tq ? m[qbase + row] : 0.f;
      dl_r[r] = row < tq ? dl[qbase + row] : 0.f;
    }
  }

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<KD, VEC, BK>(ks + (st ^ 1) * Dm::TILE, kb, (t + 1) * BK, tk, d);
      load_tile<KD, VEC, BK>(vs + (st ^ 1) * Dm::TILE, vb, (t + 1) * BK, tk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * Dm::TILE;
    const bf16* vt = vs + st * Dm::TILE;
    const int k0 = t * BK;

    float s[8][4], dp[8][4];
    qk_tile<KD>(s, qf, kt);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    // dP = (do_hi + do_lo) V^T.
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, a_addr<KD>(hs, warp * 16, kd * 16));
      ldsm_x4(al, a_addr<KD>(lsm, warp * 16, kd * 16));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<KD>(vt, np * 16, kd * 16));
        mma(dp[2 * np], ah, b[0], b[1]);
        mma(dp[2 * np], al, b[0], b[1]);
        mma(dp[2 * np + 1], ah, b[2], b[3]);
        mma(dp[2 * np + 1], al, b[2], b[3]);
      }
    }
    const bool edge = tile_edge(q0, BQ, tq, k0, BK, tk, causal, q_off, k_off);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge && !visible(wr + g + (e >> 1) * 8, k0 + n * 8 + c2 + (e & 1),
                             tq, tk, causal, q_off, k_off))
          x = NEG_INF;
        const float p = x > NEG_INF * 0.5f ? exp_le0(x - m_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] + dl_r[e >> 1]);  // dS
      }
    // dq += (dS_hi + dS_lo) K, the tile's products summed from zero and
    // added in fp32 (add_tile).
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_to_a(s[2 * j], s[2 * j + 1], sh[j], sl[j]);
#pragma unroll
    for (int np = 0; np < KD; ++np) {
      float t[2][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_addr<KD>(kt, j * 16, np * 16));
        mma(t[0], sh[j], b[0], b[1]);
        mma(t[0], sl[j], b[0], b[1]);
        mma(t[1], sh[j], b[2], b[3]);
        mma(t[1], sl[j], b[2], b[3]);
      }
      add_tile(acc[2 * np], acc[2 * np + 1], t);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + r * 8;
    if (row >= tq) continue;
    float* out = dq + (qbase + row) * d;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      const int col = n * 8 + c2;
      if (col < d) out[col] = acc[n][2 * r] * scale;
      if (col + 1 < d) out[col + 1] = acc[n][2 * r + 1] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
struct Args {
  const bf16 *q, *k, *v, *do_hi, *do_lo;
  const float *m, *dl;
  float *o, *m_out, *l_out, *dq, *dk, *dv;
  int bh, tq, tk, d, causal, q_off, k_off;
  float scale;
  cudaStream_t stream;
};

template <int KD, int VEC>
int fwd(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = opt_in_smem(block_flash_fwd_kernel<KD, VEC>,
                                Dims<KD>::FWD_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.bh, (unsigned)((a.tq + BQ - 1) / BQ));
  block_flash_fwd_kernel<KD, VEC>
      <<<grid, THREADS, Dims<KD>::FWD_SMEM, a.stream>>>(
      a.q, a.k, a.v, a.o, a.m_out, a.l_out, a.tq, a.tk, a.d, a.causal, a.q_off,
      a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int KD, int VEC>
int bwd(const Args& a) {
  static std::atomic<unsigned long long> kv_set{0}, q_set{0};
  cudaError_t err = opt_in_smem(block_flash_bwd_kv_kernel<KD, VEC>,
                                Dims<KD>::KV_SMEM, kv_set);
  if (err == cudaSuccess)
    err = opt_in_smem(block_flash_bwd_q_kernel<KD, VEC>, Dims<KD>::DQ_SMEM,
                      q_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)a.bh, (unsigned)((a.tk + BK - 1) / BK));
  if (a.tk > 0) {
    block_flash_bwd_kv_kernel<KD, VEC>
        <<<kv_grid, THREADS, Dims<KD>::KV_SMEM, a.stream>>>(
        a.q, a.k, a.v, a.do_hi, a.do_lo, a.m, a.dl, a.dk, a.dv, a.tq, a.tk,
        a.d, a.causal, a.q_off, a.k_off, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 q_grid((unsigned)a.bh, (unsigned)((a.tq + BQ - 1) / BQ));
  block_flash_bwd_q_kernel<KD, VEC>
      <<<q_grid, THREADS, Dims<KD>::DQ_SMEM, a.stream>>>(
      a.q, a.k, a.v, a.do_hi, a.do_lo, a.m, a.dl, a.dq, a.tq, a.tk, a.d,
      a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// Copy width (elements) that D and every operand's alignment allow.
int vec_width(const Args& a, bool backward) {
  const void* ptrs[5] = {a.k, a.v, a.q, a.do_hi, a.do_lo};
  const int n = backward ? 5 : 2;
  for (int vec : {8, 4}) {
    bool ok = a.d % vec == 0;
    for (int i = 0; i < n; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (2 * vec) == 0;
    if (ok) return vec;
  }
  return 1;
}

template <int KD>
int dispatch_vec(const Args& a, bool backward) {
  switch (vec_width(a, backward)) {
    case 8: return backward ? bwd<KD, 8>(a) : fwd<KD, 8>(a);
    case 4: return backward ? bwd<KD, 4>(a) : fwd<KD, 4>(a);
    default: return backward ? bwd<KD, 1>(a) : fwd<KD, 1>(a);
  }
}

int dispatch(const Args& a, bool backward) {
  return a.d <= 64 ? dispatch_vec<4>(a, backward) : dispatch_vec<8>(a, backward);
}

}  // namespace tc

}  // namespace

extern "C" {

// Largest head dimension the kernels take.
int block_flash_max_d() { return simt::D_MAX; }

// Launches K3 on `stream`; returns the cudaGetLastError() code after the
// launch (0 = success).  Tensors are contiguous: q [bh, tq, d], k and v
// [bh, tk, d], o [bh, tq, d] fp32, m and l [bh, tq] fp32.  `kind`: 0 = q
// fp32 (scaled) and k, v fp32; 1 = q fp32 (scaled) and k, v bf16 (both on
// the CUDA cores); 2 = q, k and v bf16, unscaled q, `scale` applied to the
// scores (tensor cores).  1 <= d <= block_flash_max_d(); bh <= 65535 for
// kinds 0 and 1; at most 65535 tiles of 64 rows in Tq.
int block_flash_launch(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, int bh, int tq, int tk, int d,
                       int kind, int causal, int q_off, int k_off, float scale,
                       void* stream) {
  if (bh <= 0 || tq <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > simt::D_MAX || tk < 0 || (tq + 63) / 64 > 65535 ||
      kind < 0 || kind > 2 || (kind < 2 && bh > 65535))
    return (int)cudaErrorInvalidValue;
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    tc::Args a{};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.o = of;
    a.m_out = mf;
    a.l_out = lf;
    a.bh = bh; a.tq = tq; a.tk = tk; a.d = d;
    a.causal = causal; a.q_off = q_off; a.k_off = k_off;
    a.scale = scale;
    a.stream = st;
    return tc::dispatch(a, false);
  }
  const float* qf = static_cast<const float*>(q);
  if (kind == 1)
    return simt::launch<__nv_bfloat16>(qf, k, v, of, mf, lf, bh, tq, tk, d,
                                       causal, q_off, k_off, st);
  return simt::launch<float>(qf, k, v, of, mf, lf, bh, tq, tk, d, causal,
                             q_off, k_off, st);
}

// Launches K3's backward (bf16 q, k, v) on `stream`: splits do [bh, tq, d]
// fp32 into do_hi and do_lo (bf16 scratch of the same shape), then the
// dK/dV and dQ passes; dq [bh, tq, d], dk and dv [bh, tk, d] are written in
// fp32.  m and dl are [bh, tq] fp32.  Returns the first cudaGetLastError()
// code that is not 0, else 0.
int block_flash_bwd_launch(const void* q, const void* k, const void* v,
                           const void* d_o, const void* m, const void* dl,
                           void* do_hi, void* do_lo, void* dq, void* dk,
                           void* dv, int bh, int tq, int tk, int d, int causal,
                           int q_off, int k_off, float scale, void* stream) {
  if (bh <= 0 || (tq <= 0 && tk <= 0)) return (int)cudaSuccess;
  if (d <= 0 || d > simt::D_MAX || tq < 0 || tk < 0 ||
      (tq + 63) / 64 > 65535 || (tk + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tc::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.do_hi = static_cast<__nv_bfloat16*>(do_hi);
  a.do_lo = static_cast<__nv_bfloat16*>(do_lo);
  a.m = static_cast<const float*>(m);
  a.dl = static_cast<const float*>(dl);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.bh = bh; a.tq = tq; a.tk = tk; a.d = d;
  a.causal = causal; a.q_off = q_off; a.k_off = k_off;
  a.scale = scale;
  a.stream = st;
  if (tq <= 0) {  // no query: dk = dv = 0
    const size_t bytes = (size_t)bh * tk * d * sizeof(float);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return (int)err;
  }
  const long long n = (long long)bh * tq * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  tc::block_flash_split_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(d_o), static_cast<__nv_bfloat16*>(do_hi),
      static_cast<__nv_bfloat16*>(do_lo), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return tc::dispatch(a, true);
}

const char* block_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
