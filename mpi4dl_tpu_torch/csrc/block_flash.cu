// Block flash attention for Hopper (sm_90a): kernel K3 of the PyTorch port,
// bound to Python through ctypes (mpi4dl_tpu_torch/ops/flash_attention.py).
//
// K3 replaces mpi4dl_tpu/ops/pallas_attention.py::_kernel (launched by the
// pallas_call at pallas_attention.py:165).  For one attention block it
// returns the UNNORMALISED flash state, all fp32:
//     s     = q k^T              (q arrives scaled and in fp32)
//     m     = rowmax(s)          [BH, Tq]
//     o_hat = exp(s - m) v       [BH, Tq, D]
//     l     = rowsum(exp(s - m)) [BH, Tq]
// Masked scores are -1e30 (never -inf): keys past Tk, and under `causal`
// every key whose GLOBAL position k_off + j exceeds the query's q_off + i.
// A score counts only where s > -1e30 / 2, so a fully masked row gives
// p = 0 and (o_hat, m, l) = (0, -1e30, 0), the identity of the ring merge.
// q_off and k_off are runtime arguments: one build serves every ring hop.
//
// Bound on an H100 SXM: the contract is fp32 arithmetic (TF32 off), so the
// FLOPs (4 BH Tq Tk D, about half of it under the causal mask) run on the
// CUDA cores at 67 TFLOP/s; bytes are q, k, v read once and o_hat, m, l
// written once.  At the long-context shapes (BH = 8, D = 128, T = 4096 and
// up) the kernel is operation-bound by two to three orders of magnitude.
//
// Design (first version: right and simple, not yet fast):
//   * the TPU grid (BH, q tiles, k tiles) keeps its accumulators in scratch
//     across the innermost k dimension; blocks on the H100 run in no order,
//     so the k dimension becomes a loop inside the block: one block of 256
//     threads per (bh, 64-row q tile) keeps acc, m and l in registers;
//   * each thread owns 4 query rows x 4 keys of the 64x64 score tile and
//     the same 4 rows x 8 columns of the output; a row's 16 threads share
//     its max and sum through warp shuffles;
//   * the q tile (transposed), one k or v tile and the p tile (transposed)
//     live in shared memory, fp32 (bf16 k and v are converted on load;
//     the conversion is exact); K and V take turns in one buffer, so the
//     block needs 87,040 B of dynamic shared memory (opted in above 48 KB)
//     and two blocks fit on an SM;
//   * D is a runtime value up to 128: loads past D read zeros and the
//     product loop stops at D, so no padding to 128 lanes and no rounding
//     of Tq to 8 (TPU layout rules) carry over;
//   * causal skip: the key loop stops at the block's last visible key.  A
//     skipped tile would be masked for every row of the block and leave m,
//     l and acc exactly as they were, so the skip is exact.
// Tensor-core (mma.sync / wgmma) tiles and TMA loads are later work;
// PERF.md holds this version's measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

}  // namespace

extern "C" {

// Largest head dimension the kernel takes.
int block_flash_max_d() { return D_MAX; }

// Launches K3 on `stream`; returns the cudaGetLastError() code after the
// launch (0 = success).  Tensors are contiguous: q [bh, tq, d] fp32 (scaled),
// k and v [bh, tk, d] of one type (0 = float32, 1 = bfloat16), o [bh, tq, d],
// m and l [bh, tq] fp32.  1 <= d <= block_flash_max_d(), bh <= 65535.
int block_flash_launch(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, int bh, int tq, int tk, int d,
                       int kv_bf16, int causal, int q_off, int k_off,
                       void* stream) {
  if (bh <= 0 || tq <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > D_MAX || bh > 65535 || tk < 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(qf, k, v, of, mf, lf, bh, tq, tk, d, causal,
                                 q_off, k_off, st);
  return launch<float>(qf, k, v, of, mf, lf, bh, tq, tk, d, causal, q_off,
                       k_off, st);
}

const char* block_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
