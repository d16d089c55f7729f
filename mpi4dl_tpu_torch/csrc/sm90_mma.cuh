// Tensor-core building blocks shared by the port's sm_90a kernels
// (halo_conv.cu, block_flash.cu): cp.async copies into shared memory,
// ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 with fp32
// accumulation, the once-per-device opt-in to dynamic shared memory, the
// launch-table row each library's exported query returns, and the log of
// the kernels a library launched.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32,
// g = lane / 4, c = 2 * (lane % 4)):
//   C/D (16x8 fp32): c[0], c[1] at row g, columns c, c+1; c[2], c[3] at
//     row g+8, the same columns.
//   A (16x16 bf16, row-major): a[0] row g, k c..c+1; a[1] row g+8, k c..;
//     a[2] row g, k c+8..; a[3] row g+8, k c+8.. .  So the C fragments of
//     two neighbouring n8 tiles, packed to bf16 pairs, are the A fragment of
//     a k16 step over those 16 columns (the flash kernels' P and dS).
//   B (16x8 bf16, "col"): b[0] k c..c+1 at column g; b[1] k c+8.. .
// ldsm_x4 of a [rows][k] tile gives A fragments, or the B fragments of two
// n8 tiles stored [n][k]; ldsm_x4_trans gives B fragments of a tile stored
// [k][n].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One VEC-element copy into shared memory; !ok writes zeros.
template <int VEC>
__device__ __forceinline__ void copy(__nv_bfloat16* dst,
                                     const __nv_bfloat16* src, bool ok) {
  if constexpr (VEC == 1) {
    *dst = ok ? *src : __float2bfloat16(0.f);
  } else {
    const int sz = ok ? VEC * 2 : 0;  // src-size 0: zero fill, nothing read
    if constexpr (VEC == 8) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src), "r"(sz));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                       smem_addr(dst)),
                   "l"(src), "n"(VEC * 2), "r"(sz));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Opts `kernel` into its dynamic shared memory on the current device unless
// bit d of `done` says it is done there; sets the bit.
template <typename K>
cudaError_t opt_in_smem(K kernel, int bytes,
                        std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// One row of a library's launch table: a kernel the library launches, the
// threads and minimum blocks of its __launch_bounds__ (0: none stated) and
// the dynamic shared memory its launch requests.  Each library exports
// <name>_launch_table over its rows (launch_table_row below), which the
// kernel certifier (mpi4dl_tpu_torch/analysis/pallascheck) reads.
struct LaunchRow {
  const void* fn;
  int threads;
  int min_blocks;
  int dyn_smem;
};

// Row i of `rows` (n of them): i < 0 returns n and touches nothing; else the
// row's mangled symbol, threads, minimum blocks, dynamic shared memory and
// the blocks an SM holds at that request, returning a cudaError_t code (0 =
// success, cudaErrorInvalidValue for an i past the end).
inline int launch_table_row(const LaunchRow* rows, int n, int i, const char** symbol,
                            int* threads, int* min_blocks, int* dyn_smem,
                            int* blocks_per_sm) {
  if (i < 0) return n;
  if (i >= n) return (int)cudaErrorInvalidValue;
  const LaunchRow& r = rows[i];
  *threads = r.threads;
  *min_blocks = r.min_blocks;
  *dyn_smem = r.dyn_smem;
  cudaError_t err = cudaFuncGetName(symbol, r.fn);
  if (err == cudaSuccess && r.dyn_smem > 48 * 1024)
    err = cudaFuncSetAttribute(r.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               r.dyn_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, r.fn, r.threads,
                                                        (size_t)r.dyn_smem);
  return (int)err;
}

// The kernels a library launched since the log was last cleared, each
// noted once: every launch site calls note_launch before its launch, and
// the library exports <name>_launch_log (launch_log_row below) and
// <name>_launch_log_clear, from which the kernel certifier learns which
// kernels a call launches.  A race between two launching threads may note
// a kernel twice; readers take the entries as a set.
struct LaunchLog {
  static constexpr int CAP = 64;
  std::atomic<const void*> fn[CAP];
  std::atomic<int> n;
};

inline void note_launch(LaunchLog& log, const void* fn) {
  const int n = log.n.load(std::memory_order_acquire);
  for (int i = 0; i < n && i < LaunchLog::CAP; ++i)
    if (log.fn[i].load(std::memory_order_relaxed) == fn) return;
  const int i = log.n.fetch_add(1, std::memory_order_acq_rel);
  if (i < LaunchLog::CAP) log.fn[i].store(fn, std::memory_order_release);
}

inline void clear_launch_log(LaunchLog& log) {
  log.n.store(0, std::memory_order_release);
}

// Entry i of `log`: i < 0 returns the number of entries and touches
// nothing; else the entry's mangled symbol, returning a cudaError_t code
// (cudaErrorInvalidValue for an i past the end).
inline int launch_log_row(const LaunchLog& log, int i, const char** symbol) {
  const int n = log.n.load(std::memory_order_acquire);
  const int rows = n < LaunchLog::CAP ? n : LaunchLog::CAP;
  if (i < 0) return rows;
  if (i >= rows) return (int)cudaErrorInvalidValue;
  const void* fn = log.fn[i].load(std::memory_order_acquire);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncGetName(symbol, fn);
}

}  // namespace sm90
