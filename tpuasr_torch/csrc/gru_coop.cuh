// Shared pieces of the cooperative GRU kernels (csrc/gru_bidir.cu: the
// float32 forward recurrence of K5, K2's f32 recurrence and K7's f32
// forward; csrc/gru_lean.cu: the lean BPTT recurrence of K2b, K5b and K7b;
// csrc/gru_scan.cu: K2, K4 and K7's bf16 forward): the block shape, the
// group barrier of a cooperative launch, cp.async staging, the bf16
// tensor-core product and ldmatrix, the warps' reduce-scatter and the
// occupancy-checked cooperative launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 16;                  // batch rows per staged pass
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may take (the H100 allows 227 KB).
constexpr size_t kSmemBudget = 220 * 1024;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The `members` blocks of a group of a cooperative launch meet here for
// the n-th time (n from 1). *count (zeroed before the launch) counts every
// arrival of the group, so the n-th meeting is complete when it reaches
// n * members: the last block's arrival itself releases the others. Thread
// 0 arrives with a release add at GPU scope, which carries its block's
// writes (made visible to it by __syncthreads), and polls with acquire
// loads, so the writes of every block that arrived are visible to it --
// and, after the second __syncthreads, to its whole block.
__device__ void group_sync(unsigned* count, unsigned n, unsigned members) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(count) : "memory");
    const unsigned target = n * members;
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes global -> shared without registers, through L2 (cp.async.cg:
// other blocks wrote them); zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are
// pending (a __syncthreads must follow before other threads read them).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Commits and waits for all of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait() {
  cp_async_commit();
  cp_async_wait_group<0>();
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, col), on
// the tensor cores: exact products, f32 sums. Fragments as mma.sync
// m16n8k16 lays them out: lane (g, c) = (lane / 4, lane % 4) holds a's rows
// g and g + 8 at k 2c, 2c+1 (a[0], a[1]) and 2c+8, 2c+9 (a[2], a[3]), b's
// column g at the same k (b[0], b[1]), and d's rows g and g + 8 at columns
// 2c, 2c+1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices from shared memory, one register each (lanes
// 8i .. 8i+7 give matrix i's row addresses); with trans, each transposed
// (lane (g, c) then holds rows 2c, 2c+1 of column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Sum of v over the 32 lanes of the warp, scattered: v holds kR groups of
// G values (row-major); afterwards lane l holds the sums of row l >> 1 in
// v[0 .. G-1]. Each halving step keeps one half and adds the partner's.
template <int N, int G, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (N > G) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    reduce_scatter<N / 2, G, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < G; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
}

// Cooperative launch: every block must be resident for the grid barrier.
int launch_cooperative(const void* kernel, int grid, size_t smem,
                       void** args, cudaStream_t stream) {
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm * nsm < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TPUASR_BY_UNITS(CALL)                                                  \
  switch (U) {                                                                 \
    case 1: return CALL(1);                                                    \
    case 2: return CALL(2);                                                    \
    case 4: return CALL(4);                                                    \
    case 8: return CALL(8);                                                    \
    case 16: return CALL(16);                                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);                   \
  }
