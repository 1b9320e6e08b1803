// Shared pieces of the cooperative GRU kernels (csrc/gru_bptt.cu: K5;
// csrc/gru_bidir.cu: K7's f32 forward; csrc/gru_lean.cu: the lean BPTT
// recurrence of K2b, K5b and K7b; csrc/gru_scan.cu: K2, K4): the block
// shape, the grid barrier (and a group's, for row groups), cp.async
// staging, the warps' reduce-scatter, the occupancy-checked cooperative
// launch, and K5's forward kernel with its row staging and per-unit
// products, which K2's float32 recurrence launches too. See gru_bptt.cu
// for K5's design.
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

// All blocks of a cooperative launch meet here for the n-th time.
__device__ void grid_sync(unsigned* count, unsigned n) {
  group_sync(count, n, gridDim.x);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows b0 .. b0+kR-1 of a (B, n) row-major array into dst[kR][n], bypassing
// L1; rows past B (and every row when src is null) become zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int b0, int B, int n) {
  const int rows = src ? min(kR, B - b0) : 0;
  const int total = kR * n;
  const int have = rows * n;
  const float* s = src ? src + static_cast<size_t>(b0) * n : nullptr;
  if ((n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < total / 4; i += kThreads) {
      d4[i] = 4 * i < have ? __ldcg(s4 + i)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      dst[i] = i < have ? __ldcg(s + i) : 0.f;
    }
  }
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

// The [r, z, n, 0] column vectors of units u0 .. u0+U-1 of Wh (H, 3H) as
// wcol[U][H] (zero past H).
template <int U>
__device__ void load_columns(float4* wcol, const float* wh, int H, int u0) {
  const int H3 = 3 * H;
  for (int i = threadIdx.x; i < H * U; i += kThreads) {
    const int u = i / H;
    const int k = i - u * H;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + u < H) {
      const float* p = wh + static_cast<size_t>(k) * H3 + u0 + u;
      v = make_float4(p[0], p[H], p[2 * H], 0.f);
    }
    wcol[i] = v;
  }
}

// hp of the staged rows for the block's units: warp w takes unit w % U and
// the w / U-th slice of the H contraction indices; its partial sums land in
// red[w][kR][3].
template <int U>
__device__ __forceinline__ void rows_times_columns(const float* hs,
                                                   const float4* wcol,
                                                   float* red, int H) {
  constexpr int kP = kWarps / U;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = warp % U;
  const int span = (H + kP - 1) / kP;
  const int k0 = (warp / U) * span;
  const int k1 = min(H, k0 + span);
  float acc[kR * 3];
#pragma unroll
  for (int i = 0; i < kR * 3; ++i) acc[i] = 0.f;
  for (int k = k0 + lane; k < k1; k += 32) {
    const float4 w = wcol[u * H + k];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float h = hs[r * H + k];
      acc[3 * r] = fmaf(h, w.x, acc[3 * r]);
      acc[3 * r + 1] = fmaf(h, w.y, acc[3 * r + 1]);
      acc[3 * r + 2] = fmaf(h, w.z, acc[3 * r + 2]);
    }
  }
  reduce_scatter<kR * 3, 3, 16>(acc, lane);
  if ((lane & 1) == 0) {
    float* o = red + warp * kR * 3 + (lane >> 1) * 3;
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
  }
}

// Sum over the kWarps / U warps of unit u for row r, gate g.
template <int U>
__device__ __forceinline__ float unit_sum(const float* red, int u, int r,
                                          int g, int G) {
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < kWarps / U; ++p) s += red[((p * U + u) * kR + r) * G + g];
  return s;
}


// K5's forward (csrc/gru_bptt.cu), shared with K2's float32 recurrence
// (csrc/gru_scan.cu): ys (T, B, H) from xp (T, B, 3H) and Wh, f32, with the
// state exchanged through ys itself.
template <int U>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ xp,     // (T, B, 3H)
               const float* __restrict__ wh,     // (H, 3H)
               const float* __restrict__ mask,   // (T, B)
               float* __restrict__ ys,           // (T, B, H)
               unsigned* __restrict__ bar,       // arrival count, zeroed
               int T, int B, int H, int reverse) {
  extern __shared__ float4 smem4[];
  float4* wcol = smem4;                                     // [U][H]
  float* hs = reinterpret_cast<float*>(wcol + U * H);       // [kR][H]
  float* red = hs + kR * H;                                 // [kWarps][kR][3]
  const int H3 = 3 * H;
  const int u0 = blockIdx.x * U;
  load_columns<U>(wcol, wh, H, u0);
  // Gate threads: one per (row, unit) of a pass.
  const int gr = threadIdx.x / U;
  const int gu = threadIdx.x % U;
  const int j = u0 + gu;
  const bool gate = threadIdx.x < kR * U && j < H;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;     // previous step, scan order
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && b < B;
      float xr = 0.f, xz = 0.f, xn = 0.f, m = 0.f;
      if (live) {                               // loaded before the product
        const size_t row = static_cast<size_t>(t) * B + b;
        xr = xp[row * H3 + j];
        xz = xp[row * H3 + H + j];
        xn = xp[row * H3 + 2 * H + j];
        m = mask[row];
      }
      stage_rows(hs, s ? ys + static_cast<size_t>(tp) * B * H : nullptr, b0,
                 B, H);
      __syncthreads();
      rows_times_columns<U>(hs, wcol, red, H);
      __syncthreads();
      if (live) {
        const float rg = sigmoid(xr + unit_sum<U>(red, gu, gr, 0, 3));
        const float zg = sigmoid(xz + unit_sum<U>(red, gu, gr, 1, 3));
        const float ng = tanhf(xn + rg * unit_sum<U>(red, gu, gr, 2, 3));
        const float h = hs[gr * H + j];
        const float hn = (1.f - zg) * ng + zg * h;
        ys[(static_cast<size_t>(t) * B + b) * H + j] = m * hn + (1.f - m) * h;
      }
      __syncthreads();                          // hs and red are reused
    }
    if (s + 1 < T) grid_sync(bar, s + 1);
  }
}

// The forward's dynamic shared memory: Wh columns, one staged pass, sums.
size_t fwd_smem_bytes(int H, int U) {
  return sizeof(float4) * U * H + sizeof(float) * kR * H +
         sizeof(float) * kWarps * kR * 3;
}

// Units per block: ceil(H / SMs) rounded up to a power of two <= 16, so the
// kWarps warps split evenly over the units.
int units_per_block(int H, int nsm) {
  int U = 1;
  while (U * nsm < H) U *= 2;
  return U;
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

template <int U>
int launch_fwd(const float* xp, const float* wh, const float* mask, float* ys,
               unsigned* bar, int T, int B, int H, int reverse,
               cudaStream_t stream) {
  void* args[] = {&xp, &wh, &mask, &ys, &bar, &T, &B, &H, &reverse};
  return launch_cooperative(reinterpret_cast<const void*>(gru_fwd_kernel<U>),
                            (H + U - 1) / U, fwd_smem_bytes(H, U), args,
                            stream);
}

int sm_count(int* nsm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
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
