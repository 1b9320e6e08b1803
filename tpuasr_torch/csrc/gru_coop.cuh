// Shared pieces of the cooperative GRU kernels (csrc/gru_bptt.cu: K5,
// K5b; csrc/gru_bidir.cu: K7, K7b): the block shape, the grid barrier,
// row staging, the per-unit products with Wh resident in shared memory,
// and the occupancy-checked cooperative launch. See gru_bptt.cu for the
// design.
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

// All blocks of a cooperative launch meet here for the n-th time (n from
// 1). *count (zeroed before the launch) counts every arrival of the
// launch, so the n-th meeting is complete when it reaches n * gridDim.x:
// the last block's arrival itself releases the others. Thread 0 fences its
// block's writes (made visible to it by __syncthreads) before arriving,
// and fences again after leaving.
__device__ void grid_sync(unsigned* count, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned target = n * gridDim.x;
    const volatile unsigned* c = count;
    while (*c < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to bf16 and widened back (what a bf16 operand holds).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows b0 .. b0+kR-1 of a (B, n) row-major array into dst[kR][n], bypassing
// L1; rows past B (and every row when src is null) become zeros. With
// kRound each value is rounded to bf16 (the recurrent product's operand).
template <bool kRound = false>
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
      float4 v = 4 * i < have ? __ldcg(s4 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kRound)
        v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                        bf16_round(v.w));
      d4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const float v = i < have ? __ldcg(s + i) : 0.f;
      dst[i] = kRound ? bf16_round(v) : v;
    }
  }
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

// The [r, z, n, 0] column vectors of units u0 .. u0+U-1 as wcol[U][H]
// (zero past H), widened to f32.
template <int U, typename W>
__device__ void load_columns(float4* wcol, const W* wh, int H, int u0) {
  const int H3 = 3 * H;
  for (int i = threadIdx.x; i < H * U; i += kThreads) {
    const int u = i / H;
    const int k = i - u * H;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + u < H) {
      const W* w = wh + static_cast<size_t>(k) * H3 + u0 + u;
      v = make_float4(to_f32(w[0]), to_f32(w[H]), to_f32(w[2 * H]), 0.f);
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
