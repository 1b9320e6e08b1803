// Capsule dynamic routing, forward (K8): v = routing(u_hat = u . W).
//
// Replaces K8's forward, _fwd_kernel of tpuasr/ops/pallas_routing.py
// (pallas_call at line 161, built by _build_fwd). For each routed row r
// (one (batch, frame) position) with primary capsules u[r] (I, Din) and the
// routing weights W (I, Din, O*D):
//
//   u_hat[i, o, d] = sum_k u[r, i, k] W[i, k, o*D + d]
//   b = 0; repeat iters times:
//     c[i, :] = softmax_o(b[i, :])
//     s[o, d] = sum_i c[i, o] u_hat[i, o, d];  v = squash(s)
//     b[i, o] += sum_d u_hat[i, o, d] v[o, d]      (not after the last)
//   out[r] = v
//
// as tpuasr/models/capsnet.py:31-52 defines it (the iterations before the
// last run on stop_gradient(u_hat); the forward is the same).
//
// What bounds it on the H100: operations. Per row the function needs
// 2*Din*O*D*I flops for u_hat, 2*O*D*I for the weighted sum in each
// iteration and 2*O*D*I for the agreement in all but the last:
// (4*iters - 2)*O*D*I for routing. That is 5.1 MFLOP at config 4 (I=256,
// Din=8, O*D=768, iters 3), 10.2 GFLOP of fp32 at B=8 x 5 s (1,992 rows),
// against 29 MB of u, W and v. u_hat itself is 786 KB per
// row, more than a block's 227 KB of shared memory, so unlike the TPU
// kernel (which holds a row's u_hat in VMEM) this one never holds it
// anywhere: it recomputes u_hat from u and W where it is needed, in
// registers, and never writes it to memory.
//
// Design:
//  * b needs no storage. With b_0 = 0, after k iterations
//    b[i, o] = sum_d u_hat[i, o, d] V_k[o, d] with V_k = v_0 + ... + v_{k-1},
//    so an iteration is ONE pass over i: recompute u_hat, form b from V,
//    softmax over o, accumulate s. Iteration 0 has c = 1/O and skips b.
//    That is iters passes over W per row instead of the 2*iters - 1 that
//    storing nothing but b would need. Only the f32 summation order
//    differs from the reference (as the Pallas kernel's does).
//  * A block routes ROWS = 4 * RG rows (RG = 1 or 2 row groups). Each
//    thread owns 4 rows x 4 consecutive d of one class o (its "column"),
//    so each W value it reads feeds 4 rows, and s and V live in registers.
//    The Gp threads of one class are adjacent lanes of a warp; sums over d
//    (for b and for the squash) are xor shuffles among them.
//  * i advances in chunks of 2 between two barriers: the threads write the
//    chunk's b to shared memory, one warp per (row, i) takes the softmax
//    over o (max-subtracted, IEEE expf, division as jax.nn.softmax), and
//    the threads read c back for s += c * u_hat with u_hat still in
//    registers. u's chunk (kIC * Din <= 32 floats a row) is staged in
//    shared memory, double-buffered, so any I and any Din <= 16 work
//    without padding I.
//  * W's chunk (2 x Din x O*D floats, 96 KB at config 4) is copied to
//    shared memory by cp.async, double-buffered: the next chunk's copy runs
//    while this chunk computes, so no W load waits on L2 inside a chunk.
//    Where two chunks do not fit the block's share (at Din = 8, O*D past
//    ~820 with two blocks per SM, ~1,700 with one), each thread reads W
//    from L2 directly instead.
//  * The barriers and the softmax leave most warps waiting, so latency,
//    not the FMAs or L2, sets the pace: config 4 (192 class threads) runs
//    blocks of 2 x 192 threads, two per SM, whose phases overlap. That, 2
//    capsules per chunk and the staged W took chip_smoke.py's K8 time at
//    B = 8 from 4.5 to 2.3 ms (H100 80GB HBM3, 700 W).
//  * Columns: O * Gp threads (Gp = next power of two of ceil(D / 4)),
//    rounded up to whole warps; limit O * Gp <= 512 (O <= 128 at D = 16).
//    Any O * D, also one that is not a multiple of 8: lanes past D, past
//    O or past the last row carry zeros and write nothing.
//
// The backward K8b (routing_bwd.cu) runs this kernel as its first pass
// (tpuasr_routing_bwd_prep): given dv, the last iteration writes each
// row's V and the squash VJP ds of its final s in place of v.
//
// IEEE arithmetic only: expf, correctly rounded division and sqrtf (the
// build never passes --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTR = 4;            // rows per thread
constexpr int kTC = 4;            // capsule dims d per thread
constexpr int kIC = 2;            // input capsules i per chunk
// Launch shapes. Up to 384 threads (two row groups of <= 192 class threads,
// or one of <= 384) run two blocks per SM, so that one block's barrier and
// softmax phases overlap the other's FMAs; wider class counts run one
// block of up to 512 threads per SM.
constexpr int kPairThreads = 384;
constexpr int kPairBlocks = 2;
constexpr int kWideThreads = 512;
// Shared memory a block may take with W's chunks staged (two per SM of the
// pair shape, one of the wide shape); past it, W is read from L2 directly.
constexpr int kPairSmem = 110 * 1024;
constexpr int kWideSmem = 220 * 1024;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float group_sum(float x, int Gp) {
  for (int off = Gp >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 4 consecutive W values of one class, from global memory (SMEM false) or
// from a chunk staged in shared memory.
template <bool SMEM>
__device__ __forceinline__ void load_w(const float* __restrict__ p, bool vec,
                                       int nvalid, float w[kTC]) {
  if (vec && nvalid == kTC) {
    const float4 q = SMEM ? *reinterpret_cast<const float4*>(p)
                          : __ldg(reinterpret_cast<const float4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTC; ++j)
      w[j] = j < nvalid ? (SMEM ? p[j] : __ldg(p + j)) : 0.0f;
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// STAGE: W's chunks are copied to shared memory by cp.async, the next
// chunk's copy overlapping this chunk's work; vec16: those copies can be
// 16-byte (Din * O * D a multiple of 4, W 16-byte aligned).
template <int MAXT, int MINB, bool STAGE>
__global__ void __launch_bounds__(MAXT, MINB)
routing_fwd_kernel(const float* __restrict__ u,    // (R, I, Din)
                   const float* __restrict__ W,    // (I, Din, O*D)
                   float* __restrict__ v,          // (R, O, D)
                   const float* __restrict__ dv,   // (R, O, D) or null
                   float* __restrict__ Vo,         // (R, O, D) if dv
                   float* __restrict__ dso,        // (R, O, D) if dv
                   int R, int I, int Din, int O, int D, int iters, int Gp,
                   int col_threads, bool vec, bool vec16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RG = blockDim.x / col_threads;
  const int ROWS = RG * kTR;
  // ROWS is a multiple of 4, so every buffer starts 16-byte aligned.
  float* ubuf = smem;                                  // [2][ROWS][kIC][Din]
  float* cbuf = smem + 2 * ROWS * kIC * Din;           // [2][ROWS][kIC][O]
  float* wbuf = cbuf + 2 * ROWS * kIC * O;             // [2][kIC][Din][O*D]
  const int ustride_row = kIC * Din;
  const int ustride = ROWS * ustride_row;
  const int cstride = ROWS * kIC * O;

  const int tid = threadIdx.x;
  const int rg = tid / col_threads;
  const int ct = tid - rg * col_threads;
  const int o = ct / Gp;
  const int g = ct - o * Gp;
  const int d0 = g * kTC;
  const int OD = O * D;
  const int nvalid = o < O ? max(0, min(kTC, D - d0)) : 0;
  const int row0 = blockIdx.x * ROWS;                  // the block's rows
  const int rloc0 = rg * kTR;                          // this thread's rows
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nchunks = (I + kIC - 1) / kIC;
  const float c0 = 1.0f / static_cast<float>(O);       // softmax of zeros

  const int wstride = kIC * Din * O * D;
  // Start the copy of chunk's W slab (contiguous in W) into wbuf.
  auto stage_w = [&](int chunk) {
    const int i0 = chunk * kIC;
    const int n = min(kIC, I - i0) * Din * O * D;
    const float* src = W + static_cast<size_t>(i0) * Din * O * D;
    float* dst = wbuf + (chunk & 1) * wstride;
    if (vec16) {
      for (int e = 4 * tid; e < n; e += 4 * blockDim.x)
        cp_async16(dst + e, src + e);
    } else {
      for (int e = tid; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
    }
    cp_async_commit();
  };

  // A row's chunk of u is kIC * Din <= 32 contiguous floats: one warp per
  // row, one lane per float.
  auto load_u = [&](int chunk, float* dst) {
    const int e0 = chunk * kIC * Din;                  // (i0, 0) in the row
    for (int rl = warp; rl < ROWS; rl += nwarps) {
      const int row = row0 + rl;
      if (lane < ustride_row)
        dst[rl * ustride_row + lane] =
            (row < R && e0 + lane < I * Din)
                ? __ldg(u + static_cast<size_t>(row) * I * Din + e0 + lane)
                : 0.0f;
    }
  };

  float V[kTR][kTC];
#pragma unroll
  for (int tr = 0; tr < kTR; ++tr)
#pragma unroll
    for (int tc = 0; tc < kTC; ++tc) V[tr][tc] = 0.0f;

  for (int it = 0; it < iters; ++it) {
    const bool route = it > 0;
    float s[kTR][kTC];
#pragma unroll
    for (int tr = 0; tr < kTR; ++tr)
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) s[tr][tc] = 0.0f;

    if (STAGE) stage_w(0);
    load_u(0, ubuf);
    if (STAGE) cp_async_wait_all();
    __syncthreads();
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int buf = chunk & 1;
      const float* ub = ubuf + buf * ustride;
      float* cb = cbuf + buf * cstride;
      const int i0 = chunk * kIC;
      // The next chunk's W: its buffer was last read before the previous
      // chunk's first barrier, which every thread has passed.
      if (STAGE && chunk + 1 < nchunks) stage_w(chunk + 1);

      // u_hat for this chunk's kIC capsules, in registers.
      float uh[kIC][kTR][kTC];
#pragma unroll
      for (int ii = 0; ii < kIC; ++ii) {
#pragma unroll
        for (int tr = 0; tr < kTR; ++tr)
#pragma unroll
          for (int tc = 0; tc < kTC; ++tc) uh[ii][tr][tc] = 0.0f;
        const int i = i0 + ii;
        if (nvalid > 0 && i < I) {
          const float* wp =
              (STAGE ? wbuf + buf * wstride + ii * Din * OD
                     : W + static_cast<size_t>(i) * Din * OD) + o * D + d0;
#pragma unroll 8
          for (int k = 0; k < Din; ++k) {
            float w[kTC];
            load_w<STAGE>(wp + static_cast<size_t>(k) * OD, vec, nvalid, w);
#pragma unroll
            for (int tr = 0; tr < kTR; ++tr) {
              const float uk = ub[(rloc0 + tr) * ustride_row + ii * Din + k];
#pragma unroll
              for (int tc = 0; tc < kTC; ++tc)
                uh[ii][tr][tc] = fmaf(uk, w[tc], uh[ii][tr][tc]);
            }
          }
        }
      }

      // b[i, o] = sum_d u_hat[i, o, d] V[o, d] -> shared memory.
      if (route) {
#pragma unroll
        for (int ii = 0; ii < kIC; ++ii)
#pragma unroll
          for (int tr = 0; tr < kTR; ++tr) {
            float pb = 0.0f;
#pragma unroll
            for (int tc = 0; tc < kTC; ++tc)
              pb = fmaf(uh[ii][tr][tc], V[tr][tc], pb);
            pb = group_sum(pb, Gp);
            if (g == 0 && o < O) cb[((rloc0 + tr) * kIC + ii) * O + o] = pb;
          }
      }
      __syncthreads();

      // Softmax over o, one warp per (row, i); stage the next chunk of u.
      if (route) {
        for (int p = warp; p < ROWS * kIC; p += nwarps) {
          float* bp = cb + p * O;
          float m = -INFINITY;
          for (int q = lane; q < O; q += 32) m = fmaxf(m, bp[q]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          float sum = 0.0f;
          for (int q = lane; q < O; q += 32) {
            const float e = expf(bp[q] - m);
            bp[q] = e;
            sum += e;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          for (int q = lane; q < O; q += 32) bp[q] = bp[q] / sum;
        }
      }
      if (chunk + 1 < nchunks) load_u(chunk + 1, ubuf + (buf ^ 1) * ustride);
      if (STAGE) cp_async_wait_all();   // the next chunk's W has landed
      __syncthreads();

      // s[o, d] += c[i, o] u_hat[i, o, d].
#pragma unroll
      for (int ii = 0; ii < kIC; ++ii)
#pragma unroll
        for (int tr = 0; tr < kTR; ++tr) {
          const float c =
              route && o < O ? cb[((rloc0 + tr) * kIC + ii) * O + o] : c0;
#pragma unroll
          for (int tc = 0; tc < kTC; ++tc)
            s[tr][tc] = fmaf(c, uh[ii][tr][tc], s[tr][tc]);
        }
    }

    // v = squash(s) per (row, o); the last iteration's v is the output,
    // or, given dv, V and ds = g dv + 2 (s . dv) g'(a) s with a = |s|^2
    // and g, g' as at tpuasr/ops/pallas_routing.py:136-143.
    const bool last = it + 1 == iters;
#pragma unroll
    for (int tr = 0; tr < kTR; ++tr) {
      float a = 0.0f;
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) a = fmaf(s[tr][tc], s[tr][tc], a);
      a = group_sum(a, Gp);
      const float inv_sq = 1.0f / sqrtf(a + kEps);
      const float scale = a / (1.0f + a) * inv_sq;
      const int row = row0 + rloc0 + tr;
      if (last && dv != nullptr) {
        const size_t base = (static_cast<size_t>(row) * O + o) * D + d0;
        float dvv[kTC];
        float dot = 0.0f;
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) {
          dvv[tc] = tc < nvalid && row < R ? dv[base + tc] : 0.0f;
          dot = fmaf(s[tr][tc], dvv[tc], dot);
        }
        dot = group_sum(dot, Gp);
        const float gp = (1.0f / ((1.0f + a) * (1.0f + a))) * inv_sq -
                         0.5f * a / (1.0f + a) * inv_sq / (a + kEps);
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) {
          if (tc < nvalid && row < R) {
            Vo[base + tc] = V[tr][tc];
            dso[base + tc] = scale * dvv[tc] + 2.0f * dot * gp * s[tr][tc];
          }
        }
        continue;
      }
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) {
        const float vv = scale * s[tr][tc];
        if (!last) {
          V[tr][tc] += vv;
        } else if (tc < nvalid && row < R) {
          v[(static_cast<size_t>(row) * O + o) * D + d0 + tc] = vv;
        }
      }
    }
    __syncthreads();   // the next pass reuses both buffers
  }
}

template <int MAXT, int MINB, bool STAGE>
cudaError_t launch_kernel(const float* u, const float* W, float* v,
                          const float* dv, float* Vo, float* dso, int R,
                          int I, int Din, int O, int D, int iters, int Gp,
                          int col_threads, int RG, bool vec, size_t smem,
                          cudaStream_t stream) {
  const auto kernel = routing_fwd_kernel<MAXT, MINB, STAGE>;
  if (smem > 48 * 1024) {
    // Above 48 KB only by opting in; and the largest shared-memory share
    // of the SM, so that MINB such blocks fit on one SM.
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  const int rows = RG * kTR;
  const bool vec16 = (static_cast<size_t>(Din) * O * D) % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  kernel<<<(R + rows - 1) / rows, RG * col_threads, smem, stream>>>(
      u, W, v, dv, Vo, dso, R, I, Din, O, D, iters, Gp, col_threads, vec,
      vec16);
  return cudaGetLastError();
}

// Stages W when the block's shared memory stays within smem_max.
template <int MAXT, int MINB>
cudaError_t launch_shape(const float* u, const float* W, float* v,
                         const float* dv, float* Vo, float* dso, int R,
                         int I, int Din, int O, int D, int iters, int Gp,
                         int col_threads, int RG, bool vec, size_t smem_max,
                         cudaStream_t stream) {
  const int rows = RG * kTR;
  const size_t base =
      sizeof(float) * 2 * rows * kIC * (Din + static_cast<size_t>(O));
  const size_t staged =
      base + sizeof(float) * 2 * kIC * static_cast<size_t>(Din) * O * D;
  if (staged <= smem_max)
    return launch_kernel<MAXT, MINB, true>(
        u, W, v, dv, Vo, dso, R, I, Din, O, D, iters, Gp, col_threads, RG,
        vec, staged, stream);
  return launch_kernel<MAXT, MINB, false>(
      u, W, v, dv, Vo, dso, R, I, Din, O, D, iters, Gp, col_threads, RG,
      vec, base, stream);
}

// The launch shape for this many class threads.
cudaError_t launch(const float* u, const float* W, float* v, const float* dv,
                   float* Vo, float* dso, int R, int I, int Din, int O, int D,
                   int iters, int Gp, int col_threads, bool vec,
                   cudaStream_t stream) {
  if (col_threads <= kPairThreads) {
    const int RG = 2 * col_threads <= kPairThreads ? 2 : 1;
    return launch_shape<kPairThreads, kPairBlocks>(
        u, W, v, dv, Vo, dso, R, I, Din, O, D, iters, Gp, col_threads, RG,
        vec, kPairSmem, stream);
  }
  return launch_shape<kWideThreads, 1>(
      u, W, v, dv, Vo, dso, R, I, Din, O, D, iters, Gp, col_threads, 1, vec,
      kWideSmem, stream);
}

// Checks the shape and launches: v, or (dv given) V and ds.
int routing(const float* u, const float* W, float* v, const float* dv,
            float* Vo, float* dso, int R, int I, int Din, int O, int D,
            int iters, cudaStream_t stream) {
  if (R < 0 || I < 1 || Din < 1 || Din > 16 || O < 1 || D < 1 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (D + kTC - 1) / kTC;
  int Gp = 1;
  while (Gp < G) Gp <<= 1;
  if (Gp > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int col_threads = (O * Gp + 31) / 32 * 32;
  if (col_threads > kWideThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const bool vec = D % kTC == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const cudaError_t e = launch(u, W, v, dv, Vo, dso, R, I, Din, O, D, iters,
                               Gp, col_threads, vec, stream);
  return static_cast<int>(e);
}

}  // namespace

// Shapes this kernel takes: Din in [1, 16], D in [1, 128], I >= 1,
// iters >= 1, O * Gp <= 512 with Gp = next_pow2(ceil(D / 4)). Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int tpuasr_routing_fwd(const float* u, const float* W, float* v,
                                  int R, int I, int Din, int O, int D,
                                  int iters, cudaStream_t stream) {
  return routing(u, W, v, nullptr, nullptr, nullptr, R, I, Din, O, D, iters,
                 stream);
}

// K8b's first pass: for each row, V = v_0 + ... + v_{iters-2} and the
// squash VJP ds of the final s for the output gradient dv, all (R, O, D).
extern "C" int tpuasr_routing_bwd_prep(const float* u, const float* W,
                                       const float* dv, float* V, float* ds,
                                       int R, int I, int Din, int O, int D,
                                       int iters, cudaStream_t stream) {
  return routing(u, W, nullptr, dv, V, ds, R, I, Din, O, D, iters, stream);
}
