// Capsule dynamic routing, backward (K8b): du and dW of v = routing(u . W).
//
// Replaces K8's backward, _bwd_kernel of tpuasr/ops/pallas_routing.py
// (pallas_call at line 180, built by _build_bwd, reached through the custom
// VJP's _routed_bwd). For each routed row r, with u_hat[i, o, d] =
// sum_k u[r, i, k] W[i, k, o*D + d] and the routing of routing.cu run to its
// final coupling c and sum s (the iterations before the last run on
// stop_gradient(u_hat), so c carries no gradient):
//
//   ds = g dv + 2 (s . dv) g'(a) s       (squash VJP, a = |s|^2)
//   du_hat[i, o, d] = c[i, o] ds[o, d]
//   du[r, i, k] = sum_{o,d} du_hat[i, o, d] W[i, k, o*D + d]
//   dW[i, k, o*D + d] = sum_r u[r, i, k] du_hat[r, i, o, d]
//
// What bounds it on the H100: operations. Per row the gradient needs
// (6*Din + 4*iters - 1)*O*D*I flops (u_hat 2*Din, the routing to the final
// s 4*iters - 2, du_hat 1, du 2*Din, dW 2*Din): 11.6 MFLOP at config 4
// (I=256, Din=8, O*D=768, iters 3), 23.1 GFLOP of fp32 at B=8 x 5 s (1,992
// rows), against about 51 MB of u, W, dv, du and dW.
//
// Design. The TPU kernel kept W and the whole dW (6.29 MB each) in VMEM and
// revisited dW from grid step to grid step; a block here has 227 KB of
// shared memory and blocks run in no order, so the work is split in two
// passes and nothing is ever summed by atomics:
//  * Pass 1 is K8's forward kernel (routing.cu, tpuasr_routing_bwd_prep):
//    each row's routing as in the forward, which writes, in place of v,
//    V = v_0 + ... + v_{iters-2} and ds (2 x O*D floats a row).
//  * Given V and ds, everything else is independent per input capsule i:
//    b[i, o] = sum_d u_hat[i, o, d] V[o, d] (K8's identity), the softmax
//    over o, du_hat, du[r, i, :] and dW[i, :, :]. Pass 2 runs one block per
//    (capsule i, chunk of rows). Each thread owns 4 consecutive d of one
//    class o (K8's columns) and keeps its slice of W[i] (Din x 4 floats)
//    and of dW[i] (Din x 4 sums over the chunk's rows) in registers for the
//    whole block; rows go by in tiles of 4. Per tile: u_hat in registers,
//    b to shared memory, one warp per row takes the softmax (as K8, so c is
//    K8's bit for bit), then du_hat = c ds, dW += u du_hat, and du's sums
//    over the columns: a reduce-scatter over each warp's lanes (Din values
//    a row in log2 steps) and a sum over the warps from shared memory.
//  * With more than one chunk, each chunk's partial dW goes to scratch and
//    a third kernel adds the chunks in chunk order, so the result is the
//    same on every run.
//
// IEEE arithmetic only: expf, correctly rounded division and sqrtf (the
// build never passes --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

extern "C" int tpuasr_routing_bwd_prep(const float* u, const float* W,
                                       const float* dv, float* V, float* ds,
                                       int R, int I, int Din, int O, int D,
                                       int iters, cudaStream_t stream);

namespace {

constexpr int kTR = 4;            // rows per tile
constexpr int kTC = 4;            // capsule dims d per thread
constexpr int kMaxCols = 512;     // class threads, as in routing.cu

__device__ __forceinline__ float group_sum(float x, int Gp) {
  for (int off = Gp >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Reduce-scatter over a warp: lane l ends with the warp's total of x[l % NV]
// (NV a power of two <= 32), in NV - 1 shuffles and log2(32 / NV) more.
template <int NV>
__device__ __forceinline__ float warp_reduce_scatter(float (&x)[NV],
                                                     int lane) {
#pragma unroll
  for (int off = NV / 2; off >= 1; off >>= 1) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < off; ++j) {
      const float send = up ? x[j] : x[j + off];
      const float keep = up ? x[j + off] : x[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float r = x[0];
#pragma unroll
  for (int off = NV; off < 32; off <<= 1)
    r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// 4 consecutive floats of one class's row of V or ds.
__device__ __forceinline__ void load4(const float* __restrict__ p, bool vec,
                                      int nvalid, float x[kTC]) {
  if (vec && nvalid == kTC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTC; ++j) x[j] = j < nvalid ? __ldg(p + j) : 0.0f;
  }
}

// Pass 2: grid (I, chunks); MAXDIN >= Din bounds the register arrays.
template <int MAXDIN, int MAXT>
__global__ void __launch_bounds__(MAXT)
routing_bwd_kernel(const float* __restrict__ u,    // (R, I, Din)
                   const float* __restrict__ W,    // (I, Din, O*D)
                   const float* __restrict__ Vs,   // (R, O, D)
                   const float* __restrict__ ds,   // (R, O, D)
                   float* __restrict__ du,         // (R, I, Din)
                   float* __restrict__ dWp,        // (chunks, I, Din, O*D)
                   int R, int I, int Din, int O, int D, int Gp,
                   int rows_per_chunk, bool route, bool vec) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  float* ubuf = smem;                               // [2][kTR][MAXDIN]
  float* cb = ubuf + 2 * kTR * MAXDIN;              // [kTR][O]
  float* red = cb + kTR * O;                        // [nwarps][kTR][MAXDIN]

  const int i = blockIdx.x;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int o = tid / Gp;
  const int g = tid - o * Gp;
  const int d0 = g * kTC;
  const int OD = O * D;
  const int nvalid = o < O ? max(0, min(kTC, D - d0)) : 0;
  const int col = o * D + d0;
  const float c0 = 1.0f / static_cast<float>(O);   // softmax of zeros

  // This thread's W[i, :, col:col+4], and its dW sums, for the whole block.
  float w[MAXDIN][kTC];
  float dw[MAXDIN][kTC];
#pragma unroll
  for (int k = 0; k < MAXDIN; ++k)
#pragma unroll
    for (int tc = 0; tc < kTC; ++tc) {
      w[k][tc] = k < Din && tc < nvalid
                     ? __ldg(W + (static_cast<size_t>(i) * Din + k) * OD +
                             col + tc)
                     : 0.0f;
      dw[k][tc] = 0.0f;
    }

  // A tile's u: kTR rows x Din floats of capsule i, zeros past the chunk.
  auto load_u = [&](int r0, float* dst) {
    for (int e = tid; e < kTR * MAXDIN; e += blockDim.x) {
      const int tr = e / MAXDIN;
      const int k = e - tr * MAXDIN;
      const int row = r0 + tr;
      dst[e] = row < r_end && k < Din
                   ? __ldg(u + (static_cast<size_t>(row) * I + i) * Din + k)
                   : 0.0f;
    }
  };

  const int ntiles = r_end > r_begin ? (r_end - r_begin + kTR - 1) / kTR : 0;
  if (ntiles > 0) load_u(r_begin, ubuf);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = r_begin + t * kTR;
    const float* ub = ubuf + (t & 1) * kTR * MAXDIN;

    // ds of this thread's rows and column; b = u_hat . V -> shared memory.
    float dsr[kTR][kTC];
#pragma unroll
    for (int tr = 0; tr < kTR; ++tr) {
      const int row = r0 + tr;
      const bool ok = row < r_end && nvalid > 0;
      const size_t base = (static_cast<size_t>(row) * O + o) * D + d0;
      float vr[kTC];
      if (ok) {
        load4(ds + base, vec, nvalid, dsr[tr]);
        if (route) load4(Vs + base, vec, nvalid, vr);
      } else {
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) dsr[tr][tc] = vr[tc] = 0.0f;
      }
      if (route) {
        float uh[kTC] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < MAXDIN; ++k) {
          if (k < Din) {
            const float uk = ub[tr * MAXDIN + k];
#pragma unroll
            for (int tc = 0; tc < kTC; ++tc)
              uh[tc] = fmaf(uk, w[k][tc], uh[tc]);
          }
        }
        float pb = 0.0f;
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) pb = fmaf(uh[tc], vr[tc], pb);
        pb = group_sum(pb, Gp);
        if (g == 0 && o < O) cb[tr * O + o] = pb;
      }
    }
    __syncthreads();

    // Softmax over o, one warp per row; stage the next tile's u.
    if (route) {
      for (int tr = warp; tr < kTR; tr += nwarps) {
        float* bp = cb + tr * O;
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
    if (t + 1 < ntiles) load_u(r0 + kTR, ubuf + ((t + 1) & 1) * kTR * MAXDIN);
    __syncthreads();

    // du_hat = c ds; dW += u du_hat; du's partial sums over this warp.
#pragma unroll
    for (int tr = 0; tr < kTR; ++tr) {
      const float c = route ? (o < O ? cb[tr * O + o] : 0.0f) : c0;
      float p[MAXDIN];
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) dsr[tr][tc] *= c;
#pragma unroll
      for (int k = 0; k < MAXDIN; ++k) {
        const float uk = ub[tr * MAXDIN + k];
        float acc = 0.0f;
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) {
          dw[k][tc] = fmaf(uk, dsr[tr][tc], dw[k][tc]);
          acc = fmaf(dsr[tr][tc], w[k][tc], acc);
        }
        p[k] = acc;
      }
      const float tot = warp_reduce_scatter<MAXDIN>(p, lane);
      if (lane < MAXDIN) red[(warp * kTR + tr) * MAXDIN + lane] = tot;
    }
    __syncthreads();

    // du: the sum over the warps.
    for (int e = tid; e < kTR * Din; e += blockDim.x) {
      const int tr = e / Din;
      const int k = e - tr * Din;
      const int row = r0 + tr;
      if (row < r_end) {
        float acc = 0.0f;
        for (int wp = 0; wp < nwarps; ++wp)
          acc += red[(wp * kTR + tr) * MAXDIN + k];
        du[(static_cast<size_t>(row) * I + i) * Din + k] = acc;
      }
    }
  }

  // This chunk's dW[i, :, col:col+4] (zeros for an empty chunk).
  float* dst = dWp + static_cast<size_t>(blockIdx.y) * I * Din * OD;
#pragma unroll
  for (int k = 0; k < MAXDIN; ++k)
#pragma unroll
    for (int tc = 0; tc < kTC; ++tc)
      if (k < Din && tc < nvalid)
        dst[(static_cast<size_t>(i) * Din + k) * OD + col + tc] = dw[k][tc];
}

// dW = the sum of the chunks' partials, in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n,
                                  int chunks) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = part[e];
    for (int c = 1; c < chunks; ++c) acc += part[c * n + e];
    out[e] = acc;
  }
}

template <int MAXDIN, int MAXT>
cudaError_t launch_pass2(const float* u, const float* W, const float* V,
                         const float* ds, float* du, float* dst, int R, int I,
                         int Din, int O, int D, int Gp, int threads,
                         int chunks, int rows_per_chunk, bool route, bool vec,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTR * MAXDIN + static_cast<size_t>(kTR) * O +
                       (threads / 32) * kTR * MAXDIN);
  routing_bwd_kernel<MAXDIN, MAXT><<<dim3(I, chunks), threads, smem, stream>>>(
      u, W, V, ds, du, dst, R, I, Din, O, D, Gp, rows_per_chunk, route, vec);
  return cudaGetLastError();
}

}  // namespace

// K8b: du (R, I, Din) and dW (I, Din, O*D) for the output gradient dv
// (R, O, D). Scratch from the caller: V and ds (R, O, D) each, and, for
// chunks > 1, part (chunks, I, Din, O*D). Takes the shapes K8 takes (Din in
// [1, 16], O * next_pow2(ceil(D / 4)) <= 512); anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int tpuasr_routing_bwd(const float* u, const float* W,
                                  const float* dv, float* V, float* ds,
                                  float* du, float* dW, float* part, int R,
                                  int I, int Din, int O, int D, int iters,
                                  int chunks, cudaStream_t stream) {
  if (R < 0 || I < 1 || Din < 1 || Din > 16 || O < 1 || D < 1 ||
      iters < 1 || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (D + kTC - 1) / kTC;
  int Gp = 1;
  while (Gp < G) Gp <<= 1;
  if (Gp > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (O * Gp + 31) / 32 * 32;
  if (threads > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  int e = tpuasr_routing_bwd_prep(u, W, dv, V, ds, R, I, Din, O, D, iters,
                                  stream);
  if (e != 0) return e;
  const int rows_per_chunk = (R + chunks - 1) / chunks;
  float* dst = chunks == 1 ? dW : part;
  const bool route = iters > 1;
  const bool vec = D % kTC == 0;
  cudaError_t err;
  if (Din <= 8)
    err = threads <= 256
              ? launch_pass2<8, 256>(u, W, V, ds, du, dst, R, I, Din, O, D,
                                     Gp, threads, chunks, rows_per_chunk,
                                     route, vec, stream)
              : launch_pass2<8, 512>(u, W, V, ds, du, dst, R, I, Din, O, D,
                                     Gp, threads, chunks, rows_per_chunk,
                                     route, vec, stream);
  else
    err = threads <= 256
              ? launch_pass2<16, 256>(u, W, V, ds, du, dst, R, I, Din, O, D,
                                      Gp, threads, chunks, rows_per_chunk,
                                      route, vec, stream)
              : launch_pass2<16, 512>(u, W, V, ds, du, dst, R, I, Din, O, D,
                                      Gp, threads, chunks, rows_per_chunk,
                                      route, vec, stream);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(I) * Din * O * D;
  const int blocks =
      static_cast<int>(std::min<size_t>((n + 255) / 256, 1024));
  sum_chunks_kernel<<<blocks, 256, 0, stream>>>(part, dW, n, chunks);
  return static_cast<int>(cudaGetLastError());
}
