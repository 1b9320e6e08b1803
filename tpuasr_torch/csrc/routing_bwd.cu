// Capsule dynamic routing, backward (K8b): du and dW of v = routing(u . W).
//
// Replaces K8's backward, _bwd_kernel of tpuasr/ops/pallas_routing.py
// (pallas_call at line 180, built by _build_bwd, reached through the custom
// VJP's _routed_bwd). For each routed row r, with u_hat[i, o, d] =
// sum_k u[r, i, k] W[i, k, o*D + d], the final sum s of the routing and
// V = v_0 + ... + v_{iters-2} (the iterations before the last run on
// stop_gradient(u_hat), so the final coupling c carries no gradient):
//
//   c[i, :] = softmax_o(sum_d u_hat[i, o, d] V[o, d])
//   ds = g dv + 2 (s . dv) g'(a) s       (squash VJP, a = |s|^2)
//   du_hat[i, o, d] = c[i, o] ds[o, d]
//   du[r, i, k] = sum_{o,d} du_hat[i, o, d] W[i, k, o*D + d]
//   dW[i, k, o*D + d] = sum_r u[r, i, k] du_hat[r, i, o, d]
//
// What bounds it on the H100: operations. Given V and s, per row the
// gradient needs (6*Din + 3)*O*D*I flops (u_hat 2*Din, b 2, du_hat 1, du
// 2*Din, dW 2*Din): 10.0 MFLOP at config 4 (I=256, Din=8, O*D=768), 20.0
// GFLOP of fp32 at B=8 x 5 s (1,992 rows).
//
// Design. V and s come from K8's forward in its saving mode (routing.cu),
// which holds both at its end anyway: the TPU kernel recomputed the whole
// routing, which here would be a second K8. The TPU kernel kept W and the
// whole dW (6.29 MB each) in VMEM across grid steps; a block here has 227
// KB of shared memory and blocks run in no order, so:
//  * ds_kernel: ds from s and dv, once a row (a thread per 4 d of a class,
//    the class's sums by xor shuffles), not once a row and capsule.
//  * Pass 2, one block per (G capsules, chunk of rows), G = 384 / (class
//    threads) where Din <= 8 (2 at config 4): each thread owns 4
//    consecutive d of one class o of one capsule i and keeps its slice of
//    W[i] (Din x 4) and of dW[i] (Din x 4 sums over the chunk's rows) in
//    registers. Rows go by in tiles of kRT = 16, three block barriers a
//    tile: the tile's V and ds rows are copied into shared memory by
//    cp.async (V during the previous tile's softmax and products, ds during
//    this tile's b and softmax) and read there by the G capsules, so every
//    V and ds value is read from L2 once a block, not once a capsule, and
//    no load waits on L2 in the row loops; u_hat and b = u_hat . V to a b
//    buffer; barrier; the softmax of the tile's G x 16 (capsule, row)
//    pairs (Ls lanes a pair), and du of the previous tile summed over each
//    capsule's warps; barrier; du_hat = c ds, dW += u du_hat, and du's
//    partial sums over each warp's columns (a reduce-scatter over the
//    lanes). Din > 8, or a tile of V and ds too large to stage, takes a
//    capsule a block with V and ds read from L2.
//  * With more than one chunk, each chunk's partial dW goes to scratch and
//    a third kernel adds the chunks in chunk order: no atomics, the same
//    result on every run.
//
// IEEE arithmetic only: expf, correctly rounded division and sqrtf (the
// build never passes --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kRT = 16;           // rows per tile
constexpr int kTC = 4;            // capsule dims d per thread
constexpr int kMaxCols = 512;     // class threads, as in routing.cu
constexpr int kStagedThreads = 384;
constexpr int kSmemMax = 232448;
constexpr float kEps = 1e-8f;

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

// 4 consecutive floats of one class's row of V or ds (zeros past nvalid).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool vec,
                                        int nvalid) {
  if (vec && nvalid == kTC) return __ldg(reinterpret_cast<const float4*>(p));
  float x[kTC];
#pragma unroll
  for (int j = 0; j < kTC; ++j) x[j] = j < nvalid ? __ldg(p + j) : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// 4 consecutive floats from shared memory (zeros past nvalid).
__device__ __forceinline__ float4 load4s(const float* p, bool vec,
                                         int nvalid) {
  if (vec && nvalid == kTC) return *reinterpret_cast<const float4*>(p);
  float x[kTC];
#pragma unroll
  for (int j = 0; j < kTC; ++j) x[j] = j < nvalid ? p[j] : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// A 4-byte cp.async; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// A 16-byte cp.async; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the most recent group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// ds = g dv + 2 (s . dv) g'(a) s per (row, class), a = |s|^2, with g and g'
// as at tpuasr/ops/pallas_routing.py:136-143. A thread per 4 d of a class.
__global__ void ds_kernel(const float* __restrict__ s,
                          const float* __restrict__ dv,
                          float* __restrict__ ds, long long nitems, int O,
                          int D, int Gp) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool ok = p < nitems;
  const int g = static_cast<int>(p % Gp);
  const long long q = p / Gp;                     // row * O + o
  const int d0 = g * kTC;
  const int nvalid = ok ? max(0, min(kTC, D - d0)) : 0;
  const size_t base = static_cast<size_t>(q) * D + d0;
  float sv[kTC], dvv[kTC];
  float a = 0.0f, dot = 0.0f;
#pragma unroll
  for (int tc = 0; tc < kTC; ++tc) {
    sv[tc] = tc < nvalid ? s[base + tc] : 0.0f;
    dvv[tc] = tc < nvalid ? dv[base + tc] : 0.0f;
    a = fmaf(sv[tc], sv[tc], a);
    dot = fmaf(sv[tc], dvv[tc], dot);
  }
  a = group_sum(a, Gp);
  dot = group_sum(dot, Gp);
  const float inv_sq = 1.0f / sqrtf(a + kEps);
  const float scale = a / (1.0f + a) * inv_sq;
  const float gp = (1.0f / ((1.0f + a) * (1.0f + a))) * inv_sq -
                   0.5f * a / (1.0f + a) * inv_sq / (a + kEps);
#pragma unroll
  for (int tc = 0; tc < kTC; ++tc)
    if (tc < nvalid)
      ds[base + tc] = scale * dvv[tc] + 2.0f * dot * gp * sv[tc];
}

// Pass 2: grid (ceil(I / G), chunks) of G * cols threads, a capsule to
// each group of cols class threads; MAXDIN >= Din bounds the register
// arrays. STAGED: each tile's V and ds rows are copied into shared memory
// by cp.async, V a tile ahead and ds a phase ahead, and the G capsules read
// them there; else each thread reads its own float4s of them from L2.
template <int MAXDIN, int MAXT, bool STAGED>
__global__ void __launch_bounds__(MAXT, 1)
routing_bwd_kernel(const float* __restrict__ u,    // (R, I, Din)
                   const float* __restrict__ W,    // (I, Din, O*D)
                   const float* __restrict__ Vs,   // (R, O, D)
                   const float* __restrict__ ds,   // (R, O, D)
                   float* __restrict__ du,         // (R, I, Din)
                   float* __restrict__ dWp,        // (chunks, I, Din, O*D)
                   int R, int I, int Din, int O, int D, int Gp, int cols,
                   int rows_per_chunk, bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nwarps = blockDim.x >> 5;
  const int G = blockDim.x / cols;
  const int OD = O * D;
  float* ubuf = smem;                               // [2][G][kRT][MAXDIN]
  float* cbuf = ubuf + 2 * G * kRT * MAXDIN;        // [2][G][kRT][O]
  float* red = cbuf + 2 * G * kRT * O;              // [2][nwarps][kRT][MAXDIN]
  float* vtile = red + 2 * nwarps * kRT * MAXDIN;   // [kRT][OD] if STAGED
  float* dtile = vtile + kRT * OD;                  // [kRT][OD] if STAGED

  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi = tid / cols;                        // this thread's capsule
  const int i = blockIdx.x * G + gi;
  const bool cap = i < I;
  const int ct = tid - gi * cols;
  const int o = ct / Gp;
  const int g = ct - o * Gp;
  const int d0 = g * kTC;
  const int nvalid = cap && o < O ? max(0, min(kTC, D - d0)) : 0;
  const int col = o * D + d0;

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

  // A tile's u: kRT rows x Din floats of each of the G capsules, zeros
  // past the chunk or I.
  auto load_u = [&](int r0, float* dst) {
    for (int e = tid; e < G * kRT * MAXDIN; e += blockDim.x) {
      const int q = e / MAXDIN;
      const int k = e - q * MAXDIN;
      const int c = q / kRT;
      const int row = r0 + q - c * kRT;
      const int ic = blockIdx.x * G + c;
      const bool ok = row < r_end && k < Din && ic < I;
      cp_async4(dst + e,
                ok ? u + (static_cast<size_t>(row) * I + ic) * Din + k : u,
                ok ? 4 : 0);
    }
  };
  // A tile's kRT rows of V or ds into shared memory, zeros past the chunk.
  auto load_rows = [&](const float* src, int r0, float* dst) {
    const size_t base = static_cast<size_t>(r0) * OD;
    const int n = kRT * OD;
    const int valid = (min(r_end, r0 + kRT) - r0) * OD;
    if (OD % 4 == 0) {
      for (int e = 4 * tid; e < n; e += 4 * blockDim.x)
        cp_async16(dst + e, e < valid ? src + base + e : src,
                   e < valid ? 16 : 0);
    } else {
      for (int e = tid; e < n; e += blockDim.x)
        cp_async4(dst + e, e < valid ? src + base + e : src,
                  e < valid ? 4 : 0);
    }
  };

  // The softmax's lanes: Ls lanes a row, rpw rows a warp, over the G x kRT
  // (capsule, row) pairs of a tile.
  int rpw = 1;
  while (rpw * nwarps < G * kRT && rpw < 32) rpw <<= 1;
  const int Ls = 32 / rpw;
  const int srow = warp * rpw + lane / Ls;
  const int sl = lane % Ls;
  const bool sact = srow < G * kRT;

  // du of the tile at r0: each capsule's sum over its group's warps.
  auto store_du = [&](int r0, int buf) {
    const float* rb = red + buf * nwarps * kRT * MAXDIN;
    const int gw = cols >> 5;
    for (int e = tid; e < G * kRT * Din; e += blockDim.x) {
      const int c = e / (kRT * Din);
      const int q = e - c * kRT * Din;
      const int tr = q / Din;
      const int k = q - tr * Din;
      const int row = r0 + tr;
      const int ic = blockIdx.x * G + c;
      if (row < r_end && ic < I) {
        float acc = 0.0f;
        for (int wp = c * gw; wp < (c + 1) * gw; ++wp)
          acc += rb[(wp * kRT + tr) * MAXDIN + k];
        du[(static_cast<size_t>(row) * I + ic) * Din + k] = acc;
      }
    }
  };

  const int ntiles = r_end > r_begin ? (r_end - r_begin + kRT - 1) / kRT : 0;
  if (ntiles > 0) {
    load_u(r_begin, ubuf);
    if (STAGED) load_rows(Vs, r_begin, vtile);
  }
  cp_async_wait_all();
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = r_begin + t * kRT;
    const float* ub = ubuf + ((t & 1) * G + gi) * kRT * MAXDIN;
    float* cb = cbuf + ((t & 1) * G + gi) * kRT * O;
    __syncthreads();   // this tile's u (and V) has landed; tile t - 1 is done
    if (STAGED) {
      load_rows(ds, r0, dtile);    // in flight during b and the softmax
      cp_async_commit();
    }

    // b = u_hat . V -> the b buffer: every row's dot first, then the
    // class's sums of all rows together.
    float pb[kRT];
#pragma unroll
    for (int tr = 0; tr < kRT; ++tr) {
      const int row = r0 + tr;
      float4 vq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nvalid > 0 && row < r_end)
        vq = STAGED ? load4s(vtile + tr * OD + col, vec, nvalid)
                    : load4(Vs + static_cast<size_t>(row) * OD + col, vec,
                            nvalid);
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
      pb[tr] = 0.0f;
      pb[tr] = fmaf(uh[0], vq.x, pb[tr]);
      pb[tr] = fmaf(uh[1], vq.y, pb[tr]);
      pb[tr] = fmaf(uh[2], vq.z, pb[tr]);
      pb[tr] = fmaf(uh[3], vq.w, pb[tr]);
    }
    for (int off = Gp >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int tr = 0; tr < kRT; ++tr)
        pb[tr] += __shfl_xor_sync(0xffffffffu, pb[tr], off);
    if (g == 0 && o < O)
#pragma unroll
      for (int tr = 0; tr < kRT; ++tr) cb[tr * O + o] = pb[tr];
    __syncthreads();

    // The next tile's u and V; du of the previous tile; the softmax over o.
    if (t + 1 < ntiles) {
      load_u(r0 + kRT, ubuf + ((t + 1) & 1) * G * kRT * MAXDIN);
      if (STAGED) load_rows(Vs, r0 + kRT, vtile);
    }
    cp_async_commit();
    if (t > 0) store_du(r0 - kRT, (t - 1) & 1);
    {
      float* bp = cbuf + (t & 1) * G * kRT * O + srow * O;
      float m = -INFINITY;
      if (sact)
        for (int q = sl; q < O; q += Ls) m = fmaxf(m, bp[q]);
      for (int off = Ls >> 1; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.0f;
      if (sact)
        for (int q = sl; q < O; q += Ls) {
          const float e = expf(bp[q] - m);
          bp[q] = e;
          sum += e;
        }
      for (int off = Ls >> 1; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sact)
        for (int q = sl; q < O; q += Ls) bp[q] = bp[q] / sum;
    }
    if (STAGED) cp_async_wait_prior();   // this tile's ds has landed
    __syncthreads();

    // du_hat = c ds; dW += u du_hat; du's partial sums over this warp.
    float* rb = red + (t & 1) * nwarps * kRT * MAXDIN;
#pragma unroll
    for (int tr = 0; tr < kRT; ++tr) {
      const int row = r0 + tr;
      const float c = o < O ? cb[tr * O + o] : 0.0f;
      float4 dq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nvalid > 0 && row < r_end)
        dq = STAGED ? load4s(dtile + tr * OD + col, vec, nvalid)
                    : load4(ds + static_cast<size_t>(row) * OD + col, vec,
                            nvalid);
      const float dsr[kTC] = {c * dq.x, c * dq.y, c * dq.z, c * dq.w};
      float p[MAXDIN];
#pragma unroll
      for (int k = 0; k < MAXDIN; ++k) {
        const float uk = ub[tr * MAXDIN + k];
        float acc = 0.0f;
#pragma unroll
        for (int tc = 0; tc < kTC; ++tc) {
          dw[k][tc] = fmaf(uk, dsr[tc], dw[k][tc]);
          acc = fmaf(dsr[tc], w[k][tc], acc);
        }
        p[k] = acc;
      }
      const float tot = warp_reduce_scatter<MAXDIN>(p, lane);
      if (lane < MAXDIN) rb[(warp * kRT + tr) * MAXDIN + lane] = tot;
    }
    cp_async_wait_all();   // the next tile's u and V (visible at its barrier)
  }
  __syncthreads();
  if (ntiles > 0) store_du(r_begin + (ntiles - 1) * kRT, (ntiles - 1) & 1);

  // This chunk's dW[i, :, col:col+4] (zeros for an empty chunk).
  if (!cap) return;
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

template <int MAXDIN, int MAXT, bool STAGED>
cudaError_t launch_pass2(const float* u, const float* W, const float* V,
                         const float* ds, float* du, float* dst, int R, int I,
                         int Din, int O, int D, int Gp, int cols, int G,
                         int chunks, int rows_per_chunk, bool vec, size_t smem,
                         cudaStream_t stream) {
  const auto kernel = routing_bwd_kernel<MAXDIN, MAXT, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3((I + G - 1) / G, chunks), G * cols, smem, stream>>>(
      u, W, V, ds, du, dst, R, I, Din, O, D, Gp, cols, rows_per_chunk, vec);
  return cudaGetLastError();
}

// Pass 2's shared memory for G capsules a block (floats as laid out there).
size_t pass2_smem(int MAXDIN, bool staged, int G, int cols, int O, int D) {
  const size_t nwarps = static_cast<size_t>(G) * cols / 32;
  return sizeof(float) *
         (2 * static_cast<size_t>(G) * kRT * MAXDIN +
          2 * static_cast<size_t>(G) * kRT * O + 2 * nwarps * kRT * MAXDIN +
          (staged ? 2 * static_cast<size_t>(kRT) * O * D : 0));
}

}  // namespace

#ifdef TPUASR_ROUTING_CLOCKS
// The launches tpuasr_routing_bwd makes (1: ds, 2: pass 2, 4: the chunk
// sum), so that tools/routing_parts.py can time them apart.
static int g_passes = 7;
extern "C" void tpuasr_routing_bwd_passes(int mask) { g_passes = mask; }
#else
constexpr int g_passes = 7;
#endif

// K8b: du (R, I, Din) and dW (I, Din, O*D) for the output gradient dv
// (R, O, D), given K8's saved V and s (R, O, D). Scratch from the caller:
// ds (R, O, D) and, for chunks > 1, part (chunks, I, Din, O*D). Takes the
// shapes K8 takes (Din in [1, 16], O * next_pow2(ceil(D / 4)) <= 512);
// anything else returns cudaErrorInvalidValue without launching.
extern "C" int tpuasr_routing_bwd(const float* u, const float* W,
                                  const float* V, const float* s,
                                  const float* dv, float* ds, float* du,
                                  float* dW, float* part, int R, int I,
                                  int Din, int O, int D, int chunks,
                                  cudaStream_t stream) {
  if (R < 0 || I < 1 || Din < 1 || Din > 16 || O < 1 || D < 1 ||
      chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (D + kTC - 1) / kTC;
  int Gp = 1;
  while (Gp < G) Gp <<= 1;
  if (Gp > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (O * Gp + 31) / 32 * 32;
  if (threads > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaError_t err = cudaSuccess;
  if (g_passes & 1) {
    const long long nitems = static_cast<long long>(R) * O * Gp;
    ds_kernel<<<static_cast<unsigned>((nitems + 255) / 256), 256, 0,
                stream>>>(s, dv, ds, nitems, O, D, Gp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_chunk = (R + chunks - 1) / chunks;
  float* dst = chunks == 1 ? dW : part;
  const bool vec = D % kTC == 0;
  if (g_passes & 2) {
    // Din <= 8 and at most 384 class threads: G = 384 / cols capsules a
    // block share staged V and ds tiles (fewer capsules where they do not
    // fit); otherwise a capsule a block, V and ds from L2.
    int G = Din <= 8 ? kStagedThreads / threads : 0;
    while (G > 0 && pass2_smem(8, true, G, threads, O, D) > kSmemMax) --G;
    if (G > 0)
      err = launch_pass2<8, kStagedThreads, true>(
          u, W, V, ds, du, dst, R, I, Din, O, D, Gp, threads, G, chunks,
          rows_per_chunk, vec, pass2_smem(8, true, G, threads, O, D),
          stream);
    else if (Din <= 8)
      err = launch_pass2<8, 512, false>(
          u, W, V, ds, du, dst, R, I, Din, O, D, Gp, threads, 1, chunks,
          rows_per_chunk, vec, pass2_smem(8, false, 1, threads, O, D),
          stream);
    else
      err = threads <= 256
                ? launch_pass2<16, 256, false>(
                      u, W, V, ds, du, dst, R, I, Din, O, D, Gp, threads, 1,
                      chunks, rows_per_chunk, vec,
                      pass2_smem(16, false, 1, threads, O, D), stream)
                : launch_pass2<16, 512, false>(
                      u, W, V, ds, du, dst, R, I, Din, O, D, Gp, threads, 1,
                      chunks, rows_per_chunk, vec,
                      pass2_smem(16, false, 1, threads, O, D), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (chunks == 1 || !(g_passes & 4)) return 0;
  const size_t n = static_cast<size_t>(I) * Din * O * D;
  const int blocks =
      static_cast<int>(std::min<size_t>((n + 255) / 256, 1024));
  sum_chunks_kernel<<<blocks, 256, 0, stream>>>(part, dW, n, chunks);
  return static_cast<int>(cudaGetLastError());
}
