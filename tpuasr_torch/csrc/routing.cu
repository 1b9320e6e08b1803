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
// iteration and 2*O*D*I for the agreement in all but the last: 5.1 MFLOP
// at config 4 (I=256, Din=8, O*D=768, iters 3), 10.2 GFLOP of fp32 at B=8
// x 5 s (1,992 rows), against 29 MB of u, W and v. u_hat is 786 KB a row,
// more than an SM's shared memory, so it is never stored: each iteration
// recomputes it from u and W in registers (11.4 MFLOP a row in all). The
// FMAs a row also cannot be cut by tensor cores here: u_hat is a K = Din =
// 8 product, and a 3xTF32 split (needed to keep float32's precision)
// triples the tensor work of a K that short.
//
// Design:
//  * b needs no storage. With b_0 = 0, after k iterations
//    b[i, o] = sum_d u_hat[i, o, d] V_k[o, d] with V_k = v_0 + ... + v_{k-1},
//    so an iteration is ONE pass over the capsules: recompute u_hat, form b
//    from V, softmax over o, accumulate s. Iteration 0 has c = 1/O.
//  * A cluster of C CTAs takes a tile of Rc rows; CTA q owns the capsules
//    [I q / C, I (q + 1) / C) (none where I < C: it still joins the
//    cluster's barriers). ops/routing.py::routing_plan sets C = 2 and Rc =
//    16 at config 4: clusters of 8 leave the card room for 15 at once (120
//    SMs, 9 waves of 125 tiles at B = 8), clusters of 2 for 66 (every SM).
//  * Each CTA has RG row groups of col class threads and one producer warp.
//    The producer streams the CTA's capsules' W slabs (Din x O*D each)
//    through a ring of S stages in shared memory by TMA bulk copies
//    (cp.async.bulk, a "full" mbarrier a stage), with each stage's u rows.
//    A consumer warp releases a stage on its "empty" mbarrier as soon as
//    its u_hat is done, so copies never wait on a block barrier. Shapes whose u rows are not 16-byte multiples (Din % 4
//    != 0) or unaligned tensors are copied by the producer warp's lanes.
//  * Thread (rg, o, g) owns rows rg*8 .. +8 of the tile and d = 4g .. 4g +
//    3 of class o (Gp = next_pow2(ceil(D / 4)) threads a class, adjacent
//    lanes), with s and u_hat of those in registers: 64 floats, most of
//    the 128 registers a thread has at 416 threads (13 warps, at most four
//    on a scheduler). A capsule step: wait for the stage; u_hat from W
//    float4s and u float4 broadcasts, four rows' FMA chains interleaved
//    (16 independent chains; fewer ran slower) and the next four rows' u
//    in flight; release. Iteration 0 adds u_hat / O to s, no barrier. A
//    routed iteration needs b = u_hat . V (V of the tile in shared
//    memory), summed over a class's lanes by a reduce-scatter, then the
//    softmax over o of each row (Ls lanes a row, IEEE expf and division as
//    jax.nn.softmax) by the row group's warps, then s += c u_hat; it takes
//    one named barrier of the row group a step: between two barriers a
//    warp adds c_j u_hat_j, parks u_hat_{j+1} in its own shared memory,
//    takes the softmax of j + 1 and computes u_hat_{j+2} and its b, so the
//    softmax's latency has FMAs beside it (holding two capsules' u_hat in
//    registers spilled). The b/c buffers rotate over three. The two row
//    groups run apart.
//  * Softmax over o is per (row, capsule), so it never leaves the CTA. At
//    the end of an iteration each CTA writes its partial s over its
//    capsules into its V buffer, cluster barrier, then CTA q sums the C
//    partials of its classes [O q / C, O (q + 1) / C) in rank order from
//    distributed shared memory (a fixed order: the same bits on every run),
//    squashes them, adds v to its own slice of V and writes the new V into
//    every CTA's V buffer; cluster barrier. Two cluster barriers an
//    iteration, none in the capsule loop.
//  * Saving mode (autograd): the last iteration also writes each row's V =
//    v_0 + ... + v_{iters-2} and final s, which the backward (K8b,
//    routing_bwd.cu) takes in place of rerunning the routing.
//  * Launch variants: W staged (config 4: 2 row groups of 192 class
//    threads, Rc = 16, 3 stages of W and u), or read from L2
//    where a wide shape (more than 384 class threads) leaves no room for
//    two stages of it. tpuasr_routing_smem gives the layout's size, and the
//    launch refuses a plan whose shared memory differs from it.
//  * Measured (tools/routing_parts.py, H100): a routed iteration costs
//    about 1.7x iteration 0. Fewer registers a thread (8 rows a thread at
//    576 threads, or 4 at 800) spill and run slower.
//
// IEEE arithmetic only: expf, correctly rounded division and sqrtf (the
// build never passes --use_fast_math).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef TPUASR_ROUTING_CLOCKS
// Thread 0 of each CTA sums the SM cycles of each phase (slot 0 unused):
// u_hat with its wait for the stage and its release, b, the routed step's
// group barrier, parking u_hat with the softmax, the s update, and the
// iteration's cluster steps.
constexpr int kClockPhases = 7;
constexpr int kClockBlocks = 8192;
__device__ unsigned long long g_routing_clocks[kClockBlocks][kClockPhases];
#define CLOCK_START long long clk_t0 = clock64();
#define CLOCK_MARK(p)                                                    \
  {                                                                      \
    const long long clk_t = clock64();                                   \
    clk_acc[p] += clk_t - clk_t0;                                        \
    clk_t0 = clk_t;                                                      \
  }
#else
#define CLOCK_START
#define CLOCK_MARK(p)
#endif

namespace {

constexpr int kTC = 4;             // capsule dims d per thread
constexpr int kRowsPerThread = 8;  // KTR: rows per thread
constexpr int kMaxCluster = 8;     // CTAs a cluster, at most (portable)
constexpr int kSmemMax = 232448;   // an SM's shared memory for one CTA
constexpr float kEps = 1e-8f;

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the mbarrier inits visible to the async proxy, and orders this
// thread's earlier shared-memory writes before later bulk copies.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_arrive(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A TMA bulk copy of bytes (a multiple of 16, both ends 16-byte aligned)
// from global to this CTA's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Named barrier `id` over `threads` threads (a row group).
__device__ __forceinline__ void group_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- end of PTX helpers ---------------------------------------------------

__device__ __forceinline__ float group_sum(float x, int Gp) {
  for (int off = Gp >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// b of N rows summed over a class's GP lanes by a reduce-scatter: lane g
// ends with the totals of N / GP of the rows and stores them to dst (row
// r at dst[r * O]). GP - 1 + ... shuffles in place of N log2(GP).
template <int GP, int N>
__device__ __forceinline__ void b_store(float (&x)[N], int g, float* dst,
                                        int O, bool ok) {
  int base = 0;
  int n = N;
#pragma unroll
  for (int off = GP / 2; off >= 1; off >>= 1) {
    n >>= 1;
    const bool up = (g & off) != 0;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float send = up ? x[j] : x[j + n];
      const float keep = up ? x[j + n] : x[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    base += up ? n : 0;
  }
  if (ok)
#pragma unroll
    for (int j = 0; j < n; ++j) dst[(base + j) * O] = x[j];
}

// 4 consecutive W values of one class (zeros past nvalid).
__device__ __forceinline__ void load_w(const float* p, bool vec, int nvalid,
                                       float w[kTC]) {
  if (vec && nvalid == kTC) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kTC; ++j) w[j] = j < nvalid ? p[j] : 0.0f;
  }
}

// Shared memory of one CTA: the mbarriers (full and empty a stage), then
// floats: V [Rc][O][Dp], the CTA's slice of V [Rc][nq][Dp], parked u_hat
// [Rc][O][Dp] (each thread's own entries), b/c [3][Rc][O], then S stages
// of (W's capsule slab [Din*O*D] if staged, u [Rc][Dinp]).
struct Layout {
  int Rc, Dp, Dinp, nq;
  size_t bars, vbuf, vslice, uhs, cbuf, wst, ust, bytes;
};

__host__ __device__ inline size_t round4(size_t n) {
  return (n + 3) & ~size_t(3);
}

__host__ __device__ inline Layout layout(bool wstage, int C, int RG, int S,
                                         int Din, int O, int D, int Gp) {
  Layout L;
  L.Rc = kRowsPerThread * RG;
  L.Dp = kTC * Gp;
  L.Dinp = (Din + 3) & ~3;
  L.nq = (O + C - 1) / C;
  L.bars = (8 * 2 * static_cast<size_t>(S) + 15) / 16 * 16;
  L.vbuf = static_cast<size_t>(L.Rc) * O * L.Dp;
  L.vslice = static_cast<size_t>(L.Rc) * L.nq * L.Dp;
  L.uhs = L.vbuf;
  L.cbuf = round4(3 * static_cast<size_t>(L.Rc) * O);
  L.wst = wstage ? round4(static_cast<size_t>(Din) * O * D) : 0;
  L.ust = static_cast<size_t>(L.Rc) * L.Dinp;
  L.bytes = L.bars +
            sizeof(float) * (L.vbuf + L.vslice + L.uhs + L.cbuf +
                             static_cast<size_t>(S) * (L.wst + L.ust));
  return L;
}

// Threads a CTA of each instance may have: the class threads of its row
// groups and one producer warp. 416 threads are 13 warps, at most 4 on each
// of the SM's four schedulers, whose 16K registers then give each thread
// 128: s and u_hat (64 floats) and the loop's state, with little spilled.
constexpr int kStagedThreads = 416;
constexpr int kWideThreads = 544;

template <bool WSTAGE>
__global__ void __launch_bounds__(WSTAGE ? kStagedThreads : kWideThreads, 1)
routing_fwd_kernel(const float* __restrict__ u,    // (R, I, Din)
                   const float* __restrict__ W,    // (I, Din, O*D)
                   float* __restrict__ v,          // (R, O, D)
                   float* __restrict__ Vo,         // (R, O, D) or null
                   float* __restrict__ so,         // (R, O, D) or null
                   int R, int I, int Din, int O, int D, int iters, int Gp,
                   int col, int C, int RG, int S, bool bulk, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int KTR = kRowsPerThread;
  const Layout L = layout(WSTAGE, C, RG, S, Din, O, D, Gp);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + S;
  float* vbuf = reinterpret_cast<float*>(smem_raw + L.bars);
  float* vslice = vbuf + L.vbuf;
  float* uhs = vslice + L.vslice;
  float* cbuf = uhs + L.uhs;
  float* ring = cbuf + L.cbuf;
  const size_t stage = L.wst + L.ust;
  const int Rc = L.Rc, Dp = L.Dp, Dinp = L.Dinp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int consumers = RG * col;
  const bool producer = tid >= consumers;
  const int rg = producer ? 0 : tid / col;
  const int ct = producer ? 0 : tid - rg * col;
  const int o = ct / Gp;
  const int g = ct - o * Gp;
  const int d0 = g * kTC;
  const int OD = O * D;
  const int nvalid =
      !producer && o < O ? max(0, min(kTC, D - d0)) : 0;
  const int rloc0 = rg * KTR;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * Rc;
  const int nrows = min(Rc, R - row0);
  const int i_lo = static_cast<int>(static_cast<long long>(I) * rank / C);
  const int ncap =
      static_cast<int>(static_cast<long long>(I) * (rank + 1) / C) - i_lo;
  const int o_lo = O * rank / C;
  const int nq = O * (rank + 1) / C - o_lo;
  const int nsteps = iters * ncap;

  for (size_t e = tid; e < L.vbuf + L.vslice; e += blockDim.x) vbuf[e] = 0.0f;
  for (int st = 0; st < S; ++st)
    for (size_t e = tid; e < L.ust; e += blockDim.x)
      ring[st * stage + L.wst + e] = 0.0f;
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], consumers / 32);
    }
  }
  fence_init();
  __syncthreads();

  // The producer warp's copies. Step n's stage: capsule i_lo + n % ncap's
  // W slab (if staged) and its u rows.
  auto issue = [&](int n) {
    const int st = n % S;
    const int i = i_lo + n % ncap;
    float* wdst = ring + st * stage;
    float* udst = wdst + L.wst;
    const float* wsrc = W + static_cast<size_t>(i) * Din * OD;
    if (bulk) {
      const uint32_t bytes = static_cast<uint32_t>(sizeof(float)) *
                             ((WSTAGE ? Din * OD : 0) + nrows * Din);
      if (lane == 0) mbar_expect_arrive(&full[st], bytes);
      __syncwarp();
      if (WSTAGE && lane == 0)
        bulk_copy(wdst, wsrc, sizeof(float) * Din * OD, &full[st]);
      for (int r = lane; r < nrows; r += 32)
        bulk_copy(udst + r * Dinp,
                  u + (static_cast<size_t>(row0 + r) * I + i) * Din,
                  sizeof(float) * Din, &full[st]);
    } else {
      if (WSTAGE)
        for (int e = lane; e < Din * OD; e += 32) wdst[e] = __ldg(wsrc + e);
      for (int e = lane; e < nrows * Din; e += 32) {
        const int r = e / Din;
        const int k = e - r * Din;
        udst[r * Dinp + k] =
            __ldg(u + (static_cast<size_t>(row0 + r) * I + i) * Din + k);
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);
    }
  };

  // The softmax's lanes: Ls lanes a row, rpw rows a warp of the group.
  const int nw = col >> 5;
  int rpw = 1;
  while (rpw * nw < KTR && rpw < 32) rpw <<= 1;
  const int Ls = 32 / rpw;
  const int srow = (ct >> 5) * rpw + lane / Ls;     // row in the group
  const int sl = lane % Ls;
  const bool sact = srow < KTR;
  const float c0 = 1.0f / static_cast<float>(O);   // softmax of zeros
#ifdef TPUASR_ROUTING_CLOCKS
  long long clk_acc[kClockPhases] = {};
#endif

  // Step n's u_hat (capsule i_lo + j) into uh: wait for the stage, then
  // release it (this warp is done with it).
  auto u_hat = [&](int j, int n, float (&uh)[KTR][kTC]) {
    const int st = n % S;
    const float* ws = WSTAGE ? ring + st * stage
                             : W + static_cast<size_t>(i_lo + j) * Din * OD;
    const float* us = ring + st * stage + L.wst;
    mbar_wait(&full[st], (n / S) & 1);
#pragma unroll
    for (int tr = 0; tr < KTR; ++tr)
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) uh[tr][tc] = 0.0f;
    if (nvalid > 0) {
      const float* wp = ws + o * D + d0;
      for (int k4 = 0; k4 < Din; k4 += 4) {
        float w[4][kTC];
        if (vec && nvalid == kTC && k4 + 4 <= Din) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 q = *reinterpret_cast<const float4*>(
                wp + static_cast<size_t>(k4 + kk) * OD);
            w[kk][0] = q.x; w[kk][1] = q.y; w[kk][2] = q.z; w[kk][3] = q.w;
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            load_w(wp + static_cast<size_t>(k4 + kk) * OD, vec,
                   k4 + kk < Din ? nvalid : 0, w[kk]);
        }
        const float* urow = us + rloc0 * Dinp + k4;
        float x[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(
              urow + j * Dinp);
          x[j][0] = q.x; x[j][1] = q.y; x[j][2] = q.z; x[j][3] = q.w;
        }
#pragma unroll
        for (int tr = 0; tr < KTR; tr += 4) {
          // Four rows' chains interleaved; the next four's u in flight.
          float4 nx[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            nx[j] = tr + 4 < KTR ? *reinterpret_cast<const float4*>(
                                       urow + (tr + 4 + j) * Dinp)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int tc = 0; tc < kTC; ++tc)
                uh[tr + j][tc] = fmaf(x[j][kk], w[kk][tc], uh[tr + j][tc]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j][0] = nx[j].x; x[j][1] = nx[j].y; x[j][2] = nx[j].z;
            x[j][3] = nx[j].w;
          }
        }
      }
    }
    // This warp is done with the stage.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // b[i, o] = sum_d u_hat[i, o, d] V[o, d] of the thread's rows -> cb.
  auto b_of = [&](float (&uh)[KTR][kTC], float* cb) {
    // b[i, o] = sum_d u_hat[i, o, d] V[o, d] -> the b buffer.
    float pb[KTR];
#pragma unroll
    for (int tr = 0; tr < KTR; ++tr) {
      pb[tr] = 0.0f;
      if (o < O) {
        const float4 vq = *reinterpret_cast<const float4*>(
            vbuf + ((rloc0 + tr) * O + o) * Dp + d0);
        pb[tr] = fmaf(uh[tr][0], vq.x, pb[tr]);
        pb[tr] = fmaf(uh[tr][1], vq.y, pb[tr]);
        pb[tr] = fmaf(uh[tr][2], vq.z, pb[tr]);
        pb[tr] = fmaf(uh[tr][3], vq.w, pb[tr]);
      }
    }
    // The class's sums over its Gp lanes.
    float* bdst = cb + rloc0 * O + o;
    switch (Gp) {
      case 1: b_store<1>(pb, g, bdst, O, o < O); break;
      case 2: b_store<2>(pb, g, bdst, O, o < O); break;
      case 4: b_store<4>(pb, g, bdst, O, o < O); break;
      case 8: b_store<8>(pb, g, bdst, O, o < O); break;
      default:
        for (int off = Gp >> 1; off > 0; off >>= 1)
#pragma unroll
          for (int tr = 0; tr < KTR; ++tr)
            pb[tr] += __shfl_xor_sync(0xffffffffu, pb[tr], off);
        if (g == 0 && o < O)
#pragma unroll
          for (int tr = 0; tr < KTR; ++tr) bdst[tr * O] = pb[tr];
    }
  };
  // c = softmax over o of b, in place, for the group's rows.
  auto softmax = [&](float* cb) {
    // Softmax over o of the group's rows.
    float* bp = cb + (rloc0 + srow) * O;
    float m = -INFINITY;
    if (sact)
#pragma unroll 4
      for (int q = sl; q < O; q += Ls) m = fmaxf(m, bp[q]);
    for (int off = Ls >> 1; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    if (sact)
#pragma unroll 4
      for (int q = sl; q < O; q += Ls) {
        const float e = expf(bp[q] - m);
        bp[q] = e;
        sum += e;
      }
    for (int off = Ls >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (sact)
#pragma unroll 4
      for (int q = sl; q < O; q += Ls) bp[q] = bp[q] / sum;
  };
  // Thread-private shared memory for a capsule's u_hat between its b and
  // its s update (the thread's rows and d, V's layout).
  auto park = [&](const float (&uh)[KTR][kTC]) {
    if (o < O)
#pragma unroll
      for (int tr = 0; tr < KTR; ++tr)
        *reinterpret_cast<float4*>(uhs + ((rloc0 + tr) * O + o) * Dp + d0) =
            make_float4(uh[tr][0], uh[tr][1], uh[tr][2], uh[tr][3]);
  };
  // s += c u_hat of the parked capsule, c from cb.
  auto s_add = [&](float (&s)[KTR][kTC], const float* cb) {
    if (o < O)
#pragma unroll
      for (int tr = 0; tr < KTR; ++tr) {
        const float c = cb[(rloc0 + tr) * O + o];
        const float4 q = *reinterpret_cast<const float4*>(
            uhs + ((rloc0 + tr) * O + o) * Dp + d0);
        s[tr][0] = fmaf(c, q.x, s[tr][0]);
        s[tr][1] = fmaf(c, q.y, s[tr][1]);
        s[tr][2] = fmaf(c, q.z, s[tr][2]);
        s[tr][3] = fmaf(c, q.w, s[tr][3]);
      }
  };

  int n = 0;        // the consumers' step
  int issued = 0;   // the producer's
  for (int it = 0; it < iters; ++it) {
    const bool last = it + 1 == iters;
    float s[KTR][kTC];
#pragma unroll
    for (int tr = 0; tr < KTR; ++tr)
#pragma unroll
      for (int tc = 0; tc < kTC; ++tc) s[tr][tc] = 0.0f;

    if (producer) {
      // This iteration's steps and the next one's first S: each refill
      // waits until every consumer warp has released the stage, which
      // they do for steps up to the cluster barrier below.
      const int target = min(nsteps, (it + 1) * ncap + S);
      for (; issued < target; ++issued) {
        if (issued >= S)
          mbar_wait(&empty[issued % S], ((issued / S) - 1) & 1);
        issue(issued);
      }
    } else if (it == 0) {
      // c = 1/O: s += u_hat / O, no barrier.
      for (int j = 0; j < ncap; ++j, ++n) {
        CLOCK_START
        float uh[KTR][kTC];
        u_hat(j, n, uh);
        CLOCK_MARK(1)
#pragma unroll
        for (int tr = 0; tr < KTR; ++tr)
#pragma unroll
          for (int tc = 0; tc < kTC; ++tc)
            s[tr][tc] = fmaf(c0, uh[tr][tc], s[tr][tc]);
        CLOCK_MARK(5)
      }
    } else if (ncap > 0) {
      // One group barrier a step: between two barriers a warp adds c_j
      // u_hat_j (u_hat parked in its own shared memory), parks u_hat_{j+1},
      // takes the softmax of j + 1 and computes u_hat_{j+2} and its b, so
      // the softmax's latency has the next capsule's FMAs beside it. The b
      // and c buffers rotate over three.
      float uh[KTR][kTC];
      u_hat(0, n, uh);
      b_of(uh, cbuf + (n % 3) * Rc * O);
      park(uh);
      group_bar(1 + rg, col);
      softmax(cbuf + (n % 3) * Rc * O);
      if (ncap > 1) {
        u_hat(1, n + 1, uh);
        b_of(uh, cbuf + ((n + 1) % 3) * Rc * O);
      }
      for (int j = 0; j < ncap; ++j, ++n) {
        CLOCK_START
        group_bar(1 + rg, col);
        CLOCK_MARK(3)
        s_add(s, cbuf + (n % 3) * Rc * O);
        CLOCK_MARK(5)
        if (j + 1 < ncap) {
          park(uh);
          softmax(cbuf + ((n + 1) % 3) * Rc * O);
          CLOCK_MARK(4)
          if (j + 2 < ncap) {
            u_hat(j + 2, n + 2, uh);
            CLOCK_MARK(1)
            b_of(uh, cbuf + ((n + 2) % 3) * Rc * O);
            CLOCK_MARK(2)
          }
        }
      }
    }

    // The CTA's partial s over its capsules -> its V buffer (the group's
    // own rows, which only the group reads), then the cluster's sum.
    CLOCK_START
    if (!producer && o < O) {
#pragma unroll
      for (int tr = 0; tr < KTR; ++tr)
        *reinterpret_cast<float4*>(
            vbuf + (static_cast<size_t>(rloc0 + tr) * O + o) * Dp + d0) =
            make_float4(s[tr][0], s[tr][1], s[tr][2], s[tr][3]);
    }
    cluster.sync();

    // CTA `rank` owns classes [o_lo, o_lo + nq): s summed over the
    // cluster's ranks in order, squashed; V += v, written to every CTA.
    const int nitems = Rc * nq * Gp;
    const int span = (nitems + blockDim.x - 1) / blockDim.x * blockDim.x;
    for (int base = 0; base < span; base += blockDim.x) {
      const int p = base + tid;
      const bool ok = p < nitems;
      const int gg = p % Gp;
      const int q = p / Gp;
      const int oo = ok ? q % nq : 0;
      const int r = ok ? q / nq : 0;
      const size_t off = (static_cast<size_t>(r) * O + o_lo + oo) * Dp +
                         gg * kTC;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) {
        for (int rk = 0; rk < C; ++rk) {
          const float4 x =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(
                  vbuf + off, rk));
          acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
        }
      }
      float a = 0.0f;
      a = fmaf(acc.x, acc.x, a);
      a = fmaf(acc.y, acc.y, a);
      a = fmaf(acc.z, acc.z, a);
      a = fmaf(acc.w, acc.w, a);
      a = group_sum(a, Gp);
      const float inv_sq = 1.0f / sqrtf(a + kEps);
      const float scale = a / (1.0f + a) * inv_sq;
      if (!ok) continue;
      float4* vs = reinterpret_cast<float4*>(
          vslice + (static_cast<size_t>(r) * L.nq + oo) * Dp + gg * kTC);
      if (last) {
        const int row = row0 + r;
        if (row < R) {
          const float sv[kTC] = {acc.x, acc.y, acc.z, acc.w};
          const float4 vv = *vs;
          const float Vv[kTC] = {vv.x, vv.y, vv.z, vv.w};
          const size_t ob =
              (static_cast<size_t>(row) * O + o_lo + oo) * D + gg * kTC;
          for (int t = 0; t < kTC && gg * kTC + t < D; ++t) {
            v[ob + t] = scale * sv[t];
            if (Vo != nullptr) {
              Vo[ob + t] = Vv[t];
              so[ob + t] = sv[t];
            }
          }
        }
      } else {
        float4 nv = *vs;
        nv.x += scale * acc.x;
        nv.y += scale * acc.y;
        nv.z += scale * acc.z;
        nv.w += scale * acc.w;
        *vs = nv;
        for (int rk = 0; rk < C; ++rk)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(vbuf + off, rk)) =
              nv;
      }
    }
    cluster.sync();
    CLOCK_MARK(6)
  }
#ifdef TPUASR_ROUTING_CLOCKS
  if (tid == 0 && blockIdx.x < kClockBlocks)
    for (int p = 0; p < kClockPhases; ++p)
      g_routing_clocks[blockIdx.x][p] += clk_acc[p];
#endif
}

// The kernel instance for a plan: W staged, or read from L2.
template <bool WSTAGE>
cudaError_t launch_plan(const float* u, const float* W, float* v, float* Vo,
                        float* so, int R, int I, int Din, int O, int D,
                        int iters, int Gp, int col, int C, int RG, int S,
                        size_t smem, bool count_only,
                        int* clusters, cudaStream_t stream) {
  const auto kernel = routing_fwd_kernel<WSTAGE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int Rc = kRowsPerThread * RG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>((max(R, 1) + Rc - 1) / Rc * C));
  cfg.blockDim = dim3(static_cast<unsigned>(RG * col + 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (count_only)
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  const bool bulk = Din % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const bool vec = D % kTC == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  e = cudaLaunchKernelEx(&cfg, kernel, u, W, v, Vo, so, R, I, Din, O, D,
                         iters, Gp, col, C, RG, S, bulk, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Checks a plan against the shape and launches it (or, count_only, asks
// how many of its clusters the card holds at once).
int routing(const float* u, const float* W, float* v, float* Vo, float* so,
            int R, int I, int Din, int O, int D, int iters, int C, int RG,
            int S, int wide, size_t smem, bool count_only,
            int* clusters, cudaStream_t stream) {
  if (R < 0 || I < 1 || Din < 1 || Din > 16 || O < 1 || D < 1 ||
      iters < 1 || C < 1 || C > kMaxCluster || RG < 1 || S < 1 ||
      (Vo == nullptr) != (so == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (D + kTC - 1) / kTC;
  int Gp = 1;
  while (Gp < G) Gp <<= 1;
  if (Gp > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int col = (O * Gp + 31) / 32 * 32;
  if (RG * col + 32 > (wide ? kWideThreads : kStagedThreads) || RG > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(!wide, C, RG, S, Din, O, D, Gp);
  if (L.bytes != smem || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 && !count_only) return 0;
  const cudaError_t e =
      wide ? launch_plan<false>(u, W, v, Vo, so, R, I, Din, O, D, iters, Gp,
                                col, C, RG, S, smem, count_only,
                                clusters, stream)
           : launch_plan<true>(u, W, v, Vo, so, R, I, Din, O, D, iters, Gp,
                               col, C, RG, S, smem, count_only,
                               clusters, stream);
  return static_cast<int>(e);
}

}  // namespace

// Bytes of shared memory a CTA of this plan takes (the kernel's layout);
// routing_plan in ops/routing.py computes the same.
extern "C" long long tpuasr_routing_smem(int Din, int O, int D, int C,
                                         int RG, int S, int wide) {
  const int G = (D + kTC - 1) / kTC;
  int Gp = 1;
  while (Gp < G) Gp <<= 1;
  return static_cast<long long>(
      layout(!wide, C, RG, S, Din, O, D, Gp).bytes);
}

// K8: v (R, O, D) for u (R, I, Din) and W (I, Din, O*D); with V and s
// non-null (the saving mode) also each row's V = v_0 + ... + v_{iters-2}
// and final s, (R, O, D) each. (C, RG, S, wide, smem) is routing_plan's
// plan: clusters of C CTAs, RG row groups of 8 rows, S ring stages, W read
// from L2 (wide) or staged.
// Takes Din in [1, 16], O * next_pow2(ceil(D / 4)) <= 512, iters >= 1;
// anything else, or a plan whose layout is not smem bytes, returns
// cudaErrorInvalidValue without launching.
extern "C" int tpuasr_routing_fwd(const float* u, const float* W, float* v,
                                  float* V, float* s, int R, int I, int Din,
                                  int O, int D, int iters, int C, int RG,
                                  int S, int wide, long long smem,
                                  cudaStream_t stream) {
  return routing(u, W, v, V, s, R, I, Din, O, D, iters, C, RG, S, wide,
                 static_cast<size_t>(smem), false, nullptr, stream);
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int tpuasr_routing_max_clusters(int I, int Din, int O, int D,
                                           int C, int RG, int S, int wide,
                                           long long smem, int* clusters) {
  return routing(nullptr, nullptr, nullptr, nullptr, nullptr, 1, I, Din, O,
                 D, 1, C, RG, S, wide, static_cast<size_t>(smem),
                 true, clusters, nullptr);
}

#ifdef TPUASR_ROUTING_CLOCKS
// Copies the per-CTA phase sums of the first n CTAs into out (n x
// kClockPhases) and zeroes them.
extern "C" int tpuasr_routing_clocks(unsigned long long* out, int n) {
  static unsigned long long host[kClockBlocks][kClockPhases];
  cudaError_t e = cudaMemcpyFromSymbol(host, g_routing_clocks, sizeof(host));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int b = 0; b < n && b < kClockBlocks; ++b)
    for (int p = 0; p < kClockPhases; ++p)
      out[b * kClockPhases + p] = host[b][p];
  static const unsigned long long zero[kClockBlocks][kClockPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_routing_clocks, zero, sizeof(zero)));
}
#endif
