// The top-P CTC prefix beam search (the scan search), every frame of a
// batch in one launch, with the decoding graph's packed row fetch inside.
//
// Replaces K10, gather_rows of tpuasr/ops/pallas_gather.py (pallas_call at
// line 82, _gather_kernel :38-66, a ring of 16 outstanding DMAs), together
// with the lax.scan step that calls it once a frame,
// tpuasr/decode/prefix_beam.py:261-420 (the packed table is built at
// :236-259). Per frame and utterance it computes exactly what the plain
// version, decode/prefix_beam.py::scan_search_plain, computes:
//   1. each beam's packed row [next states | cost bits] of the (S, 2C)
//      int32 table, for its graph state gs (K10's fetch);
//   2. the top P classes per beam: with a graph by sel = lp_nb - g_w * cost,
//      classes whose next state is below 0 at NEG_INF; without a graph by
//      lp_nb itself (the same list for every beam, which is what the plain
//      version's batch-level top_k broadcasts). Descending, ties to the
//      lower class (a stable sort, lax.top_k);
//   3. the stays and the K*P extends: the repeat rule, the max_len kill, the
//      graph transition (a forbidden extend is killed, its gc unchanged, its
//      gs clamped to 0), the uint32 rolling hashes, the LM row of the
//      beam's context;
//   4. the hash join of the extends into the beams, absorbed into the
//      stays' p_nb as cmax + log(sum(exp(contrib - cmax)) + 1e-38), then
//      logaddexp;
//   5. the top K of the K + K*P candidates by logaddexp(p_b, p_nb) + lm_w
//      * lm - g_w * gc, ties to the lower flat index (stays 0..K-1, then
//      beam k's extends at K + k*P + p, p the position in its top-P list);
//   6. the next state (frames past an utterance's length leave it frozen);
//   7. the backpointers, packed as K3's: parent * 65536 + char + 1, (T, B,
//      K) int32 (identity past the length: own lane, no char).
// The prefixes are rebuilt from the backpointers by csrc/ctc_beam.cu's
// backtrack kernel (tpuasr_ctc_rebuild), a second launch.
//
// What bounds it on the H100: latency. The bytes are the log-probs (16.4 MB
// at B=128, T=499, C=64), the rows read (512 B each, the bench table's 29.8
// MB stays in the 50 MB L2) and the backpointers (2 MB); but each frame is a
// dependent chain (a row read, two rankings, a join, a merge) and the frames
// run in order.
//
// Design: one CTA an utterance (B CTAs, one wave at B=128 on 132 SMs), one
// warp a beam (32*K threads). The beam state sits in shared memory in two
// buffers (this frame's and the next). Lane l holds the classes l, l+32,
// ... (E of them: E = 2 up to C=64, 8 up to 256, 32 up to 1024) and their
// log-probs in registers, the next frame's loaded while a frame runs. Per
// frame, three block barriers:
//   S1. warp k reads beam k's row from global memory (the previous frame
//       asked L1 to prefetch each candidate's row), builds each class's
//       64-bit key (the float's order-preserving bits, then the class: a
//       total order, the stable sort's) and sorts the warp's keys with a
//       bitonic network in registers (shuffles across lanes); position p =
//       e*32 + lane then holds the p-th best class, and positions 0..P-1
//       are beam k's extends. Each extend is scored and joined forward
//       against the K beam hashes (a match records its mass for the target
//       beam and kills the extend). Where P <= K every extend goes to beam
//       k's list at its position; where P > K a second bitonic sort of the
//       extends' totals (then the position) keeps the top K. Beside the
//       sort every lane computes stay k's total as it stands if no extend
//       joins it;
//   S2. lane 0 of warp j, where an extend joined stay j, absorbs the
//       matched mass and ranks the stay again;
//   S3. four lanes rank candidate e of the stays and the K lists by
//       counting (the lists keep the flat order: stays, then beam k's list
//       at K + k*K + slot), and a candidate of rank s < K writes lane s of
//       the next state and its backpointer.
// What was measured slower and went (PERF.md): ranking each beam's classes
// and extends by counting (each lane over every key) instead of sorting;
// staging the candidates' rows and the log-prob row in shared memory by
// cp.async (no shorter fetch, and at B=128 the copies doubled the frame);
// a thread a candidate in S3 (a quad of lanes is faster);
// sorting only the top next_pow2(P) of the keys where P <= 16 (folding
// sorted groups: no faster, the sort's shuffle chain is as long); the
// 64-key sort as a rolled loop (slower, though the unrolled kernel is
// several thousand instructions long).
//
// Exactness: every add and multiply is rounded as the plain version's
// separate torch ops round it (__fadd_rn, __fmul_rn, __fsub_rn: no
// contraction into an FMA), logaddexp is max + log1p(exp(min - max)), exp
// and log are the IEEE expf/log1pf/logf (this library is never built with
// fast math, so no denormal is flushed). The absorbed sum has one live term
// (a beam's prefix is spelled by at most one live extend), and its other
// terms are exactly 0 or 1, so its order cannot change the bits. The
// table's cost half is read as int32 and reinterpreted only in registers:
// small state ids are denormal float bit patterns, and the TPU's float path
// flushed them to zero (tpuasr/decode/prefix_beam.py:245-251).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 40503u;
constexpr int kMaxK = 32;
constexpr int kMaxC = 1024;
// SM clock cycles of each part of a frame, summed over the frames, as
// thread 0 (lane 0 of beam 0's warp) sees them: fetch (the state, the row
// and the keys), top-P (the class sort), extends (their scores and the
// join), lists (the local top K and the stay's terms), wait 1, stays,
// wait 2, merge (the candidate ranking and the next state), wait 3.
constexpr int kClockParts = 9;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Offsets (32-bit words) of the block's shared memory, each 16-byte
// aligned (kr = K rounded up to 4): the state [2][10][kr] (p_b, p_nb, lm,
// gc as floats, then h1, h2, last, last2, plen, gs); the joined masses
// [target][source] [K][K]; the match bits of each target [kr]; the
// candidate totals [nr] (K stays, then the lists [K][K], padded to a
// multiple of 16 for the merge's four parts of float4s); the lists'
// payload [5][K][K] (p_nb, lm, gc, gs, class); the stays' p_b, p_nb and
// p_nb before the join [3][kr].
struct Layout {
  int kr, nr;
  int st, cv, mm, ent, lst, stay, words;
};

__host__ __device__ inline Layout layout(int K) {
  Layout l;
  l.kr = round4(K);
  l.nr = round16(K + K * K);
  int o = 0;
  l.st = o;
  o += 20 * l.kr;
  l.cv = o;
  o += round4(K * K);
  l.mm = o;
  o += l.kr;
  l.ent = o;
  o += l.nr;
  l.lst = o;
  o += round4(5 * K * K);
  l.stay = o;
  o += 3 * l.kr;
  l.words = o;
  return l;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = __fsub_rn(fminf(a, b), m);
  // Far below -104 expf is 0 and log1pf(0) is 0: the same bits without the
  // two calls.
  if (d < -200.f) return __fadd_rn(m, 0.f);
  return __fadd_rn(m, log1pf(expf(d)));
}

// The float's order-preserving bits (-0 first made +0, which a float
// comparison, and so the stable sort, holds equal to +0).
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const uint32_t lo = __shfl_xor_sync(kFull, static_cast<uint32_t>(v), m);
  const uint32_t hi =
      __shfl_xor_sync(kFull, static_cast<uint32_t>(v >> 32), m);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Sorts the warp's 32*E keys in descending order, key i = e*32 + lane: a
// bitonic network, in registers within a lane, by shuffles across lanes.
template <int E>
__device__ __forceinline__ void warp_sort(uint64_t (&key)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int es = stride >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          const bool desc = ((e * 32) & size) == 0;
          const uint64_t a = key[e], b = key[e | es];
          const bool sw = desc ? a < b : a > b;
          key[e] = sw ? b : a;
          key[e | es] = sw ? a : b;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const uint64_t q = shfl_xor64(key[e], stride);
          const bool lower = (lane & stride) == 0;
          const bool desc = ((e * 32 + lane) & size) == 0;
          const bool keep_max = lower == desc;
          const uint64_t mx = key[e] > q ? key[e] : q;
          const uint64_t mn = key[e] > q ? q : key[e];
          key[e] = keep_max ? mx : mn;
        }
      }
    }
  }
}

// Class c's value of a per-class register array (class c = e*32 + lane
// is held by lane c % 32 as a[c / 32]), by shuffles; every lane calls it.
template <int E, class V>
__device__ __forceinline__ V from_owner(const V (&a)[E], int c) {
  V r = a[0];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const V x = __shfl_sync(kFull, a[e], c & 31);
    if ((c >> 5) == e) r = x;
  }
  return r;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" :: "l"(p));
}

// The sums sit in shared memory (clk), not in registers.
#define SCAN_CLOCK(P)                   \
  do {                                  \
    if (timing) {                       \
      const long long now = clock64();  \
      clk[P] += now - clk_t;            \
      clk_t = now;                      \
    }                                   \
  } while (0)

// E classes a lane; MAXT threads a block at most. With 256 (K <= 8) a
// thread may hold 106 registers and spills none; under 1024 it is held to
// 64 and spills, and the served shape (B=128, K=8, C=64) ran 10% slower in
// turns on an H100 (PERF.md, K10).
template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT)
scan_beam_kernel(const float* __restrict__ lp,      // (B, T, C)
                 const int* __restrict__ lens,      // (B,)
                 const int* __restrict__ g_pack,    // (S, 2C) or null
                 const float* __restrict__ lm_tab,  // (R, C) or null
                 const float* __restrict__ fst_in,  // (4, B, K)
                 const int* __restrict__ ist_in,    // (6, B, K)
                 float* __restrict__ fst_out,       // (4, B, K)
                 int* __restrict__ ist_out,         // (6, B, K)
                 int* __restrict__ bp,              // (T, B, K)
                 long long* __restrict__ clk_out,   // (B, kClockParts) or null
                 int S, int B, int T, int C, int K, int P, int blank,
                 int max_len, int lm_order, float lm_w, float g_w) {
  extern __shared__ __align__(16) float smem[];
  const Layout ly = layout(K);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int w = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int kr = ly.kr, KK = K * K, N = K + KK;
  const int nlist = min(K, P);
  const int RW = 2 * C;                 // a graph row, in words
  float* stw = smem + ly.st;
  float* cv = smem + ly.cv;
  uint32_t* mm = reinterpret_cast<uint32_t*>(smem + ly.mm);
  float* ent = smem + ly.ent;
  float* lst = smem + ly.lst;
  int* lsti = reinterpret_cast<int*>(lst);
  float* stay = smem + ly.stay;
  const bool graph = g_pack != nullptr;
  const int len = max(0, min(lens[b], T));
  const float* lp_b = lp + static_cast<size_t>(b) * T * C;
  const size_t BK = static_cast<size_t>(B) * K;
  auto g_row = [&](int g) {
    return g_pack + static_cast<size_t>(min(max(g, 0), S - 1)) * RW;
  };
  // The absorbed mass of a stay that no extend spells: cmax = NEG_INF and
  // K*P terms exp(0) = 1.
  const float absorbed0 = __fadd_rn(
      kNegInf, logf(__fadd_rn(__fmul_rn(static_cast<float>(K * P),
                                        expf(__fsub_rn(kNegInf, kNegInf))),
                              1e-38f)));

  for (int i = tid; i < K; i += nthr) {
    for (int f = 0; f < 4; ++f) stw[f * kr + i] = fst_in[f * BK + b * K + i];
    int* sti = reinterpret_cast<int*>(stw) + 4 * kr;
    for (int f = 0; f < 6; ++f) sti[f * kr + i] = ist_in[f * BK + b * K + i];
    mm[i] = 0u;
  }
  // Empty list slots (at or past min(K, P)) and the padding are NaN: no
  // comparison finds them better than a candidate.
  for (int i = tid; i < ly.nr; i += nthr) ent[i] = __int_as_float(0x7fffffff);
  // This frame's log-probs of the lane's classes.
  float lpv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = lane + 32 * e;
    lpv[e] = len > 0 && c < C ? __ldg(lp_b + c) : 0.f;
  }
  __syncthreads();

  const bool timing = clk_out != nullptr && tid == 0;
  __shared__ long long clk[kClockParts];
  if (timing)
    for (int q = 0; q < kClockParts; ++q) clk[q] = 0;
  long long clk_t = timing ? clock64() : 0;

  for (int t = 0; t < len; ++t) {
    const int cb = t & 1;
    const float* lp_t = lp_b + static_cast<size_t>(t) * C;
    float lpx[E];                       // the next frame's, meanwhile
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = lane + 32 * e;
      lpx[e] = t + 1 < len && c < C ? __ldg(lp_t + C + c) : 0.f;
    }
    const float* sf = stw + cb * 10 * kr;                 // this frame
    const int* si = reinterpret_cast<const int*>(sf) + 4 * kr;
    float* nf = stw + (cb ^ 1) * 10 * kr;                 // the next
    int* ni = reinterpret_cast<int*>(nf) + 4 * kr;

    // ---- S1: warp k, beam k ----
    {
      const int k = w;
      const float pb = sf[k], pnb = sf[kr + k], lmk = sf[2 * kr + k];
      const float gck = sf[3 * kr + k];
      const uint32_t h1 = static_cast<uint32_t>(si[k]);
      const uint32_t h2 = static_cast<uint32_t>(si[kr + k]);
      const int last = si[2 * kr + k], last2 = si[3 * kr + k];
      const int plen = si[4 * kr + k], gs = si[5 * kr + k];
      const int* rg = graph ? g_row(gs) : nullptr;
      const float* trow =
          lm_order == 0
              ? nullptr
              : lm_tab + static_cast<size_t>(
                             lm_order == 3 ? (last2 + 1) * (C + 1) + last + 1
                                           : last + 1) * C;
      int nx[E];
      float cs[E], lmv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = lane + 32 * e;
        nx[e] = -1;
        cs[e] = 0.f;
        lmv[e] = 0.f;
        if (c < C) {
          if (graph) {
            nx[e] = __ldg(rg + c);
            cs[e] = __int_as_float(__ldg(rg + C + c));
          }
          if (trow) lmv[e] = __ldg(trow + c);
        }
      }
      uint64_t key[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = lane + 32 * e;
        key[e] = 0ull;
        if (c < C) {
          const float lpn = c == blank ? kNegInf : lpv[e];
          float s = lpn;
          if (graph) s = nx[e] >= 0 ? __fsub_rn(lpn, __fmul_rn(g_w, cs[e]))
                                    : kNegInf;
          key[e] = (static_cast<uint64_t>(ordered(s)) << 32) |
                   (0xffffffffu - static_cast<uint32_t>(c));
        }
      }
      // Stay k, as it stands if no extend spells its prefix (S2 redoes the
      // few that absorb one). Every lane computes it, beside the sort.
      const float ptot = logaddexp(pb, pnb);
      float lp_blank, lp_last;
      if constexpr (E <= 2) {
        lp_blank = from_owner<E>(lpv, blank);
        lp_last = from_owner<E>(lpv, min(max(last, 0), C - 1));
      } else {
        lp_blank = __ldg(lp_t + blank);
        lp_last = __ldg(lp_t + min(max(last, 0), C - 1));
      }
      const float spb = __fadd_rn(ptot, lp_blank);
      const float spn_raw = __fadd_rn(pnb, lp_last);
      const float spn0 = logaddexp(spn_raw, absorbed0);
      float st0 = __fadd_rn(logaddexp(spb, spn0), __fmul_rn(lm_w, lmk));
      if (graph) st0 = __fsub_rn(st0, __fmul_rn(g_w, gck));
      SCAN_CLOCK(0);
      warp_sort<E>(key, lane);
      SCAN_CLOCK(1);

      // Class c's log-prob, next state, cost and LM score, from the lane
      // that holds them (E <= 2) or from memory, for the lanes with ok.
      auto fetch = [&](int c, bool ok, float* lpc, int* nxc, float* csc,
                       float* lmc) {
        if constexpr (E <= 2) {
          *lpc = from_owner<E>(lpv, c & 1023);
          *nxc = from_owner<E>(nx, c & 1023);
          *csc = from_owner<E>(cs, c & 1023);
          *lmc = from_owner<E>(lmv, c & 1023);
        } else {
          *lpc = 0.f;
          *nxc = -1;
          *csc = 0.f;
          *lmc = 0.f;
          if (ok) {
            *lpc = __ldg(lp_t + c);
            if (graph) {
              *nxc = __ldg(rg + c);
              *csc = __int_as_float(__ldg(rg + C + c));
            }
            if (trow) *lmc = __ldg(trow + c);
          }
        }
      };
      // Position p = e*32 + lane < P: beam k's extend by class c.
      const bool capped = plen >= max_len;
      // The extend by c before the join: its p_nb (v), gc and gs.
      auto extend = [&](int c, float lpc, int nxc, float csc, float* gcn,
                        int* gsn) {
        const float lpn = c == blank ? kNegInf : lpc;
        float v = __fadd_rn(c == last ? pb : ptot, lpn);
        if (capped) v = kNegInf;
        *gcn = gck;
        *gsn = 0;
        if (graph) {
          if (nxc < 0) v = kNegInf;
          *gcn = __fadd_rn(gck, nxc < 0 ? 0.f : csc);
          *gsn = max(nxc, 0);
        }
        return v;
      };
      int cls[E], nxs[E];
      float lps[E], css[E], lms[E], tot[E];
      uint32_t killed = 0u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        cls[e] = static_cast<int>(0xffffffffu -
                                  static_cast<uint32_t>(key[e]));
        fetch(cls[e], e * 32 + lane < P, &lps[e], &nxs[e], &css[e], &lms[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        tot[e] = 0.f;
        if (e * 32 + lane >= P) continue;
        const int c = cls[e];
        float gcn;
        int gsn;
        const float v = extend(c, lps[e], nxs[e], css[e], &gcn, &gsn);
        const uint32_t e1 = h1 * kM1 + static_cast<uint32_t>(c + 1);
        const uint32_t e2 = h2 * kM2 + static_cast<uint32_t>(c + 1);
        bool hit = false;
        for (int j0 = 0; j0 < K; j0 += 4) {
          const uint4 a = *reinterpret_cast<const uint4*>(si + j0);
          const uint4 z = *reinterpret_cast<const uint4*>(si + kr + j0);
          const uint32_t av[4] = {a.x, a.y, a.z, a.w};
          const uint32_t zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (j0 + i < K && av[i] == e1 && zv[i] == e2) {
              hit = true;
              cv[(j0 + i) * K + k] = v;
              atomicOr(mm + j0 + i, 1u << k);
            }
          }
        }
        if (hit) killed |= 1u << e;
        const float pn = hit ? kNegInf : v;
        const float lme = lm_order ? __fadd_rn(lmk, lms[e]) : lmk;
        float tt = __fadd_rn(logaddexp(kNegInf, pn), __fmul_rn(lm_w, lme));
        if (graph) tt = __fsub_rn(tt, __fmul_rn(g_w, gcn));
        tot[e] = tt;
        if (P <= K) {                   // the list in position order
          const int slot = k * K + e * 32 + lane;
          ent[K + slot] = tt;
          lst[slot] = pn;
          lst[KK + slot] = lme;
          lst[2 * KK + slot] = gcn;
          lsti[3 * KK + slot] = gsn;
          lsti[4 * KK + slot] = c;
          if (graph && C <= 128)        // the next frame's row, into L1
            for (int off = 0; off < 8 * C; off += 128)
              prefetch_l1(reinterpret_cast<const char*>(g_row(gsn)) + off);
        }
      }
      SCAN_CLOCK(2);

      if (P > K) {
        // The top K of the P extends: sorted by (total desc, position
        // asc); the key's low word carries the position, the kill and the
        // class.
        uint64_t k2[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = e * 32 + lane;
          k2[e] = p < P ? (static_cast<uint64_t>(ordered(tot[e])) << 32) |
                              (static_cast<uint32_t>(0xffff - p) << 16) |
                              (((killed >> e) & 1u) << 15) |
                              static_cast<uint32_t>(cls[e])
                        : 0ull;
        }
        warp_sort<E>(k2, lane);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int q = e * 32 + lane;
          const int c = static_cast<int>(k2[e] & 0x7fffu);
          float lpc, csc, lmc;
          int nxc;
          fetch(c, q < K, &lpc, &nxc, &csc, &lmc);
          if (q >= K) continue;
          float gcn;
          int gsn;
          float v = extend(c, lpc, nxc, csc, &gcn, &gsn);
          if ((k2[e] >> 15) & 1u) v = kNegInf;
          const int slot = k * K + q;
          // The total, back from its order-preserving bits.
          const uint32_t ob = static_cast<uint32_t>(k2[e] >> 32);
          ent[K + slot] =
              __uint_as_float((ob & 0x80000000u) ? (ob ^ 0x80000000u) : ~ob);
          lst[slot] = v;
          lst[KK + slot] = lm_order ? __fadd_rn(lmk, lmc) : lmk;
          lst[2 * KK + slot] = gcn;
          lsti[3 * KK + slot] = gsn;
          lsti[4 * KK + slot] = c;
          if (graph && C <= 128)
            for (int off = 0; off < 8 * C; off += 128)
              prefetch_l1(reinterpret_cast<const char*>(g_row(gsn)) + off);
        }
      }
      if (lane == 0) {
        stay[k] = spb;
        stay[kr + k] = spn0;
        stay[2 * kr + k] = spn_raw;
        ent[k] = st0;
      }
      SCAN_CLOCK(3);
    }
    __syncthreads();
    SCAN_CLOCK(4);

    // ---- S2: stay j absorbs the extends that spell its prefix ----
    if (lane == 0 && mm[w]) {
      const int j = w;
      const uint32_t m = mm[j];
      mm[j] = 0u;
      const int nun = K * P - __popc(m);
      float cmax = nun > 0 ? kNegInf : -INFINITY;
      for (uint32_t r = m; r; r &= r - 1)
        cmax = fmaxf(cmax, cv[j * K + __ffs(r) - 1]);
      float s = 0.f;
      for (uint32_t r = m; r; r &= r - 1)
        s = __fadd_rn(s, expf(__fsub_rn(cv[j * K + __ffs(r) - 1], cmax)));
      if (nun > 0)
        s = __fadd_rn(s, __fmul_rn(static_cast<float>(nun),
                                   expf(__fsub_rn(kNegInf, cmax))));
      const float absorbed = __fadd_rn(cmax, logf(__fadd_rn(s, 1e-38f)));
      const float spb = stay[j];
      const float spn = logaddexp(stay[2 * kr + j], absorbed);
      float tt = __fadd_rn(logaddexp(spb, spn),
                           __fmul_rn(lm_w, sf[2 * kr + j]));
      if (graph) tt = __fsub_rn(tt, __fmul_rn(g_w, sf[3 * kr + j]));
      ent[j] = tt;
      stay[kr + j] = spn;
    }
    SCAN_CLOCK(5);
    __syncthreads();
    SCAN_CLOCK(6);

    // ---- S3: the top K of the stays and the lists ----
    // Four lanes count candidate e's rank, a quarter of the totals each,
    // and sum by shuffles; every lane takes part in every pass.
    int* bp_t = bp + (static_cast<size_t>(t) * B + b) * K;
    const int quarter = ly.nr / 4;
    for (int base = 0; base < 4 * N; base += nthr) {
      const int idx = base + tid, e = idx >> 2, part = idx & 3;
      // An empty slot, or past the candidates, counts nothing.
      const bool live = e < N && (e < K || (e - K) % K < nlist);
      const float tv = live ? ent[e] : 0.f;
      int r = 0;
      if (live)
        for (int e0 = part * quarter; e0 < (part + 1) * quarter; e0 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(ent + e0);
          r += (x.x > tv) | ((x.x == tv) & (e0 < e));
          r += (x.y > tv) | ((x.y == tv) & (e0 + 1 < e));
          r += (x.z > tv) | ((x.z == tv) & (e0 + 2 < e));
          r += (x.w > tv) | ((x.w == tv) & (e0 + 3 < e));
        }
      r += __shfl_xor_sync(kFull, r, 1);
      r += __shfl_xor_sync(kFull, r, 2);
      if (!live || part != 0 || r >= K) continue;
      const int s = r;
      if (e < K) {                      // stay e
        nf[s] = stay[e];
        nf[kr + s] = stay[kr + e];
        nf[2 * kr + s] = sf[2 * kr + e];
        nf[3 * kr + s] = sf[3 * kr + e];
        for (int f = 0; f < 6; ++f) ni[f * kr + s] = si[f * kr + e];
        bp_t[s] = e * 65536;
      } else {                          // an extend of beam k by class c
        const int slot = e - K, k = slot / K;
        const int c = lsti[4 * KK + slot];
        nf[s] = kNegInf;
        nf[kr + s] = lst[slot];
        nf[2 * kr + s] = lst[KK + slot];
        nf[3 * kr + s] = lst[2 * KK + slot];
        ni[s] = static_cast<int>(static_cast<uint32_t>(si[k]) * kM1 +
                                 static_cast<uint32_t>(c + 1));
        ni[kr + s] = static_cast<int>(static_cast<uint32_t>(si[kr + k]) *
                                          kM2 +
                                      static_cast<uint32_t>(c + 1));
        ni[2 * kr + s] = c;
        ni[3 * kr + s] = si[2 * kr + k];
        ni[4 * kr + s] = si[4 * kr + k] + 1;
        ni[5 * kr + s] = lsti[3 * KK + slot];
        bp_t[s] = k * 65536 + c + 1;
      }
    }
    SCAN_CLOCK(7);
#pragma unroll
    for (int e = 0; e < E; ++e) lpv[e] = lpx[e];
    __syncthreads();
    SCAN_CLOCK(8);
  }
  if (timing)
    for (int q = 0; q < kClockParts; ++q)
      clk_out[b * kClockParts + q] = clk[q];

  // Frames past the length: identity backpointers; then the final state.
  for (int i = tid; i < (T - len) * K; i += nthr) {
    const int t = len + i / K, k = i - (i / K) * K;
    bp[(static_cast<size_t>(t) * B + b) * K + k] = k * 65536;
  }
  const float* ff = stw + (len & 1) * 10 * kr;
  const int* fi = reinterpret_cast<const int*>(ff) + 4 * kr;
  for (int i = tid; i < K; i += nthr) {
    for (int f = 0; f < 4; ++f) fst_out[f * BK + b * K + i] = ff[f * kr + i];
    for (int f = 0; f < 6; ++f) ist_out[f * BK + b * K + i] = fi[f * kr + i];
  }
}

}  // namespace

// The dynamic shared memory of a block of beam K, in bytes.
extern "C" long long tpuasr_scan_beam_smem(int K) {
  return 4LL * layout(K).words;
}

extern "C" int tpuasr_scan_beam_clock_parts() { return kClockParts; }

// The scan search over all T frames of a batch: log-probs (B, T, C), lengths
// (B,), the packed graph table (S, 2C) int32 or null, the fusion table (C+1,
// C) for lm_order 2 or ((C+1)^2, C) for lm_order 3 or null with lm_order 0,
// the state (4, B, K) float32 (p_b, p_nb, lm, gc) and (6, B, K) int32 (h1,
// h2, last, last2, plen, gs) in and out, and the packed backpointers (T, B,
// K). clocks: (B, tpuasr_scan_beam_clock_parts()) int64 or null. A block
// is K warps with tpuasr_scan_beam_smem(K) bytes of dynamic shared memory;
// a shape outside the limits (K 1-32, C 2-1024, P 1 to C-1) is refused.
extern "C" int tpuasr_scan_beam(const float* lp, const int* lens,
                                const int* g_pack, const float* lm_tab,
                                const float* fst_in, const int* ist_in,
                                float* fst_out, int* ist_out, int* bp,
                                long long* clocks, int S, int B, int T, int C,
                                int K, int P, int blank, int max_len,
                                int lm_order, float lm_w, float g_w,
                                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK || C < 2 || C > kMaxC || P < 1 || P > C - 1 ||
      T < 0 || blank < 0 || blank >= C || (g_pack && S < 1) ||
      (lm_order != 0 && lm_order != 2 && lm_order != 3) ||
      (lm_order && !lm_tab))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(tpuasr_scan_beam_smem(K));
  const bool narrow = K <= 8 && C <= 64;
  const void* kernel =
      narrow ? reinterpret_cast<const void*>(scan_beam_kernel<2, 256>)
      : C <= 64 ? reinterpret_cast<const void*>(scan_beam_kernel<2, 1024>)
      : C <= 256 ? reinterpret_cast<const void*>(scan_beam_kernel<8, 1024>)
                 : reinterpret_cast<const void*>(scan_beam_kernel<32, 1024>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B), block(32 * K);
#define SCAN_LAUNCH(EV, MT)                                                 \
  scan_beam_kernel<EV, MT><<<grid, block, smem, stream>>>(                  \
      lp, lens, g_pack, lm_tab, fst_in, ist_in, fst_out, ist_out, bp,       \
      clocks, S, B, T, C, K, P, blank, max_len, lm_order, lm_w, g_w)
  if (narrow)
    SCAN_LAUNCH(2, 256);
  else if (C <= 64)
    SCAN_LAUNCH(2, 1024);
  else if (C <= 256)
    SCAN_LAUNCH(8, 1024);
  else
    SCAN_LAUNCH(32, 1024);
#undef SCAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
