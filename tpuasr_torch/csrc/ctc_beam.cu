// CTC prefix beam search, the whole per-frame update in one kernel, and the
// backtrack of its packed backpointers.
//
// Replaces K3, _beam_kernel of tpuasr/decode/pallas_beam.py (built by
// _build, pallas_call at line 455), with and without shallow LM fusion:
// per frame it scores stay and extend candidates over ALL classes, merges
// extends into existing beams through the inverse-hash join, keeps the top
// K in a fixed tie order, gives dead selections fresh hashes, enforces the
// max_len cap and writes packed backpointers parent * 65536 + char + 1.
// The backtrack kernel replaces the reverse lax.scan of the same wrapper
// (pallas_beam.py:612-629): it walks the backpointers from the final
// beams and left-compacts the tokens. With a base (tpuasr_ctc_rebuild) it
// also rebuilds the scan search's prefixes (csrc/scan_beam.cu's
// backpointers, the reverse lax.scan of tpuasr/decode/prefix_beam.py:
// 431-457): every lane is walked to its root lane at frame 0, and its chars
// go after the root's resumed prefix.
//
// LM fusion (lm_order 2 or 3): each beam carries its cumulative LM score
// lm[k]; an extend by class c ranks by ext + lm_w * (lm[k] + row[c]), a
// stay by stay_tot + lm_w * lm[k], where row is the fusion table's row for
// the beam's context: last + 1 for the bigram table (C+1, C), (last2 + 1) *
// (C+1) + last + 1 for the flattened trigram table ((C+1)^2, C). The stored
// p_b/p_nb stay acoustic; the winner's lm rides into its lane, dead lanes
// reset it to 0, and finished rows keep theirs. last2 (the token before
// last) is tracked only where something consumes it (pallas_beam.py:
// 564-566). The TPU fetched the row with a one-hot matmul (no dynamic VMEM
// indexing); here the row is read directly: the bigram table (16.6 KB at
// C=64) is staged in shared memory once a block, the trigram table (1.08 MB
// at C=64) is read from global memory through L2.
//
// What bounds it on the H100: latency. Each frame is a chain of small
// dependent steps (K stays, the K x K join, K + K*C candidates, the top K)
// for one utterance, and T frames run in sequence; the bytes are only C
// floats in and K ints out per frame.
//
// Design: one warp owns one utterance and several utterances share a block
// (decode/beam.py::beam_plan); the only block barrier is the staging
// of the bigram table before the frame loop, so a frame costs __syncwarp
// and shuffles only. The beam state (p_b, p_nb, lm, h1, h2, last, last2,
// plen) sits in the warp's own shared memory, in two buffers (this frame's
// and the next). Per frame:
//   A. lane j (j = lane, lane + 32, ...) computes beam j's stay: p_tot,
//      stay_pb, stay_pnb;
//   B. lane j runs the inverse-hash join over k for its target beam j: the
//      extend of beam k by c_kj = h1[j] - h1[k]*M1 - 1 spells beam j's
//      prefix when the second hash agrees; the absorbed mass (a log-sum-exp
//      over k in ascending order) goes into stay_pnb[j], and (k, c_kj) is
//      marked merged in a per-beam bit set of the classes;
//   C. each lane ranks its share of the K + K*C candidates (the stays
//      0..K-1, then beam k's extends at flat index K + k*C + c): G = 32 / K
//      lanes (a power of two, at least 1) share a beam's classes, so a
//      lane's beam state is loaded once, and each extend's rank comes from
//      it and the frame's log-prob row. Each lane keeps a sorted list of
//      its best L (L = 8 for K <= 8, else 32) in registers, inserting
//      without a branch; a butterfly of five shuffle exchanges merges the
//      lists (each step keeps the top L of two sorted lists: a bitonic
//      merge), so every lane ends with the warp's top L in the total order
//      (rank descending, flat index ascending). That order is exactly the
//      Pallas order: stays win ties, then arrays in ascending k, then the
//      lowest class (pallas_beam.py:280-289). For K > 32 the selection
//      runs in passes of 32, each over the candidates below the last one
//      taken;
//   D. lane s builds selection s's next state (the winner's bookkeeping, in
//      parallel over the K selections), the dead-lane fresh hashes, and
//      writes the packed backpointer.
// The next frame's log-prob row is copied into the other row buffer by
// cp.async while the frame runs.
//
// Hashes are uint32: h*M + c + 1 wraps mod 2^32 without undefined
// behaviour, and c_kj is read as int32 for the range test. exp/log are the
// IEEE expf/log1pf/logf (never fast math) and every rounding is explicit
// (__fadd_rn/__fmul_rn, no contraction into an FMA), so the kernel and its
// plain PyTorch version on the card compute the same floats.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;                // utterances a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 40503u;
constexpr uint32_t kI1 = 2166136261u;
constexpr uint32_t kI2 = 5381u;
// Dynamic shared memory a block may take (the H100 allows 227 KB).
constexpr long long kSmemBudget = 220 * 1024;

// tools/beam_parts.py builds this file with TPUASR_BEAM_CLOCKS: lane 0 of
// each utterance's warp then sums the SM clock cycles of each phase of the
// frame loop (stays, join, candidate scan, merge, bookkeeping; the warp
// meets at each boundary) into beam_clocks[b][phase]. Off in the
// package's build.
#ifdef TPUASR_BEAM_CLOCKS
constexpr int kClockRows = 4096;
__device__ long long beam_clocks[kClockRows][5];
#define BEAM_CLOCK(P)                                                         \
  do {                                                                        \
    __syncwarp();                                                             \
    const long long now = clock64();                                          \
    clk[P] += now - clk_t;                                                    \
    clk_t = now;                                                              \
  } while (0)
#else
#define BEAM_CLOCK(P) \
  do {                \
  } while (0)
#endif

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = __fsub_rn(fminf(a, b), m);
  // Far below -104 expf is 0 and log1pf(0) is 0: the same bits without the
  // two calls (a beam at NEG_INF beside a live one, the common case).
  if (d < -200.f) return __fadd_rn(m, 0.f);
  return __fadd_rn(m, log1pf(expf(d)));
}

// (value, index) with the higher value first, then the lower index: the
// total order of the candidates. An empty slot is (-inf, kNoIndex).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

constexpr int kNoIndex = 0x7fffffff;

// 32-bit words of a warp's shared memory: the log-prob rows [2][C], the
// beam state [2 buffers][8 fields][K], p_tot, stay_pb, stay_pnb, the stay
// ranks, h1 * M1 + 1, h2 * M2 + 1 and the winners' indices [7][K], and the
// merged bit sets [K][ceil(C / 32)].
__host__ __device__ inline long long warp_words(int K, int C) {
  return 2LL * C + 23LL * K + static_cast<long long>(K) * ((C + 31) / 32);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One buffer of the beam state.
struct Beams {
  float* pb;
  float* pnb;
  float* lm;
  uint32_t* h1;
  uint32_t* h2;
  int* last;
  int* last2;
  int* plen;
};

__device__ __forceinline__ Beams beams_at(float* base, int K) {
  return Beams{base,
               base + K,
               base + 2 * K,
               reinterpret_cast<uint32_t*>(base + 3 * K),
               reinterpret_cast<uint32_t*>(base + 4 * K),
               reinterpret_cast<int*>(base + 5 * K),
               reinterpret_cast<int*>(base + 6 * K),
               reinterpret_cast<int*>(base + 7 * K)};
}

// Whether beam k's extend by some class spells beam j's prefix (h1j, h2j:
// beam j's hashes; hm1, hm2: each beam's h1 * M1 + 1 and h2 * M2 + 1); the
// class in *c.
__device__ __forceinline__ bool joins(const uint32_t* hm1,
                                      const uint32_t* hm2, int k,
                                      uint32_t h1j, uint32_t h2j, int C,
                                      int* c) {
  const uint32_t ckj_u = h1j - hm1[k];
  const int ckj = static_cast<int>(ckj_u);
  *c = ckj;
  return h2j == hm2[k] + ckj_u && ckj >= 0 && ckj < C;
}

// The acoustic score of beam k's extend by class c before the merge: from
// p_b after a repeat of the last token, else from p_tot; NEG_INF for the
// blank and past the max_len cap.
__device__ __forceinline__ float ext_raw(const Beams& o, const float* ptot,
                                         const float* lpt, int k, int c,
                                         int blank, int max_len) {
  const float lp_nb = c == blank ? kNegInf : lpt[c];
  const float e = __fadd_rn(c == o.last[k] ? o.pb[k] : ptot[k], lp_nb);
  return o.plen[k] >= max_len ? kNegInf : e;
}

// The fusion table's row for beam k's context.
__device__ __forceinline__ const float* lm_row(const Beams& o,
                                               const float* tab, int k,
                                               int C, int lm_order) {
  const int row = lm_order == 3 ? (o.last2[k] + 1) * (C + 1) + o.last[k] + 1
                                : o.last[k] + 1;
  return tab + static_cast<size_t>(row) * C;
}

// Inserts (x, xi) into the sorted list (best first), dropping the last:
// every place compares with x at once, then takes its own entry, x or its
// predecessor's (no branch; an empty slot x changes nothing).
template <int L>
__device__ __forceinline__ void insert(float (&v)[L], int (&ix)[L], float x,
                                       int xi) {
  bool ahead[L];
#pragma unroll
  for (int j = 0; j < L; ++j) ahead[j] = better(v[j], ix[j], x, xi);
#pragma unroll
  for (int j = L - 1; j > 0; --j) {
    v[j] = ahead[j] ? v[j] : (ahead[j - 1] ? x : v[j - 1]);
    ix[j] = ahead[j] ? ix[j] : (ahead[j - 1] ? xi : ix[j - 1]);
  }
  v[0] = ahead[0] ? v[0] : x;
  ix[0] = ahead[0] ? ix[0] : xi;
}

// Entries j and j + h of a list in order (the better first).
template <int L>
__device__ __forceinline__ void order2(float (&v)[L], int (&ix)[L], int j,
                                       int h) {
  const float a = v[j], b = v[j + h];
  const int ai = ix[j], bi = ix[j + h];
  const bool swap = better(b, bi, a, ai);
  v[j] = swap ? b : a;
  v[j + h] = swap ? a : b;
  ix[j] = swap ? bi : ai;
  ix[j + h] = swap ? ai : bi;
}

// Every lane's sorted list becomes the top L of the warp's lists: five
// exchanges; each keeps the better of entry j and the partner's entry
// L-1-j (the top L of both lists, as a bitonic sequence) and sorts them
// with a bitonic merge.
template <int L>
__device__ __forceinline__ void warp_top(float (&v)[L], int (&ix)[L]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float pv[L];
    int pi[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      pv[j] = __shfl_xor_sync(kFull, v[j], off);
      pi[j] = __shfl_xor_sync(kFull, ix[j], off);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const bool take = better(pv[L - 1 - j], pi[L - 1 - j], v[j], ix[j]);
      v[j] = take ? pv[L - 1 - j] : v[j];
      ix[j] = take ? pi[L - 1 - j] : ix[j];
    }
#pragma unroll
    for (int h = L / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        if ((j & h) == 0) order2<L>(v, ix, j, h);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxWarps * 32)
ctc_beam_kernel(const float* __restrict__ lp,     // (B, T, C)
                const int* __restrict__ lens,     // (B,)
                const float* __restrict__ lm_tab, // (R, C) or null
                int* __restrict__ bp,             // (T, B, K)
                float* __restrict__ pb_out,       // (B, K)
                float* __restrict__ pnb_out,      // (B, K)
                float* __restrict__ lm_out,       // (B, K)
                int* __restrict__ last_out,       // (B, K)
                int* __restrict__ last2_out,      // (B, K)
                int B, int T, int C, int K, int blank, int max_len,
                int lm_order, float lm_w, int track_last2, int staged) {
  extern __shared__ __align__(16) float smem[];
  const int tab_n = staged ? (C + 1) * C : 0;
  for (int i = threadIdx.x; i < tab_n; i += blockDim.x) smem[i] = lm_tab[i];
  __syncthreads();                    // the one block barrier: the table
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const bool have_lm = lm_order > 0;
  const float* tab = staged ? smem : lm_tab;
  const int MW = (C + 31) / 32;
  float* ws = smem + tab_n + static_cast<size_t>(warp) * warp_words(K, C);
  float* lpb = ws;                                  // [2][C]
  float* stw = lpb + 2 * C;                         // [2][8][K]
  float* ptot = stw + 16 * K;                       // [K]
  float* spb = ptot + K;                            // [K]
  float* spnb = spb + K;                            // [K]
  float* srank = spnb + K;                          // [K]
  uint32_t* hm1 = reinterpret_cast<uint32_t*>(srank + K);   // [K]
  uint32_t* hm2 = hm1 + K;                          // [K]
  int* win_i = reinterpret_cast<int*>(hm2 + K);     // [K]
  uint32_t* mrg = reinterpret_cast<uint32_t*>(win_i + K);   // [K][MW]
  const int len = max(0, min(lens[b], T));
  const float* lp_b = lp + static_cast<size_t>(b) * T * C;
  int G = 32;                                       // lanes a beam
  while (G > 1 && G * K > 32) G >>= 1;

  {
    const Beams s0 = beams_at(stw, K);
    for (int k = lane; k < K; k += 32) {
      s0.pb[k] = k == 0 ? 0.f : kNegInf;
      s0.pnb[k] = kNegInf;
      s0.lm[k] = 0.f;
      s0.h1[k] = kI1 + static_cast<uint32_t>(k);
      s0.h2[k] = kI2 + static_cast<uint32_t>(k);
      s0.last[k] = -1;
      s0.last2[k] = -1;
      s0.plen[k] = 0;
    }
    for (int i = lane; i < K * MW; i += 32) mrg[i] = 0u;
    if (len > 0)
      for (int c = lane; c < C; c += 32) cp_async4(lpb + c, lp_b + c);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
  }

#ifdef TPUASR_BEAM_CLOCKS
  long long clk[5] = {0, 0, 0, 0, 0}, clk_t = clock64();
#endif
  for (int t = 0; t < len; ++t) {
    const int cb = t & 1;
    const float* lpt = lpb + cb * C;
    if (t + 1 < len) {                // the next frame's row, meanwhile
      const float* src = lp_b + static_cast<size_t>(t + 1) * C;
      float* dst = lpb + (cb ^ 1) * C;
      for (int c = lane; c < C; c += 32) cp_async4(dst + c, src + c);
    }
    cp_async_commit();
    const Beams o = beams_at(stw + cb * 8 * K, K);
    const Beams n = beams_at(stw + (cb ^ 1) * 8 * K, K);

    // A. Stays.
    const float lp_blank = lpt[blank];
    for (int j = lane; j < K; j += 32) {
      const float pt = logaddexp(o.pb[j], o.pnb[j]);
      ptot[j] = pt;
      spb[j] = __fadd_rn(pt, lp_blank);
      const int lk = o.last[j];
      const float lp_last = lk < 0 ? kNegInf : lpt[min(max(lk, 0), C - 1)];
      spnb[j] = __fadd_rn(o.pnb[j], lp_last);
      hm1[j] = o.h1[j] * kM1 + 1u;
      hm2[j] = o.h2[j] * kM2 + 1u;
    }
    __syncwarp();
    BEAM_CLOCK(0);

    // B. The inverse-hash join into target beam j: the absorbed extend
    // mass, the stay totals and ranks; merged extends are marked.
    for (int j = lane; j < K; j += 32) {
      const uint32_t h1j = o.h1[j], h2j = o.h2[j];
      float m = kNegInf, v1 = kNegInf;
      int valid = 0;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        int c;
        if (joins(hm1, hm2, k, h1j, h2j, C, &c)) {
          const float v = ext_raw(o, ptot, lpt, k, c, blank, max_len);
          m = fmaxf(m, v);
          v1 = v;
          ++valid;
          atomicOr(mrg + k * MW + (c >> 5), 1u << (c & 31));
        }
      }
      float absorbed = kNegInf;
      if (m > kNegInf * 0.5f) {
        // The sum over k in ascending order, as the plain version's.
        float s = 0.f;
        if (valid == 1) {
          s = __fadd_rn(s, expf(__fsub_rn(v1, m)));
        } else {
          for (int k = 0; k < K; ++k) {
            int c;
            if (joins(hm1, hm2, k, h1j, h2j, C, &c)) {
              const float v = ext_raw(o, ptot, lpt, k, c, blank, max_len);
              if (v > kNegInf * 0.5f) s = __fadd_rn(s, expf(__fsub_rn(v, m)));
            }
          }
        }
        absorbed = __fadd_rn(m, logf(s));
      }
      const float sp = logaddexp(spnb[j], absorbed);
      spnb[j] = sp;
      const float tot = logaddexp(spb[j], sp);
      srank[j] = have_lm ? __fadd_rn(tot, __fmul_rn(lm_w, o.lm[j])) : tot;
    }
    __syncwarp();
    BEAM_CLOCK(1);

    // C. The top K of the candidates, in passes of L. Lane l takes the
    // stays l, l+32, ... and the extends of beams l / G, l / G + 32 / G,
    // ... (G lanes a beam), classes l % G, l % G + G, ...: a lane's beam
    // changes at the same step in every lane, so its state is loaded
    // without divergence.
    float thr_v = INFINITY;           // a pass takes what is below this
    int thr_i = -1;
    for (int base = 0; base < K; base += L) {
      float lv[L];
      int li[L];
#pragma unroll
      for (int q = 0; q < L; ++q) {
        lv[q] = -INFINITY;
        li[q] = kNoIndex;
      }
      auto take = [&](float v, int i) {
        const bool in = better(thr_v, thr_i, v, i);
        insert<L>(lv, li, in ? v : -INFINITY, in ? i : kNoIndex);
      };
      for (int j = lane; j < K; j += 32) take(srank[j], j);
      for (int k = lane / G; k < K; k += 32 / G) {
        const float base_pb = o.pb[k], base_pt = ptot[k];
        const int lk = o.last[k];
        const bool capped = o.plen[k] >= max_len;
        const uint32_t* mk = mrg + k * MW;
        const float lmk = have_lm ? o.lm[k] : 0.f;
        const float* trow = have_lm ? lm_row(o, tab, k, C, lm_order)
                                    : nullptr;
        const int i0 = K + k * C;
#pragma unroll 4
        for (int c = lane % G; c < C; c += G) {
          const float lp_nb = c == blank ? kNegInf : lpt[c];
          float e = __fadd_rn(c == lk ? base_pb : base_pt, lp_nb);
          if (capped || ((mk[c >> 5] >> (c & 31)) & 1u)) e = kNegInf;
          take(have_lm ? __fadd_rn(e, __fmul_rn(lm_w, __fadd_rn(lmk, trow[c])))
                       : e,
               i0 + c);
        }
      }
      BEAM_CLOCK(2);
      warp_top<L>(lv, li);
      BEAM_CLOCK(3);
#pragma unroll
      for (int q = 0; q < L; ++q)
        if (q == lane && base + q < K) win_i[base + q] = li[q];
      thr_v = lv[L - 1];
      thr_i = li[L - 1];
    }
    __syncwarp();

    // D. Selection s's next state and backpointer.
    int* bp_t = bp + (static_cast<size_t>(t) * B + b) * K;
    for (int s = lane; s < K; s += 32) {
      const int bi = win_i[s];
      float npb, npnb, nlm;
      uint32_t nh1, nh2;
      int nlast, nlast2, nplen, parent, ch;
      if (bi < K) {
        npb = spb[bi];
        npnb = spnb[bi];
        nlm = o.lm[bi];
        nh1 = o.h1[bi];
        nh2 = o.h2[bi];
        nlast = o.last[bi];
        nlast2 = o.last2[bi];
        nplen = o.plen[bi];
        parent = bi;
        ch = -1;
      } else {
        const int k = (bi - K) / C;
        const int c = (bi - K) - k * C;
        npb = kNegInf;
        // The extend's acoustic score after the merge (without LM, its
        // rank).
        float e = ext_raw(o, ptot, lpt, k, c, blank, max_len);
        if ((mrg[k * MW + (c >> 5)] >> (c & 31)) & 1u) e = kNegInf;
        if (have_lm) {
          npnb = e;
          nlm = __fadd_rn(o.lm[k], lm_row(o, tab, k, C, lm_order)[c]);
        } else {
          npnb = fmaxf(kNegInf, e);
          nlm = 0.f;
        }
        nh1 = hm1[k] + static_cast<uint32_t>(c);
        nh2 = hm2[k] + static_cast<uint32_t>(c);
        nlast = c;
        nlast2 = o.last[k];
        nplen = o.plen[k] + 1;
        parent = k;
        ch = c;
      }
      if (logaddexp(npb, npnb) <= kNegInf * 0.5f) {
        // Dead selection: a fresh hash, so no two beams share one.
        const uint32_t step = static_cast<uint32_t>(t + 1);
        nh1 = kI1 + static_cast<uint32_t>(s) + 7777u * step;
        nh2 = kI2 + static_cast<uint32_t>(s) + 3333u * step;
        nlast = -1;
        nlast2 = -1;
        ch = -1;
        nplen = 0;
        nlm = 0.f;
        parent = s;
      }
      n.pb[s] = npb;
      n.pnb[s] = npnb;
      n.lm[s] = nlm;
      n.h1[s] = nh1;
      n.h2[s] = nh2;
      n.last[s] = nlast;
      n.last2[s] = track_last2 ? nlast2 : -1;
      n.plen[s] = nplen;
      bp_t[s] = parent * 65536 + ch + 1;
    }
    __syncwarp();
    for (int i = lane; i < K * MW; i += 32) mrg[i] = 0u;
    cp_async_wait_all();              // the next frame's row is in
    __syncwarp();
    BEAM_CLOCK(4);
  }
#ifdef TPUASR_BEAM_CLOCKS
  if (lane == 0 && b < kClockRows)
    for (int q = 0; q < 5; ++q) beam_clocks[b][q] = clk[q];
#endif
  // Finished rows are frozen: backpointers point at themselves.
  for (int i = lane; i < (T - len) * K; i += 32) {
    const int t = len + i / K;
    const int k = i - (i / K) * K;
    bp[(static_cast<size_t>(t) * B + b) * K + k] = k * 65536;
  }
  const Beams f = beams_at(stw + (len & 1) * 8 * K, K);
  for (int k = lane; k < K; k += 32) {
    pb_out[b * K + k] = f.pb[k];
    pnb_out[b * K + k] = f.pnb[k];
    lm_out[b * K + k] = f.lm[k];
    last_out[b * K + k] = f.last[k];
    last2_out[b * K + k] = f.last2[k];
  }
}

// One thread per (utterance, n-best entry) q = b * n + j walks the packed
// backpointers from frame T-1 down to 0, starting from beam cur =
// beam_idx[q]: the entry of frame t is parent * 65536 + char + 1 (char -1:
// no token). The chars land in chars (T, B * n); a forward pass then
// left-compacts the tokens into tokens (B, n, L), capped at L = max_len and
// padded with -1, and token_lens = min(count, L).
// With base (B, K, L) and base_len (B, K), the rebuild of every lane (n =
// K, beam_idx null: entry q starts from lane j): the row starts as the
// root lane's base prefix, the chars are written from position
// base_len[root] on (those past L dropped), nothing else is padded, the
// root lane goes to root[q], and token_lens may be null.
__global__ void __launch_bounds__(128)
backtrack_kernel(const int* __restrict__ bp,        // (T, B, K)
                 const int* __restrict__ beam_idx,  // (B, n) or null
                 const int* __restrict__ base,      // (B, K, L) or null
                 const int* __restrict__ base_len,  // (B, K) or null
                 int* __restrict__ chars,           // (T, B * n) scratch
                 int* __restrict__ tokens,          // (B, n, L)
                 int* __restrict__ token_lens,      // (B, n) or null
                 int* __restrict__ root,            // (B, n) or null
                 int T, int B, int K, int n, int L) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int Q = B * n;
  if (q >= Q) return;
  const int b = q / n;
  int cur = beam_idx ? beam_idx[q] : q - b * n;
  int count = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int pk = __ldg(bp + (static_cast<size_t>(t) * B + b) * K + cur);
    const int ch = pk % 65536 - 1;
    chars[static_cast<size_t>(t) * Q + q] = ch;
    count += ch >= 0;
    cur = pk / 65536;
  }
  int* out = tokens + static_cast<size_t>(q) * L;
  int pos = 0;
  if (base) {
    const int* src = base + (static_cast<size_t>(b) * K + cur) * L;
    for (int i = 0; i < L; ++i) out[i] = src[i];
    pos = base_len[b * K + cur];
    if (root) root[q] = cur;
  }
  for (int t = 0; t < T && pos < L; ++t) {
    const int ch = chars[static_cast<size_t>(t) * Q + q];
    if (ch >= 0) out[pos++] = ch;
  }
  if (!base)
    for (; pos < L; ++pos) out[pos] = -1;
  if (token_lens) token_lens[q] = min(count, L);
}

}  // namespace

// The dynamic shared memory of a block of `warps` utterances at (K, C), with
// the bigram table (C+1, C) staged when `staged`.
extern "C" long long tpuasr_ctc_beam_smem(int K, int C, int warps,
                                          int staged) {
  return 4LL * ((staged ? static_cast<long long>(C + 1) * C : 0) +
                static_cast<long long>(warps) * warp_words(K, C));
}

// K3 with the plan (warps, staged, smem) of decode/beam.py::beam_plan.
// lm_tab: the fusion table, (C+1, C) for lm_order 2 or ((C+1)^2, C) for
// lm_order 3, or null with lm_order 0. A plan the kernel does not lay out
// the same way is refused.
extern "C" int tpuasr_ctc_beam(const float* lp, const int* lens,
                               const float* lm_tab, int* bp, float* pb,
                               float* pnb, float* lm, int* last, int* last2,
                               int B, int T, int C, int K, int blank,
                               int max_len, int lm_order, float lm_w,
                               int track_last2, int warps, int staged,
                               long long smem, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > 127 || C < 1 || T < 0 || warps < 1 ||
      warps > kMaxWarps || (staged && lm_order != 2) ||
      (lm_order && !lm_tab) || smem > kSmemBudget ||
      smem != tpuasr_ctc_beam_smem(K, C, warps, staged))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = K <= 8 ? reinterpret_cast<const void*>(
                                    ctc_beam_kernel<8>)
                              : reinterpret_cast<const void*>(
                                    ctc_beam_kernel<32>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + warps - 1) / warps), block(32 * warps);
  if (K <= 8)
    ctc_beam_kernel<8><<<grid, block, smem, stream>>>(
        lp, lens, lm_tab, bp, pb, pnb, lm, last, last2, B, T, C, K, blank,
        max_len, lm_order, lm_w, track_last2, staged);
  else
    ctc_beam_kernel<32><<<grid, block, smem, stream>>>(
        lp, lens, lm_tab, bp, pb, pnb, lm, last, last2, B, T, C, K, blank,
        max_len, lm_order, lm_w, track_last2, staged);
  return static_cast<int>(cudaGetLastError());
}

// The backtrack: bp (T, B, K) and beam_idx (B, n) int32 -> tokens (B, n,
// max_len) and token_lens (B, n) int32; chars: (T, B * n) int32 scratch.
extern "C" int tpuasr_ctc_backtrack(const int* bp, const int* beam_idx,
                                    int* chars, int* tokens, int* token_lens,
                                    int T, int B, int K, int n, int max_len,
                                    cudaStream_t stream) {
  if (B <= 0 || n <= 0) return 0;
  if (T < 0 || K < 1 || max_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Q = B * n;
  backtrack_kernel<<<(Q + 127) / 128, 128, 0, stream>>>(
      bp, beam_idx, nullptr, nullptr, chars, tokens, token_lens, nullptr, T,
      B, K, n, max_len);
  return static_cast<int>(cudaGetLastError());
}

// The scan search's prefix rebuild: bp (T, B, K) int32, the resumed
// prefixes base (B, K, max_len) and their lengths base_len (B, K) int32 ->
// prefixes (B, K, max_len) and each lane's root lane at frame 0, root (B,
// K) int32; chars: (T, B * K) int32 scratch.
extern "C" int tpuasr_ctc_rebuild(const int* bp, const int* base,
                                  const int* base_len, int* chars,
                                  int* prefixes, int* root, int T, int B,
                                  int K, int max_len, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (T < 0 || K < 1 || max_len < 1 || !base || !base_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Q = B * K;
  backtrack_kernel<<<(Q + 127) / 128, 128, 0, stream>>>(
      bp, nullptr, base, base_len, chars, prefixes, nullptr, root, T, B, K,
      K, max_len);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TPUASR_BEAM_CLOCKS
// The cycles by phase of the last launch's utterances 0 .. B-1 (B <= 4096),
// into out (B, 5).
extern "C" int tpuasr_ctc_beam_clocks(long long* out, int B) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, beam_clocks, sizeof(long long) * 5 * min(B, kClockRows)));
}
#endif
