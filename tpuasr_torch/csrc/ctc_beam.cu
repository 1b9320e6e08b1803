// CTC prefix beam search, the whole per-frame update in one kernel.
//
// Replaces K3, _beam_kernel of tpuasr/decode/pallas_beam.py (built by
// _build, pallas_call at line 455), with and without shallow LM fusion:
// per frame it scores stay and extend candidates over ALL classes, merges
// extends into existing beams through the inverse-hash join, keeps the top
// K in a fixed tie order, gives dead selections fresh hashes, enforces the
// max_len cap and writes packed backpointers parent * 65536 + char + 1.
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
// C=64) is staged in shared memory, the trigram table (1.08 MB at C=64) is
// read from global memory through L2.
//
// What bounds it on the H100: latency. Each frame is a chain of small
// dependent steps (K x C candidates, K x K join, K selection rounds over
// K + K*C candidates) for one utterance, and T frames run in sequence; the
// bytes are only C floats in and K ints out per frame.
//
// Design: one block per utterance, its beam state (p_b, p_nb, h1, h2, last,
// plen, lm, last2) in shared memory and the loop over T inside the kernel.
// Threads cover the K stays and K*C extends; each selection round is one
// block argmax over the total order (rank descending, flat index ascending)
// where the flat index lists the stays 0..K-1 first and then beam k's
// extends at K + k*C + c -- exactly the Pallas order: stays win ties, then
// arrays in ascending k, then the lowest class (pallas_beam.py:280-289).
// Each thread caches the best of its own candidates and rescans only when
// that one was taken. A taken candidate becomes -inf, below every rank the
// search produces (all finite), so it is never chosen twice.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 40503u;
constexpr uint32_t kI1 = 2166136261u;
constexpr uint32_t kI2 = 5381u;
// The bigram table is staged in shared memory up to this size; a larger
// one is read from global memory like the trigram table.
constexpr size_t kMaxStagedTable = 128 * 1024;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(__fsub_rn(fminf(a, b), m))));
}

// (value, index) with the higher value first, then the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KC = K * C;
  const int N = K + KC;                       // candidates per frame
  const bool have_lm = lm_order > 0;
  const int tab_n = staged ? (C + 1) * C : 0;
  float* lpt = reinterpret_cast<float*>(smem_raw);   // [C]
  float* pb = lpt + C;                        // [K] beam state
  float* pnb = pb + K;
  float* ptot = pnb + K;
  float* stay_pb = ptot + K;
  float* stay_pnb = stay_pb + K;
  float* cand = stay_pnb + K;                 // [N] ranks: stays, extends
  float* extv = cand + N;                     // [KC] acoustic extends
  float* extlm = extv + KC;                   // [KC] their LM scores
  float* contrib = extlm + KC;                // [K * K] (j, k)
  float* npb = contrib + K * K;               // [K] next state
  float* npnb = npb + K;
  float* lmv = npnb + K;                      // [K] cumulative LM score
  float* nlm = lmv + K;
  float* red_v = nlm + K;                     // [kWarps]
  float* tab_s = red_v + kWarps;              // [tab_n] staged bigram table
  uint32_t* h1 = reinterpret_cast<uint32_t*>(tab_s + tab_n);   // [K]
  uint32_t* h2 = h1 + K;
  uint32_t* nh1 = h2 + K;
  uint32_t* nh2 = nh1 + K;
  int* last = reinterpret_cast<int*>(nh2 + K);  // [K]
  int* plen = last + K;
  int* last2 = plen + K;
  int* nlast = last2 + K;
  int* nplen = nlast + K;
  int* nlast2 = nplen + K;
  int* bpw = nlast2 + K;                      // [K] packed backpointers
  int* red_i = bpw + K;                       // [kWarps]
  int* winner = red_i + kWarps;               // [1]
  unsigned char* merged = reinterpret_cast<unsigned char*>(winner + 1);  // [KC]

  const int b = blockIdx.x;
  const int len = max(0, min(lens[b], T));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* lp_b = lp + static_cast<size_t>(b) * T * C;

  for (int i = tid; i < tab_n; i += kThreads) tab_s[i] = lm_tab[i];
  const float* tab = staged ? tab_s : lm_tab;
  for (int k = tid; k < K; k += kThreads) {
    pb[k] = k == 0 ? 0.f : kNegInf;
    pnb[k] = kNegInf;
    h1[k] = kI1 + static_cast<uint32_t>(k);
    h2[k] = kI2 + static_cast<uint32_t>(k);
    last[k] = -1;
    last2[k] = -1;
    plen[k] = 0;
    lmv[k] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    for (int c = tid; c < C; c += kThreads)
      lpt[c] = lp_b[static_cast<size_t>(t) * C + c];
    for (int i = tid; i < KC; i += kThreads) merged[i] = 0;
    __syncthreads();

    // Stays.
    for (int k = tid; k < K; k += kThreads) {
      const float pt = logaddexp(pb[k], pnb[k]);
      ptot[k] = pt;
      stay_pb[k] = __fadd_rn(pt, lpt[blank]);
      const int lk = last[k];
      const float lp_last = lk < 0 ? kNegInf : lpt[min(max(lk, 0), C - 1)];
      stay_pnb[k] = __fadd_rn(pnb[k], lp_last);
    }
    __syncthreads();
    // Extends: beam k's prefix + class c (blank excluded, max_len cap),
    // and their LM scores lm[k] + row[c].
    for (int i = tid; i < KC; i += kThreads) {
      const int k = i / C;
      const int c = i - k * C;
      const float lp_nb = c == blank ? kNegInf : lpt[c];
      float e = __fadd_rn(c == last[k] ? pb[k] : ptot[k], lp_nb);
      if (plen[k] >= max_len) e = kNegInf;
      extv[i] = e;
      if (have_lm) {
        const int row = lm_order == 3 ? (last2[k] + 1) * (C + 1) + last[k] + 1
                                      : last[k] + 1;
        extlm[i] = __fadd_rn(lmv[k], tab[static_cast<size_t>(row) * C + c]);
      }
    }
    __syncthreads();
    // Inverse-hash join: the extend of beam k by class c_kj = h1[j] -
    // h1[k]*M1 - 1 spells beam j's prefix when the second hash agrees.
    for (int p = tid; p < K * K; p += kThreads) {
      const int k = p / K;
      const int j = p - k * K;
      const uint32_t ckj_u = h1[j] - h1[k] * kM1 - 1u;
      const int ckj = static_cast<int>(ckj_u);
      const bool valid = h2[j] == h2[k] * kM2 + ckj_u + 1u && ckj >= 0 &&
                         ckj < C;
      contrib[j * K + k] = valid ? extv[k * C + ckj] : -INFINITY;
      if (valid) merged[k * C + ckj] = 1;
    }
    __syncthreads();
    // Extend ranks: merged extends are absorbed (their acoustic score
    // becomes NEG_INF); with LM, rank = ext + lm_w * ext_lm.
    for (int i = tid; i < KC; i += kThreads) {
      const float e = merged[i] ? kNegInf : extv[i];
      extv[i] = e;
      cand[K + i] = have_lm ? __fadd_rn(e, __fmul_rn(lm_w, extlm[i])) : e;
    }
    // Absorbed extend mass per target beam, then the stay totals and ranks.
    for (int j = tid; j < K; j += kThreads) {
      float m = kNegInf;
      for (int k = 0; k < K; ++k) m = fmaxf(m, contrib[j * K + k]);
      float absorbed = kNegInf;
      if (m > kNegInf * 0.5f) {
        float s = 0.f;
        for (int k = 0; k < K; ++k) {
          const float v = contrib[j * K + k];
          if (v > kNegInf * 0.5f) s = __fadd_rn(s, expf(__fsub_rn(v, m)));
        }
        absorbed = __fadd_rn(m, logf(s));
      }
      const float spnb = logaddexp(stay_pnb[j], absorbed);
      stay_pnb[j] = spnb;
      const float tot = logaddexp(stay_pb[j], spnb);
      cand[j] = have_lm ? __fadd_rn(tot, __fmul_rn(lm_w, lmv[j])) : tot;
    }
    __syncthreads();

    // K selection rounds over the total order.
    float my_v = -INFINITY;
    int my_i = 0x7fffffff;
    for (int i = tid; i < N; i += kThreads)
      if (better(cand[i], i, my_v, my_i)) { my_v = cand[i]; my_i = i; }
    for (int sel = 0; sel < K; ++sel) {
      float v = my_v;
      int i = my_i;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
      __syncthreads();
      if (tid == 0) {
        float bv = red_v[0];
        int bi = red_i[0];
        for (int w = 1; w < kWarps; ++w)
          if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
        float spb, spnb, slm;
        uint32_t sh1, sh2;
        int slast, slast2, splen, parent, ch;
        if (bi < K) {
          spb = stay_pb[bi];
          spnb = stay_pnb[bi];
          slm = lmv[bi];
          sh1 = h1[bi];
          sh2 = h2[bi];
          slast = last[bi];
          slast2 = last2[bi];
          splen = plen[bi];
          parent = bi;
          ch = -1;
        } else {
          const int k = (bi - K) / C;
          const int c = (bi - K) - k * C;
          spb = kNegInf;
          // Without LM the rank is the extend's probability itself.
          spnb = have_lm ? extv[bi - K] : fmaxf(kNegInf, bv);
          slm = have_lm ? extlm[bi - K] : 0.f;
          sh1 = h1[k] * kM1 + static_cast<uint32_t>(c) + 1u;
          sh2 = h2[k] * kM2 + static_cast<uint32_t>(c) + 1u;
          slast = c;
          slast2 = last[k];
          splen = plen[k] + 1;
          parent = k;
          ch = c;
        }
        if (logaddexp(spb, spnb) <= kNegInf * 0.5f) {
          // Dead selection: a fresh hash, so no two beams share one.
          const uint32_t step = static_cast<uint32_t>(t + 1);
          sh1 = kI1 + static_cast<uint32_t>(sel) + 7777u * step;
          sh2 = kI2 + static_cast<uint32_t>(sel) + 3333u * step;
          slast = -1;
          slast2 = -1;
          ch = -1;
          splen = 0;
          slm = 0.f;
          parent = sel;
        }
        npb[sel] = spb;
        npnb[sel] = spnb;
        nlm[sel] = slm;
        nh1[sel] = sh1;
        nh2[sel] = sh2;
        nlast[sel] = slast;
        nlast2[sel] = track_last2 ? slast2 : -1;
        nplen[sel] = splen;
        bpw[sel] = parent * 65536 + ch + 1;
        cand[bi] = -INFINITY;
        *winner = bi;
      }
      __syncthreads();
      if (my_i == *winner) {
        my_v = -INFINITY;
        my_i = 0x7fffffff;
        for (int c2 = tid; c2 < N; c2 += kThreads)
          if (better(cand[c2], c2, my_v, my_i)) { my_v = cand[c2]; my_i = c2; }
      }
    }
    __syncthreads();
    int* bp_t = bp + (static_cast<size_t>(t) * B + b) * K;
    for (int k = tid; k < K; k += kThreads) {
      pb[k] = npb[k];
      pnb[k] = npnb[k];
      lmv[k] = nlm[k];
      h1[k] = nh1[k];
      h2[k] = nh2[k];
      last[k] = nlast[k];
      last2[k] = nlast2[k];
      plen[k] = nplen[k];
      bp_t[k] = bpw[k];
    }
    __syncthreads();
  }
  // Finished rows are frozen: backpointers point at themselves.
  for (int i = tid; i < (T - len) * K; i += kThreads) {
    const int t = len + i / K;
    const int k = i - (i / K) * K;
    bp[(static_cast<size_t>(t) * B + b) * K + k] = k * 65536;
  }
  for (int k = tid; k < K; k += kThreads) {
    pb_out[b * K + k] = pb[k];
    pnb_out[b * K + k] = pnb[k];
    lm_out[b * K + k] = lmv[k];
    last_out[b * K + k] = last[k];
    last2_out[b * K + k] = last2[k];
  }
}

}  // namespace

// lm_tab: the fusion table, (C+1, C) for lm_order 2 or ((C+1)^2, C) for
// lm_order 3, or null with lm_order 0.
extern "C" int tpuasr_ctc_beam(const float* lp, const int* lens,
                               const float* lm_tab, int* bp, float* pb,
                               float* pnb, float* lm, int* last, int* last2,
                               int B, int T, int C, int K, int blank,
                               int max_len, int lm_order, float lm_w,
                               int track_last2, cudaStream_t stream) {
  const size_t kc = static_cast<size_t>(K) * C;
  const size_t tab_bytes = sizeof(float) * (C + 1) * C;
  const int staged = lm_order == 2 && tab_bytes <= kMaxStagedTable;
  const size_t tab_n = staged ? static_cast<size_t>(C + 1) * C : 0;
  const size_t smem =
      sizeof(float) * (C + 5 * K + (K + kc) + 2 * kc + K * K + 4 * K +
                       kWarps + tab_n) +
      sizeof(uint32_t) * 4 * K + sizeof(int) * (7 * K + kWarps + 1) + kc;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ctc_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_beam_kernel<<<B, kThreads, smem, stream>>>(
      lp, lens, lm_tab, bp, pb, pnb, lm, last, last2, B, T, C, K, blank,
      max_len, lm_order, lm_w, track_last2, staged);
  return static_cast<int>(cudaGetLastError());
}
