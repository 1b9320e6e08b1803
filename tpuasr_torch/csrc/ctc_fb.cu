// The CTC loss, forward and backward, each one launch: float32, a warp an
// utterance.
//
// Replaces two Pallas kernels of tpuasr/losses/ctc_pallas.py, and the XLA
// work around them:
//   K6   _alpha_kernel (line 95; pallas_call at line 167): the log-space
//        alpha recursion, here together with _prepare's extended labels,
//        skip and valid masks and emission gather (:216-247), and
//        _final_ll (:263-275) and zero_infinity (:345-353);
//   K6b  _beta_kernel (line 122; pallas_call at line 192): the beta
//        recursion, here together with _bwd (:324-339): the state
//        occupancies exp(alpha + beta - ll), masked, scaled by -g and
//        summed into the classes, the whole (B, T, C) gradient written.
// Semantics as JAX's: ext = [blank, l1, blank, l2, ..., blank] (S = 2U+1),
// labels clipped to [0, C-1] for the gather and the class sums only (the
// skip s-2 -> s compares the labels as given), valid s <= 2 * label_len,
// -1e30 for log 0 with every sum of three written m + log(exp(a-m) +
// exp(b-m) + exp(c-m)), ll read at t = clip(len-1, 0, T-1) (frame 0 for a
// row of 0 frames), the betas reset to 0 at s = 2L and 2L-1 at t = len-1,
// the gradient zero at t >= len, on invalid states and on infeasible rows
// (ll <= -5e29). Every add is the plain version's (losses/ctc.py): expf and
// logf are the IEEE functions torch's exp and log call (this library is
// never built with fast math), so the alphas agree with ctc_forward_plain's
// to the bit where the operations match, and only the class sums run in
// another (fixed) order than scatter_add_'s.
//
// What bounds it on the H100: neither bytes nor operations but the serial
// frame chain. At config 3's train step (B=16, T'=249, S=49, C=64) the loss
// moves ~1.3 MB (0.3 + 0.6 us at 3.35 TB/s) and does ~1.2 M
// transcendentals; each of the 249 frames depends on the one before, so a
// frame's latency (the exchange with the neighbouring states, then three
// expf and one logf, ~220 SM cycles measured on a bare chain) times T' is
// the floor (0.028 ms at 1.98 GHz).
//
// Design: one warp an utterance for the recursion. Lane j holds the states
// [j*K, j*K+K) in registers, K = ceil(S/32) rounded up to an instance (1,
// 2, 3, 4, 8, 16, 32; states past S are dead at -1e30). A frame's only
// exchange is the previous lane's last two alphas (the next lane's first
// two b0 in the backward), by __shfl_up_sync/__shfl_down_sync: no shared
// memory and no barrier in the chain. Each lane's K classes are fixed for
// the utterance, so its emissions (and in K6b its alphas) are loaded D
// frames ahead into a register ring (D = 8 for K <= 2, 4 for K <= 4, 2 for
// K = 8, else 1), off the chain; the frames run in chunks of D aligned to
// D, so the ring's slots are fixed at compile time and a chunk is straight-
// line code in which the compiler can hide the loads and stores under the
// chain. Each select of a state's new value stays a select (computed()),
// so a lane's K chains interleave. The alphas go out lane-major, (B, T,
// 32K), one vector store a frame. K6 reads ll back from them at the end.
// K6b: a block of two warps an utterance. Warp 0 runs the beta recursion
// and writes alpha + beta of each frame into a shared buffer of F frames
// (F = 32 unless the buffers outgrow shared memory; a row of 32K+1 floats,
// state s of lane s/K at (s%K)*32 + s/K, so neither the per-frame stores
// nor the per-frame reads conflict on a bank). Warp 1, while warp 0 fills
// the other buffer, turns a full one into gradient rows: lane l takes frame
// l, -occ * g of each valid state, the blank class summed over the even
// states in order, each label class over its positions in label order, the
// classes in order of their first position (a list it builds once per
// utterance), into a tile of F rows of C (zero where no state has the
// class), which the warp writes to the gradient as one contiguous block.
// The warps meet on named barriers once a buffer, never a frame. No
// atomics: the same bits every call.
//
// tools/ctc_time.py builds this file with TPUASR_CTC_CLOCKS: lane 0 of each
// utterance's warp(s) then sums the SM clock cycles of each part of the
// frame loop (K6: the chain, the rest; K6b: warp 1 waiting and working,
// warp 0's frames) into ctc_clocks[kernel][b][part], waiting for each
// part's last result before it reads the clock (so the parts do not
// overlap), and tpuasr_ctc_chain_cycles times the bare chain. Emissions
// staged in shared memory by bulk copies (a ring of 32-frame chunks, one
// mbarrier a slot) in place of the register ring made K6 slower at config
// 3's shape (PERF.md §6), so the register ring is the only route.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kInfeasible = -5e29f;   // JAX's NEG_INF * 0.5
constexpr unsigned kFull = 0xffffffffu;
// Shared memory K6b's buffers may take (the H100 allows 227 KB a block).
constexpr long long kSmemBudget = 220 * 1024;

#ifdef TPUASR_CTC_CLOCKS
constexpr int kClockRows = 4096;
constexpr int kClockParts = 5;
__device__ long long ctc_clocks[2][kClockRows][kClockParts];
// Waits until x is computed (a branch on it), then adds the cycles since
// the last mark to part P.
#define CTC_CLOCK(P, x)                                          \
  do {                                                           \
    if (__float_as_uint(x) == 0x7fbadbadu) asm volatile("trap;"); \
    const long long now = clock64();                             \
    clk[P] += now - clk_t;                                       \
    clk_t = now;                                                 \
  } while (0)
#else
#define CTC_CLOCK(P, x) \
  do {                  \
  } while (0)
#endif

// Frames an emission (and alpha) is loaded ahead of its use.
__host__ __device__ constexpr int depth(int K) {
  return K <= 2 ? 8 : (K <= 4 ? 4 : (K <= 8 ? 2 : 1));
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// Makes x a value the compiler must compute where it stands: a select on
// it then stays a select, and a lane's K chains stay interleaved, instead
// of each sinking into a branch of its own.
__device__ __forceinline__ float computed(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// torch.logaddexp's float formula.
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Element i of an int32 or int64 array.
__device__ __forceinline__ long long read_int(const void* p, bool wide,
                                              long long i) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : static_cast<long long>(__ldg(static_cast<const int*>(p) + i));
}

__device__ __forceinline__ int clip_class(long long v, int C) {
  return static_cast<int>(v < 0 ? 0 : (v > C - 1 ? C - 1 : v));
}

// A lane's K consecutive floats of an alpha row (16-, 8- or 4-byte
// aligned as K allows).
template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      reinterpret_cast<float4*>(p)[j / 4] =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = v[j];
  }
}

template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 x = reinterpret_cast<const float4*>(p)[j / 4];
      v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
    }
  } else if constexpr (K == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j];
  }
}

struct Args {
  const float* lp;           // (B, T, C) log-probs
  const void* labels;        // (B, U) int32 or int64
  const void* in_lens;       // (B,) int32 or int64
  const void* lab_lens;      // (B,) int32 or int64
  float* alphas;             // (B, T, 32K), state s at [s], -1e30 past S
  float* ll;                 // (B,) log-likelihood
  float* loss;               // (B,) K6: the NLL, zero_infinity applied
  const float* g;            // (B,) K6b: the loss's upstream gradient
  float* grad;               // (B, T, C) K6b
  int T, C, U, blank, zero_inf, frames;
  int wide;                  // bit 0 labels, 1 in_lens, 2 lab_lens: int64
};

// The label (as given) of extended state s; the blank at even s.
__device__ __forceinline__ long long ext_label(const Args& p, int b, int s) {
  return (s & 1) ? read_int(p.labels, p.wide & 1,
                            static_cast<long long>(b) * p.U + (s >> 1))
                 : static_cast<long long>(p.blank);
}

// One frame of the alpha recursion on a lane's K states: the previous
// lane's last two alphas by shuffles, then lse3 + the emission.
template <int K>
__device__ __forceinline__ void alpha_step(float (&a)[K], const float (&e)[K],
                                           const bool (&ok)[K],
                                           const bool (&skip)[K], int lane) {
  float p1 = __shfl_up_sync(kFull, a[K - 1], 1);
  float p2 = __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], K >= 2 ? 1 : 2);
  if (lane < 1) p1 = kNegInf;
  if (lane < (K >= 2 ? 1 : 2)) p2 = kNegInf;
  float n[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float y = i >= 1 ? a[i >= 1 ? i - 1 : 0] : p1;
    float z = i >= 2 ? a[i >= 2 ? i - 2 : 0] : (i == 1 ? p1 : p2);
    z = skip[i] ? z : kNegInf;
    const float r = computed(lse3(a[i], y, z) + e[i]);
    n[i] = ok[i] ? r : kNegInf;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) a[i] = n[i];
}

// K6: alphas (B, T, 32K), ll and loss (B,).
template <int K>
__global__ void __launch_bounds__(32) ctc_fwd_kernel(Args p) {
  constexpr int D = depth(K);
  constexpr int SP = 32 * K;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int T = p.T, C = p.C, S = 2 * p.U + 1;
  const long long len = read_int(p.in_lens, p.wide & 2, b);
  const long long L = read_int(p.lab_lens, p.wide & 4, b);
  const float* lpb = p.lp + static_cast<size_t>(b) * T * C;
  float* orow = p.alphas + static_cast<size_t>(b) * T * SP + lane * K;
#ifdef TPUASR_CTC_CLOCKS
  long long clk[kClockParts] = {0, 0, 0, 0, 0}, clk_t = clock64();
#endif

  int cls[K];
  bool ok[K], skip[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = lane * K + i;
    const long long v = s < S ? ext_label(p, b, s) : 0;
    cls[i] = clip_class(v, C);
    ok[i] = s < S && s <= 2 * L;
    skip[i] = s < S && (s & 1) && s >= 3 && v != ext_label(p, b, s - 2);
  }
  float a[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = lane * K + i;
    a[i] = ok[i] && s < 2 ? lpb[cls[i]] : kNegInf;
  }
  store_k<K>(orow, a);
  CTC_CLOCK(0, a[0]);

  // Frame t's emissions sit in ring[t % D], loaded D frames ahead. The
  // frames run in chunks of D aligned to D, so every slot index is fixed
  // at compile time; only the first and last chunks check their frames,
  // and a chunk's work (loads and stores off the chain included) is one
  // block of straight-line code for the compiler to interleave.
  float ring[D][K];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int t = d == 0 ? D : d;          // frames 1 .. D
#pragma unroll
    for (int i = 0; i < K; ++i)
      ring[d][i] = __ldg(lpb + static_cast<size_t>(min(t, T - 1)) * C +
                         cls[i]);
  }
  auto chunk = [&](int c, bool checked) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = c * D + d;
      if (checked && (t == 0 || t >= T)) continue;
      alpha_step<K>(a, ring[d], ok, skip, lane);
      CTC_CLOCK(1, a[K - 1]);
      store_k<K>(orow + static_cast<size_t>(t) * SP, a);
      const float* ahead =
          lpb + static_cast<size_t>(min(t + D, T - 1)) * C;
#pragma unroll
      for (int i = 0; i < K; ++i) ring[d][i] = __ldg(ahead + cls[i]);
      CTC_CLOCK(2, a[0]);
    }
  };
  const int chunks = (T + D - 1) / D;
  chunk(0, true);
  int c = 1;
  for (; c < chunks - 1; ++c) chunk(c, false);
  if (c < chunks) chunk(c, true);

  // ll = logaddexp(alpha at s = 2L, at s = 2L-1 if L > 0) at t = clip(len
  // - 1, 0, T - 1), as _final_ll, read back from the alphas just written.
  __syncwarp();
  if (lane == 0) {
    const long long t_ll = len - 1 < 0 ? 0 : (len - 1 > T - 1 ? T - 1
                                                              : len - 1);
    const float* at = p.alphas + (static_cast<size_t>(b) * T + t_ll) * SP;
    const float a_end = L >= 0 && 2 * L < S ? at[2 * L] : kNegInf;
    const float a_pre = L > 0 && 2 * L - 1 < S ? at[2 * L - 1] : kNegInf;
    const float ll = logaddexp(a_end, a_pre);
    float loss = -ll;
    if (p.zero_inf && loss >= -kInfeasible) loss = 0.f;
    p.ll[b] = ll;
    p.loss[b] = loss;
  }
#ifdef TPUASR_CTC_CLOCKS
  CTC_CLOCK(3, p.ll[b]);
  if (lane == 0 && b < kClockRows)
    for (int k = 0; k < kClockParts; ++k) ctc_clocks[0][b][k] = clk[k];
#endif
}

// Shared memory of K6b at F frames a block: two buffers of F rows of
// alpha + beta, the class tile, the class list and two int lists of U.
__host__ __device__ inline long long bwd_smem(int K, int F, int C, int U) {
  return 4LL * (2LL * F * (32 * K + 1) + static_cast<long long>(F) * (C | 1) +
                3LL * U);
}

// Named barriers between K6b's two warps (64 threads each meeting): a
// buffer's "full" (the chain warp arrives, the sum warp waits) and
// "empty" (the other way round). Barrier 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// K6b: grad (B, T, C) = d loss / d log_probs, from K6's alphas and ll and
// the upstream gradient g. Two warps an utterance: warp 0 runs the beta
// recursion and writes alpha + beta of each frame into a shared buffer of
// F frames; warp 1 turns each full buffer into gradient rows (lane l frame
// l: the occupancies, their class sums, the tile written out) while warp 0
// fills the other buffer. The warps meet once a buffer, never a frame.
template <int K>
__global__ void __launch_bounds__(64) ctc_bwd_kernel(Args p) {
  constexpr int D = depth(K);
  constexpr int SP = 32 * K;
  constexpr int R = SP + 1;          // a frame's row in a buffer
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int T = p.T, C = p.C, U = p.U, S = 2 * U + 1, F = p.frames;
  const int Cp = C | 1;              // the tile's row stride (odd)
  const long long len = read_int(p.in_lens, p.wide & 2, b);
  const long long L = read_int(p.lab_lens, p.wide & 4, b);
  const float ll = p.ll[b];
  float* grad = p.grad + static_cast<size_t>(b) * T * C;
#ifdef TPUASR_CTC_CLOCKS
  long long clk[kClockParts] = {0, 0, 0, 0, 0}, clk_t = clock64();
#endif

  // Frames with a gradient: t < len where the row is feasible. A row with
  // len > T never meets its reset (its betas stay at -1e30 and below), so
  // it has none, as in the plain version.
  const int n = ll > kInfeasible && len >= 1 && len <= T
                    ? static_cast<int>(len) : 0;
  for (size_t k = static_cast<size_t>(n) * C + threadIdx.x;
       k < static_cast<size_t>(T) * C; k += 64)
    grad[k] = 0.f;
  if (n == 0) return;
  const int blocks = (n - 1) / F + 1;  // of F frames, from the top down

  float* vbuf = smem;                                   // [2][F][R]
  float* tile = vbuf + 2 * static_cast<size_t>(F) * R;  // [F][Cp]
  // The class list: the labels grouped by class, the classes in order of
  // their first position, each group in label order; an item is its
  // state's position in a buffer row | last of its class << 11 | its class
  // << 12.
  int* items = reinterpret_cast<int*>(tile + static_cast<size_t>(F) * Cp);
  int* lab_cls = items + U;
  int* first = lab_cls + U;          // first position of the label's class
  const int Le = static_cast<int>(L < 0 ? 0 : (L > U ? U : L));
  const int s_end = static_cast<int>(2 * L < S - 1 ? 2 * L : S - 1);

  if (threadIdx.x >= 32) {
    // ---- warp 1: the class list once, then every buffer's rows ----
    const float g = p.g[b];
    const int blank_cls = clip_class(p.blank, C);
    for (int u = lane; u < Le; u += 32)
      lab_cls[u] = clip_class(ext_label(p, b, 2 * u + 1), C);
    for (int k = lane; k < F * Cp; k += 32) tile[k] = 0.f;
    __syncwarp();
    for (int u = lane; u < Le; u += 32) {
      int f = u;
      for (int v = 0; v < u; ++v)
        if (lab_cls[v] == lab_cls[u]) {
          f = v;
          break;
        }
      first[u] = f;
    }
    __syncwarp();
    for (int u = lane; u < Le; u += 32) {
      const int c = lab_cls[u];
      int rank = 0;
      bool later = false;
      for (int v = 0; v < Le; ++v) {
        rank += first[v] < first[u] || (v < u && lab_cls[v] == c);
        later |= v > u && lab_cls[v] == c;
      }
      const int s = 2 * u + 1;
      items[rank] = ((s % K) * 32 + s / K) | (later ? 0 : 1 << 11) |
                    (c << 12);
    }
    __syncwarp();
    // -occ * g of a state from its alpha + beta.
    auto occ = [&](float v) {
      return -expf(fminf(fmaxf(v - ll, kNegInf), 0.f)) * g;
    };
    for (int j = 0; j < blocks; ++j) {
      const int t = (blocks - 1 - j) * F;
      const int nf = n - t < F ? n - t : F;
      pair_sync(1 + (j & 1));        // buffer j & 1 is full
      CTC_CLOCK(1, tile[lane]);
      if (lane < nf) {
        const float* vr = vbuf + ((j & 1) * F + lane) * static_cast<size_t>(R);
        float* tr = tile + lane * Cp;
        float blank_sum = 0.f;
#pragma unroll 8
        for (int s = 0; s <= s_end; s += 2)
          blank_sum += occ(vr[(s % K) * 32 + s / K]);
        tr[blank_cls] = blank_sum;
        float sum = 0.f;
        for (int k0 = 0; k0 < Le; k0 += 8) {
          // Eight items and their states loaded before any tile store.
          int it[8];
          float x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            it[i] = k0 + i < Le ? items[k0 + i] : 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = vr[it[i] & 2047];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (k0 + i < Le) {
              sum += occ(x[i]);
              if (it[i] & 2048) {
                const int c = it[i] >> 12;
                tr[c] = c == blank_cls ? blank_sum + sum : sum;
                sum = 0.f;
              }
            }
          }
        }
      }
      if (j + 2 < blocks) pair_arrive(3 + (j & 1));   // buffer j & 1 read
      __syncwarp();
      float* dst = grad + static_cast<size_t>(t) * C + lane;
      for (int c = lane; c < C; c += 32, dst += 32) {
        float* out = dst;
        const float* src = tile + c;
#pragma unroll 8
        for (int r = 0; r < nf; ++r, out += C, src += Cp) *out = *src;
      }
      __syncwarp();
      CTC_CLOCK(2, tile[lane]);
    }
#ifdef TPUASR_CTC_CLOCKS
    if (lane == 0 && b < kClockRows)
      for (int k = 0; k < 3; ++k) ctc_clocks[1][b][k] = clk[k];
#endif
    return;
  }

  // ---- warp 0: the beta recursion ----
  int cls[K];
  bool ok[K], skip[K];
  float beta[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = lane * K + i;
    const long long v = s < S ? ext_label(p, b, s) : 0;
    cls[i] = clip_class(v, C);
    ok[i] = s < S && s <= 2 * L;
    // The skip s -> s+2 (allow[s+2]).
    skip[i] = s + 2 < S && (s & 1) && v != ext_label(p, b, s + 2);
    beta[i] = s == 2 * L || (s == 2 * L - 1 && L > 0) ? 0.f : kNegInf;
  }
  const float* lpb = p.lp + static_cast<size_t>(b) * T * C;
  const float* ab = p.alphas + static_cast<size_t>(b) * T * SP + lane * K;
  // Frame t's alphas and emissions sit in ra[t % D] and re[t % D], loaded
  // D frames ahead. The frames run down in chunks of D aligned to D (slot
  // indices fixed at compile time); only the first and last chunks check
  // their frames. F is a multiple of D, so buffers start and end with
  // chunks, and a chunk's work is one block of straight-line code.
  float ra[D][K], re[D][K];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    // The frame of slot d among n-1 .. n-D.
    const int t = n - 1 - ((n - 1 - d) % D + D) % D;
    const int tc = max(t, 0);
    load_k<K>(ra[d], ab + static_cast<size_t>(tc) * SP);
#pragma unroll
    for (int i = 0; i < K; ++i)
      re[d][i] = __ldg(lpb + static_cast<size_t>(tc) * C + cls[i]);
  }
  CTC_CLOCK(3, beta[0]);

  const int top = (n - 1) / D;
  auto chunk = [&](int c, bool checked) {
    const int j = blocks - 1 - c * D / F;          // this buffer's index
    float* buf = vbuf + (j & 1) * static_cast<size_t>(F) * R;
    if (j >= 2 && (c == top || ((c + 1) * D & (F - 1)) == 0))
      pair_sync(3 + (j & 1));      // wait until buffer j - 2 was read
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const int d = D - 1 - e;             // frames run down
      const int t = c * D + d;
      if (checked && t >= n) continue;
      float* row = buf + (t & (F - 1)) * R;       // F is a power of two
#pragma unroll
      for (int i = 0; i < K; ++i) row[i * 32 + lane] = ra[d][i] + beta[i];
      if (checked && t == 0) continue;
      // The chain: beta at t-1 from b0 = beta + the emission at t, and the
      // next lane's first two b0.
      float b0[K];
#pragma unroll
      for (int i = 0; i < K; ++i) b0[i] = beta[i] + re[d][i];
      float q1 = __shfl_down_sync(kFull, b0[0], 1);
      float q2 = __shfl_down_sync(kFull, b0[K >= 2 ? 1 : 0], K >= 2 ? 1 : 2);
      if (lane > 30) q1 = kNegInf;
      if (lane > (K >= 2 ? 30 : 29)) q2 = kNegInf;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float y = i + 1 < K ? b0[i + 1 < K ? i + 1 : 0] : q1;
        float z = i + 2 < K ? b0[i + 2 < K ? i + 2 : 0]
                            : (i + 1 < K ? q1 : q2);
        z = skip[i] ? z : kNegInf;
        const float r = computed(lse3(b0[i], y, z));
        beta[i] = ok[i] ? r : kNegInf;
      }
      CTC_CLOCK(4, beta[K - 1]);
      const int tn = max(t - D, 0);
      load_k<K>(ra[d], ab + static_cast<size_t>(tn) * SP);
#pragma unroll
      for (int i = 0; i < K; ++i)
        re[d][i] = __ldg(lpb + static_cast<size_t>(tn) * C + cls[i]);
    }
    if ((c * D & (F - 1)) == 0) pair_arrive(1 + (j & 1));  // buffer j is full
  };
  int c = top;
  chunk(c, true);
  for (--c; c > 0; --c) chunk(c, false);
  if (c == 0) chunk(0, true);
#ifdef TPUASR_CTC_CLOCKS
  if (lane == 0 && b < kClockRows)
    for (int k = 3; k < kClockParts; ++k) ctc_clocks[1][b][k] = clk[k];
#endif
}

template <int K>
int launch(bool fwd, int B, const Args& p, cudaStream_t stream) {
  if (fwd) {
    ctc_fwd_kernel<K><<<B, 32, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = bwd_smem(K, p.frames, p.C, p.U);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_bwd_kernel<K><<<B, 64, static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool fwd, int B, int K, const Args& p, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<1>(fwd, B, p, stream);
    case 2: return launch<2>(fwd, B, p, stream);
    case 3: return launch<3>(fwd, B, p, stream);
    case 4: return launch<4>(fwd, B, p, stream);
    case 8: return launch<8>(fwd, B, p, stream);
    case 16: return launch<16>(fwd, B, p, stream);
    case 32: return launch<32>(fwd, B, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The checks both entries share; K must be the instance lane_states(S) of
// losses/ctc.py gives (1, 2, 3, 4, 8, 16 or 32 states a lane, 32K >= S),
// and a class must fit the class list's 20 bits.
int check_shape(int B, int T, int C, int U, int K) {
  const int S = 2 * U + 1;
  if (B <= 0 || T <= 0 || C <= 0 || C > (1 << 19) || U < 0 || S > 1024 ||
      32 * K < S)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// K6: alphas (B, T, 32K) (state s of frame t at [b, t, s], -1e30 past S),
// ll and loss (B,) f32 from log_probs (B, T, C) f32, labels (B, U) and the
// (B,) input and label lengths, each int32 or int64 (wide: bit 0 labels,
// bit 1 input lengths, bit 2 label lengths int64).
extern "C" int tpuasr_ctc_fwd(const float* lp, const void* labels,
                              const void* in_lens, const void* lab_lens,
                              float* alphas, float* ll, float* loss, int B,
                              int T, int C, int U, int K, int blank,
                              int zero_inf, int wide, cudaStream_t stream) {
  if (int err = check_shape(B, T, C, U, K)) return err;
  Args p{lp, labels, in_lens, lab_lens, alphas, ll, loss, nullptr, nullptr,
         T, C, U, blank, zero_inf, 0, wide};
  return dispatch(true, B, K, p, stream);
}

// K6b: grad (B, T, C) f32 from the forward's inputs, its alphas and ll, and
// the upstream gradient g (B,) f32. The frames a class-sum block holds
// are chosen here: 32, or fewer where the buffers outgrow shared memory.
extern "C" int tpuasr_ctc_bwd(const float* lp, const void* labels,
                              const void* in_lens, const void* lab_lens,
                              const float* alphas, const float* ll,
                              const float* g, float* grad, int B, int T,
                              int C, int U, int K, int blank, int wide,
                              cudaStream_t stream) {
  if (int err = check_shape(B, T, C, U, K)) return err;
  int F = 32;                  // a multiple of depth(K), which divides 32
  while (F > depth(K) && bwd_smem(K, F, C, U) > kSmemBudget) F /= 2;
  if (bwd_smem(K, F, C, U) > kSmemBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{lp, labels, in_lens, lab_lens, const_cast<float*>(alphas),
         const_cast<float*>(ll), nullptr, g, grad, T, C, U, blank, 0, F, wide};
  return dispatch(false, B, K, p, stream);
}

#ifdef TPUASR_CTC_CLOCKS
namespace {
// The bare chain: one warp runs `frames` alpha steps on K states a lane,
// every state live and skipping, the emissions fixed, nothing loaded or
// stored; the SM cycles they take go to *cycles. Its cycles a frame times
// T'-1 is the serial floor of this arithmetic.
template <int K>
__global__ void __launch_bounds__(32) chain_kernel(int frames,
                                                   long long* cycles,
                                                   float* sink) {
  const int lane = threadIdx.x;
  float a[K], e[K];
  bool ok[K], skip[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    a[i] = -0.25f * (lane * K + i);
    e[i] = -0.5f - 0.001f * i;
    ok[i] = true;
    skip[i] = ((lane * K + i) & 1) != 0;
  }
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 4
  for (int t = 0; t < frames; ++t) alpha_step<K>(a, e, ok, skip, lane);
  if (__float_as_uint(a[K - 1]) == 0x7fbadbadu) asm volatile("trap;");
  const long long t1 = clock64();
  if (lane == 0) *cycles = t1 - t0;
  sink[lane] = a[0];
}
}  // namespace

// The bare chain's SM cycles for `frames` frames at K states a lane (1, 2
// or 32) into cycles (device memory); sink takes 32 floats.
extern "C" int tpuasr_ctc_chain_cycles(int K, int frames, long long* cycles,
                                       float* sink) {
  switch (K) {
    case 1: chain_kernel<1><<<1, 32>>>(frames, cycles, sink); break;
    case 2: chain_kernel<2><<<1, 32>>>(frames, cycles, sink); break;
    case 32: chain_kernel<32><<<1, 32>>>(frames, cycles, sink); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The clock sums of the last launches: kernel 0 (K6) or 1 (K6b), rows b <
// rows, 5 parts each, into host memory.
extern "C" int tpuasr_ctc_clocks(int kernel, long long* host, int rows) {
  if (kernel < 0 || kernel > 1 || rows < 0 || rows > kClockRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, ctc_clocks, sizeof(long long) * kClockParts * rows,
      sizeof(long long) * kClockParts * kClockRows * kernel));
}
#endif
