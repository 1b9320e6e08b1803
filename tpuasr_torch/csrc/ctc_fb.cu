// CTC forward-backward recursions over extended-label emissions, float32.
//
// Replaces two Pallas kernels of tpuasr/losses/ctc_pallas.py:
//   K6   _alpha_kernel, built by _build_alpha_call (pallas_call at line 167):
//        the log-space alpha recursion;
//   K6b  _beta_kernel, built by _build_beta_call (line 192): the beta
//        recursion, with the emission at t+1, the per-row reset to beta_init
//        at t = len-1 and -1e30 past a row's length.
// Both take lp_ext (T, B, S): the log-probs gathered at the extended labels
// [blank, l1, blank, l2, ..., blank] (S = 2U+1), gathered by the wrapper
// with torch.gather as the JAX wrapper gathers outside its kernel. The
// masks are (B, S) float 0/1: allow[s] (the skip s-2 -> s) and valid[s]
// (s <= 2 * label_len). -1e30 stands for log 0, exactly as in JAX: every
// sum of three terms is m + log(exp(a-m) + exp(b-m) + exp(c-m)) with m the
// largest, so an all -1e30 triple stays at -1e30 + log 3 = -1e30.
//
// What bounds them on the H100: neither bytes nor operations. At the
// training shapes (T=249, B=16, S=49) a launch moves 1.6 MB (0.5 us at
// 3.35 TB/s) and does a few hundred thousand transcendentals; the 249 steps
// are sequential, so a step's latency (a shared-memory exchange, a
// __syncthreads and three expf and one logf) sets the time.
//
// Design: one block per utterance, one thread per extended state; the state
// vector stays in registers and crosses to the neighbours through a
// double-buffered shared array (one __syncthreads per step). The next
// step's emission is loaded before the current step's arithmetic, so its
// latency hides behind the exchange.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,    // (T,B,S)
                                 const float* __restrict__ allow, // (B, S)
                                 const float* __restrict__ valid, // (B, S)
                                 float* __restrict__ alphas,      // (T,B,S)
                                 int T, int B, int S) {
  extern __shared__ float buf[];                // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in = s < S;
  const bool skip = in && s >= 2 && allow[b * S + s] > 0.5f;
  const bool ok = in && valid[b * S + s] > 0.5f;
  const size_t row = static_cast<size_t>(B) * S;
  const float* lpb = lp + static_cast<size_t>(b) * S + s;
  float* out = alphas + static_cast<size_t>(b) * S + s;

  float a = (ok && s < 2) ? lpb[0] : kNegInf;
  if (in) out[0] = a;
  float next = (in && T > 1) ? lpb[row] : 0.f;
  for (int t = 1; t < T; ++t) {
    float* cur = buf + (t & 1) * S;
    if (in) cur[s] = a;
    __syncthreads();
    const float e = next;
    if (in && t + 1 < T) next = lpb[(t + 1) * row];
    if (in) {
      const float a1 = s >= 1 ? cur[s - 1] : kNegInf;
      const float a2 = skip ? cur[s - 2] : kNegInf;
      a = ok ? lse3(a, a1, a2) + e : kNegInf;
      out[t * row] = a;
    }
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp,     // (T,B,S)
                                const float* __restrict__ allow,  // (B, S)
                                const float* __restrict__ valid,  // (B, S)
                                const int* __restrict__ lens,     // (B,)
                                const int* __restrict__ label_lens,  // (B,)
                                float* __restrict__ betas,        // (T,B,S)
                                int T, int B, int S) {
  extern __shared__ float buf[];                // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in = s < S;
  // allow_fwd[s] = allow[s + 2]: the skip s -> s+2.
  const bool skip = in && s + 2 < S && allow[b * S + s + 2] > 0.5f;
  const bool ok = in && valid[b * S + s] > 0.5f;
  const int len = lens[b];
  const int L = label_lens[b];
  const float init =
      (s == 2 * L || (s == 2 * L - 1 && L > 0)) ? 0.f : kNegInf;
  const size_t row = static_cast<size_t>(B) * S;
  const float* lpb = lp + static_cast<size_t>(b) * S + s;
  float* out = betas + static_cast<size_t>(b) * S + s;

  float beta = kNegInf;
  float e = kNegInf;                            // emission at t+1 (none at T-1)
  float next = (in && T > 1) ? lpb[(T - 1) * row] : kNegInf;
  for (int t = T - 1; t >= 0; --t) {
    float* cur = buf + (t & 1) * S;
    const float b0 = beta + e;
    if (in) cur[s] = b0;
    __syncthreads();
    e = next;                                   // emission at t, for t-1
    if (in && t >= 2) next = lpb[(t - 1) * row];
    if (in) {
      const float b1 = s + 1 < S ? cur[s + 1] : kNegInf;
      const float b2 = skip ? cur[s + 2] : kNegInf;
      float v = ok ? lse3(b0, b1, b2) : kNegInf;
      if (t == len - 1) v = init;
      if (t >= len) v = kNegInf;
      beta = v;
      out[t * row] = v;
    }
  }
}

int launch_common(int B, int S, size_t* smem, int* threads) {
  if (S > 1024) return static_cast<int>(cudaErrorInvalidValue);
  *threads = (S + 31) / 32 * 32;
  *smem = 2 * sizeof(float) * S;
  return 0;
}

}  // namespace

// K6: alphas (T, B, S) from lp_ext (T, B, S), allow and valid (B, S).
extern "C" int tpuasr_ctc_alpha(const float* lp_ext, const float* allow,
                                const float* valid, float* alphas, int T,
                                int B, int S, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return 0;
  size_t smem;
  int threads;
  if (int err = launch_common(B, S, &smem, &threads)) return err;
  ctc_alpha_kernel<<<B, threads, smem, stream>>>(lp_ext, allow, valid, alphas,
                                                 T, B, S);
  return static_cast<int>(cudaGetLastError());
}

// K6b: betas (T, B, S) from lp_ext, allow, valid, input lengths and label
// lengths (B,) int32.
extern "C" int tpuasr_ctc_beta(const float* lp_ext, const float* allow,
                               const float* valid, const int* lens,
                               const int* label_lens, float* betas, int T,
                               int B, int S, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return 0;
  size_t smem;
  int threads;
  if (int err = launch_common(B, S, &smem, &threads)) return err;
  ctc_beta_kernel<<<B, threads, smem, stream>>>(lp_ext, allow, valid, lens,
                                                label_lens, betas, T, B, S);
  return static_cast<int>(cudaGetLastError());
}
