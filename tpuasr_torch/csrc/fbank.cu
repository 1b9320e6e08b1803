// Fused fbank kernel: wav -> frames -> window -> rDFT -> |X|^2 -> mel.
//
// Replaces the Pallas kernels of tpuasr/features/pallas_fused.py: K1,
// _make_framed_kernel built by _build_call_framed (pallas_call at line 109),
// and K1b, _fused_kernel built by _build_call (line 137). Pallas frames
// hop-sized rows inside the kernel only while the hop fits a 128-lane tile;
// here each block frames straight from the wav, so one kernel covers any hop.
//
// What bounds it on the H100: arithmetic. Per frame it does 2*win*n_freqs
// DFT FMAs plus n_freqs*n_out mel FMAs (51.6k + 8.3k at 8 kHz), against
// hop*4 new bytes of wav in and n_out*4 bytes out, so it is far above the
// memory roofline; the cos/sin tables (2 x 103 KB at 8 kHz) are read by
// every block and live in L2/L1.
//
// Design: one block per (utterance, tile of kFrames frames). The block reads
// its span of the wav once into shared memory (frames overlap: win 200, hop
// 80), windows the frames into shared memory, and each thread owns one
// frequency bin for all kFrames frames, so every cos/sin value it loads feeds
// 2*kFrames FMAs. The power spectrum stays in shared memory; only the
// projected (B, T, n_out) power reaches device memory. All arithmetic is
// fp32 FMA, never TF32: the JAX kernel runs at Precision.HIGHEST because
// lower precision moves low-energy log-mel values by 0.3-0.6.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 16;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fbank_power_kernel(const float* __restrict__ wav,
                   const float* __restrict__ window,
                   const float* __restrict__ cosm,
                   const float* __restrict__ sinm,
                   const float* __restrict__ proj,
                   float* __restrict__ out,
                   int S, int T, int hop, int win, int n_freqs, int n_out) {
  extern __shared__ float smem[];
  const int span_len = (kFrames - 1) * hop + win;
  float* span = smem;                          // [span_len]
  float* xw = span + span_len;                 // [kFrames][win]
  float* pw = xw + kFrames * win;              // [kFrames][n_freqs]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, T - t0);
  const float* w_b = wav + static_cast<size_t>(b) * S;
  const int64_t s0 = static_cast<int64_t>(t0) * hop;

  for (int i = threadIdx.x; i < span_len; i += kThreads) {
    const int64_t s = s0 + i;
    span[i] = s < S ? w_b[s] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFrames * win; i += kThreads) {
    const int fr = i / win;
    const int w = i - fr * win;
    xw[i] = fr < nf ? span[fr * hop + w] * window[w] : 0.f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freqs; f += kThreads) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) { re[i] = 0.f; im[i] = 0.f; }
    for (int w = 0; w < win; ++w) {
      const float c = __ldg(cosm + static_cast<size_t>(w) * n_freqs + f);
      const float s = __ldg(sinm + static_cast<size_t>(w) * n_freqs + f);
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        const float x = xw[i * win + w];
        re[i] = fmaf(x, c, re[i]);
        im[i] = fmaf(x, s, im[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i)
      pw[i * n_freqs + f] = re[i] * re[i] + im[i] * im[i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nf * n_out; idx += kThreads) {
    const int i = idx / n_out;
    const int m = idx - i * n_out;
    const float* p = pw + i * n_freqs;
    float acc = 0.f;
    for (int f = 0; f < n_freqs; ++f)
      acc = fmaf(p[f], __ldg(proj + static_cast<size_t>(f) * n_out + m), acc);
    out[(static_cast<size_t>(b) * T + t0 + i) * n_out + m] = acc;
  }
}

}  // namespace

extern "C" int tpuasr_fbank_power(const float* wav, const float* window,
                                  const float* cosm, const float* sinm,
                                  const float* proj, float* out, int B, int S,
                                  int T, int hop, int win, int n_freqs,
                                  int n_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>((kFrames - 1) * hop + win) + kFrames * win +
       kFrames * n_freqs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fbank_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((T + kFrames - 1) / kFrames, B);
  fbank_power_kernel<<<grid, kThreads, smem, stream>>>(
      wav, window, cosm, sinm, proj, out, S, T, hop, win, n_freqs, n_out);
  return static_cast<int>(cudaGetLastError());
}
