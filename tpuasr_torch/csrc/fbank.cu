// Fused fbank kernel: wav -> frames -> window -> rDFT -> |X|^2 -> mel, with
// both products on the tensor cores in split TF32.
//
// Replaces the Pallas kernels of tpuasr/features/pallas_fused.py: K1,
// _make_framed_kernel built by _build_call_framed (pallas_call at line 109),
// and K1b, _fused_kernel built by _build_call (line 137). Pallas frames
// hop-sized rows inside the kernel only while the hop fits a 128-lane tile;
// here each CTA frames straight from its staged wav span, so one kernel
// covers any hop (hop 110 at 11,025 Hz included).
//
// What bounds it on the H100: operations. A frame costs 2*win*(2*n_freqs)
// rDFT flops plus 2*n_freqs*n_out mel flops (103k + 16.5k at 8 kHz) against
// hop*4 new bytes of wav and n_out*4 bytes out. The JAX kernel multiplies at
// Precision.HIGHEST (single-pass low precision moves low-energy log-mel
// values by 0.3-0.6), so float32 precision is the contract: on TF32 tensor
// cores that takes three products a term (a = hi + lo, each TF32; a*b ~
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b), so the bound is 3x the flops at 495
// TFLOP/s (0.093 ms at 8 kHz, B=128 x 10 s; the float32 FMA bound, 67
// TFLOP/s, is 0.228 ms). The split carries 22 of float32's 24 bits, and
// the tensor cores accumulate with truncation; both matter only near a
// spectral null (|X_k| thousands of times below the sum of its terms),
// where this kernel's distance from a float64 rDFT is of the order of the
// plain version's float32 matmuls' (fbank: closer; single spectrogram
// bins: 0.6-1.4x theirs; tools/fbank_time.py --precision, chip_smoke).
//
// Design (the plan, features/fused.py::fbank_plan, picks M, the chunks, the
// stages and the CTAs; tpuasr_fbank_smem is the layout the launcher checks
// the plan's figure against):
// - Persistent CTAs of 8 warps, one an SM, each walking tiles of M frames
//   of one utterance. A CTA stages a tile's wav span ((M-1)*hop + win
//   samples) once, as rows of hop samples (or of the Kp a frame reads,
//   where hop > Kp) with a stride of 4 mod 8 floats, by cp.async (16 B
//   where the rows are 16-byte aligned, 4 B otherwise), so the A fragments
//   of 8 frames fall in 8 distinct banks; the next tile's span loads
//   during this tile's mel stage. A[i][w] = span[i*hop + w] * window[w] is
//   read straight from the span, rounded to float32 as the plain version
//   rounds it, and split into TF32 hi and lo in registers (cvt.rna's
//   rounding on the bits): no frame matrix anywhere.
// - B is the (cos_k, sin_k)-interleaved rDFT table; sin is zero at DC and
//   at Nyquist (even n_fft), so the first pair is (cos_0, cos_nyq) and 129
//   bins take 256 columns. Split into TF32 hi and lo and laid out on the
//   host once (pack_tables), streamed from L2 into a ring of shared-memory
//   stages by TMA bulk copies on each stage's mbarrier. The last warp to
//   finish reading a slot (a count in shared memory) refills it, so no CTA
//   barrier runs a stage; two run a tile (the span is staged; the power
//   tile is whole).
// - M = 64 (wherever the layout fits): wgmma. The two warpgroups take the
//   tile's 64 frames each, and half of a chunk's 256 rDFT columns (the
//   table padded with zero columns to a multiple of 256) and of its 64
//   mel columns. A is the register operand (its fragment is mma.m16n8k8's
//   per warp), B a K-major tile without swizzle: a k-step of a stage holds
//   [hi, lo][K 0-3, 4-7][columns][4]. Each term is three m64n128k8 TF32
//   products, smallest first (lo*hi, hi*lo, hi*hi); a stage's products (of
//   stage_k = 4, 3 or 2 k-steps, the deepest whose ring of 2 stages fits)
//   go into fresh sums (scale-d 0), waited for, then added to the running
//   sums by IEEE float32 adds: adding into the whole running sum, the
//   tensor cores' truncation doubled the error near spectral nulls (9.7e-4
//   of the 1e-3 gate at 8 kHz B=128). The wait a stage is also what frees
//   the A registers; the other warpgroup's products fill the tensor cores
//   meanwhile.
// - M = 32 or 16 (only where 64 frames' span and power tile do not fit, a
//   large n_fft): mma.sync.m16n8k8, 8 warps each holding MT m-tiles x up
//   to 8 n-tiles of a chunk, B in mma fragment order (for each k-step and
//   column the 4 lanes' (hi b0, hi b1, lo b0, lo b1) as float4s: one
//   conflict-free 16-byte load a lane), the same three products and
//   stage-fresh sums.
// - Under both, a thread holds columns 2*tig and 2*tig + 1 of its rows:
//   re_k and im_k of one bin, so the power is formed in registers. The
//   chunk's epilogue writes p = re^2 + im^2 into an M x n_freqs power tile
//   in shared memory, in the mel product's A-fragment order (bin 4j + tig
//   of n-tile j is component 2*(j & 1) of the same lane's float4 in mel
//   k-step j / 2); it never reaches device memory.
// - The mel stage (power @ proj: proj laid out as B, rows past n_freqs and
//   columns past n_out zero) runs through the same ring and the same split
//   products (its terms are all positive: no running-sum flush). The
//   spectrogram's identity proj takes the same path. Frames >= T and
//   columns >= n_out are masked at the store.
// - The five faults of the first kernel: no one-thread tail (every warp
//   takes columns of the chunk; the Nyquist bin shares DC's column pair);
//   B comes from shared memory straight into the tensor cores (wgmma) or
//   as one 16-byte load for 3*MT mma, not one 4-byte load for two FMAs; the
//   mel stage is a tensor-core product, not a serial FMA chain; the tensor
//   cores do all the arithmetic; tiles of 64 frames read the tables from
//   L2 a quarter as often as tiles of 16.
// Deterministic: no value is summed by atomics (the one atomic counts a
// slot's readers); the same inputs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kNtMax = 8;       // n-tiles a warp holds in a chunk
constexpr int kBank = 4;        // the mel stage's n-tiles a warp, banked
constexpr int kFlushTiles = 4;  // rDFT n-tiles a warp sums in one go
constexpr int kStageK = 2;      // k-steps of 8 in a ring stage
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 64;   // a full mbarrier and a release count a stage
constexpr int kWgCols = 256;    // wgmma route: rDFT columns a chunk (128 a
constexpr int kWgMelCols = 64;  // warpgroup) and mel columns (32)
constexpr int kWgStageMax = 4;  // k-steps of an rDFT stage (wgmma route)
constexpr long long kSmemLimit = 232448;

#ifdef TPUASR_FBANK_CLOCKS
// SM cycles thread 0 of each CTA spends in: staging (to the first stage's
// barrier), the later stages' barriers and ring waits, issuing ring stages
// and spans, the rDFT products, the rDFT epilogues, the mel products, the
// mel stores.
enum { kStaging, kWait, kIssue, kDft, kDftEpi, kMel, kMelEpi, kClocks = 8 };
__device__ long long* g_clock_buf = nullptr;
#define FBANK_CLOCK(slot)                  \
  do {                                     \
    const long long now_ = clock_now();    \
    clk[slot] += now_ - clk_prev;          \
    clk_prev = now_;                       \
  } while (0)
#else
#define FBANK_CLOCK(slot) \
  do {                    \
  } while (0)
#endif

// ---- PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count) : "memory");
}

// Makes the mbarrier inits visible to the async proxy.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_arrive(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes) : "memory");
}

// Waits for the phase of the given parity. A wait that has not completed
// after 2^28 polls (seconds; no stage takes a millisecond) traps, so that a
// fault in the ring's accounting ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
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

// d += a * b on one 16 x 8 x 8 TF32 tile (a row-major, b column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a read or write of d across a wgmma
// fence, issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory matrix descriptor of wgmma for a K-major tile without
// swizzle: its start, the byte offsets of neighbouring core matrices (8
// rows x 16 bytes) along K (lbo) and of neighbouring 8-row groups (sbo).
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

// d (64 x 128, f32) = A (64 x 8, TF32 in registers) B^T (128 x 8, K-major
// in shared memory at descriptor b), plus d where scale is 1: one
// warpgroup's asynchronous product; d may be read only after wgmma_wait.
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (64 x 32, f32) = A (64 x 8, TF32 in registers) B^T (32 x 8, K-major
// in shared memory at descriptor b), plus d where scale is 1: one
// warpgroup's asynchronous product; d may be read only after wgmma_wait.
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

#ifdef TPUASR_FBANK_CLOCKS
__device__ __forceinline__ long long clock_now() { return clock64(); }
#endif
// ---- end PTX helpers

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero, 10 mantissa bits), on the bits: two integer ops.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// Shared-memory layout: the stages' full mbarriers and release counts (64
// bytes), then in floats
// the ring [stages][2 k-steps][cols][4 lanes][4], the span [rows][ldh], the
// window and span offsets [Kp] (float2), the power tile [M/16][nfp/8][32
// lanes][4].
__host__ __device__ inline int span_rows(int M, int hop, int Kp) {
  return M + (Kp - 1) / hop;
}

// A span row holds the min(hop, Kp) samples of a hop that frames read.
__host__ __device__ inline int span_ld(int hop, int Kp) {
  const int len = hop < Kp ? hop : Kp;
  return len + (12 - len % 8) % 8;      // the least >= len that is 4 mod 8
}

__host__ __device__ inline long long smem_bytes(int M, int hop, int Kp,
                                               int nfp, int stage_k,
                                               int stage_cols, int stages) {
  return kBarBytes +
         4 * (static_cast<long long>(stages) * stage_k * stage_cols * 16 +
              static_cast<long long>(span_rows(M, hop, Kp)) *
                  span_ld(hop, Kp) +
              2LL * Kp + static_cast<long long>(M) * nfp);
}

struct Params {
  const float* wav;     // (B, S)
  const float* window;  // (Kp,), zero past win
  const float* dft;     // (Kp/8, Nd, 4, 4): the rDFT table's fragments
  const float* mel;     // (nfp/8, No, 4, 4): proj's fragments
  float* out;           // (B, T, n_out)
  int S, T, hop, Kp, Nd, nfp, No, n_out, tiles_t, n_tiles;
  int nyq;              // the Nyquist bin, paired with DC; -1: no pairing
  int dft_nt, dft_chunks, mel_nt, mel_chunks, stage_k, stage_cols, stages;
  int vec;
};

// Stage the span of the tile starting at frame t0 of utterance b: row r
// holds samples [(t0 + r) * hop, + rlen); past S, zeros.
__device__ __forceinline__ void stage_span(const Params& prm, float* span,
                                           int b, int t0, int rows, int ldh,
                                           int rlen) {
  const float* wav_b = prm.wav + static_cast<long long>(b) * prm.S;
  const long long s0 = static_cast<long long>(t0) * prm.hop;
  if (prm.vec) {
    const int q = rlen / 4;
    for (int idx = threadIdx.x; idx < rows * q; idx += kThreads) {
      const int r = idx / q, c = (idx - r * q) * 4;
      const long long s = s0 + static_cast<long long>(r) * prm.hop + c;
      float* dst = span + r * ldh + c;
      if (s < prm.S) cp_async16(dst, wav_b + s);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * rlen; idx += kThreads) {
      const int r = idx / rlen, c = idx - r * rlen;
      const long long s = s0 + static_cast<long long>(r) * prm.hop + c;
      if (s < prm.S) cp_async4(span + r * ldh + c, wav_b + s);
      else span[r * ldh + c] = 0.f;
    }
  }
  cp_async_commit();
}

// The three split products of one k-step over a warp's tiles of a chunk:
// B fragments (float4 a lane: hi b0, hi b1, lo b0, lo b1) from the ring
// slot's k-step, columns of n-tiles wn + WN * u below nt, u < NU, summed
// into the accumulators U0 + u.
template <int MT, int WN, int NU, int U0>
__device__ __forceinline__ void products(float (&acc)[MT][kNtMax][4],
                                         const uint32_t (&ahi)[MT][4],
                                         const uint32_t (&alo)[MT][4],
                                         const float4* bk, int wn, int nt) {
  uint32_t bf[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (wn + WN * u >= nt) continue;           // warp-uniform
    const float4 v = bk[(wn + WN * u) * 32];
    bf[u][0] = __float_as_uint(v.x);
    bf[u][1] = __float_as_uint(v.y);
    bf[u][2] = __float_as_uint(v.z);
    bf[u][3] = __float_as_uint(v.w);
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (wn + WN * u >= nt) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma_tf32(acc[mt][U0 + u], alo[mt], bf[u][0], bf[u][1]);
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (wn + WN * u >= nt) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma_tf32(acc[mt][U0 + u], ahi[mt], bf[u][2], bf[u][3]);
  }
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (wn + WN * u >= nt) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma_tf32(acc[mt][U0 + u], ahi[mt], bf[u][0], bf[u][1]);
  }
}

// The rDFT's ring stage: the three split products of its k-steps, for H of
// the warp's n-tiles at a time, go into fresh sums, which join the running
// sums by IEEE float32 adds. The tensor cores add into their accumulator
// with truncation, and near a spectral null (|X_k| thousands of times below
// the sum of its terms) truncations against the whole running sum cost more
// than the split itself; against a stage's own sum they cost little.
template <int MT, int WN, int H>
__device__ __forceinline__ void products_stage(
    float (&acc)[MT][kNtMax][4], const uint32_t (&ahi)[kStageK][MT][4],
    const uint32_t (&alo)[kStageK][MT][4], const float4* bk, int kstride,
    int ks, int wn, int nt) {
#pragma unroll
  for (int h = 0; h < kNtMax / H; ++h) {
    float st[MT][kNtMax][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < kNtMax; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][u][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      if (kk >= ks) break;
      // n-tiles wn + WN * (h * H + u): the B pointer and the bound shift
      if (h == 0)
        products<MT, WN, H, 0>(st, ahi[kk], alo[kk], bk + kk * kstride, wn,
                               nt);
      else
        products<MT, WN, H, (H < kNtMax ? H : 0)>(
            st, ahi[kk], alo[kk], bk + kk * kstride + WN * H * 32, wn,
            nt - WN * H);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = h * H; u < h * H + H; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][u][e] = __fadd_rn(acc[mt][u][e], st[mt][u][e]);
  }
}

// The stage sequence of a tile, walked without divisions: the rDFT's
// chunks x kd stages, then the mel's chunks x km; then the next tile's.
struct StageIter {
  int mel = 0, c = 0, j = 0;
  __device__ __forceinline__ bool tile_start() const {
    return !mel && !c && !j;
  }
  __device__ __forceinline__ bool mel_start() const { return mel && !c && !j; }
  __device__ __forceinline__ void next(const Params& prm, int kd, int km) {
    if (++j < (mel ? km : kd)) return;
    j = 0;
    if (++c < (mel ? prm.mel_chunks : prm.dft_chunks)) return;
    c = 0;
    mel ^= 1;
  }
};

template <int MT, int WN>
__global__ void __launch_bounds__(kThreads, 1)
fbank_tc_kernel(const Params prm) {
  constexpr int WM = kThreads / 32 / WN;
  constexpr int M = WM * MT * 16;
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + kMaxStages);
  const int hop = prm.hop, Kp = prm.Kp, nfp = prm.nfp;
  const int rows = span_rows(M, hop, Kp);
  const int ldh = span_ld(hop, Kp);
  const int rlen = hop < Kp ? hop : Kp;
  const int slot_floats = kStageK * prm.stage_cols * 16;
  float* ring = reinterpret_cast<float*>(smem4) + kBarBytes / 4;
  float* span = ring + prm.stages * slot_floats;
  float2* winoff = reinterpret_cast<float2*>(span + rows * ldh);
  float4* pf = reinterpret_cast<float4*>(span + rows * ldh + 2 * Kp);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#ifdef TPUASR_FBANK_CLOCKS
  long long clk[kClocks] = {}, clk_prev = clock_now();
#endif

  const int kt_dft = Kp / 8, kt_mel = nfp / 8;          // k-steps of 8
  const int kd = (kt_dft + kStageK - 1) / kStageK;      // stages a chunk
  const int km = (kt_mel + kStageK - 1) / kStageK;
  const int per_tile = prm.dft_chunks * kd + prm.mel_chunks * km;
  const int nt_dft = prm.Nd / 8, nt_mel = prm.No / 8;
  const int my_tiles = (prm.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_total = my_tiles * per_tile;
  const bool banked = prm.mel_nt <= kBank * WN;

  // Ring stage `it` into `slot`, by one thread: the slot's mbarrier expects
  // its bytes, and one TMA bulk copy a k-step brings the chunk's columns.
  auto issue = [&](const StageIter& it, int slot) {
    const float* table = it.mel ? prm.mel : prm.dft;
    const int nt_c = it.mel ? prm.mel_nt : prm.dft_nt;
    const int N = it.mel ? prm.No : prm.Nd;
    const int kt = it.mel ? kt_mel : kt_dft;
    const int cols = min(nt_c, N / 8 - it.c * nt_c) * 8;
    const int ks = min(kStageK, kt - it.j * kStageK);
    const uint32_t bytes = cols * 64;
    float* dst = ring + slot * slot_floats;
    const float* src = table + (static_cast<long long>(it.j * kStageK) * N +
                                it.c * nt_c * 8) * 16;
    mbar_expect_arrive(full + slot, bytes * ks);
    for (int kk = 0; kk < ks; ++kk)
      bulk_copy(dst + kk * prm.stage_cols * 16,
                src + static_cast<long long>(kk) * N * 16, bytes, full + slot);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < prm.stages; ++i) {
      mbar_init(full + i, 1);
      released[i] = 0;
    }
    fence_init();
  }
  stage_span(prm, span, blockIdx.x / prm.tiles_t,
             (blockIdx.x % prm.tiles_t) * M, rows, ldh, rlen);
  for (int w = threadIdx.x; w < Kp; w += kThreads)      // A = span * window
    winoff[w] = make_float2(prm.window[w],
                            __int_as_float((w / hop) * ldh + w % hop));
  for (int i = threadIdx.x; i < M * nfp / 4; i += kThreads)
    pf[i] = make_float4(0.f, 0.f, 0.f, 0.f);    // bins no chunk writes: 0
  __syncthreads();                              // the mbarriers' init
  StageIter ahead;                              // stage gs + stages
  for (int i = 0; i < prm.stages; ++i) {
    if (threadIdx.x == 0 && i < n_total) issue(ahead, i);
    ahead.next(prm, kd, km);
  }

  const int g = lane >> 2, tig = lane & 3;
  const int wn = warp % WN;
  const int row0 = (warp / WN) * MT * 16;
  const int mt0 = row0 / 16;                 // the warp's first m-tile
  float acc[MT][kNtMax][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int u = 0; u < kNtMax; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][u][e] = 0.f;

  StageIter it;
  int slot = 0, tile = blockIdx.x, i_tile = 0;
  uint32_t parity = 0;
  for (int gs = 0; gs < n_total; ++gs) {
    if (it.tile_start()) {                     // this tile's span, and every
      cp_async_wait_all();                     // warp past the last mel
      __syncthreads();
      FBANK_CLOCK(gs == 0 ? kStaging : kWait);
    } else if (it.mel_start()) {
      __syncthreads();                         // the power tile is whole and
      FBANK_CLOCK(kWait);                      // the span is free: stage the
      if (i_tile + 1 < my_tiles) {             // next tile's
        const int next = tile + gridDim.x;
        stage_span(prm, span, next / prm.tiles_t, (next % prm.tiles_t) * M,
                   rows, ldh, rlen);
      }
      FBANK_CLOCK(kIssue);
    }
    mbar_wait(full + slot, parity);
    FBANK_CLOCK(kWait);

    const float4* sl = reinterpret_cast<const float4*>(ring +
                                                       slot * slot_floats);
    const bool dft = !it.mel;
    const int nt_c = dft ? prm.dft_nt : prm.mel_nt;
    const int n0 = it.c * nt_c;
    const int nt = min(nt_c, (dft ? nt_dft : nt_mel) - n0);
    const int t_first = it.j * kStageK;
    const int ks = min(kStageK, (dft ? kt_dft : kt_mel) - t_first);
    uint32_t ahi[kStageK][MT][4], alo[kStageK][MT][4];
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      if (kk >= ks) break;
      const int t = t_first + kk;
      if (dft) {
        // x * window rounded to float32 as the plain version rounds it
        const float2 wo0 = winoff[8 * t + tig], wo1 = winoff[8 * t + tig + 4];
        const int o0 = __float_as_int(wo0.y), o1 = __float_as_int(wo1.y);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* sp = span + (row0 + mt * 16 + g) * ldh;
          split(__fmul_rn(sp[o0], wo0.x), ahi[kk][mt][0], alo[kk][mt][0]);
          split(__fmul_rn(sp[8 * ldh + o0], wo0.x), ahi[kk][mt][1],
                alo[kk][mt][1]);
          split(__fmul_rn(sp[o1], wo1.x), ahi[kk][mt][2], alo[kk][mt][2]);
          split(__fmul_rn(sp[8 * ldh + o1], wo1.x), ahi[kk][mt][3],
                alo[kk][mt][3]);
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 a = pf[((mt0 + mt) * kt_mel + t) * 32 + lane];
          split(a.x, ahi[kk][mt][0], alo[kk][mt][0]);
          split(a.y, ahi[kk][mt][1], alo[kk][mt][1]);
          split(a.z, ahi[kk][mt][2], alo[kk][mt][2]);
          split(a.w, ahi[kk][mt][3], alo[kk][mt][3]);
        }
      }
    }
    const float4* bk = sl + lane;
    const int kstride = prm.stage_cols * 4;
    if (dft) {
      products_stage<MT, WN, kFlushTiles>(acc, ahi, alo, bk, kstride, ks,
                                          wn, nt);
    } else {
      // The mel stage's few tiles a warp take two accumulator banks, one
      // for each k-step of a stage, so that their chains interleave.
#pragma unroll
      for (int kk = 0; kk < kStageK; ++kk) {
        if (kk >= ks) break;
        if (!banked)
          products<MT, WN, kNtMax, 0>(acc, ahi[kk], alo[kk],
                                      bk + kk * kstride, wn, nt);
        else if (kk == 0)
          products<MT, WN, kBank, 0>(acc, ahi[kk], alo[kk], bk, wn, nt);
        else
          products<MT, WN, kBank, kBank>(acc, ahi[kk], alo[kk],
                                         bk + kk * kstride, wn, nt);
      }
    }
    // The slot is read: the last of the 8 warps to say so refills it with
    // stage gs + stages (the count only grows: every 8th arrival is last).
    __syncwarp();
    if (lane == 0 && (atomicAdd(released + slot, 1u) & 7u) == 7u &&
        gs + prm.stages < n_total)
      issue(ahead, slot);
    ahead.next(prm, kd, km);
    if (++slot == prm.stages) {
      slot = 0;
      parity ^= 1;
    }
    if (dft) FBANK_CLOCK(kDft);
    else FBANK_CLOCK(kMel);

    if (dft && it.j == kd - 1) {
      // Power of the chunk's bins into the tile, in the mel A order. Where
      // the table pairs (cos_0, cos_nyq) in its first column pair (sin is
      // zero at both), that pair's two squares are two bins.
#pragma unroll
      for (int u = 0; u < kNtMax; ++u) {
        const int jg = n0 + wn + WN * u;        // global n-tile
        if (wn + WN * u >= nt) continue;
        const int bin = 4 * jg + tig;
        const bool dc = prm.nyq >= 0 && bin == 0;
        if (prm.nyq >= 0 && bin >= prm.nyq) continue;   // zero columns
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* a = acc[mt][u];
          float* dst = reinterpret_cast<float*>(
              pf + ((mt0 + mt) * kt_mel + (jg >> 1)) * 32 + lane);
          if (dc) {
            const int q = prm.nyq;
            float* ny = reinterpret_cast<float*>(
                pf + ((mt0 + mt) * kt_mel + (q >> 3)) * 32 + g * 4 + (q & 3));
            *reinterpret_cast<float2*>(ny + (q & 4 ? 2 : 0)) =
                make_float2(a[1] * a[1], a[3] * a[3]);
            a[1] = a[3] = 0.f;
          }
          *reinterpret_cast<float2*>(dst + 2 * (jg & 1)) =
              make_float2(a[0] * a[0] + a[1] * a[1],
                          a[2] * a[2] + a[3] * a[3]);
          a[0] = a[1] = a[2] = a[3] = 0.f;
        }
      }
      FBANK_CLOCK(kDftEpi);
    } else if (!dft && it.j == km - 1) {
      const int b = tile / prm.tiles_t, t0 = (tile % prm.tiles_t) * M;
      const int nf = min(M, prm.T - t0);
      float* out_b = prm.out + (static_cast<long long>(b) * prm.T + t0) *
                                   prm.n_out;
#pragma unroll
      for (int u = 0; u < kNtMax; ++u) {
        if (wn + WN * u >= nt) continue;
        const int col = (n0 + wn + WN * u) * 8 + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = row0 + mt * 16 + g;
          float* a = acc[mt][u];
          if (banked && u < kBank) {
            float* a2 = acc[mt][u + kBank];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              a[e] += a2[e];
              a2[e] = 0.f;
            }
          }
          if (r < nf) {
            if (col < prm.n_out) out_b[r * prm.n_out + col] = a[0];
            if (col + 1 < prm.n_out) out_b[r * prm.n_out + col + 1] = a[1];
          }
          if (r + 8 < nf) {
            if (col < prm.n_out) out_b[(r + 8) * prm.n_out + col] = a[2];
            if (col + 1 < prm.n_out)
              out_b[(r + 8) * prm.n_out + col + 1] = a[3];
          }
          a[0] = a[1] = a[2] = a[3] = 0.f;
        }
      }
      FBANK_CLOCK(kMelEpi);
    }
    it.next(prm, kd, km);
    if (it.tile_start()) {
      tile += gridDim.x;
      ++i_tile;
    }
  }
#ifdef TPUASR_FBANK_CLOCKS
  if (threadIdx.x == 0 && g_clock_buf) {
    long long* o = g_clock_buf + kClocks * static_cast<long long>(blockIdx.x);
    for (int i = 0; i < kClocks; ++i) o[i] = clk[i];
  }
#endif
}

// ---- the wgmma route (M = 64)

// The descriptor of B for k-step kk, plane (0 hi, 1 lo), in a ring slot of
// a product W columns wide, from column c0: a k-step holds [plane][half (K
// 0-3, 4-7)][W columns][4 floats], so the halves lie 16 * W bytes apart
// (lbo) and 8-column core matrices 128 bytes apart (sbo).
__device__ __forceinline__ uint64_t b_desc(const float* slot, int kk,
                                           int plane, int W, int c0) {
  return smem_desc(slot + (2 * kk + plane) * 8 * W + 4 * c0, 16 * W, 128);
}

// One warpgroup's split products of KS k-steps, N columns: the A fragments
// of every k-step from build(kk, hi, lo), then for each k-step lo*hi,
// hi*lo, hi*hi against B at column c0 of the slot. d = their sum, added to
// d unless fresh (then the first overwrites it); waited for, so that d may
// be read, and the slot and the A registers reused. (Building each
// k-step's A just before its products, behind a fence of its own, measured
// no faster over the two rates: 4% faster at 8 kHz, 6% slower at 16.)
template <int N, int KS, class Build>
__device__ __forceinline__ void wg_products(float (&d)[N / 2],
                                            const float* slot, int W, int c0,
                                            bool fresh, Build build) {
  uint32_t ahi[KS][4], alo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) build(kk, ahi[kk], alo[kk]);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t bh = b_desc(slot, kk, 0, W, c0);
    const uint64_t bl = b_desc(slot, kk, 1, W, c0);
    const int add = kk > 0 || !fresh;
    if constexpr (N == 128) {
      wgmma_n128(d, alo[kk], bh, add);
      wgmma_n128(d, ahi[kk], bl, 1);
      wgmma_n128(d, ahi[kk], bh, 1);
    } else {
      wgmma_n32(d, alo[kk], bh, add);
      wgmma_n32(d, ahi[kk], bl, 1);
      wgmma_n32(d, ahi[kk], bh, 1);
    }
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(d);
}

// wg_products of n <= KS k-steps (n known only at run time).
template <int N, int KS, class Build>
__device__ __forceinline__ void wg_products_n(int n, float (&d)[N / 2],
                                              const float* slot, int W,
                                              int c0, bool fresh,
                                              Build build) {
  if constexpr (KS > 1) {
    if (n < KS) {
      wg_products_n<N, KS - 1>(n, d, slot, W, c0, fresh, build);
      return;
    }
  }
  wg_products<N, KS>(d, slot, W, c0, fresh, build);
}

// Tiles of 64 frames: warpgroup wg takes all 64 rows (warp wi of it rows
// 16 wi to 16 wi + 15) and columns [128 wg, + 128) of each rDFT chunk,
// [32 wg, + 32) of each mel chunk. The tables (pack_tables' "dft_wg",
// "mel_wg") are [chunk][k-step][hi, lo][half][W][4], so a ring stage
// (stage_k rDFT k-steps, or 4 * stage_k mel k-steps, of one chunk) is one
// contiguous run.
__global__ void __launch_bounds__(kThreads, 1)
fbank_wg_kernel(const Params prm) {
  constexpr int M = 64;
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + kMaxStages);
  const int hop = prm.hop, Kp = prm.Kp, nfp = prm.nfp;
  const int rows = span_rows(M, hop, Kp);
  const int ldh = span_ld(hop, Kp);
  const int rlen = hop < Kp ? hop : Kp;
  const int slot_floats = prm.stage_k * prm.stage_cols * 16;
  float* ring = reinterpret_cast<float*>(smem4) + kBarBytes / 4;
  float* span = ring + prm.stages * slot_floats;
  float2* winoff = reinterpret_cast<float2*>(span + rows * ldh);
  float4* pf = reinterpret_cast<float4*>(span + rows * ldh + 2 * Kp);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3;
  const int sk_dft = prm.stage_k;                       // k-steps a stage
  const int sk_mel = prm.stage_k * (kWgCols / kWgMelCols);
  const int g = lane >> 2, tig = lane & 3;
#ifdef TPUASR_FBANK_CLOCKS
  long long clk[kClocks] = {}, clk_prev = clock_now();
#endif

  const int kt_dft = Kp / 8, kt_mel = nfp / 8;          // k-steps of 8
  const int kd = (kt_dft + sk_dft - 1) / sk_dft;        // stages a chunk
  const int km = (kt_mel + sk_mel - 1) / sk_mel;
  const int per_tile = prm.dft_chunks * kd + prm.mel_chunks * km;
  const int my_tiles = (prm.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_total = my_tiles * per_tile;

  // Ring stage `it` into `slot`, by one thread: one TMA bulk copy.
  auto issue = [&](const StageIter& it, int slot) {
    const int W = it.mel ? kWgMelCols : kWgCols;
    const int kt = it.mel ? kt_mel : kt_dft;
    const int sk = it.mel ? sk_mel : sk_dft;
    const int k0 = it.j * sk;
    const int ks = min(sk, kt - k0);
    const uint32_t bytes = ks * 64 * W;
    const float* src = (it.mel ? prm.mel : prm.dft) +
                       (static_cast<long long>(it.c) * kt + k0) * 16 * W;
    mbar_expect_arrive(full + slot, bytes);
    bulk_copy(ring + slot * slot_floats, src, bytes, full + slot);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < prm.stages; ++i) {
      mbar_init(full + i, 1);
      released[i] = 0;
    }
    fence_init();
  }
  stage_span(prm, span, blockIdx.x / prm.tiles_t,
             (blockIdx.x % prm.tiles_t) * M, rows, ldh, rlen);
  for (int w = threadIdx.x; w < Kp; w += kThreads)      // A = span * window
    winoff[w] = make_float2(prm.window[w],
                            __int_as_float((w / hop) * ldh + w % hop));
  for (int i = threadIdx.x; i < M * nfp / 4; i += kThreads)
    pf[i] = make_float4(0.f, 0.f, 0.f, 0.f);    // bins no chunk writes: 0
  __syncthreads();                              // the mbarriers' init
  StageIter ahead;                              // stage gs + stages
  for (int i = 0; i < prm.stages; ++i) {
    if (threadIdx.x == 0 && i < n_total) issue(ahead, i);
    ahead.next(prm, kd, km);
  }

  float run[64], fresh[64], mel[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) mel[i] = 0.f;
  const float* srow = span + (wi * 16 + g) * ldh;       // this lane's rows
  const float4* prow = pf + wi * kt_mel * 32 + lane;

  StageIter it;
  int slot = 0, tile = blockIdx.x, i_tile = 0;
  uint32_t parity = 0;
  for (int gs = 0; gs < n_total; ++gs) {
    if (it.tile_start()) {                     // this tile's span, and every
      cp_async_wait_all();                     // warp past the last mel
      __syncthreads();
      FBANK_CLOCK(gs == 0 ? kStaging : kWait);
    } else if (it.mel_start()) {
      __syncthreads();                         // the power tile is whole and
      FBANK_CLOCK(kWait);                      // the span is free: stage the
      if (i_tile + 1 < my_tiles) {             // next tile's
        const int next = tile + gridDim.x;
        stage_span(prm, span, next / prm.tiles_t, (next % prm.tiles_t) * M,
                   rows, ldh, rlen);
      }
      FBANK_CLOCK(kIssue);
    }
    mbar_wait(full + slot, parity);
    FBANK_CLOCK(kWait);

    const float* sl = ring + slot * slot_floats;
    const bool dft = !it.mel;
    if (dft) {
      const int t_first = it.j * sk_dft;
      // x * window rounded to float32 as the plain version rounds it
      auto build = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        const int t = t_first + kk;
        const float2 wo0 = winoff[8 * t + tig], wo1 = winoff[8 * t + tig + 4];
        const int o0 = __float_as_int(wo0.y), o1 = __float_as_int(wo1.y);
        split(__fmul_rn(srow[o0], wo0.x), hi[0], lo[0]);
        split(__fmul_rn(srow[8 * ldh + o0], wo0.x), hi[1], lo[1]);
        split(__fmul_rn(srow[o1], wo1.x), hi[2], lo[2]);
        split(__fmul_rn(srow[8 * ldh + o1], wo1.x), hi[3], lo[3]);
      };
      wg_products_n<128, kWgStageMax>(min(sk_dft, kt_dft - t_first), fresh,
                                      sl, kWgCols, 128 * wg, true, build);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], fresh[i]);
    } else {
      const int t_first = it.j * sk_mel;
      const int ks = min(sk_mel, kt_mel - t_first);
      for (int p = 0; p < ks; p += kWgStageMax) {
        auto build = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          const float4 a = prow[(t_first + p + kk) * 32];
          split(a.x, hi[0], lo[0]);
          split(a.y, hi[1], lo[1]);
          split(a.z, hi[2], lo[2]);
          split(a.w, hi[3], lo[3]);
        };
        wg_products_n<32, kWgStageMax>(min(kWgStageMax, ks - p), mel,
                                       sl + p * 16 * kWgMelCols, kWgMelCols,
                                       32 * wg, false, build);
      }
    }
    // The slot is read (the products were waited for): the last of the 8
    // warps to say so refills it with stage gs + stages.
    __syncwarp();
    if (lane == 0 && (atomicAdd(released + slot, 1u) & 7u) == 7u &&
        gs + prm.stages < n_total)
      issue(ahead, slot);
    ahead.next(prm, kd, km);
    if (++slot == prm.stages) {
      slot = 0;
      parity ^= 1;
    }
    if (dft) FBANK_CLOCK(kDft);
    else FBANK_CLOCK(kMel);

    if (dft && it.j == kd - 1) {
      // Power of the chunk's bins into the tile, in the mel A order. Where
      // the table pairs (cos_0, cos_nyq) in its first column pair, that
      // pair's two squares are two bins.
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int jg = it.c * 32 + wg * 16 + u;     // global n-tile
        const int bin = 4 * jg + tig;
        if (bin >= nfp || (prm.nyq >= 0 && bin >= prm.nyq)) continue;
        const float* a = run + 4 * u;
        float im0 = a[1], im1 = a[3];
        if (prm.nyq >= 0 && bin == 0) {
          const int q = prm.nyq;
          float* ny = reinterpret_cast<float*>(
              pf + (wi * kt_mel + (q >> 3)) * 32 + g * 4 + (q & 3));
          *reinterpret_cast<float2*>(ny + (q & 4 ? 2 : 0)) =
              make_float2(im0 * im0, im1 * im1);
          im0 = im1 = 0.f;
        }
        float* dst = reinterpret_cast<float*>(
            pf + (wi * kt_mel + (jg >> 1)) * 32 + lane);
        *reinterpret_cast<float2*>(dst + 2 * (jg & 1)) =
            make_float2(a[0] * a[0] + im0 * im0, a[2] * a[2] + im1 * im1);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = 0.f;
      FBANK_CLOCK(kDftEpi);
    } else if (!dft && it.j == km - 1) {
      const int b = tile / prm.tiles_t, t0 = (tile % prm.tiles_t) * M;
      const int nf = min(M, prm.T - t0);
      float* out_b = prm.out + (static_cast<long long>(b) * prm.T + t0) *
                                   prm.n_out;
      const int r = wi * 16 + g;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = it.c * kWgMelCols + 32 * wg + 8 * u + 2 * tig;
        const float* a = mel + 4 * u;
        if (r < nf) {
          if (col < prm.n_out) out_b[r * prm.n_out + col] = a[0];
          if (col + 1 < prm.n_out) out_b[r * prm.n_out + col + 1] = a[1];
        }
        if (r + 8 < nf) {
          if (col < prm.n_out) out_b[(r + 8) * prm.n_out + col] = a[2];
          if (col + 1 < prm.n_out) out_b[(r + 8) * prm.n_out + col + 1] = a[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) mel[i] = 0.f;
      FBANK_CLOCK(kMelEpi);
    }
    it.next(prm, kd, km);
    if (it.tile_start()) {
      tile += gridDim.x;
      ++i_tile;
    }
  }
#ifdef TPUASR_FBANK_CLOCKS
  if (threadIdx.x == 0 && g_clock_buf) {
    long long* o = g_clock_buf + kClocks * static_cast<long long>(blockIdx.x);
    for (int i = 0; i < kClocks; ++i) o[i] = clk[i];
  }
#endif
}

int launch(void (*kernel)(Params), const Params& prm, int ctas,
           long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, kThreads, static_cast<size_t>(smem), stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory the kernel lays out for a plan (see the layout
// above); fbank_plan computes the same figure.
extern "C" long long tpuasr_fbank_smem(int M, int hop, int Kp, int nfp,
                                       int stage_k, int stage_cols,
                                       int stages) {
  return smem_bytes(M, hop, Kp, nfp, stage_k, stage_cols, stages);
}

// wav (B, S) -> out (B, T, n_out): frames [t*hop, t*hop + win), t < T.
// window (Kp,) and nyq (the Nyquist bin where the table pairs it with DC,
// else -1) from pack_tables, and the tables of the plan's route: at M = 64
// "dft_wg" (Nd/256, Kp/8, 2, 2, 256, 4) and "mel_wg" (No/64, nfp/8, 2, 2,
// 64, 4), with dft_nt = 32, mel_nt = 8 and stage_k (rDFT k-steps a ring
// stage) 2 or 4; at M = 32 or 16 "dft" (Kp/8, Nd, 4, 4) and "mel" (nfp/8,
// No, 4, 4), stage_k = 2. M, chunks (n-tiles a chunk), stage_k, stages
// and CTAs from fbank_plan, whose shared-memory figure must equal this
// layout's.
extern "C" int tpuasr_fbank_power(const float* wav, const float* window,
                                  const float* dft, const float* mel,
                                  float* out, int B, int S, int T, int hop,
                                  int Kp, int Nd, int nfp, int No, int n_out,
                                  int nyq, int M, int dft_nt, int mel_nt,
                                  int stage_k, int stages, int ctas,
                                  long long smem,
                                  cudaStream_t stream) {
  const bool wgmma = M == 64;
  if ((M != 64 && M != 32 && M != 16) || stages < 2 ||
      stages > kMaxStages || B < 1 || T < 1 || hop < 1 || Kp < 8 ||
      Kp % 8 || nfp < 8 || nfp % 8 || n_out < 1 || n_out > No ||
      nyq < -1 || nyq >= nfp || static_cast<long long>(T - 1) * hop + 1 > S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma ? (dft_nt != kWgCols / 8 || mel_nt != kWgMelCols / 8 ||
               stage_k < 2 || stage_k > kWgStageMax || Nd < kWgCols ||
               Nd % kWgCols || No < kWgMelCols || No % kWgMelCols)
            : (stage_k != kStageK || Nd < 8 || Nd % 8 || No < 8 || No % 8 ||
               nfp < Nd / 2 ||
               (nyq >= 0 && nyq < Nd / 2 - 3) || dft_nt < 1 ||
               dft_nt > 8 * kNtMax || mel_nt < 1 || mel_nt > 8 * kNtMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = static_cast<long long>((T + M - 1) / M) * B;
  if (ctas < 1 || ctas > n_tiles || n_tiles > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage_cols = 8 * (dft_nt > mel_nt ? dft_nt : mel_nt);
  if (smem != tpuasr_fbank_smem(M, hop, Kp, nfp, stage_k, stage_cols,
                                stages) ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.wav = wav;
  prm.window = window;
  prm.dft = dft;
  prm.mel = mel;
  prm.out = out;
  prm.S = S;
  prm.T = T;
  prm.hop = hop;
  prm.Kp = Kp;
  prm.Nd = Nd;
  prm.nfp = nfp;
  prm.No = No;
  prm.n_out = n_out;
  prm.nyq = nyq;
  prm.tiles_t = (T + M - 1) / M;
  prm.n_tiles = static_cast<int>(n_tiles);
  prm.dft_nt = dft_nt;
  prm.dft_chunks = (Nd / 8 + dft_nt - 1) / dft_nt;
  prm.mel_nt = mel_nt;
  prm.mel_chunks = (No / 8 + mel_nt - 1) / mel_nt;
  prm.stage_k = stage_k;
  prm.stage_cols = stage_cols;
  prm.stages = stages;
  prm.vec = hop % 4 == 0 && S % 4 == 0 &&
            reinterpret_cast<uintptr_t>(wav) % 16 == 0;
  if (wgmma) return launch(fbank_wg_kernel, prm, ctas, smem, stream);
  if (M == 32) return launch(fbank_tc_kernel<2, 8>, prm, ctas, smem, stream);
  return launch(fbank_tc_kernel<1, 8>, prm, ctas, smem, stream);
}

#ifdef TPUASR_FBANK_CLOCKS
// Where the next launches write their cycles (8 long longs a CTA).
extern "C" int tpuasr_fbank_clocks(long long* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_clock_buf, &buf, sizeof(buf)));
}
#endif
