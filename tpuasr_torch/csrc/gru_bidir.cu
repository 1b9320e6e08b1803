// Both directions of a bidirectional GRU in one cooperative launch: the
// forward scan in f32 (training). The bf16 forward (serving) is K2's
// tensor-core recurrence over both directions (csrc/gru_scan.cu,
// tpuasr_gru_rec); the f32 backward, K7b, is csrc/gru_lean.cu's lean
// recurrence over both directions with its products before and after.
//
// Replaces, for f32 streams, K7 of tpuasr/ops/pallas_gru.py:
// _bidir_fwd_kernel (line 319), built by _build_bidir_fwd (pallas_call at
// line 406): ysf, ysb = gru_scan_bidir(xpf, xpb, whf, whb, mask). xpb is
// built by the caller from the per-row reversed input, so both recursions
// run forward in time under the same mask; the gate math is K5's
// (csrc/gru_bptt.cu, pallas_gru.py:70-74), once per direction.
//
// What bounds it on the H100: the operations, as for K5, twice over.
// Training (T=249, B=16, H=512, f32): 1.25e10 flops, 0.19 ms at the
// 67 TFLOP/s fp32 peak.
//
// Design: K5's (see gru_bptt.cu): the hidden units split over a cooperative
// grid, U per block, each block's Wh columns resident in shared memory for
// the whole scan, one grid barrier per step. A block owns its units in BOTH
// directions and keeps both directions' columns (2 x 32 KB at H=512 in
// f32), so the grid (128 blocks at H=512), its residency and its barrier
// count stay K5's while one barrier per step serves both directions: half
// the launches and barriers of two K5 scans. h is carried in a
// double-buffered (2 directions, 2, B, H) scratch, written at step s into
// buffer s & 1 and staged by every block after the barrier, 16 rows a
// pass. Shared memory at H=512: 134 KB.
#include "gru_coop.cuh"

namespace {

template <int U>
__global__ void __launch_bounds__(kThreads)
gru_bidir_fwd_kernel(const float* __restrict__ xpf,  // (T, B, 3H)
                     const float* __restrict__ xpb,  // (T, B, 3H)
                     const float* __restrict__ whf,  // (H, 3H)
                     const float* __restrict__ whb,  // (H, 3H)
                     const float* __restrict__ mask, // (T, B)
                     float* __restrict__ ysf,        // (T, B, H)
                     float* __restrict__ ysb,        // (T, B, H)
                     float* __restrict__ hbuf,       // (2, 2, B, H) scratch
                     unsigned* __restrict__ bar,     // arrival count, zeroed
                     int T, int B, int H) {
  extern __shared__ float4 smem4[];
  float4* wcol = smem4;                                  // [2][U][H]
  float* hs = reinterpret_cast<float*>(wcol + 2 * U * H);  // [2][kR][H]
  float* red = hs + 2 * kR * H;                          // [2][kWarps][kR][3]
  const int H3 = 3 * H;
  const size_t BH = static_cast<size_t>(B) * H;
  const int u0 = blockIdx.x * U;
  load_columns<U>(wcol, whf, H, u0);
  load_columns<U>(wcol + U * H, whb, H, u0);
  const float* xp[2] = {xpf, xpb};
  float* ys[2] = {ysf, ysb};
  // Gate threads: one per (row, unit) of a pass, for both directions.
  const int gr = threadIdx.x / U;
  const int gu = threadIdx.x % U;
  const int j = u0 + gu;
  const bool gate = threadIdx.x < kR * U && j < H;

  for (int t = 0; t < T; ++t) {
    const float* hprev[2] = {
        t ? hbuf + ((t - 1) & 1) * BH : nullptr,
        t ? hbuf + (2 + ((t - 1) & 1)) * BH : nullptr};
    float* hnext[2] = {hbuf + (t & 1) * BH, hbuf + (2 + (t & 1)) * BH};
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && b < B;
      const size_t row = static_cast<size_t>(t) * B + b;
      float x[2][3], h[2] = {0.f, 0.f}, m = 0.f;
      if (live) {                               // loaded before the product
#pragma unroll
        for (int d = 0; d < 2; ++d) {
#pragma unroll
          for (int g = 0; g < 3; ++g)
            x[d][g] = xp[d][row * H3 + g * H + j];
          if (t) h[d] = __ldcg(hprev[d] + static_cast<size_t>(b) * H + j);
        }
        m = mask[row];
      }
      stage_rows(hs, hprev[0], b0, B, H);
      stage_rows(hs + kR * H, hprev[1], b0, B, H);
      __syncthreads();
      rows_times_columns<U>(hs, wcol, red, H);
      rows_times_columns<U>(hs + kR * H, wcol + U * H, red + kWarps * kR * 3,
                            H);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const float* rd = red + d * kWarps * kR * 3;
          const float rg = sigmoid(x[d][0] + unit_sum<U>(rd, gu, gr, 0, 3));
          const float zg = sigmoid(x[d][1] + unit_sum<U>(rd, gu, gr, 1, 3));
          const float ng =
              tanhf(x[d][2] + rg * unit_sum<U>(rd, gu, gr, 2, 3));
          const float hn = (1.f - zg) * ng + zg * h[d];
          const float hv = m * hn + (1.f - m) * h[d];
          hnext[d][static_cast<size_t>(b) * H + j] = hv;
          ys[d][row * H + j] = hv;
        }
      }
      __syncthreads();                          // hs and red are reused
    }
    if (t + 1 < T) grid_sync(bar, t + 1);
  }
}

size_t fwd_smem(int H, int U) {
  return 2 * (sizeof(float4) * U * H + sizeof(float) * kR * H +
              sizeof(float) * kWarps * kR * 3);
}

template <int U>
int fwd(const float* xpf, const float* xpb, const float* whf,
        const float* whb, const float* mask, float* ysf, float* ysb,
        float* hbuf, unsigned* bar, int T, int B, int H,
        cudaStream_t stream) {
  void* args[] = {&xpf, &xpb, &whf, &whb, &mask, &ysf, &ysb, &hbuf,
                  &bar, &T,   &B,   &H};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_fwd_kernel<U>),
      (H + U - 1) / U, fwd_smem(H, U), args, stream);
}

}  // namespace

// K7 in f32: ysf, ysb (T, B, H) from xpf, xpb (T, B, 3H), whf, whb (H, 3H)
// and mask (T, B), all f32 and contiguous. hbuf: (2, 2, B, H) f32 scratch;
// bar: one zeroed uint32 word of device memory.
extern "C" int tpuasr_gru_bidir_fwd(const float* xpf, const float* xpb,
                                    const float* whf, const float* whb,
                                    const float* mask, float* ysf, float* ysb,
                                    float* hbuf, unsigned* bar, int T, int B,
                                    int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_FWD(N) \
  fwd<N>(xpf, xpb, whf, whb, mask, ysf, ysb, hbuf, bar, T, B, H, stream)
  TPUASR_BY_UNITS(TPUASR_FWD)
#undef TPUASR_FWD
}

#undef TPUASR_BY_UNITS
