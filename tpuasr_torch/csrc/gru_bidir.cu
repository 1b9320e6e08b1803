// Both directions of a bidirectional GRU in one cooperative launch: the
// forward scan (f32 or bf16 streams) and its BPTT (f32).
//
// Replaces two Pallas kernels of tpuasr/ops/pallas_gru.py:
//   K7   _bidir_fwd_kernel (line 319), built by _build_bidir_fwd (pallas_call
//        at line 406): ysf, ysb = gru_scan_bidir(xpf, xpb, whf, whb, mask);
//   K7b  _bidir_bwd_kernel (line 346), built by _build_bidir_bwd (line 437):
//        dxpf, dxpb, dWhf, dWhb from (xpf, xpb, yspf, yspb, whf, whb, mask,
//        dysf, dysb), dWh summed inside the kernel.
// xpb is built by the caller from the per-row reversed input, so both
// recursions run forward in time under the same mask; the gate math and the
// BPTT formulas are K5's and K5b's (csrc/gru_bptt.cu, pallas_gru.py:70-74
// and 117-146), once per direction.
//
// What bounds them on the H100: the operations, as for K5/K5b, twice over.
// Training (T=249, B=16, H=512, f32): the forward 1.25e10 flops, 0.19 ms at
// the 67 TFLOP/s fp32 peak; the backward three times that, 0.56 ms.
// Serving (T=499, B=128, bf16 streams): 2.0e11 flops; the products run on
// the fp32 FMA units here (3.0 ms at 67 TFLOP/s), not on the tensor cores
// (0.20 ms at 989 TFLOP/s).
//
// Design: K5's (see gru_bptt.cu): the hidden units split over a cooperative
// grid, U per block, each block's Wh columns resident in shared memory for
// the whole scan, one grid barrier per step. A block owns its units in BOTH
// directions and keeps both directions' columns (2 x 32 KB at H=512 in
// f32), so the grid (128 blocks at H=512), its residency and its barrier
// count stay K5's while one barrier per step serves both directions: half
// the launches and barriers of two K5 scans.
//   forward: h is carried in f32 in a double-buffered (2 directions, 2,
//   B, H) scratch, written at step s into buffer s & 1 and staged by every
//   block after the barrier (rounded to bf16 for the product when the
//   streams are bf16, as the Pallas kernel casts h to Wh's type); xp is
//   widened to f32 and the gate math is f32; ys is stored in the stream
//   type. Serving streams B=128 rows as 8 staged passes of 16 per step.
//   backward: K5b per direction, one direction after the other inside each
//   pass, sharing one staging buffer: dhp goes to a double-buffered (2
//   directions, 2, 3 gates, B, H) scratch and comes back after the barrier
//   one gate at a time, so the staging buffer stays (16 x H); each
//   direction's dWh columns accumulate in shared memory across all steps
//   and are written once, with no atomics: the same bits on every run.
//   Shared memory at H=512: 134 KB forward, 215-219 KB backward (B=16-64).
#include <type_traits>

#include "gru_coop.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int U, typename IO>
__global__ void __launch_bounds__(kThreads)
gru_bidir_fwd_kernel(const IO* __restrict__ xpf,     // (T, B, 3H)
                     const IO* __restrict__ xpb,     // (T, B, 3H)
                     const IO* __restrict__ whf,     // (H, 3H)
                     const IO* __restrict__ whb,     // (H, 3H)
                     const float* __restrict__ mask, // (T, B)
                     IO* __restrict__ ysf,           // (T, B, H)
                     IO* __restrict__ ysb,           // (T, B, H)
                     float* __restrict__ hbuf,       // (2, 2, B, H) scratch
                     unsigned* __restrict__ bar,     // arrival count, zeroed
                     int T, int B, int H) {
  constexpr bool kBf16 = !std::is_same<IO, float>::value;
  extern __shared__ float4 smem4[];
  float4* wcol = smem4;                                  // [2][U][H]
  float* hs = reinterpret_cast<float*>(wcol + 2 * U * H);  // [2][kR][H]
  float* red = hs + 2 * kR * H;                          // [2][kWarps][kR][3]
  const int H3 = 3 * H;
  const size_t BH = static_cast<size_t>(B) * H;
  const int u0 = blockIdx.x * U;
  load_columns<U>(wcol, whf, H, u0);
  load_columns<U>(wcol + U * H, whb, H, u0);
  const IO* xp[2] = {xpf, xpb};
  IO* ys[2] = {ysf, ysb};
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
            x[d][g] = to_f32(xp[d][row * H3 + g * H + j]);
          if (t) h[d] = __ldcg(hprev[d] + static_cast<size_t>(b) * H + j);
        }
        m = mask[row];
      }
      stage_rows<kBf16>(hs, hprev[0], b0, B, H);
      stage_rows<kBf16>(hs + kR * H, hprev[1], b0, B, H);
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
          store(ys[d] + row * H + j, hv);
        }
      }
      __syncthreads();                          // hs and red are reused
    }
    if (t + 1 < T) grid_sync(bar, t + 1);
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
gru_bidir_bwd_kernel(const float* __restrict__ xpf,   // (T, B, 3H)
                     const float* __restrict__ xpb,
                     const float* __restrict__ yspf,  // (T, B, H)
                     const float* __restrict__ yspb,
                     const float* __restrict__ whf,   // (H, 3H)
                     const float* __restrict__ whb,
                     const float* __restrict__ mask,  // (T, B)
                     const float* __restrict__ dysf,  // (T, B, H)
                     const float* __restrict__ dysb,
                     float* __restrict__ dxpf,        // (T, B, 3H)
                     float* __restrict__ dxpb,
                     float* __restrict__ dwhf,        // (H, 3H)
                     float* __restrict__ dwhb,
                     float* __restrict__ dhp_buf,     // (2, 2, 3, B, H)
                     unsigned* __restrict__ bar,      // arrival count, zeroed
                     int T, int B, int H) {
  extern __shared__ float4 smem4[];
  const int H3 = 3 * H;
  const size_t BH = static_cast<size_t>(B) * H;
  float4* wcol = smem4;                                   // [2][U][H]
  float4* acc = wcol + 2 * U * H;                         // [2][U][H] dWh
  float4* own = acc + 2 * U * H;                          // [2][kR][U] dhp
  float* wrow = reinterpret_cast<float*>(own + 2 * kR * U);  // [2][U][3H]
  float* st = wrow + 2 * U * H3;                          // [kR][H]
  float* red = st + kR * H;                               // [kWarps][kR][3]
  float* dh = red + kWarps * kR * 3;                      // [2][B][U]
  float* zs = dh + 2 * B * U;                             // [2][B][U]
  float* dht = zs + 2 * B * U;                            // [2][B][U]

  const float* xp[2] = {xpf, xpb};
  const float* ysp[2] = {yspf, yspb};
  const float* wh[2] = {whf, whb};
  const float* dys[2] = {dysf, dysb};
  float* dxp[2] = {dxpf, dxpb};
  float* dwh[2] = {dwhf, dwhb};

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  for (int d = 0; d < 2; ++d) {
    load_columns<U>(wcol + d * U * H, wh[d], H, u0);
    for (int i = threadIdx.x; i < U * H3; i += kThreads)
      wrow[d * U * H3 + i] =
          i / H3 < nu ? wh[d][static_cast<size_t>(u0) * H3 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * H * U; i += kThreads)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < 2 * B * U; i += kThreads) dh[i] = 0.f;
  const int gr = threadIdx.x / U;
  const int gu = threadIdx.x % U;
  const int j = u0 + gu;
  const bool gate = threadIdx.x < kR * U;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;                    // BPTT order
    // Recompute the gates from (xp, h_prev), form dhp and dxp, and add
    // h_prev^T dhp to the block's dWh columns, kR rows at a time, one
    // direction after the other.
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && gu < nu && b < B;
      const size_t row = static_cast<size_t>(t) * B + b;
      for (int d = 0; d < 2; ++d) {
        float* buf = dhp_buf + (d * 2 + (s & 1)) * 3 * BH;
        float* dhd = dh + d * B * U;
        float4* ownd = own + d * kR * U;
        float xr = 0.f, xz = 0.f, xn = 0.f, m = 0.f, dd = 0.f;
        if (live) {
          xr = xp[d][row * H3 + j];
          xz = xp[d][row * H3 + H + j];
          xn = xp[d][row * H3 + 2 * H + j];
          m = mask[row];
          dd = dys[d][row * H + j] + dhd[b * U + gu];
        }
        stage_rows(st, ysp[d] + static_cast<size_t>(t) * BH, b0, B, H);
        __syncthreads();
        rows_times_columns<U>(st, wcol + d * U * H, red, H);
        __syncthreads();
        if (gate) {
          float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live) {
            const float an = unit_sum<U>(red, gu, gr, 2, 3);
            const float rg = sigmoid(xr + unit_sum<U>(red, gu, gr, 0, 3));
            const float zg = sigmoid(xz + unit_sum<U>(red, gu, gr, 1, 3));
            const float ng = tanhf(xn + rg * an);
            const float h_prev = st[gr * H + j];
            const float dz = dd * (h_prev - ng);
            const float dn = dd * (1.f - zg) * (1.f - ng * ng);
            const float dxr = dn * an * rg * (1.f - rg);
            const float dxz = dz * zg * (1.f - zg);
            float* dx = dxp[d] + row * H3;
            dx[j] = dxr * m;
            dx[H + j] = dxz * m;
            dx[2 * H + j] = dn * m;
            g = make_float4(dxr * m, dxz * m, dn * rg * m, 0.f);
            const size_t o = static_cast<size_t>(b) * H + j;
            buf[o] = g.x;
            buf[BH + o] = g.y;
            buf[2 * BH + o] = g.z;
            zs[d * B * U + b * U + gu] = zg;
            dht[d * B * U + b * U + gu] = dd;
          }
          ownd[gr * U + gu] = g;
        }
        __syncthreads();
        float4* accd = acc + d * U * H;
        for (int k = threadIdx.x; k < H; k += kThreads) {
          float4 a[U];
#pragma unroll
          for (int u = 0; u < U; ++u) a[u] = accd[u * H + k];
#pragma unroll 4
          for (int r = 0; r < kR; ++r) {
            const float h = st[r * H + k];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const float4 o = ownd[r * U + u];
              a[u].x = fmaf(h, o.x, a[u].x);
              a[u].y = fmaf(h, o.y, a[u].y);
              a[u].z = fmaf(h, o.z, a[u].z);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) accd[u * H + k] = a[u];
        }
        __syncthreads();                        // st, red, own are reused
      }
    }
    if (s + 1 == T) break;
    grid_sync(bar, s + 1);                      // every block's dhp is out
    // dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot for the block's units:
    // warp w takes unit w % U and a slice of each gate's H columns; the
    // three gates' columns are staged one after the other.
    constexpr int kP = kWarps / U;
    const int u = warp % U;
    const int span = (H + kP - 1) / kP;
    const int c0 = (warp / U) * span;
    const int c1 = min(H, c0 + span);
    for (int d = 0; d < 2; ++d) {
      const float* buf = dhp_buf + (d * 2 + (s & 1)) * 3 * BH;
      const float* wr = wrow + d * U * H3 + u * H3;
      for (int b0 = 0; b0 < B; b0 += kR) {
        float v[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) v[r] = 0.f;
        for (int g = 0; g < 3; ++g) {
          stage_rows(st, buf + g * BH, b0, B, H);
          __syncthreads();
          for (int c = c0 + lane; c < c1; c += 32) {
            const float w = wr[g * H + c];
#pragma unroll
            for (int r = 0; r < kR; ++r) v[r] = fmaf(st[r * H + c], w, v[r]);
          }
          __syncthreads();
        }
        reduce_scatter<kR, 1, 16>(v, lane);
        if ((lane & 1) == 0) red[warp * kR + (lane >> 1)] = v[0];
        __syncthreads();
        const int b = b0 + gr;
        if (gate && gu < nu && b < B) {
          const int i = d * B * U + b * U + gu;
          const float m = mask[static_cast<size_t>(t) * B + b];
          const float a = unit_sum<U>(red, gu, gr, 0, 1);
          dh[i] = m * (dht[i] * zs[i] + a) + (1.f - m) * dht[i];
        }
        __syncthreads();
      }
    }
  }

  for (int d = 0; d < 2; ++d) {
    for (int i = threadIdx.x; i < H * U; i += kThreads) {
      const int u = i / H;
      const int k = i - u * H;
      if (u >= nu) continue;
      const float4 a = acc[d * U * H + i];
      float* w = dwh[d] + static_cast<size_t>(k) * H3 + u0 + u;
      w[0] = a.x;
      w[H] = a.y;
      w[2 * H] = a.z;
    }
  }
}

size_t fwd_smem(int H, int U) {
  return 2 * (sizeof(float4) * U * H + sizeof(float) * kR * H +
              sizeof(float) * kWarps * kR * 3);
}

size_t bwd_smem(int B, int H, int U) {
  const size_t H3 = 3 * static_cast<size_t>(H);
  return 2 * (2 * sizeof(float4) * U * H + sizeof(float4) * kR * U +
              sizeof(float) * U * H3 + 3 * sizeof(float) * B * U) +
         sizeof(float) * kR * H + sizeof(float) * kWarps * kR * 3;
}

template <int U, typename IO>
int fwd(const void* xpf_, const void* xpb_, const void* whf_,
        const void* whb_, const float* mask, void* ysf_, void* ysb_,
        float* hbuf, unsigned* bar, int T, int B, int H,
        cudaStream_t stream) {
  const IO* xpf = static_cast<const IO*>(xpf_);
  const IO* xpb = static_cast<const IO*>(xpb_);
  const IO* whf = static_cast<const IO*>(whf_);
  const IO* whb = static_cast<const IO*>(whb_);
  IO* ysf = static_cast<IO*>(ysf_);
  IO* ysb = static_cast<IO*>(ysb_);
  void* args[] = {&xpf, &xpb, &whf, &whb, &mask, &ysf, &ysb, &hbuf,
                  &bar, &T,   &B,   &H};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_fwd_kernel<U, IO>),
      (H + U - 1) / U, fwd_smem(H, U), args, stream);
}

template <int U>
int bwd(const float* xpf, const float* xpb, const float* yspf,
        const float* yspb, const float* whf, const float* whb,
        const float* mask, const float* dysf, const float* dysb, float* dxpf,
        float* dxpb, float* dwhf, float* dwhb, float* dhp_buf, unsigned* bar,
        int T, int B, int H, cudaStream_t stream) {
  void* args[] = {&xpf,  &xpb,  &yspf, &yspb, &whf,     &whb,
                  &mask, &dysf, &dysb, &dxpf, &dxpb,    &dwhf,
                  &dwhb, &dhp_buf, &bar, &T,  &B,       &H};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_bwd_kernel<U>),
      (H + U - 1) / U, bwd_smem(B, H, U), args, stream);
}

}  // namespace

// K7: ysf, ysb (T, B, H) from xpf, xpb (T, B, 3H), whf, whb (H, 3H) -- all
// f32 (bf16 == 0) or all bf16 -- and mask (T, B) f32, contiguous. hbuf:
// (2, 2, B, H) f32 scratch; bar: one zeroed uint32 word of device memory.
extern "C" int tpuasr_gru_bidir_fwd(int bf16, const void* xpf,
                                    const void* xpb, const void* whf,
                                    const void* whb, const float* mask,
                                    void* ysf, void* ysb, float* hbuf,
                                    unsigned* bar, int T, int B, int H,
                                    cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_FWD(N)                                                          \
  (bf16 ? fwd<N, __nv_bfloat16>(xpf, xpb, whf, whb, mask, ysf, ysb, hbuf,     \
                                bar, T, B, H, stream)                          \
        : fwd<N, float>(xpf, xpb, whf, whb, mask, ysf, ysb, hbuf, bar, T, B,  \
                        H, stream))
  TPUASR_BY_UNITS(TPUASR_FWD)
#undef TPUASR_FWD
}

// K7b: dxpf, dxpb (T, B, 3H) and dwhf, dwhb (H, 3H) from xpf, xpb, yspf,
// yspb (T, B, H: the states before each step), whf, whb, mask (T, B) and
// dysf, dysb (T, B, H), all f32 and contiguous. dhp_buf: (2, 2, 3, B, H)
// f32 scratch; bar: one zeroed uint32 word.
extern "C" int tpuasr_gru_bidir_bwd(
    const float* xpf, const float* xpb, const float* yspf, const float* yspb,
    const float* whf, const float* whb, const float* mask, const float* dysf,
    const float* dysb, float* dxpf, float* dxpb, float* dwhf, float* dwhb,
    float* dhp_buf, unsigned* bar, int T, int B, int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_BWD(N)                                                          \
  bwd<N>(xpf, xpb, yspf, yspb, whf, whb, mask, dysf, dysb, dxpf, dxpb, dwhf,   \
         dwhb, dhp_buf, bar, T, B, H, stream)
  TPUASR_BY_UNITS(TPUASR_BWD)
#undef TPUASR_BWD
}

#undef TPUASR_BY_UNITS
