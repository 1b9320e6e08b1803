// GRU scan over precomputed input projections (forward) and its BPTT
// (backward), float32.
//
// Replaces two Pallas kernels of tpuasr/ops/pallas_gru.py:
//   K5   _fwd_kernel, built by _build_fwd (pallas_call at line 163): the
//        masked GRU recurrence ys = gru_scan(xp, wh, mask, reverse);
//   K5b  _bwd_kernel, built by _build_bwd (line 190): its BPTT, dxp and dWh
//        from (xp, ysp, wh, mask, dys), with ysp the forward's ys shifted one
//        step in scan order (h_{t-1}, or h_{t+1} for a reversed scan).
//
// Gate math (pallas_gru.py:70-74, gate order r, z, n, bias on the input
// side only): r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z),
// n = tanh(xp_n + r * hp_n), h' = (1 - z) n + z h, h = m h' + (1 - m) h with
// hp = h @ Wh. The backward (pallas_gru.py:117-146), per step in BPTT order:
//   dh_tot = dys + dh, dz = dh_tot (h_prev - n), dn = dh_tot (1 - z)(1 - n^2),
//   dxr = dn hp_n r (1 - r), dxz = dz z (1 - z),
//   dhp = m [dxr, dxz, dn r], dxp = m [dxr, dxz, dn],
//   dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot, dWh += h_prev^T dhp.
//
// What bounds them on the H100: the operations. At DeepSpeech's training
// shapes (T=249, B=16, H=512) the forward does one (16 x 512) @ (512 x 1536)
// product per step, 3.1 G MAC per launch (94 us at the 67 TFLOP/s fp32 FMA
// peak), and the backward three such products per step (hp, dhp Wh^T and
// h_prev^T dhp), 9.4 G MAC (280 us); both move only 36-72 MB. But the steps
// are sequential and each is a small product, so what a design can reach is
// set by how many SMs share one step and what each SM must load per step.
//
// Design: the hidden units are split across the grid, U units per block
// (U = ceil(H / SMs) rounded up to a power of two: 4 at H=512, so 128
// blocks), and each block keeps the weights of its units in shared memory
// for the whole scan -- the Hopper counterpart of "Wh resident in VMEM":
// the columns (u, H+u, 2H+u) as one [r, z, n, 0] vector per contraction
// index (32 KB at H=512), and in the backward also the rows Wh[u, :] for
// dhp Wh^T. Each step then needs the whole previous state of every batch
// row, which other blocks wrote, so the kernel is a cooperative launch (all
// blocks resident) with one grid barrier per step, written here as one
// arrival counter in device memory that never resets. A step stages 16 batch
// rows at a time into shared memory with L1-bypassing loads (__ldcg:
// another block's writes must be seen after the barrier). Each warp owns
// one unit and a slice of the contraction, each lane every 32nd index of
// it, and a lane keeps the sums of all 16 rows in registers, so one weight
// load feeds 16 (or 48) FMAs; the warp then reduces its 32 lanes with a
// reduce-scatter of shuffles (each halving step sends half the values),
// and the warps of a unit add up in shared memory.
//   forward: the state lives in ys itself (ys[t_prev] is h), so nothing
//   else crosses blocks. Its kernel is in gru_coop.cuh: K2's float32
//   recurrence (csrc/gru_scan.cu) launches it too.
//   backward: dhp of a step is written to a double-buffered (2, B, 3H)
//   scratch; after the barrier each block stages it back and forms
//   dhp Wh^T for its own units. dWh's columns of the block's units
//   accumulate in shared memory across all steps -- inside this kernel, as
//   the TPU kernel accumulates it in VMEM scratch -- and are written once at
//   the end; no two blocks own the same column, so no second pass or atomics.
#include "gru_coop.cuh"

namespace {

template <int U>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ xp,     // (T, B, 3H)
               const float* __restrict__ ysp,    // (T, B, H)
               const float* __restrict__ wh,     // (H, 3H)
               const float* __restrict__ mask,   // (T, B)
               const float* __restrict__ dys,    // (T, B, H)
               float* __restrict__ dxp,          // (T, B, 3H)
               float* __restrict__ dwh,          // (H, 3H)
               float* __restrict__ dhp_buf,      // (2, B, 3H) scratch
               unsigned* __restrict__ bar,       // arrival count, zeroed
               int T, int B, int H, int reverse) {
  extern __shared__ float4 smem4[];
  const int H3 = 3 * H;
  float4* wcol = smem4;                                     // [U][H]
  float4* acc = wcol + U * H;                               // [U][H] dWh
  float4* own = acc + U * H;                                // [kR][U] dhp
  float* wrow = reinterpret_cast<float*>(own + kR * U);     // [U][3H]
  float* st = wrow + U * H3;                                // [kR][3H]
  float* red = st + kR * H3;                                // [kWarps][kR][3]
  float* dh = red + kWarps * kR * 3;                        // [B][U]
  float* zs = dh + B * U;                                   // [B][U]
  float* dht = zs + B * U;                                  // [B][U]

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  load_columns<U>(wcol, wh, H, u0);
  for (int i = threadIdx.x; i < U * H3; i += kThreads)
    wrow[i] = i / H3 < nu ? wh[static_cast<size_t>(u0) * H3 + i] : 0.f;
  for (int i = threadIdx.x; i < H * U; i += kThreads)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < B * U; i += kThreads) dh[i] = 0.f;
  const int gr = threadIdx.x / U;
  const int gu = threadIdx.x % U;
  const int j = u0 + gu;
  const bool gate = threadIdx.x < kR * U;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;      // BPTT order
    float* buf = dhp_buf + static_cast<size_t>(s & 1) * B * H3;
    // Recompute the gates from (xp, h_prev), form dhp and dxp, and add
    // h_prev^T dhp to the block's dWh columns, kR rows at a time.
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && gu < nu && b < B;
      float xr = 0.f, xz = 0.f, xn = 0.f, m = 0.f, d = 0.f;
      if (live) {
        const size_t row = static_cast<size_t>(t) * B + b;
        xr = xp[row * H3 + j];
        xz = xp[row * H3 + H + j];
        xn = xp[row * H3 + 2 * H + j];
        m = mask[row];
        d = dys[row * H + j] + dh[b * U + gu];
      }
      stage_rows(st, ysp + static_cast<size_t>(t) * B * H, b0, B, H);
      __syncthreads();
      rows_times_columns<U>(st, wcol, red, H);
      __syncthreads();
      if (gate) {
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
          const float an = unit_sum<U>(red, gu, gr, 2, 3);
          const float rg = sigmoid(xr + unit_sum<U>(red, gu, gr, 0, 3));
          const float zg = sigmoid(xz + unit_sum<U>(red, gu, gr, 1, 3));
          const float ng = tanhf(xn + rg * an);
          const float h_prev = st[gr * H + j];
          const float dz = d * (h_prev - ng);
          const float dn = d * (1.f - zg) * (1.f - ng * ng);
          const float dxr = dn * an * rg * (1.f - rg);
          const float dxz = dz * zg * (1.f - zg);
          float* dx = dxp + (static_cast<size_t>(t) * B + b) * H3;
          dx[j] = dxr * m;
          dx[H + j] = dxz * m;
          dx[2 * H + j] = dn * m;
          g = make_float4(dxr * m, dxz * m, dn * rg * m, 0.f);
          float* o = buf + static_cast<size_t>(b) * H3;
          o[j] = g.x;
          o[H + j] = g.y;
          o[2 * H + j] = g.z;
          zs[b * U + gu] = zg;
          dht[b * U + gu] = d;
        }
        own[gr * U + gu] = g;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < H; k += kThreads) {
        float4 a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) a[u] = acc[u * H + k];
#pragma unroll 4
        for (int r = 0; r < kR; ++r) {
          const float h = st[r * H + k];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float4 o = own[r * U + u];
            a[u].x = fmaf(h, o.x, a[u].x);
            a[u].y = fmaf(h, o.y, a[u].y);
            a[u].z = fmaf(h, o.z, a[u].z);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u * H + k] = a[u];
      }
      __syncthreads();                          // st, red, own are reused
    }
    if (s + 1 == T) break;
    grid_sync(bar, s + 1);                      // every block's dhp is out
    // dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot for the block's units:
    // warp w takes unit w % U and a slice of the 3H columns.
    for (int b0 = 0; b0 < B; b0 += kR) {
      stage_rows(st, buf, b0, B, H3);
      __syncthreads();
      {
        constexpr int kP = kWarps / U;
        const int u = warp % U;
        const int span = (H3 + kP - 1) / kP;
        const int c0 = (warp / U) * span;
        const int c1 = min(H3, c0 + span);
        float v[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) v[r] = 0.f;
        for (int c = c0 + lane; c < c1; c += 32) {
          const float w = wrow[u * H3 + c];
#pragma unroll
          for (int r = 0; r < kR; ++r) v[r] = fmaf(st[r * H3 + c], w, v[r]);
        }
        reduce_scatter<kR, 1, 16>(v, lane);
        if ((lane & 1) == 0) red[warp * kR + (lane >> 1)] = v[0];
      }
      __syncthreads();
      const int b = b0 + gr;
      if (gate && gu < nu && b < B) {
        const float m = mask[static_cast<size_t>(t) * B + b];
        const float d = dht[b * U + gu];
        const float a = unit_sum<U>(red, gu, gr, 0, 1);
        dh[b * U + gu] = m * (d * zs[b * U + gu] + a) + (1.f - m) * d;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < H * U; i += kThreads) {
    const int u = i / H;
    const int k = i - u * H;
    if (u >= nu) continue;
    const float4 a = acc[i];
    float* w = dwh + static_cast<size_t>(k) * H3 + u0 + u;
    w[0] = a.x;
    w[H] = a.y;
    w[2 * H] = a.z;
  }
}

size_t bwd_smem_bytes(int B, int H, int U) {
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t red = sizeof(float) * kWarps * kR * 3;
  return 2 * sizeof(float4) * U * H + sizeof(float4) * kR * U +
         sizeof(float) * U * H3 + sizeof(float) * kR * H3 + red +
         3 * sizeof(float) * B * U;
}

template <int U>
int bwd(const float* xp, const float* ysp, const float* wh, const float* mask,
        const float* dys, float* dxp, float* dwh, float* dhp_buf,
        unsigned* bar, int T, int B, int H, int reverse,
        cudaStream_t stream) {
  void* args[] = {&xp,  &ysp, &wh, &mask, &dys, &dxp, &dwh, &dhp_buf,
                  &bar, &T,   &B,  &H,    &reverse};
  return launch_cooperative(reinterpret_cast<const void*>(gru_bwd_kernel<U>),
                            (H + U - 1) / U, bwd_smem_bytes(B, H, U), args,
                            stream);
}

}  // namespace

// K5: ys (T, B, H) from xp (T, B, 3H), wh (H, 3H), mask (T, B), all f32 and
// contiguous. bar: one zeroed uint32 word of device memory.
extern "C" int tpuasr_gru_fwd(const float* xp, const float* wh,
                              const float* mask, float* ys, unsigned* bar,
                              int T, int B, int H, int reverse,
                              cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_FWD(N)                                                          \
  launch_fwd<N>(xp, wh, mask, ys, bar, T, B, H, reverse, stream)
  TPUASR_BY_UNITS(TPUASR_FWD)
#undef TPUASR_FWD
}

// K5b: dxp (T, B, 3H) and dwh (H, 3H) from xp, ysp (T, B, H), wh, mask and
// dys (T, B, H), all f32 and contiguous. dhp_buf: (2, B, 3H) f32 scratch;
// bar: one zeroed uint32 word.
extern "C" int tpuasr_gru_bwd(const float* xp, const float* ysp,
                              const float* wh, const float* mask,
                              const float* dys, float* dxp, float* dwh,
                              float* dhp_buf, unsigned* bar, int T, int B,
                              int H, int reverse, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_BWD(N)                                                          \
  bwd<N>(xp, ysp, wh, mask, dys, dxp, dwh, dhp_buf, bar, T, B, H, reverse,     \
         stream)
  TPUASR_BY_UNITS(TPUASR_BWD)
#undef TPUASR_BWD
}

#undef TPUASR_BY_UNITS
