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
// (csrc/gru_lean.cu runs the same backward for K2b and K7b with hp taken
// out of the step; K5b keeps it in.)
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
// index (32 KB at H=512). Each step then needs the whole previous state of
// every batch row, which other blocks wrote, so the kernel is a cooperative
// launch (all blocks resident) with one grid barrier per step, written here
// as one arrival counter in device memory that never resets. A step stages
// 16 batch rows at a time into shared memory with L1-bypassing loads (__ldcg:
// another block's writes must be seen after the barrier). Each warp owns
// one unit and a slice of the contraction, each lane every 32nd index of
// it, and a lane keeps the sums of all 16 rows in registers, so one weight
// load feeds 16 (or 48) FMAs; the warp then reduces its 32 lanes with a
// reduce-scatter of shuffles (each halving step sends half the values),
// and the warps of a unit add up in shared memory.
//   forward: the state lives in ys itself (ys[t_prev] is h), so nothing
//   else crosses blocks. Its kernel is in gru_coop.cuh: K2's float32
//   recurrence (csrc/gru_scan.cu) launches it too.
//   backward: each step recomputes hp = h_prev Wh for the block's units
//   (K5's product on the staged ysp rows), forms dxp and dhp, and writes
//   both for every step into (T, B, 3H) tensors; after the barrier each
//   block stages the rows of dhp[t] and forms
//   dhp Wh^T for its own units, reading Wh's rows of its units through the
//   read-only cache (they are not kept in shared memory, so a block needs
//   little beyond the forward's: the width reaches the forward's limit,
//   H <= 1056 on 132 SMs; all three gates of dhp are staged at once where
//   they fit, up to H=694, one at a time beyond). The carried dh of a
//   (row, unit) lives in a (B, H) buffer in device memory that only the
//   thread owning that (row, unit) reads and writes, so a launch takes
//   any batch. dWh is not
//   summed inside the kernel: ops/gru.py::gru_scan_bwd gets it from
//   dWh = ysp^T dhp over all T*B rows, csrc/gru_lean.cu's fixed-order
//   product (no atomics, the same bits on every call).
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
               float* __restrict__ dhp,          // (T, B, 3H)
               float* __restrict__ dh,           // (B, H), zeroed
               unsigned* __restrict__ bar,       // arrival count, zeroed
               int T, int B, int H, int reverse, int G) {
  extern __shared__ float4 smem4[];
  const int H3 = 3 * H;
  float4* wcol = smem4;                                     // [U][H]
  float* st = reinterpret_cast<float*>(wcol + U * H);       // [kR][G * H]
  float* red = st + kR * G * H;                             // [kWarps][kR][3]

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  load_columns<U>(wcol, wh, H, u0);
  // Gate threads: one per (row, unit) of a pass; the same thread owns the
  // (row, unit)'s carried dh in every pass.
  const int gr = threadIdx.x / U;
  const int gu = threadIdx.x % U;
  const int j = u0 + gu;
  const bool gate = threadIdx.x < kR * U && gu < nu;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;      // BPTT order
    const size_t tb = static_cast<size_t>(t) * B;
    // Recompute the gates from (xp, h_prev), form dxp and dhp, and keep
    // c = m dh_tot z + (1 - m) dh_tot as the row's dh until dhp Wh^T comes.
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && b < B;
      float xr = 0.f, xz = 0.f, xn = 0.f, m = 0.f, d = 0.f;
      if (live) {
        const size_t row = tb + b;
        xr = xp[row * H3 + j];
        xz = xp[row * H3 + H + j];
        xn = xp[row * H3 + 2 * H + j];
        m = mask[row];
        d = dys[row * H + j] + dh[static_cast<size_t>(b) * H + j];
      }
      stage_rows(st, ysp + tb * H, b0, B, H);
      __syncthreads();
      rows_times_columns<U>(st, wcol, red, H);
      __syncthreads();
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
        const size_t o = (tb + b) * H3;
        dxp[o + j] = dxr * m;
        dxp[o + H + j] = dxz * m;
        dxp[o + 2 * H + j] = dn * m;
        dhp[o + j] = dxr * m;
        dhp[o + H + j] = dxz * m;
        dhp[o + 2 * H + j] = dn * rg * m;
        dh[static_cast<size_t>(b) * H + j] = m * (d * zg) + (1.f - m) * d;
      }
      __syncthreads();                          // st and red are reused
    }
    if (s + 1 == T) break;
    grid_sync(bar, s + 1);                      // every block's dhp is out
    // dh += m dhp Wh^T for the block's units: warp w takes unit w % U and
    // a slice of each gate's H columns; G of the three gates are staged at
    // once (the sums run in the same order whatever G is).
    const float* src = dhp + tb * H3;
    constexpr int kP = kWarps / U;
    const int u = warp % U;
    const int span = (H + kP - 1) / kP;
    const int c0 = (warp / U) * span;
    const int c1 = min(H, c0 + span);
    const int GH = G * H;
    for (int b0 = 0; b0 < B; b0 += kR) {
      float v[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) v[r] = 0.f;
      for (int g0 = 0; g0 < 3; g0 += G) {
        stage_cols(st, src, H3, g0 * H, GH, b0, B);
        __syncthreads();
        for (int g = 0; g < G && u < nu; ++g) {
          const float* w =
              wh + static_cast<size_t>(u0 + u) * H3 + (g0 + g) * H;
          const float* sg = st + g * H;
          for (int c = c0 + lane; c < c1; c += 32) {
            const float wv = __ldg(w + c);
#pragma unroll
            for (int r = 0; r < kR; ++r) v[r] = fmaf(sg[r * GH + c], wv, v[r]);
          }
        }
        __syncthreads();                        // st is restaged
      }
      reduce_scatter<kR, 1, 16>(v, lane);
      if ((lane & 1) == 0) red[warp * kR + (lane >> 1)] = v[0];
      __syncthreads();
      const int b = b0 + gr;
      if (gate && b < B) {
        const float m = mask[tb + b];
        dh[static_cast<size_t>(b) * H + j] +=
            m * unit_sum<U>(red, gu, gr, 0, 1);
      }
      __syncthreads();                          // red is reused
    }
  }
}

// K5b's shared memory: K5's layout with the staging rows G * H wide.
size_t bwd_smem_bytes(int H, int U, int G) {
  return sizeof(float4) * U * H + sizeof(float) * kR * G * H +
         sizeof(float) * kWarps * kR * 3;
}

// Gates of dhp K5b stages at once: all three where they fit the budget,
// else one (H > 694 at 8 units a block).
int bwd_gates(int H, int U) {
  return bwd_smem_bytes(H, U, 3) <= kSmemBudget ? 3 : 1;
}

template <int U>
int bwd(const float* xp, const float* ysp, const float* wh, const float* mask,
        const float* dys, float* dxp, float* dhp, float* dh, unsigned* bar,
        int T, int B, int H, int reverse, cudaStream_t stream) {
  int G = bwd_gates(H, U);
  void* args[] = {&xp,  &ysp, &wh, &mask, &dys, &dxp, &dhp,     &dh,
                  &bar, &T,   &B,  &H,    &reverse, &G};
  return launch_cooperative(reinterpret_cast<const void*>(gru_bwd_kernel<U>),
                            (H + U - 1) / U, bwd_smem_bytes(H, U, G), args,
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

// K5b's dynamic shared memory a block at width H on this card
// (ops/gru.py::_k5b_plan computes the same).
extern "C" long long tpuasr_gru_bwd_smem(int H) {
  int nsm = 0;
  if (sm_count(&nsm)) return -1;
  const int U = units_per_block(H, nsm);
  return static_cast<long long>(bwd_smem_bytes(H, U, bwd_gates(H, U)));
}

// K5b's recurrence: dxp and dhp (T, B, 3H) from xp, ysp (T, B, H), wh,
// mask and dys (T, B, H), all f32 and contiguous (dWh = ysp^T dhp comes
// after, from tpuasr_gemm_tn). dh: (B, H) f32, zeroed; bar: one zeroed
// uint32 word.
extern "C" int tpuasr_gru_bwd(const float* xp, const float* ysp,
                              const float* wh, const float* mask,
                              const float* dys, float* dxp, float* dhp,
                              float* dh, unsigned* bar, int T, int B, int H,
                              int reverse, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_BWD(N)                                                          \
  bwd<N>(xp, ysp, wh, mask, dys, dxp, dhp, dh, bar, T, B, H, reverse, stream)
  TPUASR_BY_UNITS(TPUASR_BWD)
#undef TPUASR_BWD
}

#undef TPUASR_BY_UNITS
