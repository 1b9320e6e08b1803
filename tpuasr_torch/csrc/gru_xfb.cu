// Fully fused BPTT of the projection-fused GRU scan, float32.
//
// Replaces K2b of tpuasr/ops/pallas_gru.py: _bwd_xf_kernel (line 661),
// built by _build_bwd_xf (pallas_call at line 736) and reached through
// _xf_bwd -> _xf_bwd_fused (lines 829-838) wherever wx, dwx, wh and dwh
// fit JAX's 11 MiB budget. From the saved inputs x (T, B, D), ysp (T, B, H)
// (the forward's ys shifted one step in scan order), wx (D, 3H), b (3H),
// wh (H, 3H), mask (T, B) and dys (T, B, H) it gives dx (T, B, D) and, summed
// over time, dwx (D, 3H), db (3H) and dwh (H, 3H). Neither xp = x Wx + b nor
// dxp, the (T, B, 3H) tensors, is ever written to memory. Per step, in BPTT
// order (pallas_gru.py:686-727):
//   xp = x[t] Wx + b, hp = h_prev Wh, r, z, n as in the forward,
//   dh_tot = dys + dh, dz = dh_tot (h_prev - n),
//   dn = dh_tot (1 - z)(1 - n^2), dxr = dn hp_n r (1 - r), dxz = dz z (1 - z),
//   dhp = m [dxr, dxz, dn r], dxp = m [dxr, dxz, dn],
//   dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot,
//   dWh += h_prev^T dhp, dx[t] = dxp Wx^T, dWx += x[t]^T dxp, db += sum dxp.
//
// What bounds it on the H100: the operations, 3 B 3H (D + H) multiply-adds a
// step (31.7 GFLOP at T=249, B=16, D=768, H=384: 0.47 ms at the 67 TFLOP/s
// fp32 peak), against 47 MB of inputs and outputs. As in K5b the steps are
// sequential and each is a set of small products.
//
// Design: K5b's (csrc/gru_bptt.cu), U hidden units per block of a
// cooperative grid with one grid barrier per step. Each block also keeps
// its units' 3U columns of Wx in shared memory, and recomputes its units'
// xp[t] from the x[t] rows (read by every block from L2) in the same
// staged pass that forms hp. Its dWx columns (registers: each thread owns
// kDC contraction rows of the block's 3U columns), its db (the gate
// threads' registers) and its dWh columns (shared memory) belong to the
// block alone: no atomics, and every launch gives the same bits.
// dx[t] needs every unit's dxp[t]. Each step therefore writes
// [dxr, dxz, dn r, dn] (times m) of its units to a double-buffered
// (2, B, 4H) exchange buffer; after the barrier each block stages the
// first 3H columns for dhp Wh^T (its units' dh, as K5b) and for the r and
// z part of its slice of DS = ceil(D / grid) columns of dx[t], then the
// last H columns for the n part. The slice's Wx rows are read through the
// read-only cache. The buffer written at step s is read only between the
// barriers s + 1 and s + 2, before anyone writes it again at step s + 2,
// and the last step has a barrier too so that its dx is formed.
// The shape limits (shared memory and the registers of dWx) are checked
// by tpuasr_gru_xfb_fits before a launch.
#include "gru_coop.cuh"

namespace {

// dWx contraction rows per thread: kDC * U = 8 column vectors in registers.
// Built for U <= 4 only: JAX's rule takes the fused backward at H <= 512
// alone (H = 640 with the smallest D already needs 11.8 MB of its 11 MiB),
// which is U <= 4 on the H100's 132 SMs.
template <int U>
__host__ __device__ constexpr int dwx_chunks() {
  return 8 / U;
}

// Columns [c0, c0 + n) of rows b0 .. b0+kR-1 of a (B, ld) row-major array
// into dst[kR][n], bypassing L1; rows past B become zeros.
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int ld, int c0, int n, int b0,
                                           int B) {
  const int rows = min(kR, B - b0);
  const float* s = src + static_cast<size_t>(b0) * ld + c0;
  if (((ld | c0 | n) & 3) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < kR * n4; i += kThreads) {
      const int r = i / n4;
      const int c = i - r * n4;
      reinterpret_cast<float4*>(dst)[i] =
          r < rows ? __ldcg(reinterpret_cast<const float4*>(
                                s + static_cast<size_t>(r) * ld) + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kR * n; i += kThreads) {
      const int r = i / n;
      const int c = i - r * n;
      dst[i] = r < rows ? __ldcg(s + static_cast<size_t>(r) * ld + c) : 0.f;
    }
  }
}

// Rows b0 .. b0+kR-1 of dx[t]'s columns d0 .. d0+DS-1 over the first n
// staged columns of st[kR][ld] against Wx's columns w_off .. w_off+n-1:
// warp w takes the block's columns w, w + kWarps, ...; part[kR][DS] carries
// the first part of the sum, and with out set the second adds it and
// stores.
__device__ __forceinline__ void dx_slice(const float* st, int ld, int n,
                                         const float* __restrict__ wx,
                                         int w_off, int H3, int d0, int DS,
                                         int D, float* part, float* out,
                                         int b0, int B) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int dd = warp; dd < DS; dd += kWarps) {
    const int d = d0 + dd;
    float v[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = 0.f;
    if (d < D) {
      const float* w = wx + static_cast<size_t>(d) * H3 + w_off;
      for (int c = lane; c < n; c += 32) {
        const float wv = __ldg(w + c);
#pragma unroll
        for (int r = 0; r < kR; ++r) v[r] = fmaf(st[r * ld + c], wv, v[r]);
      }
    }
    reduce_scatter<kR, 1, 16>(v, lane);
    if ((lane & 1) == 0) {
      const int r = lane >> 1;
      if (out == nullptr) {
        part[r * DS + dd] = v[0];
      } else if (d < D && b0 + r < B) {
        out[static_cast<size_t>(b0 + r) * D + d] = part[r * DS + dd] + v[0];
      }
    }
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads)
gru_xfb_kernel(const float* __restrict__ x,      // (T, B, D)
               const float* __restrict__ ysp,    // (T, B, H)
               const float* __restrict__ wx,     // (D, 3H)
               const float* __restrict__ bias,   // (3H)
               const float* __restrict__ wh,     // (H, 3H)
               const float* __restrict__ mask,   // (T, B)
               const float* __restrict__ dys,    // (T, B, H)
               float* __restrict__ dx,           // (T, B, D)
               float* __restrict__ dwx,          // (D, 3H)
               float* __restrict__ db,           // (3H)
               float* __restrict__ dwh,          // (H, 3H)
               float* __restrict__ xbuf,         // (2, B, 4H) scratch
               unsigned* __restrict__ bar,       // arrival count, zeroed
               int T, int B, int D, int H, int reverse, int DS) {
  constexpr int kDC = dwx_chunks<U>();
  extern __shared__ float4 smem4[];
  const int H3 = 3 * H;
  const int H4 = 4 * H;
  const int SW = max(H3, D + H);
  float4* wcol = smem4;                                     // [U][H]
  float4* acc = wcol + U * H;                               // [U][H] dWh
  float4* wxc = acc + U * H;                                // [U][D]
  float4* own = wxc + U * D;                                // [kR][U] dhp
  float4* ownx = own + kR * U;                              // [kR][U] dxp
  float* wrow = reinterpret_cast<float*>(ownx + kR * U);    // [U][3H]
  float* st = wrow + ((U * H3 + 3) & ~3);                   // [kR][SW]
  float* red = st + kR * SW;                                // [kWarps][kR][3]
  float* part = red + kWarps * kR * 3;                      // [kR][DS]
  float* dh = part + kR * DS;                               // [B][U]
  float* zs = dh + B * U;                                   // [B][U]
  float* dht = zs + B * U;                                  // [B][U]

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  const int d0 = blockIdx.x * DS;
  load_columns<U>(wcol, wh, H, u0);
  load_columns<U>(wxc, wx, D, H, u0);
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
  float br = 0.f, bz = 0.f, bn = 0.f;
  if (gate && gu < nu) {
    br = bias[j];
    bz = bias[H + j];
    bn = bias[2 * H + j];
  }
  float dbr = 0.f, dbz = 0.f, dbn = 0.f;
  float ax[kDC][U][3];
#pragma unroll
  for (int c = 0; c < kDC; ++c)
#pragma unroll
    for (int u = 0; u < U; ++u) ax[c][u][0] = ax[c][u][1] = ax[c][u][2] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;      // BPTT order
    float* buf = xbuf + static_cast<size_t>(s & 1) * B * H4;
    float* xs = st;                             // [kR][D]
    float* hs = st + kR * D;                    // [kR][H]
    // Recompute xp and the gates from (x[t], h_prev), form dhp and dxp,
    // and add h_prev^T dhp and x[t]^T dxp to the block's columns, kR rows
    // at a time.
    for (int b0 = 0; b0 < B; b0 += kR) {
      const int b = b0 + gr;
      const bool live = gate && gu < nu && b < B;
      float m = 0.f, d = 0.f;
      if (live) {
        const size_t row = static_cast<size_t>(t) * B + b;
        m = mask[row];
        d = dys[row * H + j] + dh[b * U + gu];
      }
      stage_rows(xs, x + static_cast<size_t>(t) * B * D, b0, B, D);
      stage_rows(hs, ysp + static_cast<size_t>(t) * B * H, b0, B, H);
      __syncthreads();
      rows_times_columns<U>(xs, wxc, red, D);
      __syncthreads();
      float xr = 0.f, xz = 0.f, xn = 0.f;
      if (live) {
        xr = unit_sum<U>(red, gu, gr, 0, 3) + br;
        xz = unit_sum<U>(red, gu, gr, 1, 3) + bz;
        xn = unit_sum<U>(red, gu, gr, 2, 3) + bn;
      }
      __syncthreads();
      rows_times_columns<U>(hs, wcol, red, H);
      __syncthreads();
      if (gate) {
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 gx = g;
        if (live) {
          const float an = unit_sum<U>(red, gu, gr, 2, 3);
          const float rg = sigmoid(xr + unit_sum<U>(red, gu, gr, 0, 3));
          const float zg = sigmoid(xz + unit_sum<U>(red, gu, gr, 1, 3));
          const float ng = tanhf(xn + rg * an);
          const float h_prev = hs[gr * H + j];
          const float dz = d * (h_prev - ng);
          const float dn = d * (1.f - zg) * (1.f - ng * ng);
          const float dxr = dn * an * rg * (1.f - rg);
          const float dxz = dz * zg * (1.f - zg);
          g = make_float4(dxr * m, dxz * m, dn * rg * m, 0.f);
          gx = make_float4(dxr * m, dxz * m, dn * m, 0.f);
          float* o = buf + static_cast<size_t>(b) * H4;
          o[j] = g.x;
          o[H + j] = g.y;
          o[2 * H + j] = g.z;
          o[3 * H + j] = gx.z;
          zs[b * U + gu] = zg;
          dht[b * U + gu] = d;
          dbr += gx.x;
          dbz += gx.y;
          dbn += gx.z;
        }
        own[gr * U + gu] = g;
        ownx[gr * U + gu] = gx;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < H; k += kThreads) {
        float4 a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) a[u] = acc[u * H + k];
#pragma unroll 4
        for (int r = 0; r < kR; ++r) {
          const float h = hs[r * H + k];
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
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int k = threadIdx.x + c * kThreads;
        if (k < D) {
#pragma unroll 4
          for (int r = 0; r < kR; ++r) {
            const float xv = xs[r * D + k];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const float4 o = ownx[r * U + u];
              ax[c][u][0] = fmaf(xv, o.x, ax[c][u][0]);
              ax[c][u][1] = fmaf(xv, o.y, ax[c][u][1]);
              ax[c][u][2] = fmaf(xv, o.z, ax[c][u][2]);
            }
          }
        }
      }
      __syncthreads();                          // st, red, own are reused
    }
    grid_sync(bar, s + 1);                      // every block's dxp is out
    // dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot for the block's units
    // (not after the last step), and the block's slice of dx[t].
    float* dxt = dx + static_cast<size_t>(t) * B * D;
    for (int b0 = 0; b0 < B; b0 += kR) {
      stage_cols(st, buf, H4, 0, H3, b0, B);
      __syncthreads();
      if (s + 1 < T) {
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
      if (s + 1 < T && gate && gu < nu && b < B) {
        const float m = mask[static_cast<size_t>(t) * B + b];
        const float d = dht[b * U + gu];
        const float a = unit_sum<U>(red, gu, gr, 0, 1);
        dh[b * U + gu] = m * (d * zs[b * U + gu] + a) + (1.f - m) * d;
      }
      // dx's r and z columns from the staged dhp (equal to dxp there).
      dx_slice(st, H3, 2 * H, wx, 0, H3, d0, DS, D, part, nullptr, b0, B);
      __syncthreads();
      stage_cols(st, buf, H4, 3 * H, H, b0, B);   // m dn
      __syncthreads();
      dx_slice(st, H, H, wx, 2 * H, H3, d0, DS, D, part, dxt, b0, B);
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
#pragma unroll
  for (int c = 0; c < kDC; ++c) {
    const int k = threadIdx.x + c * kThreads;
    if (k >= D) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      float* w = dwx + static_cast<size_t>(k) * H3 + u0 + u;
      w[0] = ax[c][u][0];
      w[H] = ax[c][u][1];
      w[2 * H] = ax[c][u][2];
    }
  }
  // db: the gate threads' sums, added over the kR rows in a fixed order.
  if (gate) {
    red[threadIdx.x * 3] = dbr;
    red[threadIdx.x * 3 + 1] = dbz;
    red[threadIdx.x * 3 + 2] = dbn;
  }
  __syncthreads();
  if (threadIdx.x < 3 * nu) {
    const int u = threadIdx.x / 3;
    const int g = threadIdx.x - 3 * u;
    float sum = 0.f;
    for (int r = 0; r < kR; ++r) sum += red[(r * U + u) * 3 + g];
    db[g * H + u0 + u] = sum;
  }
}

int grid_of(int H, int U) { return (H + U - 1) / U; }

int slice_of(int D, int grid) { return (D + grid - 1) / grid; }

size_t smem_bytes(int B, int D, int H, int U) {
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t SW = std::max<size_t>(H3, static_cast<size_t>(D) + H);
  const size_t DS = slice_of(D, grid_of(H, U));
  return sizeof(float4) * (2 * static_cast<size_t>(U) * H +
                           static_cast<size_t>(U) * D + 2 * kR * U) +
         sizeof(float) * (((U * H3 + 3) & ~size_t{3}) + kR * SW +
                          kWarps * kR * 3 + kR * DS +
                          3 * static_cast<size_t>(B) * U);
}

int max_d(int U) {
  return U <= 4 ? 8 / U * kThreads : 0;
}

template <int U>
int xfb(const float* x, const float* ysp, const float* wx, const float* b,
        const float* wh, const float* mask, const float* dys, float* dx,
        float* dwx, float* db, float* dwh, float* xbuf, unsigned* bar, int T,
        int B, int D, int H, int reverse, cudaStream_t stream) {
  if (D > max_d(U)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_of(H, U);
  int DS = slice_of(D, grid);
  void* args[] = {&x,  &ysp, &wx,  &b, &wh, &mask, &dys,     &dx, &dwx,
                  &db, &dwh, &xbuf, &bar, &T, &B, &D, &H, &reverse, &DS};
  return launch_cooperative(reinterpret_cast<const void*>(gru_xfb_kernel<U>),
                            grid, smem_bytes(B, D, H, U), args, stream);
}

}  // namespace

// Whether K2b holds a shape: 1 if it does. smem gets the shared memory a
// block needs and budget what a block may take; dmax the largest D that
// the registers of dWx hold at this H (0 past U = 4, H > 512 here).
extern "C" int tpuasr_gru_xfb_fits(int B, int D, int H, long long* smem,
                                   long long* budget, int* dmax) {
  int nsm = 0;
  if (sm_count(&nsm)) return 0;
  const int U = units_per_block(H, nsm);
  *smem = static_cast<long long>(smem_bytes(B, D, H, U));
  *budget = static_cast<long long>(kSmemBudget);
  *dmax = max_d(U);
  return *smem <= *budget && D <= *dmax;
}

// K2b: dx (T, B, D), dwx (D, 3H), db (3H) and dwh (H, 3H) from x, ysp
// (T, B, H), wx, b, wh, mask (T, B) and dys (T, B, H), all f32 and
// contiguous. xbuf: (2, B, 4H) f32 scratch; bar: one zeroed uint32 word.
extern "C" int tpuasr_gru_xfb(const float* x, const float* ysp,
                              const float* wx, const float* b,
                              const float* wh, const float* mask,
                              const float* dys, float* dx, float* dwx,
                              float* db, float* dwh, float* xbuf,
                              unsigned* bar, int T, int B, int D, int H,
                              int reverse, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || D <= 0 || H <= 0) return 0;
  int nsm = 0;
  if (int err = sm_count(&nsm)) return err;
  const int U = units_per_block(H, nsm);
#define TPUASR_XFB(N)                                                          \
  xfb<N>(x, ysp, wx, b, wh, mask, dys, dx, dwx, db, dwh, xbuf, bar, T, B, D, \
         H, reverse, stream)
  switch (U) {
    case 1: return TPUASR_XFB(1);
    case 2: return TPUASR_XFB(2);
    case 4: return TPUASR_XFB(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUASR_XFB
}

#undef TPUASR_BY_UNITS
