// The GRU backward in three phases (float32, or bf16 streams): its lean
// recurrence, and the fixed-order products over all T*B rows that come
// after it.
//
// Replaces, with csrc/gru_scan.cu's f32 projection for the products over
// x and ysp, three Pallas kernels of tpuasr/ops/pallas_gru.py:
//   K2b  _bwd_xf_kernel (line 661), built by _build_bwd_xf (pallas_call at
//        line 736), reached through _xf_bwd -> _xf_bwd_fused (lines
//        829-838): dx, dWx, db and dWh of gru_scan_xfused from
//        (x, ysp, wx, b, wh, mask, dys);
//   K7b  _bidir_bwd_kernel (line 346), built by _build_bidir_bwd (line
//        437): dxpf, dxpb, dWhf, dWhb of gru_scan_bidir from (xpf, xpb,
//        yspf, yspb, whf, whb, mask, dysf, dysb), both directions forward
//        in time under one mask;
//   K5b  _bwd_kernel (line 104), built by _build_bwd (line 190): dxp and
//        dWh of gru_scan from (xp, ysp, wh, mask, dys), one direction,
//        forward or reversed in time (K2b's phases without x).
//
// The BPTT step (pallas_gru.py:117-146, 686-727), in BPTT order:
//   hp = h_prev Wh, r, z, n from (xp + hp) as in the forward,
//   dh_tot = dys + dh, dz = dh_tot (h_prev - n),
//   dn = dh_tot (1 - z)(1 - n^2), dxr = dn hp_n r (1 - r), dxz = dz z (1 - z),
//   dhp = m [dxr, dxz, dn r], dxp = m [dxr, dxz, dn],
//   dh = m (dh_tot z + dhp Wh^T) + (1 - m) dh_tot,
// and the sums dWh = sum_t h_prev^T dhp, dWx = sum_t x^T dxp, db = sum dxp,
// dx = dxp Wx^T. Only dhp Wh^T depends on the step before (through dh):
// h_prev = ysp[t] is a saved input, so hp (and K2b's xp = x Wx + b) is one
// product over all T*B rows before the scan, and every weight gradient and
// dx one product over all T*B rows after it.
//
// What bounds it on the H100: the operations (fp32, FMA units: never TF32).
// K2b at T=249, B=16, D=768, H=384 does 31.7 GFLOP (0.47 ms at 67 TFLOP/s),
// of which the sequential part, dhp Wh^T, is 3.5. The old fused kernels ran
// all three products of Wh (and K2b's three of Wx) inside each of the T
// steps, on 4 units a block, about 20 us a step; their dWh (and dWx) sums in
// shared memory also bounded the batch and the width.
//
// Design, three phases:
//   a. hp = ysp Wh (and K2b's xp = x Wx + b) over all T*B rows: K2's f32
//      projection tiles (csrc/gru_scan.cu, tpuasr_gru_proj), launched from
//      ops/gru.py.
//   b. The lean recurrence (gru_lean_kernel): a cooperative grid of
//      directions x row groups x unit groups, as K2's recurrence is split
//      (ops/gru.py::_lean_plan picks U, the row groups and the contraction
//      chunk). A block keeps the Wh rows of its U units (U x 3H, the
//      contraction of dhp Wh^T) in shared memory for the whole scan. A step
//      first runs the gate math of its (row, unit) items from the saved xp,
//      hp, ysp and dys, writes dxp and dhp of step t to (T, B, 3H) tensors
//      and keeps c = m dh_tot z + (1 - m) dh_tot as the item's dh; after its
//      row group's barrier it stages 16 rows of dhp[t] at a time (in chunks
//      of KC of the 3H columns, L1 bypassed: other blocks wrote them) and
//      adds m dhp Wh^T to dh.
//      The product: each warp owns a tile of 8 rows x min(U, 4) units and
//      a share of the contraction, each lane 4 columns at a time (float4
//      from shared memory: 12 loads feed 128 FMAs), the lanes' sums reduced
//      by shuffles and the tile's warps in a fixed order. The next step's
//      saved inputs of the gate items are loaded while the products run.
//      dh lives in a (B, H) buffer in device memory, each element read and
//      written by its own block only, so nothing grows with the batch in
//      shared memory: any batch plans.
//   c. dWh = ysp^T dhp, K2b's dWx = x^T dxp with db as one more row (A's
//      column of ones), over all T*B rows (gemm_tn_kernel): 128 x 128 tiles
//      of the output times S slices of the rows, each slice summed in row
//      order into its own partial, then the partials summed in slice order
//      (sum_parts_kernel). No atomics: every call gives the same bits.
//      K2b's dx = dxp Wx^T is phase a's projection again.
//
// bf16 (the JAX kernels with bf16 streams, pallas_gru.py:139, :271-293,
// :719, :887): xp, ysp, dys and Wh hold bf16 values, and the recurrence
// reads their f32 upcasts (phase a's products and phase c's sums read f32
// rows anyway, and one load path keeps the f32 mode's bits). The mode
// flags change two things: kRoundDhp rounds each staged dhp value to bf16
// before dhp Wh^T, as JAX casts dhp to Wh's dtype for that product (dh,
// the gates and the dhp written out for phase c's dWh stay f32,
// unrounded); kDxpBf16 writes dxp rounded to bf16 (K5b, K7b), where K2b
// keeps it in f32 for its dWx and db.
#include "gru_coop.cuh"

namespace {

// ---- phase c: C = A^T B over the rows, in a fixed order ------------------

constexpr int kTT = 256;          // product threads: 16 x 16, 8 x 8 sums each
constexpr int kTB = 128;          // output tile rows and columns

// Four values of row r, columns c .. c+3, of a (rows, ncols) array with
// rows ld apart (zero past rend or ncols); with ones, column ncols reads
// as 1. vec: the array's rows are 16-byte aligned.
__device__ __forceinline__ float4 load_four(const float* __restrict__ p,
                                            int ld, bool vec, int r,
                                            int rend, int c, int ncols,
                                            int ones) {
  if (r >= rend) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = p + static_cast<size_t>(r) * ld;
  if (vec && c + 4 <= ncols)
    return __ldg(reinterpret_cast<const float4*>(row + c));
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = c + i;
    e[i] = k < ncols ? __ldg(row + k) : (ones && k == ncols ? 1.f : 0.f);
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// parts[s] (N1, N2) = A^T Bm over the rows [s * ms, min(M, (s + 1) * ms))
// of slice s = blockIdx.y, summed in row order: A (M, N1a), Bm (M, N2),
// rows lda and ldb apart; N1 = N1a + ones (A's column N1a reads as ones,
// so C's last row is the column sums of Bm). Block x covers a 128 x 128
// tile of C; the rows come 8 at a time, double-buffered through shared
// memory, as in proj_f32_kernel (csrc/gru_scan.cu).
__global__ void __launch_bounds__(kTT)
gemm_tn_kernel(const float* __restrict__ A, int lda, int N1a, int ones,
               const float* __restrict__ Bm, int ldb, int N2,
               float* __restrict__ parts, int M, int ms) {
  __shared__ __align__(16) float As[2][8][kTB];      // [row][C's row]
  __shared__ __align__(16) float Bs[2][8][kTB];      // [row][C's column]
  const int N1 = N1a + ones;
  const int tn2 = (N2 + kTB - 1) / kTB;
  const int i0 = (blockIdx.x / tn2) * kTB;
  const int j0 = (blockIdx.x % tn2) * kTB;
  const int r0 = blockIdx.y * ms;
  const int r1 = min(M, r0 + ms);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 5, lc = (tid & 31) * 4;     // a load: row, 4 columns
  const bool va = ((reinterpret_cast<uintptr_t>(A) | (lda * 4u)) & 15) == 0;
  const bool vb = ((reinterpret_cast<uintptr_t>(Bm) | (ldb * 4u)) & 15) == 0;
  float4 ra, rb;
  auto load = [&](int k0) {
    ra = load_four(A, lda, va, k0 + lr, r1, i0 + lc, N1a, ones);
    rb = load_four(Bm, ldb, vb, k0 + lr, r1, j0 + lc, N2, 0);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lr][lc]) = ra;
    *reinterpret_cast<float4*>(&Bs[buf][lr][lc]) = rb;
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = r1 > r0 ? (r1 - r0 + 7) / 8 : 0;
  if (nk > 0) {
    load(r0);
    store(0);
  }
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nk) load(r0 + (kb + 1) * 8);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kb + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  float* out = parts + static_cast<size_t>(blockIdx.y) * N1 * N2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n1 = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (n1 >= N1) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n2 = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n2 < N2) out[static_cast<size_t>(n1) * N2 + n2] = acc[i][j];
    }
  }
}

// c[i] = parts[0][i] + parts[1][i] + ... + parts[S-1][i], in that order.
__global__ void __launch_bounds__(kTT)
sum_parts_kernel(const float* __restrict__ parts, int S, size_t n,
                 float* __restrict__ c) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTT + threadIdx.x;
  if (i >= n) return;
  float v = parts[i];
  for (int s = 1; s < S; ++s) v += parts[s * n + i];
  c[i] = v;
}

// ---- phase b: the lean recurrence ----------------------------------------

constexpr int kTM = 8;            // rows of a lane's tile
constexpr int kGI = 2;            // gate items a thread loads at once

constexpr int kRoundDhp = 1;      // mode: dhp rounded to bf16 for dhp Wh^T
constexpr int kDxpBf16 = 2;       // mode: dxp written in bf16

// One direction's tensors, f32 (dxp bf16 with kDxpBf16) and contiguous.
struct LeanDir {
  const float* xp;                // (T, B, 3H): x Wx + b
  const float* hp;                // (T, B, 3H): ysp Wh
  const float* ysp;               // (T, B, H): h before each step
  const float* dys;               // (T, B, H)
  const float* wh;                // (H, 3H)
  void* dxp;                      // (T, B, 3H), out
  float* dhp;                     // (T, B, 3H), out; read back by blocks
  float* dh;                      // (B, H), zeroed: the carried gradient
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                     bf16_round(v.w));
}

// The saved inputs of a gate item (row, unit j): xp's and hp's three gates,
// h_prev, dys and the mask (zeros where the item is not live).
struct GateIn {
  float xr, xz, xn, ar, az, an, h, dy, m;
};

__device__ __forceinline__ GateIn load_gate(const LeanDir& io,
                                            const float* __restrict__ mask,
                                            size_t row, int j, int H,
                                            bool live) {
  GateIn v{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const size_t q = row * 3 * H + j;
    const size_t h = row * H + j;
    v.xr = __ldg(io.xp + q);
    v.xz = __ldg(io.xp + q + H);
    v.xn = __ldg(io.xp + q + 2 * H);
    v.ar = __ldg(io.hp + q);
    v.az = __ldg(io.hp + q + H);
    v.an = __ldg(io.hp + q + 2 * H);
    v.h = __ldg(io.ysp + h);
    v.dy = __ldg(io.dys + h);
    v.m = __ldg(mask + row);
  }
  return v;
}

// Units of a lane's tile.
__host__ __device__ constexpr int lean_tn(int U) { return U < 4 ? U : 4; }

// Shared memory of a block: Wh's rows [U][nch * KC], the staged chunk
// [kR][KC] and the warps' sums [kWarps][kTM * TN].
size_t lean_smem_bytes(int H, int U, int KC) {
  const size_t nch = (3 * static_cast<size_t>(H) + KC - 1) / KC;
  return sizeof(float) * (U * nch * KC + static_cast<size_t>(kR) * KC +
                          kWarps * kTM * lean_tn(U));
}

// The grid is directions x RG row groups x ceil(H / U) unit groups: block
// (d, rg, ug) runs direction d's units ug*U .. for the rows of group rg,
// ceil(B / RG) of them. Rows never meet rows of another group or
// direction, so each (direction, row group) has a barrier of its own, one
// a step. reverse: the scan ran from t = T-1 down (K2b's or K5b's reversed
// direction), so BPTT runs up from t = 0. mode: kRoundDhp | kDxpBf16.
template <int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_lean_kernel(LeanDir d0, LeanDir d1, const float* __restrict__ mask,
                unsigned* __restrict__ bar, int T, int B, int H, int reverse,
                int RG, int KC, int mode) {
  constexpr int TN = lean_tn(U);
  constexpr int N = kTM * TN;             // sums a lane keeps
  constexpr int RT = kR / kTM;            // row tiles of a pass
  constexpr int NT = RT * (U / TN);       // tiles of a pass
  constexpr int WPT = kWarps / NT;        // warps a tile
  constexpr int SPAN = 32 / N;            // lanes that end with one sum
  static_assert(kWarps % NT == 0 && 32 % N == 0, "tiles split the warps");
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  const int nch = (H3 + KC - 1) / KC;
  const int K3 = nch * KC;
  float* wres = smem;                     // [U][K3]
  float* st = wres + U * K3;              // [kR][KC]
  float* red = st + kR * KC;              // [kWarps][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int UG = (H + U - 1) / U;
  const int dir = blockIdx.x / (RG * UG), rest = blockIdx.x % (RG * UG);
  const int ug = rest % UG, rg = rest / UG;
  const int u0 = ug * U;
  const int rpg = (B + RG - 1) / RG;                      // rows a group
  const int rb0 = min(B, rg * rpg), rb1 = min(B, rb0 + rpg);
  unsigned* gbar = bar + dir * RG + rg;   // the row group's own barrier
  const LeanDir io = dir ? d1 : d0;
  // Wh's rows of the block's units, zero past H and past 3H.
  for (int i = tid; i < U * K3; i += kThreads) {
    const int u = i / K3, c = i - u * K3;
    wres[i] = u0 + u < H && c < H3
                  ? __ldg(io.wh + static_cast<size_t>(u0 + u) * H3 + c)
                  : 0.f;
  }
  // The warp's tile: rows rt .. rt+7 of a pass, units ut .. ut+TN-1, and
  // its share kw of the contraction.
  const int tile = warp / WPT, kw = warp % WPT;
  const int rt = (tile % RT) * kTM, ut = (tile / RT) * TN;
  const int items = (rb1 - rb0) * U;
  const int kc4 = KC / 4, k34 = K3 / 4;
  const bool vec = (H3 & 3) == 0;
  const bool round_dhp = mode & kRoundDhp;
  GateIn pre[kGI];
  auto load_first = [&](int t) {
#pragma unroll
    for (int g = 0; g < kGI; ++g) {
      const int item = g * kThreads + tid;
      pre[g] = load_gate(io, mask, static_cast<size_t>(t) * B + rb0 + item / U,
                         u0 + item % U, H, item < items && u0 + item % U < H);
    }
  };
  load_first(reverse ? 0 : T - 1);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;                // BPTT order
    const size_t tb = static_cast<size_t>(t) * B;
    // Gates of the (row, unit) items, kGI a thread at once; the first
    // kGI * kThreads items' saved inputs were loaded during the last step.
    for (int i0 = 0; i0 < items; i0 += kGI * kThreads) {
      GateIn in[kGI];
#pragma unroll
      for (int g = 0; g < kGI; ++g) {
        const int item = i0 + g * kThreads + tid;
        in[g] = i0 == 0 ? pre[g]
                        : load_gate(io, mask, tb + rb0 + item / U,
                                    u0 + item % U, H,
                                    item < items && u0 + item % U < H);
      }
#pragma unroll
      for (int g = 0; g < kGI; ++g) {
        const int item = i0 + g * kThreads + tid;
        const int j = u0 + item % U;
        if (item >= items || j >= H) continue;
        const size_t b = rb0 + item / U;
        const GateIn& v = in[g];
        const float rg_ = sigmoid(v.xr + v.ar);
        const float zg = sigmoid(v.xz + v.az);
        const float ng = tanhf(v.xn + rg_ * v.an);
        const float d = v.dy + io.dh[b * H + j], m = v.m;
        const float dz = d * (v.h - ng);
        const float dn = d * (1.f - zg) * (1.f - ng * ng);
        const float dxr = dn * v.an * rg_ * (1.f - rg_);
        const float dxz = dz * zg * (1.f - zg);
        const size_t q = (tb + b) * H3 + j;
        if (mode & kDxpBf16) {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(io.dxp);
          o[q] = __float2bfloat16_rn(dxr * m);
          o[q + H] = __float2bfloat16_rn(dxz * m);
          o[q + 2 * H] = __float2bfloat16_rn(dn * m);
        } else {
          float* o = static_cast<float*>(io.dxp);
          o[q] = dxr * m;
          o[q + H] = dxz * m;
          o[q + 2 * H] = dn * m;
        }
        io.dhp[q] = dxr * m;
        io.dhp[q + H] = dxz * m;
        io.dhp[q + 2 * H] = dn * rg_ * m;
        io.dh[b * H + j] = m * (d * zg) + (1.f - m) * d;
      }
    }
    if (s + 1 == T) break;
    // The next step's first round, loaded while this step's products run.
    load_first(reverse ? s + 1 : T - 2 - s);
    if (s + 1 == T) break;
    group_sync(gbar, s + 1, UG);          // the row group's dhp[t] is out
    // dh += m dhp[t] Wh^T for the block's units, kR rows a pass, each pass
    // in nch chunks of KC of the contraction.
    const float* src = io.dhp + tb * H3;
    for (int b0 = rb0; b0 < rb1; b0 += kR) {
      const int rows = min(kR, rb1 - b0);
      float acc[N];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        const int c0 = ch * KC;
        // Rows b0 .. of columns c0 .. c0+KC-1 (zero past the rows or 3H).
        if (vec) {
          for (int e = tid; e < kR * kc4; e += kThreads) {
            const int r = e / kc4;
            const int c = c0 + 4 * (e - r * kc4);
            float4 v = r < rows && c < H3
                           ? __ldcg(reinterpret_cast<const float4*>(
                                 src + static_cast<size_t>(b0 + r) * H3 + c))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            reinterpret_cast<float4*>(st)[e] = round_dhp ? bf16_round4(v) : v;
          }
        } else {
          for (int e = tid; e < kR * KC; e += kThreads) {
            const int r = e / KC;
            const int c = c0 + e - r * KC;
            const float v =
                r < rows && c < H3
                    ? __ldcg(src + static_cast<size_t>(b0 + r) * H3 + c)
                    : 0.f;
            st[e] = round_dhp ? bf16_round(v) : v;
          }
        }
        __syncthreads();
        const float4* s4 = reinterpret_cast<const float4*>(st);
        const float4* w4 = reinterpret_cast<const float4*>(wres) + c0 / 4;
        for (int q = kw * 32 + lane; q < kc4; q += WPT * 32) {
          float4 h[kTM];
#pragma unroll
          for (int r = 0; r < kTM; ++r) h[r] = s4[(rt + r) * kc4 + q];
#pragma unroll
          for (int u = 0; u < TN; ++u) {
            const float4 w = w4[(ut + u) * k34 + q];
#pragma unroll
            for (int r = 0; r < kTM; ++r) {
              float& a = acc[r * TN + u];
              a = fmaf(h[r].x, w.x, a);
              a = fmaf(h[r].y, w.y, a);
              a = fmaf(h[r].z, w.z, a);
              a = fmaf(h[r].w, w.w, a);
            }
          }
        }
        __syncthreads();                  // st is restaged
      }
      reduce_scatter<N, 1, 16>(acc, lane);
      if (lane % SPAN == 0) red[warp * N + lane / SPAN] = acc[0];
      __syncthreads();
      if (tid < kR * U) {
        const int r = tid / U, u = tid % U;
        const int j = u0 + u;
        if (r < rows && j < H) {
          const int tl = (u / TN) * RT + r / kTM;
          const int idx = (r % kTM) * TN + u % TN;
          float a = 0.f;
#pragma unroll
          for (int w = 0; w < WPT; ++w) a += red[(tl * WPT + w) * N + idx];
          const int b = b0 + r;
          io.dh[static_cast<size_t>(b) * H + j] += __ldg(mask + tb + b) * a;
        }
      }
      // red is next written after the next pass's two barriers.
    }
    __syncthreads();                      // the next gates read dh
  }
}

template <int U>
int launch_lean(const LeanDir& d0, const LeanDir& d1, const float* mask,
                unsigned* bar, int T, int B, int H, int reverse, int RG,
                int KC, int ndir, int mode, cudaStream_t stream) {
  LeanDir a = d0, b = d1;
  void* args[] = {&a, &b, &mask, &bar, &T, &B, &H, &reverse, &RG, &KC, &mode};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_lean_kernel<U>),
      ndir * RG * ((H + U - 1) / U), lean_smem_bytes(H, U, KC), args,
      stream);
}

}  // namespace

// C (N1a + ones, N2) = A^T B over M rows: A (M, N1a) with rows lda apart,
// B (M, N2) with rows ldb apart, f32; with ones, C's last row is the
// column sums of B. The rows split into S slices of ceil(M / S) rounded up
// to 8, each summed in row order into parts (S, N1a + ones, N2) f32
// scratch, then summed in slice order into c (contiguous); with S = 1, c
// directly (parts may be null).
extern "C" int tpuasr_gemm_tn(const float* a, int lda, int n1a, int ones,
                              const float* b, int ldb, int n2, float* c,
                              float* parts, int M, int S,
                              cudaStream_t stream) {
  const int n1 = n1a + (ones ? 1 : 0);
  if (n1 <= 0 || n2 <= 0) return 0;
  if (M < 0 || S < 1 || (S > 1 && parts == nullptr) || lda < n1a ||
      ldb < n2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ms = ((M + S - 1) / S + 7) / 8 * 8;
  const dim3 grid(((n1 + kTB - 1) / kTB) * ((n2 + kTB - 1) / kTB), S);
  gemm_tn_kernel<<<grid, kTT, 0, stream>>>(a, lda, n1a, ones ? 1 : 0, b, ldb,
                                           n2, S > 1 ? parts : c, M,
                                           ms > 0 ? ms : 8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(n1) * n2;
  sum_parts_kernel<<<static_cast<unsigned>((n + kTT - 1) / kTT), kTT, 0,
                     stream>>>(parts, S, n, c);
  return static_cast<int>(cudaGetLastError());
}

// The lean recurrence's dynamic shared memory a block at (H, U, KC).
extern "C" long long tpuasr_gru_lean_smem(int H, int U, int KC) {
  return static_cast<long long>(lean_smem_bytes(H, U, KC));
}

// Phase b over ndir directions (1 or 2) with the plan (U, RG, KC, smem) of
// ops/gru.py::_lean_plan: direction d's tensors are those of LeanDir's
// fields, the second set read only with ndir = 2. mask (T, B) f32; bar:
// ndir * RG zeroed uint32 words; mode: 0 (float32), or kRoundDhp (1) with
// kDxpBf16 (2) or without it (the bf16 streams). A plan the kernel does
// not lay out the same way is refused.
extern "C" int tpuasr_gru_lean(
    const float* xp0, const float* hp0, const float* ysp0, const float* dys0,
    const float* wh0, void* dxp0, float* dhp0, float* dh0, const float* xp1,
    const float* hp1, const float* ysp1, const float* dys1, const float* wh1,
    void* dxp1, float* dhp1, float* dh1, const float* mask, unsigned* bar,
    int T, int B, int H, int reverse, int U, int RG, int KC, int ndir,
    int mode, long long smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (ndir < 1 || ndir > 2 || RG < 1 || KC <= 0 || KC % 128 || mode < 0 ||
      mode > (kRoundDhp | kDxpBf16) ||
      smem != tpuasr_gru_lean_smem(H, U, KC))
    return static_cast<int>(cudaErrorInvalidValue);
  const LeanDir d0{xp0, hp0, ysp0, dys0, wh0, dxp0, dhp0, dh0};
  const LeanDir d1{xp1, hp1, ysp1, dys1, wh1, dxp1, dhp1, dh1};
#define TPUASR_LEAN(N)                                                        \
  launch_lean<N>(d0, d1, mask, bar, T, B, H, reverse, RG, KC, ndir, mode,   \
                 stream)
  TPUASR_BY_UNITS(TPUASR_LEAN)
#undef TPUASR_LEAN
}

#undef TPUASR_BY_UNITS
