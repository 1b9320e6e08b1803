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
// What bounds it on the H100 in float32: the operations (fp32, FMA units:
// never TF32).
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
// bf16 (the JAX kernels with bf16 streams, pallas_gru.py:138-140, :375-377,
// :705-707): xp, ysp, dys and Wh hold bf16 values; JAX rounds dhp to bf16
// for dhp Wh^T only (dh, the gates and the dhp of dWh stay f32), writes dxp
// in bf16 (K5b, K7b; K2b keeps it f32 for dWx and db) and rounds the weight
// gradients, f32 sums, at the end. Its own design on the H100, since the
// bf16 products belong on the tensor cores:
//   b. gru_lean_bf16_kernel reads the streams in their own dtype (K2b's xp
//      is f32: phase a's unrounded sums), keeps Wh's rows of its U <= 32
//      units resident in bf16, and its gate phase writes dhp twice: f32 for
//      phase c and rounded to bf16 into a two-step ring (2, B, K3) that the
//      other blocks of the row group read after the barrier. dhp[t] Wh^T
//      runs on mma.sync m16n8k16 (bf16 in, f32 sums): a warp takes every
//      16th piece of 32 columns of the contraction, loads its A fragments
//      straight from L2 (16 bytes of a row a lane, the k order permuted
//      alike in A and B), its B fragments from the resident rows, and the
//      warps' 16 x U sums are added in warp order. A step stages rows x 3H x
//      2 bytes a block, where the f32 body stages x 4 at fewer units a
//      block. What bounds this form is the chain of T steps, each a barrier
//      and an L2 round trip of the rows (about 5 us a step on an H100 SXM
//      at 700 W at the trained shapes), not its operations.
//   c. gemm_tn_bf16_kernel: A (ysp, or K2b's x with its ones column) is
//      bf16; each f32 value of B (dhp, K2b's dxp) is split exactly into
//      three bf16 terms, hi + mid + lo, on its way into shared memory, and
//      A^T hi, A^T mid and A^T lo run on mma.sync: every product exact,
//      only the f32 sums' order differs from the FMA tiles. The same slices
//      and fixed slice order as the f32 product.
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

// One direction's tensors, f32 and contiguous; XT and WT are bf16 for
// the bf16 body's streams (K2b's xp, and then dxp, f32).
template <typename XT = float, typename WT = float>
struct LeanDir {
  const XT* xp;                   // (T, B, 3H): x Wx + b
  const float* hp;                // (T, B, 3H): ysp Wh
  const WT* ysp;                  // (T, B, H): h before each step
  const WT* dys;                  // (T, B, H)
  const WT* wh;                   // (H, 3H)
  XT* dxp;                        // (T, B, 3H), out
  float* dhp;                     // (T, B, 3H), out: phase c's (the f32
                                  // body's blocks read it back)
  float* dh;                      // (B, H), zeroed: the carried gradient
  __nv_bfloat16* ring;            // bf16 body: (2, B, K3) bf16(dhp), zeros
                                  // past 3H; step t's at t % 2
};

// The saved inputs of a gate item (row, unit j): xp's and hp's three gates,
// h_prev, dys and the mask (zeros where the item is not live).
struct GateIn {
  float xr, xz, xn, ar, az, an, h, dy, m;
};

template <typename XT, typename WT>
__device__ __forceinline__ GateIn load_gate(const LeanDir<XT, WT>& io,
                                            const float* __restrict__ mask,
                                            size_t row, int j, int H,
                                            bool live) {
  GateIn v{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const size_t q = row * 3 * H + j;
    const size_t h = row * H + j;
    v.xr = to_f32(__ldg(io.xp + q));
    v.xz = to_f32(__ldg(io.xp + q + H));
    v.xn = to_f32(__ldg(io.xp + q + 2 * H));
    v.ar = __ldg(io.hp + q);
    v.az = __ldg(io.hp + q + H);
    v.an = __ldg(io.hp + q + 2 * H);
    v.h = to_f32(__ldg(io.ysp + h));
    v.dy = to_f32(__ldg(io.dys + h));
    v.m = __ldg(mask + row);
  }
  return v;
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The gate math of item (row b of step t, unit j): dxp and dhp of step t
// written out (dhp also rounded into the ring where it has one), dh = c.
template <typename XT, typename WT>
__device__ __forceinline__ void gate_item(const LeanDir<XT, WT>& io,
                                          const GateIn& v, size_t tb,
                                          size_t b, int j, int H,
                                          size_t ring_row) {
  const int H3 = 3 * H;
  const float rg_ = sigmoid(v.xr + v.ar);
  const float zg = sigmoid(v.xz + v.az);
  const float ng = tanhf(v.xn + rg_ * v.an);
  const float d = v.dy + io.dh[b * H + j], m = v.m;
  const float dz = d * (v.h - ng);
  const float dn = d * (1.f - zg) * (1.f - ng * ng);
  const float dxr = dn * v.an * rg_ * (1.f - rg_);
  const float dxz = dz * zg * (1.f - zg);
  const size_t q = (tb + b) * H3 + j;
  store_as(io.dxp + q, dxr * m);
  store_as(io.dxp + q + H, dxz * m);
  store_as(io.dxp + q + 2 * H, dn * m);
  const float p0 = dxr * m, p1 = dxz * m, p2 = dn * rg_ * m;
  io.dhp[q] = p0;
  io.dhp[q + H] = p1;
  io.dhp[q + 2 * H] = p2;
  if (io.ring) {
    __nv_bfloat16* r = io.ring + ring_row + j;
    r[0] = __float2bfloat16_rn(p0);
    r[H] = __float2bfloat16_rn(p1);
    r[2 * H] = __float2bfloat16_rn(p2);
  }
  io.dh[b * H + j] = m * (d * zg) + (1.f - m) * d;
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
// direction), so BPTT runs up from t = 0.
template <int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_lean_kernel(LeanDir<> d0, LeanDir<> d1, const float* __restrict__ mask,
                unsigned* __restrict__ bar, int T, int B, int H, int reverse,
                int RG, int KC) {
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
  const LeanDir<> io = dir ? d1 : d0;
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
        gate_item(io, in[g], tb, rb0 + item / U, j, H, 0);
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
            reinterpret_cast<float4*>(st)[e] = v;
          }
        } else {
          for (int e = tid; e < kR * KC; e += kThreads) {
            const int r = e / KC;
            const int c = c0 + e - r * KC;
            const float v =
                r < rows && c < H3
                    ? __ldcg(src + static_cast<size_t>(b0 + r) * H3 + c)
                    : 0.f;
            st[e] = v;
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
int launch_lean(const LeanDir<>& d0, const LeanDir<>& d1, const float* mask,
                unsigned* bar, int T, int B, int H, int reverse, int RG,
                int KC, int ndir, cudaStream_t stream) {
  LeanDir<> a = d0, b = d1;
  void* args[] = {&a, &b, &mask, &bar, &T, &B, &H, &reverse, &RG, &KC};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_lean_kernel<U>),
      ndir * RG * ((H + U - 1) / U), lean_smem_bytes(H, U, KC), args,
      stream);
}

// ---- phase b in bf16: the lean recurrence on the tensor cores -----------

constexpr int kPiece = 32;        // contraction columns of a warp's piece
constexpr int kPieces = 4;        // pieces a warp holds in registers at once

// The contraction of the bf16 body: 3H rounded up to whole pieces (the
// ring's row). A resident row of Wh takes 32 columns more where that is a
// multiple of 64, so that the rows of a warp's B fragments (lane / 4)
// start 64 bytes apart modulo 128 and a 16-byte load hits no bank twice.
__host__ __device__ constexpr int lean_bf16_k3(int H) {
  return (3 * H + kPiece - 1) / kPiece * kPiece;
}
__host__ __device__ constexpr int lean_bf16_ld(int H) {
  return lean_bf16_k3(H) + kPiece * (lean_bf16_k3(H) % 64 == 0);
}

// Shared memory of a bf16 block: Wh's rows [U][ld] in bf16, the warps'
// sums of a pass [kWarps][kR rows][U units] in f32.
size_t lean_bf16_smem_bytes(int H, int U) {
  return 2 * static_cast<size_t>(U) * lean_bf16_ld(H) + 4 * kWarps * kR * U;
}

// The bf16 streams' lean recurrence: the grid and the step as in
// gru_lean_kernel (the same gate math, gate_item), with the bf16 ring in
// place of the staged f32 rows and dhp[t] Wh^T on mma.sync. U in 8, 16, 32:
// U / 8 n8 tiles of units; a pass is one m16 tile of rows.
template <int U, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
gru_lean_bf16_kernel(LeanDir<XT, __nv_bfloat16> d0,
                     LeanDir<XT, __nv_bfloat16> d1,
                     const float* __restrict__ mask,
                     unsigned* __restrict__ bar, int T, int B, int H,
                     int reverse, int RG) {
  constexpr int NT = U / 8;
  static_assert(U % 8 == 0 && kR * U <= kThreads, "a pass's sums a thread");
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int H3 = 3 * H, K3 = lean_bf16_k3(H), ld = lean_bf16_ld(H);
  __nv_bfloat16* wres = reinterpret_cast<__nv_bfloat16*>(smem_b);  // [U][ld]
  float4* red = reinterpret_cast<float4*>(wres + U * ld);  // [warp][NT][lane]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int UG = (H + U - 1) / U;
  const int dir = blockIdx.x / (RG * UG), rest = blockIdx.x % (RG * UG);
  const int ug = rest % UG, rg = rest / UG;
  const int u0 = ug * U;
  const int rpg = (B + RG - 1) / RG;                      // rows a group
  const int rb0 = min(B, rg * rpg), rb1 = min(B, rb0 + rpg);
  unsigned* gbar = bar + dir * RG + rg;   // the row group's own barrier
  const LeanDir<XT, __nv_bfloat16> io = dir ? d1 : d0;
  for (int i = tid; i < U * ld; i += kThreads) {
    const int u = i / ld, c = i - u * ld;
    wres[i] = u0 + u < H && c < H3
                  ? io.wh[static_cast<size_t>(u0 + u) * H3 + c]
                  : __float2bfloat16_rn(0.f);
  }
  const int items = (rb1 - rb0) * U;
  const int g = lane >> 2, q = lane & 3;
  const int npc = K3 / kPiece;
  GateIn pre[kGI];
  auto load_first = [&](int t) {
#pragma unroll
    for (int k = 0; k < kGI; ++k) {
      const int item = k * kThreads + tid;
      pre[k] = load_gate(io, mask, static_cast<size_t>(t) * B + rb0 + item / U,
                         u0 + item % U, H, item < items && u0 + item % U < H);
    }
  };
  load_first(reverse ? 0 : T - 1);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;                // BPTT order
    const size_t tb = static_cast<size_t>(t) * B;
    const size_t ring_t = static_cast<size_t>(t & 1) * B;  // the ring's rows
    for (int i0 = 0; i0 < items; i0 += kGI * kThreads) {
      GateIn in[kGI];
#pragma unroll
      for (int k = 0; k < kGI; ++k) {
        const int item = i0 + k * kThreads + tid;
        in[k] = i0 == 0 ? pre[k]
                        : load_gate(io, mask, tb + rb0 + item / U,
                                    u0 + item % U, H,
                                    item < items && u0 + item % U < H);
      }
#pragma unroll
      for (int k = 0; k < kGI; ++k) {
        const int item = i0 + k * kThreads + tid;
        const int j = u0 + item % U;
        if (item >= items || j >= H) continue;
        const size_t b = rb0 + item / U;
        gate_item(io, in[k], tb, b, j, H, (ring_t + b) * K3);
      }
    }
    if (s + 1 == T) break;
    load_first(reverse ? s + 1 : T - 2 - s);
    group_sync(gbar, s + 1, UG);          // the row group's ring[t] is out
    // dh += m bf16(dhp[t]) Wh^T, 16 rows a pass. Lane (g, q) of a warp
    // loads columns 8q .. 8q+7 of each piece of rows g and g + 8 from L2
    // (other blocks wrote them), and the same columns of Wh's rows: k
    // 2q, 2q+1 of the piece's first k16 step are its columns 8q, 8q+1, k
    // 2q+8, 2q+9 its 8q+2, 8q+3, and the second step the next four.
    const __nv_bfloat16* ring = io.ring + ring_t * K3;
    for (int b0 = rb0; b0 < rb1; b0 += kR) {
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const bool lo = b0 + g < rb1, hi = b0 + g + 8 < rb1;
      const __nv_bfloat16* rlo = ring + static_cast<size_t>(b0 + g) * K3 + 8 * q;
      const __nv_bfloat16* rhi = rlo + 8 * static_cast<size_t>(K3);
      for (int c0 = warp; c0 < npc; c0 += kWarps * kPieces) {
        uint4 alo[kPieces], ahi[kPieces];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int c = (c0 + p * kWarps) * kPiece;
          const bool in = c0 + p * kWarps < npc;
          alo[p] = in && lo ? __ldcg(reinterpret_cast<const uint4*>(rlo + c))
                            : make_uint4(0, 0, 0, 0);
          ahi[p] = in && hi ? __ldcg(reinterpret_cast<const uint4*>(rhi + c))
                            : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int c = (c0 + p * kWarps) * kPiece;
          if (c0 + p * kWarps >= npc) break;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                wres + (n * 8 + g) * ld + c + 8 * q);
            const uint32_t a0[4] = {alo[p].x, ahi[p].x, alo[p].y, ahi[p].y};
            const uint32_t b0f[2] = {w.x, w.y};
            mma_bf16(acc[n], a0, b0f);
            const uint32_t a1[4] = {alo[p].z, ahi[p].z, alo[p].w, ahi[p].w};
            const uint32_t b1f[2] = {w.z, w.w};
            mma_bf16(acc[n], a1, b1f);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        red[(warp * NT + n) * 32 + lane] =
            make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      __syncthreads();
      if (tid < kR * U) {
        // Row r, unit u of the pass: d fragment element (r % 8, u % 8) of
        // tile u / 8, at lane (r % 8) * 4 + u % 8 / 2, element
        // 2 (r / 8) + u % 2; the warps' sums in warp order.
        const int r = tid / U, u = tid % U;
        const int b = b0 + r, j = u0 + u;
        if (b < rb1 && j < H) {
          const float* rf = reinterpret_cast<const float*>(red) +
                            ((u >> 3) * 32 + (r & 7) * 4 + ((u & 7) >> 1)) * 4 +
                            (r >> 3) * 2 + (u & 1);
          float a = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) a += rf[w * NT * 128];
          io.dh[static_cast<size_t>(b) * H + j] += __ldg(mask + tb + b) * a;
        }
      }
      __syncthreads();                    // red is rewritten; gates read dh
    }
  }
}

// ---- phase c in bf16: C = A^T B, B split into three bf16 terms -----------

constexpr int kCK = 32;                   // rows a stage
constexpr int kCL = kTB + 8;              // a staged row in bf16, padded
constexpr int kCStage = 4 * kCK * kCL;    // A, then B's hi, mid, lo terms
constexpr size_t kCSmem = 2 * kCStage * sizeof(__nv_bfloat16);

// Eight bf16 of row r, columns c .. c+7, of a (rows, ncols) bf16 array as
// uint4 (zero past rend or ncols; with ones, column ncols reads as 1).
__device__ __forceinline__ uint4 load_eight(const __nv_bfloat16* __restrict__ p,
                                            int ld, bool vec, int r, int rend,
                                            int c, int ncols, int ones) {
  if (r >= rend) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* row = p + static_cast<size_t>(r) * ld;
  if (vec && c + 8 <= ncols)
    return __ldg(reinterpret_cast<const uint4*>(row + c));
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t two = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c + 2 * i + h;
      const uint32_t v = k < ncols ? __bfloat16_as_ushort(row[k])
                                   : (ones && k == ncols ? 0x3f80u : 0u);
      two |= v << (16 * h);
    }
    e[i] = two;
  }
  return make_uint4(e[0], e[1], e[2], e[3]);
}

// v = hi + mid + lo exactly, each a bf16 (a float's 24 significant bits in
// three pieces of 8; each difference below is exact in f32).
__device__ __forceinline__ void split3(float v, uint32_t* t) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo =
      __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
  t[0] = __bfloat16_as_ushort(hi);
  t[1] = __bfloat16_as_ushort(mid);
  t[2] = __bfloat16_as_ushort(lo);
}

// parts[s] (N1, N2) = A^T Bm over the rows [s * ms, min(M, (s + 1) * ms))
// of slice s = blockIdx.y: A (M, N1a) bf16 (column N1a reads as ones with
// ones), Bm (M, N2) f32, rows lda and ldb apart. Block x covers a 128 x 128
// tile of C in 8 warps of 64 x 32 (4 x 4 mma tiles); the rows come 32 at a
// time, double-buffered through shared memory, each f32 of Bm split into
// its three bf16 terms as it is stored; fragments by ldmatrix.trans (the
// staged tiles are [row][column], the contraction runs down the rows).
__global__ void __launch_bounds__(kTT)
gemm_tn_bf16_kernel(const __nv_bfloat16* __restrict__ A, int lda, int N1a,
                    int ones, const float* __restrict__ Bm, int ldb, int N2,
                    float* __restrict__ parts, int M, int ms) {
  extern __shared__ __align__(16) unsigned char csm[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(csm);  // [2][A|terms]
  const int N1 = N1a + ones;
  const int tn2 = (N2 + kTB - 1) / kTB;
  const int i0 = (blockIdx.x / tn2) * kTB;
  const int j0 = (blockIdx.x % tn2) * kTB;
  const int r0 = blockIdx.y * ms;
  const int r1 = min(M, r0 + ms);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const bool va = ((reinterpret_cast<uintptr_t>(A) | (lda * 2u)) & 15) == 0;
  const bool vb = ((reinterpret_cast<uintptr_t>(Bm) | (ldb * 4u)) & 15) == 0;
  uint4 ra[2];                            // A: 2 x 8 columns a thread
  float4 rb[4];                           // Bm: 4 x 4 columns a thread
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kTT;
      ra[i] = load_eight(A, lda, va, k0 + (e >> 4), r1, i0 + (e & 15) * 8,
                         N1a, ones);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kTT;
      rb[i] = load_four(Bm, ldb, vb, k0 + (e >> 5), r1, j0 + (e & 31) * 4,
                        N2, 0);
    }
  };
  auto store = [&](int buf) {
    __nv_bfloat16* As = cs + buf * kCStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kTT;
      *reinterpret_cast<uint4*>(As + (e >> 4) * kCL + (e & 15) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kTT;
      const float v[4] = {rb[i].x, rb[i].y, rb[i].z, rb[i].w};
      uint32_t t[4][3];
#pragma unroll
      for (int k = 0; k < 4; ++k) split3(v[k], t[k]);
#pragma unroll
      for (int term = 0; term < 3; ++term)
        *reinterpret_cast<uint2*>(As + (term + 1) * kCK * kCL +
                                  (e >> 5) * kCL + (e & 31) * 4) =
            make_uint2(t[0][term] | t[1][term] << 16,
                       t[2][term] | t[3][term] << 16);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = r1 > r0 ? (r1 - r0 + kCK - 1) / kCK : 0;
  if (nk > 0) {
    load(r0);
    store(0);
  }
  __syncthreads();
  // ldmatrix.trans lanes: matrix lane / 8, its row lane % 8. A's fragment
  // takes rows k .. k+7 then k+8 .. (matrices 2, 3) at columns m, m+8
  // (matrices 1, 3); B's two n8 tiles take rows k, k+8 (matrices 1, 3) at
  // columns n, n+8 (matrices 2, 3).
  const int ra_row = (lane & 7) + ((lane >> 4) << 3);
  const int ra_col = ((lane >> 3) & 1) << 3;
  const int rb_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int rb_col = (lane >> 4) << 3;
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nk) load(r0 + (kb + 1) * kCK);
    const __nv_bfloat16* As = cs + cur * kCStage;
#pragma unroll
    for (int kk = 0; kk < kCK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(af[i], As + (kk + ra_row) * kCL + wm + 16 * i +
                                     ra_col);
#pragma unroll
      for (int term = 1; term <= 3; ++term) {
        const __nv_bfloat16* Bt = As + term * kCK * kCL;
        uint32_t bf[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Bt + (kk + rb_row) * kCL + wn + 16 * jj +
                                   rb_col);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
    }
    if (kb + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  float* out = parts + static_cast<size_t>(blockIdx.y) * N1 * N2;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n1 = i0 + wm + 16 * i + g + 8 * (e >> 1);
        const int n2 = j0 + wn + 8 * j + 2 * q + (e & 1);
        if (n1 < N1 && n2 < N2)
          out[static_cast<size_t>(n1) * N2 + n2] = acc[i][j][e];
      }
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

// tpuasr_gemm_tn with A in bf16 (the bf16 streams' ysp, or x) and B in f32
// split into three bf16 terms on the tensor cores: every product exact,
// the sums f32, slices of ceil(M / S) rows rounded up to 32, the same
// fixed slice order.
extern "C" int tpuasr_gemm_tn_bf16(const void* a, int lda, int n1a,
                                   int ones, const float* b, int ldb, int n2,
                                   float* c, float* parts, int M, int S,
                                   cudaStream_t stream) {
  const int n1 = n1a + (ones ? 1 : 0);
  if (n1 <= 0 || n2 <= 0) return 0;
  if (M < 0 || S < 1 || (S > 1 && parts == nullptr) || lda < n1a ||
      ldb < n2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kCSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ms = ((M + S - 1) / S + kCK - 1) / kCK * kCK;
  const dim3 grid(((n1 + kTB - 1) / kTB) * ((n2 + kTB - 1) / kTB), S);
  gemm_tn_bf16_kernel<<<grid, kTT, kCSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), lda, n1a, ones ? 1 : 0, b, ldb,
      n2, S > 1 ? parts : c, M, ms > 0 ? ms : kCK);
  err = cudaGetLastError();
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
// ops/gru.py::_lean_plan, float32: direction d's tensors are those of
// LeanDir's fields, the second set read only with ndir = 2. mask (T, B)
// f32; bar: ndir * RG zeroed uint32 words. A plan the kernel does not lay
// out the same way is refused.
extern "C" int tpuasr_gru_lean(
    const float* xp0, const float* hp0, const float* ysp0, const float* dys0,
    const float* wh0, float* dxp0, float* dhp0, float* dh0, const float* xp1,
    const float* hp1, const float* ysp1, const float* dys1, const float* wh1,
    float* dxp1, float* dhp1, float* dh1, const float* mask, unsigned* bar,
    int T, int B, int H, int reverse, int U, int RG, int KC, int ndir,
    long long smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (ndir < 1 || ndir > 2 || RG < 1 || KC <= 0 || KC % 128 ||
      smem != tpuasr_gru_lean_smem(H, U, KC))
    return static_cast<int>(cudaErrorInvalidValue);
  const LeanDir<> d0{xp0, hp0, ysp0, dys0, wh0, dxp0, dhp0, dh0, nullptr};
  const LeanDir<> d1{xp1, hp1, ysp1, dys1, wh1, dxp1, dhp1, dh1, nullptr};
#define TPUASR_LEAN(N)                                                        \
  launch_lean<N>(d0, d1, mask, bar, T, B, H, reverse, RG, KC, ndir, stream)
  TPUASR_BY_UNITS(TPUASR_LEAN)
#undef TPUASR_LEAN
}

// The bf16 body's dynamic shared memory a block at (H, U).
extern "C" long long tpuasr_gru_lean_bf16_smem(int H, int U) {
  return static_cast<long long>(lean_bf16_smem_bytes(H, U));
}

// Phase b of the bf16 streams with the plan (U, RG, smem) of
// ops/gru.py::_lean_plan(..., bf16=True): per direction xp (T, B, 3H) bf16,
// or f32 with xp_f32 (K2b; dxp then f32 too), hp (T, B, 3H) f32, ysp and
// dys (T, B, H) bf16, wh (H, 3H) bf16; out dxp (xp's dtype), dhp (T, B, 3H)
// f32; scratch ring (2, B, K3) bf16 zeroed (K3 = 3H rounded up to 32) and
// dh (B, H) f32 zeroed. mask (T, B) f32; bar: ndir * RG zeroed words. A
// plan the kernel does not lay out the same way is refused.
extern "C" int tpuasr_gru_lean_bf16(
    const void* xp0, const float* hp0, const void* ysp0, const void* dys0,
    const void* wh0, void* dxp0, float* dhp0, float* dh0, void* ring0,
    const void* xp1, const float* hp1, const void* ysp1, const void* dys1,
    const void* wh1, void* dxp1, float* dhp1, float* dh1, void* ring1,
    const float* mask, unsigned* bar, int T, int B, int H, int reverse,
    int U, int RG, int ndir, int xp_f32, long long smem,
    cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (ndir < 1 || ndir > 2 || RG < 1 ||
      smem != tpuasr_gru_lean_bf16_smem(H, U))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const int grid = ndir * RG * ((H + U - 1) / U);
  auto run = [&](auto xt, auto kernel) {
    using XT = decltype(xt);
    LeanDir<XT, bf> a{static_cast<const XT*>(xp0), hp0,
                      static_cast<const bf*>(ysp0),
                      static_cast<const bf*>(dys0),
                      static_cast<const bf*>(wh0), static_cast<XT*>(dxp0),
                      dhp0, dh0, static_cast<bf*>(ring0)};
    LeanDir<XT, bf> b{static_cast<const XT*>(xp1), hp1,
                      static_cast<const bf*>(ysp1),
                      static_cast<const bf*>(dys1),
                      static_cast<const bf*>(wh1), static_cast<XT*>(dxp1),
                      dhp1, dh1, static_cast<bf*>(ring1)};
    void* args[] = {&a, &b, &mask, &bar, &T, &B, &H, &reverse, &RG};
    return launch_cooperative(reinterpret_cast<const void*>(kernel), grid,
                              static_cast<size_t>(smem), args, stream);
  };
#define TPUASR_LEAN_BF16(N)                                                   \
  xp_f32 ? run(0.f, gru_lean_bf16_kernel<N, float>)                           \
         : run(bf(), gru_lean_bf16_kernel<N, bf>)
  switch (U) {
    case 8: return TPUASR_LEAN_BF16(8);
    case 16: return TPUASR_LEAN_BF16(16);
    case 32: return TPUASR_LEAN_BF16(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUASR_LEAN_BF16
}

#undef TPUASR_BY_UNITS
