// The float32 forward GRU recurrence, one or two directions in one
// cooperative grid: K5's forward, the second launch of K2 in float32 (after
// its input projection on K2's f32 tiles) and K7's f32 forward (both
// directions of a bidirectional GRU). The bf16 forwards (serving) are K2's
// tensor-core recurrence (csrc/gru_scan.cu, tpuasr_gru_rec); the f32
// backwards (K5b, K2b, K7b) are csrc/gru_lean.cu's lean recurrence with
// their products before and after.
//
// Replaces, for f32 streams, of tpuasr/ops/pallas_gru.py:
//   K5  _fwd_kernel (line 77), built by _build_fwd (pallas_call at line
//       163): ys = gru_scan(xp, wh, mask, reverse). With reverse the scan
//       runs t = T-1 down to 0 with h_prev = ys[t+1], on left-aligned
//       ragged rows under the same mask (a row's padded tail keeps h = 0).
//   K2  _fwd_xf_kernel (pallas_call at line 615) in f32: its recurrence.
//   K7  _bidir_fwd_kernel (line 319), built by _build_bidir_fwd
//       (pallas_call at line 406): ysf, ysb = gru_scan_bidir(xpf, xpb, whf,
//       whb, mask). xpb is built by the caller from the per-row reversed
//       input, so both recursions run forward in time under the same mask.
// Per direction and step (pallas_gru.py:70-74, gate order r, z, n):
// hp = h Wh, r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z),
// n = tanh(xp_n + r hp_n), h' = (1 - z) n + z h, h = m h' + (1 - m) h.
//
// What bounds it on the H100: the operations (fp32 on the FMA units, never
// TF32). K7 in training at T=249, B=128, H=512 does 2 x 249 x 128 x 512 x
// 1536 multiply-adds, 1.50 ms at the 67 TFLOP/s fp32 peak; at B=16, 0.19
// ms; K5 at B=16 one direction, 0.094 ms.
// But the steps are sequential and each is a small product, so what a
// design reaches is set by how many SMs share a step and what each must
// stage per step.
//
// Design: a cooperative grid of directions x row groups x unit groups, as
// K2's recurrence and the lean recurrence are split (ops/gru.py::
// _bidir_f32_plan picks U, the row groups and the contraction chunk for
// two directions, and shares one grid where the H contraction takes at
// most two chunks, else each is a launch; _f32_rec_plan plans one
// direction). Block (d, rg, ug) keeps Wh's 3U columns
// of direction d's units ug*U .. (U of 1-16) in shared memory for the
// whole scan, contraction contiguous, and runs the rows of its row group,
// ceil(B / RG) of them; each (direction, row group) has a barrier of its
// own, one a step. The state is ys itself: a step stages rows of ys at
// the previous step's time (t-1, or t+1 with reverse; cp.async through
// L2: other blocks wrote them), 16 rows a pass, in
// chunks of KC of the H contraction, into two buffers, so that the next
// pass's (or chunk's) copy runs during this one's product, with one
// __syncthreads a staged item. The product is tiled in registers: each
// warp owns 8 rows x (3 gates x min(U, 2) units) and a share of the
// contraction, each lane 4 columns at a time (float4 from shared memory:
// 14 loads feed 192 FMAs), the lanes' sums reduced by shuffles and a
// tile's warps in a fixed order, so two calls give the same bits. A
// pass's gate inputs (xp, the mask and the item's own h_prev) are loaded
// before its product runs, the next step's first pass before the step's
// barrier.
#include "gru_coop.cuh"

namespace {

constexpr int kTM = 8;            // rows of a lane's tile

// Units of a lane's tile (three gate columns each).
__host__ __device__ constexpr int bidir_tn(int U) { return U < 2 ? U : 2; }

// Shared memory of a block: Wh's columns [3U][nch * KC], two staging
// buffers [2][kR][KC] and the warps' sums [kWarps][kTM * 3 * TN].
size_t bidir_smem_bytes(int H, int U, int KC) {
  const size_t nch = (static_cast<size_t>(H) + KC - 1) / KC;
  return sizeof(float) * (3 * U * nch * KC +
                          2 * static_cast<size_t>(kR) * KC +
                          kWarps * kTM * 3 * bidir_tn(U));
}

// One direction's tensors, all f32 and contiguous.
struct BidirDir {
  const float* xp;                // (T, B, 3H)
  const float* wh;                // (H, 3H)
  float* ys;                      // (T, B, H), out; read back by blocks
};

// The inputs of a gate item (row, unit): xp's three gates and the mask.
struct XIn {
  float xr, xz, xn, m;
};

template <int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_bidir_f32_kernel(BidirDir d0, BidirDir d1,
                     const float* __restrict__ mask,   // (T, B)
                     unsigned* __restrict__ bar,       // (dirs, RG), zeroed
                     int T, int B, int H, int RG, int KC, int reverse) {
  constexpr int TN = bidir_tn(U);
  constexpr int P = kTM * TN;             // (row, unit) pairs of a tile
  constexpr int N = 3 * P;                // sums a lane keeps
  constexpr int RT = kR / kTM;            // row tiles of a pass
  constexpr int NT = RT * (U / TN);       // tiles of a pass
  constexpr int WPT = kWarps / NT;        // warps a tile
  constexpr int SPAN = 32 / P;            // lanes that end with one pair
  static_assert(kWarps % NT == 0 && 32 % P == 0, "tiles split the warps");
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  const int nch = (H + KC - 1) / KC;
  const int HC = nch * KC;
  float* wres = smem;                     // [3U][HC]: column g*U + u
  float* st = wres + 3 * U * HC;          // [2][kR][KC]
  float* red = st + 2 * kR * KC;          // [kWarps][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int UG = (H + U - 1) / U;
  const int dir = blockIdx.x / (RG * UG), rest = blockIdx.x % (RG * UG);
  const int ug = rest % UG, rg = rest / UG;
  const int u0 = ug * U;
  const int rpg = (B + RG - 1) / RG;                      // rows a group
  const int rb0 = min(B, rg * rpg), rb1 = min(B, rb0 + rpg);
  unsigned* gbar = bar + dir * RG + rg;   // the row group's own barrier
  const BidirDir io = dir ? d1 : d0;
  // Wh's columns of the block's units, zero past H: neighbouring threads
  // read neighbouring units of one row of Wh.
  for (int i = tid; i < 3 * U * HC; i += kThreads) {
    const int k = i / (3 * U), c = i - k * (3 * U);
    const int g = c / U, u = c - g * U;
    wres[c * HC + k] =
        k < H && u0 + u < H
            ? __ldg(io.wh + static_cast<size_t>(k) * H3 + g * H + u0 + u)
            : 0.f;
  }
  // The warp's tile: rows rt .. rt+7 of a pass, units ut .. ut+TN-1 (all
  // three gates), and its share kw of the contraction.
  const int tile = warp / WPT, kw = warp % WPT;
  const int rt = (tile % RT) * kTM, ut = (tile / RT) * TN;
  const int kc4 = KC / 4, hc4 = HC / 4;
  const bool vec = (H & 3) == 0;
  // The thread's gate item of a pass: row gr of the pass, unit u0 + gu.
  const int gr = tid / U, gu = tid % U, j = u0 + gu;
  const bool gate = tid < kR * U && j < H;
  auto load_x = [&](int t, int b0) {
    XIn v{0.f, 0.f, 0.f, 0.f};
    const int b = b0 + gr;
    if (gate && b < rb1) {
      const size_t row = static_cast<size_t>(t) * B + b;
      v.xr = __ldg(io.xp + row * H3 + j);
      v.xz = __ldg(io.xp + row * H3 + H + j);
      v.xn = __ldg(io.xp + row * H3 + 2 * H + j);
      v.m = __ldg(mask + row);
    }
    return v;
  };
  // Staging item i of a step: pass i / nch's rows, chunk i % nch of the
  // columns of ys[t-1], into buffer i & 1 (zero past the rows or H); by
  // cp.async where the rows are 16-byte aligned, so that the next item's
  // copy runs during this item's product.
  const int npass = (rb1 - rb0 + kR - 1) / kR;
  const int items = npass * nch;
  auto stage = [&](const float* hprev, int i) {
    float* dst = st + (i & 1) * kR * KC;
    const int b0 = rb0 + (i / nch) * kR, c0 = (i % nch) * KC;
    const int rows = min(kR, rb1 - b0);
    if (vec) {
      for (int e = tid; e < kR * kc4; e += kThreads) {
        const int r = e / kc4;
        const int c = c0 + 4 * (e - r * kc4);
        const bool in = r < rows && c < H;
        cp_async16(dst + 4 * e,
                   in ? hprev + static_cast<size_t>(b0 + r) * H + c : hprev,
                   in);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < kR * KC; e += kThreads) {
        const int r = e / KC;
        const int c = c0 + e - r * KC;
        dst[e] = r < rows && c < H
                     ? __ldcg(hprev + static_cast<size_t>(b0 + r) * H + c)
                     : 0.f;
      }
    }
  };
  XIn pre = load_x(reverse ? T - 1 : 0, rb0);
  __syncthreads();

  // Step s runs time t (T-1-s with reverse); h_prev is ys at the previous
  // step's time, zero at s = 0.
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const size_t tb = static_cast<size_t>(t) * B;
    const float* hprev =
        s ? io.ys + (reverse ? tb + B : tb - B) * H : io.ys;
    if (s) stage(hprev, 0);
    for (int pass = 0; pass < npass; ++pass) {
      const int b0 = rb0 + pass * kR;
      const int rows = min(kR, rb1 - b0);
      const bool live = gate && gr < rows;
      const XIn x = pass == 0 ? pre : load_x(t, b0);
      // The item's own h_prev (this thread wrote it in the last step).
      const float h =
          live && s ? __ldcg(hprev + static_cast<size_t>(b0 + gr) * H + j)
                    : 0.f;
      float p[3] = {0.f, 0.f, 0.f};                       // h_prev Wh
      if (s) {
        float acc[N];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = 0.f;
        for (int ch = 0; ch < nch; ++ch) {
          const int i = pass * nch + ch;
          cp_async_wait_group<0>();
          // Item i is in, and every thread is done with buffer (i + 1) & 1.
          __syncthreads();
          if (i + 1 < items) stage(hprev, i + 1);
          const float4* s4 =
              reinterpret_cast<const float4*>(st + (i & 1) * kR * KC);
          const float4* w4 =
              reinterpret_cast<const float4*>(wres) + ch * kc4;
          for (int q = kw * 32 + lane; q < kc4; q += WPT * 32) {
            float4 hv[kTM];
#pragma unroll
            for (int r = 0; r < kTM; ++r) hv[r] = s4[(rt + r) * kc4 + q];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
#pragma unroll
              for (int u = 0; u < TN; ++u) {
                const float4 w = w4[(g * U + ut + u) * hc4 + q];
#pragma unroll
                for (int r = 0; r < kTM; ++r) {
                  float& a = acc[(r * TN + u) * 3 + g];
                  a = fmaf(hv[r].x, w.x, a);
                  a = fmaf(hv[r].y, w.y, a);
                  a = fmaf(hv[r].z, w.z, a);
                  a = fmaf(hv[r].w, w.w, a);
                }
              }
            }
          }
        }
        // Lane l ends with the three gates' sums of pair l / SPAN.
        reduce_scatter<N, 3, 16>(acc, lane);
        if (lane % SPAN == 0) {
          float* o = red + warp * N + (lane / SPAN) * 3;
          o[0] = acc[0];
          o[1] = acc[1];
          o[2] = acc[2];
        }
        __syncthreads();
        if (live) {
          const int tl = (gu / TN) * RT + gr / kTM;
          const int idx = ((gr % kTM) * TN + gu % TN) * 3;
#pragma unroll
          for (int w = 0; w < WPT; ++w) {
            const float* o = red + (tl * WPT + w) * N + idx;
            p[0] += o[0];
            p[1] += o[1];
            p[2] += o[2];
          }
        }
        // red is next written after the next item's barrier, or the
        // step's.
      }
      if (live) {
        const float rg_ = sigmoid(x.xr + p[0]);
        const float zg = sigmoid(x.xz + p[1]);
        const float ng = tanhf(x.xn + rg_ * p[2]);
        const float hn = (1.f - zg) * ng + zg * h;
        io.ys[(tb + b0 + gr) * H + j] = x.m * hn + (1.f - x.m) * h;
      }
    }
    if (s + 1 == T) break;
    pre = load_x(reverse ? t - 1 : t + 1, rb0);   // loaded across the barrier
    group_sync(gbar, s + 1, UG);            // the row group's ys[t] is out
  }
}

template <int U>
int launch_bidir(const BidirDir& d0, const BidirDir& d1, const float* mask,
                 unsigned* bar, int T, int B, int H, int RG, int KC,
                 int reverse, int ndir, cudaStream_t stream) {
  BidirDir a = d0, b = d1;
  void* args[] = {&a, &b, &mask, &bar, &T, &B, &H, &RG, &KC, &reverse};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_f32_kernel<U>),
      ndir * RG * ((H + U - 1) / U), bidir_smem_bytes(H, U, KC), args,
      stream);
}

}  // namespace

// The f32 recurrence's dynamic shared memory a block at (H, U, KC).
extern "C" long long tpuasr_gru_bidir_fwd_smem(int H, int U, int KC) {
  return static_cast<long long>(bidir_smem_bytes(H, U, KC));
}

// The f32 recurrence over ndir directions (1 or 2) with the plan (U, RG,
// KC, smem) of ops/gru.py::_bidir_f32_plan (K7) or _f32_rec_plan (K5, K2
// in f32; one direction): direction d reads xp<d> (T, B, 3H) and wh<d>
// (H, 3H) and writes ys<d> (T, B, H), all f32 and contiguous, the second
// set read only with ndir = 2; mask (T, B) f32; reverse: every direction
// scans from t = T-1 down (K5's reverse; K7 passes 0); bar: ndir * RG
// zeroed uint32 words. A plan the kernel does not lay out the same way is
// refused.
extern "C" int tpuasr_gru_bidir_fwd(const float* xp0, const float* wh0,
                                    float* ys0, const float* xp1,
                                    const float* wh1, float* ys1,
                                    const float* mask, unsigned* bar, int T,
                                    int B, int H, int U, int RG, int KC,
                                    int reverse, int ndir, long long smem,
                                    cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (ndir < 1 || ndir > 2 || RG < 1 || KC <= 0 || KC % 128 ||
      smem != tpuasr_gru_bidir_fwd_smem(H, U, KC))
    return static_cast<int>(cudaErrorInvalidValue);
  const BidirDir d0{xp0, wh0, ys0};
  const BidirDir d1{xp1, wh1, ys1};
#define TPUASR_BIDIR(N)                                                       \
  launch_bidir<N>(d0, d1, mask, bar, T, B, H, RG, KC, reverse, ndir, stream)
  TPUASR_BY_UNITS(TPUASR_BIDIR)
#undef TPUASR_BIDIR
}

#undef TPUASR_BY_UNITS
