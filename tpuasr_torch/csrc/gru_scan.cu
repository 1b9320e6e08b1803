// Masked GRU scan with the input projection (forward), in two launches.
//
// Replaces two Pallas kernels of tpuasr/ops/pallas_gru.py:
//   K2  _fwd_xf_kernel (line 579), built by _build_fwd_xf (pallas_call at
//       line 615), the forward of gru_scan_xfused (bf16 or f32 streams);
//   K4  _fwd_xf_q8_kernel (line 974), built by _build_fwd_xf_q8 (line
//       1020), the forward of gru_scan_xfused_q8: x quantized per row to
//       int8, an exact int8 x int8 -> int32 projection, dequantized as
//       acc*sx*sw + b; with rec_q8 the hidden state is quantized per step and
//       the recurrence runs in int8 too;
// and, with its recurrence only, the bf16 forward of K7 (_bidir_fwd_kernel,
// line 319, pallas_call at line 406): both directions of a BiGRU over
// their precomputed bf16 projections in one cooperative launch, the
// directions' blocks side by side in the grid (csrc/gru_bidir.cu keeps
// K7's f32 forward and K7b).
//
// Gate math (pallas_gru.py:70-74, gate order r, z, n, bias only on the
// input side):
//   r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z),
//   n = tanh(xp_n + r * hp_n), h' = (1 - z) * n + z * h,
//   h = m * h' + (1 - m) * h   (padding freezes the state).
// h is carried in f32; the recurrent product sees h cast to the weights'
// type (bf16 when the weights are bf16), as the Pallas kernel does.
//
// What bounds it on the H100: the sequence of T steps, each a barrier and
// the staging of the whole previous state h (of the block's rows) into
// every block that shares the step -- not the weights' bytes, which stay
// on chip. At serving shapes (T=499, B=128, D=1024, H=512) the work is
// 3.0e11 flops, 0.3 ms at the bf16 tensor-core peak; two thirds of it,
// x @ Wx, does not depend on h.
//
// Design: two launches.
//   1. The projection xp = x @ Wx + b for all T*B rows, off the sequential
//      path, as a tiled product over the whole card written to device memory
//      in f32 (JAX's preferred_element_type): bf16 on mma.sync m16n8k16 with
//      f32 sums; int8 after a row-quantize pass (quant.py::quantize_rows bit
//      for bit) on mma.sync m16n8k32 s8 with exact int32 sums, dequantized
//      in the Pallas order; f32 on the FMA units (never TF32). Weights come
//      packed as the tiles want them: W^T (np, kp) for the mma paths, W
//      (kp, np) for f32, zero-padded (ops/gru.py).
//   2. The recurrence as a cooperative grid of row groups times unit
//      groups: block (rg, ug) owns U hidden units for the rows of group rg
//      and keeps its units' 3U columns of Wh in shared memory for all T
//      steps. Rows never meet rows of another group, so a row group has a
//      barrier of its own, one a step. Each step a block stages the
//      previous state of its rows (R <= 128 a pass, cp.async: other blocks
//      wrote them), multiplies on mma.sync (16 warps: R/16 row tiles times
//      256/R slices of the contraction, summed in a fixed order) and runs
//      the gates for its (row, unit) pairs, two a thread at most. bf16: the
//      operand is h rounded to bf16, which is ys[t_prev] itself, so the
//      step copies rows of ys; the f32 state a block carries for its own
//      units lives in a (B, H) f32 buffer that no other block reads.
//      rec_q8: the operand is h quantized per row, and a row's scale needs
//      every unit's |h|. Each block folds its units' max |h| per row into a
//      (B,) absmax with an atomic max (exact in any order); after a first
//      barrier each block quantizes its own units with that scale as
//      quant.py::quantize_rows does, into a (B, H) int8 buffer; after a
//      second barrier the step stages int8 rows, 1 byte a value, and every
//      block derives the same scales from the same absmax. (Quantizing the
//      whole state in every block instead, after one barrier, made a step
//      about three times as long: PERF.md.)
//      f32 (K2 in float32, training): the second launch is csrc/
//      gru_bidir.cu's row-grouped recurrence at one direction
//      (tpuasr_gru_bidir_fwd, launched by ops/gru.py), not this kernel.
//   The staging is per block, so the plan (ops/gru.py::_scan_plan) splits
//   the rows over as many row groups as the SMs allow: at the served layer
//   4 groups of 32 rows times 32 groups of 16 units, 128 blocks, against
//   one group of all 128 rows in 64 blocks of 8 units
//   (tools/gru_scan_parts.py times both); K7's two directions share the
//   SMs, 2 x 2 row groups of 64 rows x 32 unit groups. The plan's U, R,
//   row groups and shared memory are checked here before the launch.
//
// Rounding: the dequantization, the quantizers (X / s then round half to
// even) and the gate arithmetic use __fmul_rn/__fadd_rn/__fdiv_rn and rintf
// so nvcc cannot contract them into FMAs: one ulp can flip a .5 rounding,
// and with rec_q8 the flip would propagate through the recurrence.
#include "gru_coop.cuh"

namespace {

constexpr int kPT = 256;          // projection threads: 8 warps
constexpr int kBM = 128;          // projection tile rows
constexpr int kBN = 128;          // projection tile columns
constexpr int kBKB = 64;          // bytes of the contraction per stage
constexpr int kLdP = kBKB + 16;   // its shared row stride: 20 words
constexpr int kStages = 4;        // projection stages in flight
constexpr int kStageBytes = 2 * kBM * kLdP;   // A's and W^T's tiles
constexpr int kQV = 34;           // row values per lane: D <= 1088
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// quant.py::quantize_rows on one value: clip(round(v / s), -127, 127),
// rounding the IEEE quotient half to even, at the cost of a multiply (as
// csrc/conv_q8.cu): y = v * inv (inv = 1 / s correctly rounded) is within
// 1.2e-7 |y| of v / s, so the two round to the same integer unless y lies
// within 4e-5 of a half-integer (|y| <= 127 here); there the quotient
// itself decides.
__device__ __forceinline__ signed char quantize(float v, float s,
                                                float inv) {
  const float y = __fmul_rn(v, inv);
  float q = rintf(y);
  if (fabsf(y - q) >= 0.5f - 4e-5f) q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(q));
}

// ---- tensor-core products on 32-byte steps of the contraction -----------
// Tiles are row-major in shared memory, k contiguous (A: [m][k], B:
// [n][k]), with a row stride of 4 mod 8 words so that a fragment load hits
// 32 different banks. A step of 32 bytes is k16 in bf16 and k32 in int8,
// and both fragments read the same words: lane (g, c) = (lane / 4, lane %
// 4) takes word c and c + 4 of rows g and g + 8 (A) or of row g (B).

template <bool kQ> struct Mma;
template <> struct Mma<false> {   // bf16 x bf16 -> f32
  using Acc = float;
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    mma_bf16(d, a, b);
  }
};
template <> struct Mma<true> {    // s8 x s8 -> s32, exact
  using Acc = int;
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void load_a(uint32_t* a, const unsigned char* t,
                                       int ld, int row0, int ks, int lane) {
  const unsigned char* p = t + (row0 + (lane >> 2)) * ld + ks * 32;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(p) + (lane & 3);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(p + 8 * ld) +
                       (lane & 3);
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

__device__ __forceinline__ void load_b(uint32_t* b, const unsigned char* t,
                                       int ld, int n0, int ks, int lane) {
  const uint32_t* r = reinterpret_cast<const uint32_t*>(
                          t + (n0 + (lane >> 2)) * ld + ks * 32) +
                      (lane & 3);
  b[0] = r[0];
  b[1] = r[4];
}

// ldmatrix_x4 (gru_coop.cuh) gives an A fragment or two B fragments of the
// 32-byte step layout above.


// ---- 1. the projection ----------------------------------------------------

// Per-row int8 quantization of x (M, D) f32 or bf16 (rows lda apart),
// one warp a row:
// sx[m] = max(absmax, 1e-12) * (1/127), xq[m] = clip(round(x / sx)),
// zero from D to kp.
template <typename XT>
__global__ void __launch_bounds__(kPT)
quantize_rows_kernel(const XT* __restrict__ x, int lda,
                     signed char* __restrict__ xq, float* __restrict__ sx,
                     int M, int D, int kp) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kPT / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const XT* row = x + static_cast<size_t>(m) * lda;
  float v[kQV];
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kQV; ++i) {
    const int k = lane + 32 * i;
    v[i] = k < D ? to_f32(row[k]) : 0.f;
    a = fmaxf(a, fabsf(v[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  const float s = __fmul_rn(fmaxf(a, 1e-12f), kInv127);
  const float inv = __frcp_rn(s);
  if (lane == 0) sx[m] = s;
  signed char* dst = xq + static_cast<size_t>(m) * kp;
#pragma unroll
  for (int i = 0; i < kQV; ++i) {
    const int k = lane + 32 * i;
    if (k < kp) dst[k] = k < D ? quantize(v[i], s, inv) : 0;
  }
}

// xp (M, N) = x (M, D) @ W + b on the FMA units, f32 sums in k order.
// x's rows are lda apart and 16-byte aligned; W comes as (kp, np),
// zero-padded (kp a multiple of 8, np of 128). A
// 128 x 128 tile per block, 8 x 8 outputs per thread, double-buffered
// through shared memory 8 contraction indices at a time.
__global__ void __launch_bounds__(kPT)
proj_f32_kernel(const float* __restrict__ x, int lda,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ xp, int M, int D, int N, int kp, int np) {
  __shared__ __align__(16) float As[2][8][kBM + 4];   // [k][m]
  __shared__ __align__(16) float Bs[2][8][kBN];       // [k][n]
  const int ntn = np / kBN;
  const int n0 = (blockIdx.x % ntn) * kBN;
  const int m0 = (blockIdx.x / ntn) * kBM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ar = tid >> 1, ak = (tid & 1) * 4;        // A: row, 4 k's
  const int bk = tid >> 5, bn = (tid & 31) * 4;       // B: k, 4 n's
  const int am = m0 + ar;
  float4 ra, rb;
  auto load = [&](int k0) {
    const int k = k0 + ak;
    if (am < M && k + 4 <= D) {
      ra = __ldg(reinterpret_cast<const float4*>(
          x + static_cast<size_t>(am) * lda + k));
    } else {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = am < M && k + i < D
                   ? __ldg(x + static_cast<size_t>(am) * lda + k + i) : 0.f;
      ra = make_float4(e[0], e[1], e[2], e[3]);
    }
    rb = __ldg(reinterpret_cast<const float4*>(
        w + static_cast<size_t>(k0 + bk) * np + n0 + bn));
  };
  auto store = [&](int buf) {
    As[buf][ak][ar] = ra.x;
    As[buf][ak + 1][ar] = ra.y;
    As[buf][ak + 2][ar] = ra.z;
    As[buf][ak + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = rb;
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = kp / 8;
  load(0);
  store(0);
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    if (kb + 1 < nk) load((kb + 1) * 8);
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
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N)
        xp[static_cast<size_t>(m) * N + n] = __fadd_rn(acc[i][j], bias[n]);
    }
  }
}

// xp (M, N) = A (M, K) @ W + b on the tensor cores: bf16 with f32 sums, or
// int8 with exact int32 sums dequantized as (acc * sx[m]) * sw[n] + b[n].
// A rows are lda_bytes apart, 16-byte aligned, with d_bytes of data (the
// 16-byte pieces past them read as zeros); W comes as W^T (np, kp_bytes),
// zero-padded. A 128 x 128 tile per block, 8 warps of 64 x 32 (4 x 4 mma
// tiles); 64 bytes of the contraction a stage, kStages stages in flight by
// cp.async, fragments by ldmatrix.
template <bool kQ>
__global__ void __launch_bounds__(kPT)
proj_mma_kernel(const unsigned char* __restrict__ a, int lda_bytes,
                int d_bytes, const unsigned char* __restrict__ w,
                int kp_bytes, const float* __restrict__ bias,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ xp, int M, int N, int np) {
  using Acc = typename Mma<kQ>::Acc;
  extern __shared__ __align__(16) unsigned char psm[];  // [kStages][A|W^T]
  const int ntn = np / kBN;
  const int n0 = (blockIdx.x % ntn) * kBN;
  const int m0 = (blockIdx.x / ntn) * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int nkb = kp_bytes / kBKB;
  // Stage st <- contraction bytes kb*64 .. of A's and W^T's tile rows:
  // two 16-byte pieces of each a thread.
  auto load = [&](int st, int kb) {
    unsigned char* As = psm + st * kStageBytes;
    unsigned char* Bs = As + kBM * kLdP;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kPT;
      const int r = id >> 2, o = (id & 3) * 16, off = kb * kBKB + o;
      const bool ok = m0 + r < M && off < d_bytes;
      cp_async16(As + r * kLdP + o,
                 ok ? a + static_cast<size_t>(m0 + r) * lda_bytes + off : a,
                 ok);
      cp_async16(Bs + r * kLdP + o,
                 w + static_cast<size_t>(n0 + r) * kp_bytes + off, true);
    }
  };
  Acc c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkb) load(st, st);
    cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait_group<kStages - 2>();
    __syncthreads();                  // stage kb in; stage kb - 1 consumed
    if (kb + kStages - 1 < nkb) load((kb + kStages - 1) % kStages,
                                     kb + kStages - 1);
    cp_async_commit();
    const unsigned char* As = psm + (kb % kStages) * kStageBytes;
    const unsigned char* Bs = As + kBM * kLdP;
#pragma unroll
    for (int ks = 0; ks < kBKB / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], As + (wm + 16 * i + (lane & 15)) * kLdP + ks * 32 +
                               (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t t[4];
        ldmatrix_x4(t, Bs + (wn + 16 * j + (lane & 7) + (lane >> 4) * 8) *
                                kLdP + ks * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * j][0] = t[0];
        bf[2 * j][1] = t[1];
        bf[2 * j + 1][0] = t[2];
        bf[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<kQ>::run(c[i][j], af[i], bf[j]);
    }
  }
  // Each lane holds two neighbouring columns: one 8-byte store where N is
  // even (a row's four lanes then fill a 32-byte sector).
  const int g = lane >> 2, cc = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + 16 * i + g + 8 * half;
      if (m >= M) continue;
      float* out = xp + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * cc;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Acc a = c[i][j][2 * half + e];
          const int ne = min(n + e, N - 1);
          if constexpr (kQ)
            v[e] = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(a), sx[m]), sw[ne]),
                bias[ne]);
          else
            v[e] = __fadd_rn(a, bias[ne]);
        }
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v[0], v[1]);
        } else {
          if (n < N) out[n] = v[0];
          if (n + 1 < N) out[n + 1] = v[1];
        }
      }
    }
}

// ---- 2. the recurrence ----------------------------------------------------

constexpr int kGI = 2;            // gate items (row, unit) a thread at most

// Rows b0 .. b0+R-1 of a row-major array of row_bytes rows that other
// blocks wrote, into dst rows ld bytes apart; rows from b_end on become
// zeros. Rows of whole 16-byte pieces go by cp.async, all in flight at
// once, and the caller waits with cp_async_wait(); other rows (bf16 rows
// with H % 8 != 0) go through registers, 2-byte elements loaded with
// __ldcg, eight in flight per thread.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int ld,
                                          const void* src, int row_bytes,
                                          int b0, int b_end, int R) {
  const unsigned char* s0 =
      static_cast<const unsigned char*>(src) +
      static_cast<size_t>(b0) * row_bytes;
  const int rows = min(R, b_end - b0);
  if (row_bytes % 16 == 0) {
    const int nch = row_bytes / 16, total = R * nch, have = rows * nch;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / nch;
      cp_async16(dst + r * ld + (i - r * nch) * 16,
                 s0 + static_cast<size_t>(i < have ? i : 0) * 16, i < have);
    }
    return;
  }
  constexpr int kBatch = 8;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s0);
  const int n = row_bytes / 2, total = R * n, have = rows * n;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    unsigned short v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      v[q] = i < have ? __ldcg(s16 + i) : 0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * kThreads + threadIdx.x;
      const int r = i / n;
      if (i < total)
        reinterpret_cast<unsigned short*>(dst + r * ld)[i - r * n] = v[q];
    }
  }
}

// A read-only value of xp widened to f32 (f32 for K2/K4, bf16 for K7).
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// rec_q8's scale of a row from its absmax, as quant.py::quantize_rows.
__device__ __forceinline__ float row_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, 1e-12f), kInv127);
}

__host__ __device__ constexpr int rec_ld(bool q8, int H) {
  return round_up(H * (q8 ? 1 : 2), 32) + 16;
}

// Shared memory of the mma recurrence: resident Wh [3U][ld], the operand
// tile [R][ld], the partial sums [256][3U] (16 warps, each an R/16-th of
// the rows times a 256/R-th of the contraction) and rec_q8's row scales
// [R].
size_t rec_smem_bytes(bool q8, int H, int U, int R) {
  return static_cast<size_t>(3 * U + R) * rec_ld(q8, H) +
         sizeof(float) * 256 * 3 * U + sizeof(float) * R;
}

// The recurrence on the tensor cores, over one direction (K2, K4) or two
// (K7's bf16 forward: both run forward in time under one mask, xpb from
// the per-row reversed input). xp (T, B, 3H), f32 from K2/K4's projection
// or bf16 (K7's stream type); wh packed (unit groups, 3U, ld - 16 bytes):
// unit group g's row q*U + u is Wh's column q*H + g*U + u (zero past H).
// hbuf starts with each direction's (B, H) f32 state of each block's own
// units. bf16 (!kQ): YT is bf16 and the operand is read from ys[t_prev].
// rec_q8 (kQ, one direction): hbuf then holds, 16-byte aligned, the rows'
// absmax (2, B) f32, zeroed before the launch, and the quantized state (B,
// round_up(H, 16)) int8. The grid is directions times RG row groups times
// the unit groups: block (d, rg, ug) runs direction d's units ug*U.. for
// the rows of group rg, ceil(B / RG) of them, staging R rows a pass (R * U
// <= kGI * kThreads gate items). Rows never meet rows of another group or
// direction, so each (direction, row group) has a barrier of its own.
template <bool kQ, typename XT, typename YT, int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_rec_kernel(const XT* __restrict__ xp0,      // (T, B, 3H) a direction
               const XT* __restrict__ xp1,
               const unsigned char* __restrict__ wh0,
               const unsigned char* __restrict__ wh1,
               const float* __restrict__ swh,   // (3H,) kQ
               const float* __restrict__ mask,  // (T, B)
               YT* __restrict__ ys0,            // (T, B, H) a direction
               YT* __restrict__ ys1,
               float* __restrict__ hbuf,
               unsigned* __restrict__ bar,      // (dirs, RG) arrivals, 0
               int T, int B, int H, int reverse, int R, int RG) {
  using Acc = typename Mma<kQ>::Acc;
  constexpr int NB = 3 * U;                 // the block's columns
  constexpr int NT = NB / 8;                // n8 tiles
  const int ld = rec_ld(kQ, H);
  const int nks = (ld - 16) / 32;           // 32-byte contraction steps
  const int hq = round_up(H, 16);           // kQ: bytes of a quantized row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wres = smem;                               // [NB][ld]
  unsigned char* tile = wres + NB * ld;                     // [R][ld]
  Acc* red = reinterpret_cast<Acc*>(tile + R * ld);         // [256][NB]
  float* sh = reinterpret_cast<float*>(red + 256 * NB);     // [R] kQ
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int UG = (H + U - 1) / U;
  const int d = blockIdx.x / (RG * UG), rest = blockIdx.x % (RG * UG);
  const int ug = rest % UG, rg = rest / UG;
  const int u0 = ug * U;
  const int rpg = (B + RG - 1) / RG;                        // rows a group
  const int rb0 = min(B, rg * rpg), rb1 = min(B, rb0 + rpg);
  unsigned* gbar = bar + d * RG + rg;   // the row group's own barrier
  const XT* xp = d ? xp1 : xp0;
  const unsigned char* wh = d ? wh1 : wh0;
  YT* ys = d ? ys1 : ys0;
  hbuf += static_cast<size_t>(d) * B * H;
  {
    const int per_row = (ld - 16) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(wh) +
                       static_cast<size_t>(ug) * NB * per_row;
    for (int i = tid; i < NB * per_row; i += kThreads) {
      const int n = i / per_row;
      *reinterpret_cast<uint4*>(wres + n * ld + (i - n * per_row) * 16) =
          __ldg(src + i);
    }
    // The tile's columns past H must stay zero: Wh's are, and 0 * NaN is not.
    for (int i = tid; i < R * ld / 16; i += kThreads)
      reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // Product: warp (mt, kq) takes row tile mt and contraction slice kq.
  const int MT = R / 16, KS = 16 / MT;
  const int mt = warp % MT, kq = warp / MT;
  const int ks0 = kq * nks / KS, ks1 = (kq + 1) * nks / KS;
  const size_t BH = static_cast<size_t>(B) * H;
  const int H3 = 3 * H;
  float* amax = hbuf + (BH + 3) / 4 * 4;                    // kQ: (2, B)
  signed char* xq = reinterpret_cast<signed char*>(         // kQ: (B, hq)
      amax + (2 * static_cast<size_t>(B) + 3) / 4 * 4);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;     // previous step, scan order
    for (int b0 = rb0; b0 < rb1; b0 += R) {
      // Gate items: item i is (row i / U, unit i % U) of the pass; their
      // inputs are loaded before the product.
      float x0[kGI], x1[kGI], x2[kGI], m[kGI], h[kGI];
      float p0[kGI], p1[kGI], p2[kGI];          // h_prev @ Wh; zero at s=0
      bool live[kGI];
#pragma unroll
      for (int g = 0; g < kGI; ++g) {
        const int item = tid + g * kThreads;
        const int r = item / U, j = u0 + item % U, b = b0 + r;
        live[g] = item < R * U && j < H && b < rb1;
        x0[g] = x1[g] = x2[g] = m[g] = h[g] = 0.f;
        p0[g] = p1[g] = p2[g] = 0.f;
        if (live[g]) {
          const size_t row = static_cast<size_t>(t) * B + b;
          x0[g] = ldg_f32(xp + row * H3 + j);
          x1[g] = ldg_f32(xp + row * H3 + H + j);
          x2[g] = ldg_f32(xp + row * H3 + 2 * H + j);
          m[g] = __ldg(mask + row);
          if (s) h[g] = __ldcg(hbuf + static_cast<size_t>(b) * H + j);
        }
      }
      if (s) {
        if constexpr (kQ) {
          copy_rows(tile, ld, xq, hq, b0, rb1, R);
          if (tid < R && b0 + tid < rb1)
            sh[tid] = row_scale(__ldcg(amax + ((s + 1) & 1) * B + b0 + tid));
          cp_async_wait();
        } else {
          copy_rows(tile, ld, ys + static_cast<size_t>(tp) * BH, 2 * H, b0,
                    rb1, R);
          cp_async_wait();
        }
        __syncthreads();
        Acc c[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = 0;
        for (int ks = ks0; ks < ks1; ++ks) {
          uint32_t a[4];
          load_a(a, tile, ld, 16 * mt, ks, lane);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bb[2];
            load_b(bb, wres, ld, 8 * n, ks, lane);
            Mma<kQ>::run(c[n], a, bb);
          }
        }
        Acc* rp = red + (kq * R + 16 * mt + (lane >> 2)) * NB + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          rp[8 * n] = c[n][0];
          rp[8 * n + 1] = c[n][1];
          rp[8 * NB + 8 * n] = c[n][2];
          rp[8 * NB + 8 * n + 1] = c[n][3];
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < kGI; ++g) {
          if (!live[g]) continue;
          const int item = tid + g * kThreads;
          const int r = item / U, u = item % U, j = u0 + u;
          Acc q[3] = {0, 0, 0};
          for (int k = 0; k < KS; ++k) {
            const Acc* rr = red + (k * R + r) * NB + u;
            q[0] += rr[0];
            q[1] += rr[U];
            q[2] += rr[2 * U];
          }
          if constexpr (kQ) {
            const float sr = sh[r];
            p0[g] = __fmul_rn(__fmul_rn(__int2float_rn(q[0]), sr), swh[j]);
            p1[g] = __fmul_rn(__fmul_rn(__int2float_rn(q[1]), sr),
                              swh[H + j]);
            p2[g] = __fmul_rn(__fmul_rn(__int2float_rn(q[2]), sr),
                              swh[2 * H + j]);
          } else {
            p0[g] = q[0];
            p1[g] = q[1];
            p2[g] = q[2];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGI; ++g) {
        const int item = tid + g * kThreads;
        const int b = b0 + item / U, j = u0 + item % U;
        float h2 = 0.f;
        if (live[g]) {
          const float rg = sigmoid_rn(__fadd_rn(x0[g], p0[g]));
          const float zg = sigmoid_rn(__fadd_rn(x1[g], p1[g]));
          const float ng = tanhf(__fadd_rn(x2[g], __fmul_rn(rg, p2[g])));
          const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zg), ng),
                                     __fmul_rn(zg, h[g]));
          h2 = __fadd_rn(__fmul_rn(m[g], hn),
                         __fmul_rn(__fsub_rn(1.f, m[g]), h[g]));
          const size_t o = static_cast<size_t>(b) * H + j;
          ys[static_cast<size_t>(t) * BH + o] = from_f32<YT>(h2);
          hbuf[o] = h2;
        }
        if constexpr (kQ) {
          // The row's absmax: the max |h| over the block's units (U
          // neighbouring lanes) into amax[s & 1][b], an atomic max on the
          // float's bits (h >= 0 orders as an int). Exact in any order, so
          // every block reads the same absmax.
          float a = fabsf(h2);
#pragma unroll
          for (int off = U / 2; off > 0; off >>= 1)
            a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
          if (item % U == 0 && item < R * U && b < rb1)
            atomicMax(reinterpret_cast<int*>(amax + (s & 1) * B + b),
                      __float_as_int(a));
        }
      }
      if (s) __syncthreads();        // the tile, sums and scales are reused
    }
    if (s + 1 == T) break;
    if constexpr (kQ) {
      // rec_q8: once every row's absmax is in, each block quantizes its own
      // units of the new state; a second barrier then publishes the int8
      // state. amax[(s + 1) & 1] was last read in this step's staging:
      // it is zeroed here for the next step's maxima.
      group_sync(gbar, 2 * s + 1, UG);
      const float* am = amax + (s & 1) * B;
      for (int i = tid; i < (rb1 - rb0) * U; i += kThreads) {
        const int b = rb0 + i / U, j = u0 + i % U;
        if (j < H) {
          const size_t o = static_cast<size_t>(b) * H + j;
          const float sb = row_scale(__ldcg(am + b));
          xq[static_cast<size_t>(b) * hq + j] =
              quantize(__ldcg(hbuf + o), sb, __frcp_rn(sb));
        }
      }
      for (int b = rb0 + ug * kThreads + tid; b < rb1; b += UG * kThreads)
        amax[((s + 1) & 1) * B + b] = 0.f;
      group_sync(gbar, 2 * s + 2, UG);
    } else {
      group_sync(gbar, s + 1, UG);
    }
  }
}

template <bool kQ, typename XT, typename YT, int U>
int launch_rec(const void* xp0_, const void* xp1_, const void* wh0_,
               const void* wh1_, const float* swh, const float* mask,
               void* ys0_, void* ys1_, float* hbuf, unsigned* bar, int T,
               int B, int H, int reverse, int R, int RG, int ndir,
               cudaStream_t stream) {
  const XT* xp0 = static_cast<const XT*>(xp0_);
  const XT* xp1 = static_cast<const XT*>(xp1_);
  const unsigned char* wh0 = static_cast<const unsigned char*>(wh0_);
  const unsigned char* wh1 = static_cast<const unsigned char*>(wh1_);
  YT* ys0 = static_cast<YT*>(ys0_);
  YT* ys1 = static_cast<YT*>(ys1_);
  void* args[] = {&xp0, &xp1, &wh0, &wh1,    &swh, &mask, &ys0, &ys1, &hbuf,
                  &bar, &T,   &B,   &H,      &reverse, &R, &RG};
  return launch_cooperative(
      reinterpret_cast<const void*>(gru_rec_kernel<kQ, XT, YT, U>),
      ndir * RG * ((H + U - 1) / U), rec_smem_bytes(kQ, H, U, R), args,
      stream);
}

}  // namespace

// Kinds: 0 = f32, 1 = bf16, 2 = int8.

// xp (M, N) f32 = x (M, D) @ W + b. kind 0: x f32, w (kp, np) f32; kind 1:
// x bf16, w = W^T (np, kp) bf16; kind 2: x f32 or bf16 (x_bf16) quantized
// per row into xq (M, kp) int8 and sx (M,), w = W^T (np, kp) int8, sw (N,).
// kp and np are the plan's padded widths. x's rows are lda elements apart;
// for kinds 0 and 1 they are 16-byte aligned and readable up to
// round_up(D, 16 bytes) (ops/gru.py pads x where they are not).
extern "C" int tpuasr_gru_proj(int kind, int x_bf16, const void* x, int lda,
                               const void* w, const float* b, const float* sw,
                               signed char* xq, float* sx, float* xp, int M,
                               int D, int N, int kp, int np,
                               cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (np % kBN || kp <= 0 || kp < D || lda < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((M + kBM - 1) / kBM) * (np / kBN);
  constexpr int kMmaSmem = kStages * kStageBytes;
  if (kind == 0) {
    if (kp % 8 || lda % 4) return static_cast<int>(cudaErrorInvalidValue);
    proj_f32_kernel<<<grid, kPT, 0, stream>>>(
        static_cast<const float*>(x), lda, static_cast<const float*>(w), b,
        xp, M, D, N, kp, np);
  } else if (kind == 1) {
    if ((2 * kp) % kBKB || lda % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        proj_mma_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    proj_mma_kernel<false><<<grid, kPT, kMmaSmem, stream>>>(
        static_cast<const unsigned char*>(x), 2 * lda, 2 * D,
        static_cast<const unsigned char*>(w), 2 * kp, b, nullptr, nullptr, xp,
        M, N, np);
  } else if (kind == 2) {
    if (kp % kBKB || kp > 32 * kQV)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned qgrid =
        static_cast<unsigned>((M + kPT / 32 - 1) / (kPT / 32));
    if (x_bf16)
      quantize_rows_kernel<<<qgrid, kPT, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), lda, xq, sx, M, D, kp);
    else
      quantize_rows_kernel<<<qgrid, kPT, 0, stream>>>(
          static_cast<const float*>(x), lda, xq, sx, M, D, kp);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(proj_mma_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    proj_mma_kernel<true><<<grid, kPT, kMmaSmem, stream>>>(
        reinterpret_cast<const unsigned char*>(xq), kp, kp,
        static_cast<const unsigned char*>(w), kp, b, sx, sw, xp, M, N, np);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory the recurrence of a kind (1 or 2) lays out for
// (H, U, R).
extern "C" long long tpuasr_gru_rec_smem(int kind, int H, int U, int R) {
  if (kind != 1 && kind != 2) return -1;
  return static_cast<long long>(rec_smem_bytes(kind == 2, H, U, R));
}

// ys (T, B, H) from xp (T, B, 3H) and mask (T, B) with the plan (U, R, RG,
// smem) of ops/gru.py::_scan_plan, over ndir directions: block d of the
// grid's first dimension reads xp<d>, wh<d> and writes ys<d> (with one
// direction xp1, wh1, ys1 are not read). kind 1: xp f32 (K2) or
// bf16 (xp_bf16: K7, one or two directions), wh packed bf16, ys bf16; kind
// 2: xp f32, wh packed int8 with swh (3H,), ys f32 or bf16 (ys_bf16), one
// direction; hbuf: the scratch of ops/gru.py::_rec_scratch. bar: ndir * RG
// zeroed uint32 words. A plan the kernel does not lay out the same way is
// refused.
extern "C" int tpuasr_gru_rec(int kind, int ys_bf16, int xp_bf16,
                              const void* xp0, const void* xp1,
                              const void* wh0, const void* wh1,
                              const float* swh, const float* mask, void* ys0,
                              void* ys1, float* hbuf, unsigned* bar, int T,
                              int B, int H, int reverse, int U, int R, int RG,
                              int ndir, long long smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (RG < 1 || ndir < 1 || ndir > 2 ||
      smem != tpuasr_gru_rec_smem(kind, H, U, R) ||
      (xp_bf16 && kind != 1) || (ndir == 2 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R < 16 || R > 128 || (R & (R - 1)) || R * U > kGI * kThreads ||
      (kind == 1 && !ys_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
#define TPUASR_REC(Q, XT, YT)                                                 \
  switch (U) {                                                                \
    case 8: return launch_rec<Q, XT, YT, 8>(xp0, xp1, wh0, wh1, swh, mask,    \
                                            ys0, ys1, hbuf, bar, T, B, H,     \
                                            reverse, R, RG, ndir, stream);    \
    case 16: return launch_rec<Q, XT, YT, 16>(xp0, xp1, wh0, wh1, swh, mask,  \
                                              ys0, ys1, hbuf, bar, T, B, H,   \
                                              reverse, R, RG, ndir, stream);  \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }
  if (kind == 1 && xp_bf16) TPUASR_REC(false, __nv_bfloat16, __nv_bfloat16)
  if (kind == 1) TPUASR_REC(false, float, __nv_bfloat16)
  if (kind == 2 && ys_bf16) TPUASR_REC(true, float, __nv_bfloat16)
  if (kind == 2) TPUASR_REC(true, float, float)
#undef TPUASR_REC
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef TPUASR_BY_UNITS
