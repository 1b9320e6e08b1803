// Masked GRU scan with the input projection inside the kernel (forward).
//
// Replaces two Pallas kernels of tpuasr/ops/pallas_gru.py:
//   K2  _fwd_xf_kernel, built by _build_fwd_xf (pallas_call at line 615),
//       the forward of gru_scan_xfused (bf16 or f32 streams);
//   K4  _fwd_xf_q8_kernel, built by _build_fwd_xf_q8 (line 1020), the
//       forward of gru_scan_xfused_q8: x quantized per row to int8, an exact
//       int8 x int8 -> int32 projection, dequantized as acc*sx*sw + b; with
//       rec_q8 the hidden state is quantized per step and the recurrence runs
//       in int8 too.
// One template serves both: kMode 0 is K2, 1 is K4, 2 is K4 with rec_q8.
//
// Gate math (pallas_gru.py:70-74, gate order r, z, n, bias only on the
// input side):
//   r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z),
//   n = tanh(xp_n + r * hp_n), h' = (1 - z) * n + z * h,
//   h = m * h' + (1 - m) * h   (padding freezes the state).
// h is carried in fp32; the recurrent matmul sees h cast to the weights'
// type (bf16 when the weights are bf16), as the Pallas kernel does.
//
// What bounds it on the H100: the weights. Each step reads all of Wx
// (D x 3H) and Wh (H x 3H) -- 4.7 MB in bf16 at D=1024, H=512, half that
// in int8 -- to advance kRows batch rows, and 499 steps run in sequence.
// Neither matrix fits the 227 KB of shared memory, so this first version
// streams both from L2 every step, and the bytes each SM can pull from L2
// bound it; keeping the weights on chip (split over a cluster of SMs, or as
// int8 in shared memory with tensor-core products) is the next step.
//
// Design: the recurrence is independent per batch row, so each block owns
// kRows rows for all T steps and needs no grid-wide sync. Each thread owns
// hidden units u and computes all three gate columns (u, H+u, 2H+u) of both
// products for the block's rows, so every weight it loads feeds kRows FMAs
// and the gate math runs in registers. The wrapper packs the three gate
// weights of each (contraction index, unit) pair into one vector
// [r, z, n, 0] -- 8 bytes in bf16, 16 in fp32 or in int8 words -- so one
// load fetches all three, and the staged x rows and h are read from shared
// memory 16 bytes at a time. int8 operands are packed four along the
// contraction axis per 32-bit word and multiplied with __dp4a, an exact
// int32 accumulation. reverse walks t from T-1 down on left-aligned ragged
// rows: the trailing padding is masked, so no reversal gather is needed.
//
// Rounding: the dequantization, the quantizers (X / s then round half to
// even) and the gate arithmetic use __fmul_rn/__fadd_rn/__fdiv_rn and rintf
// so nvcc cannot contract them into FMAs: one ulp can flip a .5 rounding,
// and with rec_q8 the flip would propagate through the recurrence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // batch rows per block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// Padded widths shared by the kernel and its launcher: fp32 rows of n
// floats padded to 4, int8 rows of n values padded to 16 (4 words).
__host__ __device__ constexpr int f32_width(int n) { return round_up(n, 4); }
__host__ __device__ constexpr int q8_words(int n) { return round_up(n, 16) / 4; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One packed [r, z, n, 0] gate vector of the float weights.
template <typename XT> struct GateVec;
template <> struct GateVec<float> {
  using V = float4;
  static __device__ __forceinline__ void load(const V* p, float& r, float& z,
                                              float& n) {
    const float4 v = __ldg(p);
    r = v.x;
    z = v.y;
    n = v.z;
  }
};
template <> struct GateVec<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ void load(const V* p, float& r, float& z,
                                              float& n) {
    const uint2 v = __ldg(p);
    const __nv_bfloat162 rz = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 n0 = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    r = __low2float(rz);
    z = __high2float(rz);
    n = __low2float(n0);
  }
};

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// Per-row absmax over a [kRows][stride] fp32 tile (n valid columns) in
// shared memory, then the symmetric int8 quantization of
// quant.py::quantize_rows:
//   s = max(absmax, 1e-12) * (1/127), q = clip(round(X / s), -127, 127),
// packed four per word (element 4w + i in byte i) into q[kRows][nw], zero
// past n.
__device__ void quantize_rows(const float* src, int n, int stride, int nw,
                              int32_t* q, float* scale, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < kRows; ++r) {
    float a = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads)
      a = fmaxf(a, fabsf(src[r * stride + i]));
    for (int off = 16; off > 0; off >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    if (lane == 0) red[r * kWarps + warp] = a;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a = fmaxf(a, red[threadIdx.x * kWarps + w]);
    scale[threadIdx.x] = __fmul_rn(fmaxf(a, 1e-12f), kInv127);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * nw; idx += kThreads) {
    const int r = idx / nw;
    const int w = idx - r * nw;
    const float s = scale[r];
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * w + i;
      float v = 0.f;
      if (d < n) {
        v = rintf(__fdiv_rn(src[r * stride + d], s));
        v = fminf(fmaxf(v, -127.f), 127.f);
      }
      word |= (static_cast<uint32_t>(static_cast<int32_t>(v)) & 0xffu)
              << (8 * i);
    }
    q[r * nw + w] = static_cast<int32_t>(word);
  }
}

// acc[r][g] += sum_k a[r][k] * W[k][u][g] over fp32 rows a[kRows][K4]
// (K4 a multiple of 4, zero past the data) and packed gate vectors W[K4][H].
template <typename XT>
__device__ __forceinline__ void gates_f32(const float* a, int K4,
                                          const typename GateVec<XT>::V* W,
                                          int H, int u, float acc[kRows][3]) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const int n4 = K4 / 4;
  for (int k4 = 0; k4 < n4; ++k4) {
    float4 av[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = a4[r * n4 + k4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float w0, w1, w2;
      GateVec<XT>::load(W + static_cast<size_t>(4 * k4 + j) * H + u, w0, w1,
                        w2);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = reinterpret_cast<const float*>(&av[r])[j];
        acc[r][0] = fmaf(x, w0, acc[r][0]);
        acc[r][1] = fmaf(x, w1, acc[r][1]);
        acc[r][2] = fmaf(x, w2, acc[r][2]);
      }
    }
  }
}

// acc[r][g] += int8 dot products over packed words q[kRows][nw] (nw a
// multiple of 4) and packed gate word vectors W[nw][H] = [r, z, n, 0].
__device__ __forceinline__ void gates_q8(const int32_t* q, int nw,
                                         const int4* W, int H, int u,
                                         int32_t acc[kRows][3]) {
  const int4* q4 = reinterpret_cast<const int4*>(q);
  const int n4 = nw / 4;
  for (int w4 = 0; w4 < n4; ++w4) {
    int4 qv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) qv[r] = q4[r * n4 + w4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 wv = __ldg(W + static_cast<size_t>(4 * w4 + j) * H + u);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t x = reinterpret_cast<const int32_t*>(&qv[r])[j];
        acc[r][0] = __dp4a(x, wv.x, acc[r][0]);
        acc[r][1] = __dp4a(x, wv.y, acc[r][1]);
        acc[r][2] = __dp4a(x, wv.z, acc[r][2]);
      }
    }
  }
}

template <typename XT, int kMode>
__global__ void __launch_bounds__(kThreads)
gru_scan_kernel(const XT* __restrict__ x,          // (T, B, D)
                const void* __restrict__ wx_,      // packed, see launcher
                const float* __restrict__ bias,    // (3H,)
                const void* __restrict__ wh_,      // packed, see launcher
                const float* __restrict__ sw,      // (3H,) kMode >= 1
                const float* __restrict__ swh,     // (3H,) kMode == 2
                const float* __restrict__ mask,    // (T, B)
                XT* __restrict__ ys,               // (T, B, H)
                int T, int B, int D, int H, int reverse) {
  constexpr bool kQx = kMode >= 1;
  constexpr bool kQh = kMode == 2;
  using V = typename GateVec<XT>::V;
  const int Dp = f32_width(D);
  const int Hp = f32_width(H);
  const int nwx = q8_words(D);
  const int nwh = q8_words(H);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);           // [kRows][Dp]
  float* hcur = xs + kRows * Dp;                            // [kRows][Hp]
  float* hmm = hcur + kRows * Hp;                           // [kRows][Hp]
  int32_t* xq = reinterpret_cast<int32_t*>(hmm + kRows * Hp);  // [kRows][nwx]
  float* sx = reinterpret_cast<float*>(xq + kRows * nwx);   // [kRows]
  float* sh = sx + kRows;                                   // [kRows]
  float* red = sh + kRows;                                  // [kRows][kWarps]
  int32_t* hq = reinterpret_cast<int32_t*>(hmm);  // kQh: [kRows][nwh]

  const int b0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * Hp; i += kThreads) {
    hcur[i] = 0.f;
    hmm[i] = 0.f;
  }

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // Stage this step's x rows (fp32, zero past D) and the matmul copy of h.
    for (int i = threadIdx.x; i < kRows * Dp; i += kThreads) {
      const int r = i / Dp;
      const int d = i - r * Dp;
      const int b = b0 + r;
      xs[i] = b < B && d < D
                  ? to_f32(x[(static_cast<size_t>(t) * B + b) * D + d])
                  : 0.f;
    }
    if (!kQh) {
      for (int i = threadIdx.x; i < kRows * Hp; i += kThreads)
        hmm[i] = to_f32(from_f32<XT>(hcur[i]));
    }
    __syncthreads();
    if (kQx) quantize_rows(xs, D, Dp, nwx, xq, sx, red);
    if (kQh) quantize_rows(hcur, H, Hp, nwh, hq, sh, red);
    __syncthreads();

    for (int u = threadIdx.x; u < H; u += kThreads) {
      float xp[kRows][3], hp[kRows][3];
      if (kQx) {
        int32_t acc[kRows][3] = {};
        gates_q8(xq, nwx, static_cast<const int4*>(wx_), H, u, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xp[r][g] = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(acc[r][g]), sx[r]),
                          sw[g * H + u]),
                bias[g * H + u]);
      } else {
        float acc[kRows][3] = {};
        gates_f32<XT>(xs, Dp, static_cast<const V*>(wx_), H, u, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xp[r][g] = __fadd_rn(acc[r][g], bias[g * H + u]);
      }

      if (kQh) {
        int32_t acc[kRows][3] = {};
        gates_q8(hq, nwh, static_cast<const int4*>(wh_), H, u, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            hp[r][g] = __fmul_rn(__fmul_rn(__int2float_rn(acc[r][g]), sh[r]),
                                 swh[g * H + u]);
      } else {
        float acc[kRows][3] = {};
        gates_f32<XT>(hmm, Hp, static_cast<const V*>(wh_), H, u, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g) hp[r][g] = acc[r][g];
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const float rg = sigmoid_rn(__fadd_rn(xp[r][0], hp[r][0]));
        const float zg = sigmoid_rn(__fadd_rn(xp[r][1], hp[r][1]));
        const float ng = tanhf(__fadd_rn(xp[r][2], __fmul_rn(rg, hp[r][2])));
        const float h = hcur[r * Hp + u];
        const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zg), ng),
                                   __fmul_rn(zg, h));
        const float m = mask[static_cast<size_t>(t) * B + b];
        const float h2 = __fadd_rn(__fmul_rn(m, hn),
                                   __fmul_rn(__fsub_rn(1.f, m), h));
        hcur[r * Hp + u] = h2;
        ys[(static_cast<size_t>(t) * B + b) * H + u] = from_f32<XT>(h2);
      }
    }
    __syncthreads();
  }
}

template <typename XT, int kMode>
int launch(const void* x, const void* wx, const float* b, const void* wh,
           const float* sw, const float* swh, const float* mask, void* ys,
           int T, int B, int D, int H, int reverse, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * f32_width(D) +
                       2 * kRows * f32_width(H) + kRows * q8_words(D) +
                       2 * kRows + kRows * kWarps);
  auto kernel = gru_scan_kernel<XT, kMode>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (B + kRows - 1) / kRows;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), wx, b, wh, sw, swh, mask,
      static_cast<XT*>(ys), T, B, D, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 = K2, 1 = K4, 2 = K4 with rec_q8; x_bf16 selects bf16 or fp32
// streams (x, ys, and the float weights). Weight layouts (ops/gru.py packs
// them): float weights (K, 3H) become (round_up(K, 4), H, 4) in the stream
// type, int8 weights become (round_up(K, 16) / 4, H, 4) int32 words, each
// [r, z, n, 0] and zero past K.
extern "C" int tpuasr_gru_scan(int mode, int x_bf16, const void* x,
                               const void* wx, const float* b, const void* wh,
                               const float* sw, const float* swh,
                               const float* mask, void* ys, int T, int B,
                               int D, int H, int reverse,
                               cudaStream_t stream) {
#define TPUASR_GRU_LAUNCH(XT, M)                                            \
  return launch<XT, M>(x, wx, b, wh, sw, swh, mask, ys, T, B, D, H, reverse, \
                       stream)
  if (x_bf16) {
    if (mode == 0) TPUASR_GRU_LAUNCH(__nv_bfloat16, 0);
    if (mode == 1) TPUASR_GRU_LAUNCH(__nv_bfloat16, 1);
    if (mode == 2) TPUASR_GRU_LAUNCH(__nv_bfloat16, 2);
  } else {
    if (mode == 0) TPUASR_GRU_LAUNCH(float, 0);
    if (mode == 1) TPUASR_GRU_LAUNCH(float, 1);
    if (mode == 2) TPUASR_GRU_LAUNCH(float, 2);
  }
#undef TPUASR_GRU_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
