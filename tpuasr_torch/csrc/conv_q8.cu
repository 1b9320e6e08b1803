// int8 freq-Toeplitz tap-GEMM convolution over time (DeepSpeech's conv2 in
// the int8 serving arm).
//
// Replaces K9 of tpuasr/ops/pallas_conv.py: _make_im2col_kernel (line 52),
// built by _build_call (pallas_call at line 138), the "im2col" mode of
// conv_taps_q8. For each utterance b and output row i:
//   sx[i]   = max(max_{t < Kt} absmax(x[i + t, :]), 1e-12) * (1/127),
//   q[t, k] = clip(rint(x[i + t, k] / sx[i]), -127, 127)      (int8),
//   acc     = sum_t sum_k q[t, k] * mq[t, k, n]                (exact int32),
//   out     = (float(acc) * sx[i]) * sw[n]
// -- the order of the plain version (reference_q8_conv_taps, as JAX's
// oracle), every rounding written out (__fdiv_rn, rintf, __fmul_rn) so
// that nvcc contracts nothing. Kt * Kd * 127^2 < 2^31 (the wrapper checks),
// so the int32 sums are exact in any order.
//
// What bounds it on the H100: the int8 operations. At config 5 (B=128,
// T_out=499, Kt=11, Kd=1024, N=512) the GEMM is (63,872 x 11,264) @
// (11,264 x 512): 7.4e11 operations, 0.37 ms at the 1,979 TOPS int8 peak,
// against 0.12 ms for the 267 MB of f32 input and 131 MB of output.
//
// Design. The TPU kernel keeps a (T_BLK + Kt - 1, Kd) slab in VMEM and
// builds the (T_BLK, Kt * Kd) int8 im2col there; at T_BLK = 64 that is
// 720 KB, more than a block's shared memory. Here:
//   pass 1 (row_absmax_kernel): one warp per input row writes its absmax;
//   pass 2 (conv_q8_kernel): one block per (utterance, 128 output rows,
//   256 columns). It forms its rows' scales from the windowed max of pass
//   1's absmaxes, then walks the contraction in chunks of 64 and, inside
//   each chunk, the Kt taps. As the TPU kernel holds its slab across the
//   taps, the block holds the chunk's f32 slab of 128 + Kt - 1 input rows
//   in shared memory for all taps: tap t quantizes slab rows r + t with
//   OUTPUT row r's scale into a (128 x 64) int8 tile and multiplies it
//   with the (64 x 256) tile of the band matrix (stored column-major by
//   the wrapper, so a column's 64 bytes are contiguous) on the tensor
//   cores, mma.sync m16n8k32 s8 x s8 -> s32 (16 warps, 32 x 64 outputs
//   each). The next band-matrix tile, and the next chunk's slab, arrive by
//   cp.async one step ahead, in two stages. The sums stay in registers
//   across all taps and chunks; the epilogue dequantizes once. Column
//   tiles of one row tile are neighbours in the grid and read the same
//   slab from L2. Each input value is still quantized once per tap and
//   column tile (Kt * N / 256 times), so the quantizer multiplies by the
//   reciprocal and divides only near a rounding boundary.
//   Not yet: TMA, wgmma, one quantization shared by all column tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // output rows per block
constexpr int kBN = 256;               // output columns per block
constexpr int kKC = 64;                // contraction bytes per chunk
constexpr int kStride = kKC + 16;      // smem row stride (no bank conflicts)
constexpr int kThreads = 512;          // 16 warps: 4 along rows x 4 along N
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(256)
row_absmax_kernel(const float* __restrict__ x,   // (B, T_in, Kd)
                  float* __restrict__ rmax,      // (B, T_need)
                  int B, int T_in, int T_need, int Kd) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B * T_need) return;
  const int b = row / T_need;
  const int r = row - b * T_need;
  float m = 0.f;
  if (r < T_in) {
    const float4* p = reinterpret_cast<const float4*>(
        x + (static_cast<size_t>(b) * T_in + r) * Kd);
    for (int i = lane; i < Kd / 4; i += 32) {
      const float4 v = p[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) rmax[row] = m;
}

// x / sx rounded half to even and clipped to +-127, exactly as the plain
// version rounds the IEEE quotient, at the cost of a multiply: y = x * inv
// (inv = 1 / sx, correctly rounded) is within 1.2e-7 |y| of x / sx, so the
// two round to the same integer unless y lies within 4e-5 of a half-integer
// (|y| <= 127 here); there the quotient itself decides.
__device__ __forceinline__ int quant(float v, float sx, float inv) {
  const float y = __fmul_rn(v, inv);
  float q = rintf(y);
  if (fabsf(y - q) >= 0.5f - 4e-5f) q = rintf(__fdiv_rn(v, sx));
  return max(-127, min(127, __float2int_rn(q)));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

constexpr int kATileBytes = kBM * kStride;
constexpr int kBTileBytes = kBN * kStride;

// Shared memory for Kt taps: two stages of the f32 slab (the block's
// kBM + Kt - 1 input rows, one contraction chunk) and of the band-matrix
// tile, the int8 tile, and the rows' scales and their reciprocals.
size_t smem_bytes(int Kt) {
  return 2 * static_cast<size_t>(kBM + Kt - 1) * kKC * sizeof(float) +
         kATileBytes + 2 * kBTileBytes + 2 * kBM * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
conv_q8_kernel(const float* __restrict__ x,      // (B, T_in, Kd) f32
               const int8_t* __restrict__ mqt,   // (Kt, N, Kd) int8
               const float* __restrict__ sw,     // (N,)
               const float* __restrict__ rmax,   // (B, T_out + Kt - 1)
               float* __restrict__ out,          // (B, T_out, N)
               int T_in, int T_out, int Kt, int Kd, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slab_rows = kBM + Kt - 1;
  float* slab = reinterpret_cast<float*>(smem);     // [2][slab_rows][kKC]
  int8_t* Bs = reinterpret_cast<int8_t*>(slab + 2 * slab_rows * kKC);
  int8_t* As = Bs + 2 * kBTileBytes;                // [kBM][kStride]
  float* sx_s = reinterpret_cast<float*>(As + kATileBytes);
  float* inv_s = sx_s + kBM;

  const int n0 = blockIdx.x * kBN;
  const int i0 = blockIdx.y * kBM;
  const int b = blockIdx.z;
  const int T_need = T_out + Kt - 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                // mma groupID
  const int tig = lane & 3;               // thread in group
  const int wm = (warp >> 2) * 32;        // warp's first row in the tile
  const int wn = (warp & 3) * 64;         // warp's first column

  if (tid < kBM) {
    const int i = i0 + tid;
    float s = 1.f;
    if (i < T_out) {
      const float* rm = rmax + static_cast<size_t>(b) * T_need + i;
      float m = rm[0];
      for (int t = 1; t < Kt; ++t) m = fmaxf(m, rm[t]);
      s = __fmul_rn(fmaxf(m, 1e-12f), static_cast<float>(1.0 / 127.0));
    }
    sx_s[tid] = s;
    inv_s[tid] = __frcp_rn(s);
  }

  // The walk: contraction chunks kc outside, taps t inside, so that one
  // slab serves all Kt taps. Input rows past T_in are zeros.
  const int nkc = Kd / kKC;
  const float* xb = x + static_cast<size_t>(b) * T_in * Kd;
  auto load_slab = [&](int kci, int stage) {
    float* sl = slab + stage * slab_rows * kKC;
    for (int e = tid; e < slab_rows * (kKC / 4); e += kThreads) {
      const int j = e / (kKC / 4);
      const int c = (e - j * (kKC / 4)) * 4;
      const bool live = i0 + j < T_in;
      cp_async16(sl + j * kKC + c,
                 live ? xb + static_cast<size_t>(i0 + j) * Kd + kci * kKC + c
                      : xb,
                 live ? 16 : 0);
    }
  };
  auto load_b = [&](int it, int stage) {
    const int kci = it / Kt;
    const int t = it - kci * Kt;
    int8_t* bs = Bs + stage * kBTileBytes;
    for (int e = tid; e < kBN * (kKC / 16); e += kThreads) {
      const int n = e / (kKC / 16);
      const int c = (e - n * (kKC / 16)) * 16;
      const bool live = n0 + n < N;       // N % 256 == 128: a half tile
      cp_async16(bs + n * kStride + c,
                 live ? mqt + (static_cast<size_t>(t) * N + n0 + n) * Kd +
                            kci * kKC + c
                      : mqt,
                 live ? 16 : 0);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // One step ahead: the next band-matrix tile, and at each chunk's first
  // tap the next chunk's slab. wait_group 1 leaves only the newest group
  // (the next step's) in flight.
  const int n_it = nkc * Kt;
  load_slab(0, 0);
  load_b(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int kci = it / Kt;
    const int t = it - kci * Kt;
    __syncthreads();                      // step it - 1 is done
    if (it + 1 < n_it) {
      load_b(it + 1, (it + 1) & 1);
      if (t == 0 && kci + 1 < nkc) load_slab(kci + 1, (kci + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait_one();                  // this thread's copies for step it
    __syncthreads();                      // everyone's copies
    // Quantize slab rows r + t with OUTPUT row r's scale into As.
    const float* af = slab + ((kci & 1) * slab_rows + t) * kKC;
    for (int e = tid; e < kBM * (kKC / 4); e += kThreads) {
      const int r = e / (kKC / 4);
      const int c = (e - r * (kKC / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(af + r * kKC + c);
      const float s = sx_s[r], inv = inv_s[r];
      const unsigned packed =
          (quant(v.x, s, inv) & 0xff) | ((quant(v.y, s, inv) & 0xff) << 8) |
          ((quant(v.z, s, inv) & 0xff) << 16) |
          (static_cast<unsigned>(quant(v.w, s, inv) & 0xff) << 24);
      *reinterpret_cast<unsigned*>(As + r * kStride + c) = packed;
    }
    __syncthreads();
    const int8_t* bs = Bs + (it & 1) * kBTileBytes;
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 32) {
      unsigned af_[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* a = As + (wm + mi * 16 + g) * kStride + ks + tig * 4;
        af_[mi][0] = *reinterpret_cast<const unsigned*>(a);
        af_[mi][1] = *reinterpret_cast<const unsigned*>(a + 8 * kStride);
        af_[mi][2] = *reinterpret_cast<const unsigned*>(a + 16);
        af_[mi][3] = *reinterpret_cast<const unsigned*>(a + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = bs + (wn + ni * 8 + g) * kStride + ks + tig * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af_[mi], bf[ni]);
    }
  }

  // Epilogue: (acc * sx) * sw, rounded as the plain version rounds.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + mi * 16 + g + half * 8;
      const int i = i0 + r;
      if (i >= T_out) continue;
      const float s = sx_s[r];
      float* o = out + (static_cast<size_t>(b) * T_out + i) * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = n0 + wn + ni * 8 + tig * 2;
        if (n >= N) break;
        float2 v;
        v.x = __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][half * 2]),
                                  s), sw[n]);
        v.y = __fmul_rn(
            __fmul_rn(static_cast<float>(acc[mi][ni][half * 2 + 1]), s),
            sw[n + 1]);
        *reinterpret_cast<float2*>(o + n) = v;
      }
    }
  }
}

}  // namespace

// K9: out (B, T_out, N) f32 from x (B, T_in, Kd) f32, mqt (Kt, N, Kd) int8
// (the band matrices with each column's contraction contiguous), sw (N,)
// f32; rmax: (B, T_out + Kt - 1) f32 scratch. Kd % 64 == 0, N % 128 == 0,
// all contiguous. Rows of x past T_in count as zeros.
extern "C" int tpuasr_conv_q8(const float* x, const int8_t* mqt,
                              const float* sw, float* rmax, float* out,
                              int B, int T_in, int T_out, int Kt, int Kd,
                              int N, cudaStream_t stream) {
  if (B <= 0 || T_out <= 0 || N <= 0) return 0;
  if (Kd % kKC || N % 128 || Kt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T_need = T_out + Kt - 1;
  const int rows = B * T_need;
  row_absmax_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(x, rmax, B, T_in,
                                                        T_need, Kd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(Kt);
  err = cudaFuncSetAttribute(conv_q8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (T_out + kBM - 1) / kBM, B);
  conv_q8_kernel<<<grid, kThreads, smem, stream>>>(
      x, mqt, sw, rmax, out, T_in, T_out, Kt, Kd, N);
  return static_cast<int>(cudaGetLastError());
}
