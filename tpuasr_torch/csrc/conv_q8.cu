// int8 freq-Toeplitz tap-GEMM convolution over time (DeepSpeech's conv2 in
// the int8 serving arm).
//
// Replaces K9 of tpuasr/ops/pallas_conv.py, the pallas_call of _build_call
// (line 138) with each of its three bodies, the modes of conv_taps_q8:
// "im2col" (_make_im2col_kernel, line 52), and "taps" and "slab"
// (_make_kernel, lines 88-127). In the im2col mode, for each utterance b and
// output row i:
//   sx[i]   = max(max_{t < Kt} absmax(x[i + t, :]), 1e-12) * (1/127),
//   q[t, k] = clip(rint(x[i + t, k] / sx[i]), -127, 127)      (int8),
//   acc     = sum_t sum_k q[t, k] * mq[t, k, n]                (exact int32),
//   out     = (float(acc) * sx[i]) * sw[n]
// -- the order of the plain version (reference_q8_conv_taps, as JAX's
// oracle), every rounding written out (__fmul_rn, __fmaf_rn, __fadd_rn)
// so that nvcc contracts nothing. Kt * Kd * 127^2 < 2^31 (the wrapper
// checks), so the int32 sums are exact in any order.
//   taps (pallas_conv.py:114-124): each input row j has its own scale
//   sx[j] = max(absmax(x[j, :]), 1e-12) * (1/127); each tap's int32 product
//   is dequantized on its own, acc_f += float(acc_t) * sx[i + t] in tap
//   order, and out = acc_f * sw[n].
//   slab (pallas_conv.py:93-110): one scale for the slab of input rows
//   128 k .. 128 k + 127 + Kt - 1 that JAX's time block k reads, all taps
//   summed in int32, out = float(acc) * (sx * sw[n]) as Pallas rounds it.
//
// What bounds it on the H100: the int8 operations. At config 5 (B=128,
// T_out=499, Kt=11, Kd=1024, N=512) the GEMM is (63,872 x 11,264) @
// (11,264 x 512): 7.4e11 operations, 0.37 ms at the 1,979 TOPS int8 peak,
// against 0.12 ms for the 267 MB of f32 input and 131 MB of output. The
// band matrix (Kt * N * Kd = 5.8 MB) stays in L2 but every row tile reads
// it again: 256 operations per L2 byte at 128-row tiles, 128 at 64.
//
// Design. The TPU kernel keeps a (T_BLK + Kt - 1, Kd) slab in VMEM and
// builds the (T_BLK, Kt * Kd) int8 im2col there. Here the quantizing is
// taken off the products' path where the scale allows it:
//   taps and slab: a pre-pass quantizes the input once (taps: each row
//   with its own scale, (B, T_rm, Kd); slab: each time block's slab of
//   128 + Kt - 1 rows with the block's scale, (B, n_tb, 128 + Kt - 1, Kd),
//   the Kt - 1 rows shared by two blocks stored under both scales), so the
//   main loop is a pure int8 implicit GEMM that moves each input value as
//   1 byte. slab walks the contraction in chunks of 128 bytes and stages
//   one int8 slab of 128 + Kt - 1 rows a chunk; tap t reads it t rows on.
//   taps keeps its own walk, taps outside, so that each tap's sum is
//   dequantized as it completes; it stages the 128 rows of a (tap, chunk).
//   im2col: the scale is the OUTPUT row's windowed max, so an input value
//   takes another int8 value in each tap and cannot be quantized once. A
//   block covers 64 rows x all 512 columns, so each (row, tap, k) is
//   quantized once for every column: it stages a chunk's f32 slab of
//   64 + Kt - 1 rows and quantizes step j + 1's A tile on the FP32 units
//   while the tensor cores run step j.
// Each body: two warpgroups, each 64 rows x 256 (taps 128) columns of
// int32 sums in registers, on wgmma m64nNk32 s8 (asynchronous, operands
// read from shared memory: the band matrix in the 128-byte swizzled
// layout, A tiles plain or swizzled); a ring of band-matrix tiles (and
// taps' A tiles) in flight by cp.async; one barrier a 128-byte step. The
// epilogue dequantizes once (taps: once a tap). tools/conv_q8_parts.py
// times the parts (quantize, products, barriers) of each body. Not yet:
// TMA, a producer warp, products in flight across the barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps of 64 rows each
constexpr int kTB = 128;               // JAX's time block (slab's scale)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

enum Mode { kIm2col = 0, kTaps = 1, kSlab = 2 };

// A block's tile: BM output rows x BN columns over two warpgroups, each
// 64 rows x WGN columns of int32 sums in registers (WGM of them along the
// rows); KC = 128 contraction bytes a step; S steps of the band matrix (and
// of taps' A tiles) in the ring, as many as the shared memory holds beside
// the rest. im2col's block covers all 512 columns of conv2, so each
// quantized value serves every column (tools/conv_q8_parts.py times the
// 128 x 256 tile, which quantizes twice but reads the band matrix half as
// often).
template <int M>
struct Tile {
  static constexpr int BM = M == kIm2col ? 64 : 128;
  static constexpr int BN = M == kIm2col ? 512 : M == kTaps ? 128 : 256;
  static constexpr int WGM = BM / 64;          // warpgroups along the rows
  static constexpr int WGN = BN * WGM / 2;     // a warpgroup's columns
  static constexpr int NACC = WGN / 2;         // its sums a thread
  static constexpr int KC = 128;
  static constexpr int NC = KC / 16;           // 16-byte chunks a step
  static constexpr int LDF = KC * 4 + 16;      // im2col's f32 slab stride
  static constexpr int S = M == kIm2col ? (BN == 256 ? 3 : 2)
                           : M == kTaps ? 6 : 5;
};

__host__ __device__ constexpr size_t align256(size_t n) {
  return (n + 255) / 256 * 256;
}

// Rows of a scale array: the rows that JAX's time blocks' slabs cover.
__host__ __device__ constexpr int rows_covered(int T_out, int Kt) {
  return (T_out + kTB - 1) / kTB * kTB + Kt - 1;
}

// y rounded half to even on the FP32 units: adding 1.5 * 2^23 leaves the
// rounded integer in the low mantissa bits (exact for |y| < 2^22), so the
// low byte of the sum's bits is the int8 value. (rintf and the
// float-to-int conversions run at a sixteenth of the FP32 rate.)
constexpr float kRound = 12582912.f;
__device__ __forceinline__ float round_int(float y) {
  return __fadd_rn(y, kRound);
}

// The low bytes of four such sums, lowest address first.
__device__ __forceinline__ unsigned pack4(float a, float b, float c,
                                          float d) {
  return __byte_perm(__byte_perm(__float_as_uint(a), __float_as_uint(b),
                                 0x0040),
                     __byte_perm(__float_as_uint(c), __float_as_uint(d),
                                 0x0040),
                     0x5410);
}

// 4 * W values v / sx rounded half to even and clipped to +-127, as the
// plain version rounds the IEEE quotient (quant.py::quantize_rows), into W
// words of 4 bytes, lowest address first. The quotient comes without a
// division: with inv = 1 / sx correctly rounded and q = v * inv (within an
// ulp of v / sx), q + (v - q * sx) * inv in two fused steps is v / sx
// correctly rounded (Markstein's correction, the last two steps of the
// card's own division) for every v and sx here: no overflow, and where sx
// is tiny (an all-zero window) v is 0. The clip never acts: sx is the
// absmax of rows that hold v, times 1/127, so |v / sx| <= 127 * (1 + 2^-23)
// and rounds to at most 127.
template <int W>
__device__ __forceinline__ void quant_words(const float4* p, float sx,
                                            float inv, unsigned* w) {
  float t[4 * W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float4 f = p[k];
    const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = __fmul_rn(v[e], inv);
      t[4 * k + e] = round_int(__fmaf_rn(__fmaf_rn(-q, sx, v[e]), inv, q));
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k)
    w[k] = pack4(t[4 * k], t[4 * k + 1], t[4 * k + 2], t[4 * k + 3]);
}

__device__ __forceinline__ float row_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, 1e-12f), kInv127);
}

// The shared-memory matrix descriptor of wgmma for a K-major tile: its
// start, the byte offsets of neighbouring core matrices along K (lbo) and
// of neighbouring 8-row groups (sbo), and the swizzle mode (0 none, 1 for
// 128-byte rows).
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo, unsigned mode) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(mode) << 62;
}

// Two layouts of a K-major int8 tile in shared memory for wgmma:
// - swizzled: rows of 128 bytes, 16-byte chunk c of row n at chunk
//   c ^ (n % 8) of the row, the hardware's 128-byte swizzle; the tile
//   starts 1024-byte aligned. A warp copies whole rows from global memory
//   and stores them without bank conflicts. Descriptor: lbo unused, sbo =
//   8 rows (1024 bytes), mode 1.
// - plain: [16-byte chunk][rows][16 bytes], core matrices of 128
//   contiguous bytes; it may start at any row (the slab body's taps read
//   their slab t rows on). Descriptor: lbo = a chunk plane, sbo = 128
//   bytes, mode 0.
__device__ __forceinline__ int swizzled(int n, int c) {
  return n * 128 + (c ^ (n & 7)) * 16;
}

// d (64 x 256, s32) += A (64 x 32 bytes) B^T (256 x 32 bytes), both
// K-major in shared memory (descriptors da, db): one warpgroup's
// asynchronous product; d may be read only after wgmma_wait.
__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, s32) += A (64 x 32 bytes) B^T (128 x 32 bytes), both
// K-major in shared memory (descriptors da, db): one warpgroup's
// asynchronous product; d may be read only after wgmma_wait.
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a read or write of v across the
// asynchronous products (they own the sums' registers in between).
__device__ __forceinline__ void fence_reg(int& v) {
  asm volatile("" : "+r"(v)::"memory");
}
// Orders this thread's shared-memory writes (st.shared, cp.async) before
// later reads by the tensor cores (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared without registers; zeros where !live (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the pre-passes -------------------------------------------------------

// One warp a row: the row's absmax (0 past T_in).
__global__ void __launch_bounds__(256)
row_absmax_kernel(const float* __restrict__ x,   // (B, T_in, Kd)
                  float* __restrict__ rmax,      // (B, T_rm)
                  int B, int T_in, int T_rm, int Kd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B * T_rm) return;
  const int b = row / T_rm;
  const int r = row - b * T_rm;
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

// One warp a row of the quantized input. taps (slab_rows == 0): row r of
// utterance b with its own scale, as quant.py::quantize_rows, into xq (B,
// T_rm, Kd) and sxo (B, T_rm). slab: row r of time block tb's slab (input
// row tb * 128 + r) with the slab's scale, the max of rmax over its
// slab_rows rows, into xq (B, n_tb, slab_rows, Kd) and sxo (B, n_tb).
// Input rows past T_in are zeros.
__global__ void __launch_bounds__(256)
quantize_kernel(const float* __restrict__ x,     // (B, T_in, Kd)
                const float* __restrict__ rmax,  // slab: (B, T_rm)
                int8_t* __restrict__ xq, float* __restrict__ sxo, int B,
                int T_in, int T_rm, int Kd, int slab_rows, int n_tb) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int per_b = slab_rows ? n_tb * slab_rows : T_rm;
  if (row >= B * per_b) return;
  const int b = row / per_b;
  const int rr = row - b * per_b;
  const int tb = slab_rows ? rr / slab_rows : 0;
  const int r = slab_rows ? tb * kTB + rr - tb * slab_rows : rr;
  const float4* p = reinterpret_cast<const float4*>(
      x + (static_cast<size_t>(b) * T_in + r) * Kd);
  const bool live = r < T_in;
  float m = 0.f;
  if (slab_rows) {
    const float* rb = rmax + static_cast<size_t>(b) * T_rm + tb * kTB;
    for (int j = lane; j < slab_rows; j += 32) m = fmaxf(m, rb[j]);
  } else if (live) {
    for (int i = lane; i < Kd / 4; i += 32) {
      const float4 v = p[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float s = row_scale(m), inv = __frcp_rn(s);
  unsigned* dst = reinterpret_cast<unsigned*>(xq + static_cast<size_t>(row) *
                                                       Kd);
  for (int i = lane; i < Kd / 4; i += 32) {       // Kd % 128 == 0
    unsigned w = 0u;
    if (live) quant_words<1>(p + i, s, inv, &w);
    dst[i] = w;
  }
  if (lane == 0 && (!slab_rows || rr - tb * slab_rows == 0))
    sxo[slab_rows ? b * n_tb + tb : row] = s;
}

// ---- the GEMM -------------------------------------------------------------

// The block's dynamic shared memory for Kt taps, G taps a slab (im2col).
template <int M>
size_t smem_bytes(int Kt, int G) {
  using Tl = Tile<M>;
  size_t n = 1024 +                                         // alignment
             static_cast<size_t>(Tl::S) * Tl::BN * Tl::KC;  // band matrix
  if (M == kIm2col)
    n += static_cast<size_t>(Tl::BM + G - 1) * Tl::LDF +      // f32 slab
         2 * static_cast<size_t>(Tl::BM) * Tl::KC +           // int8 A tiles
         2 * sizeof(float) * Tl::BM;                          // scales
  else if (M == kSlab)
    n += 2 * static_cast<size_t>(Tl::BM + Kt - 1) * Tl::KC;  // int8 slabs
  else
    n += static_cast<size_t>(Tl::S) * Tl::BM * Tl::KC +       // int8 A tiles
         sizeof(float) * (Tl::BM + Kt - 1);                   // row scales
  return n;
}

// Rows of a K-major int8 tile, NC 16-byte chunks each, from global memory
// (rows src_ld bytes apart; live(n) false gives zeros) into dst, swizzled:
// each row's chunks go to neighbouring lanes.
template <int NC, typename Live>
__device__ __forceinline__ void load_swizzled(unsigned char* dst, int rows,
                                              const int8_t* src,
                                              size_t src_ld, Live live) {
  for (int e = threadIdx.x; e < NC * rows; e += kThreads) {
    const int c = e % NC, n = e / NC;
    const bool ok = live(n);
    cp_async16(dst + swizzled(n, c),
               src + (ok ? static_cast<size_t>(n) * src_ld + c * 16 : 0), ok);
  }
}

// The same into the plain layout: a warp copies 8 rows x 4 chunks, so each
// 8 lanes store to 8 rows' distinct banks.
template <int NC>
__device__ __forceinline__ void load_plain(unsigned char* dst, int rows,
                                           const int8_t* src,
                                           size_t src_ld) {
  const int total = NC * ((rows + 7) / 8 * 8);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int c = (e / 8) % NC;
    const int n = e / (8 * NC) * 8 + e % 8;
    if (n < rows)
      cp_async16(dst + (c * rows + n) * 16,
                 src + static_cast<size_t>(n) * src_ld + c * 16, true);
  }
}

// out (B, T_out, N) f32. im2col: x (B, T_in, Kd) f32 and scales = the row
// absmaxes (B, T_rm); taps: xq (B, T_rm, Kd) and scales (B, T_rm); slab:
// xq (B, n_tb, 128 + Kt - 1, Kd) and scales (B, n_tb). mqt (Kt, N, Kd):
// the band matrices, each column's contraction contiguous. Block (column
// tile, row tile, utterance); G taps a slab (im2col).
template <int M>
__global__ void __launch_bounds__(kThreads, 1)
conv_q8_kernel(const float* __restrict__ x, const int8_t* __restrict__ xq,
               const float* __restrict__ scales,
               const int8_t* __restrict__ mqt, const float* __restrict__ sw,
               float* __restrict__ out, int T_in, int T_out, int T_rm,
               int Kt, int G, int Kd, int N) {
  using Tl = Tile<M>;
  constexpr int BM = Tl::BM, BN = Tl::BN, KC = Tl::KC, NC = Tl::NC;
  constexpr int LDF = Tl::LDF, NACC = Tl::NACC, kStages = Tl::S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // The swizzled tiles start on 1024-byte boundaries (the swizzle's span).
  unsigned char* smem =
      smem_raw + ((1024 - (static_cast<unsigned>(
                               __cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023);
  unsigned char* Bs = smem;                      // [kStages][BN][KC] swizzled
  unsigned char* rest = Bs + kStages * BN * KC;
  const int srows = M == kSlab ? BM + Kt - 1 : BM + G - 1;  // a slab's rows
  float* fslab = reinterpret_cast<float*>(rest);             // im2col
  unsigned char* As =          // im2col [2][NC][BM][16], taps [S][BM][KC]
      M == kIm2col ? rest + srows * LDF : rest;
  unsigned char* islab = rest;                               // slab [2]
  float* sx_s = reinterpret_cast<float*>(
      As + (M == kIm2col ? 2 : kStages) * BM * KC);
  float* inv_s = sx_s + BM;                                  // im2col

  const int n0 = blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4;                      // the warpgroup
  const int row0 = Tl::WGM == 2 ? wg * 64 : 0;  // its rows and columns
  const int col0 = Tl::WGM == 2 ? 0 : wg * Tl::WGN;
  const int n_tb = (T_out + kTB - 1) / kTB;

  // Scales: im2col the output rows' windowed maxima (for the tile's rows
  // past T_out too: T_rm covers their windows), taps the input rows', slab
  // the time block's.
  float s_blk = 0.f;
  if constexpr (M == kIm2col) {
    const float* rb = scales + static_cast<size_t>(b) * T_rm + i0;
    for (int r = tid; r < BM; r += kThreads) {
      float m = rb[r];
      for (int t = 1; t < Kt; ++t) m = fmaxf(m, rb[r + t]);
      sx_s[r] = row_scale(m);
      inv_s[r] = __frcp_rn(sx_s[r]);
    }
  } else if constexpr (M == kTaps) {
    const float* rb = scales + static_cast<size_t>(b) * T_rm + i0;
    for (int r = tid; r < BM + Kt - 1; r += kThreads) sx_s[r] = rb[r];
  } else {
    s_blk = scales[b * n_tb + blockIdx.y];
  }

  // The walk: step j is (chunk kc, tap t), chunks outside (taps inside),
  // or taps outside for the taps body. im2col and slab stage a slab per
  // chunk and G taps (slab id kc * ntg + t / G).
  const int nkc = Kd / KC;
  const int n_steps = nkc * Kt;
  const int ntg = (Kt + G - 1) / G;
  const int n_slabs = nkc * ntg;
  auto step_of = [&](int j, int& kc, int& t) {
    if constexpr (M == kTaps) {
      t = j / nkc;
      kc = j - t * nkc;
    } else {
      kc = j / Kt;
      t = j - kc * Kt;
    }
  };
  auto slab_first = [&](int sid) {          // its first step
    const int kc = sid / ntg;
    return kc * Kt + (sid - kc * ntg) * G;
  };
  auto slab_len = [&](int sid) {            // its steps
    return min(G, Kt - (sid % ntg) * G);
  };
  // slab: slab sid >= 2 goes into the buffer of slab sid - 2 once that one
  // is read for the last time, as far ahead of its first step as the
  // band-matrix tiles, kStages - 1 iterations, or as the slab between them
  // allows. im2col has one f32 slab buffer: the next slab comes in the
  // iteration that quantizes from it first, while that step's products run.
  auto slab_lead = [&](int sid) {
    return min(kStages - 1, slab_len(sid - 1));
  };
  auto slab_issue = [&](int sid) {
    return slab_first(sid) - slab_lead(sid);
  };

  auto load_b = [&](int j) {                // band-matrix tile of step j
    int kc, t;
    step_of(j, kc, t);
    load_swizzled<NC>(Bs + (j % kStages) * BN * KC, BN,
                      mqt + (static_cast<size_t>(t) * N + n0) * Kd + kc * KC,
                      Kd, [&](int n) { return n0 + n < N; });
    if constexpr (M == kTaps)               // and taps' A tile
      load_swizzled<NC>(As + (j % kStages) * BM * KC, BM,
                        xq + (static_cast<size_t>(b) * T_rm + i0 + t) * Kd +
                            kc * KC,
                        Kd, [](int) { return true; });
  };
  auto load_slab = [&](int sid) {           // im2col f32, slab int8
    const int kc = sid / ntg, tg = sid - kc * ntg;
    if constexpr (M == kIm2col) {
      float* fs = fslab;
      const float* xb = x + static_cast<size_t>(b) * T_in * Kd + kc * KC;
      for (int e = tid; e < srows * (KC / 4); e += kThreads) {
        const int r = e / (KC / 4);
        const int c = (e - r * (KC / 4)) * 4;
        const int row = i0 + tg * G + r;
        const bool live = row < T_in;
        cp_async16(fs + r * (LDF / 4) + c,
                   xb + static_cast<size_t>(live ? row : 0) * Kd + c, live);
      }
    } else if constexpr (M == kSlab) {
      load_plain<NC>(islab + (sid & 1) * srows * KC, srows,
                     xq + (static_cast<size_t>(b) * n_tb + blockIdx.y) *
                              srows * Kd + kc * KC,
                     Kd);
    }
  };
  // im2col: step j's A tile from its slab, rows r + (t mod G) quantized
  // with OUTPUT row r's scale; thread (g, r) takes chunk g of row r.
  auto quantize_tile = [&](int j) {
    if (j >= n_steps) return;
    int kc, t;
    step_of(j, kc, t);
    const float* fs = fslab + (t % G) * (LDF / 4);
    unsigned char* as = As + (j & 1) * BM * KC;
    static_assert(BM * NC % kThreads == 0, "whole warps per item");
    for (int e = tid; e < BM * NC; e += kThreads) {
      const int g = e / BM, r = e - g * BM;
      unsigned w[4];
      quant_words<4>(
          reinterpret_cast<const float4*>(fs + r * (LDF / 4) + g * 16),
          sx_s[r], inv_s[r], w);
      *reinterpret_cast<uint4*>(as + (g * BM + r) * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  int acc[NACC];
  float facc[M == kTaps ? NACC : 1];        // taps: the f32 sums
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0;
  if constexpr (M == kTaps) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) facc[k] = 0.f;
  }

  // Prologue: steps 0 .. kStages - 2 in flight, the first slab (slab:
  // two) with step 0; im2col quantizes step 0's A tile.
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) load_b(j);
    if (M != kTaps && j == 0)
      for (int sid = 0; sid < min(M == kSlab ? 2 : 1, n_slabs); ++sid)
        load_slab(sid);
    cp_async_commit();
  }
  int next_sid = 2;                         // slab: the next slab to load
  int next_issue = M == kSlab && n_slabs > 2 ? slab_issue(2) : n_steps;
  if constexpr (M == kIm2col) {
    cp_async_wait<0>();
    __syncthreads();
    quantize_tile(0);
  }

  for (int i = 0; i < n_steps; ++i) {
    int kc, t;
    step_of(i, kc, t);
    // Step i's band-matrix tile is in; where this step reads a slab for
    // the first time (im2col: quantizes step i + 1 from it), that slab
    // too: loaded kStages - 1 iterations ago like the tile, or fewer where
    // the slab before it is shorter (then everything in flight is waited).
    bool drain = false;
    if constexpr (M == kSlab) {
      const int sid = kc * ntg + t / G;
      drain = t % G == 0 && sid >= 2 && slab_lead(sid) < kStages - 1;
    }
    if (drain)
      cp_async_wait<0>();
    else
      cp_async_wait<kStages - 2>();
    fence_async_smem();                     // copies and A tiles -> tensor
    __syncthreads();                        // cores; step i - 1 is done
    if (i + kStages - 1 < n_steps) load_b(i + kStages - 1);
    if (i == next_issue) {
      load_slab(next_sid);
      ++next_sid;
      next_issue = next_sid < n_slabs ? slab_issue(next_sid) : n_steps;
    }
    cp_async_commit();

    // The warpgroup's products of step i, asynchronous: B swizzled, A
    // swizzled (taps) or plain (im2col; slab, where tap t starts t rows
    // on).
    const unsigned char* as;
    int a_rows;
    if constexpr (M == kIm2col) {
      as = As + (i & 1) * BM * KC;
      a_rows = BM;
    } else if constexpr (M == kTaps) {
      as = As + (i % kStages) * BM * KC;
      a_rows = BM;
    } else {
      as = islab + ((kc * ntg) & 1) * srows * KC + t * 16;
      a_rows = srows;
    }
    const unsigned char* bs = Bs + (i % kStages) * BN * KC;
#pragma unroll
    for (int k = 0; k < NACC; ++k) fence_reg(acc[k]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      const uint64_t da =
          M == kTaps
              ? smem_desc(as + row0 * KC + ks * 32, 16, 8 * KC, 1)
              : smem_desc(as + (2 * ks * a_rows + row0) * 16, a_rows * 16,
                          128, 0);
      const uint64_t db =
          smem_desc(bs + col0 * KC + ks * 32, 16, 8 * KC, 1);
      if constexpr (Tl::WGN == 256)
        wgmma_n256(acc, da, db);
      else
        wgmma_n128(acc, da, db);
    }
    wgmma_commit();
    if constexpr (M == kIm2col) {
      // Step i + 1's A tile is quantized while the products run, from the
      // next slab where it starts one (its copies waited for here).
      if (i + 1 < n_steps) {
        int kn, tn;
        step_of(i + 1, kn, tn);
        if (tn % G == 0) {
          load_slab(kn * ntg + tn / G);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
      }
      quantize_tile(i + 1);
    }
    wgmma_wait();
#pragma unroll
    for (int k = 0; k < NACC; ++k) fence_reg(acc[k]);
    if constexpr (M == kTaps) {
      // Tap t is complete: acc_f += float(acc) * sx[row + t], then acc = 0.
      if (kc + 1 == nkc) {
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
          const int r = row0 + (warp % 4) * 16 + (lane >> 2) + (k & 2) * 4;
          facc[k] = __fadd_rn(
              facc[k], __fmul_rn(static_cast<float>(acc[k]), sx_s[r + t]));
          acc[k] = 0;
        }
      }
    }
  }

  // Epilogue, rounded as the plain version rounds: (acc * sx) * sw
  // (im2col), acc_f * sw (taps), acc * (sx * sw) (slab). Sum 4j + e of a
  // thread is row g (+ 8 for e >= 2), column 8j + 2 (lane % 4) (+ 1 for odd
  // e) of its warp's 16 rows.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + (warp % 4) * 16 + (lane >> 2) + half * 8;
    const int i = i0 + r;
    if (i >= T_out) continue;
    float* o = out + (static_cast<size_t>(b) * T_out + i) * N;
#pragma unroll
    for (int jn = 0; jn < NACC / 4; ++jn) {
      const int n = n0 + col0 + jn * 8 + (lane & 3) * 2;
      if (n >= N) break;
      const int k = 4 * jn + 2 * half;
      const float a0 = static_cast<float>(acc[k]);
      const float a1 = static_cast<float>(acc[k + 1]);
      float2 v;
      if constexpr (M == kIm2col) {
        const float s = sx_s[r];
        v.x = __fmul_rn(__fmul_rn(a0, s), sw[n]);
        v.y = __fmul_rn(__fmul_rn(a1, s), sw[n + 1]);
      } else if constexpr (M == kTaps) {
        v.x = __fmul_rn(facc[k], sw[n]);
        v.y = __fmul_rn(facc[k + 1], sw[n + 1]);
      } else {
        v.x = __fmul_rn(a0, __fmul_rn(s_blk, sw[n]));
        v.y = __fmul_rn(a1, __fmul_rn(s_blk, sw[n + 1]));
      }
      *reinterpret_cast<float2*>(o + n) = v;
    }
  }
}

int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// im2col's taps a slab: all Kt where the f32 slabs fit, else as many as do.
int im2col_taps(int Kt, int limit) {
  int G = Kt;
  while (G > 1 && smem_bytes<kIm2col>(Kt, G) > static_cast<size_t>(limit))
    --G;
  return G;
}

// The scratch of a mode: im2col the row absmaxes (B, T_rm); taps the row
// scales (B, T_rm) and the quantized rows (B, T_rm, Kd); slab the row
// absmaxes, the blocks' scales (B, n_tb) and their quantized slabs (B,
// n_tb, 128 + Kt - 1, Kd); each part 256-byte aligned.
struct Scratch {
  size_t rmax, scales, xq, total;
};

Scratch scratch_of(int B, int T_out, int Kt, int Kd, int mode) {
  const int T_rm = rows_covered(T_out, Kt);
  const int n_tb = (T_out + kTB - 1) / kTB;
  const size_t rows = static_cast<size_t>(B) * T_rm;
  Scratch s{};
  s.rmax = 0;
  if (mode == kIm2col) {
    s.scales = s.xq = 0;
    s.total = align256(sizeof(float) * rows);
  } else if (mode == kTaps) {
    s.scales = 0;
    s.xq = align256(sizeof(float) * rows);
    s.total = s.xq + align256(rows * Kd);
  } else {
    s.scales = align256(sizeof(float) * rows);
    s.xq = s.scales + align256(sizeof(float) * B * n_tb);
    s.total = s.xq + align256(static_cast<size_t>(B) * n_tb *
                              (kTB + Kt - 1) * Kd);
  }
  return s;
}

template <int M>
int launch_conv(const float* x, const int8_t* xq, const float* scales,
                const int8_t* mqt, const float* sw, float* out, int B,
                int T_in, int T_out, int T_rm, int Kt, int G, int Kd, int N,
                cudaStream_t stream) {
  using Tl = Tile<M>;
  const size_t smem = smem_bytes<M>(Kt, G);
  if (smem > static_cast<size_t>(max_smem()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_q8_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (T_out + Tl::BM - 1) / Tl::BM,
                  B);
  conv_q8_kernel<M><<<grid, kThreads, smem, stream>>>(
      x, xq, scales, mqt, sw, out, T_in, T_out, T_rm, Kt, G, Kd, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch that tpuasr_conv_q8 needs for a shape and mode.
extern "C" long long tpuasr_conv_q8_scratch(int B, int T_in, int T_out,
                                            int Kt, int Kd, int N, int mode) {
  (void)T_in;
  (void)N;
  return static_cast<long long>(scratch_of(B, T_out, Kt, Kd, mode).total);
}

// K9: out (B, T_out, N) f32 from x (B, T_in, Kd) f32, mqt (Kt, N, Kd) int8
// (the band matrices with each column's contraction contiguous), sw (N,)
// f32, with the body of mode (0 im2col, 1 taps, 2 slab); scratch: the
// bytes tpuasr_conv_q8_scratch gives, 256-byte aligned. Kd % 128 == 0,
// N % 128 == 0, all contiguous. Rows of x past T_in count as zeros.
extern "C" int tpuasr_conv_q8(const float* x, const int8_t* mqt,
                              const float* sw, void* scratch, float* out,
                              int B, int T_in, int T_out, int Kt, int Kd,
                              int N, int mode, cudaStream_t stream) {
  if (B <= 0 || T_out <= 0 || N <= 0) return 0;
  if (Kd % 128 || N % 128 || Kt <= 0 || Kt - 1 > kTB || mode < 0 ||
      mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T_rm = rows_covered(T_out, Kt);
  const int n_tb = (T_out + kTB - 1) / kTB;
  const Scratch sc = scratch_of(B, T_out, Kt, Kd, mode);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* rmax = reinterpret_cast<float*>(base + sc.rmax);
  float* scales = reinterpret_cast<float*>(base + sc.scales);
  int8_t* xq = reinterpret_cast<int8_t*>(base + sc.xq);
  const int rows = B * T_rm;
  if (mode != kTaps) {
    row_absmax_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(x, rmax, B, T_in,
                                                          T_rm, Kd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (mode) {
    case kTaps: {
      quantize_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
          x, nullptr, xq, rmax, B, T_in, T_rm, Kd, 0, n_tb);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      return launch_conv<kTaps>(nullptr, xq, rmax, mqt, sw, out, B, T_in,
                                T_out, T_rm, Kt, Kt, Kd, N, stream);
    }
    case kSlab: {
      const int srows = kTB + Kt - 1;
      const int qrows = B * n_tb * srows;
      quantize_kernel<<<(qrows + 7) / 8, 256, 0, stream>>>(
          x, rmax, xq, scales, B, T_in, T_rm, Kd, srows, n_tb);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      return launch_conv<kSlab>(nullptr, xq, scales, mqt, sw, out, B, T_in,
                                T_out, T_rm, Kt, Kt, Kd, N, stream);
    }
    default:
      return launch_conv<kIm2col>(x, nullptr, rmax, mqt, sw, out, B, T_in,
                                  T_out, T_rm, Kt,
                                  im2col_taps(Kt, max_smem()), Kd, N,
                                  stream);
  }
}
