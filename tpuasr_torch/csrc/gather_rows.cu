// Row gather out[i, :] = table[clamp(idx[i], 0, S - 1), :] for an int32
// table (S, W).
//
// The counterpart of gather_rows of tpuasr/ops/pallas_gather.py (K10,
// pallas_call at line 82), the JAX package's public row gather. The
// graph-constrained beam search no longer launches it: csrc/scan_beam.cu
// runs the whole frame loop and fetches each beam's packed row [next
// states | cost bits] itself. The clamp is the semantics of the default JAX
// path (XLA's gather clamps out-of-range indices).
//
// What bounds it on the H100: latency of scattered row reads. Each row is
// W * 4 = 512 bytes at C = 64 and the rows are independent, so the work is
// B*K reads of one row each. The bench-scale table (58k states, 29.8 MB)
// fits in the 50 MB L2, so a warm fetch is an L2 hit.
//
// Design: one warp per row; each lane copies 16-byte int4 vectors, so a
// 512-byte row is one int4 per lane, one coalesced request per warp. Many
// warps in flight (B*K / 8 blocks of 8 warps) overlap the row latencies,
// the job the TPU kernel's ring of 16 outstanding DMAs did. The copy is
// int32 end to end: the cost half holds float32 bits, and a float carrier
// could flush the denormal patterns of small state ids (as it did on the
// TPU), so nothing here ever touches a float.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const int32_t* __restrict__ table,   // (S, W)
                   const int32_t* __restrict__ idx,     // (N,)
                   int32_t* __restrict__ out,           // (N, W)
                   int S, int W, int N, bool vec) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const int s = min(max(idx[row], 0), S - 1);
  const int32_t* src = table + static_cast<size_t>(s) * W;
  int32_t* dst = out + static_cast<size_t>(row) * W;
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int j = lane; j < (W >> 2); j += 32) d4[j] = __ldg(s4 + j);
  } else {
    for (int j = lane; j < W; j += 32) dst[j] = __ldg(src + j);
  }
}

}  // namespace

extern "C" int tpuasr_gather_rows(const int32_t* table, const int32_t* idx,
                                  int32_t* out, int S, int W, int N,
                                  cudaStream_t stream) {
  // 16-byte vectors need rows that start on 16-byte boundaries.
  const bool vec = (W & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, idx, out, S, W, N, vec);
  return static_cast<int>(cudaGetLastError());
}
