// GRU scan over precomputed input projections, float32: the forward (K5).
// Its BPTT, K5b, runs in three phases at one direction (ops/gru.py::
// gru_scan_bwd): hp = ysp Wh over all T*B rows on K2's f32 projection
// tiles, csrc/gru_lean.cu's lean recurrence, then dWh = ysp^T dhp over all
// rows.
//
// Replaces K5 of tpuasr/ops/pallas_gru.py: _fwd_kernel, built by
// _build_fwd (pallas_call at line 163), the masked GRU recurrence
// ys = gru_scan(xp, wh, mask, reverse); K5b (_bwd_kernel, built by
// _build_bwd, line 190) is the three phases above.
//
// Gate math (pallas_gru.py:70-74, gate order r, z, n, bias on the input
// side only): r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z),
// n = tanh(xp_n + r * hp_n), h' = (1 - z) n + z h, h = m h' + (1 - m) h with
// hp = h @ Wh.
//
// What bounds it on the H100: the operations. At DeepSpeech's training
// shapes (T=249, B=16, H=512) the forward does one (16 x 512) @ (512 x 1536)
// product per step, 3.1 G MAC per launch (94 us at the 67 TFLOP/s fp32 FMA
// peak), and moves only 36 MB. But the steps are sequential and each is a
// small product, so what a design can reach is set by how many SMs share
// one step and what each SM must load per step.
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
// load feeds 48 FMAs; the warp then reduces its 32 lanes with a
// reduce-scatter of shuffles (each halving step sends half the values),
// and the warps of a unit add up in shared memory. The state lives in ys
// itself (ys[t_prev] is h), so nothing else crosses blocks. The kernel is
// in gru_coop.cuh: K2's float32 recurrence (csrc/gru_scan.cu) launches it
// too.
#include "gru_coop.cuh"

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

#undef TPUASR_BY_UNITS
