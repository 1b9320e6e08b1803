"""Time the GRU scan kernels K5/K5b of two checkouts on one card, in turns.

    python3 tools/gru_bptt_ab.py [--against DIR]

Times ``gru_scan_fwd`` (K5) and ``gru_scan_bwd`` (K5b) at the config-3
train step's shapes (T=249, H=512, B=16 and B=64, float32) with CUDA
events, for this checkout and, with ``--against``, for another checkout
of the repository (for example ``git archive`` of the parent commit
unpacked under ``build/``), in the order other, this, this, other, each
in its own process with its own kernel build. Each run also reports the
kernels' largest error against their plain versions. Then it times
kernels that do nothing but the 248 block meetings of one K5 launch (512
threads per block, at 32, 64 and 128 blocks), in four forms: one arrival
counter that never resets, with fences around the add (the first form of
the barrier in csrc/gru_coop.cuh) and with a release add and acquire
polls (its form now), an earlier barrier with a counter reset by the last
block and a generation word, and per-block step flags that one warp of
every block polls.

Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

RUN = r'''
import json, sys, torch
sys.path.insert(0, ROOT)
from tpuasr_torch import _build
from tpuasr_torch.ops import gru as g
from tpuasr_torch.precision import full_fp32
_build.lib()

def ms(fn, n):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n

out = {"tree": ROOT}
gen = torch.Generator().manual_seed(0)
T, H = 249, 512
for B in (16, 64):
    xp = torch.randn(T, B, 3 * H, generator=gen).cuda()
    wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).cuda()
    lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lens[0] = T
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    mask = mask.cuda().contiguous()
    dys = torch.randn(T, B, H, generator=gen).cuda()
    with full_fp32():
        errs = []
        for rev in (False, True):
            ys = g.gru_scan_fwd(xp, wh, mask, rev)
            ref = g.gru_scan_plain(xp, wh, mask, rev)
            ysp = g.prev_states(ref, rev)
            dxp, dwh = g.gru_scan_bwd(xp, ysp, wh, mask, dys, rev)
            rdxp, rdwh = g.gru_scan_bwd_plain(xp, ysp, wh, mask, dys, rev)
            errs.append(max((ys - ref).abs().max().item(),
                            (dxp - rdxp).abs().max().item()
                            / rdxp.abs().max().item(),
                            (dwh - rdwh).abs().max().item()
                            / rdwh.abs().max().item()))
        ysp = g.prev_states(g.gru_scan_plain(xp, wh, mask, False), False)
        out[f"B={B}"] = dict(
            max_err=max(errs),
            k5_ms=ms(lambda: g.gru_scan_fwd(xp, wh, mask, False), ITERS),
            k5b_ms=ms(lambda: g.gru_scan_bwd(xp, ysp, wh, mask, dys, False),
                      ITERS))
print("RESULT " + json.dumps(out))
'''

BARRIER = r'''
#include <cuda_runtime.h>
// A barrier with a generation: bar[0] counts arrivals and is reset by the
// last block, which then bumps the generation bar[1].
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}
__global__ void barriers(unsigned* bar, int n) {
  for (int i = 0; i < n; ++i) grid_sync(bar);
}
// The counter barrier in its first form: the n-th meeting is complete when
// the arrival count reaches n * gridDim.x; fences around the add and the
// volatile polls.
__global__ void counter(unsigned* c, int n) {
  for (int i = 1; i <= n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(c, 1u);
      const unsigned target = i * gridDim.x;
      const volatile unsigned* v = c;
      while (*v < target) {
      }
      __threadfence();
    }
    __syncthreads();
  }
}
// The counter barrier of csrc/gru_coop.cuh (group_sync): the same count,
// arrived at with a release add and polled with acquire loads.
__global__ void release_counter(unsigned* c, int n) {
  for (int i = 1; i <= n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                   :: "l"(c) : "memory");
      const unsigned target = i * gridDim.x;
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(seen) : "l"(c) : "memory");
      } while (seen < target);
    }
    __syncthreads();
  }
}
// Per-block step flags: each block stores the step in its own word, then
// one warp polls every word until all have reached the step.
__global__ void flags(unsigned* f, int n) {
  for (int s = 1; s <= n; ++s) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      *reinterpret_cast<volatile unsigned*>(f + blockIdx.x) = s;
    }
    if (threadIdx.x < 32) {
      const volatile unsigned* v = f;
      for (int i = threadIdx.x; i < gridDim.x; i += 32)
        while (v[i] < (unsigned)s) {
        }
      __threadfence();
    }
    __syncthreads();
  }
}
extern "C" float run(int kind, int blocks, int n, int reps) {
  unsigned* bar = nullptr;
  cudaMalloc(&bar, 4 * 1024);
  void* args[] = {&bar, &n};
  void* fn = kind == 0   ? (void*)counter
             : kind == 1 ? (void*)barriers
             : kind == 2 ? (void*)flags
                         : (void*)release_counter;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaMemset(bar, 0, 4 * 1024);
  cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(512), args, 0, 0);
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) {
    cudaMemsetAsync(bar, 0, 4 * 1024);
    cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(512), args, 0, 0);
  }
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, a, b);
  cudaFree(bar);
  return ms / reps;
}
'''


def run_tree(tree: Path, iters: int) -> dict:
    code = f"ROOT = {str(tree)!r}\nITERS = {iters}\n" + RUN
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: rc {res.returncode}\n{res.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--against", type=Path, default=None,
                   help="another checkout of the repository to time in turns")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = ([args.against, ROOT, ROOT, args.against] if args.against
             else [ROOT])
    for tree in order:
        print(json.dumps(run_tree(tree.resolve(), args.iters)), flush=True)

    sys.path.insert(0, str(ROOT))
    from tpuasr_torch import _build
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        src, lib = Path(tmp) / "barrier.cu", Path(tmp) / "barrier.so"
        src.write_text(BARRIER)
        res = subprocess.run([_build.find_nvcc(), "-gencode",
                              "arch=compute_90a,code=sm_90a", "-O3",
                              "-shared", "-Xcompiler", "-fPIC", "-o",
                              str(lib), str(src)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise SystemExit(res.stderr)
        run = ctypes.CDLL(str(lib)).run
        run.restype = ctypes.c_float
        for kind, name in ((0, "counter barrier, fences"),
                           (3, "counter barrier, release/acquire"),
                           (1, "generation barrier"), (2, "step flags")):
            for blocks in (32, 64, 128):
                t = run(kind, blocks, 248, args.iters)
                print(f"{name} only: {blocks} blocks, 248 meetings: {t:.4f} "
                      f"ms = {t / 248 * 1e3:.3f} us each (a memset of the "
                      "words included)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
