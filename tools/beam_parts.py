"""Where a frame of the beam search kernel (K3) goes, on one card.

    python3 tools/beam_parts.py [--source FILE]

Builds csrc/ctc_beam.cu (or --source, another version of it) with
TPUASR_BEAM_CLOCKS, which makes lane 0 of each utterance's warp sum the SM
clock cycles of each phase of the frame loop (A: stays; B: the inverse-hash
join and the stay totals; C: the scan of the lane's candidates into its
sorted list; merge: the warp's butterfly of lists; D: the bookkeeping of
the K selections, up to the next frame). Runs the search at the served
shape (B=128 utterances, T'=499 frames, C=64 classes, K=8; without LM and
with the bigram table) and prints the mean cycles a frame by phase, their
sum, the SM clock that nvidia-smi reads during the run, and the kernel's
time from CUDA events (mean of 10; the counters cost a few cycles a phase).
Prints the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpuasr_torch import _build  # noqa: E402
from tpuasr_torch.decode import beam as beam_mod  # noqa: E402

CSRC = ROOT / "tpuasr_torch" / "csrc"
PHASES = ("A stays", "B join", "C scan", "merge", "D bookkeeping")


def build(source: Path, out: Path) -> ctypes.CDLL:
    so = out / "beam_clocks.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DTPUASR_BEAM_CLOCKS",
           "-o", str(so), str(source), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p
    lib.tpuasr_ctc_beam_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuasr_ctc_beam_clocks.restype = ctypes.c_int
    return lib


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(CSRC / "ctc_beam.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    B, T, C, K = 128, 499, 64, 8
    g = torch.Generator().manual_seed(0)
    lp = torch.log_softmax(torch.randn(B, T, C, generator=g) * 2.0, -1)
    lp = lp.cuda().contiguous()
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    tab = torch.log_softmax(torch.randn(C + 1, C, generator=g), -1).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(args.source), Path(tmp))
        with mock.patch.object(_build, "_lib", lib):
            for label, extra in (("no LM", ()), ("bigram", (tab, 2, 0.5))):
                def call():
                    return beam_mod.beam_scan(lp, lens, K, 0, 256, *extra)
                call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call()
                end.record()
                clock = sm_clock()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / 10
                clk = torch.zeros((B, 5), dtype=torch.int64)
                code = lib.tpuasr_ctc_beam_clocks(
                    ctypes.c_void_p(clk.data_ptr()), B)
                if code:
                    raise RuntimeError(f"clocks: {code}")
                per = clk.double().mean(0) / T
                parts = "; ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, per))
                print(f"K3 {label} B={B} T={T} C={C} K={K}: {ms:.3f} ms "
                      f"({ms / T * 1e3:.2f} us a frame); cycles a frame: "
                      f"{parts}; sum {per.sum():.0f} (SM clock {clock})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
