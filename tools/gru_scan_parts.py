"""Where a step of K2/K4's recurrence (csrc/gru_scan.cu) goes, on one card.

    python3 tools/gru_scan_parts.py

Builds csrc/gru_scan.cu as it is and in ablated copies, each with one part
of the recurrence's step taken out (the barriers, the staging of the
previous state, the tensor-core product), and times each build's
recurrence (CUDA events, mean of 5) at the served layer (T=499, B=128,
H=512) for bf16 and for rec_q8, under the plan ops/gru.py gives and under
one row group of 8-unit blocks (each staging all rows every step), and
K7's bf16 forward (both directions in one grid, bf16 xp) under its plan.
An ablated build computes wrong values: its time only says what the part
costs. Prints the card's name and power limit first. Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpuasr_torch import _build  # noqa: E402
from tpuasr_torch.ops import gru as gru_mod  # noqa: E402

CSRC = ROOT / "tpuasr_torch" / "csrc"
# name -> [(text in gru_scan.cu, replacement)]
ABLATIONS = {
    "as is": [],
    "no barrier": [("group_sync(gbar, ", "if (false) group_sync(gbar, ")],
    "no staging": [("copy_rows(tile", "if (false) copy_rows(tile")],
    "no product": [("Mma<kQ>::run(c[n], a, bb);", "(void)bb;")],
}


def build(name: str, edits, out: Path) -> ctypes.CDLL:
    src = (CSRC / "gru_scan.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in gru_scan.cu")
        src = src.replace(old, new)
    d = out / name.replace(" ", "_")
    d.mkdir()
    (d / "gru_scan.cu").write_text(src)
    for f in CSRC.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    so = d / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(d / "gru_scan.cu"), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    return ctypes.CDLL(str(so))


def recur_ms(lib, plan, xps, whps, swh, mask2) -> float:
    """Mean ms of the recurrence launch of ops/gru.py::_recur_dirs with
    this build's library in the package's place."""
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p

    def call():
        gru_mod._recur_dirs(plan, xps, whps, swh, mask2, False,
                            torch.bfloat16)

    with mock.patch.object(_build, "_lib", lib):
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 5


def one_group(plan, B: int, H: int):
    """The plan with one row group of 8-unit blocks: every block stages all
    B rows each step."""
    U, R = 8, 16
    while R < min(128, gru_mod._GATE_ITEMS * gru_mod._REC_THREADS // U, B):
        R *= 2
    while gru_mod._rec_smem(plan.rec, H, U, R) > gru_mod._SMEM_BUDGET:
        R //= 2
    return dataclasses.replace(plan, U=U, R=R, rg=1, grid=-(-H // U),
                               smem=gru_mod._rec_smem(plan.rec, H, U, R))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    T, B, H = 499, 128, 512
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(T, B, 3 * H, generator=g).cuda()
    wh = (torch.randn(H, 3 * H, generator=g) / H ** 0.5).cuda()
    mask2 = torch.ones(T, B, device="cuda")
    from tpuasr_torch.ops.quant import quantize_per_channel
    whq, swh = quantize_per_channel(wh)
    n_sm = gru_mod._sm_count(xp.device)
    cases = []
    for label, mode, w, s in (("bf16", gru_mod._MODE_K2, wh.bfloat16(), None),
                              ("rec_q8", gru_mod._MODE_Q8_REC, whq, swh)):
        plan = gru_mod._scan_plan(B, 1024, H, mode, torch.bfloat16, n_sm)
        for p in (plan, one_group(plan, B, H)):
            cases.append((label, p, (xp,), (gru_mod._pack_rec(w, p),), s))
    plan = gru_mod._scan_plan(B, H, H, gru_mod._MODE_K2, torch.bfloat16,
                              n_sm, ndir=2)
    whp = gru_mod._pack_rec(wh.bfloat16(), plan)
    cases.append(("K7 bf16", plan, (xp.bfloat16(), xp.flip(1).bfloat16()),
                  (whp, whp), None))
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(ABLATIONS)) as pool:
            libs = dict(zip(ABLATIONS, pool.map(
                lambda kv: build(kv[0], kv[1], Path(tmp)),
                ABLATIONS.items())))
        for label, plan, xps, whps, s in cases:
            row = []
            for name, lib in libs.items():
                ms = recur_ms(lib, plan, xps, whps, s, mask2)
                row.append(f"{name} {ms:.3f} ms ({ms / T * 1e3:.2f} us)")
            print(f"{label} U={plan.U} R={plan.R} rg={plan.rg} "
                  f"dirs={plan.ndir} grid={plan.grid}: "
                  + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
