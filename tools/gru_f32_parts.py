"""Where a step of the float32 GRU recurrences goes, on one card.

    python3 tools/gru_f32_parts.py [--bf16] [--root DIR]

Builds csrc/gru_bidir.cu (the f32 forward recurrence of K5, K2 in f32 and
K7-f32) and csrc/gru_lean.cu (the lean BPTT recurrence of K5b, K2b and
K7b) as they are and in ablated
copies, each with one part of the step taken out: the barrier (a
__syncthreads in its place), the staging of the previous step's rows (h,
or dhp), the product (and with it what the compiler drops when its sums
are zero), and the loads of the gate items' inputs (xp and the mask; for
the lean recurrence also hp, ysp and dys). Times each build's recurrence
(CUDA events, mean of 5) at config 3's layer (T=249, H=512): K7-f32 at
B=16, 64 and 128, K5's forward (one direction, ``_f32_rec_plan``) at B=16
and 64 and at deepspeech_var's H=384, K5b's lean recurrence at B=16 and 64,
K7b's at B=16 and 128, each under the plan ops/gru.py gives. An ablated build computes wrong
values: its time only says what the part costs, and the parts overlap, so
they need not add up. Then K5's forward as it is, with its contraction
staged in chunks of 128, 256 and all of H (the plan takes all of H where
it fits): more chunks overlap a chunk's copy with the previous chunk's
product. Prints the card's name and power limit first. Needs one CUDA card
and nvcc.

--bf16 ablates the lean recurrence's bf16 form instead (the backward of the
bf16 streams) at K5b-bf16's B=16 and 64, H=512, K7b-bf16's B=64 and
K2b-bf16's B=16, H=384 (its xp and dxp in f32), with the same four parts
taken out, under the tree's own bf16 plan and its own bf16 body: where the
tree runs the bf16 streams through the f32 body's rounding mode (over
their f32 upcasts, not timed), that body's edits apply. --root builds the
sources and imports tpuasr_torch of another checkout (for example the
parent commit, unpacked by git archive).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
_build = gru_mod = None              # the tree's, imported by main()
CSRC = ROOT / "tpuasr_torch" / "csrc"
_PRODUCT = ("for (int q = kw * 32 + lane; q < kc4; q += WPT * 32) {",
            "for (int q = kc4; q < kc4; q += WPT * 32) {")
# source -> part -> [(text in the source, replacement)]
ABLATIONS = {
    "gru_bidir.cu": {
        "as is": [],
        "no barrier": [("group_sync(gbar, s + 1, UG);", "__syncthreads();")],
        "no staging": [("if (s) stage(hprev, 0);", ""),
                       ("if (i + 1 < items) stage(hprev, i + 1);", "")],
        "no product": [_PRODUCT],
        "no gate loads": [("if (gate && b < rb1) {", "if (false) {")],
    },
    "gru_lean.cu": {
        "as is": [],
        "no barrier": [("group_sync(gbar, s + 1, UG);", "__syncthreads();")],
        "no staging": [("        if (vec) {\n          for (int e = tid; "
                        "e < kR * kc4;",
                        "        if (false) {\n          for (int e = tid; "
                        "e < kR * kc4;"),
                       ("        } else {\n          for (int e = tid; "
                        "e < kR * KC;",
                        "        } else if (false) {\n          for (int e "
                        "= tid; e < kR * KC;")],
        "no product": [_PRODUCT],
        "no gate loads": [("  if (live) {\n    const size_t q = row * 3 * H "
                           "+ j;", "  if (false) {\n    const size_t q = row "
                           "* 3 * H + j;")],
    },
}


# --bf16: part -> edit lists tried in turn, the first whose texts all occur
# in the tree's gru_lean.cu applying: the tensor-core body's (its staging is
# the L2 loads of the ring's rows into registers), else the f32 body's,
# where the bf16 streams run through its rounding mode.
ABLATIONS_BF16 = {
    "as is": [[]],
    "no barrier": [[("group_sync(gbar, s + 1, UG);          // the row "
                     "group's ring[t] is out", "__syncthreads();")]],
    "no staging": [[("alo[p] = in && lo ?", "alo[p] = false ?"),
                    ("ahi[p] = in && hi ?", "ahi[p] = false ?")]],
    "no product": [[("mma_bf16(acc[n], a0, b0f);", ""),
                    ("mma_bf16(acc[n], a1, b1f);", "")]],
    "no gate loads": [],
}
for _part, _edits in ABLATIONS["gru_lean.cu"].items():
    ABLATIONS_BF16[_part].append(_edits)


def pick(src: str, options):
    for edits in options:
        if all(old in src for old, _ in edits):
            return edits
    raise RuntimeError(f"no edit list of {options!r} fits the source")


def build(source: str, name: str, edits, out: Path) -> ctypes.CDLL:
    src = (CSRC / source).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in {source}")
        src = src.replace(old, new)
    d = out / f"{Path(source).stem}_{name.replace(' ', '_')}"
    d.mkdir()
    (d / source).write_text(src)
    for f in CSRC.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    so = d / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(d / source), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p
    return lib


def timed(lib, call) -> float:
    """Mean ms of call() with this build's library in the package's place."""
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


def bf16_cases(rnd, n_sm):
    """(label, call) of the lean recurrence's bf16 form at the trained
    shapes: inputs as the backward wrappers give them (xp, ysp, dys and wh
    bf16, hp f32 from the bf16 tiles; K2b's xp f32), run as the tree runs
    them."""
    T, bf, f32 = 249, torch.bfloat16, torch.float32
    own = "bf16" in inspect.signature(gru_mod._lean_plan).parameters
    cases = []
    for key, B, H, ndir in (("K5b-bf16", 16, 512, 1), ("K5b-bf16", 64, 512, 1),
                            ("K7b-bf16", 64, 512, 2),
                            ("K2b-bf16", 16, 384, 1)):
        k2b = key == "K2b-bf16"
        plan = (gru_mod._lean_plan(B, H, ndir, n_sm, bf16=True) if own
                else gru_mod._lean_plan(B, H, ndir, n_sm))
        dirs = []
        for _ in range(ndir):
            wh = rnd(H, 3 * H, scale=H ** -0.5).to(bf)
            ysp = rnd(T, B, H, scale=0.5).to(bf)
            dirs.append((rnd(T, B, 3 * H).to(f32 if k2b else bf),
                         gru_mod._hp(ysp, wh), ysp, rnd(T, B, H).to(bf), wh))
        m2 = torch.ones(T, B, device="cuda")
        if own:
            call = (lambda p=plan, d=dirs, m=m2: gru_mod._lean_bf16(
                p, d, m, False))
        else:
            up = [(xp.to(f32), hp, y.to(f32), dy.to(f32), w.to(f32))
                  for xp, hp, y, dy, w in dirs]
            mode = gru_mod._LEAN_ROUND_DHP | (0 if k2b
                                              else gru_mod._LEAN_DXP_BF16)
            call = (lambda p=plan, d=up, m=m2, md=mode: gru_mod._lean(
                p, d, m, False, md))
        cases.append((f"{key} lean B={B} H={H} U={plan.U} rg={plan.rg} "
                      f"dirs={plan.ndir} grid={plan.grid} smem={plan.smem}",
                      "gru_lean.cu", call))
    return cases


def main() -> int:
    global _build, gru_mod, CSRC
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from tpuasr_torch import _build as b_mod
    from tpuasr_torch.ops import gru as g_mod
    _build, gru_mod = b_mod, g_mod
    CSRC = root / "tpuasr_torch" / "csrc"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), f"[{root}]", flush=True)
    T, H = 249, 512
    g = torch.Generator().manual_seed(0)
    n_sm = gru_mod._sm_count(torch.device("cuda"))

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    if args.bf16:
        src = (CSRC / "gru_lean.cu").read_text()
        ablations = {"gru_lean.cu": {part: pick(src, options) for part,
                                     options in ABLATIONS_BF16.items()}}
        cases = bf16_cases(rnd, n_sm)
    else:
        ablations = ABLATIONS
        cases = f32_cases(rnd, n_sm, T, H)
    jobs = [(src, name, edits) for src, parts in ablations.items()
            for name, edits in parts.items()]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip([(s, n) for s, n, _ in jobs], pool.map(
                lambda j: build(*j, Path(tmp)), jobs)))
        for label, source, call in cases:
            row = []
            for name in ablations[source]:
                ms = timed(libs[(source, name)], call)
                row.append(f"{name} {ms:.3f} ms ({ms / T * 1e3:.2f} us)")
            print(f"{label}: " + "; ".join(row), flush=True)
        if not args.bf16:
            chunk_sweep(libs[("gru_bidir.cu", "as is")], rnd, n_sm, T)
    return 0


def f32_cases(rnd, n_sm, T, H):
    """(label, source, call) of the f32 recurrences at config 3's layer."""
    wh = [rnd(H, 3 * H, scale=H ** -0.5) for _ in range(2)]
    cases = []                           # (label, source, call)
    for B in (16, 64, 128):
        plan = gru_mod._bidir_f32_plan(B, H, n_sm)
        xps, m2 = (rnd(T, B, 3 * H), rnd(T, B, 3 * H)), torch.ones(
            T, B, device="cuda")
        cases.append((f"K7-f32 B={B} U={plan.U} rg={plan.rg} "
                      f"dirs={plan.ndir} grid={plan.grid}", "gru_bidir.cu",
                      lambda p=plan, x=xps, m=m2: gru_mod._bidir_f32(
                          p, x, wh, m)))
    for Hk, B in ((512, 16), (512, 64), (384, 16), (384, 64)):
        plan = gru_mod._f32_rec_plan(B, Hk, n_sm)
        xp, m2 = rnd(T, B, 3 * Hk), torch.ones(T, B, device="cuda")
        whk = rnd(Hk, 3 * Hk, scale=Hk ** -0.5)
        cases.append((f"K5 fwd H={Hk} B={B} U={plan.U} rg={plan.rg} "
                      f"grid={plan.grid}", "gru_bidir.cu",
                      lambda p=plan, x=xp, w=whk, m=m2: gru_mod._bidir_f32(
                          p, (x,), (w,), m)))
    for key, B, ndir in (("K5b", 16, 1), ("K5b", 64, 1), ("K7b", 16, 2),
                         ("K7b", 128, 2)):
        plan = gru_mod._lean_plan(B, H, ndir, n_sm)
        ysp = [rnd(T, B, H, scale=0.5) for _ in range(ndir)]
        dirs = [(rnd(T, B, 3 * H), gru_mod._hp(ysp[d], wh[d]), ysp[d],
                 rnd(T, B, H), wh[d]) for d in range(ndir)]
        m2 = torch.ones(T, B, device="cuda")
        cases.append((f"{key} lean B={B} U={plan.U} rg={plan.rg} "
                      f"dirs={plan.ndir} grid={plan.grid}", "gru_lean.cu",
                      lambda p=plan, d=dirs, m=m2: gru_mod._lean(
                          p, d, m, False)))
    return cases


def chunk_sweep(lib, rnd, n_sm, T):
    """K5's forward as it is, its contraction staged in chunks of 128, 256
    and all of H."""
    for Hk, B in ((512, 16), (512, 64), (384, 16), (384, 64)):
        base = gru_mod._f32_rec_plan(B, Hk, n_sm)
        xp, m2 = rnd(T, B, 3 * Hk), torch.ones(T, B, device="cuda")
        whk = rnd(Hk, 3 * Hk, scale=Hk ** -0.5)
        row = []
        for kc in (128, 256, -(-Hk // 128) * 128):
            plan = gru_mod.RowGroupPlan(
                base.U, base.rg, kc, gru_mod._bidir_f32_smem(Hk, base.U, kc),
                base.grid, 1)
            ms = timed(lib, lambda p=plan: gru_mod._bidir_f32(
                p, (xp,), (whk,), m2))
            row.append(f"kc={kc} {ms:.3f} ms ({ms / T * 1e3:.2f} us)")
        print(f"K5 fwd H={Hk} B={B} U={base.U} rg={base.rg} by "
              f"contraction chunk: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
