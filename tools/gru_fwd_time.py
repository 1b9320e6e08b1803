"""Time the float32 GRU forward kernels (K7-f32, K5) on one card.

    python3 tools/gru_fwd_time.py [--root DIR] [--tag NAME] [--out FILE]

K7 in float32 (gru_scan_bidir_fwd, both directions) at config 3's layer
(H=512, D=1024 for cuDNN) at every batch the fused_bidir train step runs
(B=16, 64 and 128 at T'=249) and at the served shape (B=128, T'=499),
beside cuDNN's bidirectional forward in full float32 (torch.nn.GRU, b_hh =
0; its time includes the input projection); K5's forward (gru_scan_fwd) at
H=512 and 384, B=16 and 64 (since PR 13 it runs csrc/gru_bidir.cu's
recurrence at one direction, which K2's f32 recurrence shares); and, where
the tree has it (ops/gru.py::_bidir_f32), that recurrence at one
direction under its one-direction plan (_f32_rec_plan; PR 12's tree:
_bidir_f32_plan with ndir=1) at those shapes. CUDA
events, mean of 10 calls after a warm-up, TF32 off. --root imports
tpuasr_torch from another checkout (for example the parent commit,
unpacked by git archive), so two trees can be timed in turns in one call:
parent, change, change, parent. Prints the card's name and power limit
first; with --out, writes the numbers as JSON. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # noqa: E402  (its timing helpers)
    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m.startswith("tpuasr_torch")]:
        del sys.modules[name]
    from tpuasr_torch import _build
    from tpuasr_torch.ops import gru as g
    from tpuasr_torch.precision import full_fp32

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{args.tag or args.root}] {card}", flush=True)
    _build.lib()
    gen = torch.Generator().manual_seed(0)
    res = {"card": card, "root": args.root, "tag": args.tag}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def masked(T, B):
        lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
        lens[0] = T
        m = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
        return m.cuda().contiguous()

    with full_fp32():
        D, H = 1024, 512
        for T, B in ((249, 16), (249, 64), (249, 128), (499, 128)):
            a = (rnd(T, B, 3 * H), rnd(T, B, 3 * H),
                 rnd(H, 3 * H, scale=H ** -0.5),
                 rnd(H, 3 * H, scale=H ** -0.5), masked(T, B))
            ms = cs.cuda_ms(lambda: g.gru_scan_bidir_fwd(*a), 10)
            r = {"ms": ms, "us_a_step": ms / T * 1e3,
                 "cudnn_ms": cs.library_gru_ms(T, B, D, H, torch.float32,
                                               False, bidirectional=True)}
            if hasattr(g, "_bidir_f32_plan"):
                r["plan"] = str(g._bidir_f32_plan(B, H,
                                                  g._sm_count(a[0].device)))
            res[f"K7-f32 T={T} B={B}"] = r
            print(f"K7-f32 T={T} B={B} H={H}: {json.dumps(r)}", flush=True)
            del a
            torch.cuda.empty_cache()
        T = 249
        for H in (512, 384):
            for B in (16, 64):
                xp, wh = rnd(T, B, 3 * H), rnd(H, 3 * H, scale=H ** -0.5)
                mask = torch.ones(T, B, 1, device="cuda")
                r = {"k5_ms": cs.cuda_ms(lambda: g.gru_scan_fwd(xp, wh, mask),
                                         10)}
                if hasattr(g, "_bidir_f32"):
                    n_sm = g._sm_count(xp.device)
                    plan = (g._f32_rec_plan(B, H, n_sm)
                            if hasattr(g, "_f32_rec_plan")
                            else g._bidir_f32_plan(B, H, n_sm, ndir=1))
                    r["one_direction_ms"] = cs.cuda_ms(
                        lambda: g._bidir_f32(plan, (xp,), (wh,),
                                             mask.reshape(T, B)), 10)
                res[f"K5 fwd T={T} B={B} H={H}"] = r
                print(f"K5 fwd T={T} B={B} H={H}: {json.dumps(r)}",
                      flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
