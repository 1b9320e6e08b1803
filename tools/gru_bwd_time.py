"""Time the GRU backward kernels (K2b, K7b, K5b) on one card, in float32
and with bf16 streams.

    python3 tools/gru_bwd_time.py [--root DIR] [--tag NAME] [--out FILE]

At the shapes the train steps of chip_smoke.py run (T'=249): K2b at the
deepspeech_var preset's layer (D=768, H=384, B=16 and 64) beside the
recompute route (xp by a matmul, K5b, three matmuls) and cuDNN's GRU
backward; K7b at config 3's layer (H=512, D=1024 for cuDNN, B=16, 64 and
128) beside cuDNN's bidirectional backward; K5b at H=512, B=16 and 64,
beside cuDNN's backward. Where the tree has the three-phase backward
(ops/gru.py::_lean; for K5b, where it has no _k5b_plan), its phases are
timed apart too (that checkout's chip_smoke.bwd_phases). Then the bf16 forms at the
shapes of chip_smoke's phase 3: K5b-bf16 at H=512, B=16 and 64, K7b-bf16
at B=16 and 64, K2b-bf16 at D=512 and 768, H=384, B=16, beside
torch.nn.GRU in bf16, their phases apart. CUDA events, mean of 10 calls after a
warm-up, TF32 off. Each f32 output's digest (sha256 of its bytes, 16 hex
digits) is printed beside its time, so that two trees' f32 bits compare
line for line; inputs come from one seeded generator in the same order
in every tree. --root imports tpuasr_torch from another checkout (for
example the parent commit, unpacked by git archive), so two trees can be
timed in turns in one call: parent, change, change, parent. Prints the
card's name and power limit first; with --out, writes the numbers as
JSON. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
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
    # The checkout's own chip_smoke (its timing helpers and bwd_phases,
    # which call that tree's private phase functions) and package.
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs            # noqa: E402
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
    phased = hasattr(g, "_lean")
    gen = torch.Generator().manual_seed(0)
    T = 249
    res = {"card": card, "root": args.root, "tag": args.tag}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def masked(B):
        lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
        lens[0] = T
        m = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
        return m.cuda().contiguous()

    def ms(fn):
        return cs.cuda_ms(fn, 10)

    def digests(outs):
        return [hashlib.sha256(t.detach().contiguous().cpu().numpy()
                               .tobytes()).hexdigest()[:16] for t in outs]

    with full_fp32():
        D, H = 768, 384
        for B in (16, 64):
            x, mask = rnd(T, B, D), masked(B)
            wx, b = rnd(D, 3 * H, scale=D ** -0.5), rnd(3 * H, scale=0.1)
            wh, dys = rnd(H, 3 * H, scale=H ** -0.5), rnd(T, B, H)
            ysp = g.prev_states(g.gru_scan_xfused(x, wx, b, wh, mask), False)
            a = (x, ysp, wx, b, wh, mask, dys, False)

            def recompute():
                xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H)
                dxp, dwh = g.gru_scan_bwd(xp, ysp, wh, mask, dys, False)
                dxp2 = dxp.reshape(T * B, 3 * H)
                return (dxp2 @ wx.T, x.reshape(T * B, D).T @ dxp2,
                        dxp2.sum(0), dwh)

            r = {"ms": ms(lambda: g.gru_scan_xfused_bwd(*a)),
                 "digests": digests(g.gru_scan_xfused_bwd(*a)),
                 "recompute_ms": ms(recompute),
                 "cudnn_ms": cs.library_gru_ms(T, B, D, H, torch.float32,
                                               True)}
            if phased:
                r["phases"] = cs.bwd_phases(g, "K2b", a)
            res[f"K2b B={B}"] = r
            print(f"K2b T={T} B={B} D={D} H={H}: {json.dumps(r)}",
                  flush=True)
            del x, ysp, a
        D, H = 1024, 512
        for B in (16, 64, 128):
            mask = masked(B)
            xpf, xpb = rnd(T, B, 3 * H), rnd(T, B, 3 * H)
            whf, whb = rnd(H, 3 * H, scale=H ** -0.5), rnd(
                H, 3 * H, scale=H ** -0.5)
            ysf, ysb = g.gru_scan_bidir_fwd(xpf, xpb, whf, whb, mask)
            yspf, yspb = g.prev_states(ysf, False), g.prev_states(ysb, False)
            dysf, dysb = rnd(T, B, H), rnd(T, B, H)
            a = (xpf, xpb, yspf, yspb, whf, whb, mask, dysf, dysb)
            r = {"ms": ms(lambda: g.gru_scan_bidir_bwd(*a)),
                 "digests": digests(g.gru_scan_bidir_bwd(*a)),
                 "cudnn_ms": cs.library_gru_ms(T, B, D, H, torch.float32,
                                               True, bidirectional=True)}
            if phased:
                r["phases"] = cs.bwd_phases(g, "K7b", a)
            res[f"K7b B={B}"] = r
            print(f"K7b T={T} B={B} H={H}: {json.dumps(r)}", flush=True)
            if B <= 64:
                a5 = (xpf, yspf, whf, mask, dysf, False)
                r5 = {"ms": ms(lambda: g.gru_scan_bwd(*a5)),
                      "digests": digests(g.gru_scan_bwd(*a5)),
                      "cudnn_ms": cs.library_gru_ms(T, B, D, H,
                                                    torch.float32, True)}
                if phased and not hasattr(g, "_k5b_plan"):
                    r5["phases"] = cs.bwd_phases(g, "K5b", a5)
                res[f"K5b B={B}"] = r5
                print(f"K5b T={T} B={B} H={H}: {json.dumps(r5)}", flush=True)
            del a, xpf, xpb, ysf, ysb, yspf, yspb, dysf, dysb
            torch.cuda.empty_cache()
    bf16_forms(g, cs, gen, masked, res, args.tag or args.root, phased)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


def bf16_forms(g, cs, gen, masked, res, who, phased) -> None:
    """K5b-bf16, K7b-bf16 and K2b-bf16 at phase 3's shapes: ms, the
    phases (as the tree's bwd_phases runs them), torch.nn.GRU in bf16."""
    T, H, bf = 249, 512, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda().to(bf)

    def ms(fn):
        return cs.cuda_ms(fn, 10)

    def show(key, r):
        res[key] = r
        print(f"[{who}] {key}: {json.dumps(r)}", flush=True)

    for B in (16, 64):
        mask = masked(B)
        xp, wh, dys = rnd(T, B, 3 * H), rnd(H, 3 * H, scale=H ** -0.5), \
            rnd(T, B, H)
        a = (xp, g.prev_states(g.gru_scan_plain(xp, wh, mask), False), wh,
             mask, dys, False)
        r = {"ms": ms(lambda: g.gru_scan_bwd(*a)),
             "cudnn_ms": cs.library_gru_ms(T, B, 2 * H, H, bf, True)}
        if phased:
            r["phases"] = cs.bwd_phases(g, "K5b", a)
        show(f"K5b-bf16 T={T} B={B} H={H}", r)
        xps = [rnd(T, B, 3 * H) for _ in range(2)]
        whs = [rnd(H, 3 * H, scale=H ** -0.5) for _ in range(2)]
        ys = g.gru_scan_bidir_plain(*xps, *whs, mask)
        a = (*xps, *[g.prev_states(y, False) for y in ys], *whs, mask,
             *[rnd(T, B, H) for _ in range(2)])
        r = {"ms": ms(lambda: g.gru_scan_bidir_bwd(*a)),
             "cudnn_ms": cs.library_gru_ms(T, B, 2 * H, H, bf, True,
                                           bidirectional=True)}
        if phased:
            r["phases"] = cs.bwd_phases(g, "K7b", a)
        show(f"K7b-bf16 T={T} B={B} H={H}", r)
        del a, xps, ys
    Hv, B = 384, 16
    mask = masked(B)
    for D in (512, 768):
        x, wx = rnd(T, B, D), rnd(D, 3 * Hv, scale=D ** -0.5)
        b = (torch.randn(3 * Hv, generator=gen) * 0.1).cuda()
        wh, dys = rnd(Hv, 3 * Hv, scale=Hv ** -0.5), rnd(T, B, Hv)
        ys = g.gru_scan_xfused_plain(x, wx, b, wh, mask, False)
        a = (x, g.prev_states(ys, False), wx, b, wh, mask, dys, False)
        r = {"ms": ms(lambda: g.gru_scan_xfused_bwd(*a)),
             "cudnn_ms": cs.library_gru_ms(T, B, D, Hv, bf, True)}
        if phased:
            r["phases"] = cs.bwd_phases(g, "K2b", a)
        show(f"K2b-bf16 T={T} B={B} D={D} H={Hv}", r)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
