"""Time chip_smoke's train steps in this checkout and another, in turns;
or, with --bits, compare their outputs bit for bit.

    python3 tools/train_step_time.py --root DIR [--rounds 2] [--out FILE]
    python3 tools/train_step_time.py --root DIR --bits

The steps of chip_smoke phases 7, 8 and 10 through ``Trainer.train_step``:
config 3's DeepSpeechCTC (512 x 4 BiGRU, float32, K5/K5b) at B=16 x 5 s,
U=24; config 4's CapsNet (capsule1, 48 classes) at B=8 and B=32 x 5 s,
U=16; config 2's ResNet-CTC preset at B=16 x 5 s, U=24. Each checkout runs
in a process of its own (``--worker``, with the checkout first on the
path; each builds its own kernels), in turns: DIR, this checkout, this
checkout, DIR (``--rounds`` such pairs). A worker times each step after 2
warm-up steps: the device time of a step (the sum of the device kernels'
self times under torch.profiler over 5 steps, divided by 5; the rows are
chip_smoke's ``device_rows``, this checkout's in both turns) and its wall
(CUDA events around 10 steps). Prints the card's name and power limit,
each turn's numbers, and each checkout's numbers sorted; --out writes them
as JSON.

--bits: each checkout computes, from seeded inputs on the card, the f32
GRU kernels and their backwards (K5, K5b, K7 and K7b at config 3's width,
K2 and K2b at deepspeech_var's), the bf16 serving kernels (K2, K7), the
serving arms' log-probs (f32 kernel path, bf16, int8, bf16 + fused_bidir)
and two f32 config-3 train steps (loss, grad-norm, every parameter after
them); prints how many of the outputs are equal (torch.equal) and names
the others. Exits 1 if any differs.

Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SR = 8000
SECONDS = 5.0


def _batch(n: int, U: int, C: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    S = int(SR * SECONDS)
    wav = (rng.standard_normal((n, S)) * 0.2).astype(np.float32)
    tok = rng.integers(1, C, (n, U)).astype(np.int32)
    return {k: torch.as_tensor(v, device="cuda") for k, v in dict(
        wav=wav, wav_lens=np.full((n,), S, np.int32), tokens=tok,
        token_lens=np.full((n,), U, np.int32),
        real=np.ones((n,), np.float32)).items()}


def worker() -> dict:
    """Each step's device and event ms in the checkout on PYTHONPATH."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # noqa: E402  (its device-row filter)
    sys.path.remove(str(HERE))

    from tpuasr_torch import _build
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import TrainConfig, Trainer
    from tpuasr_torch.utils.params import preset_for

    _build.build()
    _build.lib()
    resnet_kw, resnet_train = preset_for("resnet_ctc")
    steps = {
        "7 config 3 B=16": (TrainConfig(
            model="deepspeech_ctc", num_classes=64, warmup_steps=1,
            model_kwargs=dict(rnn_hidden=512, rnn_layers=4,
                              pallas_gru=True)), 16, 24, 64),
        "8 capsnet B=8": (TrainConfig(model="capsule1", num_classes=48,
                                      warmup_steps=1), 8, 16, 48),
        "8 capsnet B=32": (TrainConfig(model="capsule1", num_classes=48,
                                       warmup_steps=1), 32, 16, 48),
        "10 resnet B=16": (TrainConfig(
            model="resnet_ctc", num_classes=64, warmup_steps=1,
            model_kwargs=resnet_kw, **resnet_train), 16, 24, 64),
    }
    out = {}
    for name, (cfg, n, U, C) in steps.items():
        trainer = Trainer(cfg, FeatureConfig(), device="cuda")
        batch = _batch(n, U, C)
        state = trainer.init_state()
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            state, _ = trainer.train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in cs.device_rows(prof))
        out[name] = {"device_ms": round(dev_us / 5e3, 3),
                     "events_ms": round(start.elapsed_time(end) / 10, 3)}
        del trainer, state, batch
        torch.cuda.empty_cache()
    return out


def bits_outputs() -> dict:
    """--bits: every compared output, on the CPU, keyed by name."""
    import numpy as np
    import torch

    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.models import create_model
    from tpuasr_torch.ops import gru as g
    from tpuasr_torch.precision import full_fp32
    from tpuasr_torch.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    T, B, H = 249, 16, 512
    mask = (torch.arange(T)[:, None] < torch.randint(
        T // 2, T + 1, (B,), generator=gen)[None, :]).float()[:, :, None]
    mask = mask.to(dev).contiguous()
    with full_fp32():
        xp, wh = rnd(T, B, 3 * H), rnd(H, 3 * H, scale=H ** -0.5)
        dys = rnd(T, B, H)
        for rev in (False, True):
            ys = g.gru_scan_fwd(xp, wh, mask, rev)
            out[f"K5 rev={rev}"] = ys
            dxp, dwh = g.gru_scan_bwd(xp, g.prev_states(ys, rev), wh, mask,
                                      dys, rev)
            out[f"K5b dxp rev={rev}"], out[f"K5b dwh rev={rev}"] = dxp, dwh
        xpb, whb = rnd(T, B, 3 * H), rnd(H, 3 * H, scale=H ** -0.5)
        dysb = rnd(T, B, H)
        ysf, ysb = g.gru_scan_bidir_fwd(xp, xpb, wh, whb, mask)
        out["K7-f32 ysf"], out["K7-f32 ysb"] = ysf, ysb
        for i, t in enumerate(g.gru_scan_bidir_bwd(
                xp, xpb, g.prev_states(ysf, False), g.prev_states(ysb, False),
                wh, whb, mask, dys, dysb)):
            out[f"K7b {i}"] = t
        Hv, D = 384, 768
        x, wx = rnd(T, B, D), rnd(D, 3 * Hv, scale=D ** -0.5)
        b, whv = rnd(3 * Hv, scale=0.1), rnd(Hv, 3 * Hv, scale=Hv ** -0.5)
        ysv = g.gru_scan_xfused(x, wx, b, whv, mask)
        out["K2-f32"] = ysv
        for i, t in enumerate(g.gru_scan_xfused_bwd(
                x, g.prev_states(ysv, False), wx, b, whv, mask,
                rnd(T, B, Hv))):
            out[f"K2b {i}"] = t
    bf = torch.bfloat16
    out["K2 bf16"] = g.gru_scan_xfused(
        rnd(T, B, 2 * H, dtype=bf), rnd(2 * H, 3 * H, dtype=bf, scale=0.03),
        rnd(3 * H), wh.to(bf), mask)
    out["K7 bf16 f"], out["K7 bf16 b"] = g.gru_scan_bidir_fwd(
        xp.to(bf), xpb.to(bf), wh.to(bf), whb.to(bf), mask)

    # The serving arms' log-probs on seeded features (B=4 x 5 s).
    base = dict(num_classes=64, rnn_hidden=H, rnn_layers=4, in_features=64)
    arms = {"f32": dict(pallas_gru=True, fused_proj=True),
            "bf16": dict(pallas_gru=True, bf16_gru=True, fused_proj=True),
            "int8": dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                         int8_proj=True, int8_rec=True),
            "bf16+fused_bidir": dict(pallas_gru=True, bf16_gru=True,
                                     fused_bidir=True)}
    feats = rnd(4, 499, 64)
    lens = torch.tensor([499, 400, 300, 17], device=dev)
    for arm, kw in arms.items():
        model = create_model("deepspeech_ctc", **base, **kw, device=dev,
                             generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            out[f"arm {arm}"] = model(feats, lens)[0]

    # Two f32 config-3 train steps (B=4 x 5 s, U=24).
    cfg = TrainConfig(model="deepspeech_ctc", num_classes=64,
                      warmup_steps=1, model_kwargs=dict(
                          rnn_hidden=H, rnn_layers=4, pallas_gru=True))
    tr = Trainer(cfg, FeatureConfig(), device="cuda")
    batch = _batch(4, 24, 64)
    state = tr.init_state()
    for step in range(2):
        state, m = tr.train_step(state, batch)
        out[f"train loss {step}"] = m["loss"]
        out[f"train grad_norm {step}"] = m["grad_norm"]
    for k, v in state.model.state_dict().items():
        out[f"train {k}"] = v
    return {k: torch.as_tensor(v).detach().cpu() for k, v in out.items()}


def bits(roots: dict) -> int:
    """--bits: each checkout's outputs in a process of its own, compared."""
    import tempfile

    import torch

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for who, root in roots.items():
            path = Path(tmp) / f"{who}.pt"
            res = subprocess.run(
                [sys.executable, __file__, "--bits-dump", str(path)],
                capture_output=True, text=True, cwd=root,
                env=dict(os.environ, PYTHONPATH=str(root)))
            if res.returncode != 0:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            got[who] = torch.load(path)
    a, b = got["this"], got["other"]
    if set(a) != set(b):
        print(f"outputs differ in name: {sorted(set(a) ^ set(b))}")
        return 1
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    for k in differ:
        d = (a[k].float() - b[k].float()).abs().max().item()
        print(f"differs: {k} (max abs {d:.3e})")
    print(f"{len(a) - len(differ)} of {len(a)} outputs equal bit for bit "
          f"to {roots['other']}")
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="the other checkout (e.g. the parent)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--bits", action="store_true",
                    help="compare outputs bit for bit instead of timing")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--bits-dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()))
        return 0
    if args.bits_dump:
        import torch
        torch.save(bits_outputs(), args.bits_dump)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    roots = {"other": Path(args.root).resolve(), "this": HERE}
    if args.bits:
        return bits(roots)
    order = ["other", "this", "this", "other"] * args.rounds
    turns = {k: [] for k in roots}
    for who in order:
        root = roots[who]
        res = subprocess.run([sys.executable, __file__, "--worker"],
                             capture_output=True, text=True, cwd=root,
                             env=dict(os.environ, PYTHONPATH=str(root)))
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        turns[who].append(got)
        print(f"{who} ({root}): {json.dumps(got)} [{card}]", flush=True)
    summary = {}
    for who, runs in turns.items():
        summary[who] = {name: {k: sorted(r[name][k] for r in runs)
                               for k in ("device_ms", "events_ms")}
                        for name in runs[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": card, "turns": turns, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
