"""Time chip_smoke's train steps in this checkout and another, in turns.

    python3 tools/train_step_time.py --root DIR [--rounds 2] [--out FILE]

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
as JSON. Needs one CUDA card and nvcc.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="the other checkout (e.g. the parent)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    roots = {"other": Path(args.root).resolve(), "this": HERE}
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
