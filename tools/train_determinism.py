"""Find which operations of the float32 train step differ from run to run.

    python3 tools/train_determinism.py [--time] [--out FILE]

Config 3's model (the deepspeech_ctc preset: 512 x 4 BiGRU, float32,
TF32 off) with the fused featurizer, on two seeded batches of B=16
utterances: one at chip_smoke phase 11's length (0.9 s, U=6) and one at
config 3's (5 s, U=24), lengths ragged. For each batch and setting, the
same training forward and backward runs twice from the same weights, and
the loss and every parameter's gradient are compared bit for bit (the
parameters that differ and their largest |difference| are printed):

  default          the port as it runs (cuDNN picks its algorithms);
  cudnn.deterministic
                   torch.backends.cudnn.deterministic = True.

Then one step under torch.use_deterministic_algorithms(True,
warn_only=True), which names the operations PyTorch knows to be
nondeterministic. --time times ``Trainer.train_step`` with each setting in
turns (default, deterministic, deterministic, default; the mean of 10
steps after 2 warm-up steps, CUDA events) at both batches and at config
3's B=64. Prints the card's name and power limit first; --out writes the
results as JSON. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SR = 8000
B = 16


def make_batch(seconds: float, U: int, C: int, seed: int,
               n: int = B) -> dict:
    rng = np.random.default_rng(seed)
    S = int(SR * seconds)
    lens = np.linspace(S // 2, S, n).astype(np.int32)
    wav = (rng.standard_normal((n, S)) * 0.2).astype(np.float32)
    for i, m in enumerate(lens):
        wav[i, m:] = 0.0
    return dict(wav=wav, wav_lens=lens,
                tokens=rng.integers(1, C, (n, U)).astype(np.int32),
                token_lens=np.full((n,), U, np.int32),
                real=np.ones((n,), bool))


def step_ms(trainer, batch, steps: int = 10) -> float:
    """Mean ms of ``steps`` train steps after 2 warm-up steps (CUDA
    events), from a fresh state."""
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        state, _ = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / steps, 3)


def gradients(trainer, state, batch):
    """(loss, {name: gradient}) of one training forward and backward."""
    from tpuasr_torch.precision import full_fp32

    model = state.model
    for p in model.parameters():
        p.grad = None
    with full_fp32():
        loss, _, _ = trainer._loss_fn(model, trainer._batch(batch), True, 0)
        loss.backward()
    torch.cuda.synchronize()
    return loss.detach().clone(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()}


def compare(trainer, state, batch) -> dict:
    la, ga = gradients(trainer, state, batch)
    lb, gb = gradients(trainer, state, batch)
    diffs = {n: float((ga[n] - gb[n]).abs().max()) for n in ga
             if not torch.equal(ga[n], gb[n])}
    return {"loss_equal": bool(torch.equal(la, lb)),
            "params": len(ga), "differ": dict(sorted(
                diffs.items(), key=lambda kv: -kv[1]))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import TrainConfig, Trainer
    from tpuasr_torch.utils.params import preset_for

    kwargs, overrides = preset_for("deepspeech_ctc")
    C = 64
    trainer = Trainer(TrainConfig(model="deepspeech_ctc", num_classes=C,
                                  model_kwargs=kwargs, fused_featurizer=True,
                                  **overrides), FeatureConfig(), "cuda")
    state = trainer.init_state()
    batches = {"phase 11 (0.9 s, U=6)": make_batch(0.9, 6, C, 0),
               "config 3 (5 s, U=24)": make_batch(5.0, 24, C, 1)}
    results = {"card": card}
    for name, batch in batches.items():
        for setting in ("default", "cudnn.deterministic"):
            torch.backends.cudnn.deterministic = setting != "default"
            r = compare(trainer, state, batch)
            results[f"{name}, {setting}"] = r
            top = list(r["differ"].items())[:6]
            print(f"{name}, {setting}: loss bit for bit {r['loss_equal']}; "
                  f"{len(r['differ'])} of {r['params']} gradients differ; "
                  f"largest {top} [{card}]", flush=True)
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gradients(trainer, state, batch)
        torch.use_deterministic_algorithms(False)
        named = sorted({str(w.message).split(".")[0] for w in caught
                        if "deterministic" in str(w.message)})
        results[f"{name}, flagged"] = named
        print(f"{name}: operations PyTorch flags as nondeterministic: "
              f"{named}", flush=True)
    if args.time:
        batches["config 3 (5 s, U=24, B=64)"] = make_batch(5.0, 24, C, 2,
                                                          n=64)
        for name, batch in batches.items():
            ms = {"default": [], "cudnn.deterministic": []}
            for setting in ("default", "cudnn.deterministic",
                            "cudnn.deterministic", "default"):
                torch.backends.cudnn.deterministic = setting != "default"
                ms[setting].append(step_ms(trainer, batch))
            torch.backends.cudnn.deterministic = False
            results[f"{name}, step ms"] = ms
            print(f"{name}: train step ms, default {ms['default']}, "
                  f"cudnn.deterministic {ms['cudnn.deterministic']} "
                  f"[{card}]", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
