"""Time chip_smoke's serving arms through Recognizer on one card.

    python3 tools/serve_arm_time.py [--root DIR] [--tag NAME] [--rounds N]

The int8, bf16, int8 + int8_conv and bf16 + fused_bidir arms of BASELINE
config 5 (DeepSpeechCTC 512 x 4, 64 classes, beam K=8, random weights from
seed 0) and the int8 arm's two graph arms (the scan search on the bench LG,
bench.py:183-201, at class_topk 8 and 63: "graph P=8", "graph P=63") on a
batch of B=128 x 10 s of seeded noise at 8 kHz: ms a batch from CUDA
events (mean of 5 after a warm-up), and the wall ms a batch (host clock
around synchronised calls, mean of 3), each arm in turn, --rounds times, so
that the spread between rounds shows; in the first round also each arm's
device ms of one batch (torch.profiler, the sum of the kernels' device
times). --root imports tpuasr_torch from another
checkout (for example the parent commit, unpacked by git archive), so two
trees can be timed in turns in one call: parent, change, change, parent.
Prints the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # noqa: E402  (its settings, helpers)
    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m.startswith("tpuasr_torch")]:
        del sys.modules[name]
    from tpuasr_torch import _build
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.models import create_model
    from tpuasr_torch.serve.offline import Recognizer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{args.tag or args.root}] {card}", flush=True)
    _build.lib()
    feat_cfg = FeatureConfig(sample_rate=cs.SR, n_mels=64)
    arms = {
        "int8": dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                     int8_proj=True, int8_rec=True),
        "bf16": dict(pallas_gru=True, bf16_gru=True, fused_proj=True),
        "int8+int8_conv": dict(pallas_gru=True, bf16_gru=True,
                               fused_proj=True, int8_proj=True,
                               int8_rec=True, int8_conv=True),
        "bf16+fused_bidir": dict(pallas_gru=True, bf16_gru=True,
                                 fused_bidir=True),
    }
    base = dict(num_classes=cs.NUM_CLASSES, rnn_hidden=cs.HIDDEN,
                rnn_layers=cs.LAYERS, in_features=feat_cfg.n_mels)
    state = create_model("deepspeech_ctc", **base, **arms["int8"],
                         generator=torch.Generator().manual_seed(cs.SEED)
                         ).state_dict()
    bcfg = BeamSearchConfig(beam_width=cs.BEAM, max_len=256)
    recs = {}
    for arm, flags in arms.items():
        model = create_model("deepspeech_ctc", **base, **flags,
                             device="cuda")
        model.load_state_dict(cs.fused_bidir_state(state)
                              if flags.get("fused_bidir") else state)
        recs[arm] = Recognizer(model, feat_cfg, bcfg, "cuda")
    tabs, _, _ = cs.bench_graph()
    for P in (8, cs.NUM_CLASSES - 1):
        recs[f"graph P={P}"] = Recognizer(
            recs["int8"].model, feat_cfg,
            BeamSearchConfig(beam_width=cs.BEAM, class_topk=P, max_len=256),
            "cuda", graph=tabs)
    S = int(cs.SR * cs.SECONDS)
    wav = torch.as_tensor((np.random.default_rng(cs.SEED).standard_normal(
        (cs.B, S)) * 0.1).astype(np.float32), device="cuda")
    lens = torch.full((cs.B,), S, dtype=torch.int32, device="cuda")
    audio_s = cs.B * cs.SECONDS
    for r in range(args.rounds):
        row = []
        for arm, rec in recs.items():
            ms = cs.cuda_ms(lambda: rec(wav, lens), 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                rec(wav, lens)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            dev = ""
            if r == 0:
                dev = ", device " + cs.device_breakdown(
                    lambda: rec(wav, lens), top=3)
            row.append(f"{arm} {ms:.2f} ms ({audio_s / (ms / 1e3):.1f}x), "
                       f"wall {wall:.2f} ms{dev}")
        print(f"round {r}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
