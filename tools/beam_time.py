"""Time the served beam search and the int8 serving arm on one card.

    python3 tools/beam_time.py [--root DIR] [--tag NAME] [--rounds N]

At the served shape (B=128 utterances, T'=499 frames, C=64 classes, beam
K=8, max_len 256, seeded log-probs) it splits decode/beam.py::
ctc_beam_search into K3 (beam_scan: CUDA events, mean of 10), the
backtrack of the packed backpointers (host clock around a synchronised
call, mean of 5, and the CUDA kernels it launches, counted by
torch.profiler) and the rest of the wrapper, and gives the search's wall
time (host clock) against its device time (torch.profiler). Then BASELINE
config 5's int8 arm (DeepSpeechCTC 512 x 4, int8_proj + int8_rec, random
weights from seed 0) through Recognizer on B=128 x 10 s of seeded noise:
wall ms a batch (host clock around synchronised calls, mean of 5) against
the device time of one batch (torch.profiler), each --rounds times.
--root imports tpuasr_torch from another checkout (for example the parent
commit, unpacked by git archive), so two trees can be timed in turns in one
call: parent, change, change, parent, each in its own process. Prints the
card's name and power limit first. Needs one CUDA card and nvcc.
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


def wall_ms(fn, iters: int = 5) -> float:
    """Mean host-clock ms of a call that ends synchronised, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ms(fn) -> tuple[float, int]:
    """(device ms, CUDA kernels launched) of one call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "_", "autograd::"))]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--rounds", type=int, default=2)
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
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.models import create_model
    from tpuasr_torch.serve.offline import Recognizer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tag = args.tag or args.root
    print(f"[{tag}] {card}", flush=True)
    _build.lib()
    B, T, C, K = cs.B, 499, cs.NUM_CLASSES, cs.BEAM
    g = torch.Generator().manual_seed(cs.SEED)
    lp = torch.log_softmax(torch.randn(B, T, C, generator=g) * 2.0, -1)
    lp = lp.cuda().contiguous()
    lens = torch.randint(1, T + 1, (B,), generator=g).to(torch.int32)
    lens[0] = T
    lens = lens.cuda()
    cfg = BeamSearchConfig(beam_width=K, max_len=256)
    k3 = cs.cuda_ms(lambda: beam_mod.beam_scan(lp, lens, K, 0, 256), 10)
    bp = beam_mod.beam_scan(lp, lens, K, 0, 256)[0]
    idx = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    bt = wall_ms(lambda: beam_mod.backtrack(bp, idx, 256))
    _, bt_n = device_ms(lambda: beam_mod.backtrack(bp, idx, 256))
    search = wall_ms(lambda: beam_mod.ctc_beam_search(lp, lens, cfg))
    search_dev, _ = device_ms(lambda: beam_mod.ctc_beam_search(lp, lens,
                                                               cfg))
    print(f"[{tag}] ctc_beam_search B={B} T={T} C={C} K={K}: wall "
          f"{search:.3f} ms, device {search_dev:.3f} ms; K3 {k3:.3f} ms "
          f"(CUDA events), backtrack {bt:.3f} ms wall ({bt_n} kernel "
          f"launches), the rest {search - k3 - bt:.3f} ms", flush=True)

    feat_cfg = FeatureConfig(sample_rate=cs.SR, n_mels=64)
    kw = dict(num_classes=C, rnn_hidden=cs.HIDDEN, rnn_layers=cs.LAYERS,
              in_features=feat_cfg.n_mels, pallas_gru=True, bf16_gru=True,
              fused_proj=True, int8_proj=True, int8_rec=True)
    state = create_model("deepspeech_ctc", **kw,
                         generator=torch.Generator().manual_seed(cs.SEED)
                         ).state_dict()
    model = create_model("deepspeech_ctc", **kw, device="cuda")
    model.load_state_dict(state)
    rec = Recognizer(model, feat_cfg, cfg, "cuda")
    S = int(cs.SR * cs.SECONDS)
    wav = torch.as_tensor((np.random.default_rng(cs.SEED).standard_normal(
        (B, S)) * 0.1).astype(np.float32), device="cuda")
    wl = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for r in range(args.rounds):
        wall = wall_ms(lambda: rec(wav, wl))
        dev, n = device_ms(lambda: rec(wav, wl))
        print(f"[{tag}] round {r}: int8 arm B={B} x {cs.SECONDS:.0f} s: wall "
              f"{wall:.2f} ms a batch ({B * cs.SECONDS / (wall / 1e3):.1f}x "
              f"real time), device {dev:.2f} ms ({n} kernel launches), gap "
              f"{wall - dev:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
