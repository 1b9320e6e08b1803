"""Time the fbank kernel (K1/K1b, csrc/fbank.cu) on one card.

    python3 tools/fbank_time.py [--parent DIR] [--clocks] [--ptxas]
                                [--precision] [--tiles]

Prints the card's name and power limit first. Then:
  * K1 at 8 kHz (B=128 and B=8 x 10 s) and K1b at 16 kHz (B=32 x 10 s),
    chip_smoke's inputs (seeded noise x 0.1): kernel ms a call, the
    plain version's beside it, each from a CUDA graph of 20 calls replayed
    after a warm-up (device time, no host time between launches);
  * with --tiles, K1 at 8 kHz x 10 s for B = 1, 4 and 8 at each tile
    height the plan can take (64 on wgmma, 32 and 16 on mma.sync), beside
    the plan's own choice;
  * with --ptxas, the registers, shared memory, spills and warnings
    (wgmma serialization among them) of the kernel's instances (nvcc
    -Xptxas -v);
  * with --clocks, the split of a tile's SM cycles into staging (to the
    first ring stage's barrier), the later stages' barriers and ring waits,
    issuing ring stages and the next span, the rDFT products, the rDFT
    epilogues (power into the shared tile), the mel products and the mel
    store, from a build with TPUASR_FBANK_CLOCKS (clock64 on thread 0 of
    each persistent CTA, in the first warpgroup, summed over its tiles;
    the readings cost a few cycles a stage), averaged over tiles;
  * with --precision, how far the kernel and the plain version (float32
    matmuls) each lie from the same function in float64, as the largest
    log difference (floor 1e-10), beside their difference from each other
    (chip_smoke's gate): fbank at 8 kHz B=128 x 10 s and the spectrogram
    (single bins, the most sensitive near a spectral null) at 8 kHz B=16;
  * with --parent DIR (a checkout of another commit, for example the parent
    unpacked by git archive), DIR's and this tree's fbank_power in turns in
    fresh processes (parent, change, change, parent): the three kernel
    shapes, and the int8 serving arm of tools/serve_arm_time.py (BASELINE
    config 5, B=128 x 10 s) a batch through Recognizer, 3 rounds each.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tpuasr_torch" / "csrc"
# (tag, sample rate, B): chip_smoke's K1 and K1b, and K1 at CapsNet's batch.
SHAPES = (("K1 8 kHz B=128", 8000, 128), ("K1 8 kHz B=8", 8000, 8),
          ("K1b 16 kHz B=32", 16000, 32))
PHASES = ("staging", "waits", "issue", "rDFT products", "rDFT epilogue",
          "mel products", "mel store")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=20):
    """Device ms a call: n calls captured in one CUDA graph, the graph
    replayed after a warm-up (no host time between launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * n)


def inputs(sr, nb, seed=0):
    """(cfg, tables, wav, T) of one shape; tables packed once where the
    package packs (as FusedFeaturizer does)."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features import fused
    from tpuasr_torch.features.reference import feature_tables, num_frames
    cfg = FeatureConfig(sample_rate=sr)
    tabs = feature_tables(cfg, "cuda")
    if hasattr(fused, "pack_tables"):
        tabs["packed"] = fused.pack_tables(tabs)
    S = int(sr * 10.0)
    g = torch.Generator().manual_seed(seed)
    wav = (torch.randn(nb, S, generator=g) * 0.1).cuda()
    return cfg, tabs, wav, num_frames(cfg, S)


def time_shapes(out: dict, plain: bool) -> None:
    from tpuasr_torch.features import fused
    for tag, sr, nb in SHAPES:
        cfg, tabs, wav, T = inputs(sr, nb)
        hop = cfg.hop_length
        out[tag] = graph_ms(lambda: fused.fbank_power(wav, tabs, hop, T))
        if plain:
            out[tag + " plain"] = graph_ms(
                lambda: fused.fbank_power_plain(wav, tabs, hop, T), 5)


def tile_heights() -> None:
    """K1 at 8 kHz x 10 s, B = 1, 4 and 8, at each tile height the plan
    can take: M = 64 (wgmma) against 32 and 16 (mma.sync)."""
    import functools
    from tpuasr_torch.features import fused
    real = fused.fbank_plan
    for nb in (1, 4, 8):
        cfg, tabs, wav, T = inputs(8000, nb)
        hop = cfg.hop_length
        row = {}
        for m in (64, 32, 16):
            with mock.patch.object(fused, "fbank_plan",
                                   functools.partial(real, M=m)):
                row[f"M={m}"] = round(graph_ms(
                    lambda: fused.fbank_power(wav, tabs, hop, T)), 4)
        row["plan"] = real(nb, T, hop, cfg.win_length, cfg.n_freqs,
                           cfg.base_dim).M
        print(f"K1 8 kHz B={nb} T={T}, ms a call by tile height: "
              + json.dumps(row), flush=True)


def int8_arm(out: dict, rounds: int = 3) -> None:
    """ms a batch of the int8 arm, as tools/serve_arm_time.py builds it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.models import create_model
    from tpuasr_torch.serve.offline import Recognizer
    feat_cfg = FeatureConfig(sample_rate=cs.SR, n_mels=64)
    flags = dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                 int8_proj=True, int8_rec=True)
    base = dict(num_classes=cs.NUM_CLASSES, rnn_hidden=cs.HIDDEN,
                rnn_layers=cs.LAYERS, in_features=feat_cfg.n_mels)
    state = create_model("deepspeech_ctc", **base, **flags,
                         generator=torch.Generator().manual_seed(cs.SEED)
                         ).state_dict()
    model = create_model("deepspeech_ctc", **base, **flags, device="cuda")
    model.load_state_dict(state)
    rec = Recognizer(model, feat_cfg, BeamSearchConfig(beam_width=cs.BEAM,
                                                       max_len=256), "cuda")
    S = int(cs.SR * cs.SECONDS)
    wav = torch.as_tensor((np.random.default_rng(cs.SEED).standard_normal(
        (cs.B, S)) * 0.1).astype(np.float32), device="cuda")
    lens = torch.full((cs.B,), S, dtype=torch.int32, device="cuda")
    out["int8 arm"] = [round(cs.cuda_ms(lambda: rec(wav, lens), 5), 3)
                       for _ in range(rounds)]


def precision() -> None:
    """Largest log-mel differences: kernel and plain against float64."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features import fused
    from tpuasr_torch.features.reference import (feature_tables, frames_plain,
                                                 num_frames)

    def log(x):
        return torch.log(x.double().clamp(min=1e-10))

    for kw, nb in ((dict(), 128), (dict(feature_type="spectrogram"), 16)):
        cfg = FeatureConfig(**kw)
        tabs = feature_tables(cfg, "cuda")
        tabs["packed"] = fused.pack_tables(tabs)
        S = int(cfg.sample_rate * 10.0)
        T = num_frames(cfg, S)
        g = torch.Generator().manual_seed(1)
        wav = (torch.randn(nb, S, generator=g) * 0.1).cuda()
        got = fused.fbank_power(wav, tabs, cfg.hop_length, T)
        ref = fused.fbank_power_plain(wav, tabs, cfg.hop_length, T)
        t64 = {k: tabs[k].double() for k in ("window", "cos", "sin", "proj")}
        x = frames_plain(wav.double(), cfg.hop_length, cfg.win_length,
                         T) * t64["window"]
        exact = ((x @ t64["cos"]) ** 2 + (x @ t64["sin"]) ** 2) @ t64["proj"]
        diff = {name: (log(a) - log(b)).abs().max().item()
                for name, a, b in (("kernel-float64", got, exact),
                                   ("plain-float64", ref, exact),
                                   ("kernel-plain", got, ref))}
        print(f"precision {cfg.feature_type} B={nb}: largest log difference "
              + ", ".join(f"{k} {v:.3e}" for k, v in diff.items()),
              flush=True)


def time_root(root: Path) -> None:
    """One side of --parent: the package under root."""
    sys.path.insert(0, str(root))
    from tpuasr_torch import _build
    _build.lib()
    out = {"root": str(root)}
    time_shapes(out, plain=False)
    int8_arm(out)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}), flush=True)


def build(out: Path, clocks: bool, ptxas: bool) -> ctypes.CDLL:
    from tpuasr_torch import _build
    so = out / "fbank.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
           *(["-DTPUASR_FBANK_CLOCKS"] if clocks else []),
           *(["-Xptxas", "-v"] if ptxas else []), "-o", str(so),
           str(CSRC / "fbank.cu"), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{res.stderr}")
    if ptxas:
        for line in res.stderr.splitlines():
            if any(w in line for w in ("fbank", "registers", "spill",
                                       "wgmma", "arning")):
                print("  ptxas:", line.strip())
    lib = ctypes.CDLL(str(so))
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p
    return lib


def clock_split(lib) -> None:
    """Mean SM cycles a tile by phase, from the TPUASR_FBANK_CLOCKS build."""
    from tpuasr_torch import _build
    from tpuasr_torch.features import fused
    lib.tpuasr_fbank_clocks.argtypes = [ctypes.c_void_p]
    lib.tpuasr_fbank_clocks.restype = ctypes.c_int
    with mock.patch.object(_build, "_lib", lib):
        for tag, sr, nb in SHAPES:
            cfg, tabs, wav, T = inputs(sr, nb)
            plan = fused.fbank_plan(nb, T, cfg.hop_length, cfg.win_length,
                                    cfg.n_freqs, cfg.base_dim)
            buf = torch.zeros(plan.ctas, 8, dtype=torch.int64,
                              device="cuda")
            per_cta = plan.grid[0] * plan.grid[1] / plan.ctas
            _build.check(lib.tpuasr_fbank_clocks(buf.data_ptr()), "clocks")
            ms = cuda_ms(lambda: fused.fbank_power(wav, tabs, cfg.hop_length,
                                                   T), 5)
            mean = (buf.double().mean(0) / per_cta).tolist()
            parts = ", ".join(f"{name} {c:,.0f}"
                              for name, c in zip(PHASES, mean))
            print(f"{tag} (clock build {ms:.4f} ms, M={plan.M}, "
                  f"{plan.grid[0] * plan.grid[1]} tiles on {plan.ctas} "
                  f"CTAs): SM cycles a tile: {parts}; total {sum(mean):,.0f}",
                  flush=True)
            _build.check(lib.tpuasr_fbank_clocks(None), "clocks")

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--time-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.time_root:
        time_root(Path(args.time_root).resolve())
        return 0
    print(card(), flush=True)
    sys.path.insert(0, str(ROOT))
    from tpuasr_torch import _build
    _build.lib()
    out = {}
    time_shapes(out, plain=True)
    print(json.dumps({k: round(v, 4) for k, v in out.items()}), flush=True)
    if args.tiles:
        tile_heights()
    if args.precision:
        precision()
    if args.ptxas or args.clocks:
        with tempfile.TemporaryDirectory() as tmp:
            lib = build(Path(tmp), args.clocks, args.ptxas)
            if args.clocks:
                clock_split(lib)
    if args.parent:
        parent = Path(args.parent).resolve()
        for root in (parent, ROOT, ROOT, parent):
            res = subprocess.run([sys.executable, __file__, "--time-root",
                                  str(root)], capture_output=True, text=True)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return 1
            print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
