"""``python -m tpuasr_torch.cli.predict <model> a.wav b.wav --weights w.npz``

Transcribe wav files with the port: one transcript per wav, as
``<path>\\t<text>``. Counterpart of ``tpuasr/cli/predict.py`` for greedy and
beam decoding (``--beam``); ``--int8`` serves the int8 GRU kernel with the
recurrence in the stream type, as the JAX ``--int8`` does. Weights come
from ``tpuasr_torch.convert.save_npz`` output; its metadata (num_classes,
model_kwargs, feature config) is used when present.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tpuasr_torch.convert import from_jax_variables, load_npz
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import MODEL_REGISTRY, create_model
from tpuasr_torch.serve.offline import Recognizer, resolve_device


def load_units(path: str | None) -> list[str]:
    return Path(path).read_text().splitlines() if path else []


def tokens_to_text(tokens, units: list[str]) -> str:
    if not units:
        return " ".join(str(int(t)) for t in tokens)
    return " ".join(units[int(t)] if 0 <= int(t) < len(units) else "<unk>"
                    for t in tokens)


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """wav file -> (float32 samples in [-1, 1], sample rate), mono."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.predict")
    p.add_argument("model", choices=sorted(MODEL_REGISTRY))
    p.add_argument("wavs", nargs="+", help="wav files to transcribe")
    p.add_argument("--weights", required=True,
                   help=".npz written by tpuasr_torch.convert.save_npz")
    p.add_argument("--units", default=None,
                   help="units file, one token per line (line 0 = <blank>)")
    p.add_argument("--beam", action="store_true",
                   help="CTC prefix beam search instead of greedy")
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--int8", action="store_true",
                   help="int8 input projections in the GRU kernel")
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--no-cmvn", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; an error without a CUDA device) "
                        "or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    units = load_units(args.units)
    tree = load_npz(args.weights)
    meta = tree.get("meta", {})
    num_classes = meta.get("num_classes") or len(units)
    if not num_classes:
        raise SystemExit("weights carry no num_classes; pass --units")
    if meta.get("feature"):
        feat_cfg = FeatureConfig(**meta["feature"])
    else:
        feat_cfg = FeatureConfig(sample_rate=args.sample_rate,
                                 n_mels=args.n_mels, cmn=not args.no_cmvn,
                                 cvn=not args.no_cmvn)
    model_kwargs = dict(meta.get("model_kwargs", {}))
    if args.int8:
        model_kwargs.update(pallas_gru=True, fused_proj=True, int8_proj=True)
    model = create_model(meta.get("model", args.model),
                         num_classes=num_classes,
                         in_features=feat_cfg.base_dim, **model_kwargs)
    model.load_state_dict(from_jax_variables(tree))

    wavs = []
    for path in args.wavs:
        data, sr = load_wav(path)
        if sr != feat_cfg.sample_rate:
            raise SystemExit(f"{path}: sample rate {sr} != "
                             f"{feat_cfg.sample_rate}")
        wavs.append(data)
    lens = np.array([len(w) for w in wavs], np.int32)
    batch = np.zeros((len(wavs), int(lens.max())), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w

    n_best = max(1, args.nbest) if args.beam else 1
    beam_cfg = None
    if args.beam:
        T_out = -(-(1 + (batch.shape[1] - feat_cfg.win_length)
                    // feat_cfg.hop_length) // 2)
        beam_cfg = BeamSearchConfig(beam_width=max(args.beam_width, n_best),
                                    max_len=max(1, T_out))
    rec = Recognizer(model, feat_cfg, beam_cfg, device, n_best=n_best)
    out = rec(batch, lens)
    toks = out["tokens"].cpu().numpy()
    tok_lens = out["token_lens"].cpu().numpy()
    scores = out["scores"].cpu().numpy() if out["scores"] is not None else None
    for i, path in enumerate(args.wavs):
        for n in range(n_best):
            text = tokens_to_text(toks[i, n, :tok_lens[i, n]], units)
            if n_best > 1:
                print(f"{path}\t[{n}] {scores[i, n]:.2f}\t{text}")
            else:
                print(f"{path}\t{text}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
