"""``python -m tpuasr_torch.cli.stream <wav> --checkpoint ...``: online
streaming recognition simulated over a wav file (fed in chunks; tokens are
printed as they are emitted).

Counterpart of ``tpuasr/cli/stream.py``, with its flags and output lines:
greedy (each chunk's new tokens), ``--beam`` (the running best hypothesis
of the resumable beam search), the LM flags (shallow fusion in the beam),
``--graph-decode`` (the graph constrains the beam; words by replay through
the graph) and ``--timestamps`` (greedy: each token's emission time; beam:
the final hypothesis CTC-forced-aligned, ``tpuasr_torch.losses.ctc_align``).
The checkpoint, JAX's or the port's (``ckpt_*.msgpack`` or its directory),
must be the streaming model: DeepSpeech with ``bidirectional=False,
explicit_pad=True`` in its ``model_kwargs``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from tpuasr_torch.cli.common import (add_lm_flags, build_decode_graph,
                                     lm_symbols, load_lm, load_units,
                                     load_wav, tokens_to_text)
from tpuasr_torch.convert import from_jax_variables
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model
from tpuasr_torch.serve.streaming import StreamingRecognizer
from tpuasr_torch.train.checkpoints import load_for_inference
from tpuasr_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.stream")
    p.add_argument("wav")
    p.add_argument("--continue-from", "--checkpoint", dest="checkpoint",
                   required=True)
    p.add_argument("--units", default=None)
    p.add_argument("--words", default=None,
                   help="words.txt symbol table (for --graph-decode word "
                        "output)")
    p.add_argument("--lexicon", default=None,
                   help="lexicon 'WORD unit unit ...': with --words and "
                        "--graph-decode, the decoding graph is built here")
    p.add_argument("--chunk-ms", type=float, default=200.0)
    p.add_argument("--beam", action="store_true",
                   help="resumable prefix beam search across chunks (prints "
                        "the running best hypothesis per chunk; earlier "
                        "output may be revised)")
    p.add_argument("--beam-width", type=int, default=8)
    p.add_argument("--timestamps", action="store_true",
                   help="per-token times: greedy tags each token with its "
                        "emission time as it streams; beam forced-aligns "
                        "the final hypothesis and prints spans")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; an error without a CUDA device) "
                        "or cpu")
    add_lm_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    try:
        variables, meta = load_for_inference(args.checkpoint)
    except FileNotFoundError as e:
        raise SystemExit(f"checkpoint not found: {e}") from e
    model_kwargs = dict(meta.get("model_kwargs", {}))
    if model_kwargs.get("bidirectional", True):
        raise SystemExit(
            "streaming needs a unidirectional checkpoint: train with "
            "--model-kwargs bidirectional=False explicit_pad=True "
            "(TrainConfig.model_kwargs)")
    if not model_kwargs.get("explicit_pad", False):
        raise SystemExit(
            "streaming needs a checkpoint with explicit padding: train with "
            "--model-kwargs bidirectional=False explicit_pad=True "
            "(TrainConfig.model_kwargs)")
    feat_cfg = FeatureConfig(**meta["feature"])
    if feat_cfg.cmn or feat_cfg.cvn:
        feat_cfg = dataclasses.replace(feat_cfg, cmn=False, cvn=False)
        print("# note: disabling CMVN for streaming (anti-causal)")
    units = load_units(args.units)
    num_classes = meta.get("num_classes") or len(units)
    model = create_model(meta.get("model", "deepspeech_ctc"),
                         num_classes=num_classes,
                         in_features=feat_cfg.feat_dim, **model_kwargs)
    model.load_state_dict(from_jax_variables(variables))

    wav, sr = load_wav(args.wav)
    if sr != feat_cfg.sample_rate:
        raise SystemExit(f"sample rate {sr} != {feat_cfg.sample_rate}")
    chunk = max(1, int(sr * args.chunk_ms / 1000.0))

    gfst = gname_fn = None
    beam_mode = True
    if args.graph_decode:
        # The graph rides the resumable beam search, its per-beam state
        # part of the chunk-to-chunk carry.
        tabs, gfst, gname_fn, goffset = build_decode_graph(
            args, num_classes, units)
        cfg = BeamSearchConfig(beam_width=args.beam_width,
                               class_topk=args.graph_topk,
                               graph_weight=args.graph_weight)
        rec = StreamingRecognizer(model, feat_cfg, decode="beam",
                                  beam_cfg=cfg, graph=tabs,
                                  keep_logp=args.timestamps, device=device)
    else:
        lm = load_lm(args)
        if args.beam or lm is not None:
            cfg = BeamSearchConfig(beam_width=args.beam_width,
                                   lm_weight=args.lm_weight if lm else 0.0)
            kw = {}
            if lm is not None:
                syms = lm_symbols(units, num_classes)
                kw = dict(lm_bigram=lm.fusion_matrix(syms),
                          lm_eos=lm.eos_vector(syms))
            rec = StreamingRecognizer(model, feat_cfg, decode="beam",
                                      beam_cfg=cfg,
                                      keep_logp=args.timestamps,
                                      device=device, **kw)
        else:
            rec = StreamingRecognizer(model, feat_cfg, device=device)
            beam_mode = False

    def fmt(toks, frames):
        if not args.timestamps or beam_mode:
            return tokens_to_text(toks, units)
        spf = rec.frame_seconds
        return " ".join(f"{tokens_to_text([t], units)}@{f * spf:.2f}"
                        for t, f in zip(toks, frames))

    t_ms = 0.0
    n_emitted = 0
    for s in range(0, len(wav), chunk):
        toks = rec.feed(wav[s:s + chunk])
        t_ms += args.chunk_ms
        if toks:
            tag = "hyp" if beam_mode else "new"
            frames = rec.token_frames[n_emitted:]
            n_emitted = len(rec.token_frames)
            print(f"[{t_ms / 1000.0:7.2f}s {tag}] "
                  f"{fmt(toks, frames)}", flush=True)
    toks = rec.flush()
    if toks:
        frames = rec.token_frames[n_emitted:]
        print(f"[  final] {fmt(toks, frames)}")
    print(f"# transcript: {tokens_to_text(rec.tokens, units)}")
    if gfst is not None:
        # Words by min-cost replay of the final hypothesis through the
        # original graph.
        cost, ols = gfst.score([int(t) for t in rec.tokens])
        if math.isinf(cost):
            print("# words: (hypothesis has no complete parse in the "
                  "graph)")
        else:
            print("# words: "
                  + " ".join(gname_fn(int(o) + goffset) for o in ols))
    if args.timestamps and beam_mode and rec.tokens:
        # Forced-align the final hypothesis over the whole AM output.
        from tpuasr_torch.losses import ctc_align
        logp = torch.as_tensor(np.concatenate(rec.logp_history, axis=0),
                               device=device)
        lab = torch.as_tensor(rec.tokens, dtype=torch.int32, device=device)
        al = ctc_align(logp[None], lab[None], [logp.shape[0]], [len(lab)])
        st = al["token_starts"][0].tolist()
        en = al["token_ends"][0].tolist()
        spf = rec.frame_seconds
        parts = [f"{tokens_to_text([t], units)}"
                 f"[{st[u] * spf:.2f}-{en[u] * spf:.2f}]"
                 for u, t in enumerate(rec.tokens)]
        print(f"# align: {' '.join(parts)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
