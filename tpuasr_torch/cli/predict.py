"""``python -m tpuasr_torch.cli.predict <model> a.wav b.wav --weights w.npz``

Transcribe wav files with the port: one transcript per wav, as
``<path>\\t<text>`` (``[n] score`` before the text with ``--nbest``).
Counterpart of ``tpuasr/cli/predict.py`` for greedy decoding, the beam
search (``--beam``, with ``--beam-impl``), an ARPA LM (``--lm``: shallow
fusion in the search with ``--lm-fusion``, else n-best rescoring), WFST
n-best rescoring (``--fst`` with ``--beam``), word output through a lexicon
(``--lexicon``/``--words``), and graph-constrained decoding
(``--graph-decode``, from ``--fst`` or built from the lexicon and a word
LM). ``--int8`` serves DeepSpeech's int8 GRU kernel; ``capsule1`` (CapsNet,
routed by the K8 kernel) and ``resnet_ctc`` have no GRU and refuse it.
``--feature-type`` picks fbank, MFCC or the spectrogram when the weights'
metadata carries no feature config. ``--weights`` (or ``--checkpoint``,
``--continue-from``) is a checkpoint that training wrote, JAX's or the
port's (``ckpt_*.msgpack``, or a checkpoint directory: its newest), or a
``tpuasr_torch.convert.save_npz`` export; the metadata beside it
(model, num_classes, model_kwargs, feature config) wins over the flags.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpuasr_torch.cli.common import (add_decode_flags, add_model_flags,
                                     build_decode_graph, fusion_tables,
                                     lm_symbols, load_fst, load_lm,
                                     load_model, load_units, load_wav,
                                     make_word_decoder, out_frames,
                                     tokens_to_text)
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.predict")
    add_model_flags(p)
    p.add_argument("wavs", nargs="+", help="wav files to transcribe")
    p.add_argument("--weights", "--checkpoint", "--continue-from",
                   dest="weights", required=True,
                   help="a checkpoint file or directory (JAX's msgpack "
                        "format, written by either package's training) or an "
                        ".npz written by tpuasr_torch.convert.save_npz")
    p.add_argument("--nbest", type=int, default=1)
    add_decode_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    units = load_units(args.units)
    if args.graph_decode and args.beam:
        raise SystemExit("--graph-decode replaces --beam")
    lm = None if args.graph_decode else load_lm(args)
    if lm is not None and not args.beam:
        raise SystemExit("--lm requires --beam (the LM applies to beam "
                         "hypotheses)")
    if args.fst and not (args.beam or args.graph_decode):
        raise SystemExit("--fst requires --beam for rescoring or "
                         "--graph-decode")
    model, feat_cfg, num_classes = load_model(args.weights, args, units)

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
    T_out = out_frames(feat_cfg, batch.shape[1], model)

    n_best = max(1, args.nbest) if (args.beam or args.graph_decode) else 1
    if args.graph_decode:
        return _graph_decode(args, model, feat_cfg, device, num_classes,
                             units, batch, lens, n_best, T_out)

    beam_cfg, lm_tables = None, {}
    syms = lm_symbols(units, num_classes)
    rescore = lm is not None and not args.lm_fusion
    fst, fst_osyms = load_fst(args) if args.beam else (None, None)
    search_n = n_best
    if args.beam:
        beam_cfg = BeamSearchConfig(
            beam_width=max(args.beam_width, n_best),
            class_topk=args.class_topk, max_len=T_out,
            lm_weight=args.lm_weight if args.lm_fusion else 0.0)
        if lm is not None and args.lm_fusion:
            lm_tables = fusion_tables(lm, syms, args.lm_fusion_order)
        # Rescoring re-ranks the WHOLE beam, then keeps the top n_best.
        if rescore or fst is not None:
            search_n = beam_cfg.beam_width
    rec = Recognizer(model, feat_cfg, beam_cfg, device, n_best=search_n,
                     beam_impl=args.beam_impl, lm_tables=lm_tables)
    out = rec(batch, lens)
    toks = out["tokens"].cpu().numpy()
    tok_lens = out["token_lens"].cpu().numpy()
    scores = (out["scores"].cpu().numpy().astype(np.float64)
              if out["scores"] is not None else None)
    fst_outs = None
    if rescore:
        from tpuasr_torch.lm import rescore_nbest
        scores = rescore_nbest(lm, toks, tok_lens, scores, syms,
                               lm_weight=args.lm_weight)
    if fst is not None:
        from tpuasr_torch.decode import rescore_nbest_fst
        scores, fst_outs = rescore_nbest_fst(fst, toks, tok_lens, scores,
                                             fst_weight=args.fst_weight)
    if rescore or fst is not None:
        order = np.argsort(-scores, axis=1, kind="stable")
        toks = np.take_along_axis(toks, order[:, :, None], axis=1)
        tok_lens = np.take_along_axis(tok_lens, order, axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
        if fst_outs is not None:
            fst_outs = [[fst_outs[b][j] for j in order[b]]
                        for b in range(len(fst_outs))]

    word_dec, words = make_word_decoder(args, units)
    for i, path in enumerate(args.wavs):
        for n in range(n_best):
            seq = toks[i, n, :tok_lens[i, n]].tolist()
            if fst_outs is not None and fst_outs[i][n]:
                text = " ".join(fst_osyms.sym(w) if fst_osyms is not None
                                else str(w) for w in fst_outs[i][n])
            elif word_dec is not None:
                text = " ".join(words.sym(w) for w in word_dec.decode(seq))
            else:
                text = tokens_to_text(seq, units)
            if n_best > 1:
                print(f"{path}\t[{n}] {scores[i, n]:.2f}\t{text}")
            else:
                print(f"{path}\t{text}")
    return 0


def _graph_decode(args, model, feat_cfg, device, num_classes, units, batch,
                  lens, n_best, T_out) -> int:
    """Graph-constrained decode: the compiled graph rides the beam search
    on the device; words by min-cost replay through the original graph."""
    from tpuasr_torch.decode import graph_tokens_to_words
    tabs, gfst, name_fn, offset = build_decode_graph(args, num_classes, units)
    cfg = BeamSearchConfig(beam_width=max(args.beam_width, n_best),
                           class_topk=args.graph_topk, max_len=T_out,
                           graph_weight=args.graph_weight)
    rec = Recognizer(model, feat_cfg, cfg, device, n_best=n_best, graph=tabs)
    out = rec(batch, lens)
    toks = out["tokens"].cpu().numpy()
    tok_lens = out["token_lens"].cpu().numpy()
    scores = out["scores"].cpu().numpy()
    reached = out["reached_final"].cpu().numpy()
    wordseqs = graph_tokens_to_words(gfst, toks, tok_lens, offset=offset)
    for i, path in enumerate(args.wavs):
        for n in range(n_best):
            text = " ".join(name_fn(w) for w in wordseqs[i * n_best + n])
            if n_best > 1:
                print(f"{path}\t[{n}] {scores[i, n]:.2f}\t{text}")
            else:
                print(f"{path}\t{text}")
        if not bool(reached[i, 0]):
            print("# graph: no final state reached (partial hypothesis)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
