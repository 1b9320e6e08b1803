"""``python -m tpuasr_torch.cli.predict <model> a.wav b.wav --weights w.npz``

Transcribe wav files with the port: one transcript per wav, as
``<path>\\t<text>`` (``[n] score`` before the text with ``--nbest``).
Counterpart of ``tpuasr/cli/predict.py`` for greedy decoding, the beam
search (``--beam``, with ``--beam-impl``), an ARPA LM (``--lm``: shallow
fusion in the search with ``--lm-fusion``, else n-best rescoring), WFST
n-best rescoring (``--fst`` with ``--beam``), word output through a lexicon
(``--lexicon``/``--words``), graph-constrained decoding
(``--graph-decode``, from ``--fst`` or built from the lexicon and a word
LM), and the host first pass over ``--fst`` (``--fst-decode``: words,
``--fst-nbest`` hypotheses and word confidences from the lattice,
``--write-lattice``, word times with ``--align``). With greedy or beam
decoding, ``--align`` prints each token's time span from the CTC forced
alignment of the best hypothesis and ``--confidence`` its confidences
(``decode/confidence.py``). ``--dump-loglikes PREFIX`` writes each wav's
log-probs to ``PREFIX.ark``/``.scp`` (Kaldi binary matrices, keys = the wav
basenames). ``--int8`` serves DeepSpeech's int8 GRU kernel; ``capsule1``
(CapsNet, routed by the K8 kernel) and ``resnet_ctc`` have no GRU and
refuse it. ``--feature-type`` picks fbank, MFCC or the spectrogram when
the weights' metadata carries no feature config. ``--weights`` (or
``--checkpoint``, ``--continue-from``) is a checkpoint that training
wrote, JAX's or the port's (``ckpt_*.msgpack``, or a checkpoint directory:
its newest), or a ``tpuasr_torch.convert.save_npz`` export; the metadata
beside it (model, num_classes, model_kwargs, feature config) wins over the
flags.

The log-probs stay on the card for the searches, the alignment and the
confidences; they are copied to the host once, for the first pass and the
dump only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tpuasr_torch.cli.common import (add_decode_flags, add_model_flags,
                                     build_decode_graph, check_first_pass,
                                     first_pass_kwargs, fusion_tables,
                                     lm_symbols, load_fst, load_lm,
                                     load_model, load_units, load_wav,
                                     make_word_decoder, out_frames,
                                     tokens_to_text, wav_keys)
from tpuasr_torch.decode import (BeamSearchConfig, align_confidence,
                                 beam_posterior, graph_tokens_to_words,
                                 rescore_nbest_fst, wfst_ctc_decode,
                                 wfst_ctc_decode_nbest, wfst_ctc_lattice,
                                 write_lattice_text)
from tpuasr_torch.losses import ctc_align
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.utils.device import resolve_device
from tpuasr_torch.utils.kaldi_io import write_ark_scp


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
    p.add_argument("--align", action="store_true",
                   help="also print each token's time span from the CTC "
                        "forced alignment of the best hypothesis (with "
                        "--fst-decode: each word's emission time)")
    p.add_argument("--confidence", action="store_true",
                   help="also print confidences: per utterance (the Viterbi "
                        "path's geometric-mean posterior; with --beam also "
                        "the hypothesis' posterior mass within the beam) "
                        "and per token (the mean class posterior over its "
                        "aligned span); with --fst-decode, word posteriors "
                        "from the lattice")
    p.add_argument("--dump-loglikes", metavar="PREFIX", default=None,
                   help="also write each wav's log-probs to PREFIX.ark/.scp "
                        "(Kaldi binary FM, keys = wav basenames)")
    add_decode_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    units = load_units(args.units)
    if args.graph_decode and (args.beam or args.fst_decode):
        raise SystemExit("--graph-decode replaces --beam/--fst-decode")
    lm = None if args.graph_decode else load_lm(args)
    check_first_pass(args, lm)
    if lm is not None and not args.beam:
        raise SystemExit("--lm requires --beam (the LM applies to beam "
                         "hypotheses)")
    if args.fst and not (args.beam or args.graph_decode or args.fst_decode):
        raise SystemExit("--fst requires --beam for rescoring, "
                         "--graph-decode or --fst-decode")
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
    beam_cfg, lm_tables, graph = None, {}, None
    syms = lm_symbols(units, num_classes)
    rescore = lm is not None and not args.lm_fusion
    fst, fst_osyms = load_fst(args) if args.beam else (None, None)
    search_n = n_best
    if args.graph_decode:
        graph, gfst, name_fn, offset = build_decode_graph(args, num_classes,
                                                          units)
        beam_cfg = BeamSearchConfig(beam_width=max(args.beam_width, n_best),
                                    class_topk=args.graph_topk,
                                    max_len=T_out,
                                    graph_weight=args.graph_weight)
    elif args.beam:
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
                     beam_impl=args.beam_impl, lm_tables=lm_tables,
                     graph=graph)
    out = rec(batch, lens)
    host_lp = None
    if args.dump_loglikes or args.fst_decode:
        host_lp = out["log_probs"].cpu().numpy()
    ol_np = out["out_lens"].cpu().numpy()
    if args.dump_loglikes:
        items = [(k, host_lp[i, :ol_np[i]])
                 for i, k in enumerate(wav_keys(args.wavs))]
        ark, scp = write_ark_scp(args.dump_loglikes, items)
        print(f"# wrote {len(items)} loglike matrices to {ark} ({scp})")
    if args.graph_decode:
        _print_graph_decode(args, out, gfst, name_fn, offset, n_best)
        return 0
    if args.fst_decode:
        _first_pass(args, out, host_lp, ol_np, feat_cfg)
        return 0

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
    beam_post = None
    if args.beam and args.confidence:
        # Posterior mass of each hypothesis within the searched set,
        # normalized over the whole beam before the n-best cut (float32,
        # as the JAX command computes it).
        beam_post = beam_posterior(torch.as_tensor(
            scores, dtype=torch.float32)).numpy()[:, :n_best]

    spans = conf_tok = conf_utt = None
    if args.align or args.confidence:
        spans, conf_tok, conf_utt = _align_best(args, out, toks, tok_lens)

    word_dec, words = make_word_decoder(args, units)
    fl_np = out["feat_lens"].cpu().numpy()
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
        syms_i = [units[t] if units and t < len(units) else str(t)
                  for t in toks[i, 0, :int(tok_lens[i, 0])].tolist()]
        if spans is not None:
            spf = _seconds_a_frame(fl_np[i], ol_np[i], feat_cfg)
            st, en = spans
            parts = [f"{sym}[{st[i, u] * spf:.2f}-{en[i, u] * spf:.2f}]"
                     for u, sym in enumerate(syms_i)]
            print(f"# align: {' '.join(parts)}")
        if conf_utt is not None:
            head = f"# conf: utt {conf_utt[i]:.3f}"
            if beam_post is not None:
                head += f" beam {beam_post[i, 0]:.3f}"
            parts = [f"{sym} {conf_tok[i, u]:.3f}"
                     for u, sym in enumerate(syms_i)]
            print(head + (" | " + " ".join(parts) if parts else ""))
    return 0


def _seconds_a_frame(feat_len, out_len, feat_cfg) -> float:
    """Seconds a model frame: the featurizer's hop times the model's time
    stride (feature frames over output frames)."""
    stride = max(1, round(float(feat_len) / max(int(out_len), 1)))
    return stride * feat_cfg.hop_length / feat_cfg.sample_rate


def _align_best(args, out, toks, tok_lens):
    """Force-align each wav's best hypothesis onto the log-probs, on their
    device: -> (spans (starts, ends) or None, token confidences, utterance
    confidences), as numpy; the confidences None without --confidence."""
    logp, ol = out["log_probs"], out["out_lens"]
    B = toks.shape[0]
    U = max(1, int(tok_lens[:, 0].max()))
    lab = np.zeros((B, U), np.int32)
    lab_lens = np.zeros((B,), np.int32)
    for i in range(B):
        n = int(tok_lens[i, 0])
        lab_lens[i] = n
        lab[i, :n] = toks[i, 0, :n]
    lab = torch.as_tensor(lab, device=logp.device)
    lab_lens = torch.as_tensor(lab_lens, device=logp.device)
    if args.confidence:
        cf = align_confidence(logp, lab, lab_lens, ol)
        spans = ((cf["token_starts"].cpu().numpy(),
                  cf["token_ends"].cpu().numpy()) if args.align else None)
        return (spans, cf["token_conf"].cpu().numpy(),
                cf["utt_conf"].cpu().numpy())
    al = ctc_align(logp, lab, ol, lab_lens)
    return ((al["token_starts"].cpu().numpy(),
             al["token_ends"].cpu().numpy()), None, None)


def _first_pass(args, out, lp_np, ol_np, feat_cfg) -> None:
    """``--fst-decode``: the host first pass over --fst on the copied
    log-probs, printed as the JAX command prints it. The lattice engine
    serves n-best, confidences and lattices; plain 1-best runs the lighter
    Viterbi pass."""
    fst, osyms = load_fst(args)
    want_lattice = (args.fst_nbest > 1 or args.confidence
                    or args.write_lattice)
    if want_lattice:
        res = wfst_ctc_decode_nbest(fst, lp_np, ol_np,
                                    nbest=max(args.fst_nbest, 1),
                                    **first_pass_kwargs(args, lattice=True))
    else:
        res = wfst_ctc_decode(fst, lp_np, ol_np, **first_pass_kwargs(args))
    if args.write_lattice:
        with open(args.write_lattice, "w") as fh:
            for i, path in enumerate(args.wavs):
                key = Path(path).stem
                lat = wfst_ctc_lattice(fst, lp_np[i, :int(ol_np[i])],
                                       **first_pass_kwargs(args,
                                                           lattice=True))
                write_lattice_text(fh, key, lat, words=osyms)
        print(f"# wrote {len(args.wavs)} lattices to {args.write_lattice}")

    def name(w):
        return osyms.sym(w) if osyms is not None else str(w)

    fl_np = out["feat_lens"].cpu().numpy()
    for i, path in enumerate(args.wavs):
        if want_lattice:
            for j in range(int(res["nhyp"][i])):
                n = int(res["word_lens"][i, j])
                text = " ".join(name(w) for w in res["words"][i, j, :n])
                if args.fst_nbest > 1:
                    print(f"{path}\t[{j}] {res['scores'][i, j]:.2f}\t{text}")
                else:
                    print(f"{path}\t{text}")
                if j == 0 and args.confidence and n:
                    parts = [f"{name(w)}:{c:.3f}" for w, c in
                             zip(res["words"][i, 0, :n],
                                 res["confidences"][i, :n])]
                    print(f"# conf: {' '.join(parts)}")
            n = int(res["word_lens"][i, 0])
            ws, fr = res["words"][i, 0, :n], res["frames"][i, 0, :n]
        else:
            n = int(res["word_lens"][i])
            ws, fr = res["words"][i, :n], res["frames"][i, :n]
            print(f"{path}\t{' '.join(name(w) for w in ws)}")
        if not bool(res["reached_final"][i]):
            print("# fst: no final state reached (partial hypothesis)")
        if args.align and n:
            spf = _seconds_a_frame(fl_np[i], ol_np[i], feat_cfg)
            parts = [f"{name(w)}[{max(f, 0) * spf:.2f}]"
                     for w, f in zip(ws, fr)]
            print(f"# align: {' '.join(parts)}")


def _print_graph_decode(args, out, gfst, name_fn, offset, n_best) -> None:
    """Graph-constrained decode's output: words by min-cost replay of each
    hypothesis through the original graph."""
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


if __name__ == "__main__":
    raise SystemExit(main())
