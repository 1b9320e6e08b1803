"""``python -m tpuasr_torch.cli.test <model> --manifest m.jsonl --checkpoint
weights.npz``

Score a labeled set with the port: the manifest's utterances go through
``AudioLoader`` (length buckets, shuffle off) and ``Recognizer`` on the
card. The command prints one ``<id>\\t<hypothesis>`` line per utterance,
which ``tpuasr/cli/test.py`` does not print, then the summary line that
``tpuasr/cli/test.py`` prints: the corpus token error rate (and the word
error rate with ``--lexicon``/``--words``) by ``utils.metrics.wer``, or
with ``--graph-decode`` the word error rate and the count of utterances
whose best path reached a final state. Decoding: greedy; the beam search
(``--beam``, ``--beam-impl``) with shallow LM fusion (``--lm-fusion``) or
n-best rescoring by an ARPA LM (``--lm``) or a WFST (``--fst``); or the
graph-constrained search (``--graph-decode``); or the host first pass over
``--fst`` (``--fst-decode``: word error rate and final states, as with a
graph). ``--checkpoint`` is a
checkpoint that training wrote, JAX's or the port's (``ckpt_*.msgpack``,
or a checkpoint directory: its newest), or the port's ``.npz`` export
(``tpuasr_torch.convert.save_npz``), as predict's ``--weights``.

Kaldi archives beside the score: ``--dump-loglikes PREFIX`` writes each
utterance's log-probs (binary FM), ``--align PREFIX`` the per-frame labels
of the reference transcript's CTC forced alignment (binary FV; blank 0,
-1 where infeasible), and ``--write-segments OUT.jsonl`` (with
``--align``) a copy of the manifest whose ``segments`` hold each token's
aligned sample span. The log-probs stay on the card for the search and the
alignment and are copied to the host for the first pass and the dump only.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from tpuasr_torch.cli.common import (add_decode_flags, add_model_flags,
                                     build_decode_graph, check_first_pass,
                                     first_pass_kwargs, fusion_tables,
                                     lm_symbols, load_fst, load_lm,
                                     load_model, load_units,
                                     make_word_decoder, out_frames,
                                     tokens_to_text)
from tpuasr_torch.data import AudioLoader, LoaderConfig, write_manifest
from tpuasr_torch.decode import BeamSearchConfig, wfst_ctc_decode
from tpuasr_torch.features import num_frames
from tpuasr_torch.losses import ctc_align
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.utils.device import resolve_device
from tpuasr_torch.utils.kaldi_io import write_ark_scp
from tpuasr_torch.utils.metrics import wer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.test")
    add_model_flags(p)
    p.add_argument("--manifest", required=True,
                   help="JSON-lines manifest with tokens (and text)")
    p.add_argument("--checkpoint", "--continue-from", dest="checkpoint",
                   required=True,
                   help="a checkpoint file or directory (JAX's msgpack "
                        "format) or an .npz from tpuasr_torch.convert")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-label-len", type=int, default=64)
    p.add_argument("--dump-loglikes", metavar="PREFIX", default=None,
                   help="also write each utterance's log-probs to "
                        "PREFIX.ark/.scp (Kaldi binary FM)")
    p.add_argument("--align", metavar="PREFIX", default=None,
                   help="force-align the reference transcripts and write "
                        "the per-frame label ids to PREFIX.ark/.scp (Kaldi "
                        "binary FV; blank 0, -1 where infeasible)")
    p.add_argument("--write-segments", metavar="OUT.jsonl", default=None,
                   help="with --align: write a copy of the manifest whose "
                        "`segments` hold each token's aligned sample span")
    add_decode_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    units = load_units(args.units)
    if args.graph_decode and (args.beam or args.fst_decode):
        raise SystemExit("--graph-decode replaces --beam/--fst-decode")
    if args.write_segments and not args.align:
        raise SystemExit("--write-segments requires --align")
    lm = None if args.graph_decode else load_lm(args)
    check_first_pass(args, lm)
    if lm is not None and not args.beam:
        raise SystemExit("--lm requires --beam (the LM applies to beam "
                         "hypotheses) or --graph-decode (composed into LG)")
    fst, fst_osyms = (None, None) if args.graph_decode else load_fst(args)
    if fst is not None and not (args.beam or args.fst_decode):
        raise SystemExit("--fst requires --beam for rescoring, "
                         "--graph-decode or --fst-decode")
    model, feat_cfg, num_classes = load_model(args.checkpoint, args, units)
    loader = AudioLoader(args.manifest,
                         LoaderConfig(batch_size=args.batch_size,
                                      max_label_len=args.max_label_len,
                                      shuffle=False))
    utt_text = {u.id: u.text for u in loader.utts}
    syms = lm_symbols(units, num_classes)
    rescore = lm is not None and not args.lm_fusion
    graph = None
    if args.graph_decode:
        from tpuasr_torch.decode import graph_tokens_to_words
        graph, gfst, gname_fn, goffset = build_decode_graph(args, num_classes,
                                                            units)
    lm_tables = (fusion_tables(lm, syms, args.lm_fusion_order)
                 if lm is not None and args.lm_fusion else {})
    word_dec, words = make_word_decoder(args, units)

    recs = {}          # one Recognizer a bucket: max_len is its T'

    def recognizer(S: int) -> Recognizer:
        if S not in recs:
            T_out = out_frames(feat_cfg, S, model)
            if graph is not None:
                cfg = BeamSearchConfig(beam_width=args.beam_width,
                                       class_topk=args.graph_topk,
                                       max_len=T_out,
                                       graph_weight=args.graph_weight)
                recs[S] = Recognizer(model, feat_cfg, cfg, device,
                                     graph=graph)
            elif args.beam:
                cfg = BeamSearchConfig(
                    beam_width=args.beam_width, class_topk=args.class_topk,
                    max_len=T_out,
                    lm_weight=args.lm_weight if args.lm_fusion else 0.0)
                n = cfg.beam_width if (rescore or fst is not None) else 1
                recs[S] = Recognizer(model, feat_cfg, cfg, device, n_best=n,
                                     beam_impl=args.beam_impl,
                                     lm_tables=lm_tables)
            else:
                recs[S] = Recognizer(model, feat_cfg, None, device)
        return recs[S]

    refs, hyps, wrefs, whyps = [], [], [], []
    n_final = 0
    loglikes = []     # (utt_id, (T', C) log-probs) with --dump-loglikes
    aligns = []       # (utt_id, (T',) frame labels) with --align
    segments = {}     # utt_id -> [[token, s0, s1], ...] with --write-segments
    for batch in loader:
        out = recognizer(batch["wav"].shape[1])(batch["wav"],
                                                batch["wav_lens"])
        toks_nb = out["tokens"].cpu().numpy()
        lens_nb = out["token_lens"].cpu().numpy()
        real = [j for j in range(len(batch["real"])) if batch["real"][j]]
        ol = out["out_lens"].cpu().numpy()
        if args.align:
            _align_refs(batch, out, real, feat_cfg, aligns,
                        segments if args.write_segments else None)
        host_lp = None
        if args.dump_loglikes or args.fst_decode:
            host_lp = out["log_probs"].cpu().numpy()
        if args.dump_loglikes:
            loglikes += [(batch["ids"][j], host_lp[j, :ol[j]]) for j in real]
        if args.fst_decode:
            # The first pass's words come straight off the graph's output
            # labels.
            fd = wfst_ctc_decode(fst, host_lp, ol, **first_pass_kwargs(args))
            for j in real:
                n = int(fd["word_lens"][j])
                n_final += int(bool(fd["reached_final"][j]))
                hyp = [fst_osyms.sym(w) if fst_osyms is not None else str(w)
                       for w in fd["words"][j, :n]]
                wrefs.append(utt_text.get(batch["ids"][j], "").split())
                whyps.append(hyp)
                print(f"{batch['ids'][j]}\t{' '.join(hyp)}")
            continue
        if graph is not None:
            reached = out["reached_final"].cpu().numpy()[:, 0]
            wordseqs = graph_tokens_to_words(gfst, toks_nb[:, 0],
                                             lens_nb[:, 0], offset=goffset)
            for j in real:
                n_final += int(bool(reached[j]))
                hyp = [gname_fn(w) for w in wordseqs[j]]
                wrefs.append(utt_text.get(batch["ids"][j], "").split())
                whyps.append(hyp)
                print(f"{batch['ids'][j]}\t{' '.join(hyp)}")
            continue
        if rescore or fst is not None:
            sc = out["scores"].cpu().numpy().astype(np.float64)
            if rescore:
                from tpuasr_torch.lm import rescore_nbest
                sc = rescore_nbest(lm, toks_nb, lens_nb, sc, syms,
                                   lm_weight=args.lm_weight)
            if fst is not None:
                from tpuasr_torch.decode import rescore_nbest_fst
                sc, _ = rescore_nbest_fst(fst, toks_nb, lens_nb, sc,
                                          fst_weight=args.fst_weight)
            best = np.argmax(sc, axis=1)
            rows = np.arange(len(best))
            toks, tok_lens = toks_nb[rows, best], lens_nb[rows, best]
        else:
            toks, tok_lens = toks_nb[:, 0], lens_nb[:, 0]
        for j in real:
            refs.append(batch["tokens"][j][:batch["token_lens"][j]].tolist())
            hyp = toks[j][:tok_lens[j]].tolist()
            hyps.append(hyp)
            text = tokens_to_text(hyp, units)
            if word_dec is not None:
                wrefs.append(utt_text.get(batch["ids"][j], "").split())
                whyps.append([words.sym(w) for w in word_dec.decode(hyp)])
                text = " ".join(whyps[-1])
            print(f"{batch['ids'][j]}\t{text}")
    if args.dump_loglikes:
        ark, scp = write_ark_scp(args.dump_loglikes, loglikes)
        print(f"# wrote {len(loglikes)} loglike matrices to {ark} ({scp})")
    if args.align:
        ark, scp = write_ark_scp(args.align, aligns)
        print(f"# wrote {len(aligns)} alignments to {ark} ({scp})")
    if args.write_segments:
        write_manifest(args.write_segments, [
            dataclasses.replace(u, segments=segments.get(u.id, u.segments))
            for u in loader.utts])
        print(f"# wrote manifest with {len(segments)} aligned segment "
              f"lists to {args.write_segments}")
    if graph is not None or args.fst_decode:
        # A graph emits words, not unit tokens: word-level WER only.
        print(f"utterances: {len(wrefs)}  "
              f"word-error-rate: {wer(wrefs, whyps):.4f}  "
              f"final-reached: {n_final}/{len(wrefs)}")
        return 0
    line = (f"utterances: {len(refs)}  "
            f"token-error-rate: {wer(refs, hyps):.4f}")
    if word_dec is not None:
        line += f"  word-error-rate: {wer(wrefs, whyps):.4f}"
    print(line)
    return 0


def _align_refs(batch, out, real, feat_cfg, aligns, segments) -> None:
    """Force-align the batch's reference tokens onto its log-probs (on
    their device): each real utterance's frame labels go to ``aligns``
    and, given ``segments``, each token's sample span [s0, s1) to it."""
    logp, ol_d = out["log_probs"], out["out_lens"]
    al = ctc_align(logp, torch.as_tensor(batch["tokens"], device=logp.device),
                   ol_d, torch.as_tensor(batch["token_lens"],
                                         device=logp.device))
    fl = al["frame_labels"].cpu().numpy().astype(np.float32)
    ol = ol_d.cpu().numpy()
    for j in real:
        aligns.append((batch["ids"][j], fl[j, :ol[j]]))
    if segments is None:
        return
    st = al["token_starts"].cpu().numpy()
    en = al["token_ends"].cpu().numpy()
    feasible = al["feasible"].cpu().numpy()
    hop = feat_cfg.hop_length
    for j in real:
        if not feasible[j]:
            continue
        # Output frames stride the utterance's own feature frames (not the
        # padded batch's) by feat_len / out_len; feature frames stride the
        # samples by hop_length.
        T_feat = num_frames(feat_cfg, int(batch["wav_lens"][j]))
        stride = max(1, round(T_feat / max(int(ol[j]), 1)))
        segments[batch["ids"][j]] = [
            [int(batch["tokens"][j][u]), int(st[j, u]) * stride * hop,
             int(en[j, u]) * stride * hop + feat_cfg.win_length]
            for u in range(int(batch["token_lens"][j]))]


if __name__ == "__main__":
    raise SystemExit(main())
