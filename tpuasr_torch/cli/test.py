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
graph-constrained search (``--graph-decode``). ``--checkpoint`` is a
checkpoint that training wrote, JAX's or the port's (``ckpt_*.msgpack``,
or a checkpoint directory: its newest), or the port's ``.npz`` export
(``tpuasr_torch.convert.save_npz``), as predict's ``--weights``.

The JAX command's host-only outputs are not ported and exit with a
message: ``--dump-loglikes`` (Kaldi archives, ROADMAP Queue 1 item 8),
``--align`` and ``--write-segments`` (forced alignment, item 8) and
``--fst-decode`` (the host first pass, item 9).
"""

from __future__ import annotations

import argparse

import numpy as np

from tpuasr_torch.cli.common import (add_decode_flags, add_model_flags,
                                     build_decode_graph, fusion_tables,
                                     lm_symbols, load_fst, load_lm,
                                     load_model, load_units,
                                     make_word_decoder, out_frames,
                                     tokens_to_text)
from tpuasr_torch.data import AudioLoader, LoaderConfig
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.utils.device import resolve_device
from tpuasr_torch.utils.metrics import wer

# Flags of the JAX command whose modules the port does not have yet.
UNPORTED = {"dump_loglikes": "--dump-loglikes (Kaldi ark/scp output, "
                             "ROADMAP Queue 1 item 8)",
            "align": "--align (CTC forced alignment, ROADMAP Queue 1 item 8)",
            "write_segments": "--write-segments (forced alignment, ROADMAP "
                              "Queue 1 item 8)",
            "fst_decode": "--fst-decode (the host first pass, ROADMAP Queue 1 "
                          "item 9)"}


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
    add_decode_flags(p)
    g = p.add_argument_group("not ported (exit with a message)")
    g.add_argument("--dump-loglikes", metavar="PREFIX", default=None)
    g.add_argument("--align", metavar="PREFIX", default=None)
    g.add_argument("--write-segments", metavar="OUT.jsonl", default=None)
    g.add_argument("--fst-decode", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for name, what in UNPORTED.items():
        if getattr(args, name):
            raise SystemExit(f"{what} is not ported to tpuasr_torch")
    device = resolve_device(args.device)
    units = load_units(args.units)
    if args.graph_decode and args.beam:
        raise SystemExit("--graph-decode replaces --beam")
    lm = None if args.graph_decode else load_lm(args)
    if lm is not None and not args.beam:
        raise SystemExit("--lm requires --beam (the LM applies to beam "
                         "hypotheses) or --graph-decode (composed into LG)")
    fst, _ = (None, None) if args.graph_decode else load_fst(args)
    if fst is not None and not args.beam:
        raise SystemExit("--fst requires --beam for rescoring or "
                         "--graph-decode")
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
    for batch in loader:
        out = recognizer(batch["wav"].shape[1])(batch["wav"],
                                                batch["wav_lens"])
        toks_nb = out["tokens"].cpu().numpy()
        lens_nb = out["token_lens"].cpu().numpy()
        real = [j for j in range(len(batch["real"])) if batch["real"][j]]
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
    if graph is not None:
        # Graph decoding emits words, not unit tokens: word-level WER only.
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


if __name__ == "__main__":
    raise SystemExit(main())
