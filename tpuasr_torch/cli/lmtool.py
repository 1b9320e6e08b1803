"""``python -m tpuasr_torch.cli.lmtool {train,ppl,score}``: build and query
ARPA n-gram LMs with the port, the counterpart of ``tpuasr/cli/lmtool.py``
(``python lm.py``). The LM is Witten-Bell backoff (``tpuasr_torch/lm/
ngram.py``), stored in the ARPA text format that ``predict``/``test`` take
by ``--lm``; the same corpus gives the same file as the JAX command.

Training sources, token level:
  * --manifest x.jsonl --units units.txt  -> unit-symbol sentences from the
    manifest's token ids (the LM used for fusion/rescoring over AM outputs);
  * --manifest without --units            -> raw token-id strings;
  * --text corpus.txt                     -> whitespace words per line
    (a word-level LM, e.g. for lexicon-decoded output or a graph's G).
"""

from __future__ import annotations

import argparse

from tpuasr_torch.lm import NGramLM, train_ngram


def _sentences(args) -> list[list[str]]:
    if args.text:
        with open(args.text) as f:
            return [line.split() for line in f if line.strip()]
    if not args.manifest:
        raise SystemExit("pass --manifest or --text")
    from tpuasr_torch.data.manifest import read_manifest
    units = None
    if args.units:
        from tpuasr_torch.cli.common import load_units
        units = load_units(args.units)
    sents = []
    for u in read_manifest(args.manifest):
        if units:
            sents.append([units[t] for t in u.tokens])
        else:
            sents.append([str(t) for t in u.tokens])
    return sents


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpuasr_torch.cli.lmtool")
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="estimate an ARPA LM from transcripts")
    tr.add_argument("--manifest", help="JSONL manifest (token-level LM)")
    tr.add_argument("--units", help="unit symbol file (token id -> symbol)")
    tr.add_argument("--text", help="plain text, one sentence per line "
                                   "(word-level LM)")
    tr.add_argument("--order", type=int, default=3)
    tr.add_argument("--out", required=True, help="output ARPA path")

    pl = sub.add_parser("ppl", help="perplexity of a held-out set")
    pl.add_argument("--lm", required=True)
    pl.add_argument("--manifest")
    pl.add_argument("--units")
    pl.add_argument("--text")

    sc = sub.add_parser("score", help="ln P(sentence) for words on argv")
    sc.add_argument("--lm", required=True)
    sc.add_argument("words", nargs="+")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        sents = _sentences(args)
        lm = train_ngram(sents, order=args.order)
        lm.save_arpa(args.out)
        n = sum(len(s) for s in sents)
        print(f"trained order-{args.order} LM on {len(sents)} sentences "
              f"({n} tokens, vocab {len(lm.vocab)}); ppl(train) = "
              f"{lm.perplexity(sents):.2f} -> {args.out}")
    elif args.cmd == "ppl":
        lm = NGramLM.load_arpa(args.lm)
        sents = _sentences(args)
        print(f"perplexity: {lm.perplexity(sents):.3f} "
              f"({len(sents)} sentences)")
    elif args.cmd == "score":
        lm = NGramLM.load_arpa(args.lm)
        print(f"{lm.score(args.words):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
