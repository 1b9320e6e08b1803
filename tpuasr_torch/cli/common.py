"""Shared CLI plumbing: units and wav loading, LM and WFST loading, fusion
tables, the beam-search dispatch with its loud fallback, and the decoding
graph for ``--graph-decode``.

Counterpart of the decode half of ``tpuasr/cli/common.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


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


def lm_symbols(units: list[str], num_classes: int) -> list[str]:
    return units if units else [str(i) for i in range(num_classes)]


def load_lm(args):
    """NGramLM from --lm, or None."""
    if not getattr(args, "lm", None):
        return None
    from tpuasr_torch.lm import NGramLM
    return NGramLM.load_arpa(args.lm)


def fusion_tables(lm, syms: list[str], order: int) -> dict:
    """Beam-search kwargs for shallow fusion at `order` (2 or 3)."""
    if order == 3:
        return dict(lm_trigram=lm.fusion_tensor3(syms),
                    lm_eos=lm.eos_matrix(syms))
    return dict(lm_bigram=lm.fusion_matrix(syms), lm_eos=lm.eos_vector(syms))


def run_beam_search(impl: str, logp, lens, cfg, n_best: int, **kwargs):
    """Beam search at the requested impl. Every fusion order runs in every
    impl; the only fallback is the kernel search's trigram size gate, and
    it is loud (a line on stderr)."""
    from tpuasr_torch.decode import get_beam_search
    try:
        return get_beam_search(impl)(logp, lens, cfg, n_best=n_best, **kwargs)
    except ValueError as e:
        if "XLA ctc_beam_search" not in str(e):
            raise
        print(f"# beam kernel rejected the problem ({e}); falling back to "
              "the scan search (xla)", file=sys.stderr)
        return get_beam_search("xla")(logp, lens, cfg, n_best=n_best,
                                      **kwargs)


def load_fst(args):
    """(WFST, output SymbolTable | None) from --fst flags, or (None, None)."""
    if not getattr(args, "fst", None):
        return None, None
    from tpuasr_torch.decode import WFST, SymbolTable
    isyms = SymbolTable.load(args.fst_isyms) if args.fst_isyms else None
    osyms = SymbolTable.load(args.fst_osyms) if args.fst_osyms else None
    fst = WFST.load(args.fst, isyms=isyms, osyms=osyms)
    return fst, osyms if osyms is not None else fst.osyms


def make_word_decoder(args, units: list[str]):
    """(LexiconDecoder, words SymbolTable) from --lexicon/--words, or
    (None, None) when word output is not asked for."""
    if not args.lexicon or not args.words:
        return None, None
    if not units:
        raise SystemExit("--lexicon requires --units (unit symbol table)")
    from tpuasr_torch.decode import Lexicon, LexiconDecoder, SymbolTable
    words = SymbolTable.load(args.words)
    lex = Lexicon.load(args.lexicon, words, SymbolTable.from_list(units))
    return LexiconDecoder(lex, word_score=1.0), words


def build_decode_graph(args, num_classes: int, units: list[str]):
    """The --graph-decode tables: (GraphTables, original WFST for word
    replay, word-name fn, olabel -> word-id offset).

    Two sources: ``--fst``, a prebuilt graph over unit ilabels (word names
    through --fst-osyms); or L from --lexicon/--words/--units (olabels =
    words.txt id + 1), composed with a WORD-level ARPA --lm into LG when
    one is given.
    """
    from tpuasr_torch.decode import (Lexicon, SymbolTable,
                                     compile_graph_tables, compose,
                                     lexicon_to_fst, ngram_to_fst)
    if getattr(args, "fst", None):
        fst, osyms = load_fst(args)
        name_fn = osyms.sym if osyms is not None else str
        offset = 0
    else:
        if not (args.lexicon and args.words and units):
            raise SystemExit(
                "--graph-decode needs a graph: pass --fst, or build one "
                "with --lexicon + --words + --units (+ a word-level --lm "
                "for a grammar-bearing LG)")
        words = SymbolTable.load(args.words)
        lex = Lexicon.load(args.lexicon, words, SymbolTable.from_list(units))
        # olabels = word id + 1: stable across multiple prons of a word and
        # aligned with ngram_to_fst's sym2label space.
        fst = lexicon_to_fst([(wid, pron) for wid, pron in lex.prons],
                             olabels=[wid + 1 for wid, _ in lex.prons])
        lm = load_lm(args)
        if lm is not None:
            fst = compose(fst, ngram_to_fst(
                lm, {words.sym(wid): wid + 1 for wid, _ in lex.prons}))
        name_fn = words.sym
        offset = -1
    prune = args.graph_prune if args.graph_prune > 0 else None
    try:
        tabs = compile_graph_tables(fst, num_classes,
                                    max_states=args.graph_max_states,
                                    prune=prune, quantum=args.graph_quantum)
    except ValueError as e:
        raise SystemExit(
            f"graph compilation failed: {e}\n"
            "Weighted determinization can blow up on non-twin graphs "
            "(L*G with homophones). Try --graph-prune 10 (on by default), "
            "a coarser --graph-quantum or a larger --graph-max-states."
        ) from e
    return tabs, fst, name_fn, offset
