"""The port's host graph builders (tpuasr_torch/decode/{lexicon,fst,
graph}.py) against the JAX package's (CPU, no device): for a 30-word LG
(lexicon composed with a word bigram), ``compile_graph_tables`` gives the
same next_state, cost, final and start, and ``graph_tokens_to_words`` the
same words; WFST files written by either package load in the other;
lexicon segmentation and WFST n-best rescoring agree.
"""

import numpy as np
import pytest

from tpuasr.decode import WFST as JWFST
from tpuasr.decode import compile_graph_tables as j_compile_graph_tables
from tpuasr.decode import compose as j_compose
from tpuasr.decode import graph_tokens_to_words as j_graph_tokens_to_words
from tpuasr.decode import lexicon_to_fst as j_lexicon_to_fst
from tpuasr.decode import ngram_to_fst as j_ngram_to_fst
from tpuasr.decode import rescore_nbest_fst as j_rescore_nbest_fst
from tpuasr.decode.lexicon import Lexicon as JLexicon
from tpuasr.decode.lexicon import LexiconDecoder as JLexiconDecoder
from tpuasr.decode.lexicon import SymbolTable as JSymbolTable
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr_torch.decode import (WFST, Lexicon, LexiconDecoder, SymbolTable,
                                 compile_graph_tables, compose,
                                 graph_tokens_to_words, lexicon_to_fst,
                                 ngram_to_fst, rescore_nbest_fst)
from tpuasr_torch.lm import train_ngram

C = 16
N_WORDS = 30


def _recipe(seed=7):
    """The bench.py LG recipe at 30 words: prons of 2-4 classes (some
    homophone-free), 80 sentences of 3-8 words."""
    rng = np.random.default_rng(seed)
    prons, seen = [], set()
    while len(prons) < N_WORDS:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(2, 5))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons):03d}", p))
    sents = [[f"w{int(v):03d}" for v in
              rng.integers(0, N_WORDS, size=int(rng.integers(3, 9)))]
             for _ in range(80)]
    return prons, sents


def _lg(jax_side: bool):
    prons, sents = _recipe()
    sym2label = {w: i + 1 for i, (w, _) in enumerate(prons)}
    if jax_side:
        return prons, sents, j_compose(
            j_lexicon_to_fst(prons),
            j_ngram_to_fst(j_train_ngram(sents, order=2), sym2label))
    return prons, sents, compose(
        lexicon_to_fst(prons),
        ngram_to_fst(train_ngram(sents, order=2), sym2label))


@pytest.fixture(scope="module")
def graphs():
    _, _, jlg = _lg(True)
    prons, sents, tlg = _lg(False)
    kw = dict(max_states=400_000, prune=10.0, quantum=0.1)
    return (prons, sents, jlg, tlg, j_compile_graph_tables(jlg, C, **kw),
            compile_graph_tables(tlg, C, **kw))


def test_graph_tables_equal(graphs):
    _, _, jlg, tlg, jt, tt = graphs
    assert tlg.num_states == jlg.num_states
    assert tt.start == jt.start and tt.num_states == jt.num_states > 100
    for name in ("next_state", "cost", "final"):
        want, got = getattr(jt, name), getattr(tt, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_graph_tokens_to_words_equal(graphs):
    prons, sents, jlg, tlg, _, _ = graphs
    pron = dict(prons)
    rows = [[p for w in s for p in pron[w]] for s in sents[:12]]
    rows.append([1, 1, 1, 1])                        # likely rejected
    rows.append([])
    L = max(len(r) for r in rows)
    toks = np.full((len(rows), L), -1, np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    lens = np.array([len(r) for r in rows], np.int32)
    want = j_graph_tokens_to_words(jlg, toks, lens, offset=-1)
    got = graph_tokens_to_words(tlg, toks, lens, offset=-1)
    assert got == want
    names = [w for w, _ in prons]
    assert [names[i] for i in got[0]] == sents[0]


def test_wfst_files_across_packages(tmp_path, graphs):
    _, _, jlg, tlg, _, _ = graphs
    isyms = SymbolTable.from_list(["<eps>"] + [f"u{i}" for i in range(1, C)])
    jlg.save_binary(tmp_path / "jax.fst")
    tlg.save_binary(tmp_path / "torch.fst", isyms=isyms)
    back = WFST.load(tmp_path / "jax.fst")
    jback = JWFST.load(tmp_path / "torch.fst")
    assert jback.isyms.sym2id == isyms.sym2id
    for fst in (back, jback):          # the binary format stores float32
        assert fst.start == tlg.start
        assert fst.finals == {s: np.float32(w).item()
                              for s, w in tlg.finals.items()}
        assert {s: [(a.ilabel, a.olabel, a.weight, a.dst) for a in arcs]
                for s, arcs in fst.arcs.items()} == \
            {s: [(a.ilabel, a.olabel, np.float32(a.weight).item(), a.dst)
                 for a in arcs] for s, arcs in tlg.arcs.items()}
    tlg.save_text(tmp_path / "torch.txt")
    jlg.save_text(tmp_path / "jax.txt")
    assert (tmp_path / "torch.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    assert WFST.load(tmp_path / "jax.txt").score([1, 2]) == \
        JWFST.load(tmp_path / "torch.txt").score([1, 2])


def test_lexicon_and_fst_rescoring(tmp_path, graphs):
    prons, _, jlg, tlg, _, _ = graphs
    (tmp_path / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, (w, _) in enumerate(prons)))
    (tmp_path / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(f'u{p}' for p in pr)}\n" for w, pr in prons))
    units = ["<blank>"] + [f"u{i}" for i in range(1, C)]
    jw = JSymbolTable.load(tmp_path / "words.txt")
    tw = SymbolTable.load(tmp_path / "words.txt")
    jlex = JLexicon.load(tmp_path / "lexicon.txt", jw,
                         JSymbolTable.from_list(units))
    tlex = Lexicon.load(tmp_path / "lexicon.txt", tw,
                        SymbolTable.from_list(units))
    assert tlex.prons == jlex.prons
    seq = [p for _, pr in prons[:5] for p in pr] + [3, 3]
    assert LexiconDecoder(tlex, word_score=1.0).decode(seq) == \
        JLexiconDecoder(jlex, word_score=1.0).decode(seq)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, C, size=(2, 3, 5)).astype(np.int32)
    toks[0, 0, :3] = prons[0][1][:3] if len(prons[0][1]) >= 3 else 1
    lens = np.array([[3, 5, 2], [4, 1, 0]], np.int32)
    am = rng.uniform(-20, -1, size=(2, 3)).astype(np.float32)
    want = j_rescore_nbest_fst(jlg, toks, lens, am, fst_weight=0.5)
    got = rescore_nbest_fst(tlg, toks, lens, am, fst_weight=0.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
