"""The port's n-gram LM (tpuasr_torch/lm/ngram.py) against the JAX
package's (CPU, no device): a seeded ``train_ngram`` gives byte-equal
fusion tables, eos vector and eos matrix; an ARPA file written by either
package loads in the other to the same model; scores and n-best rescoring
agree exactly.
"""

import numpy as np
import pytest

from tpuasr.lm import NGramLM as JNGramLM
from tpuasr.lm import rescore_nbest as j_rescore_nbest
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr_torch.lm import (BOS, EOS, UNK, NGramLM, rescore_nbest,
                             train_ngram)

SYMS = ["<blk>"] + [f"p{i}" for i in range(1, 12)]


def _sentences(seed, n=60):
    rng = np.random.default_rng(seed)
    return [[SYMS[int(v)] for v in rng.integers(1, len(SYMS) - 1,
                                                size=int(rng.integers(2, 9)))]
            for _ in range(n)]


@pytest.mark.parametrize("order", [1, 2, 3])
def test_fusion_tables_byte_equal(order):
    sents = _sentences(order)
    a, b = j_train_ngram(sents, order=order), train_ngram(sents, order=order)
    assert a.ngrams == b.ngrams and a.vocab == b.vocab
    for name in ("fusion_matrix", "fusion_tensor3", "eos_vector",
                 "eos_matrix"):
        want = getattr(a, name)(SYMS)
        got = getattr(b, name)(SYMS)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            name


def test_arpa_round_trip_across_packages(tmp_path):
    sents = _sentences(7)
    a, b = j_train_ngram(sents, order=3), train_ngram(sents, order=3)
    a.save_arpa(tmp_path / "jax.arpa")
    b.save_arpa(tmp_path / "torch.arpa")
    assert (tmp_path / "jax.arpa").read_bytes() == \
        (tmp_path / "torch.arpa").read_bytes()
    from_jax = NGramLM.load_arpa(tmp_path / "jax.arpa")
    from_torch = JNGramLM.load_arpa(tmp_path / "torch.arpa")
    assert from_jax.order == from_torch.order == 3
    assert from_jax.ngrams == from_torch.ngrams
    test = _sentences(8, n=10) + [["p1", "zzz", "p2"]]
    for s in test:
        assert from_jax.score(s) == from_torch.score(s)
        assert b.score(s) == a.score(s)
    assert from_jax.perplexity(test) == from_torch.perplexity(test)
    assert (BOS, EOS, UNK) == ("<s>", "</s>", "<unk>")


def test_rescore_nbest_matches():
    sents = _sentences(9)
    a, b = j_train_ngram(sents, order=2), train_ngram(sents, order=2)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, len(SYMS), size=(2, 3, 6)).astype(np.int32)
    lens = np.array([[6, 2, 0], [4, 5, 1]], np.int32)
    am = rng.uniform(-30, -5, size=(2, 3)).astype(np.float32)
    am[1, 2] = -1e30                                 # a dead hypothesis
    want = j_rescore_nbest(a, toks, lens, am, SYMS, lm_weight=0.8,
                           length_bonus=0.5)
    got = rescore_nbest(b, toks, lens, am, SYMS, lm_weight=0.8,
                        length_bonus=0.5)
    np.testing.assert_array_equal(got, want)
    assert got[1, 2] == -np.inf
