"""tpuasr_torch beam search (plain version of the beam kernel) against the
JAX Pallas beam kernel with ``interpret=True`` (selected by the JAX package
off a TPU; see test_torch_gru.py), on identical log-probs (CPU), without
and with bigram or trigram LM fusion.

Tokens and token lengths must be exactly equal, scores equal to rtol 1e-5
(1e-4 absolute with LM fusion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode.pallas_beam import ctc_beam_search_pallas
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr_torch.decode import (BeamSearchConfig, beam_scan,
                                 ctc_beam_search, ctc_beam_search_xla,
                                 get_beam_search)
from tpuasr_torch.decode.beam import _wrap32, backtrack, logaddexp


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Drop the executables that earlier test files in this process traced.
    A file that ran the JAX package's Pallas kernels under
    ``pltpu.force_tpu_interpret_mode()`` leaves executables whose host
    callbacks dispatch JAX ops; reused here, they can deadlock."""
    jax.clear_caches()


def _logp(seed, B, T, C, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * scale
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


def _compare(lp, lens, K, max_len, n_best=1):
    a = ctc_beam_search_pallas(jnp.asarray(lp), jnp.asarray(lens),
                               JBeamSearchConfig(beam_width=K,
                                                 max_len=max_len),
                               n_best=n_best)
    b = ctc_beam_search(torch.tensor(lp), torch.tensor(lens),
                        BeamSearchConfig(beam_width=K, max_len=max_len),
                        n_best=n_best)
    np.testing.assert_array_equal(b["token_lens"].numpy(),
                                  np.asarray(a["token_lens"]))
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(a["tokens"]))
    np.testing.assert_allclose(b["scores"].numpy(), np.asarray(a["scores"]),
                               rtol=1e-5)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_pallas_ragged(seed):
    """K=8 over 16 classes; rows of full length, short, length 1 and 0."""
    B, T, C = 4, 14, 16
    lp = _logp(seed, B, T, C)
    lens = np.array([T, 6, 1, 0], np.int32)
    out = _compare(lp, lens, K=8, max_len=T)
    assert int(out["token_lens"][3, 0]) == 0      # an empty row decodes empty
    assert float(out["scores"][3, 0]) == 0.0


def test_dead_lanes_c5_k8():
    """C=5 < K=8: fewer live candidates than lanes in the first frames, so
    dead selections need fresh hashes or extend mass is absorbed twice."""
    B, T, C = 2, 18, 5
    lp = _logp(10, B, T, C, scale=1.0)
    _compare(lp, np.array([T, 11], np.int32), K=8, max_len=T)


def test_max_len_cap():
    """max_len < T: the cap inside the kernel stops extending at 4 tokens."""
    B, T, C = 2, 16, 8
    lp = _logp(20, B, T, C, scale=3.0)
    out = _compare(lp, np.array([T, 12], np.int32), K=8, max_len=4)
    assert int(out["token_lens"].max()) <= 4


def test_hash_wrap_matches_int32():
    rng = np.random.default_rng(0)
    a = rng.integers(-2 ** 31, 2 ** 31, size=1000, dtype=np.int64)
    m = np.int32(np.uint32(2654435761).astype(np.int64) - (1 << 32))
    with np.errstate(over="ignore"):
        want = (a.astype(np.int32) * m + np.int32(7)).astype(np.int64)
    got = _wrap32(_wrap32(torch.tensor(a) * int(m)) + 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_backtrack_packed_pointers():
    # Two frames, K=2: beam 0 extends beam 1 by char 3 at t=1, beam 1 at
    # t=0 extended the root (beam 0) by char 2.
    bp = torch.tensor([[[0 * 65536 + 0, 0 * 65536 + 3]],
                       [[1 * 65536 + 4, 1 * 65536 + 0]]], dtype=torch.int32)
    toks, lens = backtrack(bp, torch.tensor([[0]]), max_len=3)
    assert toks.tolist() == [[[2, 3, -1]]] and lens.tolist() == [[2]]


def test_plain_scan_invariants():
    lp = torch.tensor(_logp(5, 3, 9, 6))
    lens = torch.tensor([9, 4, 0], dtype=torch.int32)
    bp, pb, pnb, lm, last, last2 = beam_scan(lp, lens, 4, 0, 9)
    assert bp.shape == (9, 3, 4) and bp.dtype == torch.int32
    # Frozen rows point each lane at itself with no character.
    assert torch.equal(bp[4:, 1], (torch.arange(4) * 65536).int()
                       .expand(5, 4))
    assert torch.equal(bp[:, 2], (torch.arange(4) * 65536).int()
                       .expand(9, 4))
    am = logaddexp(pb, pnb)
    assert float(am[2, 0]) == 0.0 and bool((am[:, 0] > -1e29).all())
    # Without LM the score stays 0 and last2 is not tracked.
    assert not lm.any() and bool((last2 == -1).all())
    assert int(last[2, 0]) == -1 and bool((last[0] >= -1).all())


SYMS = ["<blk>", "a", "b", "c", "d", "e"]
SENTS = [["a", "b", "c"], ["c", "a"], ["b", "d", "e", "a"], ["e", "e", "b"],
         ["d", "a", "c", "b"]] * 2


def _fusion(order):
    lm = j_train_ngram(SENTS, order=order)
    if order == 3:
        return dict(lm_trigram=lm.fusion_tensor3(SYMS),
                    lm_eos=lm.eos_matrix(SYMS))
    return dict(lm_bigram=lm.fusion_matrix(SYMS), lm_eos=lm.eos_vector(SYMS))


@pytest.mark.parametrize("order,seed,eos", [(2, 0, True), (2, 1, False),
                                            (3, 0, True), (3, 2, False)])
def test_lm_fusion_matches_pallas(order, seed, eos):
    """Bigram / trigram fusion in the plain version of the kernel against
    the Pallas kernel's LM branch, B=2, T=12, C=6, K=4, n_best=2."""
    B, T, C, K = 2, 12, len(SYMS), 4
    lp = _logp(30 + seed, B, T, C, scale=1.5)
    lens = np.array([T, 7], np.int32)
    tabs = _fusion(order)
    if not eos:
        del tabs["lm_eos"]
    kw = dict(beam_width=K, max_len=T, lm_weight=0.7)
    a = ctc_beam_search_pallas(jnp.asarray(lp), jnp.asarray(lens),
                               JBeamSearchConfig(**kw), n_best=2, **tabs)
    b = ctc_beam_search(torch.tensor(lp), torch.tensor(lens),
                        BeamSearchConfig(**kw), n_best=2, **tabs)
    np.testing.assert_array_equal(b["token_lens"].numpy(),
                                  np.asarray(a["token_lens"]))
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(a["tokens"]))
    for key in ("scores", "am_scores", "lm_scores"):
        np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]),
                                   rtol=0, atol=1e-4)
    assert bool((b["lm_scores"] < 0).all())


def test_lm_table_validation():
    """The kernel search's checks, with the Pallas wrapper's messages: both
    tables at once, a trigram of the wrong shape, and the trigram size gate
    that sends the CLI to the scan search (C=192: (C+1)^2 rows)."""
    lp = torch.tensor(_logp(0, 1, 4, 5))
    cfg = BeamSearchConfig(beam_width=4)
    big = np.zeros((6, 5), np.float32)
    with pytest.raises(ValueError, match="not both"):
        ctc_beam_search(lp, torch.tensor([4]), cfg, lm_bigram=big,
                        lm_trigram=np.zeros((6, 6, 5), np.float32))
    with pytest.raises(ValueError, match="lm_trigram shape"):
        ctc_beam_search(lp, torch.tensor([4]), cfg,
                        lm_trigram=np.zeros((6, 5, 5), np.float32))
    with pytest.raises(ValueError, match="lm_bigram shape"):
        ctc_beam_search(lp, torch.tensor([4]), cfg,
                        lm_bigram=np.zeros((5, 5), np.float32))
    C = 192
    lp = torch.full((1, 2, C), -5.0)
    with pytest.raises(ValueError, match="XLA ctc_beam_search"):
        ctc_beam_search(lp, torch.tensor([2]), cfg,
                        lm_trigram=np.zeros((C + 1, C + 1, C), np.float32))


def test_get_beam_search():
    assert get_beam_search("auto") is ctc_beam_search
    assert get_beam_search("pallas") is ctc_beam_search
    assert get_beam_search("xla") is ctc_beam_search_xla
    with pytest.raises(ValueError):
        get_beam_search("cuda")
