"""Confidence scores in the port (``tpuasr_torch.decode.confidence``)
against the JAX package's (``tpuasr.decode.confidence``) on the CPU: the
beam posterior, and the forced-alignment confidences on peaked and flat
posteriors, ragged batches, padding, an infeasible alignment and an empty
hypothesis. Spans and feasibility are exact; confidences agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.decode import align_confidence as j_align_confidence
from tpuasr.decode import beam_posterior as j_beam_posterior
from tpuasr_torch.decode import align_confidence, beam_posterior

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


def _peaked_logp(T, C, labels, peak=12.0, blank=0):
    """Log-softmax frames tracing blank, l1, blank, l2, ... then blanks."""
    seq = []
    for lab in labels:
        seq += [blank, int(lab)]
    seq += [blank]
    frame_classes = (seq + [blank] * T)[:T]
    logits = np.zeros((T, C), np.float32)
    logits[np.arange(T), frame_classes] = peak
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _both(lp, tokens, token_lens, in_lens):
    """The port's result (numpy) after holding it against JAX's."""
    got = align_confidence(torch.tensor(lp), torch.as_tensor(tokens),
                           torch.as_tensor(token_lens),
                           torch.as_tensor(in_lens))
    ref = jax.jit(j_align_confidence)(jnp.asarray(lp), jnp.asarray(tokens),
                                      jnp.asarray(token_lens),
                                      jnp.asarray(in_lens))
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("token_starts", "token_ends", "feasible"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for k in ("token_conf", "utt_conf"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    return got


@pytest.mark.parametrize("scores", [[[-1.0, -2.0, -5.0], [-0.1, -9.0, -9.0]],
                                    [[-3.0, -4.0, -4.5]],
                                    [[-1e30, -2.0, -1e30, -2.5]]])
def test_beam_posterior_matches_jax(scores):
    s = np.asarray(scores, np.float32)
    p = beam_posterior(torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(p, np.asarray(j_beam_posterior(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(beam_posterior(torch.as_tensor(s + 7.25)), p,
                               rtol=1e-6)


def test_peaked_and_flat_posteriors():
    T, C, labels = 24, 6, [2, 3, 1]
    args = (np.asarray([labels], np.int32), np.asarray([3], np.int32),
            np.asarray([T], np.int32))
    hi = _both(_peaked_logp(T, C, labels, peak=12.0)[None], *args)
    lo = _both(_peaked_logp(T, C, labels, peak=1.0)[None], *args)
    assert hi["feasible"][0] and (hi["token_conf"][0] > 0.95).all()
    assert hi["utt_conf"][0] > 0.95
    assert lo["utt_conf"][0] < hi["utt_conf"][0]
    assert (lo["token_conf"][0] < hi["token_conf"][0]).all()


def test_ragged_batch_and_padding_match_singletons():
    T, C = 20, 5
    rng = np.random.default_rng(0)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((2, T, C)).astype(np.float32)), axis=-1))
    labels = np.zeros((2, 3), np.int32)
    labels[0, :2] = [1, 2]
    labels[1, :3] = [3, 1, 4]
    lab_lens = np.asarray([2, 3], np.int32)
    in_lens = np.asarray([12, 20], np.int32)
    batched = _both(lp, labels, lab_lens, in_lens)
    for b in range(2):
        solo = _both(lp[b:b + 1], labels[b:b + 1], lab_lens[b:b + 1],
                     in_lens[b:b + 1])
        np.testing.assert_allclose(batched["utt_conf"][b],
                                   solo["utt_conf"][0], rtol=1e-5)
        np.testing.assert_allclose(batched["token_conf"][b],
                                   solo["token_conf"][0], rtol=1e-5)
    assert batched["token_conf"][0, 2] == 0.0


def test_infeasible_reports_zero():
    lp = np.asarray(jax.nn.log_softmax(jnp.zeros((1, 2, 5)), axis=-1))
    out = _both(lp, np.asarray([[1, 2, 3]], np.int32),
                np.asarray([3], np.int32), np.asarray([2], np.int32))
    assert not out["feasible"][0]
    assert out["utt_conf"][0] == 0.0 and (out["token_conf"] == 0.0).all()


def test_empty_hypothesis_takes_the_blank_path():
    T, C = 10, 4
    logits = np.zeros((T, C), np.float32)
    logits[:, 0] = 10.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))[None]
    out = _both(lp, np.zeros((1, 1), np.int32), np.asarray([0], np.int32),
                np.asarray([T], np.int32))
    assert out["feasible"][0] and out["utt_conf"][0] > 0.95
    assert (out["token_conf"] == 0.0).all()


def test_random_batch_with_repeats_and_ragged_lengths():
    """Seeded log-probs at the CLI's shapes: hypotheses with repeated
    tokens (they need a blank between them), ragged frame and token counts
    and a zero-frame utterance."""
    rng = np.random.default_rng(3)
    B, T, C, U = 5, 30, 7, 6
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        (rng.standard_normal((B, T, C)) * 3).astype(np.float32)), axis=-1))
    tokens = rng.integers(1, C, size=(B, U)).astype(np.int32)
    tokens[0, 1] = tokens[0, 0]
    token_lens = np.asarray([6, 3, 0, 6, 2], np.int32)
    in_lens = np.asarray([30, 11, 30, 0, 5], np.int32)
    out = _both(lp, tokens, token_lens, in_lens)
    assert out["feasible"].tolist() == [True, True, True, False, True]
