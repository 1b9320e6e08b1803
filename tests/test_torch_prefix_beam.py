"""tpuasr_torch's scan search (decode/prefix_beam.py) against the JAX
package's ``ctc_beam_search`` on identical log-probs (CPU): top-P pruning
alone, bigram and trigram LM fusion with and without the end-of-sentence
term, a decoding graph at P=2 and at full width, a run resumed from a
returned state, and the traced-weight overrides.

Tokens, token lengths, reached_final, graph states and the uint32 hashes
(as int32 bits) must be exactly equal; scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode import apply_score_bias as j_apply_score_bias
from tpuasr.decode import compile_graph_tables as j_compile_graph_tables
from tpuasr.decode import compose as j_compose
from tpuasr.decode import ctc_beam_search as j_ctc_beam_search
from tpuasr.decode import lexicon_to_fst as j_lexicon_to_fst
from tpuasr.decode import ngram_to_fst as j_ngram_to_fst
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr_torch.decode import (BeamSearchConfig, GraphTables,
                                 apply_score_bias, ctc_beam_search_xla)
from tpuasr_torch.decode.prefix_beam import topk_indices


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


B, T, C, K = 3, 10, 7, 4
SYMS = ["<blk>", "a", "b", "c", "d", "e", "f"]
SENTS = [["a", "b", "c"], ["c", "a"], ["b", "d", "e", "a"], ["e", "f", "b"],
         ["d", "a", "c", "b"], ["f", "f", "a"]] * 2


def _logp(seed, scale=1.5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * scale
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


def _graph():
    """A small LG: 8 words of 1-3 classes composed with a word bigram."""
    rng = np.random.default_rng(5)
    prons, seen = [], set()
    while len(prons) < 8:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(1, 4))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons)}", p))
    sents = [[f"w{int(v)}" for v in rng.integers(0, 8,
                                                 size=int(rng.integers(2, 5)))]
             for _ in range(30)]
    lg = j_compose(j_lexicon_to_fst(prons),
                   j_ngram_to_fst(j_train_ngram(sents, order=2),
                                  {w: i + 1 for i, (w, _) in
                                   enumerate(prons)}))
    return j_compile_graph_tables(lg, C, prune=10.0, quantum=0.1)


def _fusion(case):
    lm = j_train_ngram(SENTS, order=3 if "tri" in case else 2)
    if "tri" in case:
        tabs = dict(lm_trigram=lm.fusion_tensor3(SYMS),
                    lm_eos=lm.eos_matrix(SYMS))
    else:
        tabs = dict(lm_bigram=lm.fusion_matrix(SYMS),
                    lm_eos=lm.eos_vector(SYMS))
    if "eos" not in case:
        tabs.pop("lm_eos")
    if case == "eos":
        tabs.pop("lm_bigram")
    return tabs


def _check(a, b, state_keys=()):
    for key in ("tokens", "token_lens") + (("reached_final",)
                                           if "reached_final" in a else ()):
        np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]),
                                      err_msg=key)
    for key in ("scores", "am_scores", "lm_scores") + (
            ("graph_scores",) if "graph_scores" in a else ()):
        np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    for key in state_keys:
        want = np.asarray(a["state"][key])
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(b["state"][key].numpy(), want,
                                      err_msg=key)


CASES = {
    "no_lm": dict(),
    "bigram": dict(lm=True),
    "bigram_eos": dict(lm=True),
    "trigram": dict(lm=True),
    "trigram_eos": dict(lm=True),
    "eos": dict(lm=True),
    "graph_p2": dict(graph=True, P=2),
    "graph_full": dict(graph=True, P=C - 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_scan_search(case):
    spec = CASES[case]
    lp = _logp(sum(map(ord, case)))
    lens = np.array([T, 6, 1], np.int32)
    kw = dict(beam_width=K, class_topk=spec.get("P", 3), max_len=T,
              lm_weight=0.6 if spec.get("lm") else 0.0, graph_weight=0.8)
    tabs = _fusion(case) if spec.get("lm") else {}
    jg = tg = None
    if spec.get("graph"):
        jg = _graph()
        tg = GraphTables(jg.next_state, jg.cost, jg.final, start=jg.start)
    a = j_ctc_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                          JBeamSearchConfig(**kw), n_best=3, graph=jg,
                          return_state=True, **tabs)
    b = ctc_beam_search_xla(torch.tensor(lp), torch.tensor(lens),
                            BeamSearchConfig(**kw), n_best=3, graph=tg,
                            return_state=True, **tabs)
    keys = ("plen", "last", "last2", "h1", "h2", "prefixes") + (
        ("gs",) if jg is not None else ())
    _check(a, b, keys)
    if jg is not None:
        assert b["reached_final"].dtype == torch.bool
        assert int(b["token_lens"][0, 0]) > 0


@pytest.mark.parametrize("graph", [False, True])
def test_resumed_state_matches_jax(graph):
    """Two chunks of frames, the second resumed from the first's state, in
    both packages; the resumed run equals the JAX resumed run."""
    lp = _logp(41)
    lens = np.array([T, 8, 3], np.int32)
    kw = dict(beam_width=K, class_topk=3, max_len=T, lm_weight=0.5)
    tabs = _fusion("bigram_eos")
    jg = tg = None
    if graph:
        jg = _graph()
        tg = GraphTables(jg.next_state, jg.cost, jg.final, start=jg.start)
    cut = 4
    len1 = np.minimum(lens, cut)
    len2 = lens - len1
    a1 = j_ctc_beam_search(jnp.asarray(lp[:, :cut]), jnp.asarray(len1),
                           JBeamSearchConfig(**kw), graph=jg,
                           return_state=True, **tabs)
    a2 = j_ctc_beam_search(jnp.asarray(lp[:, cut:]), jnp.asarray(len2),
                           JBeamSearchConfig(**kw), n_best=2, graph=jg,
                           init_state=a1["state"], return_state=True, **tabs)
    b1 = ctc_beam_search_xla(torch.tensor(lp[:, :cut]), torch.tensor(len1),
                             BeamSearchConfig(**kw), graph=tg,
                             return_state=True, **tabs)
    b2 = ctc_beam_search_xla(torch.tensor(lp[:, cut:]), torch.tensor(len2),
                             BeamSearchConfig(**kw), n_best=2, graph=tg,
                             init_state=b1["state"], return_state=True,
                             **tabs)
    keys = ("plen", "last", "h1", "h2", "prefixes") + (("gs",) if graph
                                                       else ())
    _check(a2, b2, keys)
    # Resuming equals one run over all frames.
    whole = ctc_beam_search_xla(torch.tensor(lp), torch.tensor(lens),
                                BeamSearchConfig(**kw), n_best=2, graph=tg,
                                **tabs)
    assert torch.equal(whole["tokens"], b2["tokens"])


def test_weight_overrides_and_gather_names():
    """lm_weight / graph_weight as 0-d tensors override the config, and the
    two JAX names of the graph row fetch give the same result."""
    lp = torch.tensor(_logp(8))
    lens = torch.tensor([T, 9, 5])
    jg = _graph()
    tg = GraphTables(jg.next_state, jg.cost, jg.final, start=jg.start)
    tabs = _fusion("bigram")
    ref = ctc_beam_search_xla(lp, lens, BeamSearchConfig(
        beam_width=K, max_len=T, lm_weight=0.3, graph_weight=0.7), graph=tg,
        **tabs)
    cfg = BeamSearchConfig(beam_width=K, max_len=T)
    for impl in ("xla", "pallas"):
        got = ctc_beam_search_xla(lp, lens, cfg, graph=tg,
                                  lm_weight=torch.tensor(0.3),
                                  graph_weight=torch.tensor(0.7),
                                  graph_gather_impl=impl, **tabs)
        for key in ("tokens", "token_lens", "scores", "reached_final"):
            assert torch.equal(got[key], ref[key]), key
    with pytest.raises(ValueError, match="graph_gather_impl"):
        ctc_beam_search_xla(lp, lens, cfg, graph=tg, graph_gather_impl="dma")
    with pytest.raises(ValueError, match="not both"):
        ctc_beam_search_xla(lp, lens, cfg, lm_bigram=tabs["lm_bigram"],
                            lm_trigram=np.zeros((C + 1, C + 1, C)))


def test_score_bias_and_topk_ties():
    lp = _logp(3)
    cfg = BeamSearchConfig(token_insertion_bonus=0.25)
    bias = np.linspace(-1, 0, C).astype(np.float32)
    np.testing.assert_allclose(
        apply_score_bias(torch.tensor(lp), cfg, bias).numpy(),
        np.asarray(j_apply_score_bias(
            jnp.asarray(lp), JBeamSearchConfig(token_insertion_bonus=0.25),
            bias)), rtol=0, atol=1e-6)
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30]])
    assert topk_indices(x, 5).tolist() == [[1, 2, 4, 0, 3]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 5)[1]).tolist() \
        == [[1, 2, 4, 0, 3]]
