"""The host first pass over a WFST in the port (``tpuasr_torch.decode.
fst_decode``) against the JAX package's (``tpuasr.decode.fst_decode``), on
the CPU.

The cases of ``tests/test_fst_decode.py`` and ``tests/test_fst_lattice.py``
run through the port, on graphs built in both packages from the same arcs
and on the same seeded log-probs. Every call runs four ways: the port's
native library (``native/*.cc`` built by ``tpuasr_torch/native/build.py``)
and its ``impl="py"``, and the JAX package's native library (built by
``make`` in ``native/``) and its ``impl="py"``. Words, frames, lengths,
``nhyp`` and ``reached_final`` are exact in every pairing; scores and
confidences are bit for bit the JAX package's, native against native (the
same sources; both builds contract no a*b+c into an FMA under ISO C++17,
so ``-march=native`` in JAX's Makefile changes no result) and Python
against Python (the same code), and within JAX's own bounds between the
native and Python versions. Then each case's own property is checked on
the port's results.
"""

import io
import itertools

import numpy as np
import pytest

from tpuasr.decode import fst_decode as jfd
from tpuasr.decode.fst import WFST as JWFST
from tpuasr.decode.fst import lexicon_to_fst as j_lexicon_to_fst
from tpuasr_torch.decode import fst_decode as pfd
from tpuasr_torch.decode.fst import WFST, lexicon_to_fst
from tpuasr_torch.native import build as native_build

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]

IMPLS = ["native", "py"]
INTS = ("words", "frames", "word_lens", "nhyp", "reached_final")


def _rand_logp(rng, T, C, peak=None, scale=1.0):
    """Random normalized log-probs; optionally peaked on a class track."""
    logits = rng.standard_normal((T, C)).astype(np.float32) * scale
    if peak is not None:
        logits[np.arange(T), peak] += 8.0
    x = logits - logits.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _graphs(arcs, finals, start=0):
    """The same graph in both packages: arcs (src, dst, ilabel, olabel,
    weight), finals {state: weight}."""
    out = []
    for cls in (WFST, JWFST):
        fst = cls(start=start)
        for a in arcs:
            fst.add_arc(*a)
        for s, w in finals.items():
            fst.set_final(s, w)
        out.append(fst)
    return tuple(out)


def _lexicon(prons):
    return lexicon_to_fst(prons), j_lexicon_to_fst(prons)


def _same(a, b, where):
    """Every field of two results equal, bit for bit."""
    assert set(a) == set(b), where
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{where} {k}")


def run4(name, graphs, *args, **kw):
    """``name`` of both packages in both impls on the same inputs -> the
    port's results by impl, after holding the four against each other."""
    pf, jf = graphs
    got = {}
    for impl in IMPLS:
        got[impl] = getattr(pfd, name)(pf, *args, impl=impl, **kw)
        ref = getattr(jfd, name)(jf, *args, impl=impl, **kw)
        _same(got[impl], ref, f"{name} {impl} vs JAX")
    a, b = got["native"], got["py"]
    if name == "wfst_ctc_lattice":
        # Node ids differ between the two builders (JAX compares these).
        assert len(a["src"]) == len(b["src"])
        np.testing.assert_allclose(np.sort(a["post"]), np.sort(b["post"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(a["best_cost"], b["best_cost"], rtol=1e-6)
        assert a["reached_final"] == b["reached_final"]
    else:
        for k in a:
            if k in INTS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-4)
        if "confidences" in a:
            np.testing.assert_allclose(a["confidences"], b["confidences"],
                                       rtol=1e-4, atol=1e-6)
    return got


def _exhaustive_best(fst, lp):
    """Min over ALL frame label paths of acoustic cost + WFST.score of the
    collapsed sequence (incl. finals)."""
    T, C = lp.shape
    best, words = np.inf, []
    for path in itertools.product(range(C), repeat=T):
        ac = -sum(float(lp[t, path[t]]) for t in range(T))
        collapsed, last = [], 0
        for y in path:
            if y != 0 and y != last:
                collapsed.append(y)
            last = y
        g, outs = fst.score(collapsed)
        if ac + g < best:
            best, words = ac + g, outs
    return best, words


def _all_parses(fst, seq):
    """Every accepting path of a phone sequence: [(graph_cost, words)]."""
    out = []

    def walk(state, pos, cost, words, depth):
        if depth > 50:
            return
        if pos == len(seq):
            fw = fst.finals.get(state)
            if fw is not None and np.isfinite(fw):
                out.append((cost + fw, list(words)))
        for a in fst.arcs.get(state, ()):
            w2 = words + [a.olabel] if a.olabel else words
            if a.ilabel == 0:
                walk(a.dst, pos, cost + a.weight, w2, depth + 1)
            elif pos < len(seq) and a.ilabel == seq[pos]:
                walk(a.dst, pos + 1, cost + a.weight, w2, 0)

    walk(fst.start, 0, 0.0, [], 0)
    return out


def _exhaustive_groups(fst, lp):
    """{words: (min_cost, total_log_mass)} over every (frame path x graph
    parse)."""
    T, C = lp.shape
    groups: dict = {}
    for path in itertools.product(range(C), repeat=T):
        ac = -sum(float(lp[t, path[t]]) for t in range(T))
        collapsed, last = [], 0
        for y in path:
            if y != 0 and y != last:
                collapsed.append(y)
            last = y
        for g, outs in _all_parses(fst, collapsed):
            cost = ac + g
            key = tuple(outs)
            best, mass = groups.get(key, (np.inf, -np.inf))
            groups[key] = (min(best, cost), np.logaddexp(mass, -cost))
    return groups


# (src, dst, ilabel, olabel, weight): words 1 "ab", 2 "ba", 3 "a" at
# distinct costs, so every parse has a unique total.
LOOP = ([(0, 1, 1, 0, 0.0), (1, 0, 2, 1, 0.11), (0, 2, 2, 0, 0.0),
         (2, 0, 1, 2, 0.23), (0, 0, 1, 3, 0.37)], {0: 0.0})
TWO_WORDS = ([(0, 1, 1, 10, 0.5), (0, 2, 2, 20, 0.7)], {1: 0.0, 2: 0.0})


def _random_graph(rng, n_states=8, n_arcs=30, C=6, n_words=5, eps_frac=0.2):
    arcs = []
    for _ in range(n_arcs):
        src, dst = int(rng.integers(n_states)), int(rng.integers(n_states))
        eps = rng.random() < eps_frac
        il = 0 if eps else int(rng.integers(1, C))
        ol = int(rng.integers(0, n_words + 1))
        w = float(rng.random() * 2.0) if not eps else float(rng.random())
        arcs.append((src, dst, il, ol, w))
    finals = {int(s): float(rng.random())
              for s in rng.choice(n_states, size=3, replace=False)}
    return _graphs(arcs, finals)


# ---- the 1-best first pass (tests/test_fst_decode.py) ----------------------


def test_decode_matches_exhaustive():
    g = _graphs(*LOOP)
    for seed in range(4):
        lp = _rand_logp(np.random.default_rng(seed), T=5, C=3, scale=2.0)
        gold_cost, gold_words = _exhaustive_best(g[0], lp)
        got = run4("wfst_ctc_decode", g, lp[None], np.asarray([5]),
                   beam=1e9, max_active=0)
        for out in got.values():
            assert bool(out["reached_final"][0])
            np.testing.assert_allclose(-out["scores"][0], gold_cost,
                                       rtol=1e-5)
            n = int(out["word_lens"][0])
            assert out["words"][0, :n].tolist() == gold_words


def test_decode_graph_weights_break_ties():
    g = _graphs([(0, 0, 1, 1, 3.0), (0, 0, 1, 2, 0.5)], {0: 0.0})
    lp = _rand_logp(np.random.default_rng(1), T=4, C=2, peak=[1, 0, 0, 0])
    for out in run4("wfst_ctc_decode", g, lp[None], np.asarray([4])).values():
        assert out["words"][0, :int(out["word_lens"][0])].tolist() == [2]


def test_decode_grammar_constraint_beats_am():
    g = _lexicon([("one", (1,))])
    lp = _rand_logp(np.random.default_rng(2), T=6, C=3,
                    peak=[0, 2, 2, 2, 0, 0])
    for out in run4("wfst_ctc_decode", g, lp[None], np.asarray([6])).values():
        assert bool(out["reached_final"][0])
        assert out["words"][0, :int(out["word_lens"][0])].tolist() == [1]


def test_decode_repeated_phone_needs_blank():
    g = _lexicon([("aa", (1, 1))])
    ok = _rand_logp(np.random.default_rng(3), T=3, C=2, peak=[1, 0, 1])
    bad = _rand_logp(np.random.default_rng(4), T=3, C=2, peak=[1, 1, 1])
    for impl, o1 in run4("wfst_ctc_decode", g, ok[None], np.asarray([3]),
                         beam=4.0).items():
        assert bool(o1["reached_final"][0])
        assert o1["words"][0, :int(o1["word_lens"][0])].tolist() == [1]
    for o2 in run4("wfst_ctc_decode", g, bad[None], np.asarray([3]),
                   beam=4.0).values():
        assert not bool(o2["reached_final"][0])


def test_decode_empty_input():
    g = _lexicon([("w", (1,))])
    lp = np.zeros((1, 4, 2), np.float32)
    for out in run4("wfst_ctc_decode", g, lp, np.asarray([0])).values():
        assert bool(out["reached_final"][0])
        assert int(out["word_lens"][0]) == 0
        assert float(out["scores"][0]) == 0.0


def test_decode_word_frames_monotone():
    g = _lexicon([("ab", (1, 2)), ("c", (3,))])
    lp = _rand_logp(np.random.default_rng(5), T=10, C=4,
                    peak=[1, 2, 0, 3, 0, 1, 2, 0, 3, 0])
    for out in run4("wfst_ctc_decode", g, lp[None],
                    np.asarray([10])).values():
        n = int(out["word_lens"][0])
        assert n >= 2
        fr = out["frames"][0, :n]
        assert (np.diff(fr) >= 0).all() and (fr >= 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_decode_random_graphs(seed):
    g = _random_graph(np.random.default_rng(100 + seed))
    lp = _rand_logp(np.random.default_rng(7 + seed), T=20, C=6, scale=2.0)
    run4("wfst_ctc_decode", g, lp[None], np.asarray([20]), beam=1e9,
         max_active=0)


def test_decode_pruned_random_graph():
    g = _random_graph(np.random.default_rng(42), n_states=12, n_arcs=60)
    lp = _rand_logp(np.random.default_rng(8), T=30, C=6)
    run4("wfst_ctc_decode", g, lp[None], np.asarray([30]), beam=8.0,
         max_active=16)


def test_decode_ragged_batch_matches_singletons_and_threads():
    g = _lexicon([("ab", (1, 2)), ("ba", (2, 1)), ("a", (1,))])
    rng = np.random.default_rng(9)
    lp = np.stack([_rand_logp(rng, 12, 3) for _ in range(3)])
    lens = np.asarray([12, 7, 1], np.int32)
    batched = run4("wfst_ctc_decode", g, lp, lens)["native"]
    for b in range(3):
        solo = pfd.wfst_ctc_decode(g[0], lp[b:b + 1], lens[b:b + 1])
        for k in batched:
            np.testing.assert_array_equal(batched[k][b], solo[k][0])
    for threads in (1, 4):
        _same(pfd.wfst_ctc_decode(g[0], lp, lens, num_threads=threads),
              batched, f"num_threads={threads}")


def test_flatten_csr_and_binary_roundtrip(tmp_path):
    fst = lexicon_to_fst([("ab", (1, 2)), ("c", (3,))])
    flat = pfd.flatten_fst(fst)
    assert flat.arc_off[-1] == len(flat.ilabels)
    assert pfd.flatten_fst(fst) is flat
    jflat = jfd.flatten_fst(j_lexicon_to_fst([("ab", (1, 2)), ("c", (3,))]))
    for f in ("arc_off", "ilabels", "olabels", "dsts", "weights", "finals"):
        np.testing.assert_array_equal(getattr(flat, f), getattr(jflat, f))
    fst.save_binary(tmp_path / "tlg.fst")
    loaded = WFST.load(tmp_path / "tlg.fst")
    lp = _rand_logp(np.random.default_rng(11), T=6, C=4,
                    peak=[1, 2, 0, 3, 0, 0])
    a = pfd.wfst_ctc_decode(fst, lp[None], np.asarray([6]))
    b = pfd.wfst_ctc_decode(loaded, lp[None], np.asarray([6]))
    _same(a, b, "binary round trip")


def test_unknown_impl_and_failed_build_raise(tmp_path, monkeypatch):
    g = _lexicon([("w", (1,))])
    lp = np.zeros((1, 2, 2), np.float32)
    with pytest.raises(ValueError, match="unknown impl"):
        pfd.wfst_ctc_decode(g[0], lp, np.asarray([2]), impl="auto")
    # A library that does not build raises; nothing falls back to Python.
    (tmp_path / "wfst_decode.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(native_build, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native_build, "_libs", {})
    with pytest.raises(RuntimeError, match="failed to build"):
        pfd.wfst_ctc_decode(g[0], lp, np.asarray([2]))


# ---- lattices and n-best (tests/test_fst_lattice.py) -----------------------


def test_nbest_matches_exhaustive_ranking():
    g = _graphs(*LOOP)
    for seed in range(3):
        lp = _rand_logp(np.random.default_rng(seed), T=5, C=3, scale=2.0)
        gold = sorted(((c, list(k)) for k, (c, _) in
                       _exhaustive_groups(g[0], lp).items()))
        for out in run4("wfst_ctc_decode_nbest", g, lp[None],
                        np.asarray([5]), nbest=6, beam=1e9, max_active=0,
                        lat_beam=1e9).values():
            n = int(out["nhyp"][0])
            assert n == min(6, len(gold))
            for i in range(n):
                np.testing.assert_allclose(-out["scores"][0, i], gold[i][0],
                                           rtol=1e-5)
                L = int(out["word_lens"][0, i])
                assert out["words"][0, i, :L].tolist() == gold[i][1]
            assert np.all(np.diff(out["scores"][0, :n]) <= 1e-6)


def test_nbest_hyp0_is_viterbi_best_path():
    g = _graphs(*LOOP)
    for seed in range(3):
        lp = _rand_logp(np.random.default_rng(100 + seed), T=7, C=3,
                        scale=1.5)
        best = run4("wfst_ctc_decode", g, lp[None], np.asarray([7]),
                    beam=1e9, max_active=0)
        nb = run4("wfst_ctc_decode_nbest", g, lp[None], np.asarray([7]),
                  nbest=4, beam=1e9, max_active=0, lat_beam=1e9)
        for impl in IMPLS:
            b, n = best[impl], nb[impl]
            np.testing.assert_allclose(n["scores"][0, 0], b["scores"][0],
                                       rtol=1e-5)
            L = int(b["word_lens"][0])
            assert n["words"][0, 0, :L].tolist() == b["words"][0, :L].tolist()
            assert (n["frames"][0, 0, :L].tolist()
                    == b["frames"][0, :L].tolist())
            assert n["reached_final"][0] == b["reached_final"][0]


def test_nbest_confidence_is_sequence_posterior():
    g = _graphs(*TWO_WORDS)
    lp = np.zeros((1, 4, 3), np.float32)
    lp[0, :, 0] = np.log(0.5)
    lp[0, :, 1] = np.log(0.35)
    lp[0, :, 2] = np.log(0.15)
    groups = _exhaustive_groups(g[0], lp[0])
    total = np.logaddexp.reduce([m for _, m in groups.values()])
    for out in run4("wfst_ctc_decode_nbest", g, lp, np.asarray([4]), nbest=2,
                    beam=1e9, max_active=0, lat_beam=1e9).values():
        w0 = int(out["words"][0, 0, 0])
        np.testing.assert_allclose(out["confidences"][0, 0],
                                   np.exp(groups[(w0,)][1] - total),
                                   rtol=1e-4)


def test_nbest_confidence_axioms():
    g = _graphs(*LOOP)
    lp = _rand_logp(np.random.default_rng(7), T=6, C=3, scale=1.0)
    for out in run4("wfst_ctc_decode_nbest", g, lp[None], np.asarray([6]),
                    nbest=3, beam=1e9, max_active=0, lat_beam=1e9).values():
        L = int(out["word_lens"][0, 0])
        conf = out["confidences"][0, :L]
        assert np.all(conf > 0.0) and np.all(conf <= 1.0)
        assert np.all(out["confidences"][0, L:] == 0.0)


def test_nbest_partial_hypothesis_and_empty_input():
    g = _lexicon([("aa", (1, 1))])
    lp = _rand_logp(np.random.default_rng(3), T=3, C=2, peak=[1, 1, 1])
    for out in run4("wfst_ctc_decode_nbest", g, lp[None], np.asarray([3]),
                    beam=4.0, nbest=2).values():
        assert not bool(out["reached_final"][0])
        assert int(out["nhyp"][0]) >= 1
    g = _graphs(*TWO_WORDS)
    for out in run4("wfst_ctc_decode_nbest", g,
                    np.zeros((1, 3, 3), np.float32), np.asarray([0]),
                    nbest=2).values():
        assert int(out["word_lens"][0, 0]) == 0
        assert int(out["nhyp"][0]) >= 1


@pytest.mark.parametrize("seed", range(4))
def test_nbest_random_graphs(seed):
    rng = np.random.default_rng(11 + 17 * seed)
    S, C = 5, 4
    arcs = [(int(rng.integers(S)), int(rng.integers(S)),
             int(rng.integers(1, C)), int(rng.integers(0, 6)),
             float(rng.uniform(0, 2))) for _ in range(12)]
    g = _graphs(arcs, {int(rng.integers(S)): float(rng.uniform(0, 1))})
    lp = _rand_logp(np.random.default_rng(seed), T=6, C=C)
    run4("wfst_ctc_decode_nbest", g, lp[None], np.asarray([6]), nbest=4,
         beam=1e9, max_active=0, lat_beam=8.0)


def test_nbest_pruned():
    g = _graphs(*LOOP)
    lp = _rand_logp(np.random.default_rng(5), T=8, C=3, scale=2.0)
    run4("wfst_ctc_decode_nbest", g, lp[None], np.asarray([8]), nbest=5,
         beam=5.0, max_active=4, lat_beam=3.0)


def test_nbest_threads_and_ragged_batch():
    g = _graphs(*LOOP)
    rng = np.random.default_rng(9)
    lp = np.stack([_rand_logp(rng, T=6, C=3) for _ in range(8)])
    lens = np.asarray([6, 4, 1, 6, 5, 2, 6, 3], np.int32)
    ref = run4("wfst_ctc_decode_nbest", g, lp, lens, nbest=3)["native"]
    for threads in (1, 4):
        _same(pfd.wfst_ctc_decode_nbest(g[0], lp, lens, nbest=3,
                                        num_threads=threads), ref,
              f"num_threads={threads}")
    for b in range(3):
        one = pfd.wfst_ctc_decode_nbest(g[0], lp[b:b + 1, :int(lens[b])],
                                        lens[b:b + 1], nbest=3)
        for k in ref:
            np.testing.assert_array_equal(ref[k][b], one[k][0])


def test_lattice_source_outflow_is_one():
    g = _graphs(*LOOP)
    lp = _rand_logp(np.random.default_rng(21), T=5, C=3)
    for lat in run4("wfst_ctc_lattice", g, lp, beam=1e9, max_active=0,
                    lat_beam=1e9).values():
        np.testing.assert_allclose(lat["post"][lat["src"] == 0].sum(), 1.0,
                                   rtol=1e-4)
        sink = int(np.nonzero(lat["node_state"] == -1)[0][0])
        np.testing.assert_allclose(lat["post"][lat["dst"] == sink].sum(),
                                   1.0, rtol=1e-4)


def test_lattice_best_cost_matches_decode():
    g = _graphs(*LOOP)
    lp = _rand_logp(np.random.default_rng(22), T=6, C=3)
    best = pfd.wfst_ctc_decode(g[0], lp[None], np.asarray([6]), beam=1e9,
                               max_active=0, impl="py")
    for lat in run4("wfst_ctc_lattice", g, lp, beam=1e9,
                    max_active=0).values():
        np.testing.assert_allclose(lat["best_cost"], -best["scores"][0],
                                   rtol=1e-5)
        assert lat["reached_final"] == bool(best["reached_final"][0])


def test_lattice_dump_parity():
    g = _graphs(*LOOP)
    lp = _rand_logp(np.random.default_rng(23), T=5, C=3)
    run4("wfst_ctc_lattice", g, lp, beam=1e9, max_active=0, lat_beam=6.0)


@pytest.mark.parametrize("impl", IMPLS)
def test_lattice_text_equals_jax(impl):
    """write_lattice_text of each package's lattice: the same text, with
    integer labels and through a words table."""
    from tpuasr.decode.lexicon import SymbolTable as JSymbolTable
    from tpuasr_torch.decode import SymbolTable
    g = _graphs(*TWO_WORDS)
    for lp in (np.zeros((4, 3), np.float32) + np.log(1 / 3),
               _rand_logp(np.random.default_rng(24), T=5, C=3)):
        lat = pfd.wfst_ctc_lattice(g[0], lp, beam=1e9, max_active=0,
                                   impl=impl)
        jlat = jfd.wfst_ctc_lattice(g[1], lp, beam=1e9, max_active=0,
                                    impl=impl)
        names = ["<eps>"] + [f"w{i}" for i in range(1, 21)]
        for words, jwords in ((None, None),
                              (SymbolTable.from_list(names),
                               JSymbolTable.from_list(names))):
            a, b = io.StringIO(), io.StringIO()
            pfd.write_lattice_text(a, "utt1", lat, words=words)
            jfd.write_lattice_text(b, "utt1", jlat, words=jwords)
            assert a.getvalue() == b.getvalue()
        lines = a.getvalue().strip().splitlines()
        assert lines[0] == "utt1"
        arcs = [ln for ln in lines[1:] if len(ln.split()) == 4]
        finals = [ln for ln in lines[1:] if len(ln.split()) == 2]
        assert arcs and finals


def _bench_lg(pkg):
    """The bench LG (bench.py:183-201: 200 words of 2-4 of 64 units from
    seed 7, a word bigram on 400 sentences) built by one package."""
    if pkg == "port":
        from tpuasr_torch.decode import compose, ngram_to_fst
        from tpuasr_torch.decode.fst import lexicon_to_fst as l2f
        from tpuasr_torch.lm import train_ngram
    else:
        from tpuasr.decode import compose, ngram_to_fst
        from tpuasr.decode.fst import lexicon_to_fst as l2f
        from tpuasr.lm import train_ngram
    rng = np.random.default_rng(7)
    prons, seen = [], set()
    while len(prons) < 200:
        p = tuple(int(v) for v in rng.integers(1, 64,
                                                 size=int(rng.integers(2, 5))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons):03d}", p))
    sents = [[f"w{int(v):03d}" for v in
              rng.integers(0, len(prons), size=int(rng.integers(3, 9)))]
             for _ in range(400)]
    return compose(l2f(prons), ngram_to_fst(
        train_ngram(sents, order=2),
        {w: i + 1 for i, (w, _) in enumerate(prons)}))


def test_jax_nbest_runs_out_of_pops_on_long_utterances_and_the_port_too():
    """A fault of the reference that the port keeps (ROADMAP Queue 3): on
    6 s of peaked random posteriors over the bench LG, the n-best's A*
    over path prefixes spends its 10,000 pops (native/wfst_lattice.cc,
    ``max(10000, nbest * 200)``) before any path reaches the sink, so it
    returns no hypothesis, while the 1-best pass reaches a final state.
    Both packages' native libraries give the same empty result."""
    lp = np.stack([_rand_logp(np.random.default_rng(s), T=300, C=64,
                              scale=5.0) for s in (0, 1)])
    lens = np.full(2, 300, np.int32)
    pf, jf = _bench_lg("port"), _bench_lg("jax")
    best = pfd.wfst_ctc_decode(pf, lp, lens)
    assert best["reached_final"].all() and (best["word_lens"] > 0).all()
    got = pfd.wfst_ctc_decode_nbest(pf, lp, lens, nbest=3)
    _same(got, jfd.wfst_ctc_decode_nbest(jf, lp, lens, nbest=3), "JAX")
    assert got["reached_final"].all()
    assert (got["nhyp"] == 0).all() and (got["word_lens"] == 0).all()
