"""The LM-fused and graph-constrained serving path of tpuasr_torch as a
whole, on the CPU: ``Recognizer`` (features -> AM -> fused or graph search)
against the JAX pipeline on the same wavs and weights, and the CLI's
``--lm``/``--lm-fusion`` and ``--graph-decode`` requests.

The model is the float32 DeepSpeechCTC at a small width, so the two
pipelines' log-probs agree to float32 rounding and the searches see the
same inputs; tokens must then be equal.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode import compile_graph_tables as j_compile_graph_tables
from tpuasr.decode import compose as j_compose
from tpuasr.decode import ctc_beam_search as j_ctc_beam_search
from tpuasr.decode import lexicon_to_fst as j_lexicon_to_fst
from tpuasr.decode import ngram_to_fst as j_ngram_to_fst
from tpuasr.decode.pallas_beam import ctc_beam_search_pallas
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features.pallas_fused import FusedFeaturizer as JFusedFeaturizer
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr.models import create_model as j_create_model
from tpuasr_torch.cli import predict
from tpuasr_torch.cli.common import fusion_tables, run_beam_search
from tpuasr_torch.convert import from_jax_variables, save_npz, to_jax_variables
from tpuasr_torch.decode import BeamSearchConfig, GraphTables, lexicon_to_fst
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.lm import train_ngram
from tpuasr_torch.models import create_model
from tpuasr_torch.serve.offline import Recognizer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


C = 12
BASE = dict(num_classes=C, rnn_hidden=24, rnn_layers=2, conv_channels=4,
            dropout=0.0)
UNITS = ["<blank>"] + [f"u{i}" for i in range(1, C)]


def _wavs(seed):
    rng = np.random.default_rng(seed)
    S = 8000
    wav = (rng.standard_normal((2, S)) * 0.1).astype(np.float32)
    lens = np.array([S, 5200], np.int32)
    wav[1, lens[1]:] = 0.0
    return wav, lens


def _unit_lm(order):
    rng = np.random.default_rng(order)
    sents = [[UNITS[int(v)] for v in rng.integers(1, C, size=6)]
             for _ in range(40)]
    return j_train_ngram(sents, order=order), train_ngram(sents, order=order)


def _lexicon(seed=3, n_words=10):
    rng = np.random.default_rng(seed)
    prons, seen = [], set()
    while len(prons) < n_words:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(1, 4))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons)}", p))
    sents = [[f"w{int(v)}" for v in rng.integers(0, n_words, size=4)]
             for _ in range(40)]
    return prons, sents


def _jax_pipeline(seed):
    wav, lens = _wavs(seed)
    feats, flens = JFusedFeaturizer(JFeatureConfig())(wav, lens)
    jm = j_create_model("deepspeech_ctc", **BASE)
    variables = jm.init(jax.random.PRNGKey(seed), feats, flens, train=False)
    lp, ol = jm.apply(variables, feats, flens, train=False)
    tm = create_model("deepspeech_ctc", **BASE, in_features=64)
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray,
                                                       variables)))
    return wav, lens, lp, ol, tm


@pytest.mark.parametrize("order", [2, 3])
def test_recognizer_lm_fusion_matches_jax(order):
    wav, lens, lp, ol, tm = _jax_pipeline(order)
    jlm, tlm = _unit_lm(order)
    kw = dict(beam_width=4, max_len=64, lm_weight=0.5)
    a = ctc_beam_search_pallas(lp, ol, JBeamSearchConfig(**kw), n_best=2,
                               **fusion_tables(jlm, UNITS, order))
    rec = Recognizer(tm, FeatureConfig(), BeamSearchConfig(**kw), "cpu",
                     n_best=2, lm_tables=fusion_tables(tlm, UNITS, order))
    b = rec(wav, lens)
    np.testing.assert_allclose(b["log_probs"].numpy(), np.asarray(lp),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(b["token_lens"].numpy(),
                                  np.asarray(a["token_lens"]))
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(a["tokens"]))
    np.testing.assert_allclose(b["lm_scores"].numpy(),
                               np.asarray(a["lm_scores"]), rtol=0, atol=1e-3)


def test_recognizer_graph_matches_jax():
    wav, lens, lp, ol, tm = _jax_pipeline(5)
    prons, sents = _lexicon()
    lg = j_compose(j_lexicon_to_fst(prons),
                   j_ngram_to_fst(j_train_ngram(sents, order=2),
                                  {w: i + 1 for i, (w, _) in
                                   enumerate(prons)}))
    jt = j_compile_graph_tables(lg, C, prune=10.0, quantum=0.1)
    kw = dict(beam_width=6, class_topk=4, max_len=64)
    a = j_ctc_beam_search(lp, ol, JBeamSearchConfig(**kw), graph=jt)
    rec = Recognizer(tm, FeatureConfig(), BeamSearchConfig(**kw), "cpu",
                     graph=GraphTables(jt.next_state, jt.cost, jt.final,
                                       start=jt.start))
    b = rec(wav, lens)
    for key in ("tokens", "token_lens", "reached_final"):
        np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]))
    np.testing.assert_allclose(b["scores"].numpy(), np.asarray(a["scores"]),
                               rtol=0, atol=1e-3)


def test_fallback_to_scan_search_is_loud(capsys):
    """The trigram size gate of the kernel search sends the request to the
    scan search, with a line on stderr (as the JAX CLI does)."""
    Cb = 192
    rng = np.random.default_rng(0)
    lp = torch.log_softmax(torch.tensor(rng.standard_normal((1, 3, Cb)),
                                        dtype=torch.float32), -1)
    tri = np.zeros((Cb + 1, Cb + 1, Cb), np.float32)
    out = run_beam_search("auto", lp, torch.tensor([3]),
                          BeamSearchConfig(beam_width=2, class_topk=2,
                                           max_len=3, lm_weight=0.5),
                          n_best=1, lm_trigram=tri)
    assert "falling back to the scan search" in capsys.readouterr().err
    assert out["tokens"].shape == (1, 1, 3)
    with pytest.raises(ValueError, match="need a beam_cfg"):
        Recognizer(create_model("deepspeech_ctc", **BASE, in_features=64),
                   FeatureConfig(), None, "cpu", lm_tables=dict(
                       lm_bigram=np.zeros((Cb + 1, Cb), np.float32)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_lm")
    model = create_model("deepspeech_ctc", num_classes=C, rnn_hidden=16,
                         rnn_layers=1, conv_channels=2,
                         generator=torch.Generator().manual_seed(0))
    meta = dict(model="deepspeech_ctc", num_classes=C,
                model_kwargs=dict(rnn_hidden=16, rnn_layers=1,
                                  conv_channels=2))
    save_npz(to_jax_variables(model.state_dict()), tmp / "w.npz", meta=meta)
    (tmp / "units.txt").write_text("\n".join(UNITS))
    _, tlm = _unit_lm(3)
    tlm.save_arpa(tmp / "units.arpa")
    prons, sents = _lexicon()
    (tmp / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, (w, _) in enumerate(prons)))
    (tmp / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(UNITS[p] for p in pr)}\n" for w, pr in prons))
    train_ngram(sents, order=2).save_arpa(tmp / "words.arpa")
    # The lexicon as an L transducer; its olabel i + 1 is word i.
    lexicon_to_fst(prons).save_text(tmp / "l.fst")
    (tmp / "fst_words.txt").write_text("<eps> 0\n" + "".join(
        f"{w} {i + 1}\n" for i, (w, _) in enumerate(prons)))
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((8000, 5200)):
        p = tmp / f"utt{i}.wav"
        wavfile.write(p, 8000, (rng.standard_normal(n) * 3000)
                      .astype(np.int16))
        paths.append(str(p))
    return tmp, paths


@pytest.mark.parametrize("extra", [
    ["--beam", "--lm", "units.arpa", "--lm-fusion"],
    ["--beam", "--lm", "units.arpa", "--lm-fusion", "--lm-fusion-order", "3",
     "--beam-impl", "xla", "--nbest", "2"],
    ["--beam", "--lm", "units.arpa", "--lexicon", "lexicon.txt", "--words",
     "words.txt"],
    ["--graph-decode", "--lexicon", "lexicon.txt", "--words", "words.txt",
     "--lm", "words.arpa", "--graph-topk", "4"],
    ["--beam", "--fst", "l.fst", "--fst-osyms", "fst_words.txt", "--nbest",
     "2"],
    ["--graph-decode", "--fst", "l.fst", "--fst-osyms", "fst_words.txt"],
], ids=["fusion2", "fusion3_xla_nbest", "rescore_words", "graph",
        "fst_rescore", "graph_fst"])
def test_cli_lm_and_graph(served, capsys, extra):
    tmp, paths = served
    extra = [str(tmp / a) if (tmp / a).exists() else a for a in extra]
    rc = predict.main(["deepspeech_ctc", *paths, "--weights",
                       str(tmp / "w.npz"), "--units", str(tmp / "units.txt"),
                       "--beam-width", "4", "--device", "cpu", *extra])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    n_best = 2 if "--nbest" in extra else 1
    assert len(lines) == n_best * len(paths)
    # Words from a graph or a lexicon; FST rescoring prints the transduced
    # words, or the units of a hypothesis the FST rejects.
    if "--graph-decode" in extra or "--lexicon" in extra:
        prefixes = ("w",)
    elif "--fst" in extra:
        prefixes = ("w", "u")
    else:
        prefixes = ("u",)
    for i, line in enumerate(lines):
        path, *rest = line.split("\t")
        assert path == paths[i // n_best]
        assert all(t.startswith(prefixes) for t in rest[-1].split())


def test_cpu_lm_and_graph_paths_never_build_or_launch(monkeypatch):
    """On CPU tensors the LM-fused and graph searches run the plain
    versions of K3 and K10: no build, no launch."""
    import subprocess

    from tpuasr_torch import _build
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.ops import gather as gather_mod

    def no_build(*a, **k):
        raise AssertionError("a kernel build was attempted on the CPU")

    for name in ("find_nvcc", "build", "lib"):
        monkeypatch.setattr(_build, name, no_build)
    monkeypatch.setattr(subprocess, "run", no_build)
    before = (beam_mod.beam_scan.launches, gather_mod.gather_rows.launches)
    _, tlm = _unit_lm(2)
    prons, sents = _lexicon()
    from tpuasr_torch.decode import (compile_graph_tables, compose,
                                     lexicon_to_fst, ngram_to_fst)
    lg = compose(lexicon_to_fst(prons),
                 ngram_to_fst(train_ngram(sents, order=2),
                              {w: i + 1 for i, (w, _) in enumerate(prons)}))
    tabs = compile_graph_tables(lg, C, prune=10.0, quantum=0.1)
    model = create_model("deepspeech_ctc", **BASE, in_features=64,
                         generator=torch.Generator().manual_seed(1))
    wav, lens = _wavs(9)
    cfg = BeamSearchConfig(beam_width=4, class_topk=4, max_len=64,
                           lm_weight=0.5)
    for kw in (dict(lm_tables=fusion_tables(tlm, UNITS, 2)),
               dict(graph=tabs)):
        out = Recognizer(model, FeatureConfig(), cfg, "cpu", **kw)(wav, lens)
        assert bool(torch.isfinite(out["scores"]).all())
    assert (beam_mod.beam_scan.launches,
            gather_mod.gather_rows.launches) == before
    assert _build._lib is None
