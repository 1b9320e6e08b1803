"""The port's host CTC library (``tpuasr_torch.native``: ``native/ctc_host.cc``
built by ``tpuasr_torch/native/build.py``) against the JAX package's
binding of the same source (``tpuasr.native``, built by ``make``), and as an
independent oracle of the port's own decoders: greedy decoding, the
all-class beam search (K3's plain version here) and the scan search, with
``tests/test_native.py``'s shapes and seeds.
"""

import numpy as np
import pytest
import torch

from tpuasr import native as jnative
from tpuasr_torch import native
from tpuasr_torch.decode import (BeamSearchConfig, ctc_beam_search,
                                 ctc_beam_search_xla, greedy_decode)
from tpuasr_torch.native import build as native_build
from tpuasr_torch.utils.metrics import edit_distance

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


def _log_softmax(x: np.ndarray) -> np.ndarray:
    return torch.log_softmax(torch.as_tensor(x), -1).numpy()


def test_edit_distance_matches_python_and_jax(rng):
    for _ in range(20):
        a = rng.integers(0, 5, size=rng.integers(0, 12)).astype(np.int32)
        b = rng.integers(0, 5, size=rng.integers(0, 12)).astype(np.int32)
        d = native.edit_distance_host(a, b)
        assert d == jnative.edit_distance_host(a, b)
        assert d == edit_distance(a.tolist(), b.tolist())


def test_greedy_matches_jax_and_the_port(rng):
    B, T, C = 4, 30, 8
    lp = _log_softmax(rng.standard_normal((B, T, C)).astype(np.float32))
    lens = np.array([T, T - 5, T - 10, 3], np.int32)
    ht, hl = native.ctc_greedy_host(lp, lens)
    jt, jl = jnative.ctc_greedy_host(lp, lens)
    np.testing.assert_array_equal(ht, jt)
    np.testing.assert_array_equal(hl, jl)
    dt, dl = greedy_decode(torch.as_tensor(lp), torch.as_tensor(lens))
    np.testing.assert_array_equal(hl, dl.numpy())
    for b in range(B):
        np.testing.assert_array_equal(ht[b, :hl[b]], dt.numpy()[b, :dl[b]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_beam_matches_jax_and_the_ports_searches(seed):
    """The exact map-merge host search: bit for bit JAX's binding, and at a
    wide beam the same tokens (scores within 1e-4) as the port's all-class
    search and its scan search."""
    r = np.random.default_rng(seed)
    B, T, C = 2, 8, 5
    lp = _log_softmax((r.standard_normal((B, T, C)) * 2).astype(np.float32))
    lens = np.array([T, T - 2], np.int32)
    host = native.ctc_beam_search_host(lp, lens, beam_width=64,
                                       class_topk=C - 1, max_len=T)
    jhost = jnative.ctc_beam_search_host(lp, lens, beam_width=64,
                                         class_topk=C - 1, max_len=T)
    for k in host:
        np.testing.assert_array_equal(host[k], jhost[k])
    cfg = BeamSearchConfig(beam_width=64, class_topk=C - 1, max_len=T)
    for search in (ctc_beam_search, ctc_beam_search_xla):
        dev = search(torch.as_tensor(lp), torch.as_tensor(lens), cfg)
        for b in range(B):
            n_h = int(host["token_lens"][b])
            n_d = int(dev["token_lens"][b, 0])
            assert n_h == n_d
            np.testing.assert_array_equal(
                host["tokens"][b, :n_h], dev["tokens"][b, 0, :n_d].numpy())
            np.testing.assert_allclose(host["scores"][b],
                                       float(dev["scores"][b, 0]), rtol=1e-4)


def test_narrow_host_beam_equals_jax(rng):
    """At the served beam (16 wide, 8 classes a step) on ragged lengths,
    the same tokens, lengths and scores as JAX's binding."""
    B, T, C = 6, 40, 12
    lp = _log_softmax((rng.standard_normal((B, T, C)) * 2)
                      .astype(np.float32))
    lens = np.array([40, 33, 1, 0, 17, 40], np.int32)
    a = native.ctc_beam_search_host(lp, lens, max_len=T)
    b = jnative.ctc_beam_search_host(lp, lens, max_len=T)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_build_names_the_library_by_source_and_writes_nothing_in_native(
        tmp_path, monkeypatch):
    """One library a source, named by the hash of the source, the compiler's
    version and the flags, built outside native/; a missing compiler
    raises."""
    before = sorted(p.name for p in native_build.SOURCE_DIR.iterdir())
    a = native_build.build(native_build.SOURCE_DIR / "ctc_host.cc",
                           tmp_path)
    assert a.parent == tmp_path and a.name.startswith("libctc_host_")
    assert native_build.build(native_build.SOURCE_DIR / "ctc_host.cc",
                              tmp_path) == a
    src = tmp_path / "ctc_host.cc"
    src.write_text((native_build.SOURCE_DIR / "ctc_host.cc").read_text()
                   + "\n// edited\n")
    assert native_build.build(src, tmp_path / "out").name != a.name
    assert sorted(p.name for p in native_build.SOURCE_DIR.iterdir()) == before
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="not found"):
        native_build.build(src, tmp_path / "again")
