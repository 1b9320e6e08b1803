"""tpuasr_torch CapsNet serving (BASELINE config 4) against the JAX package
(CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its port: routing (the port's plain K8 against JAX's einsum +
``dynamic_routing`` and against the Pallas kernel run with the package's
own ``interpret=True``), the model on weights converted from a Flax
``init``, the converter, ``Recognizer`` and the predict CLI. The JAX
kernels are never wrapped in ``force_tpu_interpret_mode`` (its host
callbacks can deadlock a test that dispatches JAX ops around them).
"""

import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode import greedy_decode as j_greedy_decode
from tpuasr.decode.pallas_beam import ctc_beam_search_pallas
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.features.pallas_fused import FusedFeaturizer as JFusedFeaturizer
from tpuasr.models import create_model as j_create_model
from tpuasr.models.capsnet import dynamic_routing as j_dynamic_routing
from tpuasr.models.capsnet import squash as j_squash
from tpuasr.ops.pallas_routing import routed_caps as j_routed_caps
from tpuasr_torch import _build
from tpuasr_torch.cli import predict
from tpuasr_torch.convert import (from_jax_variables, load_npz, save_npz,
                                  to_jax_variables)
from tpuasr_torch.decode import BeamSearchConfig, greedy_decode
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import CapsNetCTC, create_model
from tpuasr_torch.models import capsnet as capsnet_mod
from tpuasr_torch.ops import routing as routing_mod
from tpuasr_torch.serve.offline import Recognizer


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Drop the executables that earlier test files in this process traced.
    A file that ran the JAX package's Pallas kernels under
    ``pltpu.force_tpu_interpret_mode()`` leaves executables whose host
    callbacks dispatch JAX ops; reused here, they can deadlock."""
    jax.clear_caches()

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "golden"
C = 12
SMALL = dict(conv_channels=8, primary_caps=4, primary_dim=4, class_dim=4)

# (B, T, I, Din, O, D): tests/test_pallas_routing.py:34-39.
CASES = [
    (2, 3, 128, 8, 12, 8),
    (1, 4, 96, 8, 10, 4),
    (2, 2, 256, 4, 6, 16),
]


def _routing_inputs(B, T, I, Din, O, D, seed=0):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(B, T, I, Din)) * 0.5).astype(np.float32)
    W = (rng.normal(size=(I, Din, O * D)) * 0.2).astype(np.float32)
    return u, W


# rtol 2e-5 / atol 2e-6: the JAX test's bound for the Pallas kernel against
# the einsum path (test_pallas_routing.py:49); the port's plain version is
# the einsum path in torch, so only the float32 summation order differs.
@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("B,T,I,Din,O,D", CASES)
def test_plain_routing_matches_jax(B, T, I, Din, O, D, iters):
    u, W = _routing_inputs(B, T, I, Din, O, D)
    u_hat = jnp.einsum("btid,idk->btik", jnp.asarray(u), jnp.asarray(W),
                       preferred_element_type=jnp.float32)
    ref = j_dynamic_routing(u_hat.reshape(B, T, I, O, D), iters)
    pallas = j_routed_caps(jnp.asarray(u), jnp.asarray(W), O, D, iters,
                           interpret=True)
    got = routing_mod.routed_caps_plain(torch.tensor(u), torch.tensor(W), O,
                                        D, iters)
    assert got.shape == (B, T, O, D) and got.dtype == torch.float32
    for want in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)
    # The wrapper takes the plain version for CPU tensors.
    same = routing_mod.routed_caps(torch.tensor(u), torch.tensor(W), O, D,
                                   iters)
    assert torch.equal(same, got)


def test_squash_and_dynamic_routing_match_jax():
    rng = np.random.default_rng(3)
    s = (rng.normal(size=(3, 5, 7)) * 2.0).astype(np.float32)
    s[0, 0] = 0.0                              # |s| = 0: eps keeps it finite
    np.testing.assert_allclose(capsnet_mod.squash(torch.tensor(s)).numpy(),
                               np.asarray(j_squash(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-7)
    u_hat = (rng.normal(size=(2, 9, 6, 4)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        capsnet_mod.dynamic_routing(torch.tensor(u_hat), 3).numpy(),
        np.asarray(j_dynamic_routing(jnp.asarray(u_hat), 3)),
        rtol=2e-5, atol=2e-6)


def jax_capsnet(feats, lens, seed=0, **kw):
    """A Flax CapsNetCTC at small widths and its variables, with batch-norm
    statistics, the primary bias and logit_scale moved off their initial
    values so that each does real work."""
    model = j_create_model("capsule1", num_classes=C, **SMALL, **kw)
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                   jnp.asarray(lens), train=False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed + 100)
    stats = v["batch_stats"]["stem_bn"]
    stats["mean"] = (rng.standard_normal(stats["mean"].shape) * 0.1
                     ).astype(np.float32)
    stats["var"] = (1.0 + rng.random(stats["var"].shape)).astype(np.float32)
    prim = v["params"]["primary"]
    prim["bias"] = (rng.standard_normal(prim["bias"].shape) * 0.1
                    ).astype(np.float32)
    v["params"]["logit_scale"] = np.asarray(7.5, np.float32)
    return model, v


def _features(F=40, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 37, F)).astype(np.float32)
    lens = np.array([37, 22, 5], np.int32)
    return feats, lens


# logp within 1e-4: float32 convs and routing summed in other orders.
@pytest.mark.parametrize("time_stride", [2, 1])
@pytest.mark.parametrize("pallas_routing", [False, True])
def test_capsnet_matches_jax(time_stride, pallas_routing):
    feats, lens = _features()
    jm, v = jax_capsnet(feats, lens, time_stride=time_stride)
    lp_j, ol_j = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                          train=False)
    tm = create_model("capsule1", num_classes=C, **SMALL,
                      time_stride=time_stride, pallas_routing=pallas_routing,
                      in_features=feats.shape[-1])
    assert isinstance(tm, CapsNetCTC)
    tm.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    assert lp_t.shape == tuple(lp_j.shape)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=1e-4)
    assert (lp_t[2, int(ol_t[2]):] == 0).all()
    tok_j, tl_j = j_greedy_decode(lp_j, ol_j)
    tok_t, tl_t = greedy_decode(lp_t, ol_t)
    np.testing.assert_array_equal(tl_t.numpy(), np.asarray(tl_j))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_capsnet_tree_roundtrip(tmp_path):
    feats, lens = _features()
    _, v = jax_capsnet(feats, lens)
    sd = from_jax_variables(v)
    assert tuple(sd["stem.weight"].shape) == (8, 1, 5, 9)       # OIHW
    assert tuple(sd["primary.weight"].shape) == (16, 8, 3, 9)
    assert tuple(sd["primary.bias"].shape) == (16,)
    assert "stem.bias" not in sd
    assert tuple(sd["W_route"].shape) == (40, 4, C * 4)          # as in JAX
    assert sd["logit_scale"].ndim == 0 and float(sd["logit_scale"]) == 7.5
    tm = create_model("capsule1", num_classes=C, **SMALL, in_features=40)
    tm.load_state_dict(sd)
    back = to_jax_variables(tm.state_dict())
    flat = dict(_leaves(v))
    assert dict(_leaves(back)).keys() == flat.keys()
    for path, a in _leaves(back):
        assert a.shape == flat[path].shape and a.dtype == flat[path].dtype, path
        np.testing.assert_array_equal(a, flat[path], err_msg=str(path))
    save_npz(back, tmp_path / "w.npz", meta={"model": "capsule1"})
    again = load_npz(tmp_path / "w.npz")
    assert again["meta"] == {"model": "capsule1"}
    for path, a in _leaves({k: again[k] for k in ("params", "batch_stats")}):
        np.testing.assert_array_equal(a, flat[path], err_msg=str(path))
        assert a.shape == flat[path].shape


def _leaves(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(val)


def _wavs(seed):
    rng = np.random.default_rng(seed)
    S = 8000
    wav = (rng.standard_normal((3, S)) * 0.1).astype(np.float32)
    lens = np.array([S, 5300, 2100], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    return wav, lens


# logp within 1e-4, the model's bound: the two featurizers differ only in
# float32 rounding on these inputs (log-probs agree to about 5e-7); feature
# and output lengths and the greedy and beam tokens exact.
@pytest.mark.parametrize("seed", [0, 1])
def test_recognizer_matches_jax_pipeline(seed):
    wav, lens = _wavs(seed)
    feats, flens = JFusedFeaturizer(JFeatureConfig())(wav, lens)
    jm, v = jax_capsnet(np.asarray(feats), np.asarray(flens), seed=seed,
                        time_stride=2)
    lp_j, ol_j = jm.apply(v, feats, flens, train=False)
    tok_j, tl_j = j_greedy_decode(lp_j, ol_j)
    cfg = dict(beam_width=8, max_len=64)
    beam_j = ctc_beam_search_pallas(lp_j, ol_j, JBeamSearchConfig(**cfg))

    tm = create_model("capsule1", num_classes=C, **SMALL, in_features=64)
    tm.load_state_dict(from_jax_variables(v))
    out = Recognizer(tm, FeatureConfig(), None, device="cpu")(wav, lens)
    np.testing.assert_array_equal(out["feat_lens"].numpy(), np.asarray(flens))
    np.testing.assert_array_equal(out["out_lens"].numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(out["log_probs"].numpy(), np.asarray(lp_j),
                               rtol=0, atol=1e-4)
    assert out["scores"] is None
    np.testing.assert_array_equal(out["token_lens"][:, 0].numpy(),
                                  np.asarray(tl_j))
    np.testing.assert_array_equal(out["tokens"][:, 0].numpy(),
                                  np.asarray(tok_j))
    beam = Recognizer(tm, FeatureConfig(), BeamSearchConfig(**cfg),
                      device="cpu")(wav, lens)
    np.testing.assert_array_equal(beam["token_lens"].numpy(),
                                  np.asarray(beam_j["token_lens"]))
    np.testing.assert_array_equal(beam["tokens"].numpy(),
                                  np.asarray(beam_j["tokens"]))


def _golden_weights(tmp_path):
    """The golden wav, a Flax CapsNet's weights as .npz with metadata, a
    units file, and the JAX pipeline's greedy transcript of the wav."""
    sr, data = wavfile.read(GOLDEN / "golden.wav")
    wav = (data.astype(np.float32) / 32768.0)[None]
    lens = np.array([wav.shape[1]], np.int32)
    feats, flens = JFeaturizer(JFeatureConfig(sample_rate=sr))(wav, lens)
    jm, v = jax_capsnet(np.asarray(feats), np.asarray(flens), seed=5)
    lp, ol = jm.apply(v, feats, flens, train=False)
    tok, tl = j_greedy_decode(lp, ol)
    units = ["<blank>"] + [f"u{i}" for i in range(1, C)]
    want = " ".join(units[int(t)] for t in np.asarray(tok)[0, :int(tl[0])])
    save_npz(v, tmp_path / "w.npz",
             meta=dict(model="capsule1", num_classes=C, model_kwargs=SMALL))
    (tmp_path / "units.txt").write_text("\n".join(units))
    return want


def _predict(tmp_path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = predict.main(["capsule1", str(GOLDEN / "golden.wav"),
                           "--weights", str(tmp_path / "w.npz"), "--units",
                           str(tmp_path / "units.txt"), "--device", "cpu",
                           *extra])
    return rc, buf.getvalue().strip().splitlines()


def test_cli_predict_capsule1_golden(tmp_path):
    want = _golden_weights(tmp_path)
    rc, lines = _predict(tmp_path)
    assert rc == 0 and len(lines) == 1
    path, text = lines[0].split("\t")
    assert path == str(GOLDEN / "golden.wav")
    assert text == want and want
    rc, lines = _predict(tmp_path, "--beam", "--beam-width", "4")
    assert rc == 0 and len(lines) == 1
    assert all(t.startswith("u") for t in lines[0].split("\t")[1].split())


def test_cli_predict_capsule1_rejects_int8(tmp_path):
    _golden_weights(tmp_path)
    with pytest.raises(SystemExit, match="has no GRU"):
        _predict(tmp_path, "--int8")


def test_capsnet_rejects_other_feature_width():
    tm = create_model("capsule1", num_classes=C, **SMALL, in_features=40)
    for train in (False, True):
        tm.train(train)
        with pytest.raises(ValueError, match="40 features"):
            tm(torch.zeros(1, 9, 64), torch.tensor([9]))


def test_seeded_capsnet_init():
    kw = dict(num_classes=48, in_features=64)
    a = create_model("capsule1", **kw,
                     generator=torch.Generator().manual_seed(7))
    b = create_model("capsule1", **kw,
                     generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # Config 4's widths (tpuasr/utils/params.py:29-33): N_in = 16 * 16.
    assert tuple(a.W_route.shape) == (256, 8, 48 * 16)
    assert tuple(a.stem.weight.shape) == (64, 1, 5, 9)
    assert tuple(a.primary.weight.shape) == (128, 64, 3, 9)
    assert float(a.logit_scale.detach()) == 10.0
    # flax lecun_normal on (N_in, Din, O*D): variance 1 / (N_in * Din).
    std = float(a.W_route.detach().std())
    assert abs(std - (256 * 8) ** -0.5) < 0.02 * (256 * 8) ** -0.5


def test_capsnet_on_cpu_never_builds_or_launches(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a kernel build was attempted on the CPU")

    monkeypatch.setattr(_build, "find_nvcc", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    before = routing_mod.routed_caps.launches
    tm = create_model("capsule1", num_classes=C, **SMALL, in_features=64,
                      generator=torch.Generator().manual_seed(0))
    out = Recognizer(tm, FeatureConfig(), BeamSearchConfig(beam_width=4,
                                                           max_len=32),
                     device="cpu")(*_wavs(2))
    assert bool(torch.isfinite(out["log_probs"]).all())
    assert routing_mod.routed_caps.launches == before
