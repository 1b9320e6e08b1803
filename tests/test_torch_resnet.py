"""tpuasr_torch ResNet-CTC (BASELINE config 2) against the JAX package (CPU).

The same numpy inputs, made from a seed, go through the Flax ``ResNetCTC``
and its port on weights converted from a Flax ``init`` (batch-norm
statistics moved off their initial values, so that each norm does real
work): eval and training forwards, padding invariance, ``Trainer`` against
the JAX ``Trainer``, the converter, ``Recognizer`` and the predict CLI.
"""

import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path
from scipy.io import wavfile

from tpuasr.decode import greedy_decode as j_greedy_decode
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.models import create_model as j_create_model
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr.utils.params import MODEL_PRESETS as J_PRESETS
from tpuasr_torch.cli import predict
from tpuasr_torch.convert import (from_jax_variables, load_npz, save_npz,
                                  to_jax_variables)
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import ResNetCTC, create_model
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.train import TrainConfig, Trainer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "golden"
C = 7
# tests/test_models.py's small ResNet, and a 4-stage, 2-block one (config
# 2's layout at narrow widths).
ARCHS = {
    "small": dict(stem_channels=8, stage_channels=(8, 16),
                  blocks_per_stage=1, dropout=0.0),
    "deep": dict(stem_channels=8, stage_channels=(8, 8, 16, 16),
                 blocks_per_stage=2, dropout=0.0),
}


def _feats(F, B=2, T=40, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = np.array([T, T - 13, 9][:B], np.int32)
    return feats, lens


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_resnet(feats, lens, arch="small", seed=0, num_classes=C):
    """A Flax ResNetCTC and its variables as numpy, every norm's running
    statistics moved off (0, 1)."""
    model = j_create_model("resnet_ctc", num_classes=num_classes,
                           **ARCHS[arch])
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                   jnp.asarray(lens), train=False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed + 100)
    for path, a in list(_leaves(v["batch_stats"])):
        node = v["batch_stats"]
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = (rng.standard_normal(a.shape) * 0.1 if path[-1]
                          == "mean" else 1.0 + rng.random(a.shape)
                          ).astype(np.float32)
    return model, v


def port_resnet(v, arch="small", F=32, num_classes=C):
    tm = create_model("resnet_ctc", num_classes=num_classes, in_features=F,
                      **ARCHS[arch])
    tm.load_state_dict(from_jax_variables(v))
    return tm


# Eval log-probs within 1e-4 (float32 convs summed in other orders); the
# out_lens exact. F=13 is an MFCC input: odd widths pad differently.
@pytest.mark.parametrize("F", [32, 13, 64])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_eval_forward_matches_flax(arch, F):
    feats, lens = _feats(F)
    jm, v = jax_resnet(feats, lens, arch)
    lp_j, ol_j = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                          train=False)
    tm = port_resnet(v, arch, F)
    with torch.no_grad():
        lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    assert lp_t.shape == (2, 20, C)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=1e-4)
    assert (lp_t[1, int(ol_t[1]):] == 0).all()
    np.testing.assert_allclose(lp_t[0].exp().sum(-1).numpy(), 1.0,
                               rtol=1e-5)


def test_flax_same_padding_is_asymmetric_where_config_2_runs():
    """Flax's SAME puts the extra pad on the high side: the stem's 5x5 /
    stride 2 on 998 frames and 64 mels pads (1, 2) on both axes, a
    freq-stride-2 3x3 on an even width (0, 1), and on an odd width (1, 1)."""
    from tpuasr_torch.models.layers import _same_pad
    assert _same_pad(998, 5, 2) == (1, 2) and _same_pad(64, 5, 2) == (1, 2)
    assert _same_pad(32, 3, 2) == (0, 1) and _same_pad(7, 3, 2) == (1, 1)
    assert _same_pad(32, 1, 2) == (0, 0)


# tests/test_models.py::test_padding_invariance's case: the same features
# with 24 zero frames more give the same valid frames (rtol 1e-4, atol
# 1e-5, as there); the port also agrees with flax on both.
@pytest.mark.parametrize("arch", list(ARCHS))
def test_padding_invariance(arch):
    B, T, F = 1, 36, 32
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, T, F)))
    lens = np.array([T], np.int32)
    jm, v = jax_resnet(feats, lens, arch, seed=1, num_classes=5)
    tm = port_resnet(v, arch, F, num_classes=5)
    pad = np.concatenate([feats, np.zeros((B, 24, F), np.float32)], axis=1)
    with torch.no_grad():
        lp1, n1 = tm(torch.tensor(feats), torch.tensor(lens))
        lp2, n2 = tm(torch.tensor(pad), torch.tensor(lens))
    assert int(n1[0]) == int(n2[0]) == 18
    n = int(n1[0])
    np.testing.assert_allclose(lp1[0, :n].numpy(), lp2[0, :n].numpy(),
                               rtol=1e-4, atol=1e-5)
    lp_j, _ = jm.apply(v, jnp.asarray(pad), jnp.asarray(lens), train=False)
    np.testing.assert_allclose(lp2.numpy(), np.asarray(lp_j), rtol=0,
                               atol=1e-4)


# The training forward (batch statistics, dropout 0) within 1e-4 of flax's
# apply(train=True); every updated running statistic within rtol 1e-5 /
# atol 1e-6 (means over B*T'*F' values summed in another order).
@pytest.mark.parametrize("F", [32, 13])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_training_forward_matches_flax(arch, F):
    feats, lens = _feats(F, B=3, seed=2)
    jm, v = jax_resnet(feats, lens, arch, seed=3)
    (lp_j, ol_j), upd = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                                 train=True, mutable=["batch_stats"])
    tm = port_resnet(v, arch, F)
    tm.train()
    lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j),
                               rtol=0, atol=1e-4)
    got = to_jax_variables(tm.state_dict())["batch_stats"]
    want = jax.tree.map(np.asarray, upd["batch_stats"])
    pairs = dict(_leaves(want))
    assert {p for p, _ in _leaves(got)} == set(pairs)
    for path, a in _leaves(got):
        np.testing.assert_allclose(a, pairs[path], rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(path))
    before = dict(_leaves(v["batch_stats"]))
    assert not np.allclose(pairs[("stem_bn", "mean")],
                           before[("stem_bn", "mean")])


def test_dropout_draws_from_the_step_generator():
    feats, lens = _feats(32)
    tm = create_model("resnet_ctc", num_classes=C, in_features=32,
                      **dict(ARCHS["small"], dropout=0.5),
                      generator=torch.Generator().manual_seed(0)).train()
    x, n = torch.tensor(feats), torch.tensor(lens)
    a, _ = tm(x, n, generator=torch.Generator().manual_seed(1))
    b, _ = tm(x, n, generator=torch.Generator().manual_seed(1))
    c, _ = tm(x, n, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    tm.eval()
    d, _ = tm(x, n)
    e, _ = tm(x, n)
    assert torch.equal(d, e)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    B, S, U = 4, 8000, 6
    wav = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    wav_lens = np.array([S, 6000, 4000, S], np.int32)
    for i in range(B):
        wav[i, wav_lens[i]:] = 0.0
    tokens = rng.integers(1, C, (B, U)).astype(np.int32)
    token_lens = np.array([6, 4, 0, 3], np.int32)
    real = np.array([1, 1, 1, 0], np.int32)          # the last row is padding
    return dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                token_lens=token_lens, real=real)


def _flat(tree):
    return {keystr(p): np.asarray(v)
            for p, v in tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_jax(optimizer):
    """Trainer(model="resnet_ctc"): loss and grad-norm of 3 steps within
    rtol 1e-4 of the JAX Trainer from the same variables (dropout 0: the
    two packages draw other masks). After nesterov SGD every parameter and
    statistic within atol 1e-5; adam divides by |g|, so there parameters
    within 4 * lr (tests/test_torch_capsnet_train.py)."""
    lr = 1e-3
    batch = _batch()
    kw = dict(model="resnet_ctc", num_classes=C, warmup_steps=1,
              ctc_impl="pallas", model_kwargs=ARCHS["small"],
              optimizer=optimizer, lr=lr)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    metrics = []
    for _ in range(3):
        js, mj = jt.train_step(js, batch)
        ts, mt = tt.train_step(ts, batch)
        metrics.append((mj, mt))
    for mj, mt in metrics:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4,
                                       err_msg=k)
    assert float(metrics[2][1]["loss"]) < float(metrics[0][1]["loss"])
    want = _flat({"params": js.params, "batch_stats": js.batch_stats})
    got = _flat(ts.variables())
    assert set(got) == set(want)
    for k in want:
        atol = 4 * lr if optimizer == "adamw" and "params" in k else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_converter_round_trip_and_registry(tmp_path):
    feats, lens = _feats(32)
    _, v = jax_resnet(feats, lens, "deep")
    tm = port_resnet(v, "deep", 32)
    back = to_jax_variables(tm.state_dict())
    want = dict(_leaves(v))
    assert {p for p, _ in _leaves(back)} == set(want)
    for path, a in _leaves(back):
        assert a.dtype == want[path].dtype
        np.testing.assert_array_equal(a, want[path])
    save_npz(back, tmp_path / "w.npz", meta=dict(model="resnet_ctc"))
    tree = load_npz(tmp_path / "w.npz")
    assert tree["meta"] == {"model": "resnet_ctc"}
    t2 = create_model("resnet_ctc", num_classes=C, in_features=32,
                      **ARCHS["deep"])
    t2.load_state_dict(from_jax_variables(tree))
    for k, val in tm.state_dict().items():
        assert torch.equal(val, t2.state_dict()[k])


def test_create_model_at_config_2_widths():
    """create_model("resnet_ctc") at the preset (stem 32, stages 32 / 64 /
    128 / 256, 2 blocks each) and 64 mels has the Flax model's every
    parameter and statistic, by name and shape: the head reads 4 x 256 =
    1024 features."""
    kwargs = J_PRESETS["resnet_ctc"][0]
    feats, lens = np.zeros((1, 16, 64), np.float32), np.array([16], np.int32)
    jm = j_create_model("resnet_ctc", num_classes=64, **kwargs)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens)))
    tm = create_model("resnet_ctc", num_classes=64, in_features=64,
                      **kwargs, generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, ResNetCTC) and not tm.training
    got = {p: a.shape for p, a in _leaves(to_jax_variables(tm.state_dict()))}
    want = {p: tuple(a.shape) for p, a in _leaves(dict(shapes))}
    assert got == want
    assert got[("params", "head", "kernel")] == (1024, 64)
    with pytest.raises(ValueError, match="64 features"):
        tm(torch.zeros(1, 20, 13), torch.tensor([20]))


def _golden_weights(tmp_path):
    """The golden wav, a Flax ResNet's weights as .npz with metadata, a
    units file, and the JAX pipeline's greedy tokens and transcript."""
    sr, data = wavfile.read(GOLDEN / "golden.wav")
    wav = (data.astype(np.float32) / 32768.0)[None]
    lens = np.array([wav.shape[1]], np.int32)
    feats, flens = JFeaturizer(JFeatureConfig(sample_rate=sr))(wav, lens)
    jm, v = jax_resnet(np.asarray(feats), np.asarray(flens), "deep", seed=5,
                       num_classes=12)
    lp, ol = jm.apply(v, feats, flens, train=False)
    tok, tl = j_greedy_decode(lp, ol)
    units = ["<blank>"] + [f"u{i}" for i in range(1, 12)]
    toks = np.asarray(tok)[0, :int(tl[0])]
    save_npz(v, tmp_path / "w.npz",
             meta=dict(model="resnet_ctc", num_classes=12,
                       model_kwargs=ARCHS["deep"],
                       feature=dict(sample_rate=sr)))
    (tmp_path / "units.txt").write_text("\n".join(units))
    return v, wav, lens, lp, ol, toks, " ".join(units[int(t)] for t in toks)


def test_recognizer_matches_jax_pipeline_on_golden_wav(tmp_path):
    v, wav, lens, lp_j, ol_j, toks, _ = _golden_weights(tmp_path)
    tm = port_resnet(v, "deep", 64, num_classes=12)
    out = Recognizer(tm, FeatureConfig(), None, device="cpu")(wav, lens)
    np.testing.assert_array_equal(out["out_lens"].numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(out["log_probs"].numpy(), np.asarray(lp_j),
                               rtol=0, atol=1e-4)
    got = out["tokens"][0, 0, :int(out["token_lens"][0, 0])].numpy()
    assert len(toks) > 0
    np.testing.assert_array_equal(got, toks)


def _predict(tmp_path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = predict.main(["resnet_ctc", str(GOLDEN / "golden.wav"),
                           "--weights", str(tmp_path / "w.npz"), "--units",
                           str(tmp_path / "units.txt"), "--device", "cpu",
                           *extra])
    return rc, buf.getvalue().strip().splitlines()


def test_cli_predict_resnet_golden(tmp_path):
    want = _golden_weights(tmp_path)[-1]
    rc, lines = _predict(tmp_path)
    assert rc == 0 and len(lines) == 1
    path, text = lines[0].split("\t")
    assert path == str(GOLDEN / "golden.wav")
    assert text == want and want
    rc, lines = _predict(tmp_path, "--beam", "--beam-width", "4")
    assert rc == 0 and len(lines) == 1
    assert all(t.startswith("u") for t in lines[0].split("\t")[1].split())
    with pytest.raises(SystemExit, match="has no GRU"):
        _predict(tmp_path, "--int8")
