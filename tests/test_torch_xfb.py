"""tpuasr_torch's fully fused BPTT of the projection-fused GRU scan (K2b)
against the JAX package (CPU): the plain version, the rule that picks K2b
or the recompute route, the presets, and the ``deepspeech_var`` train step
that runs K2b in every GRU direction.

The port's wrappers run their kernels' plain versions on CPU tensors; JAX's
Pallas kernels run with ``interpret=True``, which the JAX package selects
itself off a TPU. The same numpy inputs go to both.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.ops import pallas_gru as jpg
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr.utils import params as j_params
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.train import TrainConfig, Trainer
from tpuasr_torch.utils import params


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


# (T, B, D, H, row lengths): D and H not multiples of 128, a ragged mask
# with a row of length 1; the second shape's D spans two 128-lane tiles.
SHAPES = [(12, 4, 24, 16, (12, 7, 1, 9)), (9, 3, 130, 20, (9, 1, 4))]
SHAPE_IDS = ["T12_B4_D24_H16", "T9_B3_D130_H20"]


def _case(seed, T, B, D, H, lens):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    wx = (rng.standard_normal((D, 3 * H)) / np.sqrt(D)).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.array(lens)[None, :]).astype(
        np.float32)[:, :, None]
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    return x, wx, b, wh, mask, dys


def _close(got, want, what):
    """Each output within 1e-5 of its largest magnitude: float32 sums in
    other orders (dWx and dWh over all T*B rows)."""
    for g, w, name in zip(got, want, what):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k2b_plain_matches_jax_fused(shape, reverse):
    """gru_scan_xfused_bwd_plain against JAX's _xf_bwd_fused (K2b in
    interpret mode) on the same saved inputs."""
    x, wx, b, wh, mask, dys = _case(0, *shape)
    j = tuple(map(jnp.asarray, (x, wx, b, wh, mask)))
    ys = jpg.gru_scan_xfused(*j, reverse)
    want = jpg._xf_bwd_fused(j + (ys,), jnp.asarray(dys), reverse)[:4]
    ysp = gru_mod.prev_states(torch.tensor(np.asarray(ys)), reverse)
    got = gru_mod.gru_scan_xfused_bwd_plain(
        torch.tensor(x), ysp, torch.tensor(wx), torch.tensor(b),
        torch.tensor(wh), torch.tensor(mask), torch.tensor(dys), reverse)
    assert [tuple(g.shape) for g in got] == [
        x.shape, wx.shape, b.shape, wh.shape]
    _close([g.numpy() for g in got], want, ("dx", "dwx", "db", "dwh"))
    # The padded steps of the length-1 row give no gradient to its x.
    assert not got[0][1:, 2 if shape[1] == 4 else 1].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_xfused_autograd_matches_jax_vjp(shape, reverse):
    """Autograd through the port's gru_scan_xfused (K2's plain forward,
    then K2b's plain backward, which the rule picks at these widths)
    against jax.vjp of JAX's gru_scan_xfused."""
    x, wx, b, wh, mask, dys = _case(1, *shape)
    _, vjp = jax.vjp(lambda *a: jpg.gru_scan_xfused(*a, jnp.asarray(mask),
                                                    reverse),
                     *map(jnp.asarray, (x, wx, b, wh)))
    want = vjp(jnp.asarray(dys))
    args = [torch.tensor(a).requires_grad_() for a in (x, wx, b, wh)]
    with mock.patch.object(gru_mod, "gru_scan_xfused_bwd_plain",
                           wraps=gru_mod.gru_scan_xfused_bwd_plain) as k2b:
        ys = gru_mod.gru_scan_xfused(*args, torch.tensor(mask), reverse)
        (ys * torch.tensor(dys)).sum().backward()
    assert k2b.call_count == 1
    _close([a.grad.numpy() for a in args], want, ("dx", "dwx", "db", "dwh"))


# (D, H): the deepspeech_var layers (512 and 768 at H=384), DeepSpeech's
# 512 x 4 layers (512 and 1024 at H=512), and the edges of the budget at
# H=128 and 256.
GRID = [(512, 384), (768, 384), (512, 512), (1024, 512), (24, 16),
        (130, 20), (384, 512), (512, 256), (1536, 256), (1664, 256),
        (3584, 128), (3712, 128), (896, 384)]


@pytest.mark.parametrize("D,H", GRID)
def test_resident_bytes_and_rule_match_jax(D, H):
    assert gru_mod._XFB_RESIDENT_BUDGET == jpg._XFB_RESIDENT_BUDGET
    assert gru_mod._xfb_resident_bytes(D, H) == jpg._xfb_resident_bytes(D, H)
    with mock.patch.object(jpg, "_xf_bwd_fused",
                           lambda res, dys, reverse=False: "fused"), \
            mock.patch.object(jpg, "_xf_bwd_recompute",
                              lambda res, dys, reverse=False: "recompute"):
        res = (np.zeros((1, 1, D)), None, None, np.zeros((H, 3 * H)), None,
               None)
        route = jpg._xf_bwd(False, res, None)
    assert gru_mod.xfused_bwd_is_fused(D, H) == (route == "fused")


@pytest.mark.parametrize("D,H", [(512, 384), (768, 384), (1024, 512),
                                 (512, 512), (24, 16)])
def test_backward_takes_k2b_where_jax_fuses(D, H):
    """_XFusedScan.backward on CPU runs K2b's plain version exactly where
    JAX's _xf_bwd takes _xf_bwd_fused, and K5b's elsewhere."""
    fused = jpg._xfb_resident_bytes(-(-D // 128) * 128,
                                    -(-H // 128) * 128) <= \
        jpg._XFB_RESIDENT_BUDGET
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 1, D, generator=g, requires_grad=True)
    wx = (torch.randn(D, 3 * H, generator=g) / D ** 0.5).requires_grad_()
    b = torch.zeros(3 * H, requires_grad=True)
    wh = (torch.randn(H, 3 * H, generator=g) / H ** 0.5).requires_grad_()
    mask = torch.ones(2, 1, 1)
    with mock.patch.object(gru_mod, "gru_scan_xfused_bwd_plain",
                           wraps=gru_mod.gru_scan_xfused_bwd_plain) as k2b, \
            mock.patch.object(gru_mod, "gru_scan_bwd_plain",
                              wraps=gru_mod.gru_scan_bwd_plain) as k5b:
        gru_mod.gru_scan_xfused(x, wx, b, wh, mask).sum().backward()
    assert (k2b.call_count, k5b.call_count) == ((1, 0) if fused else (0, 1))
    assert all(torch.isfinite(t.grad).all() for t in (x, wx, b, wh))


def test_presets_match_jax():
    assert params.MODEL_PRESETS == j_params.MODEL_PRESETS
    for name in (*j_params.MODEL_PRESETS, "unknown"):
        assert params.preset_for(name) == j_params.preset_for(name)
    kw, _ = params.preset_for("deepspeech_var")
    kw["rnn_hidden"] = 1                   # a copy: the table is unchanged
    assert params.MODEL_PRESETS["deepspeech_var"][0]["rnn_hidden"] == 384


# ---- the deepspeech_var train step ----------------------------------------

C = 16


def _var_config():
    """The deepspeech_var preset (adamw 3e-4, clip 5) at small widths, with
    the Pallas GRU and the fused projection; dropout off (the two
    frameworks draw different masks)."""
    kwargs, train = params.preset_for("deepspeech_var")
    kwargs.update(rnn_hidden=16, rnn_layers=2, conv_channels=4, dropout=0.0,
                  pallas_gru=True, fused_proj=True)
    return dict(model="deepspeech_var", model_kwargs=kwargs, num_classes=C,
                warmup_steps=1, ctc_impl="pallas", **train)


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


@pytest.fixture(scope="module")
def var_run():
    """Three train steps of both Trainers from the JAX init, with the
    route each backward took: JAX's _xf_bwd_fused and the port's K2b and
    K5b plain versions, counted."""
    batch = _batch()
    kw = _var_config()
    assert kw["optimizer"] == "adamw" and kw["lr"] == 3e-4
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    metrics = []
    with mock.patch.object(jpg, "_xf_bwd_fused",
                           wraps=jpg._xf_bwd_fused) as j_fused, \
            mock.patch.object(gru_mod, "gru_scan_xfused_bwd_plain",
                              wraps=gru_mod.gru_scan_xfused_bwd_plain) as k2b, \
            mock.patch.object(gru_mod, "gru_scan_bwd_plain",
                              wraps=gru_mod.gru_scan_bwd_plain) as k5b:
        for _ in range(3):
            js, mj = jt.train_step(js, batch)
            ts, mt = tt.train_step(ts, batch)
            metrics.append(({k: float(v) for k, v in mj.items()},
                            {k: float(v) for k, v in mt.items()}))
        routes = (j_fused.call_count, k2b.call_count, k5b.call_count)
    return dict(metrics=metrics, routes=routes, jt=jt, js=js, tt=tt, ts=ts,
                batch=batch)


def test_deepspeech_var_train_step_matches_jax(var_run):
    """Loss and grad-norm of 3 steps within rtol 1e-4, both backwards
    through K2b: JAX traced _xf_bwd_fused (once per GRU direction, in its
    jitted step), and the port ran K2b's plain version 4 times a step and
    K5b's never."""
    j_fused, k2b, k5b = var_run["routes"]
    assert j_fused >= 4 and k2b == 3 * 4 and k5b == 0
    for mj, mt in var_run["metrics"]:
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                   rtol=1e-4)
    assert var_run["metrics"][2][1]["loss"] < var_run["metrics"][0][1]["loss"]


def test_deepspeech_var_eval_step_matches_jax(var_run):
    ej = var_run["jt"].eval_step(var_run["js"], var_run["batch"])
    et = var_run["tt"].eval_step(var_run["ts"], var_run["batch"])
    np.testing.assert_allclose(float(et["loss"]), float(ej["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(et["token_lens"].numpy(),
                                  np.asarray(ej["token_lens"]))
