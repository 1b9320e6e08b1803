"""tpuasr_torch's fused bidirectional GRU (K7, K7b) against the JAX package
(CPU): the scan and its backward, the BiGRU layer, the model served and
trained, and the converter.

The port's wrappers run their kernels' plain versions on CPU tensors; JAX's
Pallas ``gru_scan_bidir`` runs with ``interpret=True``, which the JAX
package selects itself off a TPU. The same numpy inputs go to both.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.models import create_model as j_create_model
from tpuasr.models.layers import BiGRU as JBiGRU
from tpuasr.models.layers import reverse_sequences as j_reverse
from tpuasr.ops.pallas_gru import gru_scan_bidir as j_scan_bidir
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr_torch.convert import from_jax_variables, to_jax_variables
from tpuasr_torch.decode import greedy_decode
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model
from tpuasr_torch.models import layers as layers_mod
from tpuasr_torch.models.layers import BiGRU, reverse_sequences
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops.gru import (gru_scan_bidir, gru_scan_bidir_bwd_plain,
                                  gru_scan_bidir_plain, prev_states)
from tpuasr_torch.train import TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Drop the executables that earlier test files in this process traced.
    A file that ran the JAX package's Pallas kernels under
    ``pltpu.force_tpu_interpret_mode()`` leaves executables whose host
    callbacks dispatch JAX ops; reused here, they can deadlock."""
    jax.clear_caches()

T, B, D, H = 12, 4, 24, 16
LENS = np.array([T, T - 5, 1, 7])        # ragged, one row of length 1


def _scan_case(seed):
    rng = np.random.default_rng(seed)
    xpf = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    xpb = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    whf = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    whb = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    mask = (np.arange(T)[:, None] < LENS[None, :]).astype(np.float32)
    return xpf, xpb, whf, whb, mask[:, :, None]


def _t(a):
    return torch.tensor(np.asarray(a))


def test_scan_f32_matches_jax():
    """f32: rtol 1e-5 (the same recurrence, sums in another order)."""
    case = _scan_case(0)
    want = j_scan_bidir(*map(jnp.asarray, case))
    got = gru_scan_bidir_plain(*map(_t, case))
    wrapped = gru_scan_bidir(*map(_t, case))
    for g, w, g2 in zip(got, want, wrapped):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(g, g2)
    # Padded steps freeze the state: the length-1 row keeps its h_0.
    assert torch.equal(got[0][1:, 2], got[0][:1, 2].expand(T - 1, H))


def test_scan_bf16_matches_jax():
    """bf16 streams (xp, Wh and ys in bf16, h rounded to bf16 for h@Wh,
    f32 gates): atol 8e-3, the K2 tests' bound (one bf16 ulp at |ys| < 1
    plus its echo through the next steps)."""
    case = _scan_case(1)
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a, bf) for a in case[:4]] + [jnp.asarray(case[4])]
    want = j_scan_bidir(*jargs)
    targs = [_t(a).to(torch.bfloat16) for a in case[:4]] + [_t(case[4])]
    got = gru_scan_bidir(*targs)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=8e-3)


def test_backward_matches_jax_vjp():
    """dxpf, dxpb, dWhf, dWhb through the port's autograd (K7b's plain
    version on CPU) and gru_scan_bidir_bwd_plain directly against jax.vjp
    of JAX's custom VJP, rtol 1e-4 as test_fused_bidir_matches_reference
    holds JAX."""
    case = _scan_case(2)
    rng = np.random.default_rng(3)
    dys = [rng.standard_normal((T, B, H)).astype(np.float32)
           for _ in range(2)]
    jargs = list(map(jnp.asarray, case))
    _, vjp = jax.vjp(lambda a, b, c, d: j_scan_bidir(a, b, c, d, jargs[4]),
                     *jargs[:4])
    want = vjp(tuple(map(jnp.asarray, dys)))
    leaves = [_t(a).requires_grad_() for a in case[:4]]
    ysf, ysb = gru_scan_bidir(*leaves, _t(case[4]))
    torch.autograd.backward((ysf, ysb), tuple(map(_t, dys)))
    direct = gru_scan_bidir_bwd_plain(
        _t(case[0]), _t(case[1]), prev_states(ysf.detach(), False),
        prev_states(ysb.detach(), False), _t(case[2]), _t(case[3]),
        _t(case[4]), *map(_t, dys))
    for leaf, d, w in zip(leaves, direct, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(leaf.grad, d)
    # Padded steps get no gradient.
    assert not leaves[0].grad[1:, 2].any()


def test_no_grad_saves_nothing():
    """Under no_grad the scan returns plain tensors (no graph), and with an
    input requiring grad a bf16 stream is refused (backward is f32 only)."""
    case = [_t(a) for a in _scan_case(0)]
    with torch.no_grad():
        ysf, ysb = gru_scan_bidir(case[0].requires_grad_(), *case[1:])
    assert ysf.grad_fn is None and ysb.grad_fn is None
    bf = [a.to(torch.bfloat16) for a in case[:4]]
    with pytest.raises(NotImplementedError, match="float32"):
        gru_scan_bidir(bf[0].requires_grad_(), *bf[1:], case[4])


def test_reverse_sequences_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, 3)).astype(np.float32)
    want = np.asarray(j_reverse(jnp.asarray(x), jnp.asarray(LENS)))
    got = reverse_sequences(_t(x).permute(1, 0, 2), torch.tensor(LENS))
    np.testing.assert_array_equal(got.permute(1, 0, 2).numpy(), want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bigru_layer_matches_flax(bf16):
    """BiGRU(fused_bidir=True) on a converted Flax BiGRU(fused_bidir=True)
    tree: the outputs (f32 atol 1e-5; bf16 streams 8e-3, as the scan), and
    in f32 the gradients of every parameter and of x (rtol 1e-4)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = jnp.asarray(LENS, jnp.int32)
    jl = JBiGRU(hidden=H, fused_bidir=True, bf16_kernel=bf16)
    v = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), lens))
    want = np.asarray(jl.apply(v, jnp.asarray(x), lens))
    layer = BiGRU(D, H, fused_bidir=True,
                  compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    sd = from_jax_variables({"params": {"rnn": v["params"]}})
    layer.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    assert sorted(dict(layer.named_parameters())) == sorted(
        f"{d}_{w}" for d in ("fwd", "bwd") for w in ("wx", "wh", "b"))
    mask = (np.arange(T)[:, None] < LENS[None, :]).astype(np.float32)
    xt = _t(x).permute(1, 0, 2).contiguous().requires_grad_(not bf16)
    with torch.set_grad_enabled(not bf16):     # bf16 serves only
        got = layer(xt, _t(mask[:, :, None]))
    np.testing.assert_allclose(got.detach().permute(1, 0, 2).numpy(), want,
                               rtol=0, atol=8e-3 if bf16 else 1e-5)
    if bf16:
        return
    rng = np.random.default_rng(6)
    dy = rng.standard_normal(want.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jl.apply({"params": p}, xx, lens) * dy)

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    (got * _t(dy).permute(1, 0, 2)).sum().backward()
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.permute(1, 0, 2).numpy(),
                               np.asarray(gx), rtol=1e-4, atol=1e-5)


# The model (as tests/test_torch_model.py).
MB, MT, MF, MC = 3, 40, 16, 16
BASE = dict(num_classes=MC, rnn_hidden=32, rnn_layers=2, conv_channels=4,
            dropout=0.0)


def _model_pair(kw):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((MB, MT, MF)).astype(np.float32)
    lens = np.array([MT, MT - 9, 5], np.int32)
    jm = j_create_model("deepspeech_ctc", **BASE, **kw)
    v = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens),
        train=False))
    rng = np.random.default_rng(100)
    for stats in v["batch_stats"].values():
        stats["mean"] = (rng.standard_normal(stats["mean"].shape)
                         * 0.1).astype(np.float32)
        stats["var"] = (1.0 + rng.random(stats["var"].shape)).astype(
            np.float32)
    tm = create_model("deepspeech_ctc", **BASE, **kw, in_features=MF)
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, tm, feats, lens


@pytest.mark.parametrize("kw,tol", [
    (dict(fused_bidir=True), 1e-4),
    (dict(fused_bidir=True, pallas_gru=True), 1e-4),
    (dict(fused_bidir=True, pallas_gru=True, bf16_gru=True), 2e-3),
    (dict(fused_bidir=True, bf16_gru=True), 2e-3),
], ids=["f32", "f32_kernel_path", "bf16_stream", "bf16_kernel_only"])
def test_model_matches_jax(kw, tol):
    """DeepSpeechCTC(fused_bidir=True) served on converted weights:
    out_lens and greedy tokens exact, logp within tol (f32: summation
    order; bf16: one flipped bf16 rounding moves a log-prob by about 1e-3
    at these widths, as in tests/test_torch_model.py)."""
    jm, v, tm, feats, lens = _model_pair(kw)
    lp_j, ol_j = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                          train=False)
    before = gru_mod.gru_scan_bidir_fwd.launches
    with torch.inference_mode():
        lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    assert gru_mod.gru_scan_bidir_fwd.launches == before   # CPU: plain
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=tol)
    toks_t, tl_t = greedy_decode(lp_t, ol_t)
    toks_j, tl_j = greedy_decode(torch.tensor(np.asarray(lp_j)), ol_t)
    np.testing.assert_array_equal(tl_t.numpy(), tl_j.numpy())
    np.testing.assert_array_equal(toks_t.numpy(), toks_j.numpy())


def test_model_runs_one_fused_scan_per_layer():
    """Each layer calls the fused scan once; the per-direction kernels
    (K2, K4, K5) are not called."""
    _, _, tm, feats, lens = _model_pair(dict(fused_bidir=True,
                                             pallas_gru=True))
    calls = []
    real = gru_mod.gru_scan_bidir_fwd

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    def fail(*a, **k):
        raise AssertionError("a per-direction scan ran")

    with mock.patch.object(gru_mod, "gru_scan_bidir_fwd", spy), \
            mock.patch.object(layers_mod, "gru_scan_xfused", fail), \
            mock.patch.object(layers_mod, "gru_scan", fail), \
            torch.inference_mode():
        tm(torch.tensor(feats), torch.tensor(lens))
    assert calls == [(MT // 2, MB, 96)] * 2


def test_convert_roundtrip_fused_bidir():
    """A Flax fused_bidir tree crosses to the port under JAX's names
    (rnn0.fwd_wx, ...) and back unchanged."""
    _, v, tm, _, _ = _model_pair(dict(fused_bidir=True))
    names = set(tm.state_dict())
    for i in range(2):
        for d in ("fwd", "bwd"):
            for w in ("wx", "wh", "b"):
                assert f"rnn{i}.{d}_{w}" in names
    back = to_jax_variables(tm.state_dict())
    want = {keystr(p): np.asarray(a)
            for p, a in tree_flatten_with_path(v)[0]}
    got = {keystr(p): a for p, a in tree_flatten_with_path(back)[0]}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n, S, U = 4, 8000, 6
    wav = (rng.standard_normal((n, S)) * 0.1).astype(np.float32)
    wav_lens = np.array([S, 6000, 4000, S], np.int32)
    for i in range(n):
        wav[i, wav_lens[i]:] = 0.0
    tokens = rng.integers(1, MC, (n, U)).astype(np.int32)
    return dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                token_lens=np.array([6, 4, 0, 3], np.int32),
                real=np.array([1, 1, 1, 0], np.int32))


def test_trainer_matches_jax():
    """Trainer with model_kwargs {"fused_bidir": True, "pallas_gru": True}
    against the JAX Trainer (one-device mesh), 3 steps of nesterov SGD,
    as tests/test_torch_train.py holds the K5 path: loss and grad-norm
    within rtol 1e-4, every parameter and batch statistic after the third
    step within atol 1e-5."""
    batch = _batch()
    kw = dict(model="deepspeech_ctc", num_classes=MC, warmup_steps=1,
              ctc_impl="pallas", optimizer="sgd", lr=1e-3,
              model_kwargs=dict(rnn_hidden=32, rnn_layers=2, conv_channels=4,
                                dropout=0.0, pallas_gru=True,
                                fused_bidir=True))
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    assert "fwd_wx" in dict(ts.model.rnn0.named_parameters())
    losses = []
    for _ in range(3):
        js, mj = jt.train_step(js, batch)
        ts, mt = tt.train_step(ts, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-4, err_msg=k)
        losses.append(float(mt["loss"]))
    assert losses[2] < losses[0]
    want = {keystr(p): np.asarray(a) for p, a in tree_flatten_with_path(
        {"params": js.params, "batch_stats": js.batch_stats})[0]}
    got = {keystr(p): a for p, a in tree_flatten_with_path(
        ts.variables())[0]}
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
