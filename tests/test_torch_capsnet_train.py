"""tpuasr_torch CapsNet training (BASELINE config 4, train half) against the
JAX package (CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its port: the routing gradient (the port's plain K8b and autograd through
its plain K8, against ``jax.grad`` of the einsum + ``dynamic_routing``
reference and against the Pallas custom VJP), ``margin_loss``, the model's
training forward against flax ``apply(..., train=True)``, and
``Trainer.train_step``/``eval_step`` against the JAX ``Trainer`` from the
same converted variables. The Pallas kernels run with the package's own
``interpret=True`` (patched into the model's import of ``routed_caps``),
never under ``force_tpu_interpret_mode``, whose host callbacks can
deadlock a test that dispatches JAX ops around them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.models import create_model as j_create_model
from tpuasr.models.capsnet import dynamic_routing as j_dynamic_routing
from tpuasr.models.capsnet import margin_loss as j_margin_loss
from tpuasr.ops import pallas_routing
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr_torch import _build
from tpuasr_torch.convert import from_jax_variables
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import capsnet as capsnet_mod
from tpuasr_torch.models import create_model
from tpuasr_torch.ops import routing as routing_mod
from tpuasr_torch.train import TrainConfig, Trainer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


C = 16
# The small model of tests/test_pallas_routing.py:98-99.
SMALL = dict(conv_channels=8, primary_caps=4, primary_dim=4, class_dim=4)
# W_route is scaled up from its init so that the routing moves the coupling
# off uniform and the gradients through it are not near zero (at the init
# scale every class capsule has length ~0.001).
W_SCALE = 20.0


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX model's Pallas routing with the package's interpret=True."""
    monkeypatch.setattr(pallas_routing, "routed_caps",
                        functools.partial(pallas_routing.routed_caps,
                                          interpret=True))


# (B, T, I, Din, O, D): tests/test_pallas_routing.py::test_grad_parity's.
GRAD_CASES = [
    (2, 3, 128, 8, 12, 8),
    (1, 4, 96, 8, 10, 4),
]


def _ref_routed(u, W, O, D, iters):
    B, T, I, _ = u.shape
    u_hat = jnp.einsum("btid,idk->btik", u, W,
                       preferred_element_type=jnp.float32)
    return j_dynamic_routing(u_hat.reshape(B, T, I, O, D), iters)


# rtol 1e-4 / atol 1e-5: the JAX test's bound for its Pallas VJP against
# jax.grad of the reference (test_pallas_routing.py:74-77).
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("B,T,I,Din,O,D", GRAD_CASES)
def test_routing_grad_matches_jax(B, T, I, Din, O, D, iters):
    rng = np.random.default_rng(1)
    u = (rng.normal(size=(B, T, I, Din)) * 0.5).astype(np.float32)
    u[0, 0] = 0.0                        # s = 0: the squash VJP's eps case
    W = (rng.normal(size=(I, Din, O * D)) * 0.2).astype(np.float32)
    tgt = rng.normal(size=(B, T, O, D)).astype(np.float32)

    def loss(fn):
        return lambda u, W: jnp.sum((fn(u, W) - tgt) ** 2)

    pallas = functools.partial(pallas_routing.routed_caps, num_classes=O,
                               class_dim=D, num_iters=iters, interpret=True)
    want = [jax.grad(loss(f), argnums=(0, 1))(jnp.asarray(u), jnp.asarray(W))
            for f in (lambda u, W: _ref_routed(u, W, O, D, iters), pallas)]

    tu, tW = torch.tensor(u), torch.tensor(W)
    v = routing_mod.routed_caps_plain(tu, tW, O, D, iters)
    dv = 2.0 * (v - torch.tensor(tgt))
    plain = routing_mod.routed_caps_bwd_plain(tu, tW, dv, O, D, iters)
    # The wrapper takes the plain version for CPU tensors.
    same = routing_mod.routed_caps_bwd(tu, tW, dv, O, D, iters)
    assert all(torch.equal(a, b) for a, b in zip(same, plain))
    au, aW = tu.clone().requires_grad_(), tW.clone().requires_grad_()
    torch.sum((routing_mod.routed_caps(au, aW, O, D, iters)
               - torch.tensor(tgt)) ** 2).backward()
    assert plain[0].shape == (B, T, I, Din) and plain[1].shape == W.shape
    assert not plain[0][0, 0].any()
    for got in (plain, (au.grad, aW.grad)):
        for w in want:
            for g, r in zip(got, w):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-4, atol=1e-5)


# The kernels' seam: K8's saving mode keeps V and s, K8b starts from them.
# Their plain versions composed are the plain backward (rtol 1e-5 / atol
# 1e-6: the coupling from b = u_hat . V where the plain backward adds the
# agreement iteration by iteration) and jax.grad of the reference within
# the JAX test's bound for its Pallas VJP.
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("B,T,I,Din,O,D", GRAD_CASES)
def test_residual_split_matches_jax(B, T, I, Din, O, D, iters):
    rng = np.random.default_rng(2)
    u = (rng.normal(size=(B, T, I, Din)) * 0.5).astype(np.float32)
    u[0, 0] = 0.0
    W = (rng.normal(size=(I, Din, O * D)) * 0.2).astype(np.float32)
    tgt = rng.normal(size=(B, T, O, D)).astype(np.float32)

    def loss(u, W):
        return jnp.sum((_ref_routed(u, W, O, D, iters) - tgt) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(W))
    tu, tW = torch.tensor(u), torch.tensor(W)
    v = routing_mod.routed_caps_plain(tu, tW, O, D, iters)
    dv = 2.0 * (v - torch.tensor(tgt))
    V, s = routing_mod.routing_residuals_plain(tu, tW, O, D, iters)
    assert V.shape == s.shape == (B, T, O, D)
    torch.testing.assert_close(routing_mod.squash(s), v, rtol=1e-5,
                               atol=1e-6)
    if iters == 1:
        assert not V.any()
    got = routing_mod.routed_caps_bwd_from_plain(tu, tW, V, s, dv, O, D)
    plain = routing_mod.routed_caps_bwd_plain(tu, tW, dv, O, D, iters)
    for g, p, w in zip(got, plain, want):
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    # The wrappers take the plain versions for CPU tensors.
    res = routing_mod.routing_residuals(tu, tW, O, D, iters)
    assert torch.equal(res[0], v)
    assert torch.equal(res[1], V) and torch.equal(res[2], s)
    same = routing_mod.routed_caps_bwd_from(tu, tW, V, s, dv, O, D)
    assert all(torch.equal(a, b) for a, b in zip(same, got))


@pytest.mark.parametrize("kw", [{}, dict(m_plus=0.8, m_minus=0.2, lam=0.3)])
def test_margin_loss_matches_jax(kw):
    rng = np.random.default_rng(4)
    caps_len = rng.random((3, 7, C)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, (3, 7))]
    want = j_margin_loss(jnp.asarray(caps_len), jnp.asarray(onehot), **kw)
    got = capsnet_mod.margin_loss(torch.tensor(caps_len),
                                  torch.tensor(onehot), **kw)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _features(F=40, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 37, F)).astype(np.float32)
    lens = np.array([37, 22, 5], np.int32)
    return feats, lens


# logp within 1e-4 (float32 convs and routing summed in other orders, as in
# the eval-mode test); the updated statistics within rtol 1e-5 / atol 1e-6
# (means over B*T'*F' values summed in another order).
@pytest.mark.parametrize("time_stride", [2, 1])
@pytest.mark.parametrize("pallas_routing_flag", [False, True])
def test_training_forward_matches_flax(time_stride, pallas_routing_flag,
                                       interpret_pallas):
    feats, lens = _features()
    jm = j_create_model("capsule1", num_classes=C, **SMALL,
                        time_stride=time_stride,
                        pallas_routing=pallas_routing_flag)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(feats),
                                         jnp.asarray(lens), train=False))
    v["params"]["W_route"] = v["params"]["W_route"] * W_SCALE
    rng = np.random.default_rng(7)
    stats = v["batch_stats"]["stem_bn"]
    stats["mean"] = (rng.standard_normal(stats["mean"].shape) * 0.1
                     ).astype(np.float32)
    stats["var"] = (1.0 + rng.random(stats["var"].shape)).astype(np.float32)
    (lp_j, ol_j), upd = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                                 train=True, mutable=["batch_stats"])
    tm = create_model("capsule1", num_classes=C, **SMALL,
                      time_stride=time_stride,
                      pallas_routing=pallas_routing_flag,
                      in_features=feats.shape[-1])
    tm.load_state_dict(from_jax_variables(v))
    tm.train()
    lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j),
                               rtol=0, atol=1e-4)
    assert (lp_t[2, int(ol_t[2]):] == 0).all()
    assert float(lp_t.detach().amax(-1).amin()) > float(np.log(1.0 / C)) + 0.1
    new = upd["batch_stats"]["stem_bn"]
    np.testing.assert_allclose(tm.stem_bn.mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.stem_bn.var.numpy(), np.asarray(new["var"]),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(np.asarray(new["mean"]), stats["mean"])


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


def _trainers(pallas_routing_flag, **cfg_kw):
    """The JAX and the port's Trainer for the small CapsNet, and their
    states from the same variables (the JAX init, W_route scaled)."""
    batch = _batch()
    kw = dict(model="capsule1", num_classes=C, warmup_steps=1,
              ctc_impl="pallas",
              model_kwargs=dict(SMALL, pallas_routing=pallas_routing_flag),
              **cfg_kw)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    params = jax.tree.map(np.asarray, js.params)
    params["W_route"] = params["W_route"] * W_SCALE
    js = js.replace(params=jax.tree.map(jnp.asarray, params))
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": params,
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    return jt, js, tt, ts, batch


@pytest.mark.parametrize("pallas_routing_flag", [False, True])
def test_eval_step_matches_jax(pallas_routing_flag, interpret_pallas):
    """Trainer(model="capsule1").eval_step ran into a TypeError (the model
    took no ``generator``); now its loss is JAX's within rtol 1e-4 and its
    token lengths are exact."""
    jt, js, tt, ts, batch = _trainers(pallas_routing_flag)
    ej = jt.eval_step(js, batch)
    et = tt.eval_step(ts, batch)
    np.testing.assert_allclose(float(et["loss"]), float(ej["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(et["token_lens"].numpy(),
                                  np.asarray(ej["token_lens"]))


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("pallas_routing_flag", [False, True])
def test_train_step_matches_jax(pallas_routing_flag, optimizer,
                                interpret_pallas):
    """Loss and grad-norm of 3 steps within rtol 1e-4. After nesterov SGD
    (linear in the gradient) every parameter and stem_bn statistic within
    atol 1e-5. Adam divides each gradient by its own magnitude, so an
    update can differ by up to lr where |g| is near the float32 rounding
    of the gradient (tests/test_torch_train.py): parameters within atol
    4 * lr for the two real updates, the statistics within atol 1e-5."""
    lr = 1e-3
    jt, js, tt, ts, batch = _trainers(pallas_routing_flag,
                                      optimizer=optimizer, lr=lr)
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


def test_capsnet_training_on_cpu_never_builds_or_launches(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a kernel build was attempted on the CPU")

    monkeypatch.setattr(_build, "find_nvcc", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    before = (routing_mod.routed_caps.launches,
              routing_mod.routed_caps_bwd.launches)
    tt = Trainer(TrainConfig(model="capsule1", num_classes=C,
                             warmup_steps=1, model_kwargs=SMALL),
                 FeatureConfig(), device="cpu")
    ts = tt.init_state()
    ts, m = tt.train_step(ts, _batch())
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert (routing_mod.routed_caps.launches,
            routing_mod.routed_caps_bwd.launches) == before
