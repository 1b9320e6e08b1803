"""tpuasr_torch's training step against the JAX Trainer (CPU).

The same batch (numpy, from a seed) and the same initial variables (the
JAX ``init_state``, carried across by ``from_jax_variables``) go through
``tpuasr.train.Trainer.train_step`` (Pallas GRU and Pallas CTC, run with
``interpret=True`` off a TPU, on a one-device mesh) and the port's
``Trainer.train_step`` (the plain versions of K5/K5b/K6/K6b on CPU
tensors). ``warmup_steps=1``: the first update is zero, the next two are
not.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr.train.loop import make_optimizer as j_make_optimizer
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model
from tpuasr_torch.train import TrainConfig, Trainer
from tpuasr_torch.train.optim import Optimizer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


REPO = Path(__file__).resolve().parents[1]
C = 16
MODEL = dict(rnn_hidden=32, rnn_layers=2, conv_channels=4, dropout=0.0,
             pallas_gru=True)


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


def _run_both(steps, **cfg_kw):
    batch = _batch()
    kw = dict(model="deepspeech_ctc", model_kwargs=MODEL, num_classes=C,
              warmup_steps=1, ctc_impl="pallas", **cfg_kw)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    metrics = []
    for _ in range(steps):
        js, mj = jt.train_step(js, batch)
        ts, mt = tt.train_step(ts, batch)
        metrics.append(({k: float(v) for k, v in mj.items()},
                        {k: float(v) for k, v in mt.items()}))
    want = _flat({"params": js.params, "batch_stats": js.batch_stats})
    got = _flat(ts.variables())
    return metrics, want, got, (jt, js, tt, ts, batch)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_jax(optimizer):
    """Loss and grad-norm of 3 steps within rtol 1e-4. Under nesterov SGD,
    whose update is linear in the gradient, every parameter and batch
    statistic after the third step within atol 1e-5. Adam divides each
    gradient by its own magnitude, so where |g| is near the float32
    rounding of the gradient (differences up to 5e-5 between the two
    frameworks' summation orders, on gradients up to 18) an update can
    differ by up to lr per step: parameters within atol 4 * lr for the two
    real updates, and the batch statistics that follow them within rtol
    1e-4 (1.3e-5 seen) besides atol 1e-5."""
    lr = 1e-3
    metrics, want, got, _ = _run_both(3, optimizer=optimizer, lr=lr)
    for mj, mt in metrics:
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                   rtol=1e-4)
    assert metrics[2][1]["loss"] < metrics[0][1]["loss"]
    assert set(got) == set(want)
    for k in want:
        atol, rtol = 1e-5, 0.0
        if optimizer == "adamw":
            atol, rtol = ((1e-5, 1e-4) if "batch_stats" in k
                          else (4 * lr, 0.0))
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_eval_step_matches_jax():
    _, _, _, (jt, js, tt, ts, batch) = _run_both(1, optimizer="adamw")
    ej = jt.eval_step(js, batch)
    et = tt.eval_step(ts, batch)
    np.testing.assert_allclose(float(et["loss"]), float(ej["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(et["token_lens"].numpy(),
                                  np.asarray(ej["token_lens"]))


@pytest.mark.parametrize("optimizer,schedule", [
    ("adamw", "warmup"), ("adamw", "cosine"), ("adam", "warmup"),
    ("sgd", "cosine")])
def test_optimizer_matches_optax(optimizer, schedule):
    """On identical gradients the port's chain is optax's: clip by global
    norm (one step above the norm, one below), then the optimizer at the
    scheduled rate, the first update zero."""
    kw = dict(optimizer=optimizer, lr=1e-2, warmup_steps=2,
              lr_schedule=schedule, decay_steps=5, grad_clip=5.0)
    tx = j_make_optimizer(JTrainConfig(**kw))
    opt = Optimizer(TrainConfig(**kw))
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    pj = [jnp.asarray(p) for p in p_np]
    pt = [torch.tensor(p) for p in p_np]
    sj, st = tx.init(pj), opt.init(pt)
    for step, scale in enumerate((10.0, 0.1, 3.0, 0.01, 1.0, 2.0)):
        g_np = [(rng.standard_normal(s) * scale).astype(np.float32)
                for s in shapes]
        upd, sj = tx.update([jnp.asarray(g) for g in g_np], sj, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.update(pt, [torch.tensor(g) for g in g_np], st)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-6, err_msg=f"step {step}")
        if step == 0:
            np.testing.assert_array_equal(pt[0].numpy(), p_np[0])


def test_dropout_is_seeded():
    """Dropout 0.1: the same seed gives the same step twice, another seed
    another step. (Same up to rtol 1e-6: PyTorch's CPU kernels may sum in
    another order from one call to the next; a different dropout mask
    moves the loss by far more.)"""
    batch = _batch()
    mk = dict(MODEL, dropout=0.1)
    losses = []
    for seed in (0, 0, 1):
        tt = Trainer(TrainConfig(model_kwargs=mk, num_classes=C,
                                 warmup_steps=1, seed=seed),
                     FeatureConfig(), device="cpu")
        ts = tt.init_state()
        if seed == 1:   # same weights as the first two: only dropout differs
            ts.model.load_state_dict(first_weights)
        else:
            first_weights = {k: v.clone()
                             for k, v in ts.model.state_dict().items()}
        _, m = tt.train_step(ts, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert abs(losses[2] - losses[0]) > 1e-3 * losses[0]
    # Dropout is off for evaluation.
    e1 = tt.eval_step(ts, batch)["loss"]
    e2 = tt.eval_step(ts, batch)["loss"]
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-6)


@pytest.mark.parametrize("field,value,extra", [
    ("objective", "framewise_ce", {}), ("objective", "ssvae_elbo", {}),
    ("use_grain", True, {}), ("use_grain", True, {"grain_workers": 2})])
def test_unported_fields_raise(field, value, extra):
    with pytest.raises(NotImplementedError, match=field.split("_")[0]):
        Trainer(TrainConfig(**{field: value}, **extra), FeatureConfig(),
                device="cpu")


def test_unported_paths_raise():
    # Dither is ported (the step draws it from a stream of its own,
    # tests/test_torch_features_modes.py), and bf16 training
    # (tests/test_torch_train_bf16.py); only what is not ported raises.
    Trainer(TrainConfig(), FeatureConfig(dither=1.0), device="cpu")


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(), FeatureConfig())


def test_int8_flags_ignored_in_training():
    """One instance trains in float32 and serves int8, as in JAX: the int8
    flags change nothing in training mode."""
    gen = torch.Generator().manual_seed(0)
    base = create_model("deepspeech_ctc", num_classes=C, in_features=64,
                        **MODEL, generator=gen)
    q8 = create_model("deepspeech_ctc", num_classes=C, in_features=64,
                      **MODEL, int8_proj=True, int8_rec=True)
    q8.load_state_dict(base.state_dict())
    feats = torch.randn(2, 30, 64, generator=gen)
    lens = torch.tensor([30, 21])
    a, _ = base.train()(feats, lens)
    b, _ = q8.train()(feats, lens)
    assert torch.equal(a, b)


def test_predict_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is for hosts without it")
    res = subprocess.run(
        [sys.executable, "-m", "tpuasr_torch.cli.predict", "deepspeech_ctc",
         str(tmp_path / "a.wav"), "--weights", str(tmp_path / "w.npz")],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
