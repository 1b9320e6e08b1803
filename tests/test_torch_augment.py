"""SpecAugment and gradient accumulation in tpuasr_torch against the JAX
package (CPU).

SpecAugment: the port's apply, fed JAX's own random numbers (the test
replays ``fold_in``/``split``/``randint``/``uniform`` as
``tpuasr/features/augment.py:36-48`` draws them), gives JAX's
``spec_augment`` bit for bit; the port's draw keeps JAX's invariants
(``tests/test_augment_accum.py``); the train step applies it in training
only, from a stream of its own. Accumulation: the port's ``MultiSteps``
against optax's through both Trainers, 4 micro-steps from the same
weights: the same micro-steps move the parameters, which agree within the
sgd bound of ``test_train_step_matches_jax`` (atol 1e-5) after step 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features.augment import spec_augment as j_spec_augment
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.features.augment import (SpecAugmentDraw,
                                           apply_spec_augment,
                                           draw_spec_augment, spec_augment)
from tpuasr_torch.train import TrainConfig, Trainer

pytest_plugins = ["jax_cache_isolation"]

C = 6
MODEL = dict(rnn_hidden=16, rnn_layers=1, conv_channels=4, dropout=0.0)


def _feats(B=3, T=40, F=24, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, T, F)).astype(np.float32) + 1.0
    lens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    lens[0] = T
    for b in range(B):
        f[b, lens[b]:] = 0.0
    return f, lens


def _jax_draws(key, B, freq_masks, freq_width, time_masks):
    """JAX's random numbers for one batch, drawn as augment.py:36-48."""
    fw, fu, tu = [], [], []
    for i in range(freq_masks):
        k1, k2 = jax.random.split(jax.random.fold_in(key, 2 * i))
        fw.append(jax.random.randint(k1, (B, 1, 1), 0, freq_width + 1))
        fu.append(jax.random.uniform(k2, (B, 1, 1)))
    for i in range(time_masks):
        k1, k2 = jax.random.split(jax.random.fold_in(key, 2 * i + 1))
        tu.append(jnp.stack([jax.random.uniform(k1, (B, 1, 1)),
                             jax.random.uniform(k2, (B, 1, 1))]))

    def t(xs, shape, dtype):
        return torch.from_numpy(np.asarray(xs).reshape(shape).astype(dtype))

    return SpecAugmentDraw(freq_w=t(fw, (freq_masks, B), np.int32),
                           freq_u=t(fu, (freq_masks, B), np.float32),
                           time_u=t(tu, (time_masks, 2, B), np.float32))


@pytest.mark.parametrize("seed,fm,fwidth,tm,frac,shape", [
    (0, 2, 12, 2, 0.05, (3, 40, 24)),
    (1, 2, 8, 2, 0.2, (4, 64, 32)),
    (2, 3, 30, 1, 0.5, (5, 37, 24)),       # widths past F: max(F - w, 1)
    (3, 0, 12, 3, 0.9, (2, 90, 16)),
    (4, 1, 0, 0, 0.05, (2, 10, 8))])          # width 0: nothing masked
def test_apply_matches_jax_on_jax_draws(seed, fm, fwidth, tm, frac, shape):
    feats, lens = _feats(*shape, seed=seed)
    feats[0, 0, :4] = -feats[0, 0, :4]          # -x * 0 must give -0.0
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_spec_augment(jnp.asarray(feats), jnp.asarray(lens),
                                     key, freq_masks=fm, freq_width=fwidth,
                                     time_masks=tm, time_frac=frac))
    draw = _jax_draws(key, shape[0], fm, fwidth, tm)
    got = apply_spec_augment(torch.from_numpy(feats), torch.from_numpy(lens),
                             draw, time_frac=frac).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got != feats).any() == (fwidth > 0)


def test_draw_keeps_jax_invariants():
    """Padding untouched, masked cells exactly 0, the same bits from the
    same seed, another mask from another, the masked share bounded."""
    feats, lens = _feats(B=4, T=64, F=32, seed=3)
    feats = np.where(feats == 0, 0.0, feats + 10.0).astype(np.float32)
    x, ln = torch.from_numpy(feats), torch.from_numpy(lens)
    kw = dict(freq_masks=2, freq_width=8, time_masks=2, time_frac=0.2)

    def run(seed):
        return spec_augment(x, ln, torch.Generator().manual_seed(seed),
                            **kw).numpy()

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert not np.array_equal(a, c)
    changed = a != feats
    assert changed.any() and (a[changed] == 0).all()
    for j, n in enumerate(lens):
        assert (a[j, n:] == 0).all()
    assert 0.0 < changed.mean() < 0.6
    d = draw_spec_augment(4, torch.Generator().manual_seed(0), freq_masks=2,
                          freq_width=8, time_masks=2)
    assert d.freq_w.dtype == torch.int32 and int(d.freq_w.max()) <= 8
    assert d.time_u.shape == (2, 2, 4)


def _batch(seed):
    rng = np.random.default_rng(seed)
    B, S, U = 4, 6000, 4
    wav = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    wav_lens = np.array([S, 5000, 4000, S], np.int32)
    for i in range(B):
        wav[i, wav_lens[i]:] = 0.0
    return dict(wav=wav, wav_lens=wav_lens,
                tokens=rng.integers(1, C, (B, U)).astype(np.int32),
                token_lens=np.array([4, 3, 2, 4], np.int32),
                real=np.array([1, 1, 1, 0], bool))


def _flat(tree):
    return {keystr(p): np.asarray(v)
            for p, v in tree_flatten_with_path(tree)[0]}


def test_accumulation_matches_multisteps():
    """accum_steps=2, warmup 1, nesterov sgd, two batches in turn: micro-
    steps 1-3 leave the parameters (1 and 3 only accumulate; the first
    applied update, at 2, runs at the warmup's lr 0) and 4 moves them, in
    both packages; then every parameter within atol 1e-5, and the port's
    MultiSteps counters where optax's are."""
    kw = dict(model="deepspeech_ctc", model_kwargs=MODEL, num_classes=C,
              warmup_steps=1, optimizer="sgd", lr=1e-2, accum_steps=2)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(n_mels=32),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    batches = [_batch(0), _batch(1)]
    js = jt.init_state(batches[0])
    tt = Trainer(TrainConfig(**kw), FeatureConfig(n_mels=32), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    prev_j = _flat(js.params)
    prev_t = _flat(ts.variables()["params"])
    for micro in range(1, 5):
        batch = batches[(micro - 1) % 2]
        js, mj = jt.train_step(js, batch)
        ts, mt = tt.train_step(ts, batch)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        now_j = _flat(js.params)
        now_t = _flat(ts.variables()["params"])
        moved_j = any(not np.array_equal(now_j[k], prev_j[k]) for k in now_j)
        moved_t = any(not np.array_equal(now_t[k], prev_t[k]) for k in now_t)
        assert moved_j == moved_t == (micro == 4), (micro, moved_j, moved_t)
        prev_j, prev_t = now_j, now_t
    want = _flat({"params": js.params, "batch_stats": js.batch_stats})
    got = _flat(ts.variables())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    st = ts.opt_state
    jst = js.opt_state
    assert (st.mini_step, st.gradient_step, st.count) == (
        int(jst.mini_step), int(jst.gradient_step),
        int(jst.inner_opt_state[1][1].count)) == (0, 2, 2)


def test_train_step_applies_spec_augment_in_training_only(monkeypatch):
    """The step masks its features from stream 2 of the step's generator
    (streams 0 and 1, dropout and dither, keep their seeds): a seeded step
    repeats bit for bit, SpecAugment changes the loss, the eval step never
    masks."""
    import tpuasr_torch.train.loop as loop_mod

    batch = _batch(0)
    seen = []
    real = loop_mod.spec_augment

    def spy(feats, flens, generator, **kw):
        seen.append(generator.initial_seed())
        return real(feats, flens, generator, **kw)

    monkeypatch.setattr(loop_mod, "spec_augment", spy)

    def first_step(spec):
        tt = Trainer(TrainConfig(model="deepspeech_ctc", model_kwargs=MODEL,
                                 num_classes=C, warmup_steps=1,
                                 spec_augment=spec, sa_time_frac=0.3),
                     FeatureConfig(n_mels=32), device="cpu")
        ts = tt.init_state()
        e0 = float(tt.eval_step(ts, batch)["loss"])
        ts, m = tt.train_step(ts, batch)
        return tt, float(m["loss"]), e0

    tt, a, e_a = first_step(True)
    _, b, _ = first_step(True)
    _, plain, e_plain = first_step(False)
    assert a == b and a != plain and e_a == e_plain
    assert seen == [(0 + 1) * 1_000_003 + 0 + 2 * (1 << 40)] * 2
    assert tt._step_generator(0, 0).initial_seed() == 1_000_003
    assert tt._step_generator(5, 1).initial_seed() == 1_000_008 + (1 << 40)
