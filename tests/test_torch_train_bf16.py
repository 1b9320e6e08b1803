"""bf16 training in tpuasr_torch against the JAX package (CPU): BASELINE
config 3's bf16 operating points (``bf16_compute`` with the TPU's
``pallas_gru``, ``bf16_gru`` and ``bf16_conv``).

* DeepSpeechCTC in training with the bf16 flags that route through K7b-bf16
  (``fused_bidir``), through the f32 scan over a rounded xp
  (``bf16_gru`` without ``pallas_gru``), the unidirectional streaming model
  with ``bf16_conv``, and config 3's flags on bf16 features, against
  ``jax.grad`` of the Flax model (``torch_bf16_common``; the kernel-level
  checks and the other model flags are in test_torch_gru_bf16.py);
* ``Trainer.train_step`` with ``bf16_compute`` and config 3's flags against
  JAX's ``Trainer.train_step``, compiled so that it rounds every bf16 value
  it names (``EXACT_BF16``);
* a bf16 model served through ``Recognizer`` on the unfused route (K5-bf16)
  against the JAX model's greedy tokens, and ``batch_train`` with the bf16
  model kwargs, its checkpoint read back by both packages and served by
  ``cli.test``.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.decode import greedy_decode as j_greedy_decode
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.models import create_model as j_create_model
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr.train.loop import TrainState as JTrainState
from tpuasr.train.checkpoints import load_for_inference as j_load
from tpuasr_torch.cli import batch_train
from tpuasr_torch.cli import test as cli_test
from tpuasr_torch.convert import to_jax_variables
from tpuasr_torch.data import AudioLoader, LoaderConfig, make_synthetic_corpus
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model
from tpuasr_torch.serve import Recognizer
from tpuasr_torch.train import TrainConfig, Trainer
from tpuasr_torch.train.checkpoints import restore_checkpoint

from torch_bf16_common import EXACT_BF16, LOGP_TOL, check_model_grads

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]

# Config 3's bf16 points on the TPU (benchmarks/config3_deepspeech_train.py
# :40-45, :82-83), at a tiny width.
TPU_BF16 = dict(pallas_gru=True, bf16_gru=True, bf16_conv=True)
C = 16
MODEL = dict(rnn_hidden=16, rnn_layers=2, conv_channels=4, dropout=0.0)


@pytest.mark.parametrize("kw,bf16_feats", [
    (dict(pallas_gru=True, bf16_gru=True, fused_bidir=True), True),
    (dict(bf16_gru=True), False),
    (dict(bidirectional=False, explicit_pad=True, bf16_conv=True), False),
    (TPU_BF16, True),
], ids=["fused_bidir_bf16_gru", "bf16_gru_without_pallas",
        "unidirectional_explicit_pad_bf16_conv", "config3_tpu_bf16_feats"])
def test_model_bf16_grads_match_jax(kw, bf16_feats):
    check_model_grads(kw, bf16_feats)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    B, S, U = 4, 8000, 6
    wav = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    wav_lens = np.array([S, 6000, 4000, S], np.int32)
    for i in range(B):
        wav[i, wav_lens[i]:] = 0.0
    tokens = rng.integers(1, C, (B, U)).astype(np.int32)
    token_lens = np.array([6, 4, 0, 3], np.int32)
    real = np.array([1, 1, 1, 0], np.int32)
    return dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                token_lens=token_lens, real=real)


def _flat(tree):
    return {keystr(p): np.asarray(v)
            for p, v in tree_flatten_with_path(tree)[0]}


def test_train_step_bf16_compute_matches_jax():
    """Two steps of config 3's bf16 point (bf16_compute, pallas_gru,
    bf16_gru, bf16_conv) under nesterov SGD, warmup 1 (the first update is
    zero, the second is not, on the same gradient): loss and grad-norm of
    each step within rtol 2^-8 (one bf16 rounding; measured 1.6e-4). Every
    parameter's change within 2^-4 of its tensor's largest change: SGD's
    change is linear in the gradient, and torch_bf16_common holds each
    gradient to 2^-4 of its tensor's largest magnitude. The conv norms'
    gradients are cancellation residues of sums of dy * x_hat, held there
    to the sums of the terms' magnitudes; here their changes are held to
    2^-4 of the largest change of the conv kernel before them, whose
    gradient sums the same dy against the conv's input. The running
    statistics within atol 2e-4: after two steps they hold 0.19 of the
    batch means and variances of a bf16 stream, where a one-ulp flip of an
    element near 2 (2^-7) moves a mean over the ~30 valid frames by about
    2.6e-4, and a few flips are seen (measured 9.2e-5). Parameters and
    optimizer state stay f32."""
    batch = _batch()
    kw = dict(model="deepspeech_ctc", model_kwargs=dict(MODEL, **TPU_BF16),
              num_classes=C, warmup_steps=1, ctc_impl="pallas",
              optimizer="sgd", lr=1e-2, bf16_compute=True)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state()
    # JAX's state on copies of the port's seeded weights (JAX's own init
    # would compile the model's forward once more; the port's step updates
    # the arrays that ts.variables() views in place).
    v = jax.tree.map(lambda a: jnp.asarray(np.array(a)), ts.variables())
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                     batch_stats=v["batch_stats"],
                     opt_state=jt.optimizer.init(v["params"]))
    init = _flat(v)
    jb = jax.tree.map(jnp.asarray, batch)
    step = JTrainer.train_step.lower(jt, js, jb).compile(
        compiler_options=EXACT_BF16)
    for i in range(2):
        js, mj = step(js, jb)
        ts, mt = tt.train_step(ts, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=2.0 ** -8, err_msg=f"{k} {i}")
    want = _flat({"params": js.params, "batch_stats": js.batch_stats})
    got = _flat(ts.variables())
    assert set(got) == set(want)
    change = {k: np.abs(want[k] - init[k]).max() for k in want}
    for k in want:
        scale = change[k]
        for i in (1, 2):
            if f"['conv{i}_bn']" in k:
                scale = max(scale, change[f"['params']['conv{i}']['kernel']"])
        atol = 2e-4 if "batch_stats" in k else 2.0 ** -4 * scale + 1e-7
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    # Parameters and optimizer state stay f32, as in JAX.
    assert all(p.dtype == torch.float32 for p in ts.model.parameters())


def _wavs():
    rng = np.random.default_rng(3)
    S = 8000
    wav = (rng.standard_normal((2, S)) * 0.3).astype(np.float32)
    lens = np.array([S, 5600], np.int32)
    wav[1, lens[1]:] = 0.0
    return wav, lens


def test_recognizer_serves_bf16_model_on_the_unfused_route():
    """Config 3's bf16 model (pallas_gru, bf16_gru, bf16_conv: xp rounded
    outside the scan, K5-bf16) served by Recognizer: greedy tokens equal to
    the JAX model's on the same features, log-probs within LOGP_TOL (the
    bf16 stream's one-ulp flips, ``torch_bf16_common``)."""
    wav, lens = _wavs()
    feats, flens = JFeaturizer(JFeatureConfig())(wav, lens)
    tm = create_model("deepspeech_ctc", num_classes=C, **MODEL, **TPU_BF16,
                      in_features=64,
                      generator=torch.Generator().manual_seed(4))
    jm = j_create_model("deepspeech_ctc", num_classes=C, **MODEL, **TPU_BF16)
    v = to_jax_variables(tm.state_dict())
    apply = jax.jit(lambda v, f, n: jm.apply(v, f, n, train=False))
    lp_j, ol_j = apply.lower(v, feats, flens).compile(
        compiler_options=EXACT_BF16)(v, feats, flens)
    tok_j, tl_j = j_greedy_decode(lp_j, ol_j)
    out = Recognizer(tm, FeatureConfig(), None, device="cpu")(wav, lens)
    np.testing.assert_array_equal(out["out_lens"].numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(out["log_probs"].numpy(), np.asarray(lp_j),
                               rtol=0, atol=LOGP_TOL)
    for i in range(2):
        n = int(out["token_lens"][i, 0])
        assert n == int(tl_j[i])
        np.testing.assert_array_equal(out["tokens"][i, 0, :n].numpy(),
                                      np.asarray(tok_j)[i, :n])


def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_batch_train_bf16_checkpoint_serves(tmp_path):
    """batch_train with config 3's bf16 model kwargs (no flag JAX's CLI
    lacks) trains; both packages read its checkpoint's model_kwargs; test
    --checkpoint serves it through Recognizer's unfused bf16 route, its
    hypotheses Trainer.evaluate's greedy tokens."""
    root = tmp_path / "corpus"
    train = make_synthetic_corpus(root, num_utts=8, vocab_size=6, seed=1,
                                  max_tokens=4)
    dev = make_synthetic_corpus(root, num_utts=4, vocab_size=6, seed=2,
                                max_tokens=4, split="dev")
    units = str(root / "units.txt")
    log = tmp_path / "run"
    model = dict(rnn_hidden=16, rnn_layers=1, conv_channels=4, dropout=0.0)
    _main(batch_train.main, [
        "deepspeech_ctc", "--train-manifest", str(train.manifest),
        "--units", units, "--n-mels", "32", "--device", "cpu",
        "--num-epochs", "1", "--batch-size", "4", "--max-label-len", "8",
        "--warmup-steps", "1", "--lr", "1e-2", "--log-dir", str(log),
        *[f"--model-kwarg={k}={v}" for k, v in model.items()],
        *[f"--model-kwarg={k}=True" for k in TPU_BF16]])
    tree, meta = restore_checkpoint(log / "ckpt")
    want_kwargs = dict(model, **TPU_BF16)
    assert meta["model_kwargs"] == want_kwargs
    _, jmeta = j_load(log / "ckpt")
    assert jmeta["model_kwargs"] == want_kwargs
    lines = _main(cli_test.main, [
        "deepspeech_ctc", "--manifest", str(dev.manifest), "--units", units,
        "--checkpoint", str(log / "ckpt"), "--device", "cpu",
        "--batch-size", "4"])
    assert lines[-1].startswith("utterances: 4  token-error-rate:")
    hyps = dict(ln.split("\t") for ln in lines[:-1])
    tt = Trainer(TrainConfig(model="deepspeech_ctc", model_kwargs=want_kwargs,
                             num_classes=6), FeatureConfig(n_mels=32),
                 device="cpu")
    state = tt.load_state_tree(tt.init_state(), tree)
    ev = tt.evaluate(state, AudioLoader(dev.manifest, LoaderConfig(
        batch_size=4, max_label_len=8, shuffle=False)))
    names = (root / "units.txt").read_text().splitlines()
    assert hyps == {k: " ".join(names[t] for t in v)
                    for k, v in ev["hyps"].items()}
