"""Checkpoints both ways between tpuasr_torch and the JAX package (CPU).

The port writes JAX's checkpoint format: flax's ``to_bytes`` of JAX's
``TrainState`` (step, params, batch_stats, and opt_state in optax's
layout), through its own msgpack codec. Held here: the synthetic corpus
byte for byte against JAX's; the codec byte for byte against flax on JAX
train states (adamw, adam, sgd, and adamw in ``MultiSteps``) and in round
trips; a port checkpoint read by JAX's ``load_for_inference``,
``restore_checkpoint`` and ``eval_step``; a JAX checkpoint read by the port
(every optimizer leaf, count and the step bit for bit) and by its
``predict`` and ``test`` CLIs beside JAX's.
"""

import contextlib
import functools
import io
import json

import flax.serialization as fser
import jax
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from tpuasr.data.synthetic import make_synthetic_corpus as j_make_corpus
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr.train import checkpoints as jckpt
from tpuasr_torch.data import make_synthetic_corpus
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.train import TrainConfig, Trainer
from tpuasr_torch.train import checkpoints as ckpt
from tpuasr_torch.utils import msgpack as mp

pytest_plugins = ["jax_cache_isolation"]

C = 6
MODEL = dict(rnn_hidden=16, rnn_layers=1, conv_channels=4, dropout=0.0)
N_MELS = 32
OPTIMIZERS = [("adamw", 1), ("adam", 1), ("sgd", 1), ("adamw", 2)]


def _batch(seed=0):
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


def _cfg_kw(optimizer="adamw", accum=1):
    return dict(model="deepspeech_ctc", model_kwargs=MODEL, num_classes=C,
                warmup_steps=1, optimizer=optimizer, accum_steps=accum,
                lr=1e-2)


@functools.lru_cache(maxsize=None)
def _jax(steps, optimizer="adamw", accum=1):
    """(JAX Trainer, its state after ``steps`` steps on ``_batch()``,
    the batch); cached: a JAX train step compiles for seconds."""
    jt = JTrainer(JTrainConfig(**_cfg_kw(optimizer, accum)),
                  JFeatureConfig(n_mels=N_MELS),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    batch = _batch()
    js = jt.init_state(batch)
    for _ in range(steps):
        js, _ = jt.train_step(js, batch)
    return jt, jax.device_get(js), batch


def _port(optimizer="adamw", accum=1):
    return Trainer(TrainConfig(**_cfg_kw(optimizer, accum)),
                   FeatureConfig(n_mels=N_MELS), device="cpu")


def _flat(tree):
    return {keystr(p): np.asarray(v)
            for p, v in tree_flatten_with_path(tree)[0]}


def _assert_same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("markov", [0.0, 0.7])
def test_synthetic_corpus_matches_jax(tmp_path, markov):
    kw = dict(num_utts=5, vocab_size=7, seed=3, split="dev", markov=markov)
    a = make_synthetic_corpus(tmp_path / "port", **kw)
    b = j_make_corpus(tmp_path / "jax", **kw)
    assert a.vocab == b.vocab and a.sample_rate == b.sample_rate
    la = a.manifest.read_text().replace(str(tmp_path / "port"), "R")
    lb = b.manifest.read_text().replace(str(tmp_path / "jax"), "R")
    assert la == lb and len(la.splitlines()) == 5
    for line in la.splitlines():
        wav = json.loads(line)["wav"]
        assert ((tmp_path / "port" / wav[2:]).read_bytes()
                == (tmp_path / "jax" / wav[2:]).read_bytes())
    assert ((tmp_path / "port" / "units.txt").read_text()
            == (tmp_path / "jax" / "units.txt").read_text())


@pytest.mark.parametrize("optimizer,accum", OPTIMIZERS)
def test_codec_writes_flax_bytes_of_a_jax_train_state(optimizer, accum):
    """JAX's TrainState after 3 steps, carried into the port
    (``load_state_tree``) and written back (``state_tree``, ``packb``):
    the bytes are flax's ``to_bytes``; ``unpackb`` reads flax's bytes as
    ``msgpack_restore`` does."""
    _, js, _ = _jax(3, optimizer, accum)
    ref = fser.to_bytes(js)
    tt = _port(optimizer, accum)
    ts = tt.load_state_tree(tt.init_state(), fser.to_state_dict(js))
    assert ts.step == 3
    assert mp.packb(tt.state_tree(ts)) == ref
    _assert_same_leaves(mp.unpackb(ref), fser.msgpack_restore(ref))


def test_codec_round_trips_every_type():
    rng = np.random.default_rng(0)
    tree = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "empty": np.zeros((0, 2), np.float64), "i8": np.int8(-3),
            "scalar": np.zeros((), np.int32),
            "u16": np.arange(17, dtype=np.uint16),
            "big": rng.standard_normal((300, 300)).astype(np.float32),
            "nested": {"x" * 40: None, "t": True, "f": False, "s": "é" * 40,
                       "ints": [0, 127, 128, 255, 256, 65536, 2 ** 33, -1,
                                -32, -33, -129, -40000, -2 ** 40],
                       "float": 1.25, "bin": b"\x00" * 300},
            "wide": {str(i): i for i in range(20)},
            "long": list(range(20))}
    data = mp.packb(tree)
    assert data == fser.msgpack_serialize(tree, in_place=True)
    back = mp.unpackb(data)
    assert list(back) == list(tree)
    ref = fser.msgpack_restore(data)
    for k in ("f32", "empty", "scalar", "u16", "big"):
        np.testing.assert_array_equal(back[k], tree[k])
        assert back[k].dtype == tree[k].dtype
    assert back["i8"] == tree["i8"] and type(back["i8"]) is type(ref["i8"])
    assert back["nested"] == ref["nested"] == dict(
        tree["nested"], ints=tree["nested"]["ints"])
    assert back["wide"] == tree["wide"] and back["long"] == tree["long"]


def test_codec_refuses_chunked_leaves(monkeypatch):
    chunked = fser.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
               "chunks": {"0": np.zeros(2, np.float32)}}}, in_place=True)
    with pytest.raises(ValueError, match="chunked"):
        mp.unpackb(chunked)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        mp.packb({"w": np.zeros(5, np.float32)})


@pytest.mark.parametrize("optimizer,accum", [("adamw", 2), ("sgd", 1)])
def test_port_checkpoint_read_by_jax(tmp_path, optimizer, accum):
    """A port run of 3 steps, saved: JAX's load_for_inference gives its
    weights exactly, JAX's restore_checkpoint accepts it against JAX's
    template, and JAX's eval_step on it gives the port's greedy tokens."""
    batch = _batch()
    tt = _port(optimizer, accum)
    ts = tt.init_state()
    for _ in range(3):
        ts, _ = tt.train_step(ts, batch)
    path = ckpt.save_checkpoint(tmp_path, tt.state_tree(ts), ts.step,
                                meta=tt.ckpt_meta(0))
    assert path.name == "ckpt_00000003.msgpack"
    variables, meta = jckpt.load_for_inference(tmp_path)
    assert meta == json.loads(json.dumps(tt.ckpt_meta(0)))
    _assert_same_leaves(jax.device_get(variables), ts.variables())

    jt, template, _ = _jax(3, optimizer, accum)
    restored, meta = jckpt.restore_checkpoint(path, template)
    assert int(restored.step) == 3 and meta["epoch"] == 0
    _assert_same_leaves(fser.to_state_dict(restored), tt.state_tree(ts))
    ej = jt.eval_step(restored, batch)
    et = tt.eval_step(ts, batch)
    lens = np.asarray(ej["token_lens"])
    np.testing.assert_array_equal(et["token_lens"].numpy(), lens)
    for j, n in enumerate(lens):
        np.testing.assert_array_equal(et["tokens"][j, :n].numpy(),
                                      np.asarray(ej["tokens"])[j, :n])


@pytest.mark.parametrize("optimizer,accum", OPTIMIZERS)
def test_jax_checkpoint_read_by_port(tmp_path, optimizer, accum):
    """A JAX run of 3 steps, saved by JAX: the port's restore carries mu,
    nu (or the trace), the counts, the accumulator and the step across bit
    for bit; an optimizer of another layout refuses it."""
    jt, js, _ = _jax(3, optimizer, accum)
    jckpt.save_checkpoint(tmp_path, js, 3, meta=jt.ckpt_meta(1))
    tt = _port(optimizer, accum)
    fresh = tt.init_state()
    tree, meta = ckpt.restore_checkpoint(tmp_path, tt.state_tree(fresh))
    ts = tt.load_state_tree(fresh, tree)
    assert ts.step == 3 and meta["epoch"] == 1
    _assert_same_leaves(tt.state_tree(ts), fser.to_state_dict(js))
    other = _port("sgd" if optimizer != "sgd" else "adam", accum)
    with pytest.raises(ValueError):
        other.load_state_tree(other.init_state(), tree)
    wrong_accum = _port(optimizer, 3 - accum)
    with pytest.raises(ValueError):
        wrong_accum.load_state_tree(wrong_accum.init_state(), tree)


def test_checkpoint_files_and_pruning(tmp_path):
    tt = _port()
    ts = tt.init_state()
    for step in (5, 10, 15):
        ckpt.save_checkpoint(tmp_path, tt.state_tree(ts), step, keep=2,
                             meta={"epoch": step})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_00000010.json", "ckpt_00000010.msgpack",
                     "ckpt_00000015.json", "ckpt_00000015.msgpack"]
    assert ckpt.latest_checkpoint(tmp_path).name == "ckpt_00000015.msgpack"
    assert ckpt.checkpoint_step(ckpt.latest_checkpoint(tmp_path)) == 15
    assert jckpt.latest_checkpoint(tmp_path) == ckpt.latest_checkpoint(
        tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_for_inference(tmp_path / "none")
    with pytest.raises(ValueError, match="lacks keys"):
        ckpt.restore_checkpoint(tmp_path, {"absent": {}})


def _cli_lines(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if ln and not ln.startswith("#")]


def test_predict_and_test_read_a_jax_checkpoint(tmp_path):
    """JAX's checkpoint directory served by the port's predict and test
    (its meta gives the model, classes and features) beside JAX's own
    predict and test on the same files: the same lines."""
    from tpuasr.cli import predict as jpredict
    from tpuasr.cli import test as jtest
    from tpuasr_torch.cli import predict, test

    corpus = make_synthetic_corpus(tmp_path / "c", num_utts=4, vocab_size=C,
                                   seed=5)
    jt, js, _ = _jax(3)
    jckpt.save_checkpoint(tmp_path / "ck", js, 3, meta=jt.ckpt_meta(0))
    units = str(corpus.root / "units.txt")
    wavs = sorted(str(p) for p in (corpus.root / "wav").glob("*.wav"))
    args = ["deepspeech_ctc", *wavs, "--units", units, "--checkpoint",
            str(tmp_path / "ck")]
    port = _cli_lines(predict.main, [*args, "--device", "cpu"])
    assert len(port) == 4
    assert port == _cli_lines(jpredict.main, args)
    args = ["deepspeech_ctc", "--manifest", str(corpus.manifest), "--units",
            units, "--checkpoint", str(tmp_path / "ck" / "ckpt_00000003"
                                       ".msgpack")]
    port = _cli_lines(test.main, [*args, "--device", "cpu"])
    # The port also prints one line an utterance; the summary is JAX's.
    assert port[-1] == _cli_lines(jtest.main, args)[-1]
    assert port[-1].startswith("utterances: 4  token-error-rate:")


@pytest.mark.parametrize("model,kwargs", [
    ("deepspeech_ctc", dict(MODEL, fused_bidir=True)),
    ("capsule1", dict(conv_channels=8, primary_caps=4, primary_dim=4,
                      class_dim=4)),
    ("resnet_ctc", dict(stem_channels=4, stage_channels=(4, 8),
                        blocks_per_stage=1))])
def test_every_model_round_trips(tmp_path, model, kwargs):
    """A state of each trainable model, saved and restored by the port
    (CapsNet's 0-d logit_scale, the fused BiGRU's layout, ResNet's nested
    blocks): the same tree, bit for bit, and the same step."""
    tt = Trainer(TrainConfig(model=model, model_kwargs=kwargs, num_classes=C,
                             warmup_steps=1, accum_steps=2),
                 FeatureConfig(n_mels=N_MELS), device="cpu")
    ts = tt.init_state()
    for _ in range(3):
        ts, _ = tt.train_step(ts, _batch())
    ckpt.save_checkpoint(tmp_path, tt.state_tree(ts), ts.step)
    fresh = tt.init_state()
    tree, meta = ckpt.restore_checkpoint(tmp_path, tt.state_tree(fresh))
    back = tt.load_state_tree(fresh, tree)
    assert meta == {} and back.step == 3
    _assert_same_leaves(tt.state_tree(back), tt.state_tree(ts))
