"""The port's training loop against the JAX package's (CPU): ``Trainer.fit``,
the device-resident corpus, the native wav reader and
``python -m tpuasr_torch.cli.batch_train``.

Fit against fit: JAX's ``Trainer.fit`` trains one epoch (nesterov sgd,
prefetch 0, no dither, no SpecAugment) and writes its checkpoint; JAX and
the port each resume it for a second epoch: the parameters agree within
the sgd bound of ``test_train_step_matches_jax`` (atol 1e-5), the losses
in ``metrics.csv`` within rtol 1e-4, its row names and steps exactly.
Then, inside the port: resume bit for bit, prefetch 0 and 2 bit for bit,
device-resident batches bit for bit the streaming loader's, the native
reader bit for bit scipy's, and the CLI end to end.
"""

import contextlib
import csv
import io

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path
from scipy.io import wavfile

from tpuasr.data import AudioLoader as JAudioLoader
from tpuasr.data import LoaderConfig as JLoaderConfig
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.parallel import make_mesh
from tpuasr.train import TrainConfig as JTrainConfig
from tpuasr.train import Trainer as JTrainer
from tpuasr_torch.cli import batch_train
from tpuasr_torch.cli import test as cli_test
from tpuasr_torch.data import (AudioLoader, LoaderConfig, load_wav,
                               make_synthetic_corpus)
from tpuasr_torch.data import native_wav
from tpuasr_torch.data.device_corpus import DeviceCorpus, try_build
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.train import TrainConfig, Trainer
from tpuasr_torch.train.checkpoints import (latest_checkpoint,
                                            restore_checkpoint)

pytest_plugins = ["jax_cache_isolation"]

C = 6
MODEL = dict(rnn_hidden=16, rnn_layers=1, conv_channels=4, dropout=0.0)
N_MELS = 32
LOADER = dict(batch_size=4, max_label_len=8, max_buckets=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train = make_synthetic_corpus(root, num_utts=14, vocab_size=C, seed=1,
                                  max_tokens=4)
    dev = make_synthetic_corpus(root, num_utts=5, vocab_size=C, seed=2,
                                max_tokens=4, split="dev")
    return train, dev


def _cfg(**kw):
    return dict(dict(model="deepspeech_ctc", model_kwargs=MODEL,
                     num_classes=C, optimizer="sgd", lr=1e-2,
                     warmup_steps=2, log_every=1, prefetch=0), **kw)


def _flat(tree):
    return {keystr(p): np.asarray(v)
            for p, v in tree_flatten_with_path(tree)[0]}


def _rows(path):
    with open(path) as f:
        return [(int(s), n, float(v)) for s, n, v in list(csv.reader(f))[1:]]


def test_fit_against_jax_fit(corpus, tmp_path):
    """JAX trains epoch 0 and saves; JAX and the port each resume it for
    epoch 1, with the dev set evaluated after it."""
    train, dev = corpus
    jt = JTrainer(JTrainConfig(**_cfg(num_epochs=1,
                                      ckpt_dir=str(tmp_path / "j1"))),
                  JFeatureConfig(n_mels=N_MELS),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    jt.fit(JAudioLoader(train.manifest, JLoaderConfig(**LOADER)))
    assert latest_checkpoint(tmp_path / "j1").name == "ckpt_00000004.msgpack"
    # The same JAX Trainer resumes (its compiled step is reused).
    jt.cfg.num_epochs, jt.cfg.continue_from = 2, str(tmp_path / "j1")
    jt.cfg.ckpt_dir = str(tmp_path / "j2")
    js = jt.fit(JAudioLoader(train.manifest, JLoaderConfig(**LOADER)),
                JAudioLoader(dev.manifest,
                             JLoaderConfig(**LOADER, shuffle=False)),
                metrics_dir=str(tmp_path / "jm"))
    tt = Trainer(TrainConfig(**_cfg(num_epochs=2,
                                    continue_from=str(tmp_path / "j1"),
                                    ckpt_dir=str(tmp_path / "p2"))),
                 FeatureConfig(n_mels=N_MELS), device="cpu")
    ts = tt.fit(AudioLoader(train.manifest, LoaderConfig(**LOADER)),
                AudioLoader(dev.manifest, LoaderConfig(**LOADER,
                                                       shuffle=False)),
                metrics_dir=str(tmp_path / "pm"))
    assert ts.step == int(js.step) == 8
    want = _flat({"params": js.params, "batch_stats": js.batch_stats})
    got = _flat(ts.variables())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    jrows, prows = _rows(tmp_path / "jm" / "metrics.csv"), _rows(
        tmp_path / "pm" / "metrics.csv")
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert [r[:2] for r in prows] == ([(s, "train/loss") for s in range(5, 9)]
                                      + [(8, "dev/loss"), (8, "dev/ter")])
    for (_, name, p), (_, _, j) in zip(prows, jrows):
        if name.endswith("loss"):
            np.testing.assert_allclose(p, j, rtol=1e-4, err_msg=name)
        else:
            assert p == j
    names = sorted(p.name for p in (tmp_path / "p2").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j2").iterdir())


def _port_fit(train, tmp_path, name, **kw):
    cfg = TrainConfig(**_cfg(**dict(dict(optimizer="adamw", accum_steps=2,
                                         spec_augment=True, num_epochs=2,
                                         ckpt_dir=str(tmp_path / name)),
                                    **kw)))
    tt = Trainer(cfg, FeatureConfig(n_mels=N_MELS, dither=0.5),
                 device="cpu")
    return tt.fit(AudioLoader(train.manifest, LoaderConfig(**LOADER)))


def _same_bits(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_resume_is_bit_for_bit(corpus, tmp_path):
    """adamw in MultiSteps, SpecAugment and dither: 2 epochs straight
    against 1 epoch, then resumed from its final checkpoint (epoch 1) for
    the second: the same bits. A checkpoint from inside an epoch restarts
    that epoch from its first batch while the step count goes on, as in
    JAX."""
    train, _ = corpus
    straight = _port_fit(train, tmp_path, "a", ckpt_every_steps=2)
    _port_fit(train, tmp_path, "b", num_epochs=1)
    resumed = _port_fit(train, tmp_path, "c",
                        continue_from=str(tmp_path / "b"))
    assert straight.step == resumed.step == 8
    assert _same_bits(straight, resumed)
    for a, b in zip(straight.opt_state.mu + straight.opt_state.acc,
                    resumed.opt_state.mu + resumed.opt_state.acc):
        assert torch.equal(a, b)
    mid = _port_fit(train, tmp_path, "d", num_epochs=1, ckpt_every_steps=2,
                    continue_from=str(tmp_path / "a" / "ckpt_00000002"
                                      ".msgpack"))
    assert mid.step == 6
    assert latest_checkpoint(tmp_path / "d").name == "ckpt_00000006.msgpack"


def test_prefetch_and_device_corpus_give_the_same_bits(corpus, tmp_path):
    train, _ = corpus
    runs = [_port_fit(train, tmp_path, f"r{i}", prefetch=p, device_corpus=dc)
            for i, (p, dc) in enumerate([(0, False), (2, False),
                                         (2, "auto")])]
    assert _same_bits(runs[0], runs[1]) and _same_bits(runs[0], runs[2])


@pytest.mark.parametrize("how", ["closed", "step raises"])
def test_prefetch_thread_stops_with_the_loop(corpus, tmp_path, monkeypatch,
                                             how):
    """A loop that leaves an epoch early (its generator closed, or a step
    that raises inside fit) stops the prefetch thread, which would
    otherwise block on a full queue."""
    import threading

    def alive():
        return [t for t in threading.enumerate()
                if t.name == "tpuasr_torch-prefetch" and t.is_alive()]

    train, _ = corpus
    cfg = TrainConfig(**_cfg(prefetch=1, device_corpus=False,
                             ckpt_dir=str(tmp_path)))
    tt = Trainer(cfg, FeatureConfig(n_mels=N_MELS), device="cpu")
    loader = AudioLoader(train.manifest, LoaderConfig(**LOADER))
    assert len(loader.batch_plan(0)) >= 3
    if how == "closed":
        batches = tt._epoch_batches(loader, 0)
        next(batches)
        assert alive()
        batches.close()
    else:
        def fail(state, batch):
            raise RuntimeError("step failed")
        monkeypatch.setattr(tt, "train_step", fail)
        with pytest.raises(RuntimeError, match="step failed"):
            tt.fit(loader)
    assert not alive()


def test_device_corpus_batches_are_the_loaders(corpus):
    train, _ = corpus
    cfg = LoaderConfig(batch_size=4, max_label_len=8, max_buckets=3)
    stream = AudioLoader(train.manifest, cfg)
    dc = DeviceCorpus(AudioLoader(train.manifest, cfg), device="cpu")
    assert len(dc._stores) == len(stream.buckets.boundaries) >= 2
    for epoch in (0, 1):
        got = list(dc.batches(epoch))
        plan = stream.batch_plan(epoch)
        assert len(got) == len(plan)
        for (n_real, db), chunk in zip(got, plan):
            ref = stream.make_batch(chunk)
            assert n_real == int(ref["real"].sum())
            assert set(db) == {"wav", "wav_lens", "tokens", "token_lens",
                               "real"}
            for k in db:
                want = torch.from_numpy(ref[k])
                assert db[k].dtype == want.dtype and torch.equal(db[k], want)
    assert any(not bool(db["real"].all()) for _, db in dc.batches(0))


def test_try_build_falls_back(corpus):
    import dataclasses

    train, _ = corpus
    loader = AudioLoader(train.manifest, LoaderConfig(**LOADER))
    assert try_build(loader, "cpu", max_bytes=64) is None
    with pytest.raises(ValueError, match="budget"):
        DeviceCorpus(loader, "cpu", max_bytes=64)
    # With augment (host random draws per batch) the corpus raises as
    # JAX's does and try_build streams (tests/test_torch_corpus.py).
    loader.cfg = dataclasses.replace(loader.cfg, augment=True)
    assert try_build(loader, "cpu") is None
    with pytest.raises(ValueError, match="augment"):
        DeviceCorpus(loader, "cpu")


@pytest.mark.parametrize("fmt", ["pcm16", "pcm32", "float32", "pcm8",
                                 "stereo"])
def test_native_reader_matches_scipy(tmp_path, fmt):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, size=777).astype(np.float32)
    data = {"pcm16": (x * 32767).astype(np.int16),
            "pcm32": (x * 2147483647).astype(np.int32),
            "float32": x, "pcm8": ((x * 127) + 128).astype(np.uint8),
            "stereo": (np.stack([x, x[::-1]], 1) * 32767).astype(np.int16)
            }[fmt]
    path = tmp_path / f"{fmt}.wav"
    wavfile.write(path, 8000, data)
    ref, sr = load_wav(str(path))
    out, lens, srs = native_wav.load_wav_batch([str(path)] * 3, 1000,
                                               num_threads=3)
    assert (srs == sr).all() and (lens == len(ref)).all()
    for j in range(3):
        np.testing.assert_array_equal(out[j, :lens[j]], ref)
        assert not out[j, lens[j]:].any()


def test_loader_native_and_scipy_agree(corpus):
    train, _ = corpus
    a = AudioLoader(train.manifest, LoaderConfig(**LOADER, native_io=True))
    b = AudioLoader(train.manifest, LoaderConfig(**LOADER, native_io=False))
    for chunk in a.batch_plan(0):
        x, y = a.make_batch(chunk), b.make_batch(chunk)
        np.testing.assert_array_equal(x["wav"], y["wav"])
        np.testing.assert_array_equal(x["wav_lens"], y["wav_lens"])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wav_batch.cc"
    bad.write_text(native_wav.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        native_wav.build(bad, tmp_path / "out")
    assert "error" in str(e.value)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="not found"):
        native_wav.build(native_wav.SOURCE, tmp_path / "out")
    with pytest.raises(RuntimeError, match="wav decode failed"):
        native_wav.load_wav_batch([str(tmp_path / "missing.wav")] * 2, 10)


def _main(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_batch_train_and_test_checkpoint_end_to_end(corpus, tmp_path):
    """batch_train trains (SpecAugment, accumulation, the device corpus)
    and writes its checkpoints and metrics; test --checkpoint serves the
    directory: its hypotheses are Trainer.evaluate's greedy tokens."""
    train, dev = corpus
    units = str(train.root / "units.txt")
    log = tmp_path / "run"
    _main(batch_train.main, [
        "deepspeech_ctc", "--train-manifest", str(train.manifest),
        "--dev-manifest", str(dev.manifest), "--units", units,
        "--n-mels", str(N_MELS), "--device", "cpu", "--num-epochs", "2",
        "--batch-size", "4", "--max-label-len", "8", "--log-every", "1",
        "--ckpt-every-steps", "3", "--spec-augment", "--accum-steps", "2",
        "--warmup-steps", "2", "--lr", "1e-2", "--log-dir", str(log),
        *[f"--model-kwarg={k}={v}" for k, v in MODEL.items()]])
    ck = sorted(p.name for p in (log / "ckpt").glob("*.msgpack"))
    steps = len(AudioLoader(train.manifest, LoaderConfig(
        batch_size=4, max_label_len=8)).batch_plan(0))
    assert ck[-1] == f"ckpt_{2 * steps:08d}.msgpack"
    rows = _rows(log / "metrics.csv")
    assert [r[1] for r in rows].count("train/loss") == 2 * steps
    assert [r[1] for r in rows].count("dev/ter") == 2
    lines = _main(cli_test.main, [
        "deepspeech_ctc", "--manifest", str(dev.manifest), "--units", units,
        "--checkpoint", str(log / "ckpt"), "--device", "cpu",
        "--batch-size", "4"])
    assert lines[-1].startswith("utterances: 5  token-error-rate:")
    hyps = dict(ln.split("\t") for ln in lines[:-1])
    tt = Trainer(TrainConfig(model="deepspeech_ctc", model_kwargs=MODEL,
                             num_classes=C, accum_steps=2),
                 FeatureConfig(n_mels=N_MELS), device="cpu")
    tree, _ = restore_checkpoint(log / "ckpt")
    state = tt.load_state_tree(tt.init_state(), tree)
    ev = tt.evaluate(state, AudioLoader(dev.manifest, LoaderConfig(
        batch_size=4, max_label_len=8, shuffle=False)))
    unit_names = (train.root / "units.txt").read_text().splitlines()
    assert hyps == {k: " ".join(unit_names[t] for t in v)
                    for k, v in ev["hyps"].items()}
    assert lines[-1] == (f"utterances: 5  token-error-rate: "
                         f"{ev['ter']:.4f}")


@pytest.mark.parametrize("flag,item", [
    (["--objective", "framewise_ce"], "item 12"),
    (["--objective", "ssvae_elbo"], "item 12"),
    (["--use-grain"], "item 5")])
def test_batch_train_refuses_unported_flags(corpus, flag, item):
    train, _ = corpus
    with pytest.raises(SystemExit, match=item):
        batch_train.main(["deepspeech_ctc", "--train-manifest",
                          str(train.manifest), "--num-classes", str(C),
                          "--device", "cpu", *flag])


def test_no_cuda_no_quiet_cpu(corpus, tmp_path):
    """With no CUDA device, Trainer, batch_train and DeviceCorpus raise
    unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is for hosts without it")
    train, _ = corpus
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainConfig(), FeatureConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_train.main(["deepspeech_ctc", "--train-manifest",
                          str(train.manifest), "--num-classes", str(C),
                          "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceCorpus(AudioLoader(train.manifest, LoaderConfig(**LOADER)))
