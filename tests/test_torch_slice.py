"""The tpuasr_torch decode slice end to end on the CPU.

wav -> FusedFeaturizer -> DeepSpeechCTC (int8 GRU kernel flags) -> beam
search, against the same pipeline in the JAX package (its Pallas kernels
with ``interpret=True``, see test_torch_gru.py), plus the CLI, the no-jax import rule and the no-fallback
rules of the device handling.
"""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import tpuasr_torch
from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode.pallas_beam import ctc_beam_search_pallas
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features.pallas_fused import FusedFeaturizer as JFusedFeaturizer
from tpuasr.models import create_model as j_create_model
from tpuasr_torch import _build
from tpuasr_torch.convert import from_jax_variables, save_npz, to_jax_variables
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.decode import beam as beam_mod
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.features import fused as fused_mod
from tpuasr_torch.models import create_model
from tpuasr_torch.losses import ctc as ctc_mod
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.train import TrainConfig, Trainer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


REPO = Path(__file__).resolve().parents[1]
C = 16
BASE = dict(num_classes=C, rnn_hidden=32, rnn_layers=2, conv_channels=4,
            dropout=0.0)
INT8_ARM = dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                int8_proj=True, int8_rec=True)


def _wavs(seed):
    rng = np.random.default_rng(seed)
    S = 8000
    wav = (rng.standard_normal((2, S)) * 0.1).astype(np.float32)
    lens = np.array([S, 4800], np.int32)
    wav[1, lens[1]:] = 0.0
    return wav, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_matches_jax_pipeline(seed):
    wav, lens = _wavs(seed)
    fz = JFusedFeaturizer(JFeatureConfig())
    feats, flens = fz(wav, lens)
    jm = j_create_model("deepspeech_ctc", **BASE, **INT8_ARM)
    variables = jm.init(jax.random.PRNGKey(seed), feats, flens, train=False)
    lp_j, ol_j = jm.apply(variables, feats, flens, train=False)
    cfg = dict(beam_width=8, max_len=64)
    out_j = ctc_beam_search_pallas(lp_j, ol_j, JBeamSearchConfig(**cfg))

    tm = create_model("deepspeech_ctc", **BASE, **INT8_ARM, in_features=64)
    tm.load_state_dict(from_jax_variables(jax.tree.map(np.asarray,
                                                       variables)))
    rec = Recognizer(tm, FeatureConfig(), BeamSearchConfig(**cfg), "cpu")
    out_t = rec(wav, lens)

    np.testing.assert_array_equal(out_t["feat_lens"].numpy(),
                                  np.asarray(flens))
    np.testing.assert_array_equal(out_t["out_lens"].numpy(),
                                  np.asarray(ol_j))
    # bf16 stream + int8 GRU: same bound as test_torch_model's bf16 modes.
    np.testing.assert_allclose(out_t["log_probs"].numpy(), np.asarray(lp_j),
                               rtol=0, atol=2e-3)
    np.testing.assert_array_equal(out_t["token_lens"].numpy(),
                                  np.asarray(out_j["token_lens"]))
    np.testing.assert_array_equal(out_t["tokens"].numpy(),
                                  np.asarray(out_j["tokens"]))


def _write_weights(path, num_classes=8):
    model = create_model("deepspeech_ctc", num_classes=num_classes,
                         rnn_hidden=16, rnn_layers=1, conv_channels=2,
                         generator=torch.Generator().manual_seed(0))
    meta = dict(model="deepspeech_ctc", num_classes=num_classes,
                model_kwargs=dict(rnn_hidden=16, rnn_layers=1,
                                  conv_channels=2))
    save_npz(to_jax_variables(model.state_dict()), path, meta=meta)


def test_cli_predict_prints_one_transcript_per_wav(tmp_path):
    _write_weights(tmp_path / "w.npz")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((8000, 5200)):
        p = tmp_path / f"utt{i}.wav"
        wavfile.write(p, 8000, (rng.standard_normal(n) * 3000)
                      .astype(np.int16))
        paths.append(str(p))
    (tmp_path / "units.txt").write_text(
        "\n".join(["<blank>"] + [f"u{i}" for i in range(1, 8)]))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for extra in ([], ["--beam", "--beam-width", "4", "--int8"]):
        res = subprocess.run(
            [sys.executable, "-m", "tpuasr_torch.cli.predict",
             "deepspeech_ctc", *paths, "--weights", str(tmp_path / "w.npz"),
             "--units", str(tmp_path / "units.txt"), "--device", "cpu",
             *extra], capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=120)
        assert res.returncode == 0, res.stderr
        lines = res.stdout.strip().splitlines()
        assert len(lines) == 2
        for line, p in zip(lines, paths):
            path, text = line.split("\t")
            assert path == p
            assert all(tok.startswith("u") for tok in text.split())


def test_package_never_imports_jax():
    mods = [m.name for m in pkgutil.walk_packages(tpuasr_torch.__path__,
                                                  "tpuasr_torch.")]
    assert "tpuasr_torch.csrc" not in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'msgpack', 'tpuasr') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print(len(" + repr(mods) + "))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ,
                                             PYTHONPATH=str(REPO)),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_package_imports_without_the_jax_package(tmp_path):
    """Every module of tpuasr_torch imports from a copy of the package
    alone, with no tpuasr/ beside it: the port loads nothing of the JAX
    package, by name or by path."""
    shutil.copytree(REPO / "tpuasr_torch", tmp_path / "tpuasr_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import importlib, importlib.util, pkgutil, sys\n"
            "assert importlib.util.find_spec('tpuasr') is None\n"
            "import tpuasr_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "tpuasr_torch.__path__, 'tpuasr_torch.')]\n"
            "assert {'tpuasr_torch.models.capsnet', "
            "'tpuasr_torch.ops.routing', 'tpuasr_torch.models.resnet_ctc', "
            "'tpuasr_torch.data.loader', 'tpuasr_torch.cli.test', "
            "'tpuasr_torch.utils.metrics', 'tpuasr_torch.utils.device', "
            "'tpuasr_torch.data.synthetic', 'tpuasr_torch.utils.msgpack', "
            "'tpuasr_torch.train.checkpoints', "
            "'tpuasr_torch.features.augment', "
            "'tpuasr_torch.utils.logger', 'tpuasr_torch.data.device_corpus', "
            "'tpuasr_torch.data.native_wav', 'tpuasr_torch.cli.batch_train', "
            "'tpuasr_torch.serve.streaming', 'tpuasr_torch.cli.stream', "
            "'tpuasr_torch.losses.align', 'tpuasr_torch.native.build', "
            "'tpuasr_torch.native.ctc_host', 'tpuasr_torch.native.wav_batch', "
            "'tpuasr_torch.decode.fst_decode', "
            "'tpuasr_torch.decode.confidence', 'tpuasr_torch.utils.kaldi_io', "
            "'tpuasr_torch.cli.lmtool'} "
            "<= set(mods), mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'msgpack', 'tpuasr')]\n"
            "assert not bad, bad\n"
            "print(len(mods), tpuasr_torch.__file__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    n, path = res.stdout.split()
    assert int(n) >= 20 and path.startswith(str(tmp_path))


def test_cuda_recognizer_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is for hosts without it")
    model = create_model("deepspeech_ctc", **BASE, in_features=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recognizer(model, FeatureConfig(), BeamSearchConfig(), "cuda")


@pytest.mark.parametrize("cls", ["Featurizer", "FusedFeaturizer"])
def test_featurizer_defaults_to_the_card(cls):
    """A featurizer made with no device runs on the card; where CUDA is
    absent that is a RuntimeError, never a quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is for hosts without it")
    import tpuasr_torch.features as features
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(features, cls)(FeatureConfig())


def test_cpu_wrappers_never_build_or_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a kernel build was attempted on the CPU")

    monkeypatch.setattr(_build, "find_nvcc", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "lib", no_build)
    monkeypatch.setattr(subprocess, "run", no_build)
    wrappers = (fused_mod.fbank_power, gru_mod.gru_scan_xfused,
                gru_mod.gru_scan_xfused_q8, beam_mod.beam_scan,
                gru_mod.gru_scan_fwd, gru_mod.gru_scan_bwd,
                ctc_mod.ctc_forward, ctc_mod.ctc_backward)
    before = [w.launches for w in wrappers]
    gen = torch.Generator().manual_seed(0)
    for flags in (INT8_ARM, dict(pallas_gru=True, bf16_gru=True,
                                 fused_proj=True)):
        model = create_model("deepspeech_ctc", **BASE, **flags,
                             in_features=64, generator=gen)
        rec = Recognizer(model, FeatureConfig(),
                         BeamSearchConfig(beam_width=4, max_len=32), "cpu")
        out = rec(*_wavs(3))
        assert bool(torch.isfinite(out["log_probs"]).all())
    wav, lens = _wavs(4)
    batch = dict(wav=wav, wav_lens=lens, tokens=np.array([[1, 2], [3, 0]]),
                 token_lens=np.array([2, 1]), real=np.ones(2))
    for fused in (False, True):      # K5/K5b, or K2 with K5b
        kw = dict(BASE, pallas_gru=True, fused_proj=fused)
        del kw["num_classes"]
        trainer = Trainer(TrainConfig(model_kwargs=kw, num_classes=C,
                                      warmup_steps=1), FeatureConfig(),
                          device="cpu")
        state, m = trainer.train_step(trainer.init_state(), batch)
        assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    assert [w.launches for w in wrappers] == before
    assert _build._lib is None


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for script in (REPO / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, cwd=tmp_path,
                             timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
