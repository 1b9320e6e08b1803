"""tpuasr_torch featurizers against the JAX featurizers (CPU).

The port's FusedFeaturizer runs its kernel's plain version on CPU tensors;
the JAX FusedFeaturizer runs its Pallas kernels with ``interpret=True``,
which the JAX package selects itself off a TPU. Tolerance 1e-3 is the JAX
fused-vs-reference parity bound (tests/test_features_pallas.py:36).
"""

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.features import functional as jfunctional
from tpuasr.features.pallas_fused import FusedFeaturizer as JFusedFeaturizer
from tpuasr_torch.features import (FeatureConfig, Featurizer,
                                   FusedFeaturizer)
from tpuasr_torch.features import functional as tfunctional

GOLDEN = Path(__file__).parent / "data" / "golden"


def _both(cfg_kwargs, wav, lens, fused):
    jcls, tcls = ((JFusedFeaturizer, FusedFeaturizer) if fused
                  else (JFeaturizer, Featurizer))
    fj, lj = jcls(JFeatureConfig(**cfg_kwargs))(wav, lens)
    ft, lt = tcls(FeatureConfig(**cfg_kwargs), device="cpu")(wav, lens)
    return (np.asarray(fj), np.asarray(lj)), (ft.numpy(), lt.numpy())


def test_constants_loaded_by_path_are_identical():
    """The port keeps its own copy of the numpy functions (it loads nothing
    of tpuasr/), and every constant they make is byte-equal to the JAX
    module's: same dtype, same bits."""
    assert (inspect.getsourcefile(tfunctional.mel_filterbank)
            != inspect.getsourcefile(jfunctional.mel_filterbank))
    assert "tpuasr_torch" in inspect.getsourcefile(tfunctional.dct_matrix)

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    for n in (1, 2, 3, 7, 200, 256, 400, 513):
        assert tfunctional.next_pow2(n) == jfunctional.next_pow2(n)
    for name in ("hann", "hamming", "blackman", "rect", "povey"):
        for win, periodic in ((200, True), (400, False), (1, True)):
            same(tfunctional.window_vector(name, win, periodic),
                 jfunctional.window_vector(name, win, periodic))
    for n_fft, win in ((256, 200), (512, 400), (512, None)):
        for a, b in zip(tfunctional.rdft_matrices(n_fft, win),
                        jfunctional.rdft_matrices(n_fft, win)):
            same(a, b)
    for args in ((256, 64, 8000, 20.0, None, True),
                 (512, 80, 16000, 0.0, 7600.0, False),
                 (256, 40, 8000, 20.0, 3800.0, True)):
        same(tfunctional.mel_filterbank(*args),
             jfunctional.mel_filterbank(*args))
    for n_out, n_in in ((13, 64), (20, 80), (64, 64)):
        same(tfunctional.dct_matrix(n_out, n_in),
             jfunctional.dct_matrix(n_out, n_in))
    for n, q in ((13, 22.0), (20, 22.0), (13, 9.5)):
        same(tfunctional.lifter_vector(n, q), jfunctional.lifter_vector(n, q))


def test_config_defaults_match():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JFeatureConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(FeatureConfig)}
    assert jf == tf
    c = FeatureConfig(sample_rate=16000)
    j = JFeatureConfig(sample_rate=16000)
    assert (c.win_length, c.hop_length, c.fft_size, c.n_freqs) == (
        j.win_length, j.hop_length, j.fft_size, j.n_freqs)


@pytest.mark.parametrize("fused", [False, True])
def test_golden_wav(fused):
    sr, data = wavfile.read(GOLDEN / "golden.wav")
    wav = (data.astype(np.float32) / 32768.0 if data.dtype == np.int16
           else data.astype(np.float32))
    cfg = json.loads((GOLDEN / "golden_meta.json").read_text())[
        "feature_config"]
    assert sr == cfg["sample_rate"]
    (fj, lj), (ft, lt) = _both(cfg, wav, None, fused)
    np.testing.assert_array_equal(lj, lt)
    assert fj.shape == ft.shape
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_ragged_batch(fused):
    rng = np.random.default_rng(0)
    S = 8000
    wav = (rng.standard_normal((3, S)) * 0.2).astype(np.float32)
    lens = np.array([S, S - 2500, 300], np.int32)
    wav[1, lens[1]:] = 0.0
    wav[2, lens[2]:] = 0.0
    (fj, lj), (ft, lt) = _both({}, wav, lens, fused)
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3)


def test_hop_wider_than_128_lanes():
    """16 kHz: hop 160 > 128 takes the JAX K1b branch (frames gathered
    outside the kernel); the port's one kernel frames from the wav."""
    rng = np.random.default_rng(1)
    S = 6000
    wav = (rng.standard_normal((2, S)) * 0.2).astype(np.float32)
    lens = np.array([S, 4000], np.int32)
    kw = dict(sample_rate=16000, n_mels=40)
    assert JFeatureConfig(**kw).hop_length > 128
    (fj, lj), (ft, lt) = _both(kw, wav, lens, fused=True)
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3)


def test_spectrogram_and_preemphasis():
    rng = np.random.default_rng(2)
    wav = (np.sin(2 * np.pi * 440 * np.arange(4000) / 8000)
           + 0.05 * rng.standard_normal(4000)).astype(np.float32)
    kw = dict(feature_type="spectrogram", preemphasis=0.97, cvn=False)
    (fj, lj), (ft, lt) = _both(kw, wav, None, fused=True)
    assert int(lj) == int(lt)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3)


def test_fused_equals_plain_featurizer():
    rng = np.random.default_rng(3)
    wav = torch.tensor((rng.standard_normal((2, 5000)) * 0.3)
                       .astype(np.float32))
    lens = torch.tensor([5000, 3100], dtype=torch.int32)
    cfg = FeatureConfig()
    fa, la = Featurizer(cfg, device="cpu")(wav, lens)
    fb, lb = FusedFeaturizer(cfg, device="cpu")(wav, lens)
    assert torch.equal(la, lb)
    torch.testing.assert_close(fa, fb, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(feature_type="mfcc"),
                                dict(center=True), dict(splice_left=1),
                                dict(frame_style="torch")])
def test_unported_options_raise(kw):
    """The fused path refuses what its kernel does not frame (torch framing,
    ``center``) and splicing, which JAX's fused path drops
    (test_torch_features_modes.py). MFCC, once refused, runs there: the
    kernel's log-mel, then the DCT, equal to the plain Featurizer's."""
    cfg = FeatureConfig(**kw)
    if cfg.feature_type == "mfcc":
        rng = np.random.default_rng(4)
        wav = torch.tensor((rng.standard_normal((2, 5000)) * 0.3)
                           .astype(np.float32))
        lens = torch.tensor([5000, 3100], dtype=torch.int32)
        fa, la = Featurizer(cfg, device="cpu")(wav, lens)
        fb, lb = FusedFeaturizer(cfg, device="cpu")(wav, lens)
        assert fb.shape == (2, 61, 13) and torch.equal(la, lb)
        torch.testing.assert_close(fa, fb, rtol=0, atol=0)
        return
    with pytest.raises(ValueError):
        FusedFeaturizer(cfg, device="cpu")


def test_too_short_signal_raises():
    with pytest.raises(ValueError, match="too short"):
        FusedFeaturizer(FeatureConfig(), device="cpu")(
            np.zeros(100, np.float32))
