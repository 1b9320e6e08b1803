"""The featurizer's other modes (BASELINE config 1) against the JAX package
(CPU): MFCC, torch framing, ``center=True``, splicing, pre-emphasis with
MFCC, and dither.

The same numpy inputs, made from a seed, go through JAX's ``Featurizer``
(and ``FusedFeaturizer``, its Pallas kernels with the ``interpret=True``
the package selects itself off a TPU) and the port's. Frame counts are
exact; features within 1e-4 (float32 in other orders of summation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.features.pallas_fused import FusedFeaturizer as JFusedFeaturizer
from tpuasr_torch.features import (FeatureConfig, Featurizer,
                                   FusedFeaturizer)
from tpuasr_torch.features.reference import add_dither, center_pad


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


def _ragged(seed=0, S=4000):
    """Three rows of seeded noise: full, 2500 samples and 300 samples (two
    kaldi frames), zero past each length."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((3, S)) * 0.2).astype(np.float32)
    lens = np.array([S, 2500, 300], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    return wav, lens


def _both(kw, wav, lens, fused=False):
    jcls, tcls = ((JFusedFeaturizer, FusedFeaturizer) if fused
                  else (JFeaturizer, Featurizer))
    fj, lj = jcls(JFeatureConfig(**kw))(wav, lens)
    ft, lt = tcls(FeatureConfig(**kw), device="cpu")(wav, lens)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert ft.shape == np.asarray(fj).shape
    return np.asarray(fj), ft.numpy()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("lifter", [0.0, 22.0])
def test_mfcc_matches_jax(lifter, fused):
    wav, lens = _ragged(1)
    kw = dict(feature_type="mfcc", lifter=lifter)
    fj, ft = _both(kw, wav, lens, fused)
    assert ft.shape[-1] == 13
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(frame_style="torch"),
    dict(frame_style="torch", feature_type="mfcc"),
    dict(center=True),
    dict(center=True, frame_style="torch", cmn=False, cvn=False),
    dict(center=True, feature_type="mfcc", lifter=22.0),
    dict(preemphasis=0.97, feature_type="mfcc"),
    dict(frame_style="torch", n_fft=512, window="hann"),
], ids=["torch", "torch-mfcc", "center", "center-torch-nocmvn",
        "center-mfcc-lifter", "preemph-mfcc", "torch-nfft512"])
def test_framing_modes_match_jax(kw):
    wav, lens = _ragged(2)
    fj, ft = _both(kw, wav, lens)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)


def test_center_reflects_the_batch_buffer():
    """JAX reflect-pads the padded (B, S) buffer, not each utterance: the
    short row's last frames reflect the buffer's zeros past its end, not
    its own samples. The port does the same, and its frame counts come
    from length + 2 * (n_fft // 2) (reference.py:108-109)."""
    wav, lens = _ragged(3)
    kw = dict(center=True, cmn=False, cvn=False)
    fj, ft = _both(kw, wav, lens)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    cfg = FeatureConfig(**kw)
    pad = cfg.fft_size // 2
    padded = center_pad(cfg, torch.tensor(wav))
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jnp.pad(wav, ((0, 0), (pad, pad)),
                                           mode="reflect")))
    # Row 2 (300 samples) reflected on its own would mirror its samples
    # past 300; the buffer's reflection reads the zeros there.
    own = np.pad(wav[2, :300], (pad, pad), mode="reflect")
    assert not np.allclose(own[300 + pad:],
                           padded[2, 300 + pad:300 + 2 * pad])
    T = (wav.shape[1] + 2 * pad - cfg.win_length) // cfg.hop_length + 1
    flen = (lens + 2 * pad - cfg.win_length) // cfg.hop_length + 1
    ft2, lt2 = Featurizer(cfg, device="cpu")(wav, lens)
    assert ft2.shape[1] == T
    np.testing.assert_array_equal(lt2.numpy(), flen)


def test_splicing_matches_jax():
    """Splicing (2, 2) after CMVN, edge-replicated. A row's last valid
    frames splice in its padded frames, which CMVN leaves at
    (log floor - mean) / std: on the 2-frame row about -150, where float32
    rounds at ~1e-5: rtol 1e-4 on top of atol 1e-4."""
    wav, lens = _ragged(4)
    kw = dict(splice_left=2, splice_right=2)
    fj, ft = _both(kw, wav, lens)
    assert ft.shape[-1] == 5 * 64 == FeatureConfig(**kw).feat_dim
    np.testing.assert_allclose(ft, fj, rtol=1e-4, atol=1e-4)
    # The centre block is the unspliced featurizer's output.
    plain, _ = Featurizer(FeatureConfig(), device="cpu")(wav, lens)
    np.testing.assert_array_equal(ft[..., 128:192], plain.numpy())


def test_jax_fused_path_drops_splicing_and_the_port_refuses_it():
    """A fault of the reference (ROADMAP Queue 3): JAX's FusedFeaturizer
    has no splice step, so it returns base_dim-wide features where
    feat_dim says 5x as many. The port's fused path raises instead."""
    wav, lens = _ragged(5)
    cfg = JFeatureConfig(splice_left=2, splice_right=2)
    fj, _ = JFusedFeaturizer(cfg)(wav, lens)
    assert np.asarray(fj).shape[-1] == cfg.base_dim == 64
    assert cfg.feat_dim == 320
    with pytest.raises(ValueError, match="splice"):
        FusedFeaturizer(FeatureConfig(splice_left=2, splice_right=2),
                        device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_dither(fused):
    """Off without a generator, even with dither > 0; the same bits from
    the same generator seed; other bits from another seed; and the noise
    itself N(0, dither^2): its std within 5% of dither over 10^5
    samples."""
    cls = FusedFeaturizer if fused else Featurizer
    wav = torch.tensor(_ragged(6, S=50_000)[0])
    lens = torch.full((3,), 50_000, dtype=torch.int32)
    fz = cls(FeatureConfig(dither=0.5), device="cpu")
    clean = cls(FeatureConfig(), device="cpu").featurize(wav, lens)[0]
    assert torch.equal(fz.featurize(wav, lens)[0], clean)
    assert torch.equal(fz(wav, lens)[0], clean)
    a = fz.featurize(wav, lens, torch.Generator().manual_seed(7))[0]
    b = fz.featurize(wav, lens, torch.Generator().manual_seed(7))[0]
    c = fz.featurize(wav, lens, torch.Generator().manual_seed(8))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, clean, atol=1e-2)
    # The noise alone, drawn as the featurizer draws it: 10^5 samples.
    zero = torch.zeros(2, 50_000)
    noise = add_dither(FeatureConfig(dither=0.5), zero,
                       torch.Generator().manual_seed(9))
    assert abs(float(noise.std()) - 0.5) < 0.05 * 0.5
    assert abs(float(noise.mean())) < 0.01
    assert torch.equal(add_dither(FeatureConfig(), zero,
                                  torch.Generator().manual_seed(9)), zero)


def test_feat_dim_and_unknown_values():
    assert FeatureConfig(feature_type="mfcc", splice_left=1).feat_dim == 26
    assert (FeatureConfig(feature_type="mfcc").feat_dim
            == JFeatureConfig(feature_type="mfcc").feat_dim)
    for kw in (dict(frame_style="htk"), dict(feature_type="plp")):
        with pytest.raises(ValueError):
            Featurizer(FeatureConfig(**kw), device="cpu")
