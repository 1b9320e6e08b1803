"""Plain PyTorch featurizer: wav -> frames -> power spectrum -> log-mel -> CMVN.

Counterpart of ``tpuasr/features/reference.py``. It covers the kaldi framing
path (``center=False``, ``frame_style="kaldi"``) for fbank and spectrogram
features, with pre-emphasis and masked per-utterance CMVN. MFCC,
``center=True``, torch-style framing and splicing raise
``NotImplementedError``; dither is a training-time option and is not applied.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from tpuasr_torch.features import functional as F
from tpuasr_torch.precision import full_fp32


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Static featurizer configuration (same fields and defaults as tpuasr)."""

    sample_rate: int = 8000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_fft: int | None = None         # default: next_pow2(win_length)
    window: str = "hamming"
    periodic_window: bool = True
    center: bool = False
    dither: float = 0.0
    frame_style: str = "kaldi"
    preemphasis: float = 0.0
    feature_type: str = "fbank"      # "fbank" | "mfcc" | "spectrogram"
    n_mels: int = 64
    fmin: float = 20.0
    fmax: float | None = None
    htk_mel: bool = True
    n_mfcc: int = 13
    lifter: float = 0.0
    log_floor: float = 1e-10
    cmn: bool = True
    cvn: bool = True
    splice_left: int = 0
    splice_right: int = 0

    @cached_property
    def win_length(self) -> int:
        return int(round(self.sample_rate * self.win_ms / 1000.0))

    @cached_property
    def hop_length(self) -> int:
        return int(round(self.sample_rate * self.hop_ms / 1000.0))

    @cached_property
    def fft_size(self) -> int:
        return self.n_fft if self.n_fft is not None else F.next_pow2(self.win_length)

    @property
    def n_freqs(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def base_dim(self) -> int:
        if self.feature_type == "fbank":
            return self.n_mels
        if self.feature_type == "mfcc":
            return self.n_mfcc
        if self.feature_type == "spectrogram":
            return self.n_freqs
        raise ValueError(f"unknown feature_type {self.feature_type!r}")


def _frame_span(cfg: FeatureConfig) -> int:
    return cfg.fft_size if cfg.frame_style == "torch" else cfg.win_length


def num_frames(cfg: FeatureConfig, n_samples):
    """Frames for a signal of ``n_samples`` (python int or integer tensor)."""
    span = _frame_span(cfg)
    if cfg.center:
        n_samples = n_samples + 2 * (cfg.fft_size // 2)
    if isinstance(n_samples, (int, np.integer)):
        return max(0, 1 + (n_samples - span) // cfg.hop_length)
    return torch.clamp(1 + torch.div(n_samples - span, cfg.hop_length,
                                     rounding_mode="floor"), min=0)


def check_supported(cfg: FeatureConfig) -> None:
    if cfg.center or cfg.frame_style != "kaldi":
        raise NotImplementedError(
            "tpuasr_torch featurizes the kaldi framing path only "
            "(center=False, frame_style='kaldi')")
    if cfg.feature_type not in ("fbank", "spectrogram"):
        raise NotImplementedError(
            f"feature_type {cfg.feature_type!r} is not ported yet")
    if cfg.splice_left or cfg.splice_right:
        raise NotImplementedError("frame splicing is not ported yet")


def feature_tables(cfg: FeatureConfig, device) -> dict:
    """Window (win,), cos/sin (win, n_freqs), projection (n_freqs, out) f32."""
    window = F.window_vector(cfg.window, cfg.win_length, cfg.periodic_window)
    cos_m, sin_m = F.rdft_matrices(cfg.fft_size, cfg.win_length)
    if cfg.feature_type == "fbank":
        proj = F.mel_filterbank(cfg.fft_size, cfg.n_mels, cfg.sample_rate,
                                cfg.fmin, cfg.fmax, cfg.htk_mel)
    else:
        proj = np.eye(cfg.n_freqs, dtype=np.float32)
    return {name: torch.as_tensor(np.ascontiguousarray(a), device=device)
            for name, a in (("window", window), ("cos", cos_m),
                            ("sin", sin_m), ("proj", proj))}


def preemphasize(wav: torch.Tensor, coeff: float) -> torch.Tensor:
    if coeff <= 0.0:
        return wav
    prev = torch.cat([wav[:, :1], wav[:, :-1]], dim=1)
    return wav - coeff * prev


def finish_features(cfg: FeatureConfig, mel_power: torch.Tensor,
                    lengths: torch.Tensor):
    """log floor, masked CMVN and padding zeroing (reference.py:186-253)."""
    feat = torch.log(torch.clamp(mel_power, min=cfg.log_floor))
    T = feat.shape[1]
    flen = torch.clamp(num_frames(cfg, lengths.to(torch.int64)),
                       max=T).to(torch.int32)
    mask = (torch.arange(T, device=feat.device)[None, :]
            < flen[:, None]).to(feat.dtype)
    if cfg.cmn or cfg.cvn:
        m = mask[:, :, None]
        denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (feat * m).sum(dim=1, keepdim=True) / denom
        if cfg.cmn:
            feat = feat - mean
            if cfg.cvn:
                var = ((feat * m) ** 2).sum(dim=1, keepdim=True) / denom
                feat = feat * torch.rsqrt(var + 1e-8)
        else:
            var = ((feat - mean) ** 2 * m).sum(dim=1, keepdim=True) / denom
            feat = feat * torch.rsqrt(var + 1e-8)
    return feat * mask[:, :, None], flen


def frames_plain(wav: torch.Tensor, hop: int, win: int, T: int):
    """(B, S) -> (B, T, win): frame t covers samples [t*hop, t*hop + win)."""
    return wav.unfold(1, win, hop)[:, :T]


def mel_power_plain(frames: torch.Tensor, tables: dict) -> torch.Tensor:
    """(B, T, win) frames -> (B, T, out) projected power spectrum, fp32."""
    with full_fp32():
        w = frames * tables["window"]
        re = w @ tables["cos"]
        im = w @ tables["sin"]
        return (re * re + im * im) @ tables["proj"]


def as_batch(wav, lengths, device):
    """Accept (S,) or (B, S) arrays/tensors; returns (wav, lengths, squeeze)."""
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
    squeeze = wav.ndim == 1
    if squeeze:
        wav = wav[None]
    if lengths is None:
        lengths = torch.full((wav.shape[0],), wav.shape[1], dtype=torch.int32,
                             device=device)
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return wav.contiguous(), lengths, squeeze


class Featurizer:
    """Plain batched featurizer.

    __call__(wav (B, S) float32, lengths (B,) int32)
        -> feats (B, T, F) float32, frame_lengths (B,) int32
    T is fixed by S; frames past a row's length are zeroed.
    """

    def __init__(self, cfg: FeatureConfig, device="cpu"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.tables = feature_tables(cfg, self.device)

    def power_spectrum(self, wav: torch.Tensor, T: int) -> torch.Tensor:
        """(B, S) -> (B, T, out) projected power spectrum."""
        frames = frames_plain(wav, self.cfg.hop_length, self.cfg.win_length, T)
        return mel_power_plain(frames, self.tables)

    def featurize(self, wav: torch.Tensor, lengths: torch.Tensor):
        c = self.cfg
        wav = preemphasize(wav, c.preemphasis).contiguous()
        T = num_frames(c, wav.shape[1])
        if T <= 0:
            raise ValueError(f"signal too short: {wav.shape[1]} samples < "
                             f"frame span {_frame_span(c)}")
        return finish_features(c, self.power_spectrum(wav, T), lengths)

    def __call__(self, wav, lengths=None):
        wav, lengths, squeeze = as_batch(wav, lengths, self.device)
        feat, flen = self.featurize(wav, lengths)
        if squeeze:
            return feat[0], flen[0]
        return feat, flen
