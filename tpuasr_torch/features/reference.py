"""Plain PyTorch featurizer: wav -> frames -> power spectrum -> log-mel /
MFCC -> CMVN -> splicing.

Counterpart of ``tpuasr/features/reference.py`` with every option of its
``FeatureConfig``: kaldi framing (frame t covers [t*hop, t*hop + win)) and
torch framing (the window centred in the n_fft span), ``center=True`` (the
padded batch buffer reflect-padded by n_fft // 2, as JAX pads it, not each
utterance), fbank, MFCC (the DCT-II of the log-mel, times the lifter when
``lifter > 0``) and spectrogram features, pre-emphasis, masked
per-utterance CMVN, edge-replicated splicing after CMVN, and dither:
``featurize(wav, lengths, generator)`` adds ``dither * randn`` drawn from
``generator`` only when ``dither > 0`` and a generator is given, as JAX
adds it only when given a key. The featurizers run on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch
import torch.nn.functional as TF

from tpuasr_torch.features import functional as F
from tpuasr_torch.precision import full_fp32
from tpuasr_torch.utils.device import resolve_device


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

    @property
    def feat_dim(self) -> int:
        return self.base_dim * (1 + self.splice_left + self.splice_right)


def _frame_span(cfg: FeatureConfig) -> int:
    return cfg.fft_size if cfg.frame_style == "torch" else cfg.win_length


def frame_offset(cfg: FeatureConfig) -> int:
    """Where a frame's window starts in its span: centred in the n_fft span
    under torch framing (tpuasr/features/reference.py:164-167), at the
    span's start under kaldi framing."""
    if cfg.frame_style == "torch":
        return (cfg.fft_size - cfg.win_length) // 2
    return 0


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
    """Refuse values that name nothing (the JAX package reads any
    frame_style other than "torch" as kaldi; the port names both)."""
    if cfg.frame_style not in ("kaldi", "torch"):
        raise ValueError(f"unknown frame_style {cfg.frame_style!r}")
    if cfg.feature_type not in ("fbank", "mfcc", "spectrogram"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")
    if cfg.splice_left < 0 or cfg.splice_right < 0:
        raise ValueError("splice context must be >= 0")


def feature_tables(cfg: FeatureConfig, device) -> dict:
    """Window (win,), cos/sin (win, n_freqs), projection (n_freqs, out) f32;
    for MFCC also the DCT (n_mels, n_mfcc) and, when lifter > 0, the
    lifter (n_mfcc,)."""
    window = F.window_vector(cfg.window, cfg.win_length, cfg.periodic_window)
    cos_m, sin_m = F.rdft_matrices(cfg.fft_size, cfg.win_length)
    if cfg.feature_type in ("fbank", "mfcc"):
        proj = F.mel_filterbank(cfg.fft_size, cfg.n_mels, cfg.sample_rate,
                                cfg.fmin, cfg.fmax, cfg.htk_mel)
    else:
        proj = np.eye(cfg.n_freqs, dtype=np.float32)
    tables = [("window", window), ("cos", cos_m), ("sin", sin_m),
              ("proj", proj)]
    if cfg.feature_type == "mfcc":
        tables.append(("dct", F.dct_matrix(cfg.n_mfcc, cfg.n_mels)))
        if cfg.lifter > 0:
            tables.append(("lifter", F.lifter_vector(cfg.n_mfcc, cfg.lifter)))
    return {name: torch.as_tensor(np.ascontiguousarray(a), device=device)
            for name, a in tables}


def add_dither(cfg: FeatureConfig, wav: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
    """wav + dither * N(0, 1) noise from ``generator`` (on wav's device);
    unchanged when dither is 0 or no generator is given."""
    if cfg.dither <= 0.0 or generator is None:
        return wav
    noise = torch.randn(wav.shape, generator=generator, device=wav.device)
    return wav + cfg.dither * noise


def preemphasize(wav: torch.Tensor, coeff: float) -> torch.Tensor:
    if coeff <= 0.0:
        return wav
    prev = torch.cat([wav[:, :1], wav[:, :-1]], dim=1)
    return wav - coeff * prev


def center_pad(cfg: FeatureConfig, wav: torch.Tensor) -> torch.Tensor:
    """With ``center``, the (B, S) buffer reflect-padded by n_fft // 2 on
    both sides (tpuasr/features/reference.py:152-154): a short row
    reflects the buffer's zeros past its end, not its own samples."""
    if not cfg.center:
        return wav
    pad = cfg.fft_size // 2
    if wav.shape[1] <= pad:
        raise ValueError(f"center=True reflects {pad} samples; the signal "
                         f"has {wav.shape[1]}")
    return TF.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]


def splice(cfg: FeatureConfig, feat: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (B, T, F * (1 + left + right)): frames t - left ..
    t + right side by side, edge-replicated
    (tpuasr/features/reference.py:224-234)."""
    if cfg.splice_left == 0 and cfg.splice_right == 0:
        return feat
    T = feat.shape[1]
    t = torch.arange(T, device=feat.device)
    return torch.cat([feat[:, torch.clamp(t + off, 0, T - 1)]
                      for off in range(-cfg.splice_left,
                                       cfg.splice_right + 1)], dim=-1)


def finish_features(cfg: FeatureConfig, power: torch.Tensor,
                    lengths: torch.Tensor, tables: dict):
    """log floor, the DCT and lifter (MFCC), masked CMVN, splicing and
    padding zeroing (reference.py:185-253)."""
    feat = torch.log(torch.clamp(power, min=cfg.log_floor))
    if cfg.feature_type == "mfcc":
        with full_fp32():
            feat = feat @ tables["dct"]
        if "lifter" in tables:
            feat = feat * tables["lifter"]
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
    return splice(cfg, feat) * mask[:, :, None], flen


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
        -> feats (B, T, feat_dim) float32, frame_lengths (B,) int32
    T is fixed by S; frames past a row's length are zeroed. The device
    defaults to the card; a CUDA device that is absent is a RuntimeError.
    """

    def __init__(self, cfg: FeatureConfig, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tables = feature_tables(cfg, self.device)

    def power_spectrum(self, wav: torch.Tensor, T: int) -> torch.Tensor:
        """(B, S') framed buffer -> (B, T, out) projected power spectrum."""
        c = self.cfg
        frames = frames_plain(wav[:, frame_offset(c):], c.hop_length,
                              c.win_length, T)
        return mel_power_plain(frames, self.tables)

    def featurize(self, wav: torch.Tensor, lengths: torch.Tensor,
                  generator: torch.Generator | None = None):
        """(B, S) wav, (B,) lengths -> (feats, frame lengths); with
        ``generator`` (on wav's device) and dither > 0, the dithered
        features of a training step."""
        c = self.cfg
        T = num_frames(c, wav.shape[1])
        if T <= 0:
            raise ValueError(f"signal too short: {wav.shape[1]} samples < "
                             f"frame span {_frame_span(c)}")
        wav = preemphasize(add_dither(c, wav, generator), c.preemphasis)
        wav = center_pad(c, wav).contiguous()
        return finish_features(c, self.power_spectrum(wav, T), lengths,
                               self.tables)

    def __call__(self, wav, lengths=None):
        wav, lengths, squeeze = as_batch(wav, lengths, self.device)
        feat, flen = self.featurize(wav, lengths)
        if squeeze:
            return feat[0], flen[0]
        return feat, flen
