"""Fused featurizer: one CUDA kernel from wav to projected power spectrum.

Counterpart of ``tpuasr/features/pallas_fused.py``. The kernel
(``csrc/fbank.cu``) replaces both Pallas variants: K1,
``_make_framed_kernel`` through ``_build_call_framed`` (pallas_fused.py:109),
which frames hop-sized rows inside the kernel, and K1b, ``_fused_kernel``
through ``_build_call`` (pallas_fused.py:137), which took frames gathered
outside for hops wider than 128 lanes. The CUDA kernel frames straight from
the wav for any hop, so one kernel serves both. Log, CMVN and the mask stay
plain torch outside the kernel, as in JAX (pallas_fused.py:257-295).
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build
from tpuasr_torch.features.reference import (Featurizer, frames_plain,
                                             mel_power_plain)


def fbank_power_plain(wav: torch.Tensor, tables: dict, hop: int,
                      T: int) -> torch.Tensor:
    """Plain version of the kernel: (B, S) wav -> (B, T, out) f32."""
    frames = frames_plain(wav, hop, tables["window"].shape[0], T)
    return mel_power_plain(frames, tables)


def fbank_power(wav: torch.Tensor, tables: dict, hop: int,
                T: int) -> torch.Tensor:
    """Projected power spectrum of frames [t*hop, t*hop + win), t < T.

    wav (B, S) f32 with (T - 1) * hop + win <= S; tables from
    ``feature_tables``. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    win = tables["window"].shape[0]
    if wav.ndim != 2 or (T - 1) * hop + win > wav.shape[1] or T <= 0:
        raise ValueError(f"wav {tuple(wav.shape)} too short for {T} frames "
                         f"of {win} at hop {hop}")
    if wav.device.type == "cpu":
        return fbank_power_plain(wav, tables, hop, T)
    if wav.device.type != "cuda":
        raise ValueError(f"fbank_power: unsupported device {wav.device}")
    n_freqs = tables["cos"].shape[1]
    n_out = tables["proj"].shape[1]
    for name, t in (("wav", wav), *tables.items()):
        if t.device != wav.device or t.dtype != torch.float32:
            raise ValueError(f"fbank_power: {name} must be float32 on "
                             f"{wav.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fbank_power: {name} must be contiguous")
    if (tables["cos"].shape != (win, n_freqs)
            or tables["sin"].shape != (win, n_freqs)
            or tables["proj"].shape[0] != n_freqs):
        raise ValueError("fbank_power: inconsistent table shapes")
    B, S = wav.shape
    out = torch.empty((B, T, n_out), dtype=torch.float32, device=wav.device)
    lib = _build.lib()
    fn = lib.tpuasr_fbank_power
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(wav.device):
        code = fn(_build.ptr(wav), _build.ptr(tables["window"]),
                  _build.ptr(tables["cos"]), _build.ptr(tables["sin"]),
                  _build.ptr(tables["proj"]), _build.ptr(out),
                  B, S, T, hop, win, n_freqs, n_out, _build.stream_ptr(wav))
        fbank_power.launches += 1
    _build.check(code, "fbank_power")
    return out


fbank_power.launches = 0


class FusedFeaturizer(Featurizer):
    """Featurizer whose framing, window, rDFT, power and mel projection run
    in one kernel on CUDA (plain torch on CPU); same interface and output
    as ``reference.Featurizer``."""

    def power_spectrum(self, wav: torch.Tensor, T: int) -> torch.Tensor:
        return fbank_power(wav, self.tables, self.cfg.hop_length, T)
