"""The featurizer's constant matrices: window, rDFT, mel and DCT (numpy).

The port's own copy of the numpy functions of ``tpuasr/features/functional.py``
(``next_pow2``, ``window_vector``, ``rdft_matrices``, ``hz_to_mel``,
``mel_to_hz``, ``mel_filterbank``, ``dct_matrix``, ``lifter_vector``),
line for line, so the constants are byte-identical between the two
packages (a test holds them to it) while this package loads nothing of the
JAX one. They are computed once on the host and moved to the device as the
featurizer's tables.
"""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def window_vector(name: str, win_length: int, periodic: bool = True,
                  dtype=np.float32) -> np.ndarray:
    """Analysis window, matching torch.{hann,hamming,blackman}_window conventions.

    ``periodic=True`` matches torch's default (window of length N sampled from a
    period-N+.. DFT-even window); ``periodic=False`` is the symmetric variant.
    """
    if win_length == 1:
        return np.ones((1,), dtype=dtype)
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2.0 * np.pi * n / denom)
             + 0.08 * np.cos(4.0 * np.pi * n / denom))
    elif name in ("rect", "rectangular", "ones", "boxcar"):
        w = np.ones_like(n)
    elif name == "povey":
        # Kaldi's default window: hann ** 0.85 (symmetric in Kaldi).
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)) ** 0.85
    else:
        raise ValueError(f"unknown window {name!r}")
    return w.astype(dtype)


def rdft_matrices(n_fft: int, win_length: int | None = None,
                  dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as matmul: returns (C, S) with shapes (win_length, n_freqs).

    For a (zero-padded to n_fft) frame x of length win_length:
        real part = x @ C,   imag part = -(x @ S)
    i.e. ``rfft(x, n_fft)[k] = sum_t x[t] * exp(-2pi i t k / n_fft)``.
    Power spectrum = (x @ C)**2 + (x @ S)**2, so the sign of the imaginary
    part is irrelevant for features; C/S are defined so that
    ``x @ C + 1j * (x @ S)`` equals ``conj(rfft(x))`` — tests only rely on
    magnitude/power parity plus real-part parity.

    Only the first ``win_length`` rows are kept (the zero-padded tail of the
    frame contributes nothing), keeping the matmul (T, win) @ (win, n_freqs).
    """
    if win_length is None:
        win_length = n_fft
    n_freqs = n_fft // 2 + 1
    t = np.arange(win_length, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def hz_to_mel(hz, htk: bool = True):
    """Hz -> mel. HTK formula (also what Kaldi uses): 2595 log10(1 + f/700)."""
    hz = np.asarray(hz, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    # Slaney variant (librosa default): linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(hz >= min_log_hz,
                    min_log_mel + np.log(hz / min_log_hz) / logstep, mel)


def mel_to_hz(mel, htk: bool = True):
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


def mel_filterbank(n_fft: int, n_mels: int, sample_rate: float,
                   fmin: float = 20.0, fmax: float | None = None,
                   htk: bool = True, dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank as a (n_freqs, n_mels) matmul matrix.

    Triangles are laid out on the mel scale between fmin and fmax (HTK/Kaldi
    style; Kaldi's fbank uses the same construction evaluated at FFT-bin
    center frequencies).  Apply as ``power_spec @ M``.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    # n_mels+2 equally spaced points on the mel axis.
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    bin_hz = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    lower = hz_pts[:-2][None, :]     # (1, n_mels)
    center = hz_pts[1:-1][None, :]
    upper = hz_pts[2:][None, :]
    f = bin_hz[:, None]              # (n_freqs, 1)
    up = (f - lower) / np.maximum(center - lower, 1e-10)
    down = (upper - f) / np.maximum(upper - center, 1e-10)
    fb = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(dtype)


def dct_matrix(n_out: int, n_in: int, dtype=np.float32) -> np.ndarray:
    """DCT-II matrix with 'ortho' norm as an (n_in, n_out) matmul matrix.

    ``log_mel @ D`` == scipy.fftpack.dct(log_mel, type=2, norm='ortho')[..., :n_out].
    """
    k = np.arange(n_out, dtype=np.float64)[None, :]
    n = np.arange(n_in, dtype=np.float64)[:, None]
    d = np.cos(np.pi * (n + 0.5) * k / n_in) * np.sqrt(2.0 / n_in)
    d[:, 0] *= np.sqrt(0.5) if n_out > 0 else 1.0
    return d.astype(dtype)


def lifter_vector(n_ceps: int, q: float = 22.0, dtype=np.float32) -> np.ndarray:
    """Standard cepstral liftering coefficients (HTK-style)."""
    n = np.arange(n_ceps, dtype=np.float64)
    return (1.0 + (q / 2.0) * np.sin(np.pi * n / q)).astype(dtype)


__all__ = ["next_pow2", "window_vector", "rdft_matrices", "mel_filterbank",
           "dct_matrix", "lifter_vector", "hz_to_mel", "mel_to_hz"]
