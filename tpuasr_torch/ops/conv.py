"""The int8 freq-Toeplitz tap-GEMM convolution (DeepSpeech's conv2).

Counterpart of ``tpuasr/ops/pallas_conv.py``: ``conv_taps_q8`` (K9) runs
a time-stride-1 conv whose (freq, channel) axes are folded into per-tap
band matrices as one int8 GEMM over the Kt taps. Output row i takes input
rows i .. i+Kt-1. Its activation scale is the windowed max of those rows'
absmaxes, each tap segment is quantized with that scale, the products are
summed exactly in int32, then dequantized by the row scale and the
per-column weight scale.

``conv_taps_q8`` launches ``csrc/conv_q8.cu`` for CUDA tensors and runs
the plain ``reference_q8_conv_taps`` for CPU tensors. The plain version
keeps both of JAX's oracle modes, ``im2col`` (the shipped kernel's math)
and ``taps`` (per-input-row scales, one dequant per tap); the kernel ports
``im2col`` only.
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build
from tpuasr_torch.ops.quant import quantize_rows
from tpuasr_torch.precision import full_fp32

T_BLK = 128             # JAX's time block; bounds Kt - 1 as there
_EXACT_K = 1024         # contraction chunk whose f32 sums stay exact


def _int8_dot(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) @ int8 (K, N) -> exact int32 sums.

    Each chunk of at most 1024 contraction terms sums to at most
    1024 * 127^2 < 2^24, so a float32 product without TF32 is exact in any
    order; the chunks add in int32. (PyTorch has no integer product on the
    card.)"""
    K = a_q.shape[-1]
    acc = None
    for k0 in range(0, K, _EXACT_K):
        with full_fp32():
            part = (a_q[..., k0:k0 + _EXACT_K].to(torch.float32)
                    @ b_q[k0:k0 + _EXACT_K].to(torch.float32))
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _check(xf, mq, sw, T_out, mode):
    """The conditions of pallas_conv.py:183-189."""
    if mode not in ("im2col", "taps", "slab"):
        raise ValueError(f"unknown conv_taps_q8 mode {mode!r}")
    B, T_in, Kd = xf.shape
    Kt, Kd2, N = mq.shape
    if Kd2 != Kd or Kt - 1 > T_BLK:
        raise ValueError(f"mq has shape {tuple(mq.shape)} for xf of "
                         f"{tuple(xf.shape)}")
    if Kd % 128 or N % 128:
        raise ValueError(f"conv_taps_q8 needs Kd and N multiples of 128, "
                         f"got Kd={Kd}, N={N}")
    terms = Kd if mode == "taps" else Kt * Kd
    if terms * 127 * 127 >= 2 ** 31:
        raise ValueError("the int32 sums would overflow")
    if tuple(sw.shape) != (N,):
        raise ValueError(f"sw has shape {tuple(sw.shape)}, expected {(N,)}")
    if mq.dtype != torch.int8:
        raise ValueError(f"mq must be int8, got {mq.dtype}")


def reference_q8_conv_taps(xf, mq, sw, T_out: int, mode: str = "im2col"):
    """Plain version of K9, in the arithmetic order of JAX's oracle
    (pallas_conv.py:202-248). xf (B, T_in, Kd) f32, mq (Kt, Kd, N) int8,
    sw (N,) f32 -> (B, T_out, N) f32.

    im2col: sx = max(windowed row absmax, 1e-12) * (1/127) per output row,
    each segment x / sx rounded half to even and clipped to +-127, one
    exact int32 product, then (acc * sx) * sw. taps: per-input-row scales,
    per-tap exact products dequantized by that row's scale and summed in
    f32 in tap order, then * sw."""
    B, T_in, Kd = xf.shape
    Kt, _, N = mq.shape
    need = T_out + Kt - 1
    xf = xf.to(torch.float32)
    if T_in < need:
        xf = torch.cat([xf, xf.new_zeros((B, need - T_in, Kd))], dim=1)
    sw = sw.to(torch.float32).reshape(1, 1, N)
    if mode == "im2col":
        rmax = xf.abs().amax(dim=2, keepdim=True)
        wmax = rmax[:, :T_out]
        for t in range(1, Kt):
            wmax = torch.maximum(wmax, rmax[:, t:t + T_out])
        sx = torch.clamp(wmax, min=1e-12) * (1.0 / 127.0)   # (B, T_out, 1)
        acc = None
        for t in range(Kt):
            seg = torch.clamp(torch.round(xf[:, t:t + T_out] / sx), -127.0,
                              127.0).to(torch.int8)
            d = _int8_dot(seg, mq[t])
            acc = d if acc is None else acc + d
        return acc.to(torch.float32) * sx * sw
    if mode != "taps":
        raise NotImplementedError(
            f"conv_taps_q8 mode {mode!r} has no plain version (JAX has no "
            "oracle for it either)")
    T_pad = xf.shape[1]
    xq, sx = quantize_rows(xf.reshape(B * T_pad, Kd))
    xq = xq.reshape(B, T_pad, Kd)
    sx = sx.reshape(B, T_pad, 1)
    acc = xf.new_zeros((B, T_out, N))
    for t in range(Kt):
        d = _int8_dot(xq[:, t:t + T_out], mq[t])
        acc = acc + d.to(torch.float32) * sx[:, t:t + T_out]
    return acc * sw


def conv_taps_q8(xf, mq, sw, T_out: int, mode: str = "im2col"):
    """K9: the quantized Kt-tap GEMM convolution over time.

    xf (B, T_in, Kd) f32 flattened (freq, channel) rows, time-padded so
    output row i consumes input rows i .. i+Kt-1 (rows past T_in count as
    zeros); mq (Kt, Kd, N) int8 band matrices, quantized per output column;
    sw (N,) f32 column scales -> (B, T_out, N) f32, equal to the plain
    version up to one f32 rounding of the dequant.

    ``mode`` is JAX's A/B switch ("im2col", "taps", "slab"; JAX also
    reads it from ``TPUASR_CONV_Q8_MODE``, the port does not): on CUDA only
    "im2col" is ported, and "slab" has no plain version."""
    _check(xf, mq, sw, T_out, mode)
    if xf.device.type == "cpu":
        return reference_q8_conv_taps(xf, mq, sw, T_out, mode)
    if xf.device.type != "cuda":
        raise ValueError(f"conv_taps_q8: unsupported device {xf.device}")
    if mode != "im2col":
        raise NotImplementedError(
            f"conv_taps_q8 mode {mode!r} is not ported to CUDA (only "
            "'im2col' is)")
    B, T_in, Kd = xf.shape
    Kt, _, N = mq.shape
    _build.check_tensor("xf", xf, xf.device, (torch.float32,), (B, T_in, Kd))
    _build.check_tensor("mq", mq, xf.device, (torch.int8,), (Kt, Kd, N))
    _build.check_tensor("sw", sw, xf.device, (torch.float32,), (N,))
    out = torch.empty((B, T_out, N), dtype=torch.float32, device=xf.device)
    if out.numel() == 0:
        return out
    # The kernel reads each column's Kd contraction bytes contiguously.
    mqt = mq.permute(0, 2, 1).contiguous()                  # (Kt, N, Kd)
    rmax = torch.empty((B, T_out + Kt - 1), dtype=torch.float32,
                       device=xf.device)
    fn = _build.lib().tpuasr_conv_q8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xf.device):
        code = fn(_build.ptr(xf), _build.ptr(mqt), _build.ptr(sw),
                  _build.ptr(rmax), _build.ptr(out), B, T_in, T_out, Kt, Kd,
                  N, _build.stream_ptr(xf))
    conv_taps_q8.launches += 1
    _build.check(code, "conv_taps_q8")
    return out


conv_taps_q8.launches = 0
