"""Symmetric int8 quantization for the int8 serving path.

Counterpart of ``tpuasr/ops/quant.py``: per-output-channel weight scales
(absmax / 127 per column), per-row dynamic activation scales, no zero
points, so the int32 accumulator needs no corrections.
"""

from __future__ import annotations

import torch

from tpuasr_torch.precision import full_fp32


def quantize_per_channel(w: torch.Tensor, axis: int = 0):
    """w (D, O) -> (wq int8, scale f32 (O,)) with w ~= wq * scale.

    ``axis`` is the contraction axis; all-zero columns get scale 1e-12/127
    and quantize to 0.
    """
    w = w.to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=axis), min=1e-12) / 127.0
    shape = [1] * w.ndim
    shape[1 - axis] = -1
    wq = torch.clamp(torch.round(w / scale.reshape(shape)), -127.0, 127.0)
    return wq.to(torch.int8), scale


def quantize_rows(x: torch.Tensor):
    """Per-row dynamic int8: (rows, D) f32 -> (int8, scales (rows, 1)).

    Zero rows get scale 1e-12/127 and quantize to 0.
    """
    s = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)
    return q, s


def int8_matmul_exact(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> exact int32 sums, as float32.

    Every partial sum is an integer of magnitude <= K * 127^2, which is below
    2^24 for K <= 1040, so a float32 matmul without TF32 is exact in any
    summation order.
    """
    if a_q.shape[1] > 1040:
        raise ValueError(f"exact int8 products need K <= 1040, got "
                         f"{a_q.shape[1]}")
    with full_fp32():
        return a_q.to(torch.float32) @ b_q.to(torch.float32)


def reference_q8_gru_scan(x, wxq, sw, b, wh, mask, reverse=False,
                          wh_scale=None):
    """Plain version of ``gru_scan_xfused_q8`` (the same quantized math:
    per-row dynamic activations, exact int8 products, fp32 gates)."""
    from tpuasr_torch.ops.gru import gru_recurrence

    T, B, D = x.shape
    H = wh.shape[0]
    xq, sx = quantize_rows(x.reshape(T * B, D).to(torch.float32))
    acc = int8_matmul_exact(xq, wxq)
    xp = (acc * sx * sw.to(torch.float32)[None, :]
          + b.to(torch.float32)[None, :]).reshape(T, B, 3 * H)
    if wh_scale is not None:
        swh = wh_scale.to(torch.float32)[None, :]

        def hp_fn(h):
            hq, sh = quantize_rows(h)
            return int8_matmul_exact(hq, wh) * sh * swh
    else:
        wh32 = wh.to(torch.float32)

        def hp_fn(h):
            with full_fp32():
                return h.to(wh.dtype).to(torch.float32) @ wh32

    return gru_recurrence(xp, hp_fn, mask, reverse, x.dtype)
