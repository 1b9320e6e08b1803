"""GRU scan with the input projection inside the kernel (forward only).

Counterparts of ``gru_scan_xfused`` (K2, tpuasr/ops/pallas_gru.py:772) and
``gru_scan_xfused_q8`` (K4, pallas_gru.py:1045). Both launch the kernel of
``csrc/gru_scan.cu`` for CUDA tensors and run their plain versions for CPU
tensors. Layouts follow the JAX package: x (T, B, D) time-major, wx (D, 3H),
wh (H, 3H), b (3H,), gate order r, z, n, mask (T, B, 1).
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build
from tpuasr_torch.ops.quant import reference_q8_gru_scan
from tpuasr_torch.precision import full_fp32

_MODE_K2, _MODE_Q8, _MODE_Q8_REC = 0, 1, 2


def gru_recurrence(xp, hp_fn, mask, reverse, out_dtype):
    """The masked GRU recurrence over precomputed input projections.

    xp (T, B, 3H) f32, hp_fn(h (B, H) f32) -> (B, 3H) f32, mask (T, B, 1).
    The state is carried in f32; ys is stored in ``out_dtype``.
    """
    T, B, H3 = xp.shape
    H = H3 // 3
    m = mask.to(torch.float32).reshape(T, B, 1)
    h = torch.zeros((B, H), dtype=torch.float32, device=xp.device)
    ys = torch.empty((T, B, H), dtype=out_dtype, device=xp.device)
    for s in range(T):
        t = T - 1 - s if reverse else s
        hp = hp_fn(h)
        r = torch.sigmoid(xp[t, :, :H] + hp[:, :H])
        z = torch.sigmoid(xp[t, :, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(xp[t, :, 2 * H:] + r * hp[:, 2 * H:])
        h_new = (1.0 - z) * n + z * h
        h = m[t] * h_new + (1.0 - m[t]) * h
        ys[t] = h.to(out_dtype)
    return ys


def gru_scan_xfused_plain(x, wx, b, wh, mask, reverse=False):
    """Plain version of K2: x@Wx+b and h@Wh in f32 on the operands' values
    (bf16 operands are widened, never multiplied in bf16), f32 gates."""
    T, B, D = x.shape
    H = wh.shape[0]
    with full_fp32():
        xp = (x.reshape(T * B, D).to(torch.float32) @ wx.to(torch.float32)
              + b.to(torch.float32)).reshape(T, B, 3 * H)
    wh32 = wh.to(torch.float32)

    def hp_fn(h):
        with full_fp32():
            return h.to(wh.dtype).to(torch.float32) @ wh32

    return gru_recurrence(xp, hp_fn, mask, reverse, x.dtype)


gru_scan_xfused_q8_plain = reference_q8_gru_scan


def _gate_vectors(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """(K, 3H) -> (k_pad, H, 4): entry (k, u) is [w_r, w_z, w_n, 0] for
    unit u, zero past K -- the kernel loads one gate vector per (k, u)."""
    K, H3 = w.shape
    H = H3 // 3
    out = w.new_zeros((k_pad, H, 4))
    out[:K, :, :3] = w.reshape(K, 3, H).permute(0, 2, 1)
    return out


def _pack_int8(w: torch.Tensor) -> torch.Tensor:
    """(K, 3H) int8 -> (ceil(K/16)*4, H, 4) int32 gate vectors of words;
    a word holds contraction indices 4i..4i+3, element 4i+j in byte j."""
    K, N = w.shape
    K16 = -(-K // 16) * 16
    if K16 != K:
        w = torch.cat([w, w.new_zeros((K16 - K, N))])
    words = (w.reshape(K16 // 4, 4, N).permute(0, 2, 1).contiguous()
             .view(torch.int32).reshape(K16 // 4, N))
    return _gate_vectors(words, K16 // 4)


def _pack_float(w: torch.Tensor) -> torch.Tensor:
    return _gate_vectors(w, -(-w.shape[0] // 4) * 4)


def _check(name, t, device, dtypes, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(mode, x, wx, b, wh, sw, swh, mask, reverse, H):
    """wx, wh already packed (_pack_float / _pack_int8)."""
    T, B, D = x.shape
    ys = torch.empty((T, B, H), dtype=x.dtype, device=x.device)
    fn = _build.lib().tpuasr_gru_scan
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    null = ctypes.c_void_p(0)
    with torch.cuda.device(x.device):
        code = fn(mode, int(x.dtype == torch.bfloat16), _build.ptr(x),
                  _build.ptr(wx), _build.ptr(b), _build.ptr(wh),
                  _build.ptr(sw) if sw is not None else null,
                  _build.ptr(swh) if swh is not None else null,
                  _build.ptr(mask), _build.ptr(ys), T, B, D, H,
                  int(bool(reverse)), _build.stream_ptr(x))
    return code, ys


def _mask_2d(mask, T, B, device):
    if tuple(mask.shape) not in ((T, B, 1), (T, B)):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{(T, B, 1)}")
    if mask.device != device or mask.dtype != torch.float32:
        raise ValueError("mask must be float32 on the device of x")
    return mask.reshape(T, B).contiguous()


def gru_scan_xfused(x, wx, b, wh, mask, reverse=False):
    """K2: masked GRU scan, x@Wx+b inside the kernel. x (T, B, D) f32 or
    bf16, wx (D, 3H) and wh (H, 3H) in x's dtype, b (3H,) f32,
    mask (T, B, 1) f32 -> ys (T, B, H) in x's dtype."""
    if x.device.type == "cpu":
        return gru_scan_xfused_plain(x, wx, b, wh, mask, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_xfused: unsupported device {x.device}")
    T, B, D = x.shape
    H = wh.shape[0]
    dt = (x.dtype,)
    _check("x", x, x.device, (torch.float32, torch.bfloat16), (T, B, D))
    _check("wx", wx, x.device, dt, (D, 3 * H))
    _check("wh", wh, x.device, dt, (H, 3 * H))
    _check("b", b, x.device, (torch.float32,), (3 * H,))
    mask = _mask_2d(mask, T, B, x.device)
    code, ys = _launch(_MODE_K2, x, _pack_float(wx), b, _pack_float(wh),
                       None, None, mask, reverse, H)
    gru_scan_xfused.launches += 1
    _build.check(code, "gru_scan_xfused")
    return ys


gru_scan_xfused.launches = 0


def gru_scan_xfused_q8(x, wxq, sw, b, wh, mask, reverse=False,
                       wh_scale=None):
    """K4: as K2 with an int8 input projection (x quantized per row inside
    the kernel, exact int32 sums, dequantized as acc*sx*sw + b). wxq (D, 3H)
    int8, sw (3H,) f32. With ``wh_scale`` (3H,), wh is int8 and the
    recurrence runs in int8 too, h re-quantized per step; otherwise wh is
    in x's dtype."""
    if wxq.dtype != torch.int8:
        raise ValueError(f"wxq must be int8, got {wxq.dtype}")
    T, B, D = x.shape
    H = wh.shape[0]
    if D > 1040:
        raise ValueError(f"int8 projection supports D <= 1040 (exact "
                         f"int32->f32 dequant); got D={D}")
    rec_q8 = wh_scale is not None
    if rec_q8:
        if wh.dtype != torch.int8:
            raise ValueError(f"wh must be int8 when wh_scale is given, got "
                             f"{wh.dtype}")
        if H > 1040:
            raise ValueError(f"int8 recurrence supports H <= 1040, got H={H}")
    if x.device.type == "cpu":
        return gru_scan_xfused_q8_plain(x, wxq, sw, b, wh, mask, reverse,
                                        wh_scale)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_xfused_q8: unsupported device {x.device}")
    _check("x", x, x.device, (torch.float32, torch.bfloat16), (T, B, D))
    _check("wxq", wxq, x.device, (torch.int8,), (D, 3 * H))
    _check("sw", sw, x.device, (torch.float32,), (3 * H,))
    _check("b", b, x.device, (torch.float32,), (3 * H,))
    _check("wh", wh, x.device, (torch.int8,) if rec_q8 else (x.dtype,),
           (H, 3 * H))
    if rec_q8:
        _check("wh_scale", wh_scale, x.device, (torch.float32,), (3 * H,))
    mask = _mask_2d(mask, T, B, x.device)
    wh_arg = _pack_int8(wh) if rec_q8 else _pack_float(wh)
    code, ys = _launch(_MODE_Q8_REC if rec_q8 else _MODE_Q8, x,
                       _pack_int8(wxq), b, wh_arg, sw, wh_scale, mask,
                       reverse, H)
    gru_scan_xfused_q8.launches += 1
    _build.check(code, "gru_scan_xfused_q8")
    return ys


gru_scan_xfused_q8.launches = 0
