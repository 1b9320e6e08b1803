"""GRU scans: over precomputed projections with BPTT, and fused-projection.

Counterparts of tpuasr/ops/pallas_gru.py:

* ``gru_scan`` (K5 forward, K5b backward; pallas_gru.py:238): the masked
  recurrence over xp = x@Wx+b, differentiable. Its kernels are
  ``gru_scan_fwd`` and ``gru_scan_bwd`` (``csrc/gru_bptt.cu``);
* ``gru_scan_xfused`` (K2, pallas_gru.py:772): the input projection inside
  the kernel (``csrc/gru_scan.cu``). Its backward takes the JAX route of
  ``_xf_bwd_recompute`` (pallas_gru.py:891-926): xp recomputed by a matmul,
  K5b, then dx, dWx and db by matmuls;
* ``gru_scan_xfused_q8`` (K4, pallas_gru.py:1045): int8 projection, forward
  only.

Every kernel wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors. Layouts follow the JAX package: x (T, B, D)
time-major, wx (D, 3H), wh (H, 3H), b (3H,), gate order r, z, n,
mask (T, B, 1).
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
    mask (T, B, 1) f32 -> ys (T, B, H) in x's dtype.

    Differentiable in float32 when an input requires grad (see
    ``_XFusedScan``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wx, b, wh)):
        return _XFusedScan.apply(x, wx, b, wh, mask, reverse)
    return _xfused_k2(x, wx, b, wh, mask, reverse)


def _xfused_k2(x, wx, b, wh, mask, reverse):
    if x.device.type == "cpu":
        return gru_scan_xfused_plain(x, wx, b, wh, mask, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_xfused: unsupported device {x.device}")
    T, B, D = x.shape
    H = wh.shape[0]
    dt = (x.dtype,)
    _build.check_tensor("x", x, x.device, (torch.float32, torch.bfloat16),
                        (T, B, D))
    _build.check_tensor("wx", wx, x.device, dt, (D, 3 * H))
    _build.check_tensor("wh", wh, x.device, dt, (H, 3 * H))
    _build.check_tensor("b", b, x.device, (torch.float32,), (3 * H,))
    mask = _mask_2d(mask, T, B, x.device)
    code, ys = _launch(_MODE_K2, x, _pack_float(wx), b, _pack_float(wh),
                       None, None, mask, reverse, H)
    gru_scan_xfused.launches += 1
    _build.check(code, "gru_scan_xfused")
    return ys


gru_scan_xfused.launches = 0


class _XFusedScan(torch.autograd.Function):
    """K2 forward; backward by the route JAX takes at H > 256
    (``_xf_bwd_recompute``): xp = x@Wx+b by a matmul, K5b for dxp and dWh,
    then dx, dWx and db by matmuls. Float32 only."""

    @staticmethod
    def forward(ctx, x, wx, b, wh, mask, reverse):
        if x.dtype != torch.float32:
            raise NotImplementedError(
                "the backward of gru_scan_xfused is ported for float32 only")
        ys = _xfused_k2(x, wx, b, wh, mask, reverse)
        ctx.save_for_backward(x, wx, b, wh, mask, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dys):
        x, wx, b, wh, mask, ys = ctx.saved_tensors
        T, B, D = x.shape
        H3 = wx.shape[1]
        with full_fp32():
            xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, H3)
        dxp, dwh = gru_scan_bwd(xp, prev_states(ys, ctx.reverse), wh, mask,
                                dys.contiguous(), ctx.reverse)
        dxp2 = dxp.reshape(T * B, H3)
        with full_fp32():
            dx = (dxp2 @ wx.T).reshape(T, B, D)
            dwx = x.reshape(T * B, D).T @ dxp2
        return dx, dwx, dxp2.sum(0), dwh, None, None


# ---- K5 / K5b: the scan over precomputed projections, with BPTT ----------


def gru_scan_plain(xp, wh, mask, reverse=False):
    """Plain version of K5: xp (T, B, 3H) f32, wh (H, 3H) f32,
    mask (T, B, 1) -> ys (T, B, H) f32."""
    wh32 = wh.to(torch.float32)

    def hp_fn(h):
        with full_fp32():
            return h @ wh32

    return gru_recurrence(xp.to(torch.float32), hp_fn, mask, reverse,
                          torch.float32)


def prev_states(ys, reverse):
    """The state before each step in scan order: ys shifted one step later
    in time (h_{t-1}, zero at t=0), or earlier for a reversed scan
    (h_{t+1}, zero at t=T-1) -- pallas_gru.py:276-284."""
    zero = torch.zeros_like(ys[:1])
    if reverse:
        return torch.cat([ys[1:], zero]).contiguous()
    return torch.cat([zero, ys[:-1]]).contiguous()


def gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse=False):
    """Plain version of K5b, step by step as ``_bwd_kernel``
    (pallas_gru.py:117-146): the gates recomputed from (xp, ysp), every
    gradient masked on padded steps. -> dxp (T, B, 3H), dwh (H, 3H), f32."""
    T, B, H3 = xp.shape
    H = H3 // 3
    m = mask.to(torch.float32).reshape(T, B, 1)
    wh32 = wh.to(torch.float32)
    dh = xp.new_zeros((B, H), dtype=torch.float32)
    dwh = xp.new_zeros((H, H3), dtype=torch.float32)
    dxp = xp.new_empty((T, B, H3), dtype=torch.float32)
    with full_fp32():
        for t in (range(T) if reverse else range(T - 1, -1, -1)):
            h_prev = ysp[t].to(torch.float32)
            hp = h_prev @ wh32
            x = xp[t].to(torch.float32)
            r = torch.sigmoid(x[:, :H] + hp[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(x[:, 2 * H:] + r * hp[:, 2 * H:])
            d = dys[t].to(torch.float32) + dh
            dz = d * (h_prev - n)
            dn = d * (1.0 - z) * (1.0 - n * n)
            dxr = dn * hp[:, 2 * H:] * r * (1.0 - r)
            dxz = dz * z * (1.0 - z)
            dhp = torch.cat([dxr, dxz, dn * r], dim=1) * m[t]
            dxp[t] = torch.cat([dxr, dxz, dn], dim=1) * m[t]
            dh = m[t] * (d * z + dhp @ wh32.T) + (1.0 - m[t]) * d
            dwh += h_prev.T @ dhp
    return dxp, dwh


def _check_scan(xp, wh, mask):
    T, B, H3 = xp.shape
    H = wh.shape[0]
    if H3 != 3 * H:
        raise ValueError(f"xp has {H3} columns, expected 3 * {H}")
    f32 = (torch.float32,)
    _build.check_tensor("xp", xp, xp.device, f32, (T, B, 3 * H))
    _build.check_tensor("wh", wh, xp.device, f32, (H, 3 * H))
    return T, B, H, _mask_2d(mask, T, B, xp.device)


def _barrier(device):
    """The grid barrier's arrival counter, zeroed for each launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def gru_scan_fwd(xp, wh, mask, reverse=False):
    """K5: ys (T, B, H) f32 from xp (T, B, 3H), wh (H, 3H), mask (T, B, 1)."""
    if xp.device.type == "cpu":
        return gru_scan_plain(xp, wh, mask, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_scan_fwd: unsupported device {xp.device}")
    T, B, H, mask2 = _check_scan(xp, wh, mask)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=xp.device)
    if ys.numel() == 0:
        return ys
    fn = _build.lib().tpuasr_gru_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bar = _barrier(xp.device)
    with torch.cuda.device(xp.device):
        code = fn(_build.ptr(xp), _build.ptr(wh), _build.ptr(mask2),
                  _build.ptr(ys), _build.ptr(bar), T, B, H,
                  int(bool(reverse)), _build.stream_ptr(xp))
    gru_scan_fwd.launches += 1
    _build.check(code, "gru_scan_fwd")
    return ys


gru_scan_fwd.launches = 0


def gru_scan_bwd(xp, ysp, wh, mask, dys, reverse=False):
    """K5b: (dxp (T, B, 3H), dwh (H, 3H)) f32 from xp, ysp = prev_states(ys),
    wh, mask (T, B, 1) and dys (T, B, H); dWh is summed inside the kernel."""
    if xp.device.type == "cpu":
        return gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: unsupported device {xp.device}")
    T, B, H, mask2 = _check_scan(xp, wh, mask)
    f32 = (torch.float32,)
    _build.check_tensor("ysp", ysp, xp.device, f32, (T, B, H))
    _build.check_tensor("dys", dys, xp.device, f32, (T, B, H))
    dxp = torch.empty_like(xp)
    if xp.numel() == 0:
        return dxp, torch.zeros_like(wh)
    dwh = torch.empty_like(wh)
    scratch = torch.empty((2, B, 3 * H), dtype=torch.float32,
                          device=xp.device)
    fn = _build.lib().tpuasr_gru_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bar = _barrier(xp.device)
    with torch.cuda.device(xp.device):
        code = fn(_build.ptr(xp), _build.ptr(ysp), _build.ptr(wh),
                  _build.ptr(mask2), _build.ptr(dys), _build.ptr(dxp),
                  _build.ptr(dwh), _build.ptr(scratch), _build.ptr(bar), T,
                  B, H, int(bool(reverse)), _build.stream_ptr(xp))
    gru_scan_bwd.launches += 1
    _build.check(code, "gru_scan_bwd")
    return dxp, dwh


gru_scan_bwd.launches = 0


class _GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, wh, mask, reverse):
        ys = gru_scan_fwd(xp, wh, mask, reverse)
        ctx.save_for_backward(xp, wh, mask, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, wh, mask, ys = ctx.saved_tensors
        dxp, dwh = gru_scan_bwd(xp, prev_states(ys, ctx.reverse), wh, mask,
                                dys.contiguous(), ctx.reverse)
        return dxp, dwh, None, None


def gru_scan(xp, wh, mask, reverse=False):
    """Masked GRU over time, differentiable: xp (T, B, 3H) f32, wh (H, 3H)
    f32, mask (T, B, 1) -> ys (T, B, H). K5 forward, K5b backward (the plain
    versions for CPU tensors). reverse=True is the right-to-left GRU on
    left-aligned ragged rows, as in JAX."""
    return _GRUScan.apply(xp.contiguous(), wh.contiguous(), mask, reverse)


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
    _build.check_tensor("x", x, x.device, (torch.float32, torch.bfloat16),
                        (T, B, D))
    _build.check_tensor("wxq", wxq, x.device, (torch.int8,), (D, 3 * H))
    _build.check_tensor("sw", sw, x.device, (torch.float32,), (3 * H,))
    _build.check_tensor("b", b, x.device, (torch.float32,), (3 * H,))
    _build.check_tensor("wh", wh, x.device,
                        (torch.int8,) if rec_q8 else (x.dtype,), (H, 3 * H))
    if rec_q8:
        _build.check_tensor("wh_scale", wh_scale, x.device,
                            (torch.float32,), (3 * H,))
    mask = _mask_2d(mask, T, B, x.device)
    wh_arg = _pack_int8(wh) if rec_q8 else _pack_float(wh)
    code, ys = _launch(_MODE_Q8_REC if rec_q8 else _MODE_Q8, x,
                       _pack_int8(wxq), b, wh_arg, sw, wh_scale, mask,
                       reverse, H)
    gru_scan_xfused_q8.launches += 1
    _build.check(code, "gru_scan_xfused_q8")
    return ys


gru_scan_xfused_q8.launches = 0
