"""Capsule dynamic routing, forward (K8) and backward (K8b): kernels,
plain versions, wrappers.

Counterpart of ``tpuasr/ops/pallas_routing.py::routed_caps`` and its custom
VJP. ``routed_caps`` launches the CUDA kernel of ``csrc/routing.cu`` for
CUDA tensors: it computes u_hat = u . W inside the kernel, never stores it,
and runs every routing iteration and the squash there. Under autograd it is
a ``torch.autograd.Function`` that saves u and W only and whose backward is
``routed_caps_bwd`` (K8b, ``csrc/routing_bwd.cu``), which recomputes u_hat
and the routing. For CPU tensors both take their plain versions:
``routed_caps_plain``, the einsum + ``dynamic_routing`` that CapsNetCTC
takes without ``pallas_routing`` (tpuasr/models/capsnet.py:99-103), through
autograd, and ``routed_caps_bwd_plain``, the analytic gradient of the Pallas
backward written in torch ops. The Pallas padding of I and of the rows to
128 served TPU tiles; the kernels take any I and any O*D as they are.
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build

_EPS = 1e-8
_MAX_DIN = 16


def squash(s: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """v = |s|^2 / (1 + |s|^2) * s / |s| in float32, cast back to s's
    dtype (tpuasr/models/capsnet.py:23-28)."""
    s32 = s.to(torch.float32)
    sq = torch.sum(s32 * s32, dim=dim, keepdim=True)
    scale = sq / (1.0 + sq) * torch.rsqrt(sq + eps)
    return (scale * s32).to(s.dtype)


def dynamic_routing(u_hat: torch.Tensor, num_iters: int = 3) -> torch.Tensor:
    """Routing by agreement (tpuasr/models/capsnet.py:31-52).

    u_hat (..., N_in, N_out, D_out) -> v (..., N_out, D_out). The first
    ``num_iters - 1`` iterations run on u_hat detached, the last one on
    u_hat itself, so a gradient flows only through the final sum and
    squash, as in JAX.
    """
    u32 = u_hat.to(torch.float32)
    u_stop = u32.detach()
    b = torch.zeros(u_hat.shape[:-1], dtype=torch.float32,
                    device=u_hat.device)
    for _ in range(num_iters - 1):
        c = torch.softmax(b, dim=-1)                  # over N_out
        v = squash(torch.sum(c[..., None] * u_stop, dim=-3))
        b = b + torch.sum(u_stop * v[..., None, :, :], dim=-1)
    c = torch.softmax(b, dim=-1)
    return squash(torch.sum(c[..., None] * u32, dim=-3))


def routed_caps_plain(u, W, num_classes: int, class_dim: int,
                      num_iters: int = 3) -> torch.Tensor:
    """Plain version of K8: u (B, T, I, Din), W (I, Din, O*D) -> v
    (B, T, O, D), as the einsum + ``dynamic_routing`` of CapsNetCTC."""
    B, T, I, _ = u.shape
    u_hat = torch.einsum("btid,idk->btik", u.to(torch.float32),
                         W.to(torch.float32))
    u_hat = u_hat.reshape(B, T, I, num_classes, class_dim)
    return dynamic_routing(u_hat, num_iters)


def routed_caps_bwd_plain(u, W, dv, num_classes: int, class_dim: int,
                          num_iters: int = 3):
    """Plain version of K8b: the gradient (du (B, T, I, Din), dW (I, Din,
    O*D)) of ``routed_caps_plain`` at (u, W) for the output gradient dv
    (B, T, O, D), as the Pallas backward computes it
    (tpuasr/ops/pallas_routing.py:114-156): recompute u_hat and the
    routing to the final coupling c and sum s; the squash VJP on s,
    ds = g dv + 2 (s . dv) g'(a) s with a = |s|^2, g and g' as at
    pallas_routing.py:136-143; du_hat = c ds (c carries no gradient: the
    iterations before the last run on stop_gradient(u_hat)); pulled back
    through u_hat = u . W to du and dW."""
    B, T, I, Din = u.shape
    O, D = num_classes, class_dim
    u32, W32 = u.to(torch.float32), W.to(torch.float32)
    u_hat = torch.einsum("btid,idk->btik", u32, W32).reshape(B, T, I, O, D)
    b = torch.zeros((B, T, I, O), dtype=torch.float32, device=u.device)
    for _ in range(num_iters - 1):
        c = torch.softmax(b, dim=-1)
        v = squash(torch.sum(c[..., None] * u_hat, dim=-3))
        b = b + torch.sum(u_hat * v[..., None, :, :], dim=-1)
    c = torch.softmax(b, dim=-1)                          # (B, T, I, O)
    s = torch.sum(c[..., None] * u_hat, dim=-3)           # (B, T, O, D)
    del u_hat, b
    dv = dv.to(torch.float32)
    a = torch.sum(s * s, dim=-1, keepdim=True)
    inv_sq = torch.rsqrt(a + _EPS)
    g = a / (1.0 + a) * inv_sq
    gp = (1.0 / ((1.0 + a) * (1.0 + a))) * inv_sq \
        - 0.5 * a / (1.0 + a) * inv_sq / (a + _EPS)
    dot = torch.sum(s * dv, dim=-1, keepdim=True)
    ds = g * dv + 2.0 * dot * gp * s
    du_hat = (c[..., None] * ds[:, :, None]).reshape(B, T, I, O * D)
    du = torch.einsum("btik,idk->btid", du_hat, W32)
    dW = torch.einsum("btid,btik->idk", u32, du_hat)
    return du, dW


def max_classes(class_dim: int) -> int:
    """The largest num_classes the kernel takes at this class_dim (its
    threads per block cover the classes; 128 at class_dim 16)."""
    g = -(-class_dim // 4)
    gp = 1 << (g - 1).bit_length()
    return 0 if gp > 32 else 512 // gp


def _check_routing(name, u, W, O, D, num_iters):
    """The shapes the kernels take, checked before any launch; -> (B, T,
    I, Din)."""
    if u.ndim != 4:
        raise ValueError(f"{name}: u must be (B, T, I, Din), got "
                         f"{tuple(u.shape)}")
    B, T, I, Din = u.shape
    if num_iters < 1:
        raise ValueError(f"{name}: num_iters must be >= 1, got {num_iters}")
    if not 1 <= Din <= _MAX_DIN or I < 1 or O < 1 or D < 1:
        raise ValueError(f"{name}: needs I >= 1, 1 <= Din <= {_MAX_DIN}, "
                         f"O >= 1, D >= 1 (got I={I}, Din={Din}, O={O}, "
                         f"D={D})")
    if O > max_classes(D):
        raise ValueError(f"{name}: the kernel takes at most "
                         f"{max_classes(D)} classes at class_dim {D} (got "
                         f"{O})")
    f32 = (torch.float32,)
    _build.check_tensor(f"{name}: u", u, u.device, f32, (B, T, I, Din))
    _build.check_tensor(f"{name}: W", W, u.device, f32, (I, Din, O * D))
    return B, T, I, Din


def _routed_caps_kernel(u, W, O, D, num_iters):
    """K8's launch: v (B, T, O, D) for checked CUDA tensors."""
    B, T, I, Din = u.shape
    v = torch.empty((B, T, O, D), dtype=torch.float32, device=u.device)
    if v.numel() == 0:
        return v
    fn = _build.lib().tpuasr_routing_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(u.device):
        code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(v), B * T, I, Din,
                  O, D, int(num_iters), _build.stream_ptr(u))
    routed_caps.launches += 1
    _build.check(code, "routed_caps")
    return v


class _RoutedCaps(torch.autograd.Function):
    """K8 forward, K8b backward; saves u and W only (the backward
    recomputes u_hat and the routing, as the Pallas VJP does)."""

    @staticmethod
    def forward(ctx, u, W, O, D, num_iters):
        ctx.save_for_backward(u, W)
        ctx.cfg = (O, D, num_iters)
        return _routed_caps_kernel(u, W, O, D, num_iters)

    @staticmethod
    def backward(ctx, dv):
        u, W = ctx.saved_tensors
        du, dW = routed_caps_bwd(u, W, dv.contiguous(), *ctx.cfg)
        return du, dW, None, None, None


def routed_caps(u, W, num_classes: int, class_dim: int,
                num_iters: int = 3) -> torch.Tensor:
    """Fused u_hat + routing: u (B, T, I, Din) f32, W (I, Din, O*D) f32 ->
    v (B, T, O, D) f32, equal to ``routed_caps_plain`` up to float32
    summation order. CPU tensors take the plain version (gradients by
    autograd); CUDA tensors launch K8, and where a gradient is needed its
    backward launches K8b."""
    if u.device.type == "cpu":
        return routed_caps_plain(u, W, num_classes, class_dim, num_iters)
    if u.device.type != "cuda":
        raise ValueError(f"routed_caps: unsupported device {u.device}")
    O, D = int(num_classes), int(class_dim)
    _check_routing("routed_caps", u, W, O, D, num_iters)
    if torch.is_grad_enabled() and (u.requires_grad or W.requires_grad):
        return _RoutedCaps.apply(u, W, O, D, int(num_iters))
    return _routed_caps_kernel(u, W, O, D, num_iters)


routed_caps.launches = 0


def routed_caps_bwd(u, W, dv, num_classes: int, class_dim: int,
                    num_iters: int = 3):
    """K8b: the gradient (du, dW) of ``routed_caps`` at (u, W) for the
    output gradient dv (B, T, O, D) f32, equal to ``routed_caps_bwd_plain``
    up to float32 summation order. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes what K8 takes."""
    if u.device.type == "cpu":
        return routed_caps_bwd_plain(u, W, dv, num_classes, class_dim,
                                     num_iters)
    if u.device.type != "cuda":
        raise ValueError(f"routed_caps_bwd: unsupported device {u.device}")
    O, D = int(num_classes), int(class_dim)
    B, T, I, Din = _check_routing("routed_caps_bwd", u, W, O, D, num_iters)
    _build.check_tensor("routed_caps_bwd: dv", dv, u.device,
                        (torch.float32,), (B, T, O, D))
    R = B * T
    du = torch.empty_like(u)
    dW = torch.empty_like(W)
    if R == 0:
        return du, dW.zero_()
    # Scratch: each row's V = v_0 + ... + v_{iters-2} and ds (pass 1), and
    # per-chunk partial sums of dW where the rows are split (pass 2).
    V = torch.empty((R, O, D), dtype=torch.float32, device=u.device)
    ds = torch.empty_like(V)
    nch = _row_chunks(R, I, u.device)
    part = (torch.empty((nch, I, Din, O * D), dtype=torch.float32,
                        device=u.device) if nch > 1 else dW)
    fn = _build.lib().tpuasr_routing_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(u.device):
        code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(dv),
                  _build.ptr(V), _build.ptr(ds), _build.ptr(du),
                  _build.ptr(dW), _build.ptr(part), R, I, Din, O, D,
                  int(num_iters), nch, _build.stream_ptr(u))
    routed_caps_bwd.launches += 1
    _build.check(code, "routed_caps_bwd")
    return du, dW


routed_caps_bwd.launches = 0


def _row_chunks(R: int, I: int, device) -> int:
    """How many chunks of rows K8b's second pass splits the rows into: a
    block takes one capsule i and one chunk, so enough chunks that the I x
    chunks blocks cover the card's SMs twice, each chunk at least 32
    rows. Each chunk's partial dW is summed in chunk order afterwards (the
    same sums on every run)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-2 * sms // I), -(-R // 32)))
