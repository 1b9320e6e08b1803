"""Capsule dynamic routing (K8 forward): kernel, plain version, wrapper.

Counterpart of ``tpuasr/ops/pallas_routing.py::routed_caps`` (forward).
``routed_caps`` launches the CUDA kernel of ``csrc/routing.cu`` for CUDA
tensors: it computes u_hat = u . W inside the kernel, never stores it, and
runs every routing iteration and the squash there. For CPU tensors it runs
``routed_caps_plain``, the einsum + ``dynamic_routing`` that CapsNetCTC
takes without ``pallas_routing`` (tpuasr/models/capsnet.py:99-103). The
Pallas padding of I and of the rows to 128 served TPU tiles; the kernel
takes any I and any O*D as they are.
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


def max_classes(class_dim: int) -> int:
    """The largest num_classes the kernel takes at this class_dim (its
    threads per block cover the classes; 128 at class_dim 16)."""
    g = -(-class_dim // 4)
    gp = 1 << (g - 1).bit_length()
    return 0 if gp > 32 else 512 // gp


def routed_caps(u, W, num_classes: int, class_dim: int,
                num_iters: int = 3) -> torch.Tensor:
    """Fused u_hat + routing: u (B, T, I, Din) f32, W (I, Din, O*D) f32 ->
    v (B, T, O, D) f32, equal to ``routed_caps_plain`` up to float32
    summation order. CPU tensors take the plain version; CUDA tensors
    launch the kernel (forward only: the backward, K8b, is not ported)."""
    if u.device.type == "cpu":
        return routed_caps_plain(u, W, num_classes, class_dim, num_iters)
    if u.device.type != "cuda":
        raise ValueError(f"routed_caps: unsupported device {u.device}")
    if torch.is_grad_enabled() and (u.requires_grad or W.requires_grad):
        raise NotImplementedError(
            "routed_caps has no backward in tpuasr_torch yet (K8b is the "
            "next slice, CapsNet training); call it under torch.no_grad()")
    if u.ndim != 4:
        raise ValueError(f"routed_caps: u must be (B, T, I, Din), got "
                         f"{tuple(u.shape)}")
    B, T, I, Din = u.shape
    O, D = int(num_classes), int(class_dim)
    if num_iters < 1:
        raise ValueError(f"routed_caps: num_iters must be >= 1, got "
                         f"{num_iters}")
    if not 1 <= Din <= _MAX_DIN or I < 1 or O < 1 or D < 1:
        raise ValueError(f"routed_caps: needs I >= 1, 1 <= Din <= "
                         f"{_MAX_DIN}, O >= 1, D >= 1 (got I={I}, "
                         f"Din={Din}, O={O}, D={D})")
    if O > max_classes(D):
        raise ValueError(f"routed_caps: the kernel takes at most "
                         f"{max_classes(D)} classes at class_dim {D} (got "
                         f"{O})")
    f32 = (torch.float32,)
    _build.check_tensor("routed_caps: u", u, u.device, f32, (B, T, I, Din))
    _build.check_tensor("routed_caps: W", W, u.device, f32, (I, Din, O * D))
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


routed_caps.launches = 0
