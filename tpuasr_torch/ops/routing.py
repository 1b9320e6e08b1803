"""Capsule dynamic routing, forward (K8) and backward (K8b): kernels,
plain versions, wrappers.

Counterpart of ``tpuasr/ops/pallas_routing.py::routed_caps`` and its custom
VJP. ``routed_caps`` launches the CUDA kernel of ``csrc/routing.cu`` for
CUDA tensors: a cluster of CTAs splits each tile of rows' capsules, computes
u_hat = u . W inside the kernel, never stores it, and runs every routing
iteration and the squash there (``routing_plan`` sizes the launch). Under
autograd it is a ``torch.autograd.Function`` whose forward runs K8 in its
saving mode, which also writes each row's V = v_0 + ... + v_{iters-2} and
final s, and whose backward is K8b (``csrc/routing_bwd.cu``) from those:
``routed_caps_bwd_from``. The Pallas VJP saves u and W only and recomputes
the routing; given V, the final coupling is softmax(u_hat . V), so nothing
reruns it here. ``routed_caps_bwd`` is the same two launches from (u, W,
dv). For CPU tensors each takes its plain version: ``routed_caps_plain``,
the einsum + ``dynamic_routing`` that CapsNetCTC takes without
``pallas_routing`` (tpuasr/models/capsnet.py:99-103), through autograd;
``routed_caps_bwd_plain``, the analytic gradient of the Pallas backward
written in torch ops; and its split along the kernels' seam,
``routing_residuals_plain`` and ``routed_caps_bwd_from_plain``. The Pallas
padding of I and of the rows to 128 served TPU tiles; the kernels take any
I and any O*D as they are.
"""

from __future__ import annotations

import ctypes
import dataclasses

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


def routing_residuals_plain(u, W, num_classes: int, class_dim: int,
                            num_iters: int = 3):
    """Plain version of what K8's saving mode keeps for the backward: each
    row's V = v_0 + ... + v_{iters-2} (zeros for one iteration) and final
    sum s, (B, T, O, D) each."""
    B, T, I, _ = u.shape
    O, D = num_classes, class_dim
    u_hat = torch.einsum("btid,idk->btik", u.to(torch.float32),
                         W.to(torch.float32)).reshape(B, T, I, O, D)
    b = torch.zeros((B, T, I, O), dtype=torch.float32, device=u.device)
    V = torch.zeros((B, T, O, D), dtype=torch.float32, device=u.device)
    for _ in range(num_iters - 1):
        c = torch.softmax(b, dim=-1)
        v = squash(torch.sum(c[..., None] * u_hat, dim=-3))
        V = V + v
        b = b + torch.sum(u_hat * v[..., None, :, :], dim=-1)
    c = torch.softmax(b, dim=-1)
    return V, torch.sum(c[..., None] * u_hat, dim=-3)


def routed_caps_bwd_from_plain(u, W, V, s, dv, num_classes: int,
                               class_dim: int):
    """Plain version of K8b: the gradient (du, dW) of the routing from the
    saved V and s (``routing_residuals_plain``) for the output gradient dv:
    the final coupling c = softmax_o(u_hat . V) (K8's identity b = sum_d
    u_hat V), the squash VJP ds on s, du_hat = c ds pulled back through
    u_hat = u . W."""
    B, T, I, Din = u.shape
    O, D = num_classes, class_dim
    u32, W32 = u.to(torch.float32), W.to(torch.float32)
    u_hat = torch.einsum("btid,idk->btik", u32, W32).reshape(B, T, I, O, D)
    c = torch.softmax(torch.sum(u_hat * V[..., None, :, :], dim=-1), dim=-1)
    del u_hat
    s, dv = s.to(torch.float32), dv.to(torch.float32)
    a = torch.sum(s * s, dim=-1, keepdim=True)
    inv_sq = torch.rsqrt(a + _EPS)
    g = a / (1.0 + a) * inv_sq
    gp = (1.0 / ((1.0 + a) * (1.0 + a))) * inv_sq \
        - 0.5 * a / (1.0 + a) * inv_sq / (a + _EPS)
    ds = g * dv + 2.0 * torch.sum(s * dv, dim=-1, keepdim=True) * gp * s
    du_hat = (c[..., None] * ds[:, :, None]).reshape(B, T, I, O * D)
    du = torch.einsum("btik,idk->btid", du_hat, W32)
    dW = torch.einsum("btid,btik->idk", u32, du_hat)
    return du, dW


def max_classes(class_dim: int) -> int:
    """The largest num_classes the kernels take at this class_dim (their
    threads cover the classes; 128 at class_dim 16)."""
    g = -(-class_dim // 4)
    gp = 1 << (g - 1).bit_length()
    return 0 if gp > 32 else 512 // gp


# K8's launch (csrc/routing.cu): clusters of _CLUSTER CTAs, each CTA at most
# _SMEM_MAX bytes of shared memory, at most _MAX_STAGES ring stages, rows in
# groups of _ROWS; a CTA's threads are its row groups' class threads and a
# producer warp, at most _THREADS (W staged) or _WIDE_THREADS (W from L2).
# Clusters of 2: an H100 holds 66 of them at once (every SM), but only 15
# clusters of 8 or 30 of 4 (120 SMs); `tools/routing_parts.py --clusters`
# times each size (PERF.md §6).
_CLUSTER = 2
_SMEM_MAX = 232448
_MAX_STAGES = 6
_ROWS = 8
_THREADS = 416
_WIDE_THREADS = 544


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """K8's launch for R rows: ``tiles`` clusters of _CLUSTER CTAs, each
    tile ``rows`` = ``row_groups`` x 8 rows; a CTA has ``threads`` threads
    (one of them a producer warp), ``stages`` ring stages and ``smem``
    bytes of shared memory; ``wide``: W read from L2, not staged."""

    tiles: int
    cluster: int
    rows: int
    row_groups: int
    stages: int
    wide: bool
    threads: int
    smem: int

    def capsules(self, I: int, rank: int) -> range:
        """The capsules CTA ``rank`` of a cluster routes."""
        c = self.cluster
        return range(I * rank // c, I * (rank + 1) // c)

    def classes(self, O: int, rank: int) -> range:
        """The classes CTA ``rank`` sums over the cluster and squashes."""
        c = self.cluster
        return range(O * rank // c, O * (rank + 1) // c)


def _class_lanes(D: int) -> int:
    """Threads a class (Gp): next_pow2(ceil(D / 4))."""
    return 1 << (-(-D // 4) - 1).bit_length()


def routing_smem(Din: int, O: int, D: int, cluster: int, row_groups: int,
                 stages: int, wide: bool) -> int:
    """Shared memory of one K8 CTA in bytes, as ``tpuasr_routing_smem``
    lays it out: 8 bytes for each of 2 * stages mbarriers (to a multiple
    of 16), then floats: V [Rc][O][Dp], the CTA's slice of V
    [Rc][ceil(O/C)][Dp], parked u_hat [Rc][O][Dp], b/c [3][Rc][O] (to a
    multiple of 4), and a stage each of W's capsule slab (Din*O*D, to a
    multiple of 4; none when ``wide``) and u [Rc][Dinp]."""
    def up4(n):
        return -(-n // 4) * 4
    rc = _ROWS * row_groups
    dp = 4 * _class_lanes(D)
    floats = (2 * rc * O * dp + rc * -(-O // cluster) * dp + up4(3 * rc * O)
              + stages * ((0 if wide else up4(Din * O * D)) + rc * up4(Din)))
    return -(-8 * 2 * stages // 16) * 16 + 4 * floats


def routing_plan(R: int, I: int, Din: int, O: int, D: int) -> RoutingPlan:
    """K8's launch plan: W staged, with the most row groups (of 8 rows)
    that the staged instance's threads hold and the rows need and at least
    two ring stages; else W read from L2 (wide shapes, more than 384 class
    threads or no room for two stages). Raises
    ValueError for shapes K8 does not take."""
    if not 1 <= Din <= _MAX_DIN or O < 1 or D < 1 or I < 1 or R < 0:
        raise ValueError(f"routing_plan: no plan for R={R}, I={I}, "
                         f"Din={Din}, O={O}, D={D}")
    gp = _class_lanes(D)
    col = -(-O * gp // 32) * 32
    if gp > 32 or col > _WIDE_THREADS - 32:
        raise ValueError(f"routing_plan: O={O} classes of D={D} need "
                         f"{col} threads, more than 512")
    for wide, limit, need in ((False, _THREADS, 2),
                              (True, _WIDE_THREADS, 1)):
        if col > limit - 32:
            continue
        top = min((limit - 32) // col, max(1, -(-R // _ROWS)))
        for rg in range(top, 0, -1):
            for stages in range(_MAX_STAGES, need - 1, -1):
                smem = routing_smem(Din, O, D, _CLUSTER, rg, stages, wide)
                if smem <= _SMEM_MAX:
                    return RoutingPlan(
                        tiles=-(-R // (_ROWS * rg)), cluster=_CLUSTER,
                        rows=_ROWS * rg, row_groups=rg, stages=stages,
                        wide=wide, threads=rg * col + 32, smem=smem)
    raise ValueError(f"routing_plan: no plan fits Din={Din}, O={O}, D={D}")


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


def _routed_caps_kernel(u, W, O, D, num_iters, save=False):
    """K8's launch for checked CUDA tensors: v (B, T, O, D), or with save
    (v, V, s), V and s as ``routing_residuals_plain`` gives them."""
    B, T, I, Din = u.shape
    R = B * T
    v = torch.empty((B, T, O, D), dtype=torch.float32, device=u.device)
    V = torch.empty_like(v) if save else None
    s = torch.empty_like(v) if save else None
    if R > 0:
        plan = routing_plan(R, I, Din, O, D)
        fn = _build.lib().tpuasr_routing_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(u.device):
            code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(v),
                      _build.ptr(V) if save else None,
                      _build.ptr(s) if save else None, R, I, Din, O, D,
                      int(num_iters), plan.cluster, plan.row_groups,
                      plan.stages, int(plan.wide), plan.smem,
                      _build.stream_ptr(u))
        routed_caps.launches += 1
        _build.check(code, "routed_caps")
    return (v, V, s) if save else v


def max_active_clusters(R: int, I: int, Din: int, O: int, D: int) -> int:
    """How many of K8's clusters the card holds at once for this shape
    (cudaOccupancyMaxActiveClusters of routing_plan's launch)."""
    plan = routing_plan(max(R, 1), I, Din, O, D)
    fn = _build.lib().tpuasr_routing_max_clusters
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    code = fn(I, Din, O, D, plan.cluster, plan.row_groups, plan.stages,
              int(plan.wide), plan.smem, ctypes.byref(out))
    _build.check(code, "max_active_clusters")
    return out.value


class _RoutedCaps(torch.autograd.Function):
    """K8 forward in its saving mode, K8b backward from u, W and the saved
    V and s (nothing reruns the routing)."""

    @staticmethod
    def forward(ctx, u, W, O, D, num_iters):
        v, V, s = _routed_caps_kernel(u, W, O, D, num_iters, save=True)
        ctx.save_for_backward(u, W, V, s)
        ctx.cfg = (O, D)
        return v

    @staticmethod
    def backward(ctx, dv):
        u, W, V, s = ctx.saved_tensors
        du, dW = routed_caps_bwd_from(u, W, V, s, dv.contiguous(), *ctx.cfg)
        return du, dW, None, None, None


def routed_caps(u, W, num_classes: int, class_dim: int,
                num_iters: int = 3) -> torch.Tensor:
    """Fused u_hat + routing: u (B, T, I, Din) f32, W (I, Din, O*D) f32 ->
    v (B, T, O, D) f32, equal to ``routed_caps_plain`` up to float32
    summation order. CPU tensors take the plain version (gradients by
    autograd); CUDA tensors launch K8, and where a gradient is needed K8
    saves V and s and its backward launches K8b."""
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


def routing_residuals(u, W, num_classes: int, class_dim: int,
                      num_iters: int = 3):
    """(v, V, s): K8 in its saving mode for CUDA tensors (one launch,
    counted as K8's), ``routed_caps_plain`` and ``routing_residuals_plain``
    for CPU tensors."""
    O, D = int(num_classes), int(class_dim)
    if u.device.type == "cpu":
        return (routed_caps_plain(u, W, O, D, num_iters),
                *routing_residuals_plain(u, W, O, D, num_iters))
    if u.device.type != "cuda":
        raise ValueError(f"routing_residuals: unsupported device {u.device}")
    _check_routing("routing_residuals", u, W, O, D, num_iters)
    with torch.no_grad():
        return _routed_caps_kernel(u, W, O, D, num_iters, save=True)


def routed_caps_bwd_from(u, W, V, s, dv, num_classes: int, class_dim: int):
    """K8b: the gradient (du, dW) of ``routed_caps`` at (u, W) for the
    output gradient dv (B, T, O, D) f32, from K8's saved V and s, equal to
    ``routed_caps_bwd_from_plain`` up to float32 summation order. CPU
    tensors take the plain version; CUDA tensors launch the kernels, which
    take what K8 takes."""
    O, D = int(num_classes), int(class_dim)
    if u.device.type == "cpu":
        return routed_caps_bwd_from_plain(u, W, V, s, dv, O, D)
    if u.device.type != "cuda":
        raise ValueError(f"routed_caps_bwd: unsupported device {u.device}")
    B, T, I, Din = _check_routing("routed_caps_bwd", u, W, O, D, 1)
    for name, t in (("V", V), ("s", s), ("dv", dv)):
        _build.check_tensor(f"routed_caps_bwd: {name}", t, u.device,
                            (torch.float32,), (B, T, O, D))
    R = B * T
    du = torch.empty_like(u)
    dW = torch.empty_like(W)
    if R == 0:
        return du, dW.zero_()
    # Scratch: ds (R, O, D), and per-chunk partial sums of dW where the rows
    # are split.
    ds = torch.empty_like(dv)
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    nch = _row_chunks(R, I, sms)
    part = (torch.empty((nch, I, Din, O * D), dtype=torch.float32,
                        device=u.device) if nch > 1 else dW)
    fn = _build.lib().tpuasr_routing_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(u.device):
        code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(V), _build.ptr(s),
                  _build.ptr(dv), _build.ptr(ds), _build.ptr(du),
                  _build.ptr(dW), _build.ptr(part), R, I, Din, O, D, nch,
                  _build.stream_ptr(u))
    routed_caps_bwd.launches += 1
    _build.check(code, "routed_caps_bwd")
    return du, dW


def routed_caps_bwd(u, W, dv, num_classes: int, class_dim: int,
                    num_iters: int = 3):
    """The gradient (du, dW) of ``routed_caps`` at (u, W) for the output
    gradient dv (B, T, O, D) f32. CPU tensors take
    ``routed_caps_bwd_plain``; CUDA tensors launch K8 in its saving mode
    and then K8b from its V and s, the same kernels and bits as autograd
    through ``routed_caps``."""
    if u.device.type == "cpu":
        return routed_caps_bwd_plain(u, W, dv, num_classes, class_dim,
                                     num_iters)
    if u.device.type != "cuda":
        raise ValueError(f"routed_caps_bwd: unsupported device {u.device}")
    O, D = int(num_classes), int(class_dim)
    B, T, _, _ = _check_routing("routed_caps_bwd", u, W, O, D, num_iters)
    _build.check_tensor("routed_caps_bwd: dv", dv, u.device,
                        (torch.float32,), (B, T, O, D))
    _, V, s = routing_residuals(u, W, O, D, num_iters)
    return routed_caps_bwd_from(u, W, V, s, dv, O, D)


routed_caps_bwd.launches = 0


def _row_chunks(R: int, I: int, sms: int) -> int:
    """How many chunks of rows K8b's second pass splits the rows into: a
    block takes one capsule i and one chunk, so enough chunks that the I x
    chunks blocks fill the card's SMs about six blocks deep, no more chunks
    than tiles of 16 rows. Each chunk's partial dW is summed in chunk order
    afterwards
    (the same sums on every run)."""
    return max(1, min(-(-6 * sms // I), -(-R // 16)))
