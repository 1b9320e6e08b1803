"""GRU scans: over precomputed projections with BPTT, and fused-projection.

Counterparts of tpuasr/ops/pallas_gru.py:

* ``gru_scan`` (K5 forward, K5b backward; pallas_gru.py:238): the masked
  recurrence over xp = x@Wx+b, differentiable. Its kernels are
  ``gru_scan_fwd`` and ``gru_scan_bwd`` (``csrc/gru_bptt.cu``);
* ``gru_scan_xfused`` (K2, pallas_gru.py:772): the input projection fused
  with the scan (``csrc/gru_scan.cu``: a tiled projection launch, then the
  recurrence, planned by ``_scan_plan``). Its backward takes JAX's route
  (``_xf_bwd``, pallas_gru.py:829-835): where wx, dwx, wh and dwh fit JAX's
  11 MiB budget, the fully fused BPTT K2b (``gru_scan_xfused_bwd``,
  ``csrc/gru_xfb.cu``; pallas_gru.py:736), which never writes xp or dxp;
  elsewhere ``_xf_bwd_recompute`` (pallas_gru.py:891-926): xp recomputed by
  a matmul, K5b, then dx, dWx and db by matmuls;
* ``gru_scan_xfused_q8`` (K4, pallas_gru.py:1045): int8 projection, forward
  only;
* ``gru_scan_bidir`` (K7 forward, K7b backward; pallas_gru.py:501): both
  directions of a BiGRU over precomputed projections in one launch,
  differentiable in float32. Its kernels are ``gru_scan_bidir_fwd`` and
  ``gru_scan_bidir_bwd`` (``csrc/gru_bidir.cu``).

Every kernel wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors. Layouts follow the JAX package: x (T, B, D)
time-major, wx (D, 3H), wh (H, 3H), b (3H,), gate order r, z, n,
mask (T, B, 1).
"""

from __future__ import annotations

import ctypes
import dataclasses

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


# ---- K2 / K4: the plan, the weights' layouts and the two launches --------

# Dynamic shared memory a cooperative block may take (kSmemBudget in
# csrc/gru_coop.cuh; the H100 allows 227 KB).
_SMEM_BUDGET = 220 * 1024
_REC_THREADS = 512          # kThreads in csrc/gru_coop.cuh
_GATE_ITEMS = 2             # kGI in csrc/gru_scan.cu: (row, unit) a thread
_PROJ_TILE = 128            # rows and columns of a projection tile
_PROJ_STAGE = 64            # bytes of the contraction a projection stage
_K5_ROWS = 16               # kR in csrc/gru_coop.cuh: K5's staged rows


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How K2/K4 run a shape (``_scan_plan``). ``proj`` and ``rec`` are the
    projection's and the recurrence's arithmetic ("f32", "bf16", "int8");
    the recurrence runs ``grid`` blocks, ``rg`` row groups times
    ceil(H / U) groups of ``U`` hidden units, stages ``R`` batch rows a pass
    and takes ``smem`` bytes of shared memory a block; the projection's
    weights are padded to ``kp`` x ``np`` and the resident Wh columns to
    ``hk`` contraction indices. ``ndir`` is 2 for K7's bf16 forward, whose
    grid holds both directions' row groups and unit groups."""
    proj: str
    rec: str
    U: int
    R: int
    rg: int
    grid: int
    smem: int
    kp: int
    np: int
    hk: int
    ndir: int = 1


def _scan_plan(B: int, D: int, H: int, mode: int, dtype: torch.dtype,
               n_sm: int = 132, ndir: int = 1) -> ScanPlan:
    """The launch plan of K2 (mode ``_MODE_K2``) or K4 (``_MODE_Q8``,
    ``_MODE_Q8_REC``) at batch B, input width D, hidden width H, for x of
    ``dtype`` on a card of ``n_sm`` SMs; with ``ndir=2`` the recurrence of
    K7's bf16 forward (both directions in one grid; D is not used). Raises
    ValueError for a shape the kernels cannot hold: a recurrence grid that
    cannot be resident at one block an SM, or a block over the
    shared-memory budget.

    The recurrence's arithmetic follows Wh's type: f32 runs K5's forward
    (U = ceil(H / n_sm) rounded up to a power of two, 16 rows a pass); bf16
    and int8 run on the tensor cores, U = 8 or 16 units a block (24 or 48
    columns, whole n8 tiles), the rows split over as many row groups as the
    SMs left allow (``_rows_plan``): the U that leaves a block the fewest
    rows to stage each step, U = 8 on a tie."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {dtype}")
    f32 = dtype == torch.float32
    proj = "int8" if mode != _MODE_K2 else ("f32" if f32 else "bf16")
    rec = "int8" if mode == _MODE_Q8_REC else ("f32" if f32 else "bf16")
    if ndir not in (1, 2) or (ndir == 2 and rec != "bf16"):
        raise ValueError(f"the two-direction recurrence is K7's bf16 "
                         f"forward, not {rec} with ndir={ndir}")
    es = {"f32": 4, "bf16": 2, "int8": 1}[proj]
    kp = _round_up(D, 8) if proj == "f32" else _round_up(
        D, _PROJ_STAGE // es)
    np_ = _round_up(3 * H, _PROJ_TILE)
    if rec == "f32":
        U = 1
        while U * n_sm < H:
            U *= 2
        R, rg, hk = _K5_ROWS, 1, H
        smem = 16 * U * H + 4 * R * H + 4 * (_REC_THREADS // 32) * R * 3
        if U > 16 or smem > _SMEM_BUDGET:
            raise ValueError(
                f"K2's f32 recurrence cannot hold H={H} on {n_sm} SMs: "
                f"{U} units a block (at most 16), {smem} bytes of shared "
                f"memory (at most {_SMEM_BUDGET})")
    else:
        options = []
        for U in (8, 16):
            if ndir * -(-H // U) <= n_sm:
                R, rg, smem = _rows_plan(B, H, rec, U, n_sm, ndir)
                if smem <= _SMEM_BUDGET:     # the fewest rows a block first
                    options.append((-(-B // rg), U, R, rg, smem))
        if not options:
            raise ValueError(
                f"the tensor-core recurrence ({rec}, {ndir} direction(s)) "
                f"cannot hold H={H}: more than {n_sm} resident blocks of 16 "
                f"units, or more than {_SMEM_BUDGET} bytes of shared memory "
                f"a block")
        _, U, R, rg, smem = min(options)
        es = 2 if rec == "bf16" else 1
        hk = _round_up(H * es, 32) // es
    return ScanPlan(proj, rec, U, R, rg, ndir * rg * -(-H // U), smem, kp,
                    np_, hk, ndir)


def _rows_plan(B: int, H: int, rec: str, U: int, n_sm: int, ndir: int = 1):
    """(R, rg, smem) of the tensor-core recurrence at U units a block. Every
    block stages all rows of its row group each step, and the bytes an SM
    pulls from L2 bound the step, so the rows split over rg row groups, as
    many as fit beside the ndir * ceil(H / U) unit groups in n_sm blocks
    (no fewer than 16 rows a group); a pass stages R rows, a power of two
    from 16 to 128 with R * U <= 1024 (two (row, unit) gate items a
    thread), no more than a group needs, halved until the block fits the
    budget."""
    rg = max(1, min(n_sm // (ndir * -(-H // U)), -(-B // 16)))
    rows = -(-B // rg)
    r_max = min(128, _GATE_ITEMS * _REC_THREADS // U)
    R = 16
    while R < r_max and R < rows:
        R *= 2
    smem = _rec_smem(rec, H, U, R)
    while smem > _SMEM_BUDGET and R > 16:
        R //= 2
        smem = _rec_smem(rec, H, U, R)
    return R, rg, smem


def _rec_smem(rec: str, H: int, U: int, R: int) -> int:
    """Shared memory of the tensor-core recurrence a block
    (rec_smem_bytes in csrc/gru_scan.cu): Wh's 3U columns and the R-row
    operand tile, rows of round_up(H bytes, 32) + 16; the partial sums
    [256][3U]; and int8's row scales [R] (counted for bf16 too)."""
    es = 2 if rec == "bf16" else 1
    ld = _round_up(H * es, 32) + 16
    return (3 * U + R) * ld + 4 * 256 * 3 * U + 4 * R


def _rec_scratch(plan: ScanPlan, B: int, H: int, device) -> torch.Tensor:
    """The recurrence's scratch, in f32 words: each block's own (B, H)
    state (one a direction); for int8 then, each part 16-byte aligned, the
    rows' absmax (2, B), zeroed, and the quantized state (B, round_up(H,
    16)) int8; none for f32 (K5's forward exchanges the state through
    ys)."""
    if plan.rec == "bf16":
        return torch.empty((plan.ndir * B * H,), dtype=torch.float32,
                           device=device)
    if plan.rec == "int8":
        n = (_round_up(B * H, 4) + _round_up(2 * B, 4)
             + B * _round_up(H, 16) // 4)
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return torch.empty((1,), dtype=torch.float32, device=device)


def _pack_proj(w: torch.Tensor, plan: ScanPlan) -> torch.Tensor:
    """The projection's weights as its tiles read them, zero-padded: f32
    (D, N) -> (kp, np); bf16 and int8 (D, N) -> W^T (np, kp), contraction
    contiguous (the mma B operand)."""
    D, N = w.shape
    if plan.proj == "f32":
        out = w.new_zeros((plan.kp, plan.np))
        out[:D, :N] = w
    else:
        out = w.new_zeros((plan.np, plan.kp))
        out[:N, :D] = w.T
    return out


def _pack_rec(wh: torch.Tensor, plan: ScanPlan) -> torch.Tensor:
    """Wh (H, 3H) as the recurrence's blocks keep it in shared memory:
    (ceil(H / U), 3U, hk), unit group g's row q*U + u is Wh's column
    q*H + g*U + u (gate q, unit g*U + u), contraction contiguous, zero past
    H in both. f32 (K5's forward) takes Wh as it is."""
    if plan.rec == "f32":
        return wh
    H = wh.shape[0]
    U = plan.U
    G = -(-H // U)
    cols = wh.new_zeros((H, 3, G * U))
    cols[:, :, :H] = wh.reshape(H, 3, H)
    out = wh.new_zeros((G, 3 * U, plan.hk))
    out[:, :, :H] = cols.reshape(H, 3, G, U).permute(2, 1, 3, 0).reshape(
        G, 3 * U, H)
    return out


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_KINDS = {"f32": 0, "bf16": 1, "int8": 2}


def _ptr_or_null(t):
    return _build.ptr(t) if t is not None else ctypes.c_void_p(0)


def _project(plan: ScanPlan, x, wxp, b, sw=None):
    """The first launch: xp (T, B, 3H) f32 = x @ Wx + b (wxp from
    ``_pack_proj``; sw, the int8 weights' scales). The f32 and bf16 tiles
    read x's rows in 16-byte pieces: where they are not 16-byte aligned, x
    is copied first into zero-padded rows of kp values."""
    T, B, D = x.shape
    N = b.shape[0]
    M = T * B
    xp = torch.empty((T, B, N), dtype=torch.float32, device=x.device)
    xq = sx = None
    lda = D
    if plan.proj == "int8":
        xq = torch.empty((M, plan.kp), dtype=torch.int8, device=x.device)
        sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    elif x.data_ptr() % 16 or D * x.element_size() % 16:
        xa = x.new_zeros((M, plan.kp))
        xa[:, :D] = x.reshape(M, D)
        x, lda = xa, plan.kp
    fn = _build.lib().tpuasr_gru_proj
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_KINDS[plan.proj], int(x.dtype == torch.bfloat16),
                  _build.ptr(x), lda, _build.ptr(wxp), _build.ptr(b),
                  _ptr_or_null(sw), _ptr_or_null(xq), _ptr_or_null(sx),
                  _build.ptr(xp), M, D, N, plan.kp, plan.np,
                  _build.stream_ptr(x))
    _build.check(code, "gru_scan_xfused (projection)")
    return xp


def _recur(plan: ScanPlan, xp, whp, swh, mask2, reverse, out_dtype):
    """The second launch: ys (T, B, H) in ``out_dtype`` from xp, whp (from
    ``_pack_rec``), swh (rec_q8's scales) and mask2 (T, B)."""
    return _recur_dirs(plan, (xp,), (whp,), swh, mask2, reverse,
                       out_dtype)[0]


def _recur_dirs(plan: ScanPlan, xps, whps, swh, mask2, reverse, out_dtype):
    """The tensor-core recurrence over ``plan.ndir`` directions in one
    cooperative launch: one ys (T, B, H) in ``out_dtype`` for each xp
    (T, B, 3H), f32 or bf16, and its whp (from ``_pack_rec``), all under
    mask2 (T, B); a barrier counter for each (direction, row group)."""
    T, B, H3 = xps[0].shape
    H = H3 // 3
    if len(xps) != plan.ndir or len(whps) != plan.ndir:
        raise ValueError(f"{len(xps)} directions for a plan of {plan.ndir}")
    dev = xps[0].device
    ys = torch.empty((plan.ndir, T, B, H), dtype=out_dtype, device=dev)
    hbuf = _rec_scratch(plan, B, H, dev)
    fn = _build.lib().tpuasr_gru_rec
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bar = _barrier(dev, plan.ndir * plan.rg)
    # With one direction, its pointers stand for the second, unread.
    with torch.cuda.device(dev):
        code = fn(_KINDS[plan.rec], int(out_dtype == torch.bfloat16),
                  int(xps[0].dtype == torch.bfloat16),
                  _build.ptr(xps[0]), _build.ptr(xps[-1]),
                  _build.ptr(whps[0]), _build.ptr(whps[-1]),
                  _ptr_or_null(swh), _build.ptr(mask2), _build.ptr(ys[0]),
                  _build.ptr(ys[-1]), _build.ptr(hbuf), _build.ptr(bar), T,
                  B, H, int(bool(reverse)), plan.U, plan.R, plan.rg,
                  plan.ndir, plan.smem, _build.stream_ptr(xps[0]))
    _build.check(code, "gru recurrence")
    return tuple(ys)


def _launch(mode, x, wx, b, wh, sw, swh, mask2, reverse):
    """K2/K4 on CUDA tensors already checked: the plan (ValueError before
    any launch where the shape cannot be planned), then the projection and
    the recurrence."""
    T, B, D = x.shape
    H = wh.shape[0]
    plan = _scan_plan(B, D, H, mode, x.dtype, _sm_count(x.device))
    if T * B * H == 0:
        return torch.empty((T, B, H), dtype=x.dtype, device=x.device)
    xp = _project(plan, x, _pack_proj(wx, plan), b, sw)
    return _recur(plan, xp, _pack_rec(wh, plan), swh, mask2, reverse,
                  x.dtype)


def _mask_2d(mask, T, B, device):
    if tuple(mask.shape) not in ((T, B, 1), (T, B)):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{(T, B, 1)}")
    if mask.device != device or mask.dtype != torch.float32:
        raise ValueError("mask must be float32 on the device of x")
    return mask.reshape(T, B).contiguous()


def gru_scan_xfused(x, wx, b, wh, mask, reverse=False):
    """K2: masked GRU scan with its input projection. x (T, B, D) f32 or
    bf16, wx (D, 3H) and wh (H, 3H) in x's dtype, b (3H,) f32,
    mask (T, B, 1) f32 -> ys (T, B, H) in x's dtype. On CUDA, two launches
    (x@Wx+b for all frames, then the recurrence) that count as one; a shape
    that ``_scan_plan`` cannot hold raises ValueError before either.

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
    ys = _launch(_MODE_K2, x, wx, b, wh, None, None, mask, reverse)
    gru_scan_xfused.launches += 1
    return ys


gru_scan_xfused.launches = 0


# ---- K2b: the fully fused BPTT of the projection-fused scan ---------------

# JAX's rule for the backward of gru_scan_xfused (pallas_gru.py:636-648,
# :829-835): the fused kernel where its resident f32 weights and their
# accumulators fit 11 MiB, with D and H padded to 128; the recompute route
# elsewhere. The port keeps the rule as it is, so that it takes JAX's route.
_XFB_RESIDENT_BUDGET = 11 * 2 ** 20


def _xfb_resident_bytes(D: int, H: int) -> int:
    """wx + dwx + wh + dwh (+ b, db), all f32: JAX's measure of K2b."""
    return (2 * D * 3 * H + 2 * H * 3 * H + 2 * 3 * H) * 4


def xfused_bwd_is_fused(D: int, H: int) -> bool:
    """Whether JAX's ``_xf_bwd`` takes the fused K2b at input width D and
    hidden width H (otherwise ``_xf_bwd_recompute``)."""
    return (_xfb_resident_bytes(_round_up(D, 128), _round_up(H, 128))
            <= _XFB_RESIDENT_BUDGET)


def gru_scan_xfused_bwd_plain(x, ysp, wx, b, wh, mask, dys, reverse=False):
    """Plain version of K2b, step by step as ``_bwd_xf_kernel``
    (pallas_gru.py:661-727): xp = x[t]@Wx+b and hp = h_prev@Wh recomputed,
    the gates, dhp and dxp masked on padded steps, then dx[t] = dxp@Wx^T and
    the sums dWh, dWx and db. x (T, B, D), ysp = prev_states(ys) (T, B, H),
    wx (D, 3H), b (3H,), wh (H, 3H), mask (T, B, 1), dys (T, B, H)
    -> (dx (T, B, D), dwx (D, 3H), db (3H,), dwh (H, 3H)), f32."""
    T, B, D = x.shape
    H = wh.shape[0]
    m = mask.to(torch.float32).reshape(T, B, 1)
    wx32, wh32 = wx.to(torch.float32), wh.to(torch.float32)
    b32 = b.to(torch.float32)
    dh = x.new_zeros((B, H), dtype=torch.float32)
    dwh = x.new_zeros((H, 3 * H), dtype=torch.float32)
    dwx = x.new_zeros((D, 3 * H), dtype=torch.float32)
    db = x.new_zeros((3 * H,), dtype=torch.float32)
    dx = x.new_empty((T, B, D), dtype=torch.float32)
    with full_fp32():
        for t in (range(T) if reverse else range(T - 1, -1, -1)):
            xt = x[t].to(torch.float32)
            xp = xt @ wx32 + b32
            h_prev = ysp[t].to(torch.float32)
            hp = h_prev @ wh32
            r = torch.sigmoid(xp[:, :H] + hp[:, :H])
            z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])
            d = dys[t].to(torch.float32) + dh
            dz = d * (h_prev - n)
            dn = d * (1.0 - z) * (1.0 - n * n)
            dxr = dn * hp[:, 2 * H:] * r * (1.0 - r)
            dxz = dz * z * (1.0 - z)
            dhp = torch.cat([dxr, dxz, dn * r], dim=1) * m[t]
            dxp = torch.cat([dxr, dxz, dn], dim=1) * m[t]
            dh = m[t] * (d * z + dhp @ wh32.T) + (1.0 - m[t]) * d
            dwh += h_prev.T @ dhp
            dx[t] = dxp @ wx32.T
            dwx += xt.T @ dxp
            db += dxp.sum(0)
    return dx, dwx, db, dwh


def gru_scan_xfused_bwd(x, ysp, wx, b, wh, mask, dys, reverse=False):
    """K2b: (dx (T, B, D), dwx (D, 3H), db (3H,), dwh (H, 3H)) f32 from
    x (T, B, D), ysp = prev_states(ys) (T, B, H), wx (D, 3H), b (3H,),
    wh (H, 3H), mask (T, B, 1) and dys (T, B, H), all f32; the weight
    gradients are summed inside the kernel. A block keeps its units' Wh and
    Wx columns in shared memory, which bounds the shape: one that does not
    fit raises RuntimeError before a launch."""
    if x.device.type == "cpu":
        return gru_scan_xfused_bwd_plain(x, ysp, wx, b, wh, mask, dys,
                                         reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_xfused_bwd: unsupported device "
                         f"{x.device}")
    T, B, D = x.shape
    H = wh.shape[0]
    f32 = (torch.float32,)
    _build.check_tensor("x", x, x.device, f32, (T, B, D))
    _build.check_tensor("wx", wx, x.device, f32, (D, 3 * H))
    _build.check_tensor("b", b, x.device, f32, (3 * H,))
    _build.check_tensor("wh", wh, x.device, f32, (H, 3 * H))
    for name, t in (("ysp", ysp), ("dys", dys)):
        _build.check_tensor(name, t, x.device, f32, (T, B, H))
    mask2 = _mask_2d(mask, T, B, x.device)
    if x.numel() == 0 or H == 0:
        return (torch.zeros_like(x), torch.zeros_like(wx),
                torch.zeros_like(b), torch.zeros_like(wh))
    lib = _build.lib()
    fits = lib.tpuasr_gru_xfb_fits
    fits.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fits.restype = ctypes.c_int
    smem, budget = ctypes.c_longlong(0), ctypes.c_longlong(0)
    dmax = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        ok = fits(B, D, H, ctypes.byref(smem), ctypes.byref(budget),
                  ctypes.byref(dmax))
    if not ok:
        raise RuntimeError(
            f"gru_scan_xfused_bwd (K2b) cannot hold B={B}, D={D}, H={H}: a "
            f"block needs {smem.value} bytes of shared memory (at most "
            f"{budget.value}) and takes D <= {dmax.value} at this H")
    dx = torch.empty_like(x)
    dwx = torch.empty_like(wx)
    db = torch.empty_like(b)
    dwh = torch.empty_like(wh)
    xbuf = torch.empty((2, B, 4 * H), dtype=torch.float32, device=x.device)
    fn = lib.tpuasr_gru_xfb
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bar = _barrier(x.device)
    with torch.cuda.device(x.device):
        code = fn(*map(_build.ptr, (x, ysp, wx, b, wh, mask2, dys, dx, dwx,
                                    db, dwh, xbuf, bar)),
                  T, B, D, H, int(bool(reverse)), _build.stream_ptr(x))
    gru_scan_xfused_bwd.launches += 1
    _build.check(code, "gru_scan_xfused_bwd")
    return dx, dwx, db, dwh


gru_scan_xfused_bwd.launches = 0


class _XFusedScan(torch.autograd.Function):
    """K2 forward; backward by JAX's rule (``xfused_bwd_is_fused``): K2b
    where JAX takes ``_xf_bwd_fused``, otherwise ``_xf_bwd_recompute``'s
    route, xp = x@Wx+b by a matmul, K5b for dxp and dWh, then dx, dWx and
    db by matmuls. Float32 only."""

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
        ysp = prev_states(ys, ctx.reverse)
        if xfused_bwd_is_fused(D, wh.shape[0]):
            dx, dwx, db, dwh = gru_scan_xfused_bwd(
                x, ysp, wx, b, wh, mask, dys.contiguous(), ctx.reverse)
            return dx, dwx, db, dwh, None, None
        with full_fp32():
            xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, H3)
        dxp, dwh = gru_scan_bwd(xp, ysp, wh, mask, dys.contiguous(),
                                ctx.reverse)
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


def _barrier(device, n=1):
    """The grid barrier's arrival counter (one a row group of K2/K4's
    recurrence), zeroed for each launch."""
    return torch.zeros(n, dtype=torch.int32, device=device)


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
    """K4: as K2 with an int8 input projection (x quantized per row, exact
    int32 sums, dequantized as acc*sx*sw + b). wxq (D, 3H) int8, sw (3H,)
    f32. With ``wh_scale`` (3H,), wh is int8 and the recurrence runs in int8
    too, h re-quantized per step; otherwise wh is in x's dtype."""
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
    ys = _launch(_MODE_Q8_REC if rec_q8 else _MODE_Q8, x, wxq, b, wh, sw,
                 wh_scale, mask, reverse)
    gru_scan_xfused_q8.launches += 1
    return ys


gru_scan_xfused_q8.launches = 0


# ---- K7 / K7b: both directions in one launch, with BPTT -------------------


def gru_scan_bidir_plain(xpf, xpb, whf, whb, mask):
    """Plain version of K7: each direction as ``gru_recurrence`` over its
    own xp (xpb already reversed per row, so both run forward in time).
    xpf, xpb (T, B, 3H) and whf, whb (H, 3H) in one dtype (f32 or bf16),
    mask (T, B, 1) -> (ysf, ysb) (T, B, H) in that dtype. xp is widened to
    f32, h is rounded to Wh's dtype for h @ Wh, the gates are f32."""

    def one(xp, wh):
        wh32 = wh.to(torch.float32)

        def hp_fn(h):
            with full_fp32():
                return h.to(wh.dtype).to(torch.float32) @ wh32

        return gru_recurrence(xp.to(torch.float32), hp_fn, mask, False,
                              xp.dtype)

    return one(xpf, whf), one(xpb, whb)


def gru_scan_bidir_bwd_plain(xpf, xpb, yspf, yspb, whf, whb, mask, dysf,
                             dysb):
    """Plain version of K7b: ``gru_scan_bwd_plain`` per direction, both
    forward in time. -> (dxpf, dxpb, dwhf, dwhb), f32."""
    dxpf, dwhf = gru_scan_bwd_plain(xpf, yspf, whf, mask, dysf)
    dxpb, dwhb = gru_scan_bwd_plain(xpb, yspb, whb, mask, dysb)
    return dxpf, dxpb, dwhf, dwhb


def _check_bidir(xpf, xpb, whf, whb, mask, dtypes):
    T, B, H3 = xpf.shape
    H = whf.shape[0]
    if H3 != 3 * H:
        raise ValueError(f"xpf has {H3} columns, expected 3 * {H}")
    dt = (xpf.dtype,)
    _build.check_tensor("xpf", xpf, xpf.device, dtypes, (T, B, 3 * H))
    _build.check_tensor("xpb", xpb, xpf.device, dt, (T, B, 3 * H))
    _build.check_tensor("whf", whf, xpf.device, dt, (H, 3 * H))
    _build.check_tensor("whb", whb, xpf.device, dt, (H, 3 * H))
    return T, B, H, _mask_2d(mask, T, B, xpf.device)


def gru_scan_bidir_fwd(xpf, xpb, whf, whb, mask):
    """K7: (ysf, ysb) (T, B, H) in xpf's dtype from xpf, xpb (T, B, 3H),
    whf, whb (H, 3H), all f32 or all bf16, and mask (T, B, 1) f32.

    bf16 (serving) runs K2's tensor-core recurrence with both directions in
    one cooperative grid (``_scan_plan(..., ndir=2)``: a shape it cannot
    hold raises ValueError before the launch); f32 (training) runs K5's
    design, a block owning its units in both directions."""
    if xpf.device.type == "cpu":
        return gru_scan_bidir_plain(xpf, xpb, whf, whb, mask)
    if xpf.device.type != "cuda":
        raise ValueError(f"gru_scan_bidir_fwd: unsupported device "
                         f"{xpf.device}")
    T, B, H, mask2 = _check_bidir(xpf, xpb, whf, whb, mask,
                                  (torch.float32, torch.bfloat16))
    ysf = torch.empty((T, B, H), dtype=xpf.dtype, device=xpf.device)
    ysb = torch.empty_like(ysf)
    if ysf.numel() == 0:
        return ysf, ysb
    if xpf.dtype == torch.bfloat16:
        plan = _scan_plan(B, H, H, _MODE_K2, torch.bfloat16,
                          _sm_count(xpf.device), ndir=2)
        ysf, ysb = _recur_dirs(plan, (xpf, xpb),
                               (_pack_rec(whf, plan), _pack_rec(whb, plan)),
                               None, mask2, False, torch.bfloat16)
        gru_scan_bidir_fwd.launches += 1
        return ysf, ysb
    hbuf = torch.empty((2, 2, B, H), dtype=torch.float32, device=xpf.device)
    fn = _build.lib().tpuasr_gru_bidir_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bar = _barrier(xpf.device)
    with torch.cuda.device(xpf.device):
        code = fn(_build.ptr(xpf), _build.ptr(xpb), _build.ptr(whf),
                  _build.ptr(whb), _build.ptr(mask2), _build.ptr(ysf),
                  _build.ptr(ysb), _build.ptr(hbuf), _build.ptr(bar), T, B,
                  H, _build.stream_ptr(xpf))
    gru_scan_bidir_fwd.launches += 1
    _build.check(code, "gru_scan_bidir_fwd")
    return ysf, ysb


gru_scan_bidir_fwd.launches = 0


def _units_per_block(H: int, n_sm: int) -> int:
    """K5's and K7's units per block (units_per_block in
    csrc/gru_coop.cuh): ceil(H / n_sm) rounded up to a power of two."""
    U = 1
    while U * n_sm < H:
        U *= 2
    return U


def _bidir_bwd_smem(B: int, H: int, U: int) -> int:
    """K7b's shared memory a block (bwd_smem in csrc/gru_bidir.cu): both
    directions' Wh columns and dWh sums, their dhp and Wh rows, per-row
    state of the block's units, one staged pass and its sums."""
    return (2 * (2 * 16 * U * H + 16 * _K5_ROWS * U + 4 * U * 3 * H
                 + 3 * 4 * B * U)
            + 4 * _K5_ROWS * H + 4 * (_REC_THREADS // 32) * _K5_ROWS * 3)


def _bidir_bwd_chunks(B: int, H: int, n_sm: int = 132):
    """The row ranges [b0, b1) that K7b runs one launch each, in order:
    as few as the shared-memory budget allows (a block keeps per-row state
    of its units, so the rows a launch holds are bounded: 74 at H=512 on
    132 SMs), of sizes that differ by one at most. Raises ValueError where
    not one row fits."""
    U = _units_per_block(H, n_sm)
    fixed = _bidir_bwd_smem(0, H, U)
    per_row = _bidir_bwd_smem(1, H, U) - fixed
    rows = (_SMEM_BUDGET - fixed) // per_row
    if U > 16 or rows < 1:
        raise ValueError(f"gru_scan_bidir_bwd (K7b) cannot hold H={H} on "
                         f"{n_sm} SMs")
    n = -(-B // rows)
    return [(B * i // n, B * (i + 1) // n) for i in range(n)]


def gru_scan_bidir_bwd(xpf, xpb, yspf, yspb, whf, whb, mask, dysf, dysb):
    """K7b: (dxpf, dxpb (T, B, 3H), dwhf, dwhb (H, 3H)) f32 from xpf, xpb,
    yspf = prev_states(ysf), yspb, whf, whb, mask (T, B, 1) and dysf, dysb
    (T, B, H); both dWh are summed inside the kernel. Each block keeps
    per-row state of its units in shared memory, so the rows run in chunks
    (``_bidir_bwd_chunks``: one launch each, one chunk up to 74 rows at
    H=512); rows never meet, so dxp is each chunk's, and the chunks' dWh
    are added in chunk order (the same bits on every call)."""
    if xpf.device.type == "cpu":
        return gru_scan_bidir_bwd_plain(xpf, xpb, yspf, yspb, whf, whb,
                                        mask, dysf, dysb)
    if xpf.device.type != "cuda":
        raise ValueError(f"gru_scan_bidir_bwd: unsupported device "
                         f"{xpf.device}")
    T, B, H, mask2 = _check_bidir(xpf, xpb, whf, whb, mask,
                                  (torch.float32,))
    for name, t in (("yspf", yspf), ("yspb", yspb), ("dysf", dysf),
                    ("dysb", dysb)):
        _build.check_tensor(name, t, xpf.device, (torch.float32,),
                            (T, B, H))
    if xpf.numel() == 0:
        return (torch.empty_like(xpf), torch.empty_like(xpb),
                torch.zeros_like(whf), torch.zeros_like(whb))
    chunks = _bidir_bwd_chunks(B, H, _sm_count(xpf.device))
    rows = (xpf, xpb, yspf, yspb, mask2, dysf, dysb)
    if len(chunks) == 1:
        return _bidir_bwd_launch(*rows, whf, whb)
    dxpf, dxpb = torch.empty_like(xpf), torch.empty_like(xpb)
    dwhf = dwhb = None
    for b0, b1 in chunks:
        part = [t[:, b0:b1].contiguous() for t in rows]
        cf, cb, wf, wb = _bidir_bwd_launch(*part, whf, whb)
        dxpf[:, b0:b1] = cf
        dxpb[:, b0:b1] = cb
        dwhf = wf if dwhf is None else dwhf.add_(wf)
        dwhb = wb if dwhb is None else dwhb.add_(wb)
    return dxpf, dxpb, dwhf, dwhb


def _bidir_bwd_launch(xpf, xpb, yspf, yspb, mask2, dysf, dysb, whf, whb):
    """One K7b launch over all the rows it is given (checked tensors)."""
    T, B, H3 = xpf.shape
    H = H3 // 3
    dxpf, dxpb = torch.empty_like(xpf), torch.empty_like(xpb)
    dwhf, dwhb = torch.empty_like(whf), torch.empty_like(whb)
    scratch = torch.empty((2, 2, 3, B, H), dtype=torch.float32,
                          device=xpf.device)
    fn = _build.lib().tpuasr_gru_bidir_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bar = _barrier(xpf.device)
    with torch.cuda.device(xpf.device):
        code = fn(*map(_build.ptr, (xpf, xpb, yspf, yspb, whf, whb, mask2,
                                    dysf, dysb, dxpf, dxpb, dwhf, dwhb,
                                    scratch, bar)),
                  T, B, H, _build.stream_ptr(xpf))
    gru_scan_bidir_bwd.launches += 1
    _build.check(code, "gru_scan_bidir_bwd")
    return dxpf, dxpb, dwhf, dwhb


gru_scan_bidir_bwd.launches = 0


class _BidirScan(torch.autograd.Function):
    """K7 forward, K7b backward (the plain versions for CPU tensors), as
    JAX's custom VJP (pallas_gru.py:501-559). Float32 only."""

    @staticmethod
    def forward(ctx, xpf, xpb, whf, whb, mask):
        if xpf.dtype != torch.float32:
            raise NotImplementedError(
                "the backward of gru_scan_bidir is ported for float32 only")
        ysf, ysb = gru_scan_bidir_fwd(xpf, xpb, whf, whb, mask)
        ctx.save_for_backward(xpf, xpb, whf, whb, mask, ysf, ysb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dysf, dysb):
        xpf, xpb, whf, whb, mask, ysf, ysb = ctx.saved_tensors
        grads = gru_scan_bidir_bwd(
            xpf, xpb, prev_states(ysf, False), prev_states(ysb, False), whf,
            whb, mask, dysf.contiguous(), dysb.contiguous())
        return (*grads, None)


def gru_scan_bidir(xpf, xpb, whf, whb, mask):
    """Both GRU directions over precomputed projections, with JAX's
    semantics (pallas_gru.py:501): xpb comes from the per-row reversed
    input, and both recursions run forward in time under ``mask``.
    xpf, xpb (T, B, 3H), whf, whb (H, 3H), mask (T, B, 1) -> (ysf, ysb)
    (T, B, H). Differentiable in float32 (K7, then K7b); with no input
    requiring grad, K7 alone runs and nothing is saved."""
    args = (xpf.contiguous(), xpb.contiguous(), whf.contiguous(),
            whb.contiguous(), mask)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xpf, xpb, whf, whb)):
        return _BidirScan.apply(*args)
    return gru_scan_bidir_fwd(*args)
