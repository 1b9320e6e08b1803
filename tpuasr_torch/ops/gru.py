"""GRU scans: over precomputed projections with BPTT, and fused-projection.

Counterparts of tpuasr/ops/pallas_gru.py:

* ``gru_scan`` (K5 forward, K5b backward; pallas_gru.py:238): the masked
  recurrence over xp = x@Wx+b, differentiable. Its kernels are
  ``gru_scan_fwd`` (in f32 ``csrc/gru_bidir.cu``'s row-grouped recurrence
  at one direction, planned by ``_f32_rec_plan``; in bf16 K2's
  tensor-core recurrence over the given xp) and ``gru_scan_bwd`` (the
  three phases of ``csrc/gru_lean.cu`` at one direction);
* ``gru_scan_xfused`` (K2, pallas_gru.py:772): the input projection fused
  with the scan (``csrc/gru_scan.cu``: a tiled projection launch, then the
  recurrence, planned by ``_scan_plan``; in f32 the recurrence is
  ``gru_scan_fwd``'s). Its backward takes JAX's route
  (``_xf_bwd``, pallas_gru.py:829-835): where wx, dwx, wh and dwh fit JAX's
  11 MiB budget, K2b (``gru_scan_xfused_bwd``; pallas_gru.py:736) in three
  phases (xp and hp over all rows, the lean recurrence of
  ``csrc/gru_lean.cu``, the weight gradients and dx over all rows);
  elsewhere ``_xf_bwd_recompute`` (pallas_gru.py:891-926): xp recomputed by
  a matmul, K5b, then dx, dWx and db by matmuls;
* ``gru_scan_xfused_q8`` (K4, pallas_gru.py:1045): int8 projection, forward
  only;
* ``gru_scan_bidir`` (K7 forward, K7b backward; pallas_gru.py:501): both
  directions of a BiGRU over precomputed projections in one launch,
  differentiable. Its kernels are ``gru_scan_bidir_fwd``
  (``csrc/gru_bidir.cu`` in f32, planned by ``_bidir_f32_plan``, and
  ``csrc/gru_scan.cu`` in bf16) and ``gru_scan_bidir_bwd`` (the three
  phases, both directions in one grid).

Every kernel wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors. Layouts follow the JAX package: x (T, B, D)
time-major, wx (D, 3H), wh (H, 3H), b (3H,), gate order r, z, n,
mask (T, B, 1).

Every scan and its backward also takes JAX's bf16 streams (the kernels'
``dtype``, pallas_gru.py:163-293, :437, :736): xp (or x and wx), wh and ys
in bf16, the state and the gates in f32, h rounded to bf16 for h@Wh. The
backwards round where JAX's do: dys to ys's dtype, dhp to bf16 before
dhp@Wh^T, dxp (K5b, K7b) and K2b's dx written in bf16, dWh and dWx rounded
to bf16 at the end from f32 sums of the unrounded dhp and dxp, db in f32.
A bf16 call on the card reaches the bf16 form of its kernel, counted on
the wrapper's ``bf16.launches``; a dtype a kernel does not take raises
ValueError before any launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types

import torch

from tpuasr_torch import _build
from tpuasr_torch.ops.quant import reference_q8_gru_scan
from tpuasr_torch.precision import full_fp32

_MODE_K2, _MODE_Q8, _MODE_Q8_REC = 0, 1, 2


def gru_recurrence(xp, hp_fn, mask, reverse, out_dtype, h0=None):
    """The masked GRU recurrence over precomputed input projections.

    xp (T, B, 3H) f32, hp_fn(h (B, H) f32) -> (B, 3H) f32, mask (T, B, 1),
    h0 (B, H) the state before the first step (zero when None). The state
    is carried in f32; ys is stored in ``out_dtype``.
    """
    T, B, H3 = xp.shape
    H = H3 // 3
    m = mask.to(torch.float32).reshape(T, B, 1)
    h = (torch.zeros((B, H), dtype=torch.float32, device=xp.device)
         if h0 is None else h0.to(torch.float32))
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
    grid holds both directions' row groups and unit groups. ``kc`` is the
    contraction chunk of the f32 recurrence (``_f32_rec_plan``), 0 for the
    tensor-core ones."""
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
    kc: int = 0


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
    (``_f32_rec_plan``: csrc/gru_bidir.cu's row-grouped recurrence at one
    direction, 16 rows a pass); bf16
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
        rp = _f32_rec_plan(B, H, n_sm)
        return ScanPlan(proj, rec, rp.U, _LEAN_ROWS, rp.rg, rp.grid, rp.smem,
                        kp, np_, H, 1, rp.kc)
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
    16)) int8; none for f32 (its recurrence exchanges the state through
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
    H in both. f32 (``gru_scan_fwd``'s recurrence) takes Wh as it is."""
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
    ``_pack_proj``; sw, the int8 weights' scales)."""
    T, B, D = x.shape
    return _proj_rows(plan.proj, x.reshape(T * B, D), wxp, b, plan.kp,
                      plan.np, sw).reshape(T, B, -1)


def _proj_rows(kind, x, wxp, b, kp, np_, sw=None):
    """out (M, N) f32 = x (M, D) @ W + b on K2's projection tiles
    (``tpuasr_gru_proj``), W packed as ``_pack_proj`` packs it for the
    ``kind`` of arithmetic, padded to kp x np_. The f32 and bf16 tiles read
    x's rows in 16-byte pieces: where they are not 16-byte aligned, x is
    copied first into zero-padded rows of kp values."""
    M, D = x.shape
    N = b.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    xq = sx = None
    lda = D
    if kind == "int8":
        xq = torch.empty((M, kp), dtype=torch.int8, device=x.device)
        sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    elif x.data_ptr() % 16 or D * x.element_size() % 16:
        xa = x.new_zeros((M, kp))
        xa[:, :D] = x
        x, lda = xa, kp
    fn = _build.lib().tpuasr_gru_proj
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        code = fn(_KINDS[kind], int(x.dtype == torch.bfloat16),
                  _build.ptr(x), lda, _build.ptr(wxp), _build.ptr(b),
                  _ptr_or_null(sw), _ptr_or_null(xq), _ptr_or_null(sx),
                  _build.ptr(out), M, D, N, kp, np_,
                  _build.stream_ptr(x))
    _build.check(code, "gru projection")
    return out


def _recur(plan: ScanPlan, xp, whp, swh, mask2, reverse, out_dtype):
    """The second launch: ys (T, B, H) in ``out_dtype`` from xp, whp (from
    ``_pack_rec``), swh (rec_q8's scales) and mask2 (T, B). f32 runs
    ``gru_scan_fwd``'s recurrence (csrc/gru_bidir.cu)."""
    if plan.rec == "f32":
        rp = RowGroupPlan(plan.U, plan.rg, plan.kc, plan.smem, plan.grid, 1)
        return _bidir_f32(rp, (xp,), (whp,), mask2, reverse)[0]
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
    -> (dx (T, B, D), dwx (D, 3H), db (3H,), dwh (H, 3H)), f32.

    With bf16 x, wx, wh, ysp and dys (JAX's bf16 streams; b f32): xp stays
    f32, unrounded; dhp is rounded to bf16 for dhp@Wh^T and dxp for
    dxp@Wx^T; dx comes back in bf16, dWx and dWh summed in f32 from the
    unrounded dxp and dhp, then rounded to bf16 (pallas_gru.py:719, :887);
    db in f32."""
    T, B, D = x.shape
    H = wh.shape[0]
    m = mask.to(torch.float32).reshape(T, B, 1)
    wx32, wh32 = wx.to(torch.float32), wh.to(torch.float32)
    rnd = _rounding(wh.dtype)
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
            dh = m[t] * (d * z + rnd(dhp) @ wh32.T) + (1.0 - m[t]) * d
            dwh += h_prev.T @ dhp
            dx[t] = rnd(dxp) @ wx32.T
            dwx += xt.T @ dxp
            db += dxp.sum(0)
    return dx.to(x.dtype), dwx.to(wx.dtype), db, dwh.to(wh.dtype)


def _rounding(dtype):
    """x -> x rounded to ``dtype`` and widened back to f32 (the identity for
    f32): where JAX casts an f32 value to the weights' dtype before a
    product."""
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: v.to(dtype).to(torch.float32)


# ---- The float32 BPTT in three phases (csrc/gru_lean.cu) -----------------
#
# Only dhp @ Wh^T depends on the step before. K2b and K7b run (a) hp =
# ysp @ Wh, and K2b's xp = x @ Wx + b, over all T*B rows on K2's f32
# projection tiles; (b) the lean recurrence, a cooperative grid that does
# the gate math from the saved xp and hp and dhp @ Wh^T, one barrier a step
# per row group; (c) dWh = ysp^T dhp, and K2b's dWx = x^T dxp, db and
# dx = dxp @ Wx^T, over all T*B rows. K5b runs the same three phases at
# one direction.

_LEAN_ROWS = 16             # kR: rows a pass stages
_LEAN_TM = 8                # kTM in csrc/gru_lean.cu: rows of a lane's tile
_TN_MIN_ROWS = 512          # the fewest rows a slice of (c) sums


@dataclasses.dataclass(frozen=True)
class RowGroupPlan:
    """How a row-grouped f32 recurrence runs: the lean recurrence
    (csrc/gru_lean.cu, ``_lean_plan``) or K7's f32 forward
    (csrc/gru_bidir.cu, ``_bidir_f32_plan``). ``ndir`` directions in one
    cooperative grid of ``grid`` blocks, each direction's rows in ``rg``
    row groups times ceil(H / U) groups of ``U`` units, the contraction
    staged in chunks of ``kc`` columns, ``smem`` bytes of shared memory a
    block. Where two directions cannot share a grid, the plan gives
    ndir=1 and each direction is a launch."""
    U: int
    rg: int
    kc: int
    smem: int
    grid: int
    ndir: int


def _lean_smem(H: int, U: int, kc: int) -> int:
    """Shared memory of a lean block (lean_smem_bytes in
    csrc/gru_lean.cu): Wh's rows of its U units over the chunks, one staged
    chunk of 16 rows, the warps' sums."""
    nch = -(-3 * H // kc)
    return 4 * (U * nch * kc + _LEAN_ROWS * kc
                + (_REC_THREADS // 32) * _LEAN_TM * min(U, 4))


def _bidir_f32_smem(H: int, U: int, kc: int) -> int:
    """Shared memory of a block of K7's f32 forward (bidir_smem_bytes in
    csrc/gru_bidir.cu): Wh's 3U columns of its units over the chunks of
    the H contraction, two staged chunks of 16 rows of h, the warps' sums
    (8 rows x 3 gates x min(U, 2) units a warp)."""
    nch = -(-H // kc)
    return 4 * (3 * U * nch * kc + 2 * _LEAN_ROWS * kc
                + (_REC_THREADS // 32) * _LEAN_TM * 3 * min(U, 2))


def _lean_rows(B: int, rg: int):
    """The row ranges [b0, b1) of the rg row groups, as the kernels cut
    them: ceil(B / rg) rows a group."""
    rpg = -(-B // rg)
    return [(min(B, g * rpg), min(B, (g + 1) * rpg)) for g in range(rg)]


def _row_group_plan(B: int, H: int, K: int, ndir: int, n_sm: int, smem_fn,
                    what: str) -> RowGroupPlan:
    """The plan of a row-grouped recurrence whose block keeps Wh's values
    of its U units resident and stages 16 rows of a K-wide operand a pass
    (``smem_fn(H, U, kc)``: a block's bytes). For each U in 1, 2, 4, 8, 16
    whose ndir * ceil(H / U) unit groups fit the n_sm SMs, the rows split
    into as many row groups as the SMs left allow (no fewer than 16 rows a
    group), and the K contraction into the fewest chunks that fit the
    shared-memory budget. The plan that leaves a block the fewest rows
    wins, the smaller U on a tie (more blocks share the step's products).
    Two directions share a grid only where the contraction takes at most
    two chunks; otherwise each direction is a launch of its own. Raises
    ValueError where no plan fits."""
    options = []
    for U in (1, 2, 4, 8, 16):
        ug = -(-H // U)
        if ndir * ug > n_sm:
            continue
        rg = max(1, min(n_sm // (ndir * ug), -(-B // 16)))
        for nch in range(1, -(-K // 128) + 1):
            kc = _round_up(-(-K // nch), 128)
            smem = smem_fn(H, U, kc)
            if smem <= _SMEM_BUDGET:
                break
        else:
            continue
        if ndir == 2 and nch > 2:
            continue
        options.append((-(-B // rg), U, rg, kc, smem))
    if not options:
        if ndir == 2:
            return _row_group_plan(B, H, K, 1, n_sm, smem_fn, what)
        raise ValueError(
            f"{what} cannot hold H={H} on {n_sm} SMs: no U of 1-16 units a "
            f"block fits {_SMEM_BUDGET} bytes of shared memory with "
            f"ceil(H / U) blocks resident")
    _, U, rg, kc, smem = min(options)
    return RowGroupPlan(U, rg, kc, smem, ndir * rg * -(-H // U), ndir)


_LEAN_PIECE = 32            # kPiece in csrc/gru_lean.cu: columns a piece


def _lean_bf16_k3(H: int) -> int:
    """The bf16 body's contraction (lean_bf16_k3): 3H rounded up to whole
    pieces of 32 columns, the ring's row."""
    return _round_up(3 * H, _LEAN_PIECE)


def _lean_bf16_ld(H: int) -> int:
    """A resident bf16 row of Wh (lean_bf16_ld): 32 columns more where the
    contraction is a multiple of 64 (no bank taken twice by a B
    fragment)."""
    k3 = _lean_bf16_k3(H)
    return k3 + _LEAN_PIECE * (k3 % 64 == 0)


def _lean_bf16_smem(H: int, U: int) -> int:
    """Shared memory of a bf16 lean block (lean_bf16_smem_bytes): Wh's
    rows of its U units in bf16, the warps' 16 x U f32 sums of a pass."""
    return (2 * U * _lean_bf16_ld(H)
            + 4 * (_REC_THREADS // 32) * _LEAN_ROWS * U)


def _lean_bf16_plan(B: int, H: int, ndir: int, n_sm: int) -> RowGroupPlan:
    """The bf16 body's plan: for each U in 8, 16, 32 (n8 tiles of the
    tensor-core product) whose ndir * ceil(H / U) unit groups fit the SMs
    and whose block holds all of the 3H contraction within the budget, the
    rows split into as many row groups as the SMs left allow (no fewer than
    16 rows a group). The fewest rows a block wins, the larger U on a tie:
    a block stages its rows' whole dhp[t] whatever its U, so fewer blocks
    stage fewer bytes and meet at a smaller barrier. Two directions share a
    grid where they fit, else a launch each; ValueError where nothing
    fits."""
    options = []
    for U in (8, 16, 32):
        ug = -(-H // U)
        smem = _lean_bf16_smem(H, U)
        if ndir * ug > n_sm or smem > _SMEM_BUDGET:
            continue
        rg = max(1, min(n_sm // (ndir * ug), -(-B // 16)))
        options.append((-(-B // rg), -U, rg, smem))
    if not options:
        if ndir == 2:
            return _lean_bf16_plan(B, H, 1, n_sm)
        raise ValueError(
            f"the lean GRU backward in bf16 cannot hold H={H} on {n_sm} "
            f"SMs: no U of 8, 16, 32 units a block fits {_SMEM_BUDGET} "
            f"bytes of shared memory with ceil(H / U) blocks resident")
    _, neg_u, rg, smem = min(options)
    return RowGroupPlan(-neg_u, rg, _lean_bf16_k3(H), smem,
                        ndir * rg * -(-H // -neg_u), ndir)


def _lean_plan(B: int, H: int, ndir: int = 1, n_sm: int = 132,
               bf16: bool = False) -> RowGroupPlan:
    """The plan of the lean recurrence at batch B and width H for ndir
    directions (1: K2b, K5b; 2: K7b) on a card of n_sm SMs: in f32
    ``_row_group_plan`` over the 3H contraction of dhp @ Wh^T; with
    ``bf16`` the tensor-core body's ``_lean_bf16_plan`` (kc is then the
    whole contraction, K3)."""
    if bf16:
        return _lean_bf16_plan(B, H, ndir, n_sm)
    return _row_group_plan(B, H, 3 * H, ndir, n_sm, _lean_smem,
                           "the lean GRU backward")


def _bidir_f32_plan(B: int, H: int, n_sm: int = 132) -> RowGroupPlan:
    """The plan of K7's f32 forward (``_row_group_plan`` over the H
    contraction of h @ Wh) at batch B and width H on a card of n_sm SMs:
    both directions in one grid where they fit, else a launch each."""
    return _row_group_plan(B, H, H, 2, n_sm, _bidir_f32_smem,
                           "K7's f32 forward")


def _f32_rec_plan(B: int, H: int, n_sm: int = 132) -> RowGroupPlan:
    """The plan of the f32 recurrence at one direction (K5's forward, and
    K2's in f32): csrc/gru_bidir.cu's kernel under ``_row_group_plan``'s
    rule. At config 3's B=16, H=512 it runs 128 blocks of 4 units, at
    deepspeech_var's H=384 96 blocks of 4; at B=64 four row groups of 16
    rows. Any batch; H up to 1056 on 132 SMs (ValueError past it)."""
    return _row_group_plan(B, H, H, 1, n_sm, _bidir_f32_smem,
                           "the f32 GRU recurrence (K5, K2 in f32)")


def _lean(plan: RowGroupPlan, dirs, mask2, reverse):
    """Phase b in f32: one (dxp, dhp) (T, B, 3H) f32 for each direction's
    (xp, hp, ysp, dys, wh), all f32 and contiguous, under mask2 (T, B); the
    directions share one launch where ``plan.ndir`` is 2, else a launch
    each."""
    T, B, H3 = dirs[0][0].shape
    H = H3 // 3
    dev = dirs[0][0].device
    fn = _build.lib().tpuasr_gru_lean
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    groups = [dirs] if plan.ndir == len(dirs) else [[d] for d in dirs]
    outs = []
    for group in groups:
        dxp = [torch.empty_like(d[0]) for d in group]
        dhp = [torch.empty_like(d[0]) for d in group]
        dh = torch.zeros((len(group), B, H), dtype=torch.float32, device=dev)
        ptrs = [[*map(_build.ptr, (*d, dxp[i], dhp[i], dh[i]))]
                for i, d in enumerate(group)]
        bar = _barrier(dev, plan.ndir * plan.rg)
        # With one direction, its pointers stand for the second, unread.
        with torch.cuda.device(dev):
            code = fn(*ptrs[0], *ptrs[-1], _build.ptr(mask2),
                      _build.ptr(bar), T, B, H, int(bool(reverse)), plan.U,
                      plan.rg, plan.kc, len(group), plan.smem,
                      _build.stream_ptr(mask2))
        _build.check(code, "gru lean recurrence")
        outs += list(zip(dxp, dhp))
    return outs


def _lean_bf16(plan: RowGroupPlan, dirs, mask2, reverse):
    """Phase b of the bf16 streams (``_lean_plan(..., bf16=True)``): one
    (dxp, dhp) for each direction's (xp, hp, ysp, dys, wh), contiguous: xp
    bf16 (K5b, K7b) or f32 (K2b, phase a's unrounded sums), hp f32, ysp,
    dys and wh bf16, read as they are. dhp (T, B, 3H) f32, unrounded; dxp
    in xp's dtype. dhp is rounded to bf16 for dhp@Wh^T only, into a
    two-step ring (2, B, K3) bf16 a direction."""
    T, B, H3 = dirs[0][0].shape
    H = H3 // 3
    dev = dirs[0][0].device
    fn = _build.lib().tpuasr_gru_lean_bf16
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    groups = [dirs] if plan.ndir == len(dirs) else [[d] for d in dirs]
    outs = []
    for group in groups:
        n = len(group)
        dxp = [torch.empty_like(d[0]) for d in group]
        dhp = [torch.empty(d[0].shape, dtype=torch.float32, device=dev)
               for d in group]
        dh = torch.zeros((n, B, H), dtype=torch.float32, device=dev)
        ring = torch.zeros((n, 2, B, _lean_bf16_k3(H)), dtype=torch.bfloat16,
                           device=dev)
        ptrs = [[*map(_build.ptr, (*d, dxp[i], dhp[i], dh[i], ring[i]))]
                for i, d in enumerate(group)]
        bar = _barrier(dev, plan.ndir * plan.rg)
        # With one direction, its pointers stand for the second, unread.
        with torch.cuda.device(dev):
            code = fn(*ptrs[0], *ptrs[-1], _build.ptr(mask2),
                      _build.ptr(bar), T, B, H, int(bool(reverse)), plan.U,
                      plan.rg, n, int(group[0][0].dtype == torch.float32),
                      plan.smem, _build.stream_ptr(mask2))
        _build.check(code, "gru lean recurrence (bf16)")
        outs += list(zip(dxp, dhp))
    return outs


def _mm(a, w, bias=None):
    """a (M, K) @ w (K, N) (+ bias (N,) f32) -> (M, N) f32 on K2's
    projection tiles, in a fixed order: for f32 operands the FMA tiles
    (each sum in k order, never TF32), for bf16 ones the ``mma.sync`` tiles
    (exact products, f32 sums, unrounded). w may be a strided view: it is
    packed zero-padded as ``_pack_proj`` packs K2's weights, (kp, np) in
    f32 and W^T (np, kp) in bf16."""
    K, N = w.shape
    np_ = _round_up(N, _PROJ_TILE)
    if a.dtype == torch.bfloat16:
        kind, kp = "bf16", _round_up(K, _PROJ_STAGE // 2)
        wp = w.new_zeros((np_, kp))
        wp[:N, :K] = w.T
    else:
        kind, kp = "f32", _round_up(K, 8)
        wp = w.new_zeros((kp, np_))
        wp[:K, :N] = w
    if bias is None:
        bias = torch.zeros((N,), dtype=torch.float32, device=w.device)
    return _proj_rows(kind, a, wp, bias, kp, np_)


def _tn_slices(M: int, N1: int, N2: int, n_sm: int) -> int:
    """Slices of the M rows for ``_tn_product``: as many as keep the
    output's 128 x 128 tiles times the slices within one wave of two blocks
    an SM (a second, partial wave would run alone), no slice under 512
    rows."""
    tiles = -(-N1 // _PROJ_TILE) * -(-N2 // _PROJ_TILE)
    return max(1, min(2 * n_sm // tiles, M // _TN_MIN_ROWS))


def _tn_product(a, b, ones=False):
    """a^T b (N1, N2) f32 over the M rows of a (M, N1), f32 or bf16, and b
    (M, N2) f32, rows contiguous; with ``ones``, one more row: the column
    sums of b. Phase c (csrc/gru_lean.cu): each of S slices of the rows
    summed in row order, then the slices in slice order, so every call
    gives the same bits; f32 a on the FMA tiles (tpuasr_gemm_tn), bf16 a on
    the tensor cores with b split into three bf16 terms
    (tpuasr_gemm_tn_bf16; ``tn_product_split_plain`` is its function)."""
    M, n1a = a.shape
    N2 = b.shape[1]
    n1 = n1a + int(ones)
    S = _tn_slices(M, n1, N2, _sm_count(a.device))
    c = torch.empty((n1, N2), dtype=torch.float32, device=a.device)
    parts = (torch.empty((S, n1, N2), dtype=torch.float32, device=a.device)
             if S > 1 else None)
    fn = (_build.lib().tpuasr_gemm_tn_bf16 if a.dtype == torch.bfloat16
          else _build.lib().tpuasr_gemm_tn)
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        code = fn(_build.ptr(a), a.stride(0), n1a, int(ones), _build.ptr(b),
                  b.stride(0), N2, _build.ptr(c), _ptr_or_null(parts), M, S,
                  _build.stream_ptr(a))
    _build.check(code, "gru weight-gradient product")
    return c


def _hp(ysp, wh):
    """Phase a's hp = ysp @ Wh (T, B, 3H) f32 over all T*B rows: on the f32
    tiles, or the bf16 tiles for bf16 ysp and wh (exact products, f32
    sums)."""
    T, B, H = ysp.shape
    return _mm(ysp.reshape(T * B, H), wh).reshape(T, B, 3 * H)


def split_bf16(v):
    """f32 v as three bf16 terms (hi, mid, lo) with hi + mid + lo == v
    exactly: a float's 24 significant bits in three pieces of 8, each
    remainder exact in f32 (what csrc/gru_lean.cu's split3 computes)."""
    bf, f32 = torch.bfloat16, torch.float32
    hi = v.to(bf)
    r1 = v - hi.to(f32)
    mid = r1.to(bf)
    return hi, mid, (r1 - mid.to(f32)).to(bf)


def tn_product_split_plain(a, b, ones=False):
    """Plain version of phase c's bf16 product: a (M, N1) bf16, b (M, N2)
    f32 -> a^T b (N1 (+1 with ``ones``: b's column sums), N2) f32 as the
    sum of a^T t over b's three bf16 terms t (``split_bf16``), each product
    of bf16 values exact in f32."""
    f32 = torch.float32
    a32 = a.to(f32)
    if ones:
        a32 = torch.cat([a32, a32.new_ones((a32.shape[0], 1))], dim=1)
    with full_fp32():
        return sum(a32.T @ t.to(f32) for t in split_bf16(b))


def _dwh(ysp, dhp):
    """Phase c's dWh = ysp^T dhp (H, 3H) over all T*B rows (ysp f32, or
    bf16 on the split-bf16 tensor-core product)."""
    T, B, H = ysp.shape
    return _tn_product(ysp.reshape(T * B, H), dhp.reshape(T * B, 3 * H))


def gru_bwd_lean_plain(xp, hp, ysp, wh, mask, dys, reverse=False):
    """Plain version of the lean recurrence (phase b): from the saved
    xp = x@Wx+b and hp = ysp@Wh (T, B, 3H), ysp and dys (T, B, H), step by
    step in BPTT order, the gates, dhp and dxp masked on padded steps, and
    dh = m (dh_tot z) + (1 - m) dh_tot + m dhp @ Wh^T -> (dxp, dhp)
    (T, B, 3H) f32. With wh in bf16 (the bf16 streams) dhp is rounded to
    bf16 for dhp @ Wh^T, as the kernel's kRoundDhp mode; dxp and dhp come
    back unrounded."""
    T, B, H3 = xp.shape
    H = H3 // 3
    m = mask.to(torch.float32).reshape(T, B, 1)
    wh32 = wh.to(torch.float32)
    rnd = _rounding(wh.dtype)
    dh = xp.new_zeros((B, H), dtype=torch.float32)
    dxp = xp.new_empty((T, B, H3), dtype=torch.float32)
    dhp = xp.new_empty((T, B, H3), dtype=torch.float32)
    with full_fp32():
        for t in (range(T) if reverse else range(T - 1, -1, -1)):
            x, a = xp[t].to(torch.float32), hp[t].to(torch.float32)
            h_prev = ysp[t].to(torch.float32)
            r = torch.sigmoid(x[:, :H] + a[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + a[:, H:2 * H])
            n = torch.tanh(x[:, 2 * H:] + r * a[:, 2 * H:])
            d = dys[t].to(torch.float32) + dh
            dz = d * (h_prev - n)
            dn = d * (1.0 - z) * (1.0 - n * n)
            dxr = dn * a[:, 2 * H:] * r * (1.0 - r)
            dxz = dz * z * (1.0 - z)
            dhp[t] = torch.cat([dxr, dxz, dn * r], dim=1) * m[t]
            dxp[t] = torch.cat([dxr, dxz, dn], dim=1) * m[t]
            dh = (m[t] * (d * z) + (1.0 - m[t]) * d
                  + m[t] * (rnd(dhp[t]) @ wh32.T))
    return dxp, dhp


def gru_scan_bwd_phases_plain(xp, ysp, wh, mask, dys, reverse=False):
    """K5b's function in the three phases, plainly: hp = ysp@Wh over all
    rows, ``gru_bwd_lean_plain``, then dWh = ysp^T dhp over all rows.
    -> dxp (T, B, 3H), dwh (H, 3H), f32."""
    T, B, H3 = xp.shape
    ysp2 = ysp.reshape(T * B, -1).to(torch.float32)
    with full_fp32():
        hp = (ysp2 @ wh.to(torch.float32)).reshape(T, B, H3)
    dxp, dhp = gru_bwd_lean_plain(xp, hp, ysp, wh, mask, dys, reverse)
    with full_fp32():
        dwh = ysp2.T @ dhp.reshape(T * B, H3)
    return dxp, dwh


def gru_scan_xfused_bwd_phases_plain(x, ysp, wx, b, wh, mask, dys,
                                     reverse=False):
    """K2b's function in the three phases, plainly: xp = x@Wx+b and
    hp = ysp@Wh over all rows, ``gru_bwd_lean_plain``, then dWh = ysp^T
    dhp, dWx = x^T dxp, db = sum dxp and dx = dxp@Wx^T over all rows.
    -> (dx (T, B, D), dwx (D, 3H), db (3H,), dwh (H, 3H)), f32."""
    T, B, D = x.shape
    H3 = wx.shape[1]
    x2 = x.reshape(T * B, D).to(torch.float32)
    ysp2 = ysp.reshape(T * B, -1).to(torch.float32)
    wx32 = wx.to(torch.float32)
    with full_fp32():
        xp = (x2 @ wx32 + b.to(torch.float32)).reshape(T, B, H3)
        hp = (ysp2 @ wh.to(torch.float32)).reshape(T, B, H3)
    dxp, dhp = gru_bwd_lean_plain(xp, hp, ysp, wh, mask, dys, reverse)
    dxp2 = dxp.reshape(T * B, H3)
    with full_fp32():
        return ((dxp2 @ wx32.T).reshape(T, B, D), x2.T @ dxp2, dxp2.sum(0),
                ysp2.T @ dhp.reshape(T * B, H3))


def _xfb_pre(x, ysp, wx, b, wh):
    """K2b's phase a: xp = x@Wx+b and hp = ysp@Wh (T, B, 3H) f32 over all
    rows, on the f32 tiles, or for bf16 operands on the bf16 tiles (xp
    unrounded, as JAX's in-kernel xp)."""
    T, B, D = x.shape
    H = wh.shape[0]
    xp = _mm(x.reshape(T * B, D), wx, b).reshape(T, B, 3 * H)
    return xp, _hp(ysp, wh)


def _xfb_post(x, ysp, wx, dxp, dhp):
    """K2b's phase c: (dx, dwx, db, dwh) from dxp and dhp (T, B, 3H) f32,
    unrounded; x, ysp and wx f32, or bf16 (then dwx, db and dwh on the
    split-bf16 tensor-core product, dx = bf16(dxp) @ Wx^T on the bf16
    tiles, written in bf16, and dwx and dwh rounded to bf16 from the f32
    sums)."""
    T, B, D = x.shape
    H3 = wx.shape[1]
    dxp2 = dxp.reshape(T * B, H3)
    dwx_db = _tn_product(x.reshape(T * B, D), dxp2, ones=True)
    dwh = _dwh(ysp, dhp)
    if x.dtype == torch.float32:
        dx = _mm(dxp2, wx.T).reshape(T, B, D)
        return dx, dwx_db[:D], dwx_db[D], dwh
    bf = torch.bfloat16
    dx = _mm(dxp2.to(bf), wx.T).reshape(T, B, D).to(bf)
    return dx, dwx_db[:D].to(bf), dwx_db[D].contiguous(), dwh.to(bf)


def _check_streams(name, dtype, **tensors):
    """The tensors of one scan or backward share ``dtype``, f32 or bf16:
    a bf16 call reaches the bf16 form of its kernel, never an f32 kernel
    on upcasts; ValueError before any launch otherwise."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: float32 or bfloat16 streams, got {dtype}")
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {k} is {t.dtype}, the streams are "
                             f"{dtype}")


def gru_scan_xfused_bwd(x, ysp, wx, b, wh, mask, dys, reverse=False):
    """K2b: (dx (T, B, D), dwx (D, 3H), db (3H,), dwh (H, 3H)) from
    x (T, B, D), ysp = prev_states(ys) (T, B, H), wx (D, 3H), b (3H,) f32,
    wh (H, 3H), mask (T, B, 1) and dys (T, B, H); x, ysp, wx, wh and dys
    all f32 (every output f32) or all bf16 (JAX's bf16 streams: dx, dwx
    and dwh in bf16, db in f32). On the card, in three phases: xp = x@Wx+b
    and hp = ysp@Wh over all T*B rows, the lean recurrence (``_lean_plan``:
    a shape it cannot hold raises ValueError before any launch; in bf16
    the tensor-core body over the bf16 streams and the f32 xp, dhp rounded
    for dhp@Wh^T), then dWh, dWx, db and dx over all rows; every product
    on hand-written tiles, in a fixed order. One count a call, on
    ``launches`` (f32) or ``bf16.launches``."""
    if x.device.type == "cpu":
        return gru_scan_xfused_bwd_plain(x, ysp, wx, b, wh, mask, dys,
                                         reverse)
    if x.device.type != "cuda":
        raise ValueError(f"gru_scan_xfused_bwd: unsupported device "
                         f"{x.device}")
    T, B, D = x.shape
    H = wh.shape[0]
    dt = (x.dtype,)
    _check_streams("gru_scan_xfused_bwd", x.dtype, wx=wx, wh=wh, ysp=ysp,
                   dys=dys)
    _build.check_tensor("x", x, x.device, dt, (T, B, D))
    _build.check_tensor("wx", wx, x.device, dt, (D, 3 * H))
    _build.check_tensor("b", b, x.device, (torch.float32,), (3 * H,))
    _build.check_tensor("wh", wh, x.device, dt, (H, 3 * H))
    for name, t in (("ysp", ysp), ("dys", dys)):
        _build.check_tensor(name, t, x.device, dt, (T, B, H))
    mask2 = _mask_2d(mask, T, B, x.device)
    if x.numel() == 0 or H == 0:
        return (torch.zeros_like(x), torch.zeros_like(wx),
                torch.zeros_like(b), torch.zeros_like(wh))
    bf16 = x.dtype == torch.bfloat16
    plan = _lean_plan(B, H, 1, _sm_count(x.device), bf16)
    xp, hp = _xfb_pre(x, ysp, wx, b, wh)
    (dxp, dhp), = (_lean_bf16 if bf16 else _lean)(
        plan, [(xp, hp, ysp, dys, wh)], mask2, reverse)
    (gru_scan_xfused_bwd.bf16 if bf16 else gru_scan_xfused_bwd).launches += 1
    return _xfb_post(x, ysp, wx, dxp, dhp)


gru_scan_xfused_bwd.launches = 0
gru_scan_xfused_bwd.bf16 = types.SimpleNamespace(launches=0)


def _xf_recompute_xp(x, wx, b):
    """The recompute route's xp (pallas_gru.py:900-901): x@Wx+b over all
    T*B rows in x's dtype; in bf16 the product is rounded to bf16 and
    b.bf16 added in bf16, so xp is rounded twice (the forward's in-kernel
    xp is not rounded at all)."""
    T, B, D = x.shape
    x2 = x.reshape(T * B, D)
    with full_fp32():
        if x.dtype == torch.float32:
            return (x2 @ wx + b).reshape(T, B, -1)
        f32 = torch.float32
        return ((x2.to(f32) @ wx.to(f32)).to(x.dtype)
                + b.to(x.dtype)).reshape(T, B, -1)


class _XFusedScan(torch.autograd.Function):
    """K2 forward; backward by JAX's rule (``xfused_bwd_is_fused``): K2b
    where JAX takes ``_xf_bwd_fused``, otherwise ``_xf_bwd_recompute``'s
    route, xp = x@Wx+b by a matmul (``_xf_recompute_xp``), K5b for dxp
    and dWh, then dx, dWx and db by matmuls on dxp's f32 upcast. In f32,
    or with bf16 x, wx, wh (and ys, dys): dx, dwx and dwh come back in
    bf16, db in f32, as JAX's ``.astype`` casts return them
    (pallas_gru.py:887-888, :925-926)."""

    @staticmethod
    def forward(ctx, x, wx, b, wh, mask, reverse):
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
        dys = dys.to(ys.dtype).contiguous()
        if xfused_bwd_is_fused(D, wh.shape[0]):
            dx, dwx, db, dwh = gru_scan_xfused_bwd(
                x, ysp, wx, b, wh, mask, dys, ctx.reverse)
            return dx, dwx, db, dwh, None, None
        xp = _xf_recompute_xp(x, wx, b)
        dxp, dwh = gru_scan_bwd(xp, ysp, wh, mask, dys, ctx.reverse)
        f32 = torch.float32
        dxp2 = dxp.reshape(T * B, H3).to(f32)
        with full_fp32():
            dx = (dxp2 @ wx.to(f32).T).reshape(T, B, D)
            dwx = x.reshape(T * B, D).to(f32).T @ dxp2
        return (dx.to(x.dtype), dwx.to(wx.dtype), dxp2.sum(0), dwh, None,
                None)


# ---- K5 / K5b: the scan over precomputed projections, with BPTT ----------


def gru_scan_plain(xp, wh, mask, reverse=False, h0=None):
    """Plain version of K5: xp (T, B, 3H) and wh (H, 3H), both f32 or both
    bf16, mask (T, B, 1), h0 (B, H) or None (zero) -> ys (T, B, H) in xp's
    dtype. The state and the gates are f32; in bf16 h is rounded to bf16
    for h @ Wh (JAX's ``_fwd_kernel``, pallas_gru.py:89-90)."""
    wh32 = wh.to(torch.float32)

    def hp_fn(h):
        with full_fp32():
            return h.to(wh.dtype).to(torch.float32) @ wh32

    return gru_recurrence(xp.to(torch.float32), hp_fn, mask, reverse,
                          xp.dtype, h0)


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
    gradient masked on padded steps. -> dxp (T, B, 3H), dwh (H, 3H), f32.
    With bf16 streams (xp, ysp, wh, dys in bf16): dhp rounded to bf16 for
    dhp @ Wh^T (pallas_gru.py:139), dxp written in bf16, dWh summed in f32
    from the unrounded dhp and returned in bf16 (:293)."""
    T, B, H3 = xp.shape
    H = H3 // 3
    m = mask.to(torch.float32).reshape(T, B, 1)
    wh32 = wh.to(torch.float32)
    rnd = _rounding(wh.dtype)
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
            dh = m[t] * (d * z + rnd(dhp) @ wh32.T) + (1.0 - m[t]) * d
            dwh += h_prev.T @ dhp
    return dxp.to(xp.dtype), dwh.to(wh.dtype)


def _check_scan(xp, wh, mask):
    T, B, H3 = xp.shape
    H = wh.shape[0]
    if H3 != 3 * H:
        raise ValueError(f"xp has {H3} columns, expected 3 * {H}")
    dt = (xp.dtype,)
    _check_streams("gru_scan", xp.dtype, wh=wh)
    _build.check_tensor("xp", xp, xp.device, dt, (T, B, 3 * H))
    _build.check_tensor("wh", wh, xp.device, dt, (H, 3 * H))
    return T, B, H, _mask_2d(mask, T, B, xp.device)


def _barrier(device, n=1):
    """The grid barrier's arrival counter (one a row group of K2/K4's
    recurrence), zeroed for each launch."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def _check_h0(h0, B, H, device, grad):
    """h0 must be a (B, H) float32 tensor on the scan's device; the scans
    from a state have no backward, so an input that requires grad raises."""
    if grad or h0.requires_grad and torch.is_grad_enabled():
        raise ValueError("a GRU scan from h0 has no backward (streaming "
                         "serves only); run it under torch.no_grad()")
    if (tuple(h0.shape) != (B, H) or h0.dtype != torch.float32
            or h0.device != device):
        raise ValueError(f"h0 must be ({B}, {H}) float32 on {device}, got "
                         f"{tuple(h0.shape)} {h0.dtype} on {h0.device}")


def _aligned_h0(h0):
    """h0 contiguous at a 16-byte address (the kernel stages it by
    cp.async), or None."""
    if h0 is None:
        return None
    h0 = h0.contiguous()
    return h0 if h0.data_ptr() % 16 == 0 else h0.clone()


def gru_scan_fwd(xp, wh, mask, reverse=False, h0=None):
    """K5: ys (T, B, H) from xp (T, B, 3H), wh (H, 3H), mask (T, B, 1).
    f32: on the card, csrc/gru_bidir.cu's row-grouped recurrence at one
    direction (``_f32_rec_plan``). bf16 (xp and wh in bf16, ys bf16; JAX's
    ``_fwd_kernel`` with bf16 streams): K2's tensor-core recurrence over
    the given xp (``_scan_plan(B, H, H, _MODE_K2, bf16)``, as K7's bf16
    forward at one direction). A shape its plan cannot hold raises
    ValueError before any launch. One count a call, on ``launches`` (f32)
    or ``bf16.launches``.

    h0: the state before the first step in scan order, (B, H) float32 on
    xp's device, or None for zero (the training scans; that path and its
    bits are unchanged). A padded step keeps the state, so a row masked
    throughout returns h0. Streaming carries the state across chunks: a
    scan over T steps equals a scan over the first T1 steps, then one over
    the rest from the first's last state. There is no backward from h0:
    with an input that requires grad (and grad enabled) it raises
    ValueError. Only the f32 scan starts from h0."""
    if h0 is not None:
        _check_h0(h0, xp.shape[1], wh.shape[0], xp.device,
                  torch.is_grad_enabled() and (xp.requires_grad
                                               or wh.requires_grad))
        if xp.dtype != torch.float32:
            raise ValueError("gru_scan_fwd starts from h0 in float32 only")
    if xp.device.type == "cpu":
        return gru_scan_plain(xp, wh, mask, reverse, h0)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_scan_fwd: unsupported device {xp.device}")
    T, B, H, mask2 = _check_scan(xp, wh, mask)
    if xp.numel() == 0:
        return torch.empty((T, B, H), dtype=xp.dtype, device=xp.device)
    n_sm = _sm_count(xp.device)
    if xp.dtype == torch.bfloat16:
        plan = _scan_plan(B, H, H, _MODE_K2, torch.bfloat16, n_sm)
        ys = _recur(plan, xp, _pack_rec(wh, plan), None, mask2, reverse,
                    torch.bfloat16)
        gru_scan_fwd.bf16.launches += 1
        return ys
    plan = _f32_rec_plan(B, H, n_sm)
    ys, = _bidir_f32(plan, (xp,), (wh,), mask2, reverse, (_aligned_h0(h0),))
    gru_scan_fwd.launches += 1
    return ys


gru_scan_fwd.launches = 0
gru_scan_fwd.bf16 = types.SimpleNamespace(launches=0)


def gru_scan_bwd(xp, ysp, wh, mask, dys, reverse=False):
    """K5b: (dxp (T, B, 3H), dwh (H, 3H)) from xp, ysp = prev_states(ys),
    wh, mask (T, B, 1) and dys (T, B, H), all f32 or all bf16 (outputs in
    the same dtype). On the card, in three phases at one direction:
    hp = ysp@Wh over all T*B rows, the lean recurrence
    (``_lean_plan(B, H, 1)``: a shape it cannot hold raises ValueError
    before any launch; in bf16 the tensor-core body over the bf16 streams,
    dhp rounded for dhp@Wh^T and dxp written in bf16), then dWh = ysp^T
    dhp over all rows, in a fixed order (rounded to bf16 at the end in
    bf16). One count a call, on ``launches`` (f32) or ``bf16.launches``."""
    if xp.device.type == "cpu":
        return gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: unsupported device {xp.device}")
    T, B, H, mask2 = _check_scan(xp, wh, mask)
    _check_streams("gru_scan_bwd", xp.dtype, ysp=ysp, dys=dys)
    dt = (xp.dtype,)
    _build.check_tensor("ysp", ysp, xp.device, dt, (T, B, H))
    _build.check_tensor("dys", dys, xp.device, dt, (T, B, H))
    if xp.numel() == 0:
        return torch.empty_like(xp), torch.zeros_like(wh)
    plan = _lean_plan(B, H, 1, _sm_count(xp.device),
                      xp.dtype == torch.bfloat16)
    (dxp, dwh), = _lean_dirs(plan, [(xp, ysp, dys, wh)], mask2, reverse)
    (gru_scan_bwd.bf16 if xp.dtype == torch.bfloat16
     else gru_scan_bwd).launches += 1
    return dxp, dwh


gru_scan_bwd.launches = 0
gru_scan_bwd.bf16 = types.SimpleNamespace(launches=0)


def _lean_dirs(plan, dirs, mask2, reverse):
    """The three phases of K5b and K7b: for each direction's
    (xp, ysp, dys, wh), all f32 or all bf16, hp = ysp@Wh (on the bf16
    tiles for bf16), the lean recurrence over the streams as they are (in
    bf16 the tensor-core body: dhp rounded for dhp@Wh^T, dxp written in
    bf16), then dWh = ysp^T dhp from the unrounded dhp (split-bf16 in
    bf16), cast to wh's dtype -> [(dxp, dwh)] in the streams' dtype. In
    f32 the cast is the tensor itself."""
    lean = _lean_bf16 if dirs[0][0].dtype == torch.bfloat16 else _lean
    outs = lean(plan, [(xp, _hp(ysp, wh), ysp, dys, wh)
                       for xp, ysp, dys, wh in dirs], mask2, reverse)
    return [(dxp, _dwh(ysp, dhp).to(wh.dtype))
            for (dxp, dhp), (_, ysp, _, wh) in zip(outs, dirs)]


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
                                dys.to(ys.dtype).contiguous(), ctx.reverse)
        return dxp, dwh, None, None


def gru_scan(xp, wh, mask, reverse=False):
    """Masked GRU over time, differentiable: xp (T, B, 3H) and wh (H, 3H),
    both f32 or both bf16 (JAX's bf16 streams), mask (T, B, 1) -> ys
    (T, B, H) in xp's dtype. K5 forward, K5b backward (the plain versions
    for CPU tensors). reverse=True is the right-to-left GRU on left-aligned
    ragged rows, as in JAX."""
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
    forward in time. -> (dxpf, dxpb, dwhf, dwhb) in the streams' dtype
    (f32, or bf16 with JAX's bf16 rounding points)."""
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
    one cooperative grid (``_scan_plan(..., ndir=2)``); f32 (training) runs
    csrc/gru_bidir.cu's row-grouped recurrence (``_bidir_f32_plan``: both
    directions in one grid where they fit, else a launch each). A shape the
    plan cannot hold raises ValueError before any launch. One count a
    call."""
    if xpf.device.type == "cpu":
        return gru_scan_bidir_plain(xpf, xpb, whf, whb, mask)
    if xpf.device.type != "cuda":
        raise ValueError(f"gru_scan_bidir_fwd: unsupported device "
                         f"{xpf.device}")
    T, B, H, mask2 = _check_bidir(xpf, xpb, whf, whb, mask,
                                  (torch.float32, torch.bfloat16))
    if T * B * H == 0:
        return (torch.empty((T, B, H), dtype=xpf.dtype, device=xpf.device),
                torch.empty((T, B, H), dtype=xpf.dtype, device=xpf.device))
    n_sm = _sm_count(xpf.device)
    if xpf.dtype == torch.bfloat16:
        plan = _scan_plan(B, H, H, _MODE_K2, torch.bfloat16, n_sm, ndir=2)
        ysf, ysb = _recur_dirs(plan, (xpf, xpb),
                               (_pack_rec(whf, plan), _pack_rec(whb, plan)),
                               None, mask2, False, torch.bfloat16)
    else:
        ysf, ysb = _bidir_f32(_bidir_f32_plan(B, H, n_sm), (xpf, xpb),
                              (whf, whb), mask2)
    gru_scan_bidir_fwd.launches += 1
    return ysf, ysb


gru_scan_bidir_fwd.launches = 0


def _bidir_f32(plan: RowGroupPlan, xps, whs, mask2, reverse=False,
               h0s=None):
    """The f32 recurrence (csrc/gru_bidir.cu): one ys (T, B, H) f32 for
    each direction's xp (T, B, 3H) and wh (H, 3H), f32 and contiguous, all
    scanned in one sense under mask2 (T, B) (from t = T-1 down with
    ``reverse``: K5's reverse), each from its h0 in ``h0s`` (B, H) where
    given and not None (16-byte aligned), else from zero; the directions
    share one launch where ``plan.ndir`` is their number, else a launch
    each."""
    T, B, H3 = xps[0].shape
    H = H3 // 3
    dev = xps[0].device
    fn = _build.lib().tpuasr_gru_bidir_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ys = [torch.empty((T, B, H), dtype=torch.float32, device=dev)
          for _ in xps]
    dirs = [(*map(_build.ptr, d), _ptr_or_null(h0)) for *d, h0 in zip(
        xps, whs, ys, h0s or (None,) * len(xps))]
    groups = [dirs] if plan.ndir == len(dirs) else [[d] for d in dirs]
    for group in groups:
        bar = _barrier(dev, plan.ndir * plan.rg)
        # With one direction, its pointers stand for the second, unread.
        with torch.cuda.device(dev):
            code = fn(*group[0], *group[-1],
                      _build.ptr(mask2), _build.ptr(bar), T, B, H, plan.U,
                      plan.rg, plan.kc, int(bool(reverse)), len(group),
                      plan.smem, _build.stream_ptr(mask2))
        _build.check(code, "the f32 GRU recurrence")
    return tuple(ys)


def gru_scan_bidir_bwd_phases_plain(xpf, xpb, yspf, yspb, whf, whb, mask,
                                    dysf, dysb):
    """K7b's function in the three phases, plainly:
    ``gru_scan_bwd_phases_plain`` per direction, both forward in time.
    -> (dxpf, dxpb, dwhf, dwhb), f32."""
    dxpf, dwhf = gru_scan_bwd_phases_plain(xpf, yspf, whf, mask, dysf)
    dxpb, dwhb = gru_scan_bwd_phases_plain(xpb, yspb, whb, mask, dysb)
    return dxpf, dxpb, dwhf, dwhb


def gru_scan_bidir_bwd(xpf, xpb, yspf, yspb, whf, whb, mask, dysf, dysb):
    """K7b: (dxpf, dxpb (T, B, 3H), dwhf, dwhb (H, 3H)) from xpf, xpb,
    yspf = prev_states(ysf), yspb, whf, whb, mask (T, B, 1) and dysf, dysb
    (T, B, H), all f32 or all bf16 (outputs in that dtype; bf16 rounds as
    K5b does). On the card, in three phases: hp = ysp@Wh for both
    directions over all T*B rows, the lean recurrence with both directions
    in one grid (``_lean_plan(B, H, 2)``: a launch a direction where they
    cannot share one; a shape it cannot hold raises ValueError before any
    launch), then dWh = ysp^T dhp per direction over all rows, in a fixed
    order. One count a call, on ``launches`` (f32) or ``bf16.launches``."""
    if xpf.device.type == "cpu":
        return gru_scan_bidir_bwd_plain(xpf, xpb, yspf, yspb, whf, whb,
                                        mask, dysf, dysb)
    if xpf.device.type != "cuda":
        raise ValueError(f"gru_scan_bidir_bwd: unsupported device "
                         f"{xpf.device}")
    dt = xpf.dtype
    T, B, H, mask2 = _check_bidir(xpf, xpb, whf, whb, mask,
                                  (torch.float32, torch.bfloat16))
    _check_streams("gru_scan_bidir_bwd", dt, yspf=yspf, yspb=yspb,
                   dysf=dysf, dysb=dysb)
    for name, t in (("yspf", yspf), ("yspb", yspb), ("dysf", dysf),
                    ("dysb", dysb)):
        _build.check_tensor(name, t, xpf.device, (dt,), (T, B, H))
    if xpf.numel() == 0:
        return (torch.empty_like(xpf), torch.empty_like(xpb),
                torch.zeros_like(whf), torch.zeros_like(whb))
    plan = _lean_plan(B, H, 2, _sm_count(xpf.device), dt == torch.bfloat16)
    (dxpf, dwhf), (dxpb, dwhb) = _lean_dirs(
        plan, [(xpf, yspf, dysf, whf), (xpb, yspb, dysb, whb)], mask2,
        False)
    (gru_scan_bidir_bwd.bf16 if dt == torch.bfloat16
     else gru_scan_bidir_bwd).launches += 1
    return dxpf, dxpb, dwhf, dwhb


gru_scan_bidir_bwd.launches = 0
gru_scan_bidir_bwd.bf16 = types.SimpleNamespace(launches=0)


class _BidirScan(torch.autograd.Function):
    """K7 forward, K7b backward (the plain versions for CPU tensors), as
    JAX's custom VJP (pallas_gru.py:501-559), in f32 or with bf16 streams
    (dys cast to ys's dtype, pallas_gru.py:531-534)."""

    @staticmethod
    def forward(ctx, xpf, xpb, whf, whb, mask):
        ysf, ysb = gru_scan_bidir_fwd(xpf, xpb, whf, whb, mask)
        ctx.save_for_backward(xpf, xpb, whf, whb, mask, ysf, ysb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dysf, dysb):
        xpf, xpb, whf, whb, mask, ysf, ysb = ctx.saved_tensors
        grads = gru_scan_bidir_bwd(
            xpf, xpb, prev_states(ysf, False), prev_states(ysb, False), whf,
            whb, mask, dysf.to(ysf.dtype).contiguous(),
            dysb.to(ysb.dtype).contiguous())
        return (*grads, None)


def gru_scan_bidir(xpf, xpb, whf, whb, mask):
    """Both GRU directions over precomputed projections, with JAX's
    semantics (pallas_gru.py:501): xpb comes from the per-row reversed
    input, and both recursions run forward in time under ``mask``.
    xpf, xpb (T, B, 3H), whf, whb (H, 3H), mask (T, B, 1) -> (ysf, ysb)
    (T, B, H). Differentiable in f32 and with bf16 streams (K7, then K7b);
    with no input requiring grad, K7 alone runs and nothing is saved."""
    args = (xpf.contiguous(), xpb.contiguous(), whf.contiguous(),
            whb.contiguous(), mask)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xpf, xpb, whf, whb)):
        return _BidirScan.apply(*args)
    return gru_scan_bidir_fwd(*args)
