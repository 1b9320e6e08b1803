"""The launch plan of K2/K4 (``tpuasr_torch.ops.gru._scan_plan``), on the CPU.

The plan chooses how the projection-fused GRU scan runs on the card: the
projection's padded widths, and for the cooperative recurrence the hidden
units a block owns (U), the batch rows it stages a pass (R), its shared
memory and its grid. Every block of the recurrence must be resident at
once (one 512-thread block an SM), so at every shape that the repository's
configurations serve or train, the plan must fit; a shape it cannot hold
raises ValueError before any launch.
"""

import re
from pathlib import Path

import pytest
import torch

from tpuasr_torch.ops.gru import (_MODE_K2, _MODE_Q8, _MODE_Q8_REC,
                                  _SMEM_BUDGET, RowGroupPlan,
                                  _bidir_f32_plan, _bidir_f32_smem,
                                  _f32_rec_plan, _lean_bf16_k3,
                                  _lean_bf16_ld, _lean_bf16_smem, _lean_plan,
                                  _lean_rows, _lean_smem, _scan_plan,
                                  _tn_slices, gru_scan_plain)

N_SM = 132                  # SMs of an H100 SXM
SMEM_MAX = 227 * 1024       # shared memory a block may take on an H100

# (mode, x dtype): K2 in f32 and bf16, K4 with bf16 or int8 recurrence.
MODES = {"k2_f32": (_MODE_K2, torch.float32),
         "k2_bf16": (_MODE_K2, torch.bfloat16),
         "k4_bf16": (_MODE_Q8, torch.bfloat16),
         "k4_rec_q8": (_MODE_Q8_REC, torch.bfloat16)}

# BASELINE config 5 (serving, 512 x 4 BiGRU: D 512 then 1024, H 512, every
# batch up to 256) and the deepspeech_var preset's training forward (384 x
# 6: D 512 then 768, H 384, B 16 and 64).
SERVED = [(B, D, 512, mode) for B in (1, 2, 7, 16, 64, 128, 129, 256)
          for D in (512, 1024) for mode in MODES]
TRAINED = [(B, D, 384, "k2_f32") for B in (16, 64) for D in (512, 768)]


def _check_fits(plan, B, H):
    assert plan.smem <= _SMEM_BUDGET <= SMEM_MAX
    assert plan.grid <= N_SM
    assert plan.grid == plan.ndir * plan.rg * -(-H // plan.U)
    if plan.rec == "f32":             # K5's forward: 16 rows a pass
        assert plan.R == 16 and plan.U in (1, 2, 4, 8, 16)
        rp = _f32_rec_plan(B, H, N_SM)
        assert (plan.U, plan.rg, plan.grid, plan.smem, plan.kc) == (
            rp.U, rp.rg, rp.grid, rp.smem, rp.kc)
        _check_rows(B, plan.rg)
    else:                             # two (row, unit) items a thread
        assert plan.U in (8, 16)
        assert plan.R * plan.U <= 1024 and plan.R in (16, 32, 64, 128)
        rows = -(-B // plan.rg)       # a row group's rows
        assert plan.R <= max(16, 2 * rows) and rows >= min(B, 16)
        assert plan.hk >= H


@pytest.mark.parametrize("B,D,H,mode", SERVED + TRAINED)
def test_plan_fits_served_and_trained_shapes(B, D, H, mode):
    plan = _scan_plan(B, D, H, *MODES[mode], n_sm=N_SM)
    want = {"k2_f32": ("f32", "f32"), "k2_bf16": ("bf16", "bf16"),
            "k4_bf16": ("int8", "bf16"), "k4_rec_q8": ("int8", "int8")}
    assert (plan.proj, plan.rec) == want[mode]
    _check_fits(plan, B, H)
    # The projection's weights: 3H padded to whole 128-column tiles, D to
    # a whole stage of the contraction.
    assert plan.np % 128 == 0 and plan.np >= 3 * H
    assert plan.kp >= D and plan.kp % (8 if plan.proj == "f32" else 32) == 0


def test_plan_serving_layer():
    """At the served layer (B=128, H=512) the tensor-core recurrence runs 32
    groups of 16 units times 4 row groups, 128 blocks, and each stages its
    32 rows in one pass (8 units would leave 2 row groups of 64 rows); at
    B=16 one row group of 8-unit blocks."""
    for mode in ("k2_bf16", "k4_bf16", "k4_rec_q8"):
        plan = _scan_plan(128, 1024, 512, *MODES[mode])
        assert (plan.U, plan.R, plan.rg, plan.grid) == (16, 32, 4, 128)
        plan = _scan_plan(16, 1024, 512, *MODES[mode])
        assert (plan.U, plan.R, plan.rg, plan.grid) == (8, 16, 1, 64)
    plan = _scan_plan(128, 1024, 512, *MODES["k2_f32"])
    assert (plan.U, plan.R, plan.rg, plan.grid) == (16, 16, 4, 128)


def test_plan_any_batch():
    """No batch limit: the rows are staged in passes, so the shared memory
    does not grow with B."""
    small = _scan_plan(256, 1024, 512, *MODES["k2_bf16"])
    for B in (257, 1000, 4096, 100_000):
        plan = _scan_plan(B, 1024, 512, *MODES["k2_bf16"])
        assert plan == small


@pytest.mark.parametrize("B,D,H,mode,n_sm", [
    (16, 512, 2048, "k2_bf16", N_SM),     # Wh columns + one pass > budget
    (16, 512, 2200, "k2_bf16", N_SM),     # > 132 blocks of 16 units
    (16, 512, 3000, "k2_f32", N_SM),      # f32: > 132 blocks of 16 units
    (16, 512, 512, "k4_rec_q8", 16),      # a small card: > 16 blocks
])
def test_plan_raises_for_shapes_that_cannot_fit(B, D, H, mode, n_sm):
    with pytest.raises(ValueError):
        _scan_plan(B, D, H, *MODES[mode], n_sm=n_sm)


def test_plan_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _scan_plan(4, 8, 8, _MODE_K2, torch.float16)


# K7's bf16 forward: the tensor-core recurrence with both directions in one
# grid, at every served batch of the 512-wide BiGRU.
@pytest.mark.parametrize("B", [1, 2, 7, 16, 64, 128, 129, 256])
def test_two_direction_plan_fits_served_batches(B):
    plan = _scan_plan(B, 512, 512, _MODE_K2, torch.bfloat16, n_sm=N_SM,
                      ndir=2)
    assert (plan.rec, plan.ndir) == ("bf16", 2)
    _check_fits(plan, B, 512)
    assert plan.grid == 2 * plan.rg * -(-512 // plan.U) <= N_SM


def test_two_direction_plan_serving_layer():
    """At the served batch (B=128, H=512) each direction takes 2 row groups
    of 64 rows x 32 groups of 16 units: 128 blocks, one pass of 64 rows a
    step (8 units would leave one group of all 128 rows)."""
    plan = _scan_plan(128, 512, 512, _MODE_K2, torch.bfloat16, ndir=2)
    assert (plan.U, plan.R, plan.rg, plan.grid) == (16, 64, 2, 128)
    one = _scan_plan(128, 512, 512, _MODE_K2, torch.bfloat16)
    assert one.ndir == 1 and one.grid == 128 and one.rg == 4


@pytest.mark.parametrize("B,H,mode,dtype,n_sm", [
    (16, 2200, _MODE_K2, torch.bfloat16, N_SM),   # > 132 blocks of 16 units
    (16, 1100, _MODE_K2, torch.bfloat16, N_SM),   # 2 x 69 blocks > 132
    (16, 512, _MODE_K2, torch.bfloat16, 16),      # a small card
    (16, 512, _MODE_K2, torch.float32, N_SM),     # f32 is K5's design
    (16, 512, _MODE_Q8_REC, torch.bfloat16, N_SM),
])
def test_two_direction_plan_raises(B, H, mode, dtype, n_sm):
    with pytest.raises(ValueError):
        _scan_plan(B, H, H, mode, dtype, n_sm=n_sm, ndir=2)


# The float32 GRU backward (ops/gru.py, csrc/gru_lean.cu): the lean
# recurrence of K2b and K5b (one direction) and K7b (two) must plan at every
# batch and at every width up to the forward's, 1056 on 132 SMs: the shapes
# the old fused kernels refused (B=683 and H >= 529 for all three, B=146 at
# H=512 and B=609 at D=768 for K2b) among them.
BATCHES = (1, 7, 16, 64, 75, 128, 146, 683)
WIDTHS = (384, 512, 529, 640, 1024)


@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_lean_plan_covers_every_row_once_within_budget(B, H, ndir):
    plan = _lean_plan(B, H, ndir, N_SM)
    assert plan.U in (1, 2, 4, 8, 16)
    assert plan.smem == _lean_smem(H, plan.U, plan.kc)
    assert plan.smem <= _SMEM_BUDGET <= SMEM_MAX
    assert plan.kc % 128 == 0
    assert plan.grid == plan.ndir * plan.rg * -(-H // plan.U) <= N_SM
    assert plan.ndir in (1, ndir)
    _check_rows(B, plan.rg)
    # The 3H contraction in whole chunks: Wh's rows then the staged chunk.
    nch = -(-3 * H // plan.kc)
    assert nch * plan.kc >= 3 * H > (nch - 1) * plan.kc


def _check_rows(B, rg):
    """Every row in exactly one row group, none empty; a group holds at
    least 16 rows unless the batch is smaller."""
    rows = _lean_rows(B, rg)
    assert rows[0][0] == 0 and rows[-1][1] == B
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(rows, rows[1:]))
    assert all(b1 > b0 for b0, b1 in rows)
    assert min(b1 - b0 for b0, b1 in rows) >= min(B, 16) - rg


@pytest.mark.parametrize("H", WIDTHS + (40, 130, 694, 695, 1056))
def test_k5b_plan_takes_any_batch_up_to_the_forward_width(H):
    """K5b runs the lean recurrence at one direction (``_lean_plan(B, H,
    1)``): at every width the forward plans (``_scan_plan`` in f32, up to
    1056) and at any batch, every row lies in one row group and the block
    fits the budget; nothing in it grows with the batch."""
    _scan_plan(16, H, H, _MODE_K2, torch.float32, n_sm=N_SM)
    for B in (1, 16, 64, 683, 100_000):
        plan = _lean_plan(B, H, 1, N_SM)
        assert plan.ndir == 1 and plan.U in (1, 2, 4, 8, 16)
        assert plan.smem == _lean_smem(H, plan.U, plan.kc) <= _SMEM_BUDGET
        assert plan.grid == plan.rg * -(-H // plan.U) <= N_SM
        _check_rows(B, plan.rg)


def test_backward_plans_at_the_trained_shapes():
    """K7b at config 3's H=512 runs both directions in one grid: 128
    blocks of 8 units at B=16, and at B=64 and 128 two row groups of 16
    units; K2b at the deepspeech_var width (H=384) 96 blocks of 4 units at
    B=16 and 4 row groups of 16 units at B=64."""
    plan = _lean_plan(16, 512, 2, N_SM)
    assert (plan.U, plan.rg, plan.ndir, plan.grid) == (8, 1, 2, 128)
    for B in (64, 128, 683):
        plan = _lean_plan(B, 512, 2, N_SM)
        assert (plan.U, plan.rg, plan.ndir, plan.grid) == (16, 2, 2, 128)
    plan = _lean_plan(16, 384, 1, N_SM)
    assert (plan.U, plan.grid) == (4, 96)
    plan = _lean_plan(64, 384, 1, N_SM)
    assert (plan.U, plan.rg) == (16, 4)


def test_two_directions_split_where_one_grid_cannot_hold_them():
    """Past two chunks of the contraction a direction takes a launch of its
    own (H=1024: 8 units a block, 128 blocks a launch)."""
    plan = _lean_plan(16, 1024, 2, N_SM)
    assert plan.ndir == 1 and plan.grid <= N_SM


# The lean plan's widest H at one direction on 132 SMs (K5b, K2b): U=16
# with chunks of 128 of the 3H contraction.
LEAN_MAX_H = 1109


@pytest.mark.parametrize("H,n_sm", [(1057, N_SM), (4096, N_SM)])
def test_backward_plans_raise_past_the_width(H, n_sm):
    """K5b's and K2b's plan (the lean plan at one direction) holds H up to
    1109 on 132 SMs and raises past it; the forward (K5, K7) stops at
    1056, so every width they train fits."""
    _lean_plan(16, LEAN_MAX_H, 1, n_sm)
    _lean_plan(683, LEAN_MAX_H, 1, n_sm)
    with pytest.raises(ValueError):
        _lean_plan(16, LEAN_MAX_H + 1, 1, n_sm)
    with pytest.raises(ValueError):
        _lean_plan(16, 2 * H, 1, n_sm)
    with pytest.raises(ValueError):
        _bidir_f32_plan(16, H, n_sm)


# The lean recurrence's bf16 body (csrc/gru_lean.cu, gru_lean_bf16_kernel):
# Wh's rows of U = 8, 16 or 32 units resident in bf16 over the whole 3H
# contraction, no chunks; the bf16 streams' backward must plan wherever the
# bf16 forward does.
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("H", WIDTHS + (40, 130, 1056))
@pytest.mark.parametrize("B", BATCHES)
def test_lean_bf16_plan_covers_every_row_once_within_budget(B, H, ndir):
    plan = _lean_plan(B, H, ndir, N_SM, bf16=True)
    assert plan.U in (8, 16, 32)
    assert plan.smem == _lean_bf16_smem(H, plan.U)
    assert plan.smem <= _SMEM_BUDGET <= SMEM_MAX
    assert plan.kc == _lean_bf16_k3(H) >= 3 * H and plan.kc % 32 == 0
    assert plan.grid == plan.ndir * plan.rg * -(-H // plan.U) <= N_SM
    assert plan.ndir in (1, ndir)
    _check_rows(B, plan.rg)


@pytest.mark.parametrize("B,H,ndir,want", [
    (16, 512, 1, (32, 1, 16)), (64, 512, 1, (32, 4, 64)),
    (128, 512, 1, (32, 8, 128)), (16, 512, 2, (32, 1, 32)),
    (64, 512, 2, (32, 4, 128)), (128, 512, 2, (32, 4, 128)),
    (16, 384, 1, (32, 1, 12))])
def test_lean_bf16_plans_at_the_trained_shapes(B, H, ndir, want):
    """At the trained shapes (config 3's H=512 at B=16, 64 and 128, one
    direction for K5b-bf16 and two for K7b-bf16; deepspeech_var's H=384 at
    B=16 for K2b-bf16) the bf16 body takes 32 units a block (a step stages
    a row group's rows once a block, so the fewest blocks that leave 16
    rows a block stage the fewest bytes), every row once, within the
    budget: (U, row groups, grid)."""
    plan = _lean_plan(B, H, ndir, N_SM, bf16=True)
    assert (plan.U, plan.rg, plan.grid) == want
    assert plan.ndir == ndir and plan.smem <= _SMEM_BUDGET
    _check_rows(B, plan.rg)


def test_lean_bf16_plan_holds_every_width_the_bf16_forward_does():
    """Every H the bf16 forward's recurrence plans (``_scan_plan`` in bf16,
    one direction) the bf16 backward plans too; it raises ValueError past
    H=2112 on 132 SMs (16 units a block, 132 blocks)."""
    widest = 0
    for H in range(32, 2200, 32):
        try:
            _scan_plan(16, H, H, _MODE_K2, torch.bfloat16, n_sm=N_SM)
        except ValueError:
            continue
        widest = H
        _lean_plan(16, H, 1, N_SM, bf16=True)
        _lean_plan(683, H, 2, N_SM, bf16=True)
    assert widest >= 1024
    _lean_plan(16, 2112, 1, N_SM, bf16=True)
    with pytest.raises(ValueError):
        _lean_plan(16, 2113, 1, N_SM, bf16=True)


def _c_returns(src: str, name: str) -> str:
    """The expression a one-statement C function ``name`` returns, as
    Python: casts dropped, integer division floored (all operands are
    non-negative), comparisons read as 0 or 1."""
    m = re.search(name + r"\([^)]*\)\s*\{\s*return\s+(.*?);\s*\}", src,
                  re.S)
    assert m, name
    expr = re.sub(r"static_cast<\w+>", "", m.group(1))
    return expr.replace("/", "//")


def test_lean_bf16_smem_is_the_kernels_formula():
    """``_lean_bf16_smem`` (and the row and contraction it rests on) is
    csrc/gru_lean.cu's lean_bf16_smem_bytes as written in the source, at
    every width up to 2112 and every U the plan takes."""
    src = (Path(__file__).resolve().parents[1] / "tpuasr_torch" / "csrc"
           / "gru_lean.cu").read_text()
    consts = dict(kPiece=int(re.search(r"kPiece = (\d+);", src).group(1)),
                  kThreads=512, kR=16)
    consts["kWarps"] = consts["kThreads"] // 32
    k3 = _c_returns(src, "lean_bf16_k3")
    ld = _c_returns(src, "lean_bf16_ld")
    smem = _c_returns(src, "lean_bf16_smem_bytes")
    for H in range(1, 2113, 7):
        env = dict(consts, H=H)
        env["lean_bf16_k3"] = lambda h: eval(k3, dict(env, H=h))
        env["lean_bf16_ld"] = lambda h: int(eval(ld, dict(env, H=h)))
        assert env["lean_bf16_k3"](H) == _lean_bf16_k3(H)
        assert env["lean_bf16_ld"](H) == _lean_bf16_ld(H)
        for U in (8, 16, 32):
            assert eval(smem, dict(env, U=U)) == _lean_bf16_smem(H, U)


@pytest.mark.parametrize("B,H,ndir,want", [
    (16, 512, 1, RowGroupPlan(4, 1, 1536, 124928, 128, 1)),
    (64, 512, 1, RowGroupPlan(16, 4, 1536, 198656, 128, 1)),
    (128, 512, 1, RowGroupPlan(16, 4, 1536, 198656, 128, 1)),
    (16, 512, 2, RowGroupPlan(8, 1, 1536, 149504, 128, 2)),
    (64, 512, 2, RowGroupPlan(16, 2, 1536, 198656, 128, 2)),
    (128, 512, 2, RowGroupPlan(16, 2, 1536, 198656, 128, 2)),
    (16, 384, 1, RowGroupPlan(4, 1, 1152, 94208, 96, 1)),
    (64, 384, 1, RowGroupPlan(16, 4, 1152, 149504, 96, 1))])
def test_lean_f32_plans_are_pinned(B, H, ndir, want):
    """The f32 lean plans at the trained shapes stay as they were: the f32
    body is unchanged beside the bf16 one."""
    assert _lean_plan(B, H, ndir, N_SM) == want


@pytest.mark.parametrize("M,N1,N2", [(3984, 512, 1536), (15936, 769, 1152),
                                     (7, 40, 120), (170067, 512, 1536)])
def test_weight_gradient_slices(M, N1, N2):
    """Phase c's row slices: at least one, none under 512 rows unless the
    rows are fewer, and no more blocks than one wave of two an SM holds
    unless the tiles alone are more."""
    S = _tn_slices(M, N1, N2, N_SM)
    tiles = -(-N1 // 128) * -(-N2 // 128)
    assert S >= 1 and (S == 1 or M // S >= 512)
    assert S == 1 or S * tiles <= 2 * N_SM


# K7's f32 forward (csrc/gru_bidir.cu, ``_bidir_f32_plan``): directions x
# row groups x unit groups, Wh's 3U columns of a block's units resident,
# the H contraction staged in chunks; both directions in one grid where the
# contraction takes at most two chunks, else a launch each. It must plan
# every batch at every width up to 1056 on 132 SMs (the old kernel refused
# H >= 571).
F32_BATCHES = (1, 7, 16, 64, 128, 129, 683)
F32_WIDTHS = (40, 384, 512, 571, 640, 1024, 1056)


def _two_directions_fit(H):
    """Whether any U of 1-16 holds both directions in one grid: 2 *
    ceil(H / U) blocks resident and the block within the budget with the
    contraction in at most two chunks."""
    for U in (1, 2, 4, 8, 16):
        if 2 * -(-H // U) > N_SM:
            continue
        for nch in (1, 2):
            kc = -(-(-(-H // nch)) // 128) * 128
            if _bidir_f32_smem(H, U, kc) <= _SMEM_BUDGET:
                return True
    return False


@pytest.mark.parametrize("H", F32_WIDTHS)
@pytest.mark.parametrize("B", F32_BATCHES)
def test_bidir_f32_plan_covers_every_row_once_within_budget(B, H):
    plan = _bidir_f32_plan(B, H, N_SM)
    assert plan.U in (1, 2, 4, 8, 16) and plan.kc % 128 == 0
    # The kernel's layout (bidir_smem_bytes): Wh's 3U columns over the
    # chunks, two staged chunks of 16 rows, the warps' sums (8 rows x 3
    # gates x min(U, 2) units a warp).
    nch = -(-H // plan.kc)
    assert nch * plan.kc >= H > (nch - 1) * plan.kc
    assert plan.smem == 4 * (3 * plan.U * nch * plan.kc + 2 * 16 * plan.kc
                             + 16 * 8 * 3 * min(plan.U, 2))
    assert plan.smem == _bidir_f32_smem(H, plan.U, plan.kc)
    assert plan.smem <= _SMEM_BUDGET <= SMEM_MAX
    assert plan.grid == plan.ndir * plan.rg * -(-H // plan.U) <= N_SM
    _check_rows(B, plan.rg)
    # A launch a direction exactly where the two cannot share a grid.
    assert (plan.ndir == 2) == _two_directions_fit(H) == (H <= 768)


def test_bidir_f32_plans_at_the_trained_shapes():
    """At config 3's H=512: 2 directions x 64 groups of 8 units (128
    blocks, one row group of 16 rows) at B=16; 2 x 2 row groups x 32
    groups of 16 units at B=64 and 128 (32 and 64 rows a block, staged 16
    a pass); at B=32, 16 rows a block. The repaired widths: H=640 in one
    grid of 80 blocks of 16 units (203 KiB each: 120 KiB of Wh, two
    staging buffers of 40 KiB), H=1056 a launch a direction of 132 blocks
    of 8 units, the contraction in two chunks of 640."""
    got = {B: _bidir_f32_plan(B, 512, N_SM) for B in (16, 32, 64, 128)}
    assert [(p.U, p.rg, p.ndir, p.grid) for p in got.values()] == [
        (8, 1, 2, 128), (16, 2, 2, 128), (16, 2, 2, 128), (16, 2, 2, 128)]
    assert -(-32 // got[32].rg) == 16
    plan = _bidir_f32_plan(16, 640, N_SM)
    assert (plan.U, plan.ndir, plan.grid, plan.kc) == (16, 2, 80, 640)
    assert plan.smem == 207872
    plan = _bidir_f32_plan(16, 1056, N_SM)
    assert (plan.U, plan.ndir, plan.grid, plan.kc) == (8, 1, 132, 640)


@pytest.mark.parametrize("B,H,n_sm", [(16, 1057, N_SM), (683, 1100, N_SM),
                                      (16, 4096, N_SM), (16, 512, 16)])
def test_bidir_f32_plan_raises_past_the_width(B, H, n_sm):
    with pytest.raises(ValueError, match="K7's f32 forward"):
        _bidir_f32_plan(B, H, n_sm)


# The f32 recurrence at one direction (``_f32_rec_plan``): K5's forward and
# K2's f32 recurrence run csrc/gru_bidir.cu's kernel with it, forward or
# reverse. It must plan every batch at every width K5 served before (H up
# to 1056 on 132 SMs), cover each (row, unit) of a step exactly once, and
# fill the card at the trained shapes.
ONE_DIR_BATCHES = (1, 16, 64, 683)
ONE_DIR_WIDTHS = (40, 130, 384, 512, 640, 1024, 1056)


def _emulate_rows(plan, xp, wh, mask, reverse):
    """The plan's schedule on the CPU: each step, block (rg, ug) computes
    the gates of its row group's rows for its U units from h_prev (ys at
    the previous step's time), as the kernel does; every (row, unit) of a
    step must be written exactly once."""
    T, B, H3 = xp.shape
    H = H3 // 3
    ys = torch.zeros(T, B, H, dtype=torch.float64)
    for s in range(T):
        t = T - 1 - s if reverse else s
        tp = t + 1 if reverse else t - 1
        h_prev = ys[tp] if s else torch.zeros(B, H, dtype=torch.float64)
        hits = torch.zeros(B, H, dtype=torch.int64)
        for b0, b1 in _lean_rows(B, plan.rg):
            for u0 in range(0, H, plan.U):
                j = torch.arange(u0, min(H, u0 + plan.U))
                hp = h_prev[b0:b1] @ wh[:, torch.cat([j, H + j, 2 * H + j])]
                x = xp[t, b0:b1]
                n = len(j)
                r = torch.sigmoid(x[:, j] + hp[:, :n])
                z = torch.sigmoid(x[:, H + j] + hp[:, n:2 * n])
                g = torch.tanh(x[:, 2 * H + j] + r * hp[:, 2 * n:])
                h = h_prev[b0:b1][:, j]
                m = mask[t, b0:b1]
                ys[t, b0:b1, u0:u0 + n] = m * ((1 - z) * g + z * h) + (
                    1 - m) * h
                hits[b0:b1, u0:u0 + n] += 1
        assert bool((hits == 1).all())
    return ys


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", ONE_DIR_WIDTHS)
@pytest.mark.parametrize("B", ONE_DIR_BATCHES)
def test_one_direction_plan_covers_every_row_once_within_budget(B, H,
                                                                reverse):
    plan = _f32_rec_plan(B, H, N_SM)
    assert plan.ndir == 1 and plan.U in (1, 2, 4, 8, 16)
    assert plan.kc % 128 == 0
    nch = -(-H // plan.kc)
    assert nch * plan.kc >= H > (nch - 1) * plan.kc
    assert plan.smem == _bidir_f32_smem(H, plan.U, plan.kc) <= _SMEM_BUDGET
    assert plan.grid == plan.rg * -(-H // plan.U) <= N_SM
    _check_rows(B, plan.rg)
    # The schedule at a short T on ragged rows: each (row, unit) once a
    # step, and the plain scan's result (the emulation runs in float64, the
    # plain scan in float32: within 1e-6).
    if B * H > 64 * 512:
        return
    T = 3
    g = torch.Generator().manual_seed(B * 7 + H)
    xp = torch.randn(T, B, 3 * H, generator=g, dtype=torch.float64)
    wh = torch.randn(H, 3 * H, generator=g, dtype=torch.float64) / H ** 0.5
    lens = torch.randint(0, T + 1, (B,), generator=g)
    lens[0] = T
    mask = (torch.arange(T)[:, None] < lens[None, :]).double()[:, :, None]
    got = _emulate_rows(plan, xp, wh, mask, reverse)
    want = gru_scan_plain(xp, wh, mask, reverse)
    torch.testing.assert_close(got, want.double(), rtol=0, atol=1e-6)


def test_one_direction_plan_fills_the_card_at_the_trained_shapes():
    """Config 3 (H=512) and deepspeech_var (H=384) at B=16: 128 and 96
    blocks of 4 units, every row in one row group; at B=64 four row groups
    of 16 rows of 16-unit blocks."""
    for H, grid in ((512, 128), (384, 96)):
        plan = _f32_rec_plan(16, H, N_SM)
        assert (plan.U, plan.rg, plan.grid) == (4, 1, grid)
        assert plan.grid >= 96
        plan = _f32_rec_plan(64, H, N_SM)
        assert (plan.U, plan.rg) == (16, 4) and plan.grid >= 96
        # K2's f32 recurrence takes the same plan.
        sp = _scan_plan(16, 768, H, _MODE_K2, torch.float32, N_SM)
        assert (sp.U, sp.rg, sp.grid, sp.kc) == (4, 1, grid, H)


@pytest.mark.parametrize("B,H,n_sm", [(16, 1057, N_SM), (683, 1100, N_SM),
                                      (16, 4096, N_SM), (16, 512, 16)])
def test_one_direction_plan_raises_past_the_width(B, H, n_sm):
    with pytest.raises(ValueError, match="f32 GRU recurrence"):
        _f32_rec_plan(B, H, n_sm)
    with pytest.raises(ValueError):
        _scan_plan(B, 512, H, _MODE_K2, torch.float32, n_sm)
