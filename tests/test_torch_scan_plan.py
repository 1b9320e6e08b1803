"""The launch plan of K2/K4 (``tpuasr_torch.ops.gru._scan_plan``), on the CPU.

The plan chooses how the projection-fused GRU scan runs on the card: the
projection's padded widths, and for the cooperative recurrence the hidden
units a block owns (U), the batch rows it stages a pass (R), its shared
memory and its grid. Every block of the recurrence must be resident at
once (one 512-thread block an SM), so at every shape that the repository's
configurations serve or train, the plan must fit; a shape it cannot hold
raises ValueError before any launch.
"""

import pytest
import torch

from tpuasr_torch.ops.gru import (_MODE_K2, _MODE_Q8, _MODE_Q8_REC,
                                  _SMEM_BUDGET, _bidir_bwd_chunks,
                                  _bidir_bwd_smem, _scan_plan,
                                  _units_per_block)

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
        assert plan.R == 16 and plan.rg == 1 and plan.U & (plan.U - 1) == 0
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
    assert (plan.U, plan.R, plan.grid) == (4, 16, 128)


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
    (16, 512, 3000, "k2_f32", N_SM),      # K5: > 16 units a block
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


# K7b keeps per-row state in shared memory: past the rows a launch holds,
# gru_scan_bidir_bwd runs the rows in chunks, one launch each.
@pytest.mark.parametrize("B", [16, 64, 74, 75, 128, 256])
def test_k7b_chunks_cover_every_row_once(B):
    H = 512
    chunks = _bidir_bwd_chunks(B, H, N_SM)
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
    U = _units_per_block(H, N_SM)
    sizes = [b1 - b0 for b0, b1 in chunks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert all(_bidir_bwd_smem(n, H, U) <= _SMEM_BUDGET for n in sizes)
    assert len(chunks) == -(-B // 74)


def test_k7b_chunk_limit_at_the_served_width():
    """74 rows fit a launch at H=512 on 132 SMs (4 units a block), 75 do
    not; config 3's batches (16, 64) run in one launch."""
    U = _units_per_block(512, N_SM)
    assert U == 4
    assert _bidir_bwd_smem(74, 512, U) <= _SMEM_BUDGET
    assert _bidir_bwd_smem(75, 512, U) > _SMEM_BUDGET
    assert _bidir_bwd_chunks(16, 512) == [(0, 16)]
    assert _bidir_bwd_chunks(64, 512) == [(0, 64)]


def test_k7b_chunks_raise_where_no_row_fits():
    with pytest.raises(ValueError):
        _bidir_bwd_chunks(16, 4096, N_SM)
