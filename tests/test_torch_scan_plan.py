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
                                  _SMEM_BUDGET, _scan_plan)

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
    assert plan.grid <= N_SM and plan.grid == plan.rg * -(-H // plan.U)
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
