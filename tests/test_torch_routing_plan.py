"""K8's launch plan (``routing_plan``) and K8b's row chunks, on the CPU.

The plan is computed in Python and handed to the kernel, which refuses a
plan whose shared memory differs from its own layout (a card test holds
``routing_smem`` to ``tpuasr_routing_smem``). Here: every shape the wrapper
accepts has a plan that fits the card, the tiles cover every row once, the
cluster's CTAs split the capsules and the classes without overlap, and the
kernel's schedule (each CTA's partial s over its capsules, summed over the
cluster in rank order, then squashed) gives the routing of
``routed_caps_plain`` in float64.
"""

import numpy as np
import pytest
import torch

from tpuasr_torch.ops import routing as rm

SMEM = 232448


def _check_plan(R, I, Din, O, D):
    plan = rm.routing_plan(R, I, Din, O, D)
    gp = 1 << (-(-D // 4) - 1).bit_length()
    col = -(-O * gp // 32) * 32
    assert plan.threads == plan.row_groups * col + 32
    assert plan.threads <= (544 if plan.wide else 416)
    assert plan.threads % 32 == 0
    assert 1 <= plan.row_groups <= 15
    assert plan.rows == 8 * plan.row_groups
    assert plan.stages >= (1 if plan.wide else 2)
    assert plan.smem <= SMEM
    assert plan.smem == rm.routing_smem(Din, O, D, plan.cluster,
                                        plan.row_groups, plan.stages,
                                        plan.wide)
    # Every row in exactly one tile.
    assert plan.tiles * plan.rows >= R > (plan.tiles - 1) * plan.rows
    # The cluster's CTAs split the capsules and the classes.
    caps = [list(plan.capsules(I, q)) for q in range(plan.cluster)]
    assert sorted(i for c in caps for i in c) == list(range(I))
    cls = [list(plan.classes(O, q)) for q in range(plan.cluster)]
    assert sorted(o for c in cls for o in c) == list(range(O))
    return plan


def test_routing_plan_config4():
    """Config 4 (I=256, Din=8, O=48, D=16) at B=8 and 32 x 249 frames:
    clusters of 2 CTAs over tiles of 16 rows (two row groups of 8), 384
    class threads and a producer warp, W and u staged in 3 stages."""
    for R, tiles in ((1992, 125), (7968, 498)):
        plan = _check_plan(R, 256, 8, 48, 16)
        assert (plan.tiles, plan.cluster, plan.rows, plan.row_groups,
                plan.stages, plan.wide, plan.threads) == (
            tiles, 2, 16, 2, 3, False, 416)


@pytest.mark.parametrize("D", [1, 3, 4, 5, 8, 12, 16, 17, 32, 64, 100, 128])
@pytest.mark.parametrize("Din", [1, 5, 8, 12, 16])
def test_routing_plan_every_shape_fits(Din, D):
    """Every (R, I, O) the wrapper takes at this (Din, D) has a plan that
    fits: O from 1 to max_classes(D), I from 1 (fewer capsules than CTAs)
    to 4096, R from 1 to a B=32 batch."""
    top = rm.max_classes(D)
    for O in sorted({1, 2, 7, top // 3, top // 2, top - 1, top} - {0}):
        for I in (1, 3, 8, 17, 256, 4096):
            for R in (1, 21, 7968):
                _check_plan(R, I, Din, O, D)


def test_routing_plan_reads_W_from_L2_where_two_stages_do_not_fit():
    """W is staged while two stages of its capsule slab fit beside the
    tile's state (O=96, D=16 at Din=8); at Din=16 they do not, and at 512
    class threads (O=128, D=16) the staged instance has too few threads:
    both read W from L2."""
    assert _check_plan(10, 64, 8, 96, 16).wide is False
    assert _check_plan(100, 256, 16, 96, 16).wide is True
    assert _check_plan(14, 96, 8, 128, 16).wide is True


def test_routing_plan_refuses_what_the_kernel_does_not_take():
    for args in ((5, 4, 17, 4, 4), (5, 4, 0, 4, 4), (5, 0, 8, 4, 4),
                 (5, 4, 8, 129, 16), (5, 4, 8, 2, 129)):
        with pytest.raises(ValueError):
            rm.routing_plan(*args)


@pytest.mark.parametrize("R,I,O,D,iters", [(21, 20, 6, 4, 3),
                                           (37, 5, 7, 3, 2),
                                           (16, 33, 48, 16, 3)])
def test_kernel_schedule_is_the_routing(R, I, O, D, iters):
    """K8's schedule emulated in float64: each CTA of a cluster sums its
    capsules' c u_hat, the cluster adds the partials in rank order, the
    class owner squashes; V accumulates v. Equal to routed_caps_plain and
    to routing_residuals_plain (float64 against float32, 1e-5)."""
    rng = np.random.default_rng(3)
    Din = 8
    u = torch.tensor(rng.normal(size=(1, R, I, Din)) * 0.5,
                     dtype=torch.float64)
    W = torch.tensor(rng.normal(size=(I, Din, O * D)) * 0.3,
                     dtype=torch.float64)
    plan = rm.routing_plan(R, I, Din, O, D)
    u_hat = torch.einsum("btid,idk->btik", u, W).reshape(R, I, O, D)
    V = torch.zeros(R, O, D, dtype=torch.float64)
    for it in range(iters):
        b = torch.einsum("riod,rod->rio", u_hat, V)
        c = torch.softmax(b, dim=-1)
        s = torch.zeros(R, O, D, dtype=torch.float64)
        for q in range(plan.cluster):
            caps = list(plan.capsules(I, q))
            s = s + torch.einsum("rio,riod->rod", c[:, caps], u_hat[:, caps])
        v = rm.squash(s)
        if it + 1 < iters:
            V_prev, V = V, V + v
        else:
            V_prev = V
    u32, W32 = u.float(), W.float()
    want = rm.routed_caps_plain(u32, W32, O, D, iters)[0]
    Vw, sw = rm.routing_residuals_plain(u32, W32, O, D, iters)
    np.testing.assert_allclose(v.numpy(), want.double().numpy(), atol=1e-5)
    np.testing.assert_allclose(V_prev.numpy(), Vw[0].double().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), sw[0].double().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,I,sms,want", [(1992, 256, 132, 4),
                                          (7968, 256, 132, 4),
                                          (21, 20, 132, 2),
                                          (5, 96, 132, 1),
                                          (100, 1, 132, 7)])
def test_row_chunks(R, I, sms, want):
    """K8b's pass 2 splits the rows into chunks so that its blocks fill the
    card about six deep, no more chunks than tiles of 16 rows."""
    n = rm._row_chunks(R, I, sms)
    assert n == want
    assert 1 <= n <= -(-R // 16)
