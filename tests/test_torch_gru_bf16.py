"""tpuasr_torch's GRU scans with bf16 streams against the JAX kernels (CPU).

JAX's GRU kernels take bf16 streams in both directions (pallas_gru.py:163,
:190, :437, :736): the same numpy inputs, rounded to bf16, go through
``jax.vjp`` of JAX's ``gru_scan``, ``gru_scan_xfused`` and
``gru_scan_bidir`` (Pallas with ``interpret=True``, which the JAX package
selects off a TPU) and through the port's autograd over its kernels' plain
versions (K5-bf16, K5b-bf16, K2b-bf16 on both routes, K7b-bf16). Both round
to bf16 at the same points: ys, h before h@Wh, dys, dhp before dhp@Wh^T,
dxp (K5b, K7b) or dxp before dxp@Wx^T (K2b), and the weight gradients at
the end. They differ only where an f32 sum taken in another order lands on
the other side of a bf16 rounding boundary: one bf16 ulp, 2^-8 relative.

Then DeepSpeechCTC in training (train=True: batch statistics, no dropout)
with the bf16 flags that route through these kernels, against ``jax.grad``
of the Flax model on converted weights (``torch_bf16_common``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from tpuasr.ops import gru_scan as j_scan
from tpuasr.ops.pallas_gru import _xf_bwd_recompute
from tpuasr.ops.pallas_gru import gru_scan_bidir as j_bidir
from tpuasr.ops.pallas_gru import gru_scan_xfused as j_xfused
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops.gru import (gru_bwd_lean_plain, gru_scan,
                                  gru_scan_bidir, gru_scan_bwd_plain,
                                  gru_scan_xfused, prev_states, split_bf16,
                                  tn_product_split_plain)

from torch_bf16_common import check_model_grads

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]

T, B, D, H = 20, 2, 12, 16
JBF, TBF = jnp.bfloat16, torch.bfloat16

# Tolerances, in units of each tensor's largest magnitude: 2^-7, two bf16
# ulps at that magnitude. ys and the gradients agree bit for bit on most
# elements (measured: ys exact, dxp within 1.2e-4 of values up to 1, dwh
# exact); a flipped rounding of h or dhp moves the next steps' values by
# about one ulp of theirs, so two ulps of the largest covers an echo.
REL = 2.0 ** -7


def _case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    wx = (rng.standard_normal((D, 3 * H)) * 0.4).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) * 0.4).astype(np.float32)
    b = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    lens = np.array([T, 13])
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    return x, wx, wh, b, mask[:, :, None], dys


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = REL * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _bf16_valued(t):
    return torch.equal(t.float(), t.float().to(TBF).float())


def _leaves(*arrays, dtypes):
    return [torch.tensor(a).to(dt).requires_grad_()
            for a, dt in zip(arrays, dtypes)]


@pytest.mark.parametrize("reverse", [False, True])
def test_k5_k5b_bf16_match_jax(reverse):
    """K5-bf16 and K5b-bf16 (gru_scan over bf16 xp and wh) against
    jax.vjp of JAX's gru_scan on the same bf16 inputs: ys, dxp, dwh; dxp
    and dwh come back in bf16, as JAX's ``.astype`` returns them."""
    x, wx, wh, b, mask, dys = _case(0)
    xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H)
    ys_j, vjp = jax.vjp(lambda a, w: j_scan(a, w, jnp.asarray(mask),
                                            reverse),
                        jnp.asarray(xp, JBF), jnp.asarray(wh, JBF))
    dxp_j, dwh_j = vjp(jnp.asarray(dys, JBF))
    xpt, wht = _leaves(xp, wh, dtypes=(TBF, TBF))
    ys = gru_scan(xpt, wht, torch.tensor(mask), reverse)
    ys.backward(torch.tensor(dys).to(TBF))
    assert ys.dtype == TBF and xpt.grad.dtype == TBF
    assert wht.grad.dtype == TBF
    _close(ys, ys_j, "ys")
    _close(xpt.grad, dxp_j, "dxp")
    _close(wht.grad, dwh_j, "dwh")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("route", ["fused", "recompute"])
def test_k2b_bf16_matches_jax(route, reverse):
    """K2b-bf16 on both of JAX's routes: the fused one (jax.vjp of
    gru_scan_xfused, which takes ``_xf_bwd_fused`` at these widths) and the
    recompute one (JAX's ``_xf_bwd_recompute`` called directly, the port's
    rule patched to take it). dx, dwx and dwh come back in bf16, db in
    f32."""
    x, wx, wh, b, mask, dys = _case(1)
    args_j = (jnp.asarray(x, JBF), jnp.asarray(wx, JBF), jnp.asarray(b),
              jnp.asarray(wh, JBF))
    ys_j, vjp = jax.vjp(lambda *a: j_xfused(*a, jnp.asarray(mask), reverse),
                        *args_j)
    if route == "fused":
        grads_j = vjp(jnp.asarray(dys, JBF))
    else:
        grads_j = _xf_bwd_recompute((*args_j, jnp.asarray(mask), ys_j),
                                    jnp.asarray(dys, JBF), reverse)[:4]
    leaves = _leaves(x, wx, b, wh, dtypes=(TBF, TBF, torch.float32, TBF))
    with mock.patch.object(gru_mod, "xfused_bwd_is_fused",
                           lambda D_, H_: route == "fused"):
        ys = gru_scan_xfused(*leaves, torch.tensor(mask), reverse)
        ys.backward(torch.tensor(dys).to(TBF))
    _close(ys, ys_j, "ys")
    for name, t, g in zip(("dx", "dwx", "db", "dwh"), leaves, grads_j):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, g, name)
    assert _bf16_valued(leaves[1].grad) and _bf16_valued(leaves[3].grad)


def test_k7b_bf16_matches_jax():
    """K7b-bf16: jax.vjp of gru_scan_bidir with bf16 xpf, xpb, whf, whb
    (both recursions forward in time, xpb reversed per row outside)."""
    x, wx, wh, b, mask, dys = _case(2)
    xpf = (x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H)
    xpb = (x[::-1].reshape(T * B, D) @ wx * 0.8).reshape(T, B, 3 * H)
    whb = (wh * 0.9).astype(np.float32)
    dysb = np.ascontiguousarray(dys[::-1] * 0.5)
    ys_j, vjp = jax.vjp(lambda *a: j_bidir(*a, jnp.asarray(mask)),
                        *[jnp.asarray(a, JBF) for a in (xpf, xpb, wh, whb)])
    grads_j = vjp((jnp.asarray(dys, JBF), jnp.asarray(dysb, JBF)))
    leaves = _leaves(xpf, xpb, wh, whb, dtypes=(TBF,) * 4)
    ysf, ysb = gru_scan_bidir(*leaves, torch.tensor(mask))
    torch.autograd.backward((ysf, ysb), (torch.tensor(dys).to(TBF),
                                         torch.tensor(dysb).to(TBF)))
    _close(ysf, ys_j[0], "ysf")
    _close(ysb, ys_j[1], "ysb")
    for name, t, g in zip(("dxpf", "dxpb", "dwhf", "dwhb"), leaves,
                          grads_j):
        assert t.grad.dtype == TBF, name
        _close(t.grad, g, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lean_plain_bf16_is_k5b_phase_b(reverse):
    """The lean recurrence's plain version in its bf16 mode (wh in bf16:
    dhp rounded for dhp@Wh^T) composed with the f32 products of phases a
    and c gives K5b-bf16's plain version bit for bit after the casts: the
    kernel's three phases compute K5b-bf16's function."""
    x, wx, wh, b, mask, dys = _case(3)
    xp = torch.tensor((x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H))
    xp, whb = xp.to(TBF), torch.tensor(wh).to(TBF)
    m = torch.tensor(mask)
    ysp = prev_states(gru_mod.gru_scan_plain(xp, whb, m, reverse), reverse)
    d = torch.tensor(dys).to(TBF)
    want_dxp, want_dwh = gru_scan_bwd_plain(xp, ysp, whb, m, d, reverse)
    f32 = torch.float32
    hp = (ysp.reshape(T * B, H).to(f32) @ whb.to(f32)).reshape(T, B, 3 * H)
    dxp, dhp = gru_bwd_lean_plain(xp.to(f32), hp, ysp.to(f32), whb, m,
                                  d.to(f32), reverse)
    dwh = ysp.reshape(T * B, H).to(f32).T @ dhp.reshape(T * B, 3 * H)
    assert torch.equal(dxp.to(TBF), want_dxp)
    np.testing.assert_allclose(dwh.to(TBF).float().numpy(),
                               want_dwh.float().numpy(), rtol=2.0 ** -7,
                               atol=0)


def test_split_bf16_is_exact():
    """Phase c's split of an f32 value into three bf16 terms: hi + mid +
    lo is the value exactly (f64 sums), each term holds a bf16 value, and
    |mid| <= 2^-8 |hi|, |lo| <= 2^-16 |hi| (each term the rounding
    remainder of the one before), over eight decades and signed zeros."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal(200_000)
         * 10.0 ** rng.uniform(-4, 4, 200_000)).astype(np.float32)
    v[:4] = [0.0, -0.0, 1.0, np.float32(1 + 2 ** -23)]
    t = torch.tensor(v)
    hi, mid, lo = split_bf16(t)
    assert all(x.dtype == TBF for x in (hi, mid, lo))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, t.double())
    assert (mid.double().abs() <= 2.0 ** -8 * hi.double().abs()).all()
    assert (lo.double().abs() <= 2.0 ** -16 * hi.double().abs()).all()


@pytest.mark.parametrize("M,N1,N2,ones", [(3984, 512, 1536, False),
                                          (3984, 384, 1152, False),
                                          (3984, 768, 1152, True)])
def test_split_product_matches_float64(M, N1, N2, ones):
    """The plain version of phase c's bf16 product (a bf16, b f32 split
    into three bf16 terms, three products in f32) at phase c's shapes
    (T'=249 x B=16 rows: K5b-bf16's dWh at H=512, K2b-bf16's dWh and dWx
    with db at H=384, D=768) against a^T b in float64: every product is
    exact, so the error is the f32 sums' alone: within sqrt(3M) 2^-24
    (|a|^T |b|) elementwise, the typical size of rounding errors over
    three sums of M terms (these inputs stay under 0.01 of it, as the
    plain f32 product a^T b does); a product over b rounded to one bf16
    term lands about 50 times beyond it."""
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.standard_normal((M, N1)).astype(np.float32)).to(TBF)
    b = torch.tensor(rng.standard_normal((M, N2)).astype(np.float32))
    got = tn_product_split_plain(a, b, ones).double()
    a64 = a.double()
    if ones:
        a64 = torch.cat([a64, a64.new_ones((M, 1))], dim=1)
    want = a64.T @ b.double()
    bound = (3 * M) ** 0.5 * 2.0 ** -24 * (a64.abs().T @ b.double().abs())
    assert got.shape == want.shape
    assert ((got - want).abs() <= bound).all()
    one_term = (a64.T @ b.to(TBF).double())
    assert ((one_term - want).abs() > bound).any()


@pytest.mark.parametrize("reverse", [False, True])
def test_k5b_bf16_phases_with_the_split_product_match_jax(reverse):
    """K5b-bf16's three phases as the card runs them, plainly: hp on bf16
    values with f32 sums, the lean recurrence with dhp rounded for
    dhp@Wh^T, dWh = ysp^T dhp by the split-bf16 product, rounded to bf16
    at the end -- against jax.vjp of JAX's gru_scan on the same bf16
    inputs (dxp and dwh within REL of the largest magnitude)."""
    x, wx, wh, b, mask, dys = _case(7)
    xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H)
    _, vjp = jax.vjp(lambda a, w: j_scan(a, w, jnp.asarray(mask), reverse),
                     jnp.asarray(xp, JBF), jnp.asarray(wh, JBF))
    dxp_j, dwh_j = vjp(jnp.asarray(dys, JBF))
    xpt, wht = torch.tensor(xp).to(TBF), torch.tensor(wh).to(TBF)
    m = torch.tensor(mask)
    ysp = prev_states(gru_mod.gru_scan_plain(xpt, wht, m, reverse), reverse)
    f32 = torch.float32
    hp = (ysp.reshape(T * B, H).to(f32) @ wht.to(f32)).reshape(T, B, 3 * H)
    dxp, dhp = gru_bwd_lean_plain(xpt.to(f32), hp, ysp.to(f32), wht, m,
                                  torch.tensor(dys).to(TBF).to(f32), reverse)
    dwh = tn_product_split_plain(ysp.reshape(T * B, H),
                                 dhp.reshape(T * B, 3 * H)).to(TBF)
    _close(dxp.to(TBF), dxp_j, "dxp")
    _close(dwh, dwh_j, "dwh")


def test_bf16_refuses_mixed_streams():
    """A bf16 stream with an f32 weight reaches no kernel: the wrappers
    raise ValueError before a launch (checked on the CPU through the
    same checks the card path runs)."""
    x, wx, wh, b, mask, dys = _case(4)
    xp = torch.zeros((T, B, 3 * H), dtype=TBF)
    with pytest.raises(ValueError, match="streams"):
        gru_mod._check_scan(xp, torch.tensor(wh), torch.tensor(mask))
    with pytest.raises(ValueError, match="streams"):
        gru_mod._check_streams("gru_scan_bwd", TBF,
                               dys=torch.zeros((T, B, H)))


# The model: JAX's bf16 rounding points through DeepSpeechCTC's layers.
@pytest.mark.parametrize("kw", [
    dict(bf16_conv=True),
    dict(pallas_gru=True, bf16_gru=True),
    dict(pallas_gru=True, bf16_gru=True, fused_proj=True),
], ids=["bf16_conv", "pallas_bf16_gru", "fused_proj_bf16_gru"])
def test_model_bf16_grads_match_jax(kw):
    check_model_grads(kw)
