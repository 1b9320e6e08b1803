"""tpuasr_torch GRU scans and int8 quantizers against the JAX package (CPU).

The port's wrappers run their kernels' plain versions on CPU tensors; the
JAX Pallas scans run with ``interpret=True``, which the JAX package selects
itself off a TPU. The same numpy inputs go to both.

The port's tests do not force ``pltpu.force_tpu_interpret_mode()``: that
interpreter runs the kernel through host callbacks that dispatch JAX ops of
their own, and those can deadlock against the test's next dispatch while
the kernel still runs. The default interpreter is plain XLA, and gives the
same values bit for bit on these kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from tpuasr.ops import gru_scan as j_scan
from tpuasr.ops.pallas_gru import gru_scan_xfused as j_xfused
from tpuasr.ops.pallas_gru import gru_scan_xfused_q8 as j_xfused_q8
from tpuasr.ops.quant import quantize_per_channel as j_qpc
from tpuasr.ops.quant import quantize_rows as j_qrows
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops.gru import (_MODE_K2, _MODE_Q8_REC, _pack_proj,
                                  _pack_rec, _scan_plan, gru_scan,
                                  gru_scan_bwd_plain, gru_scan_plain,
                                  gru_scan_xfused, gru_scan_xfused_q8,
                                  prev_states)
from tpuasr_torch.ops.quant import quantize_per_channel, quantize_rows


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


T, B, D, H = 12, 3, 24, 16


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    wx = (rng.standard_normal((D, 3 * H)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    lens = np.array([T, T - 5, 1])
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return x, wx, wh, b, mask[:, :, None]


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("reverse", [False, True])
def test_k2_f32_matches_jax(reverse):
    x, wx, wh, b, mask = _case(0)
    ys_j = np.asarray(j_xfused(*map(jnp.asarray, (x, wx, b, wh, mask)),
                               reverse))
    ys_t = gru_scan_xfused(_t(x), _t(wx), _t(b), _t(wh), _t(mask), reverse)
    np.testing.assert_allclose(ys_t.numpy(), ys_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_k2_bf16_matches_jax(reverse):
    """bf16 streams: x, wx, wh and ys in bf16, h cast to bf16 for h@Wh,
    fp32 sums and gates. Both sides round at the same places, but an fp32
    sum that differs in its last bit can flip a bf16 rounding of h, which
    moves ys by one bf16 ulp (2^-8 relative): atol 8e-3 covers one ulp at
    |ys| < 1 plus its echo through the next steps."""
    x, wx, wh, b, mask = _case(1)
    bf = jnp.bfloat16
    ys_j = j_xfused(jnp.asarray(x, bf), jnp.asarray(wx, bf), jnp.asarray(b),
                    jnp.asarray(wh, bf), jnp.asarray(mask), reverse)
    ys_j = np.asarray(ys_j.astype(jnp.float32))
    tb = torch.bfloat16
    ys_t = gru_scan_xfused(_t(x).to(tb), _t(wx).to(tb), _t(b), _t(wh).to(tb),
                           _t(mask), reverse)
    assert ys_t.dtype == tb
    np.testing.assert_allclose(ys_t.float().numpy(), ys_j, rtol=0, atol=8e-3)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rec_q8", [False, True])
def test_k4_matches_jax(reverse, rec_q8):
    x, wx, wh, b, mask = _case(2)
    wxq_j, sw_j = j_qpc(jnp.asarray(wx))
    whq_j, swh_j = j_qpc(jnp.asarray(wh))
    if rec_q8:
        ys_j = j_xfused_q8(jnp.asarray(x), wxq_j, sw_j, jnp.asarray(b),
                           whq_j, jnp.asarray(mask), reverse, wh_scale=swh_j)
    else:
        ys_j = j_xfused_q8(jnp.asarray(x), wxq_j, sw_j, jnp.asarray(b),
                           jnp.asarray(wh), jnp.asarray(mask), reverse)
    wxq, sw = quantize_per_channel(_t(wx))
    whq, swh = quantize_per_channel(_t(wh))
    if rec_q8:
        ys_t = gru_scan_xfused_q8(_t(x), wxq, sw, _t(b), whq, _t(mask),
                                  reverse, wh_scale=swh)
    else:
        ys_t = gru_scan_xfused_q8(_t(x), wxq, sw, _t(b), _t(wh), _t(mask),
                                  reverse)
    # The JAX kernel-vs-reference bound (tests/test_quant_gru.py:186).
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=2e-5,
                               atol=2e-5)


def test_quantize_per_channel_exact():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((40, 24)) * 0.7).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero column
    q_j, s_j = j_qpc(jnp.asarray(w))
    q_t, s_t = quantize_per_channel(_t(w))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_quantize_rows_exact():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((10, 33)) * 3).astype(np.float32)
    x[2] = 0.0                             # an all-zero row
    x[5, :4] = [127.0, 0.5, -0.5, 1.5]     # exact .5 ties round to even
    q_j, s_j = j_qrows(jnp.asarray(x))
    q_t, s_t = quantize_rows(_t(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_q8_exact_on_int8_grid_equals_f32():
    """On-grid inputs quantize losslessly: the q8 scan equals the f32 scan."""
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, size=(T, B, D)).astype(np.float32)
    x[:, :, 0] = 127.0
    wx = rng.integers(-8, 9, size=(D, 3 * H)).astype(np.float32) * 0.01
    wx[0, :] = 1.27
    wh = (rng.standard_normal((H, 3 * H)) * 0.05).astype(np.float32)
    b = rng.standard_normal(3 * H).astype(np.float32)
    mask = torch.ones(T, B, 1)
    wxq, sw = quantize_per_channel(_t(wx))
    ys_q = gru_scan_xfused_q8(_t(x), wxq, sw, _t(b), _t(wh), mask)
    ys_f = gru_scan_xfused(_t(x), _t(wx), _t(b), _t(wh), mask)
    torch.testing.assert_close(ys_q, ys_f, rtol=1e-5, atol=1e-5)


def _want_proj(w, plan):
    """numpy: the projection's weights zero-padded, (kp, np) in f32 and
    W^T (np, kp) on the tensor-core paths."""
    D, N = w.shape
    if plan.proj == "f32":
        out = np.zeros((plan.kp, plan.np), w.dtype)
        out[:D, :N] = w
    else:
        out = np.zeros((plan.np, plan.kp), w.dtype)
        out[:N, :D] = w.T
    return out


def _want_rec(wh, plan):
    """numpy: unit group g's row q*U + u of (ceil(H / U), 3U, hk) holds
    Wh's column q*H + g*U + u (gate q of unit g*U + u), zero past H."""
    H = wh.shape[0]
    G = -(-H // plan.U)
    out = np.zeros((G, 3 * plan.U, plan.hk), wh.dtype)
    for g in range(G):
        for q in range(3):
            for u in range(plan.U):
                if g * plan.U + u < H:
                    out[g, q * plan.U + u, :H] = wh[:, q * H + g * plan.U + u]
    return out


@pytest.mark.parametrize("mode,dtype,wdtype", [
    (_MODE_K2, torch.float32, torch.float32),
    (_MODE_K2, torch.bfloat16, torch.bfloat16),
    (_MODE_Q8_REC, torch.bfloat16, torch.int8)])
def test_weight_packing_layouts(mode, dtype, wdtype):
    """The kernels' weight layouts (``_pack_proj``, ``_pack_rec``) against
    numpy constructions of them, at widths that are no multiple of any tile
    (D=70, H=20); f32's recurrence (K5's forward) takes Wh as it is."""
    rng = np.random.default_rng(10)
    D, H = 70, 20
    if wdtype == torch.int8:
        wx = rng.integers(-127, 128, (D, 3 * H)).astype(np.int8)
        wh = rng.integers(-127, 128, (H, 3 * H)).astype(np.int8)
    else:
        wx = rng.standard_normal((D, 3 * H)).astype(np.float32)
        wh = rng.standard_normal((H, 3 * H)).astype(np.float32)
    plan = _scan_plan(5, D, H, mode, dtype)
    # kp: D padded to 8 (f32) or to 64 bytes (a projection stage).
    want_kp = {"f32": 72, "bf16": 96, "int8": 128}[plan.proj]
    assert (plan.kp, plan.np) == (want_kp, 128)
    px = _pack_proj(_t(wx).to(wdtype), plan)
    pr = _pack_rec(_t(wh).to(wdtype), plan)
    assert px.dtype == wdtype and pr.dtype == wdtype
    wx_v = _t(wx).to(wdtype).float().numpy()
    wh_v = _t(wh).to(wdtype).float().numpy()
    np.testing.assert_array_equal(px.float().numpy(), _want_proj(wx_v, plan))
    if plan.rec == "f32":
        np.testing.assert_array_equal(pr.numpy(), wh)
    else:
        assert (plan.U, plan.grid, plan.hk) == (8, 3, 32)
        np.testing.assert_array_equal(pr.float().numpy(),
                                      _want_rec(wh_v, plan))


def test_q8_rejects_wrong_dtype_and_wide_d():
    x = torch.zeros(4, 2, 8)
    wh = torch.zeros(8, 24)
    b = torch.zeros(24)
    mask = torch.ones(4, 2, 1)
    with pytest.raises(ValueError, match="int8"):
        gru_scan_xfused_q8(x, torch.zeros(8, 24), torch.ones(24), b, wh, mask)
    with pytest.raises(ValueError, match="1040"):
        gru_scan_xfused_q8(torch.zeros(4, 2, 2048),
                           torch.zeros(2048, 24, dtype=torch.int8),
                           torch.ones(24), b, wh, mask)


def test_unsupported_device_raises():
    x = torch.zeros(4, 2, 8, device="meta")
    w = torch.zeros(8, 24, device="meta")
    with pytest.raises(ValueError, match="device"):
        gru_scan_xfused(x, w, torch.zeros(24, device="meta"),
                        torch.zeros(8, 24, device="meta"),
                        torch.ones(4, 2, 1, device="meta"))


# ---- K5 / K5b: the scan over precomputed projections and its BPTT ----------


def _scan_case(seed):
    """xp (T, B, 3H), wh, ragged mask (a row of length 0 included) and a
    cotangent dys, in float32."""
    rng = np.random.default_rng(seed)
    x, wx, wh, b, _ = _case(seed)
    xp = (np.einsum("tbd,dh->tbh", x, wx) + b).astype(np.float32)
    lens = np.array([T, T - 5, 0])
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    return xp, wh, mask[:, :, None], dys


@pytest.mark.parametrize("reverse", [False, True])
def test_k5_gru_scan_matches_jax(reverse):
    xp, wh, mask, _ = _scan_case(6)
    ys_j = np.asarray(j_scan(jnp.asarray(xp), jnp.asarray(wh),
                             jnp.asarray(mask), reverse))
    ys_t = gru_scan(_t(xp), _t(wh), _t(mask), reverse)
    np.testing.assert_allclose(ys_t.numpy(), ys_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        ys_t.numpy(), gru_scan_plain(_t(xp), _t(wh), _t(mask),
                                     reverse).numpy())


@pytest.mark.parametrize("reverse", [False, True])
def test_k5b_bptt_matches_jax_vjp(reverse):
    """gru_scan_bwd_plain, and gru_scan's backward, against jax.vjp of the
    Pallas scan (its custom VJP runs the BPTT kernel)."""
    xp, wh, mask, dys = _scan_case(7)
    ys_j, vjp = jax.vjp(lambda a, w: j_scan(a, w, jnp.asarray(mask),
                                            reverse),
                        jnp.asarray(xp), jnp.asarray(wh))
    dxp_j, dwh_j = map(np.asarray, vjp(jnp.asarray(dys)))
    ysp = prev_states(_t(np.asarray(ys_j)), reverse)
    dxp, dwh = gru_scan_bwd_plain(_t(xp), ysp, _t(wh), _t(mask), _t(dys),
                                  reverse)
    np.testing.assert_allclose(dxp.numpy(), dxp_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dwh.numpy(), dwh_j, rtol=0, atol=1e-4)
    assert not dxp[:, 2].any()                # a row of length 0
    xp_t = _t(xp).requires_grad_()
    wh_t = _t(wh).requires_grad_()
    before = (gru_mod.gru_scan_fwd.launches, gru_mod.gru_scan_bwd.launches)
    (gru_scan(xp_t, wh_t, _t(mask), reverse) * _t(dys)).sum().backward()
    assert (gru_mod.gru_scan_fwd.launches,
            gru_mod.gru_scan_bwd.launches) == before
    np.testing.assert_allclose(xp_t.grad.numpy(), dxp_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(wh_t.grad.numpy(), dwh_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_k2_backward_matches_jax_vjp(reverse):
    """The fused-projection scan's backward against jax.vjp of the JAX
    gru_scan_xfused. At these widths JAX's rule and the port's take the
    fused backward (K2b's plain version); tests/test_torch_xfb.py holds the
    rule and the recompute route."""
    x, wx, wh, b, mask = _case(8)
    dys = np.random.default_rng(9).standard_normal((T, B, H)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: j_xfused(*a, jnp.asarray(mask), reverse),
                     *map(jnp.asarray, (x, wx, b, wh)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dys))]
    args = [_t(a).requires_grad_() for a in (x, wx, b, wh)]
    ys = gru_scan_xfused(*args, _t(mask), reverse)
    (ys * _t(dys)).sum().backward()
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0, atol=1e-4)
