"""The float32 GRU backward in three phases (pre-scan products, the lean
recurrence, post-scan products) as tpuasr_torch runs it on the card for
K2b, K7b and K5b's dWh, in its plain PyTorch form, against the JAX
package's BPTT (CPU): ``_xf_bwd_fused`` (K2b), and ``jax.vjp`` of the
Pallas ``gru_scan_bidir`` (K7b, ``_bidir_bwd``) and ``gru_scan`` (K5b,
``_gru_bwd``). JAX's Pallas kernels run with ``interpret=True``, which
the JAX package selects itself off a TPU. The same numpy inputs go to both.

Tolerance: each output within 1e-5 of its largest magnitude: float32 sums
in other orders (hp and the weight gradients are products over all T*B
rows, summed in one go rather than step by step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops import pallas_gru as jpg
from tpuasr_torch.ops import gru as gru_mod


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


# (T, B, D, H, row lengths): widths off the 128-lane tiles, ragged rows
# with a row of length 1 (and one of length 0 in the second).
SHAPES = [(10, 4, 24, 16, (10, 6, 1, 8)), (8, 3, 130, 20, (8, 0, 1))]
SHAPE_IDS = ["T10_B4_D24_H16", "T8_B3_D130_H20"]


def _case(seed, T, B, D, H, lens):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    wx = (rng.standard_normal((D, 3 * H)) / np.sqrt(D)).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.array(lens)[None, :]).astype(
        np.float32)[:, :, None]
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    return x, wx, b, wh, mask, dys


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, what):
    for g, w, name in zip(got, want, what):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k2b_phases_match_jax_fused(shape, reverse):
    """K2b's three phases (xp and hp over all rows, the lean recurrence, dx,
    dWx, db and dWh over all rows) against JAX's _xf_bwd_fused."""
    x, wx, b, wh, mask, dys = _case(0, *shape)
    j = tuple(map(jnp.asarray, (x, wx, b, wh, mask)))
    ys = jpg.gru_scan_xfused(*j, reverse)
    want = jpg._xf_bwd_fused(j + (ys,), jnp.asarray(dys), reverse)[:4]
    ysp = gru_mod.prev_states(_t(ys), reverse)
    got = gru_mod.gru_scan_xfused_bwd_phases_plain(
        _t(x), ysp, _t(wx), _t(b), _t(wh), _t(mask), _t(dys), reverse)
    _close([g.numpy() for g in got], want, ("dx", "dwx", "db", "dwh"))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k7b_phases_match_jax_vjp(shape):
    """K7b's three phases, both directions, against jax.vjp of JAX's
    gru_scan_bidir (its custom VJP runs _bidir_bwd)."""
    T, B, _, H, lens = shape
    rng = np.random.default_rng(1)
    xpf, xpb = (rng.standard_normal((T, B, 3 * H)).astype(np.float32)
                for _ in range(2))
    whf, whb = ((rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
                for _ in range(2))
    mask = (np.arange(T)[:, None] < np.array(lens)[None, :]).astype(
        np.float32)[:, :, None]
    dys = [rng.standard_normal((T, B, H)).astype(np.float32)
           for _ in range(2)]
    jm = jnp.asarray(mask)
    (ysf, ysb), vjp = jax.vjp(
        lambda a, b, c, d: jpg.gru_scan_bidir(a, b, c, d, jm),
        *map(jnp.asarray, (xpf, xpb, whf, whb)))
    want = vjp(tuple(map(jnp.asarray, dys)))
    got = gru_mod.gru_scan_bidir_bwd_phases_plain(
        _t(xpf), _t(xpb), gru_mod.prev_states(_t(ysf), False),
        gru_mod.prev_states(_t(ysb), False), _t(whf), _t(whb), _t(mask),
        *map(_t, dys))
    _close([g.numpy() for g in got], want, ("dxpf", "dxpb", "dwhf", "dwhb"))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k5b_phases_match_jax_vjp(shape, reverse):
    """K5b's function in three phases (hp over all rows, the lean
    recurrence, dWh = ysp^T dhp) against jax.vjp of JAX's gru_scan (its
    custom VJP runs _gru_bwd)."""
    T, B, _, H, lens = shape
    rng = np.random.default_rng(2)
    xp = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.array(lens)[None, :]).astype(
        np.float32)[:, :, None]
    dys = rng.standard_normal((T, B, H)).astype(np.float32)
    jm = jnp.asarray(mask)
    ys, vjp = jax.vjp(lambda a, w: jpg.gru_scan(a, w, jm, reverse),
                      jnp.asarray(xp), jnp.asarray(wh))
    want = vjp(jnp.asarray(dys))
    got = gru_mod.gru_scan_bwd_phases_plain(
        _t(xp), gru_mod.prev_states(_t(ys), reverse), _t(wh), _t(mask),
        _t(dys), reverse)
    _close([g.numpy() for g in got], want, ("dxp", "dwh"))


@pytest.mark.parametrize("reverse", [False, True])
def test_lean_recurrence_is_the_step_by_step_bptt(reverse):
    """The lean recurrence given hp = ysp @ Wh gives the step-by-step plain
    version's dxp (K5b's, which recomputes hp in each step), and its dhp
    differs from dxp only in the n gate, by the factor r."""
    T, B, _, H, lens = SHAPES[0]
    x, wx, b, wh, mask, dys = map(_t, _case(3, *SHAPES[0]))
    xp = (x.reshape(T * B, -1) @ wx + b).reshape(T, B, 3 * H)
    ysp = gru_mod.prev_states(gru_mod.gru_scan_plain(xp, wh, mask, reverse),
                              reverse)
    hp = (ysp.reshape(T * B, H) @ wh).reshape(T, B, 3 * H)
    dxp, dhp = gru_mod.gru_bwd_lean_plain(xp, hp, ysp, wh, mask, dys,
                                          reverse)
    want, _ = gru_mod.gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse)
    np.testing.assert_allclose(dxp.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(dxp[:, :, :2 * H], dhp[:, :, :2 * H])
    r = torch.sigmoid(xp[:, :, :H] + hp[:, :, :H])
    np.testing.assert_allclose(dhp[:, :, 2 * H:].numpy(),
                               (dxp[:, :, 2 * H:] * r).numpy(), rtol=1e-6,
                               atol=1e-7)
