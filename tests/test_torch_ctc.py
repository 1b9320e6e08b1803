"""tpuasr_torch CTC losses against the JAX package's Pallas CTC (CPU).

The port's ``ctc_loss`` runs the plain versions of K6/K6b
(``ctc_forward_plain``, ``ctc_backward_plain``) on CPU tensors;
the JAX ``ctc_loss_pallas`` runs its kernels with ``interpret=True``, which
the JAX package selects itself off a TPU. The same numpy inputs go to
both, with the edge cases the kernels must handle: ragged input lengths
including 0, an empty label, repeated labels (no skip), an infeasible row
(T < 2U + repeats) and garbage in padded label slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.losses.ctc_pallas import (_final_ll, ctc_alphas_pallas,
                                      ctc_betas_pallas, ctc_loss_pallas)
from tpuasr_torch.losses import ctc_loss, ctc_loss_ref, get_ctc_loss
from tpuasr_torch.losses import ctc as ctc_mod


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


C, U = 9, 6


def _case(seed, B=8, T=40, U=U):
    rng = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.standard_normal((B, T, C)) * 2.0, jnp.float32), -1))
    labels = rng.integers(1, C, (B, U)).astype(np.int32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ll = rng.integers(1, U + 1, B).astype(np.int32)
    il[0], ll[0] = T, U                       # full row
    il[1] = 0                                 # no frames
    ll[2] = 0                                 # empty label
    labels[3, :4] = [5, 5, 5, 2]              # repeats: no skip between them
    il[3], ll[3] = 12, 4
    labels[4, :4] = [7, 7, 7, 7]              # infeasible: needs 7 frames
    il[4], ll[4] = 6, 4
    for b in range(B):                        # garbage past each label
        labels[b, ll[b]:] = rng.integers(-5, 50, U - ll[b])
    return lp, labels, il, ll


def _jax_loss_and_grad(lp, labels, il, ll, w):
    def f(x):
        return jnp.sum(ctc_loss_pallas(x, labels, il, ll) * w)
    loss = ctc_loss_pallas(jnp.asarray(lp), labels, il, ll)
    return np.asarray(loss), np.asarray(jax.grad(f)(jnp.asarray(lp)))


def _torch_loss_and_grad(fn, lp, labels, il, ll, w):
    x = torch.tensor(lp, requires_grad=True)
    loss = fn(x, torch.tensor(labels), torch.tensor(il), torch.tensor(ll))
    (loss * torch.tensor(w)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_grad_match_pallas(seed):
    lp, labels, il, ll = _case(seed)
    w = np.random.default_rng(seed + 10).random(len(il)).astype(np.float32)
    lj, gj = _jax_loss_and_grad(lp, labels, il, ll, w)
    lt, gt = _torch_loss_and_grad(ctc_loss, lp, labels, il, ll, w)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    assert lt[4] == 0.0 and not gt[4].any()   # infeasible: zero_infinity
    assert not gt[1].any()                    # no frames: no gradient
    assert lt[3] > 0.0 and np.isfinite(lt).all()


def test_ctc_ref_matches_fb():
    """The autograd oracle and the analytic gradient agree. A row with no
    frames is left out of the gradient: its loss reads the alphas at t=0
    (the clip of _final_ll), which the oracle differentiates and the
    analytic gradient masks (t < length), in JAX as here."""
    lp, labels, il, ll = _case(3)
    w = np.ones(len(il), np.float32)
    lf, gf = _torch_loss_and_grad(ctc_loss, lp, labels, il, ll, w)
    lr, gr = _torch_loss_and_grad(ctc_loss_ref, lp, labels, il, ll, w)
    np.testing.assert_allclose(lr, lf, rtol=1e-5, atol=1e-5)
    # The oracle differentiates through 40 steps of exp/log and rounds at
    # other places than the closed form: 2e-5 seen, hence 1e-4.
    rows = il > 0
    np.testing.assert_allclose(gr[rows], gf[rows], rtol=0, atol=1e-4)


def test_ctc_matches_torch_ctc_loss():
    """An independent oracle: torch.nn.functional.ctc_loss (reduction
    'none', zero_infinity) on the feasible rows with frames. Its gradient
    is taken as if the input came out of a log-softmax: it is ours plus
    exp(log_probs) on each row's frames."""
    lp, labels, il, ll = _case(4)
    keep = [b for b in range(len(il)) if il[b] > 0 and b != 4]
    lab = np.clip(labels, 0, C - 1)[keep]
    x = torch.tensor(lp[keep], requires_grad=True)
    ours = ctc_loss(x, torch.tensor(lab), torch.tensor(il[keep]),
                    torch.tensor(ll[keep]))
    ours.sum().backward()
    x2 = torch.tensor(lp[keep], requires_grad=True)
    ref = torch.nn.functional.ctc_loss(
        x2.permute(1, 0, 2), torch.tensor(lab, dtype=torch.long),
        torch.tensor(il[keep], dtype=torch.long),
        torch.tensor(ll[keep], dtype=torch.long), blank=0, reduction="none",
        zero_infinity=True)
    ref.sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-4)
    frames = (np.arange(lp.shape[1])[None, :] < il[keep][:, None])[..., None]
    want = x2.grad.numpy() - np.exp(lp[keep]) * frames
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_plain_alphas_and_betas_match_pallas(seed):
    """K6/K6b's plain versions against the Pallas kernels on every
    reachable entry (log-prob above -1e29), and unreachable where Pallas
    is."""
    lp, labels, il, ll = _case(seed)
    a_j, _, _ = ctc_alphas_pallas(jnp.asarray(lp), labels, il, ll)
    b_j, _ = ctc_betas_pallas(jnp.asarray(lp), labels, il, ll)
    ext, allow, valid, lp_ext = ctc_mod.prepare(
        torch.tensor(lp), torch.tensor(labels), torch.tensor(ll))
    a_t = ctc_mod.ctc_alphas_plain(lp_ext, allow, valid).numpy()
    b_t = ctc_mod.ctc_betas_plain(lp_ext, allow, valid, torch.tensor(il),
                                  torch.tensor(ll)).numpy()
    for got, want in ((a_t, np.asarray(a_j)), (b_t, np.asarray(b_j))):
        reach = want > -1e29
        assert reach.sum() > 100
        np.testing.assert_array_equal(got > -1e29, reach)
        np.testing.assert_allclose(got[reach], want[reach], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("seed,T,U_", [(0, 40, U), (1, 40, U), (7, 100, 40)])
def test_forward_backward_plain_match_pallas(seed, T, U_):
    """K6's and K6b's plain versions against JAX: the loss against
    ctc_loss_pallas, the alphas against ctc_alphas_pallas (every reachable
    entry within rtol 1e-5, unreachable where Pallas is) and ll against
    its _final_ll, the gradient of sum(w * loss) against jax.grad (atol
    1e-5). U = 40 gives S = 81: three states a lane in the kernels."""
    lp, labels, il, ll = _case(seed, T=T, U=U_)
    w = np.random.default_rng(seed + 20).random(len(il)).astype(np.float32)
    loss, ll_t, alphas = ctc_mod.ctc_forward_plain(
        torch.tensor(lp), torch.tensor(labels), torch.tensor(il),
        torch.tensor(ll))
    grad = ctc_mod.ctc_backward_plain(
        torch.tensor(lp), torch.tensor(labels), torch.tensor(il),
        torch.tensor(ll), alphas, ll_t, torch.tensor(w))
    a_j, _, _ = ctc_alphas_pallas(jnp.asarray(lp), labels, il, ll)
    ll_j = np.asarray(_final_ll(a_j, jnp.asarray(il), jnp.asarray(ll)))
    lj, gj = _jax_loss_and_grad(lp, labels, il, ll, w)
    np.testing.assert_allclose(loss.numpy(), lj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-5)
    want = np.asarray(a_j).transpose(1, 0, 2)
    got = alphas.numpy()[:, :, :want.shape[2]]
    reach = want > -1e29
    assert reach.sum() > 100 and (alphas.numpy()[:, :, want.shape[2]:]
                                  == np.float32(-1e30)).all()
    np.testing.assert_array_equal(got > -1e29, reach)
    np.testing.assert_allclose(got[reach], want[reach], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), gj, rtol=0, atol=1e-5)
    assert loss[4] == 0.0 and not grad[4].any()   # infeasible
    assert not grad[1].any()                      # no frames


def test_ctc_loss_past_the_kernels_limit():
    """ctc_loss on CPU tensors takes labels past the kernels' S = 1024 (U =
    600: S = 1201), against ctc_loss_pallas and its jax.grad; its alphas
    are then (B, T, S)."""
    rng = np.random.default_rng(3)
    B, T, U_ = 2, 660, 600
    lp = np.asarray(jax.nn.log_softmax(
        jnp.asarray(rng.standard_normal((B, T, C)), jnp.float32), -1))
    # No repeats: each row is feasible in U frames.
    steps = rng.integers(1, C - 1, (B, U_))
    labels = (1 + np.cumsum(steps, axis=1) % (C - 1)).astype(np.int32)
    il = np.array([T, 640], np.int32)
    ll = np.array([U_, 590], np.int32)
    w = np.array([0.75, 1.5], np.float32)
    lj, gj = _jax_loss_and_grad(lp, labels, il, ll, w)
    lt, gt = _torch_loss_and_grad(ctc_loss, lp, labels, il, ll, w)
    assert (lt > 0).all() and np.isfinite(lt).all()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    _, _, alphas = ctc_mod.ctc_forward_plain(
        torch.tensor(lp), torch.tensor(labels), torch.tensor(il),
        torch.tensor(ll))
    assert alphas.shape == (B, T, 2 * U_ + 1)


def test_kernel_wrappers_run_plain_on_cpu():
    """ctc_forward and ctc_backward take their plain versions for CPU
    tensors, whatever the index types, and launch nothing."""
    lp, labels, il, ll = _case(6, T=14)
    w = torch.rand(len(il), generator=torch.Generator().manual_seed(6))
    before = (ctc_mod.ctc_forward.launches, ctc_mod.ctc_backward.launches)
    for idx in (torch.int32, torch.int64):
        args = (torch.tensor(lp), torch.tensor(labels, dtype=idx),
                torch.tensor(il, dtype=idx), torch.tensor(ll, dtype=idx))
        got = ctc_mod.ctc_forward(*args)
        want = ctc_mod.ctc_forward_plain(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ctc_mod.ctc_backward(*args, got[2], got[1], w),
                           ctc_mod.ctc_backward_plain(*args, *want[2:0:-1],
                                                      w))
    assert (ctc_mod.ctc_forward.launches,
            ctc_mod.ctc_backward.launches) == before


def test_get_ctc_loss_names():
    assert get_ctc_loss("ref") is ctc_loss_ref
    for name in ("fb", "pallas", "auto"):
        assert get_ctc_loss(name) is ctc_loss
    with pytest.raises(ValueError):
        get_ctc_loss("warp")
