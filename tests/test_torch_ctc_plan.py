"""The CTC kernels' order of work (csrc/ctc_fb.cu), emulated in numpy on
the CPU, against their plain versions (losses/ctc.py).

K6 and K6b hold an utterance in one warp: lane j the extended states
[j*K, j*K+K), K = lane_states(S); a frame's only exchange is the previous
lane's last two alphas (in the backward the next lane's first two b0). K6b
sums each frame's -occ * g into the classes in a fixed order: the blank
class over the even states in order, each label class over its positions
in label order, the classes in order of their first position (a label of
the blank's class adds its group to the blank's sum). The emulation does
that work in that order in float32; the alphas and the loss must match
ctc_forward_plain within 1e-6 (relative), the gradient ctc_backward_plain
within 1e-6 of its largest magnitude. The kernels themselves run only on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import itertools

import numpy as np
import pytest
import torch

from tpuasr_torch.losses import ctc as ctc_mod

F32 = np.float32
NEG = F32(-1e30)


def _exp(x):
    """torch's float32 exp (the plain versions' and, on the card, the
    kernels' expf): the emulation tests the order of work, not a libm."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _log(x):
    return torch.log(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _lse3(a, b, c):
    m = np.maximum(np.maximum(a, b), c)
    return m + _log(_exp(a - m) + _exp(b - m) + _exp(c - m))


def _pos(s, K):
    """Where state s sits in K6b's per-frame row of occupancies."""
    return (s % K) * 32 + s // K


class _Utt:
    """One utterance in the kernels' lane layout: (32, K) arrays."""

    def __init__(self, labels, L, C, blank):
        self.U = len(labels)
        self.S = 2 * self.U + 1
        self.K = K = ctc_mod.lane_states(self.S)
        s = np.arange(32 * K).reshape(32, K)
        lab = np.asarray(labels, np.int64)

        def label_at(x):            # ext as given; blank at even states
            odd = (x % 2 == 1) & (x < self.S)
            return np.where(odd, lab[np.clip(x // 2, 0, max(self.U - 1, 0))]
                            if self.U else blank, blank)

        self.s = s
        v = label_at(s)
        live = s < self.S
        self.cls = np.where(live, np.clip(v, 0, C - 1), 0)
        self.ok = live & (s <= 2 * L)
        self.skip = live & (s % 2 == 1) & (s >= 3) & (v != label_at(s - 2))
        self.skip_fwd = ((s + 2 < self.S) & (s % 2 == 1)
                         & (v != label_at(s + 2)))
        self.L = L


def _shift_up(x, d):
    """x of lane j - d (the shuffle up), -1e30 below lane d."""
    out = np.full_like(x, NEG)
    out[d:] = x[:-d]
    return out


def _shift_down(x, d):
    out = np.full_like(x, NEG)
    out[:-d] = x[d:]
    return out


def emulate_forward(lp, u: _Utt, n_in, zero_infinity=True):
    """K6 for one utterance: (loss, ll, alphas (T, 32, K))."""
    T = lp.shape[0]
    K = u.K
    a = np.where(u.ok & (u.s < 2), lp[0][u.cls], NEG).astype(F32)
    out = [a]
    for t in range(1, T):
        p1 = _shift_up(a[:, K - 1], 1)
        p2 = _shift_up(a[:, K - 2], 1) if K >= 2 else _shift_up(a[:, 0], 2)
        n = np.empty_like(a)
        for i in range(K):
            y = a[:, i - 1] if i >= 1 else p1
            z = a[:, i - 2] if i >= 2 else (p1 if i == 1 else p2)
            z = np.where(u.skip[:, i], z, NEG)
            n[:, i] = np.where(u.ok[:, i],
                               _lse3(a[:, i], y, z) + lp[t][u.cls[:, i]], NEG)
        a = n
        out.append(a)
    alphas = np.stack(out)
    t_ll = min(max(n_in - 1, 0), T - 1)
    flat = alphas[t_ll].reshape(-1)
    a_end = flat[2 * u.L] if 0 <= 2 * u.L < u.S else NEG
    a_pre = flat[2 * u.L - 1] if u.L > 0 else NEG
    m = max(a_end, a_pre)
    ll = F32(m + torch.log1p(torch.exp(torch.tensor(
        -np.abs(F32(a_end - a_pre))))).item())
    loss = -ll
    if zero_infinity and loss >= F32(5e29):
        loss = F32(0.0)
    return loss, ll, alphas


def class_list(lab_cls, K):
    """K6b's per-utterance list, built as the kernel builds it: (position
    in the occupancy row, class * 2 + last of its class) in order."""
    Le = len(lab_cls)
    first = [next(v for v in range(u + 1) if lab_cls[v] == lab_cls[u])
             for u in range(Le)]
    items = [None] * Le
    for u in range(Le):
        c = lab_cls[u]
        rank = sum(first[v] < first[u] or (v < u and lab_cls[v] == c)
                   for v in range(Le))
        later = any(v > u and lab_cls[v] == c for v in range(Le))
        items[rank] = (_pos(2 * u + 1, K), c * 2 + (0 if later else 1))
    return items


def emulate_backward(lp, u: _Utt, n_in, alphas, ll, g, blank):
    """K6b for one utterance: grad (T, C)."""
    T, C = lp.shape
    K, S, L = u.K, u.S, u.L
    grad = np.zeros((T, C), F32)
    n = n_in if ll > F32(-5e29) and 1 <= n_in <= T else 0
    if n == 0:
        return grad
    Le = min(max(L, 0), u.U)
    items = class_list([int(c) for c in u.cls.reshape(-1)[1:2 * Le:2]], K)
    blank_cls = min(max(blank, 0), C - 1)
    L2 = 2 * L
    beta = np.where((u.s == L2) | ((u.s == L2 - 1) & (L > 0)), F32(0),
                    NEG).astype(F32)
    for t in range(n - 1, -1, -1):
        occ = _exp(np.minimum(np.maximum(alphas[t] + beta - ll, NEG),
                              F32(0)))
        v = np.where(u.ok, -occ * F32(g), F32(0)).astype(F32)
        row = np.zeros(32 * K + 1, F32)
        for j in range(32):
            for i in range(K):
                row[i * 32 + j] = v[j, i]
        blank_sum = F32(0)
        for s in range(0, min(L2, S - 1) + 1, 2):
            blank_sum = F32(blank_sum + row[_pos(s, K)])
        grad[t, blank_cls] = blank_sum
        acc = F32(0)
        for pos, tag in items:
            acc = F32(acc + row[pos])
            if tag & 1:
                c = tag >> 1
                grad[t, c] = F32(blank_sum + acc) if c == blank_cls else acc
                acc = F32(0)
        if t == 0:
            break
        b0 = (beta + lp[t][u.cls]).astype(F32)
        q1 = _shift_down(b0[:, 0], 1)
        q2 = _shift_down(b0[:, 1], 1) if K >= 2 else _shift_down(b0[:, 0], 2)
        nb = np.empty_like(beta)
        for i in range(K):
            y = b0[:, i + 1] if i + 1 < K else q1
            z = b0[:, i + 2] if i + 2 < K else (q1 if i + 1 < K else q2)
            z = np.where(u.skip_fwd[:, i], z, NEG)
            nb[:, i] = np.where(u.ok[:, i], _lse3(b0[:, i], y, z), NEG)
        beta = nb
    return grad


def _batch(seed, B, T, C, U, blank=0):
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.tensor(
        rng.standard_normal((B, T, C)) * 2.0, dtype=torch.float32), -1)
    labels = rng.integers(1, C, (B, U))
    il = rng.integers(min(T // 2, 2 * U + 1), T + 1, B)
    ll = np.full(B, U)
    il[0] = T
    if B >= 6:
        il[1] = 0                                 # no frames
        ll[2] = 0                                 # empty label
        labels[3, :3] = 5                         # repeats, no skip
        labels[4, :] = 7                          # infeasible
        il[4] = U
        labels[5, 1] = blank                      # a label of the blank
        ll[5] = max(U - 2, 1)
        labels[5, ll[5]:] = rng.integers(-9, 3 * C, U - ll[5])   # garbage
    if B >= 7:
        il[6] = T + 3                             # longer than T
    return lp, labels, il, ll


def _check(lp, labels, il, ll, blank=0):
    B, T, C = lp.shape
    w = np.random.default_rng(1).random(B).astype(F32) + F32(0.5)
    args = (lp, torch.tensor(labels), torch.tensor(il), torch.tensor(ll))
    loss, ll_t, alphas = ctc_mod.ctc_forward_plain(*args, blank)
    grad = ctc_mod.ctc_backward_plain(*args, alphas, ll_t, torch.tensor(w),
                                      blank)
    x = lp.numpy()
    for b in range(B):
        u = _Utt(labels[b], int(ll[b]), C, blank)
        e_loss, e_ll, e_a = emulate_forward(x[b], u, int(il[b]))
        want = alphas[b].numpy()          # (T, 32K): the lane layout
        reach = want > -1e29
        np.testing.assert_array_equal(e_a.reshape(T, -1) > -1e29, reach)
        np.testing.assert_allclose(e_a.reshape(T, -1)[reach], want[reach],
                                   rtol=1e-6)
        np.testing.assert_allclose(e_loss, loss[b].item(), rtol=1e-6)
        e_g = emulate_backward(x[b], u, int(il[b]), e_a, e_ll, w[b], blank)
        top = max(float(np.abs(grad[b].numpy()).max()), 1e-30)
        assert np.abs(e_g - grad[b].numpy()).max() <= 1e-6 * top, b


@pytest.mark.parametrize("U", [1, 3, 6, 16, 24, 40, 50, 70])
def test_emulated_kernels_match_plain(U):
    """Every lane instance up to K = 8 (S = 3 to 141), the edge rows."""
    T = max(40, 2 * U + 12)
    _check(*_batch(U, 7 if U >= 3 else 2, T, 12, U))


def test_emulated_kernels_other_blank():
    """A blank that is not class 0, and labels of its class."""
    lp, labels, il, ll = _batch(3, 7, 40, 9, 6, blank=4)
    labels[0, 2] = 4
    _check(lp, labels, il, ll, blank=4)


def test_class_list_order_for_every_permutation():
    """For every ordering of a label multiset with repeats (the blank's
    class among them), the kernel's list holds each class's positions in
    label order, the classes in order of their first position; and the
    emulated gradient of a sample of orderings matches the plain
    version's."""
    multiset = (3, 3, 5, 5, 5, 0, 7)
    perms = sorted(set(itertools.permutations(multiset)))
    assert len(perms) == 420
    for perm in perms:
        got = class_list(list(perm), 1)
        want = []
        for c in dict.fromkeys(perm):
            at = [u for u, x in enumerate(perm) if x == c]
            want += [(_pos(2 * u + 1, 1), c * 2 + (u == at[-1])) for u in at]
        assert got == want
    rng = np.random.default_rng(0)
    lp = torch.log_softmax(torch.tensor(
        rng.standard_normal((6, 30, 9)) * 2.0, dtype=torch.float32), -1)
    pick = rng.choice(len(perms), 6, replace=False)
    labels = np.array([perms[k] for k in pick])
    _check(lp, labels, np.full(6, 30), np.full(6, 7))


def test_lane_states_and_limit():
    """K = the smallest instance with 32 K >= S, for every S up to 1024;
    S > 1024 (U > 511) raises ValueError, as does a device the kernels do
    not run on. K6b's class limit: the largest C whose tile of depth(K)
    rows fits beside the two buffers in the kernel's shared memory, and
    ctc_backward refuses one more with a ValueError that names it."""
    for S in range(1, 1025):
        K = ctc_mod.lane_states(S)
        assert 32 * K >= S and K in ctc_mod.LANE_STATES
        assert all(32 * k < S for k in ctc_mod.LANE_STATES if k < K)
    assert [ctc_mod.lane_states(S) for S in (49, 33, 81, 1023)] == [2, 2, 3,
                                                                    32]
    with pytest.raises(ValueError, match="1024"):
        ctc_mod.lane_states(1025)
    lp = torch.zeros((1, 5, 4), device="meta")
    lab = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    n = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ctc_mod.ctc_forward(lp, lab, n, n)

    def smem(K, F, C, U):             # csrc/ctc_fb.cu's bwd_smem
        return 4 * (2 * F * (32 * K + 1) + F * (C | 1) + 3 * U)

    for U_ in (0, 15, 16, 24, 40, 100, 200, 511):
        K = ctc_mod.lane_states(2 * U_ + 1)
        F = {1: 8, 2: 8, 3: 4, 4: 4, 8: 2}.get(K, 1)
        top = ctc_mod.bwd_max_classes(U_)
        assert smem(K, F, top, U_) <= 220 * 1024
        assert smem(K, F, top + 1, U_) > 220 * 1024
    assert ctc_mod.bwd_max_classes(24) >= 64    # config 3's C (config 4: 48)
    top = ctc_mod.bwd_max_classes(2)
    with pytest.raises(ValueError, match=f"at most {top} classes"):
        ctc_mod.ctc_backward(torch.zeros((1, 5, top + 1), device="meta"), lab,
                             n, n, None, None, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="device"):
        ctc_mod.ctc_backward(torch.zeros((1, 5, top), device="meta"), lab, n,
                             n, None, None, torch.zeros(1, device="meta"))
