"""CTC loss with the analytic gradient: alpha-beta forward-backward.

Counterpart of ``tpuasr/losses/ctc_fb.py`` and ``ctc_pallas.py``. The loss
is two kernels, both in ``csrc/ctc_fb.cu``: ``ctc_forward`` (K6,
ctc_pallas.py:95) goes from the log-probs, labels and lengths to the
per-row loss, its log-likelihood and the alphas in one launch (the
extended labels, masks and emission gather of ``_prepare``, the alpha
recursion, ``_final_ll`` and ``zero_infinity``); ``ctc_backward`` (K6b,
ctc_pallas.py:122) goes from those to the whole (B, T, C) gradient in one
launch (the beta recursion, the occupancies and their class sums, as
``_bwd``). For CPU tensors they run their plain versions,
``ctc_forward_plain`` and ``ctc_backward_plain``, built from
``prepare``, ``ctc_alphas_plain``, ``final_ll`` and ``ctc_betas_plain``.
The gradient is the textbook one, with beta_t(s) excluding the emission
at t:

    d loss / d log_probs[b, t, c] = -sum_{s: ext[s] = c}
                                     exp(alpha_t(s) + beta_t(s) - logZ)

masked past each row's length, on unreachable states and on infeasible
rows (ctc_pallas.py:324-339).
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build
from tpuasr_torch.losses.ctc_ref import (NEG_INF, _extend_labels, _skip_mask,
                                         gather_ext)


def prepare(log_probs, labels, label_lengths, blank: int = 0):
    """-> ext (B, S) int64, allow and valid (B, S) float 0/1, lp_ext
    (T, B, S) float32: the inputs of both recursions."""
    ext = _extend_labels(labels, blank)
    allow = _skip_mask(ext, blank).to(torch.float32)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    valid = (s_idx <= 2 * label_lengths.to(torch.int64)[:, None]).to(
        torch.float32)
    return ext, allow, valid, gather_ext(log_probs, ext)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def ctc_alphas_plain(lp_ext, allow, valid):
    """The alpha recursion of K6's plain version: alphas (T, B, S) with
    -1e30 for log 0, the arithmetic of ``_alpha_kernel``
    (ctc_pallas.py:95-119)."""
    T, B, S = lp_ext.shape
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=lp_ext.device)
    ok = valid > 0.5
    skip = allow > 0.5
    s_idx = torch.arange(S, device=lp_ext.device)[None, :]
    out = torch.empty_like(lp_ext)
    a = torch.where(ok & (s_idx < 2), lp_ext[0], neg)
    out[0] = a
    for t in range(1, T):
        a1 = torch.cat([neg.expand(B, 1), a[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg.expand(B, 2), a[:, :-2]], dim=1),
                         neg)
        a = torch.where(ok, _lse3(a, a1, a2) + lp_ext[t], neg)
        out[t] = a
    return out


def ctc_betas_plain(lp_ext, allow, valid, input_lengths, label_lengths):
    """The beta recursion of K6b's plain version: betas (T, B, S),
    beta_t(s) = log P(emissions
    t+1.. | state s at t), the arithmetic of ``_beta_kernel``
    (ctc_pallas.py:122-159) and ``ctc_fb.ctc_betas`` (ctc_fb.py:27-64):
    the emission at t+1, the skip s -> s+2 where allow[s+2], a reset to
    beta_init at t = len-1 and -1e30 from t = len on."""
    T, B, S = lp_ext.shape
    dev = lp_ext.device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    ok = valid > 0.5
    skip = torch.cat([allow[:, 2:], allow.new_zeros((B, 2))], dim=1) > 0.5
    s_idx = torch.arange(S, device=dev)[None, :]
    L = label_lengths.to(torch.int64)[:, None]
    init = torch.where((s_idx == 2 * L) | ((s_idx == 2 * L - 1) & (L > 0)),
                       torch.zeros((), device=dev), neg)
    lens = input_lengths.to(torch.int64)[:, None]
    out = torch.empty_like(lp_ext)
    beta = neg.expand(B, S)
    for t in range(T - 1, -1, -1):
        b0 = beta + (lp_ext[t + 1] if t + 1 < T else neg)
        b1 = torch.cat([b0[:, 1:], neg.expand(B, 1)], dim=1)
        b2 = torch.where(skip, torch.cat([b0[:, 2:], neg.expand(B, 2)], dim=1),
                         neg)
        beta = torch.where(ok, _lse3(b0, b1, b2), neg)
        beta = torch.where(lens - 1 == t, init, beta)
        beta = torch.where(t >= lens, neg, beta)
        out[t] = beta
    return out


def final_ll(alphas, input_lengths, label_lengths):
    """log P(labels) per row from the alphas at its last frame (t clipped
    to 0 for a length of 0), as ``_final_ll`` (ctc_pallas.py:263-275)."""
    T, B, S = alphas.shape
    t_idx = torch.clamp(input_lengths.to(torch.int64) - 1, 0, T - 1)
    a_t = alphas[t_idx, torch.arange(B, device=alphas.device)]     # (B, S)
    last = 2 * label_lengths.to(torch.int64)
    a_end = a_t.gather(1, last[:, None])[:, 0]
    a_pre = a_t.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_pre = torch.where(label_lengths > 0, a_pre,
                        torch.full_like(a_pre, NEG_INF))
    return torch.logaddexp(a_end, a_pre)


def ctc_forward_plain(log_probs, labels, input_lengths, label_lengths,
                      blank: int = 0, zero_infinity: bool = True):
    """Plain version of K6: -> (loss (B,), ll (B,), alphas (B, T, 32K)),
    the NLL with zero_infinity applied (ctc_pallas.py:345-353), the alphas
    in the kernels' layout: state s of frame t at [b, t, s], -1e30 past S
    (K = lane_states(S)). Past the kernels' S = 1024 (CPU tensors only)
    the alphas are (B, T, S)."""
    _, allow, valid, lp_ext = prepare(log_probs, labels, label_lengths,
                                      blank)
    alphas = ctc_alphas_plain(lp_ext, allow, valid)
    ll = final_ll(alphas, input_lengths, label_lengths)
    loss = -ll
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF * 0.5, torch.zeros_like(loss),
                           loss)
    S = alphas.shape[2]
    width = 32 * lane_states(S) if S <= 32 * LANE_STATES[-1] else S
    alphas = torch.nn.functional.pad(alphas.permute(1, 0, 2), (0, width - S),
                                     value=NEG_INF)
    return loss, ll, alphas.contiguous()


def ctc_backward_plain(log_probs, labels, input_lengths, label_lengths,
                       alphas, ll, g, blank: int = 0):
    """Plain version of K6b: the gradient (B, T, C) of sum(g * loss) from
    K6's alphas (B, T, 32K) and ll (B,), as ``_bwd`` (ctc_pallas.py:324-339):
    the betas, the occupancies masked to t < length, feasible rows and
    valid states, scaled by -g and scattered into the classes."""
    ext, allow, valid, lp_ext = prepare(log_probs, labels, label_lengths,
                                        blank)
    betas = ctc_betas_plain(lp_ext, allow, valid, input_lengths,
                            label_lengths)
    T, B, S = betas.shape
    C = log_probs.shape[2]
    occ = torch.exp(torch.clamp(alphas[:, :, :S].permute(1, 0, 2) + betas
                                - ll[None, :, None], NEG_INF, 0.0))
    t_mask = (torch.arange(T, device=occ.device)[:, None]
              < input_lengths[None, :])
    keep = t_mask & (ll > NEG_INF * 0.5)[None, :]
    occ = occ * keep[:, :, None] * valid[None]
    grad_ext = (-occ * g.to(torch.float32)[None, :, None]).permute(1, 0, 2)
    idx = torch.clamp(ext, 0, C - 1)[:, None, :].expand(B, T, S)
    grad = torch.zeros((B, T, C), dtype=torch.float32, device=occ.device)
    grad.scatter_add_(2, idx, grad_ext)
    return grad


# The kernels' lane layouts: K states a lane, the smallest instance of
# csrc/ctc_fb.cu with 32 * K >= S.
LANE_STATES = (1, 2, 3, 4, 8, 16, 32)


def lane_states(S: int) -> int:
    """States a lane holds in K6/K6b for S extended states (S <= 1024)."""
    if S > 32 * LANE_STATES[-1]:
        raise ValueError(f"the CTC kernels take S = 2U+1 <= 1024, got {S}")
    return next(k for k in LANE_STATES if 32 * k >= S)


# K6b's shared memory (csrc/ctc_fb.cu: bwd_smem, tpuasr_ctc_bwd): two
# buffers of F frames of 32K+1 floats, a class tile of F rows of C|1 floats
# and three int lists of U, within this budget; F is halved from 32 down to
# depth(K), the frames each state's loads run ahead.
_BWD_SMEM = 220 * 1024


def bwd_max_classes(U: int) -> int:
    """The most classes K6b takes at U labels: its tile of depth(K) rows
    of C|1 floats beside the two buffers within the shared-memory budget
    (6,901 at config 3's U = 24, 52,737 at U = 511)."""
    K = lane_states(2 * U + 1)
    F = 8 if K <= 2 else (4 if K <= 4 else (2 if K <= 8 else 1))
    row = (_BWD_SMEM // 4 - 2 * F * (32 * K + 1) - 3 * U) // F
    return row if row % 2 else row - 1


def _index(name, t, dev, shape):
    """An int32 or int64 tensor as the kernels read it (other integer types
    are converted once), and whether it is int64."""
    if t.dtype not in (torch.int32, torch.int64):
        t = t.to(torch.int32)
    t = t.contiguous()
    _build.check_tensor(name, t, dev, (t.dtype,), shape)
    return t, t.dtype == torch.int64


def _kernel_inputs(what, log_probs, labels, input_lengths, label_lengths,
                   max_classes=None):
    """Checks of both kernels' shared inputs -> (lp, labels, input
    lengths, label lengths, wide flags, B, T, C, U, K); C at most
    max_classes(U) where given."""
    dev = log_probs.device
    if log_probs.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"{what}: log_probs (B, T, C) and labels (B, U) "
                         f"expected, got {tuple(log_probs.shape)} and "
                         f"{tuple(labels.shape)}")
    B, T, C = log_probs.shape
    U = labels.shape[1]
    K = lane_states(2 * U + 1)
    if T == 0:
        raise ValueError(f"{what}: log_probs has no frames")
    if max_classes is not None and C > max_classes(U):
        raise ValueError(f"{what}: the kernel takes at most {max_classes(U)} "
                         f"classes at U = {U} labels, got C = {C}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    _build.check_tensor("log_probs", log_probs, dev, (torch.float32,),
                        (B, T, C))
    lab, w0 = _index("labels", labels, dev, (B, U))
    il, w1 = _index("input_lengths", input_lengths, dev, (B,))
    ln, w2 = _index("label_lengths", label_lengths, dev, (B,))
    return lab, il, ln, w0 | w1 << 1 | w2 << 2, B, T, C, U, K


def ctc_forward(log_probs, labels, input_lengths, label_lengths,
                blank: int = 0, zero_infinity: bool = True):
    """K6: -> (loss (B,), ll (B,), alphas (B, T, 32K)) from log_probs (B,
    T, C) float32, labels (B, U) and the (B,) lengths (int32 or int64), in
    one launch; the alphas as ``ctc_forward_plain`` lays them out."""
    if log_probs.device.type == "cpu":
        return ctc_forward_plain(log_probs, labels, input_lengths,
                                 label_lengths, blank, zero_infinity)
    lab, il, ln, wide, B, T, C, U, K = _kernel_inputs(
        "ctc_forward", log_probs, labels, input_lengths, label_lengths)
    dev = log_probs.device
    alphas = torch.empty((B, T, 32 * K), dtype=torch.float32, device=dev)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    loss = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return loss, ll, alphas
    fn = _build.lib().tpuasr_ctc_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(log_probs), _build.ptr(lab), _build.ptr(il),
                  _build.ptr(ln), _build.ptr(alphas), _build.ptr(ll),
                  _build.ptr(loss), B, T, C, U, K, blank, int(zero_infinity),
                  wide, _build.stream_ptr(log_probs))
    ctc_forward.launches += 1
    _build.check(code, "ctc_forward")
    return loss, ll, alphas


ctc_forward.launches = 0


def ctc_backward(log_probs, labels, input_lengths, label_lengths, alphas,
                 ll, g, blank: int = 0):
    """K6b: the gradient (B, T, C) float32 of sum(g * loss) with respect to
    log_probs, from the forward's inputs, its alphas (B, T, 32K) and ll
    (B,), and g (B,) read on the device, in one launch. Its shared memory
    holds a tile of C classes: at most ``bwd_max_classes(U)``."""
    if log_probs.device.type == "cpu":
        return ctc_backward_plain(log_probs, labels, input_lengths,
                                  label_lengths, alphas, ll, g, blank)
    lab, il, ln, wide, B, T, C, U, K = _kernel_inputs(
        "ctc_backward", log_probs, labels, input_lengths, label_lengths,
        bwd_max_classes)
    dev = log_probs.device
    f32 = (torch.float32,)
    _build.check_tensor("alphas", alphas, dev, f32, (B, T, 32 * K))
    _build.check_tensor("ll", ll, dev, f32, (B,))
    g = g.to(torch.float32).contiguous()
    _build.check_tensor("g", g, dev, f32, (B,))
    grad = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    if B == 0:
        return grad
    fn = _build.lib().tpuasr_ctc_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(log_probs), _build.ptr(lab), _build.ptr(il),
                  _build.ptr(ln), _build.ptr(alphas), _build.ptr(ll),
                  _build.ptr(g), _build.ptr(grad), B, T, C, U, K, blank,
                  wide, _build.stream_ptr(log_probs))
    ctc_backward.launches += 1
    _build.check(code, "ctc_backward")
    return grad


ctc_backward.launches = 0


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank,
                zero_infinity):
        loss, ll, alphas = ctc_forward(log_probs, labels, input_lengths,
                                       label_lengths, blank, zero_infinity)
        ctx.save_for_backward(log_probs, labels, input_lengths,
                              label_lengths, alphas, ll)
        ctx.blank = blank
        return loss

    @staticmethod
    def backward(ctx, g):
        grad = ctc_backward(*ctx.saved_tensors, g, ctx.blank)
        return grad, None, None, None, None, None


def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, zero_infinity: bool = True) -> torch.Tensor:
    """Per-utterance CTC NLL (B,) of log_probs (B, T, C) with the analytic
    forward-backward gradient: K6 in the forward, K6b in the backward."""
    dev = log_probs.device
    return _CTCNLL.apply(log_probs.to(torch.float32).contiguous(),
                         torch.as_tensor(labels, device=dev),
                         torch.as_tensor(input_lengths, device=dev),
                         torch.as_tensor(label_lengths, device=dev), blank,
                         zero_infinity)
