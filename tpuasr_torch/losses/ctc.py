"""CTC loss with the analytic gradient: alpha-beta forward-backward.

Counterpart of ``tpuasr/losses/ctc_fb.py`` and ``ctc_pallas.py``. The
recursions are kernels: ``ctc_alphas_kernel`` (K6, ctc_pallas.py:95) and
``ctc_betas_kernel`` (K6b, ctc_pallas.py:122), both in ``csrc/ctc_fb.cu``,
launched for CUDA tensors; for CPU tensors they run their plain versions,
``ctc_alphas_plain`` and ``ctc_betas_plain``. The emission gather, the
per-row log-likelihood and the scatter of state occupancies to classes
are plain torch around them, as JAX leaves them to XLA. The gradient is
the textbook one, with beta_t(s) excluding the emission at t:

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
    """Plain version of K6: alphas (T, B, S) with -1e30 for log 0, the
    arithmetic of ``_alpha_kernel`` (ctc_pallas.py:95-119)."""
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
    """Plain version of K6b: betas (T, B, S), beta_t(s) = log P(emissions
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


def _check_ctc(lp_ext, allow, valid):
    T, B, S = lp_ext.shape
    dev = lp_ext.device
    f32 = (torch.float32,)
    _build.check_tensor("lp_ext", lp_ext, dev, f32, (T, B, S))
    _build.check_tensor("allow", allow, dev, f32, (B, S))
    _build.check_tensor("valid", valid, dev, f32, (B, S))
    if S > 1024:
        raise ValueError(f"the CTC kernels take S = 2U+1 <= 1024, got {S}")
    return T, B, S


def ctc_alphas_kernel(lp_ext, allow, valid):
    """K6: alphas (T, B, S) f32 from lp_ext (T, B, S), allow and valid
    (B, S) float 0/1."""
    if lp_ext.device.type == "cpu":
        return ctc_alphas_plain(lp_ext, allow, valid)
    if lp_ext.device.type != "cuda":
        raise ValueError(f"ctc_alphas_kernel: unsupported device "
                         f"{lp_ext.device}")
    T, B, S = _check_ctc(lp_ext, allow, valid)
    out = torch.empty_like(lp_ext)
    if out.numel() == 0:
        return out
    fn = _build.lib().tpuasr_ctc_alpha
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lp_ext.device):
        code = fn(_build.ptr(lp_ext), _build.ptr(allow), _build.ptr(valid),
                  _build.ptr(out), T, B, S, _build.stream_ptr(lp_ext))
    ctc_alphas_kernel.launches += 1
    _build.check(code, "ctc_alphas_kernel")
    return out


ctc_alphas_kernel.launches = 0


def ctc_betas_kernel(lp_ext, allow, valid, input_lengths, label_lengths):
    """K6b: betas (T, B, S) f32 from lp_ext, allow, valid and the (B,)
    input and label lengths."""
    if lp_ext.device.type == "cpu":
        return ctc_betas_plain(lp_ext, allow, valid, input_lengths,
                               label_lengths)
    if lp_ext.device.type != "cuda":
        raise ValueError(f"ctc_betas_kernel: unsupported device "
                         f"{lp_ext.device}")
    T, B, S = _check_ctc(lp_ext, allow, valid)
    lens = input_lengths.to(device=lp_ext.device, dtype=torch.int32)
    lab = label_lengths.to(device=lp_ext.device, dtype=torch.int32)
    lens, lab = lens.contiguous(), lab.contiguous()
    if tuple(lens.shape) != (B,) or tuple(lab.shape) != (B,):
        raise ValueError("input_lengths and label_lengths must be (B,)")
    out = torch.empty_like(lp_ext)
    if out.numel() == 0:
        return out
    fn = _build.lib().tpuasr_ctc_beta
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lp_ext.device):
        code = fn(_build.ptr(lp_ext), _build.ptr(allow), _build.ptr(valid),
                  _build.ptr(lens), _build.ptr(lab), _build.ptr(out), T, B, S,
                  _build.stream_ptr(lp_ext))
    ctc_betas_kernel.launches += 1
    _build.check(code, "ctc_betas_kernel")
    return out


ctc_betas_kernel.launches = 0


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


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        ext, allow, valid, lp_ext = prepare(log_probs, labels, label_lengths,
                                            blank)
        alphas = ctc_alphas_kernel(lp_ext, allow, valid)
        ll = final_ll(alphas, input_lengths, label_lengths)
        ctx.save_for_backward(alphas, ll, ext, allow, valid, lp_ext,
                              input_lengths, label_lengths)
        ctx.num_classes = log_probs.shape[2]
        return -ll

    @staticmethod
    def backward(ctx, g):
        (alphas, ll, ext, allow, valid, lp_ext, input_lengths,
         label_lengths) = ctx.saved_tensors
        betas = ctc_betas_kernel(lp_ext, allow, valid, input_lengths,
                                 label_lengths)
        T, B, S = alphas.shape
        C = ctx.num_classes
        occ = torch.exp(torch.clamp(alphas + betas - ll[None, :, None],
                                    NEG_INF, 0.0))
        t_mask = (torch.arange(T, device=occ.device)[:, None]
                  < input_lengths[None, :])
        keep = t_mask & (ll > NEG_INF * 0.5)[None, :]
        occ = occ * keep[:, :, None] * valid[None]
        grad_ext = (-occ * g.to(torch.float32)[None, :, None]).permute(1, 0, 2)
        idx = torch.clamp(ext, 0, C - 1)[:, None, :].expand(B, T, S)
        grad = torch.zeros((B, T, C), dtype=torch.float32, device=occ.device)
        grad.scatter_add_(2, idx, grad_ext)
        return grad, None, None, None, None


def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, zero_infinity: bool = True) -> torch.Tensor:
    """Per-utterance CTC NLL (B,) of log_probs (B, T, C) with the analytic
    forward-backward gradient: K6 in the forward, K6b in the backward."""
    dev = log_probs.device
    loss = _CTCNLL.apply(log_probs.to(torch.float32),
                         torch.as_tensor(labels, device=dev),
                         torch.as_tensor(input_lengths, device=dev),
                         torch.as_tensor(label_lengths, device=dev), blank)
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF * 0.5, torch.zeros_like(loss),
                           loss)
    return loss
