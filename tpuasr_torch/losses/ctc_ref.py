"""Reference CTC loss: the log-space alpha recursion, gradient by autograd.

Counterpart of ``tpuasr/losses/ctc_ref.py``, the port's test oracle. The
production loss with the analytic gradient and the kernels is
``tpuasr_torch.losses.ctc``.

Shapes (fixed, padded):
  log_probs: (B, T, C) log-softmax over classes, blank = 0
  labels:    (B, U) int, padded with anything (masked by label_lengths)
  input_lengths:  (B,) valid frames
  label_lengths:  (B,) valid labels
Returns the per-utterance NLL (B,), with +inf mapped to 0 if zero_infinity.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, U) -> (B, S=2U+1) interleaved with blanks: [b, l1, b, ..., b]."""
    B, U = labels.shape
    s = torch.arange(2 * U + 1, device=labels.device)
    lab_idx = torch.clamp(torch.div(s - 1, 2, rounding_mode="floor"), min=0)
    blanks = torch.full_like(labels[:, lab_idx], blank)
    return torch.where(s % 2 == 1, labels[:, lab_idx], blanks).to(torch.int64)


def _skip_mask(ext: torch.Tensor, blank: int) -> torch.Tensor:
    """allow[s]: the skip s-2 -> s (s odd, a label differing from s-2)."""
    S = ext.shape[1]
    shifted = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    s = torch.arange(S, device=ext.device)[None, :]
    return (s % 2 == 1) & (s >= 2) & (ext != shifted)


def gather_ext(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """lp_ext[t, b, s] = log_probs[b, t, ext[b, s]] as (T, B, S) float32.

    ext is clipped for the gather only: padded label slots may hold any
    value; they are masked out by valid_s. (JAX gathers with a one-hot
    contraction, ctc_ref.py:42-55, because a TPU gather is slow; a plain
    gather is right here.)"""
    B, T, C = log_probs.shape
    idx = torch.clamp(ext, 0, C - 1)[:, None, :].expand(B, T, ext.shape[1])
    return torch.gather(log_probs.to(torch.float32), 2,
                        idx).permute(1, 0, 2).contiguous()


def ctc_alphas(log_probs, labels, input_lengths, label_lengths, blank=0):
    """The alpha recursion; returns (alphas (T, B, S), ll_per_t (T, B), aux).

    ll_per_t[t] = log P(labels | frames 0..t): the loss of a row with
    input_length t+1 is -ll_per_t[t]. aux = (ext, allow, lp_ext, valid_s).
    """
    ext = _extend_labels(labels, blank)
    allow = _skip_mask(ext, blank)
    lp_ext = gather_ext(log_probs, ext)
    T, B, S = lp_ext.shape
    s_idx = torch.arange(S, device=ext.device)[None, :]
    valid_s = s_idx <= 2 * label_lengths.to(torch.int64)[:, None]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=ext.device)
    last = 2 * label_lengths.to(torch.int64)

    def ll_of(alpha):
        a_last = alpha.gather(1, last[:, None])[:, 0]
        a_prev = alpha.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
        a_prev = torch.where(label_lengths > 0, a_prev, neg)
        return torch.logaddexp(a_last, a_prev)

    alpha = torch.where(valid_s & (s_idx < 2), lp_ext[0], neg)
    alphas, lls = [alpha], [ll_of(alpha)]
    for t in range(1, T):
        a1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg.expand(B, 2), alpha[:, :-2]], dim=1)
        a2 = torch.where(allow, a2, neg)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        m_safe = torch.maximum(m, neg)
        new = m_safe + torch.log(torch.exp(alpha - m_safe)
                                 + torch.exp(a1 - m_safe)
                                 + torch.exp(a2 - m_safe))
        alpha = torch.where(valid_s, new + lp_ext[t], neg)
        alphas.append(alpha)
        lls.append(ll_of(alpha))
    return (torch.stack(alphas), torch.stack(lls),
            (ext, allow, lp_ext, valid_s))


def ctc_loss_ref(log_probs, labels, input_lengths, label_lengths,
                 blank: int = 0, zero_infinity: bool = True) -> torch.Tensor:
    """Per-utterance CTC NLL, differentiable by autograd through the loop."""
    input_lengths = torch.as_tensor(input_lengths, device=log_probs.device)
    label_lengths = torch.as_tensor(label_lengths, device=log_probs.device)
    labels = torch.as_tensor(labels, device=log_probs.device)
    _, lls, _ = ctc_alphas(log_probs, labels, input_lengths, label_lengths,
                           blank)
    T = log_probs.shape[1]
    t_idx = torch.clamp(input_lengths.to(torch.int64) - 1, 0, T - 1)
    loss = -lls.gather(0, t_idx[None, :])[0]
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF * 0.5, torch.zeros_like(loss),
                           loss)
    return loss
