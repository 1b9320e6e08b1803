"""Confidence scores of CTC decodes, from quantities the pipeline already
has, with no second pass over the audio: the port's counterpart of
``tpuasr/decode/confidence.py``.

* ``beam_posterior``: for beam decodes, the probability mass of each
  hypothesis within the searched set, ``exp(score_k - logsumexp(scores))``.
  Beam scores are log p(prefix | X) totals (the search merges duplicate
  prefixes by logsumexp), so this is the n-best posterior a lattice would
  give, restricted to the beam.
* ``align_confidence``: for any decode (greedy included), force-align the
  hypothesis onto the log-probs (``losses.align.ctc_align``) and report,
  per token, the mean posterior of that token's class over its aligned
  frame span, and per utterance ``exp(viterbi_score / num_frames)``, the
  per-frame geometric mean of the Viterbi path's posterior (defined for an
  empty hypothesis too, whose path is all blanks).

Plain tensor ops on the log-probs' device; padded tokens report 0.
"""

from __future__ import annotations

import torch

from tpuasr_torch.losses.align import ctc_align

__all__ = ["align_confidence", "beam_posterior"]


def beam_posterior(scores: torch.Tensor) -> torch.Tensor:
    """(B, K) total log-probabilities of K beam hypotheses (sorted or not)
    -> (B, K) posteriors in [0, 1] summing to 1 a row."""
    scores = torch.as_tensor(scores)
    return torch.exp(scores - torch.logsumexp(scores, dim=-1, keepdim=True))


def align_confidence(log_probs: torch.Tensor, tokens, token_lens,
                     input_lengths, blank: int = 0) -> dict:
    """Token- and utterance-level confidence by CTC forced alignment.

    Args:
      log_probs: (B, T, C) log-softmax outputs, blank = ``blank``.
      tokens: (B, U) int hypothesis token ids.
      token_lens: (B,) valid token counts.
      input_lengths: (B,) valid frame counts.
    Returns a dict of tensors on log_probs' device:
      token_conf: (B, U) float32 in [0, 1], the mean posterior of token u's
        class over its aligned frame span; 0 past ``token_lens`` or where
        the alignment is infeasible.
      utt_conf: (B,) float32, exp(viterbi_score / input_length); 0 where
        infeasible.
      token_starts / token_ends: (B, U) int32 frame spans (ctc_align's).
      feasible: (B,) bool.
    """
    B, T, C = log_probs.shape
    dev = log_probs.device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int64)
    token_lens = torch.as_tensor(token_lens, device=dev).to(torch.int64)
    input_lengths = torch.as_tensor(input_lengths, device=dev).to(torch.int64)
    U = tokens.shape[1]
    al = ctc_align(log_probs, tokens, input_lengths, token_lens, blank=blank)
    st, en = al["token_starts"], al["token_ends"]              # (B, U)

    # Each token's class posterior at every frame, (B, T, U), averaged over
    # the aligned span [st, en).
    tok_g = tokens.clamp(0, C - 1)
    post_u = torch.gather(log_probs, 2,
                          tok_g[:, None, :].expand(B, T, U)).exp()
    t_idx = torch.arange(T, device=dev)[None, :, None]
    span = ((t_idx >= st[:, None, :]) & (t_idx < en[:, None, :])
            & (t_idx < input_lengths[:, None, None]))          # (B, T, U)
    n = span.sum(dim=1).clamp(min=1)                           # (B, U)
    token_conf = (post_u * span).sum(dim=1) / n
    u_valid = (torch.arange(U, device=dev)[None, :] < token_lens[:, None]) \
        & (st >= 0)
    zero = torch.zeros((), dtype=log_probs.dtype, device=dev)
    token_conf = torch.where(u_valid & al["feasible"][:, None], token_conf,
                             zero)
    frames = input_lengths.clamp(min=1).to(log_probs.dtype)
    utt_conf = torch.where(al["feasible"], torch.exp(al["scores"] / frames),
                           zero)
    return {"token_conf": token_conf, "utt_conf": utt_conf,
            "token_starts": st, "token_ends": en,
            "feasible": al["feasible"]}
