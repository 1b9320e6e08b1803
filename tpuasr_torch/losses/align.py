"""CTC forced alignment: the Viterbi best path over the extended-label
lattice.

Counterpart of ``tpuasr/losses/align.py``: given log-probs and a (forced)
label sequence, max-product dynamic programming over the blank-interleaved
lattice the CTC loss uses (``losses/ctc_ref.py``), a backtrack, and

* the per-frame extended-state path,
* the per-frame label ids (blank where the path sits on a blank state),
* per-token frame spans ``[start, end)``, the timestamps,
* the Viterbi path log-probability.

Plain PyTorch on the log-probs' device (JAX has no kernel for it): a loop
over the frames forward, keeping int8 backpointers (0 = stay, 1 = from
s-1, 2 = from s-2, the first of equal maxima as ``jnp.argmax`` takes), and
one back, each row re-anchored at its own last frame, so ragged
``input_lengths`` need nothing more.

Shapes, as the loss's:
  log_probs: (B, T, C) log-softmax over classes
  labels:    (B, U) int
  input_lengths / label_lengths: (B,)
"""

from __future__ import annotations

import torch

from tpuasr_torch.losses.ctc_ref import (NEG_INF, _extend_labels,
                                         _skip_mask, gather_ext)

__all__ = ["ctc_align"]


def ctc_align(log_probs, labels, input_lengths, label_lengths,
              blank: int = 0) -> dict:
    """Force-align ``labels`` onto ``log_probs``; returns a dict of tensors.

    Keys:
      frame_states: (B, T) int32 extended-lattice state per frame
        (even = blank slot, odd s = label (s-1)//2); -1 past input_length.
      frame_labels: (B, T) int32 class id per frame (``blank`` on blank
        states); -1 past input_length.
      token_starts / token_ends: (B, U) int32 frame spans [start, end) of
        each label token; -1 past label_length or if infeasible.
      scores: (B,) float32 Viterbi path log-probability (about NEG_INF
        when the alignment is infeasible, e.g. input too short).
      feasible: (B,) bool.
    """
    B, T, C = log_probs.shape
    U = labels.shape[1]
    dev = log_probs.device
    labels = torch.as_tensor(labels, device=dev)
    in_len = torch.as_tensor(input_lengths, device=dev).to(torch.int64)
    lab_len = torch.as_tensor(label_lengths, device=dev).to(torch.int64)
    ext = _extend_labels(labels, blank)                     # (B, S)
    S = ext.shape[1]
    allow = _skip_mask(ext, blank)
    lp_ext = gather_ext(log_probs, ext)                     # (T, B, S)
    neg = torch.tensor(NEG_INF, device=dev)

    s_idx = torch.arange(S, device=dev)[None, :]
    valid_s = s_idx <= 2 * lab_len[:, None]
    delta = torch.where(valid_s & (s_idx < 2), lp_ext[0], neg)
    last = 2 * lab_len
    last_m1 = torch.clamp(last - 1, min=0)

    def end_pair(d):
        """The two legal end states' values: s = 2L and s = 2L - 1."""
        a_last = torch.gather(d, 1, last[:, None])[:, 0]
        a_prev = torch.gather(d, 1, last_m1[:, None])[:, 0]
        return a_last, torch.where(lab_len > 0, a_prev, neg)

    el, ep = end_pair(delta)
    at_end = in_len - 1 == 0
    cap_last = torch.where(at_end, el, neg)
    cap_prev = torch.where(at_end, ep, neg)
    # choices[t] holds how frame t was reached (frame 0: 0).
    choices = torch.zeros((T, B, S), dtype=torch.int8, device=dev)
    pad1 = torch.full((B, 1), NEG_INF, device=dev)
    pad2 = torch.full((B, 2), NEG_INF, device=dev)
    for t in range(1, T):
        a1 = torch.cat([pad1, delta[:, :-1]], 1)
        a2 = torch.where(allow, torch.cat([pad2, delta[:, :-2]], 1), neg)
        best, choice = delta, torch.zeros_like(choices[0])
        for k, a in ((1, a1), (2, a2)):       # the first of equal maxima
            take = a > best
            best = torch.where(take, a, best)
            choice = torch.where(take, torch.full_like(choice, k), choice)
        choices[t] = choice
        delta = torch.where(valid_s, best + lp_ext[t], neg)
        el, ep = end_pair(delta)
        at_end = t == in_len - 1
        cap_last = torch.where(at_end, el, cap_last)
        cap_prev = torch.where(at_end, ep, cap_prev)

    scores = torch.maximum(cap_last, cap_prev)
    feasible = scores > NEG_INF * 0.5
    end_state = torch.where((cap_last >= cap_prev) | (lab_len == 0), last,
                            last_m1)
    path = torch.empty((T, B), dtype=torch.int64, device=dev)
    s = end_state
    for t in range(T - 1, -1, -1):
        s = torch.where(t == in_len - 1, end_state, s)
        path[t] = s
        s = s - torch.gather(choices[t], 1, s[:, None])[:, 0].to(torch.int64)
    path = path.T                                           # (B, T)
    t_row = torch.arange(T, device=dev)[None, :]
    frame_valid = (t_row < in_len[:, None]) & feasible[:, None]
    frame_states = torch.where(frame_valid, path, -1)
    lab_at = torch.gather(ext, 1, torch.clamp(path, 0, S - 1))
    frame_labels = torch.where(path % 2 == 1, lab_at, blank)
    frame_labels = torch.where(frame_valid, frame_labels, -1)

    # Token u occupies extended state 2u+1; its span is the run of frames
    # the path spends there.
    tok_states = 2 * torch.arange(U, device=dev) + 1        # (U,)
    match = frame_states[:, :, None] == tok_states[None, None, :]
    t_col = torch.arange(T, device=dev)[None, :, None]
    starts = torch.where(match, t_col, T).amin(dim=1)
    ends = torch.where(match, t_col + 1, 0).amax(dim=1)
    tok_valid = ((torch.arange(U, device=dev)[None, :] < lab_len[:, None])
                 & feasible[:, None])
    i32 = torch.int32
    return {
        "frame_states": frame_states.to(i32),
        "frame_labels": frame_labels.to(i32),
        "token_starts": torch.where(tok_valid, starts, -1).to(i32),
        "token_ends": torch.where(tok_valid, ends, -1).to(i32),
        "scores": scores,
        "feasible": feasible,
    }
