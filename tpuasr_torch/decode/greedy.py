"""Greedy CTC decode: argmax -> collapse repeats -> strip blanks.

Counterpart of ``tpuasr/decode/greedy.py``, batched on the tensor's device.
"""

from __future__ import annotations

import torch


def greedy_decode(log_probs, lengths, blank: int = 0, pad_id: int = -1):
    """(B, T, C) log-probs, (B,) lengths -> (tokens (B, T), token_lens (B,)).

    tokens is left-compacted and padded with ``pad_id``.
    """
    B, T, _ = log_probs.shape
    ids = torch.argmax(log_probs, dim=-1)                      # (B, T)
    valid = (torch.arange(T, device=ids.device)[None, :]
             < lengths.to(ids.device)[:, None])
    prev = torch.cat([torch.full((B, 1), blank, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, T))     # dropped -> col T
    out = torch.full((B, T + 1), pad_id, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, pos, torch.where(keep, ids, torch.full_like(ids, pad_id)))
    token_lens = keep.sum(dim=1).to(torch.int32)
    return out[:, :T].to(torch.int32), token_lens
