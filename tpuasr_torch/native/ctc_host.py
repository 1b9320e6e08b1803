"""Host CTC decoding in C++ (``native/ctc_host.cc``) bound by ctypes: the
port's counterpart of ``tpuasr/native/ctc_host.py``.

An exact prefix beam search (prefixes merged in a map, no hashing), greedy
decoding and the edit distance, on host arrays. They are an oracle
independent of the card's beam search, and a decoder for a host that has
no card. The library is built from the repository's source at first use
(``build.py`` beside this module); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpuasr_torch.native.build import load

__all__ = ["ctc_beam_search_host", "ctc_greedy_host", "edit_distance_host"]

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_c_int = ctypes.c_int

_SIGNATURES = {
    "ctc_beam_search": ([_f32p, _i32p, _c_int, _c_int, _c_int, _c_int, _c_int,
                         _c_int, _c_int, _i32p, _i32p, _f32p], None),
    "ctc_greedy": ([_f32p, _i32p, _c_int, _c_int, _c_int, _c_int, _i32p,
                    _i32p], None),
    "edit_distance": ([_i32p, _c_int, _i32p, _c_int], ctypes.c_int32),
}


def _lib() -> ctypes.CDLL:
    return load("ctc_host", _SIGNATURES)


def ctc_beam_search_host(log_probs, lengths, beam_width: int = 16,
                         class_topk: int = 8, blank: int = 0,
                         max_len: int = 256) -> dict:
    """Exact host prefix beam search. log_probs: (B, T, C) float32.

    Returns dict(tokens (B, max_len) i32 pad -1, token_lens (B,), scores
    (B,))."""
    log_probs = np.ascontiguousarray(log_probs, np.float32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, T, C = log_probs.shape
    tokens = np.full((B, max_len), -1, np.int32)
    tok_lens = np.zeros((B,), np.int32)
    scores = np.zeros((B,), np.float32)
    _lib().ctc_beam_search(log_probs, lengths, B, T, C, beam_width,
                           class_topk, blank, max_len, tokens, tok_lens,
                           scores)
    return dict(tokens=tokens, token_lens=tok_lens, scores=scores)


def ctc_greedy_host(log_probs, lengths, blank: int = 0):
    """-> (tokens (B, T) i32 pad -1, token_lens (B,) i32)."""
    log_probs = np.ascontiguousarray(log_probs, np.float32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, T, C = log_probs.shape
    tokens = np.full((B, T), -1, np.int32)
    tok_lens = np.zeros((B,), np.int32)
    _lib().ctc_greedy(log_probs, lengths, B, T, C, blank, tokens, tok_lens)
    return tokens, tok_lens


def edit_distance_host(a, b) -> int:
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    return int(_lib().edit_distance(a, len(a), b, len(b)))
