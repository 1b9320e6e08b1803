"""CTC prefix beam search over all classes: kernel, plain version, wrapper.

Counterpart of ``tpuasr/decode/pallas_beam.py::ctc_beam_search_pallas`` in
its no-LM form. ``beam_scan`` runs the per-frame update (K3): the CUDA
kernel of ``csrc/ctc_beam.cu`` for a CUDA tensor, ``beam_scan_plain`` for a
CPU tensor. ``ctc_beam_search`` turns the packed backpointers into token
sequences and picks the n-best in plain torch, as the JAX wrapper does
(pallas_beam.py:596-629).

Semantics follow the Pallas kernel for every live hypothesis: stay/extend
scoring over all classes, the inverse-hash merge, top-K selection with
ties broken by (stays, then beam k ascending, then class ascending), fresh
hashes for dead selections, the ``max_len`` cap and frozen finished rows.
Dead selections (fewer than K live candidates) get the same backpointers as
in Pallas, but which NEG_INF-level candidate fills a dead lane may differ,
so the scores of dead beams (about -1e30) are not held to Pallas.
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build
from tpuasr_torch.decode.prefix_beam import NEG_INF, BeamSearchConfig

LANES = 128
_M1 = 2654435761
_M2 = 40503
_I1 = 2166136261
_I2 = 5381


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the same value mod 2^32, as a signed int32 in int64."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _s32(v: int) -> int:
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max + log1p(exp(min - max)), the form both beam kernels use."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(torch.minimum(a, b) - m))


def beam_scan_plain(log_probs, lengths, K: int, blank: int, max_len: int):
    """Plain version of the beam kernel.

    log_probs (B, T, C) f32, lengths (B,) -> packed backpointers
    (T, B, K) int32 and the final p_blank, p_nonblank (B, K) f32.
    """
    B, T, C = log_probs.shape
    dev = log_probs.device
    lp_all = log_probs.to(torch.float32)
    lens = lengths.to(device=dev, dtype=torch.int64)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    lane = torch.arange(K, device=dev)
    cls = torch.arange(C, device=dev)
    pb = torch.where(lane == 0, 0.0, neg).expand(B, K).clone()
    pnb = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    h1 = (_s32(_I1) + lane).expand(B, K).clone()
    h2 = (_I2 + lane).expand(B, K).clone()
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    plen = torch.zeros((B, K), dtype=torch.int64, device=dev)
    bp = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    frozen_bp = (lane * 65536).to(torch.int32).expand(B, K)
    rows = torch.arange(B, device=dev)[:, None]
    m1, m2 = _s32(_M1), _M2

    for t in range(T):
        lp = lp_all[:, t, :]                                   # (B, C)
        live = (t < lens)[:, None]                             # (B, 1)
        ptot = logaddexp(pb, pnb)
        stay_pb = ptot + lp[:, blank:blank + 1]
        lp_last = torch.gather(lp, 1, last.clamp(0, C - 1))
        stay_pnb = pnb + torch.where(last < 0, neg, lp_last)
        lp_nb = torch.where(cls == blank, neg, lp)
        is_rep = cls[None, None, :] == last[:, :, None]       # (B, K, C)
        ext = torch.where(is_rep, pb[:, :, None], ptot[:, :, None]) \
            + lp_nb[:, None, :]
        ext = torch.where((plen >= max_len)[:, :, None], neg, ext)

        # Inverse-hash join, indexed [b, k, j].
        c_kj = _wrap32(h1[:, None, :] - _wrap32(h1[:, :, None] * m1) - 1)
        valid = ((h2[:, None, :]
                  == _wrap32(_wrap32(h2[:, :, None] * m2) + c_kj + 1))
                 & (c_kj >= 0) & (c_kj < C))
        cidx = c_kj.clamp(0, C - 1)
        contrib = torch.where(valid, torch.gather(ext, 2, cidx),
                              torch.tensor(float("-inf"), device=dev))
        merged = ((cidx[:, :, :, None] == cls) & valid[:, :, :, None]).any(2)
        ext = torch.where(merged, neg, ext)
        m = torch.maximum(contrib.amax(dim=1), neg)            # (B, K_j)
        live_m = m > NEG_INF * 0.5
        safe = torch.where(live_m, m, 0.0)
        e = torch.where(contrib > NEG_INF * 0.5,
                        torch.exp(contrib - safe[:, None, :]), 0.0)
        absorbed = torch.where(live_m, safe + torch.log(e.sum(dim=1)), neg)
        stay_pnb = logaddexp(stay_pnb, absorbed)
        stay_tot = logaddexp(stay_pb, stay_pnb)

        # K rounds of argmax over (stays, extends); argmax takes the first
        # maximal index, which is the tie order of the Pallas kernel.
        cand = torch.cat([stay_tot, ext.reshape(B, K * C)], dim=1)
        n_pb, n_pnb, n_h1, n_h2, n_last, n_plen, n_bp = ([] for _ in range(7))
        for sel in range(K):
            win = torch.argmax(cand, dim=1)                    # (B,)
            val = cand[rows[:, 0], win]
            is_stay = win < K
            s_idx = win.clamp(max=K - 1)[:, None]
            e_idx = (win - K).clamp(min=0)
            k = (e_idx // C)[:, None]
            c = (e_idx % C)[:, None]

            def pick(stay_val, ext_val):
                return torch.where(is_stay[:, None], stay_val, ext_val)

            spb = pick(stay_pb.gather(1, s_idx), neg.expand(B, 1))
            spnb = pick(stay_pnb.gather(1, s_idx),
                        torch.maximum(val, neg)[:, None])
            sh1 = pick(h1.gather(1, s_idx),
                       _wrap32(_wrap32(h1.gather(1, k) * m1) + c + 1))
            sh2 = pick(h2.gather(1, s_idx),
                       _wrap32(_wrap32(h2.gather(1, k) * m2) + c + 1))
            slast = pick(last.gather(1, s_idx), c)
            splen = pick(plen.gather(1, s_idx), plen.gather(1, k) + 1)
            parent = pick(s_idx, k)
            ch = pick(torch.full_like(c, -1), c)
            dead = logaddexp(spb, spnb) <= NEG_INF * 0.5
            sh1 = torch.where(dead, _s32(_I1 + sel + 7777 * (t + 1)), sh1)
            sh2 = torch.where(dead, _s32(_I2 + sel + 3333 * (t + 1)), sh2)
            slast = torch.where(dead, -1, slast)
            ch = torch.where(dead, -1, ch)
            splen = torch.where(dead, 0, splen)
            parent = torch.where(dead, sel, parent)
            for acc, v in ((n_pb, spb), (n_pnb, spnb), (n_h1, sh1),
                           (n_h2, sh2), (n_last, slast), (n_plen, splen),
                           (n_bp, parent * 65536 + ch + 1)):
                acc.append(v)
            cand = cand.scatter(1, win[:, None], float("-inf"))

        pb = torch.where(live, torch.cat(n_pb, 1), pb)
        pnb = torch.where(live, torch.cat(n_pnb, 1), pnb)
        h1 = torch.where(live, torch.cat(n_h1, 1), h1)
        h2 = torch.where(live, torch.cat(n_h2, 1), h2)
        last = torch.where(live, torch.cat(n_last, 1), last)
        plen = torch.where(live, torch.cat(n_plen, 1), plen)
        bp[t] = torch.where(live, torch.cat(n_bp, 1).to(torch.int32),
                            frozen_bp)
    return bp, pb, pnb


def beam_scan(log_probs, lengths, K: int, blank: int, max_len: int):
    """The per-frame beam update over all frames (K3).

    log_probs (B, T, C) f32, lengths (B,) int32 -> (bp (T, B, K) int32,
    p_b (B, K) f32, p_nb (B, K) f32). CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if log_probs.device.type == "cpu":
        return beam_scan_plain(log_probs, lengths, K, blank, max_len)
    if log_probs.device.type != "cuda":
        raise ValueError(f"beam_scan: unsupported device {log_probs.device}")
    B, T, C = log_probs.shape
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError("beam_scan: log_probs must be contiguous float32")
    if (lengths.device != log_probs.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError("beam_scan: lengths must be contiguous int32 (B,) "
                         "on the device of log_probs")
    if not 0 <= blank < C:
        raise ValueError(f"beam_scan: blank {blank} outside [0, {C})")
    bp = torch.empty((T, B, K), dtype=torch.int32, device=log_probs.device)
    pb = torch.empty((B, K), dtype=torch.float32, device=log_probs.device)
    pnb = torch.empty_like(pb)
    fn = _build.lib().tpuasr_ctc_beam
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(log_probs.device):
        code = fn(_build.ptr(log_probs), _build.ptr(lengths), _build.ptr(bp),
                  _build.ptr(pb), _build.ptr(pnb), B, T, C, K, blank,
                  max_len, _build.stream_ptr(log_probs))
    beam_scan.launches += 1
    _build.check(code, "beam_scan")
    return bp, pb, pnb


beam_scan.launches = 0


def backtrack(bp: torch.Tensor, beam_idx: torch.Tensor, max_len: int):
    """Packed backpointers (T, B, K) + final beams (B, n) -> left-compacted
    tokens (B, n, max_len) int32 (pad -1) and token_lens (B, n) int32."""
    T, B, _ = bp.shape
    n = beam_idx.shape[1]
    cur = beam_idx.to(torch.int64)
    chars = torch.empty((T, B, n), dtype=torch.int64, device=bp.device)
    for t in range(T - 1, -1, -1):
        pk = torch.gather(bp[t].to(torch.int64), 1, cur)
        chars[t] = pk % 65536 - 1
        cur = pk // 65536
    toks = chars.permute(1, 2, 0)                             # (B, n, T)
    keep = toks >= 0
    pos = torch.cumsum(keep.to(torch.int64), dim=2) - 1
    pos = torch.where(keep & (pos < max_len), pos, max_len)
    out = torch.full((B, n, max_len + 1), -1, dtype=torch.int64,
                     device=bp.device)
    out.scatter_(2, pos, torch.where(keep, toks, -1))
    token_lens = torch.clamp(keep.sum(dim=2), max=max_len).to(torch.int32)
    return out[:, :, :max_len].to(torch.int32), token_lens


def ctc_beam_search(log_probs, lengths, cfg: BeamSearchConfig | None = None,
                    n_best: int = 1, lm_bigram=None, lm_eos=None,
                    lm_trigram=None):
    """CTC prefix beam search over all classes (no LM).

    log_probs (B, T, C), lengths (B,) -> dict(tokens (B, n_best, max_len)
    int32 padded with -1, token_lens, scores, am_scores, lm_scores).
    """
    if lm_bigram is not None or lm_trigram is not None or lm_eos is not None:
        raise NotImplementedError(
            "shallow LM fusion in the beam kernel is not ported yet")
    if cfg is None:
        cfg = BeamSearchConfig()
    K = cfg.beam_width
    if K + 1 > LANES:
        raise ValueError(f"beam_width {K} + 1 > {LANES} lanes")
    if not 1 <= n_best <= K:
        raise ValueError(f"n_best {n_best} outside [1, beam_width={K}]")
    log_probs = log_probs.to(torch.float32).contiguous()
    lengths = torch.as_tensor(lengths, device=log_probs.device).to(
        torch.int32).contiguous()
    bp, pb, pnb = beam_scan(log_probs, lengths, K, cfg.blank, cfg.max_len)
    am = logaddexp(pb, pnb)
    order = torch.sort(am, dim=1, descending=True, stable=True).indices
    beam_idx = order[:, :n_best]
    scores = torch.gather(am, 1, beam_idx)
    tokens, token_lens = backtrack(bp, beam_idx, cfg.max_len)
    return dict(tokens=tokens, token_lens=token_lens, scores=scores,
                am_scores=scores, lm_scores=torch.zeros_like(scores))
