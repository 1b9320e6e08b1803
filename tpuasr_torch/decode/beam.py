"""CTC prefix beam search over all classes: kernel, plain version, wrapper.

Counterpart of ``tpuasr/decode/pallas_beam.py::ctc_beam_search_pallas``,
with bigram or trigram shallow LM fusion. ``beam_scan`` runs the per-frame
update (K3): the CUDA kernel of ``csrc/ctc_beam.cu`` for a CUDA tensor
(one warp an utterance, planned by ``beam_plan``), ``beam_scan_plain`` for a
CPU tensor. ``backtrack`` turns the packed backpointers into token sequences:
``csrc/ctc_beam.cu``'s backtrack kernel (a thread per utterance and n-best
entry) for a CUDA tensor, ``backtrack_plain`` for a CPU tensor.
``ctc_beam_search`` checks the fusion tables, applies the end-of-sentence
term and picks the n-best in plain torch, as the JAX wrapper does
(pallas_beam.py:525-629).

Semantics follow the Pallas kernel for every live hypothesis: stay/extend
scoring over all classes, the inverse-hash merge, ranking by acoustic +
lm_weight * LM, top-K selection with ties broken by (stays, then beam k
ascending, then class ascending), fresh hashes for dead selections, the
``max_len`` cap and frozen finished rows.
Dead selections (fewer than K live candidates) get the same backpointers as
in Pallas, but which NEG_INF-level candidate fills a dead lane may differ,
so the scores of dead beams (about -1e30) are not held to Pallas.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpuasr_torch import _build
from tpuasr_torch.decode.prefix_beam import (_H1_INIT as _I1,
                                             _H1_MUL as _M1,
                                             _H2_INIT as _I2,
                                             _H2_MUL as _M2, NEG_INF,
                                             BeamSearchConfig, _s32, _wrap32,
                                             logaddexp, topk_indices)

LANES = 128
# csrc/ctc_beam.cu: utterances (warps) a block at most, the shared memory a
# block may take, and the largest bigram table staged in it.
_MAX_WARPS = 4
_SMEM_BUDGET = 220 * 1024
_MAX_STAGED_TABLE = 128 * 1024


@dataclasses.dataclass(frozen=True)
class BeamPlan:
    """How K3 runs a batch: ``warps`` utterances a block (a warp each),
    the bigram table ``staged`` in shared memory once a block, and the
    block's ``smem`` bytes."""
    warps: int
    staged: bool
    smem: int


def _warp_words(K: int, C: int) -> int:
    """32-bit words of a warp's shared memory (warp_words in
    csrc/ctc_beam.cu): two log-prob rows, two buffers of the 8 state
    fields, p_tot, stay_pb, stay_pnb, the stay ranks, the two hash
    products, the winners' indices, and a bit set of merged classes a
    beam."""
    return 2 * C + 23 * K + K * -(-C // 32)


def beam_plan(B: int, K: int, C: int, lm_order: int = 0,
              n_sm: int = 132) -> BeamPlan:
    """The launch plan of K3 at batch B, beam K, C classes and LM order
    (0, 2 or 3) on a card of n_sm SMs: one warp an utterance, as many
    utterances a block as spread the batch over the SMs (at most 4, fewer
    where the shared memory does not hold them); the bigram table staged
    in shared memory where it takes at most 128 KiB and fits beside one
    warp. Raises ValueError for a shape no block can hold."""
    if not 1 <= K <= LANES - 1:
        raise ValueError(f"beam_width {K} outside [1, {LANES - 1}]")
    if C < 1 or lm_order not in (0, 2, 3):
        raise ValueError(f"beam_plan: C={C}, lm_order={lm_order}")
    per = 4 * _warp_words(K, C)
    tab = 4 * (C + 1) * C
    staged = lm_order == 2 and tab <= _MAX_STAGED_TABLE and (
        tab + per <= _SMEM_BUDGET)
    tab = tab if staged else 0
    if tab + per > _SMEM_BUDGET:
        raise ValueError(
            f"the beam kernel cannot hold K={K}, C={C}: a warp's state "
            f"takes {per} bytes of shared memory (at most {_SMEM_BUDGET})")
    warps = max(1, min(_MAX_WARPS, -(-max(B, 1) // n_sm)))
    while tab + warps * per > _SMEM_BUDGET:
        warps -= 1
    return BeamPlan(warps, staged, tab + warps * per)


def beam_scan_plain(log_probs, lengths, K: int, blank: int, max_len: int,
                    lm_table=None, lm_order: int = 0, lm_w: float = 0.0,
                    track_last2: bool = False):
    """Plain version of the beam kernel.

    log_probs (B, T, C) f32, lengths (B,); optional fusion table lm_table,
    (C+1, C) for lm_order 2 or ((C+1)^2, C) for lm_order 3, weighted by
    lm_w -> packed backpointers (T, B, K) int32 and the final p_blank,
    p_nonblank, cumulative LM score (B, K) f32, last and last2 (B, K) int32
    (last2 stays -1 unless track_last2).
    """
    B, T, C = log_probs.shape
    dev = log_probs.device
    have_lm = lm_order > 0
    lp_all = log_probs.to(torch.float32)
    lens = lengths.to(device=dev, dtype=torch.int64)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    lane = torch.arange(K, device=dev)
    cls = torch.arange(C, device=dev)
    pb = torch.where(lane == 0, 0.0, neg).expand(B, K).clone()
    pnb = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    lm = torch.zeros((B, K), dtype=torch.float32, device=dev)
    h1 = (_s32(_I1) + lane).expand(B, K).clone()
    h2 = (_I2 + lane).expand(B, K).clone()
    last = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    last2 = torch.full((B, K), -1, dtype=torch.int64, device=dev)
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

        # Shallow fusion: ranks = acoustic + lm_w * LM; the stored p_nb
        # stays acoustic and the LM score rides beside it.
        if have_lm:
            ridx = ((last2 + 1) * (C + 1) + last + 1 if lm_order == 3
                    else last + 1)
            ext_lm = lm[:, :, None] + lm_table[ridx]           # (B, K, C)
            ext_rank = ext + lm_w * ext_lm
            stay_rank = stay_tot + lm_w * lm
        else:
            ext_rank, stay_rank = ext, stay_tot

        # K rounds of argmax over (stays, extends); argmax takes the first
        # maximal index, which is the tie order of the Pallas kernel.
        cand = torch.cat([stay_rank, ext_rank.reshape(B, K * C)], dim=1)
        flat_ext = ext.reshape(B, K * C)
        flat_lm = ext_lm.reshape(B, K * C) if have_lm else None
        news = {n: [] for n in ("pb", "pnb", "lm", "h1", "h2", "last",
                                "last2", "plen", "bp")}
        for sel in range(K):
            win = torch.argmax(cand, dim=1)                    # (B,)
            val = cand[rows[:, 0], win]
            is_stay = win < K
            s_idx = win.clamp(max=K - 1)[:, None]
            e_idx = (win - K).clamp(min=0)[:, None]
            k = e_idx // C
            c = e_idx % C

            def pick(stay_val, ext_val):
                return torch.where(is_stay[:, None], stay_val, ext_val)

            spb = pick(stay_pb.gather(1, s_idx), neg.expand(B, 1))
            if have_lm:
                spnb = pick(stay_pnb.gather(1, s_idx), flat_ext.gather(1, e_idx))
                slm = pick(lm.gather(1, s_idx), flat_lm.gather(1, e_idx))
            else:
                spnb = pick(stay_pnb.gather(1, s_idx),
                            torch.maximum(val, neg)[:, None])
                slm = pick(lm.gather(1, s_idx), torch.zeros_like(spb))
            sh1 = pick(h1.gather(1, s_idx),
                       _wrap32(_wrap32(h1.gather(1, k) * m1) + c + 1))
            sh2 = pick(h2.gather(1, s_idx),
                       _wrap32(_wrap32(h2.gather(1, k) * m2) + c + 1))
            slast = pick(last.gather(1, s_idx), c)
            slast2 = (pick(last2.gather(1, s_idx), last.gather(1, k))
                      if track_last2 else torch.full_like(c, -1))
            splen = pick(plen.gather(1, s_idx), plen.gather(1, k) + 1)
            parent = pick(s_idx, k)
            ch = pick(torch.full_like(c, -1), c)
            dead = logaddexp(spb, spnb) <= NEG_INF * 0.5
            sh1 = torch.where(dead, _s32(_I1 + sel + 7777 * (t + 1)), sh1)
            sh2 = torch.where(dead, _s32(_I2 + sel + 3333 * (t + 1)), sh2)
            slast = torch.where(dead, -1, slast)
            slast2 = torch.where(dead, -1, slast2)
            ch = torch.where(dead, -1, ch)
            splen = torch.where(dead, 0, splen)
            slm = torch.where(dead, 0.0, slm)
            parent = torch.where(dead, sel, parent)
            for name, v in (("pb", spb), ("pnb", spnb), ("lm", slm),
                            ("h1", sh1), ("h2", sh2), ("last", slast),
                            ("last2", slast2), ("plen", splen),
                            ("bp", parent * 65536 + ch + 1)):
                news[name].append(v)
            cand = cand.scatter(1, win[:, None], float("-inf"))

        new = {n: torch.cat(v, 1) for n, v in news.items()}
        pb = torch.where(live, new["pb"], pb)
        pnb = torch.where(live, new["pnb"], pnb)
        lm = torch.where(live, new["lm"], lm)
        h1 = torch.where(live, new["h1"], h1)
        h2 = torch.where(live, new["h2"], h2)
        last = torch.where(live, new["last"], last)
        last2 = torch.where(live, new["last2"], last2)
        plen = torch.where(live, new["plen"], plen)
        bp[t] = torch.where(live, new["bp"].to(torch.int32), frozen_bp)
    return (bp, pb, pnb, lm, last.to(torch.int32), last2.to(torch.int32))


def beam_scan(log_probs, lengths, K: int, blank: int, max_len: int,
              lm_table=None, lm_order: int = 0, lm_w: float = 0.0,
              track_last2: bool = False):
    """The per-frame beam update over all frames (K3).

    log_probs (B, T, C) f32, lengths (B,) int32, optional fusion table (see
    ``beam_scan_plain``) -> (bp (T, B, K) int32, p_b, p_nb, lm (B, K) f32,
    last, last2 (B, K) int32). CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if log_probs.device.type == "cpu":
        return beam_scan_plain(log_probs, lengths, K, blank, max_len,
                               lm_table, lm_order, lm_w, track_last2)
    if log_probs.device.type != "cuda":
        raise ValueError(f"beam_scan: unsupported device {log_probs.device}")
    B, T, C = log_probs.shape
    dev = log_probs.device
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError("beam_scan: log_probs must be contiguous float32")
    _build.check_tensor("beam_scan: lengths", lengths, dev, (torch.int32,),
                        (B,))
    if not 0 <= blank < C:
        raise ValueError(f"beam_scan: blank {blank} outside [0, {C})")
    if lm_order not in (0, 2, 3):
        raise ValueError(f"beam_scan: lm_order {lm_order} not in (0, 2, 3)")
    if lm_order:
        rows = (C + 1) ** (lm_order - 1)
        _build.check_tensor("beam_scan: lm_table", lm_table, dev,
                            (torch.float32,), (rows, C))
    plan = beam_plan(B, K, C, lm_order,
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    bp = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    pb = torch.empty((B, K), dtype=torch.float32, device=dev)
    pnb, lm = torch.empty_like(pb), torch.empty_like(pb)
    last = torch.empty((B, K), dtype=torch.int32, device=dev)
    last2 = torch.empty_like(last)
    fn = _build.lib().tpuasr_ctc_beam
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(log_probs), _build.ptr(lengths),
                  _build.ptr(lm_table) if lm_order else None,
                  _build.ptr(bp), _build.ptr(pb), _build.ptr(pnb),
                  _build.ptr(lm), _build.ptr(last), _build.ptr(last2),
                  B, T, C, K, blank, max_len, lm_order, lm_w,
                  int(track_last2), plan.warps, int(plan.staged), plan.smem,
                  _build.stream_ptr(log_probs))
    beam_scan.launches += 1
    _build.check(code, "beam_scan")
    return bp, pb, pnb, lm, last, last2


beam_scan.launches = 0


def backtrack_plain(bp: torch.Tensor, beam_idx: torch.Tensor, max_len: int):
    """Plain version of the backtrack kernel: packed backpointers (T, B, K)
    + final beams (B, n) -> left-compacted tokens (B, n, max_len) int32
    (pad -1) and token_lens (B, n) int32. A loop over the frames."""
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


def backtrack(bp: torch.Tensor, beam_idx: torch.Tensor, max_len: int):
    """The reverse walk of the packed backpointers (JAX's reverse scan,
    pallas_beam.py:612-629): bp (T, B, K) int32 and the final beams
    beam_idx (B, n) -> tokens (B, n, max_len) int32 left-compacted, capped
    at max_len and padded with -1, and token_lens (B, n) int32. CPU tensors
    take ``backtrack_plain``; CUDA tensors launch the kernel (one launch, a
    thread per utterance and n-best entry)."""
    if bp.device.type == "cpu":
        return backtrack_plain(bp, beam_idx, max_len)
    if bp.device.type != "cuda":
        raise ValueError(f"backtrack: unsupported device {bp.device}")
    T, B, K = bp.shape
    n = beam_idx.shape[1]
    dev = bp.device
    _build.check_tensor("backtrack: bp", bp, dev, (torch.int32,), (T, B, K))
    idx = beam_idx.to(torch.int32).contiguous()
    _build.check_tensor("backtrack: beam_idx", idx, dev, (torch.int32,),
                        (B, n))
    tokens = torch.empty((B, n, max_len), dtype=torch.int32, device=dev)
    token_lens = torch.empty((B, n), dtype=torch.int32, device=dev)
    chars = torch.empty((T, B * n), dtype=torch.int32, device=dev)
    fn = _build.lib().tpuasr_ctc_backtrack
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(bp), _build.ptr(idx), _build.ptr(chars),
                  _build.ptr(tokens), _build.ptr(token_lens), T, B, K, n,
                  max_len, _build.stream_ptr(bp))
    backtrack.launches += 1
    _build.check(code, "backtrack")
    return tokens, token_lens


backtrack.launches = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ctc_beam_search(log_probs, lengths, cfg: BeamSearchConfig | None = None,
                    n_best: int = 1, lm_bigram=None, lm_eos=None,
                    lm_trigram=None):
    """CTC prefix beam search over all classes, with optional shallow LM
    fusion weighted by cfg.lm_weight (cfg.class_topk is ignored).

    lm_bigram (C+1, C) or lm_trigram (C+1, C+1, C): fusion tables (see
    NGramLM.fusion_matrix / fusion_tensor3); lm_eos (C+1,), or (C+1, C+1)
    with trigram context, is added at the final ranking. log_probs (B, T,
    C), lengths (B,) -> dict(tokens (B, n_best, max_len) int32 padded with
    -1, token_lens, scores, am_scores, lm_scores).
    """
    if cfg is None:
        cfg = BeamSearchConfig()
    K = cfg.beam_width
    if K + 1 > LANES:
        raise ValueError(f"beam_width {K} + 1 > {LANES} lanes")
    if lm_bigram is not None and lm_trigram is not None:
        raise ValueError("pass lm_bigram OR lm_trigram, not both")
    if not 1 <= n_best <= K:
        raise ValueError(f"n_best {n_best} outside [1, beam_width={K}]")
    log_probs = log_probs.to(torch.float32).contiguous()
    dev = log_probs.device
    B, T, C = log_probs.shape
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32).contiguous()

    def table(x):
        return torch.as_tensor(x, device=dev).to(torch.float32).contiguous()

    have_lm = lm_bigram is not None or lm_trigram is not None
    lm_w = float(cfg.lm_weight)
    if lm_eos is not None:
        lm_eos = table(lm_eos)
    # last2 (the next-to-last token) only where something consumes it: the
    # trigram context or a 2-D end-of-sentence matrix.
    track_last2 = (lm_trigram is not None
                   or (lm_eos is not None and lm_eos.ndim == 2))
    tab, order = None, 0
    if lm_trigram is not None:
        tri = table(lm_trigram)
        if tuple(tri.shape) != (C + 1, C + 1, C):
            raise ValueError(f"lm_trigram shape {tuple(tri.shape)} != "
                             f"{(C + 1, C + 1, C)}")
        # The TPU kernel's size gate, kept so that both packages send the
        # same vocabularies to the scan search (cli.common.run_beam_search
        # falls back on this message).
        R = (C + 1) * (C + 1)
        if _round_up(R, 8) * _round_up(C, LANES) * 4 > 6 * 2**20:
            raise ValueError(
                f"trigram fusion table ((C+1)^2={R} rows) exceeds the "
                "kernel's VMEM budget; use the XLA ctc_beam_search")
        tab, order = tri.reshape(R, C), 3
    elif lm_bigram is not None:
        tab = table(lm_bigram)
        if tuple(tab.shape) != (C + 1, C):
            raise ValueError(f"lm_bigram shape {tuple(tab.shape)} != "
                             f"{(C + 1, C)}")
        order = 2
    bp, pb, pnb, lm, last, last2 = beam_scan(
        log_probs, lengths, K, cfg.blank, cfg.max_len, tab, order, lm_w,
        track_last2)
    am = logaddexp(pb, pnb)
    lm_k = lm
    if lm_eos is not None:
        last, last2 = last.to(torch.int64), last2.to(torch.int64)
        if lm_eos.ndim == 2:   # trigram context: P(</s> | last2, last)
            lm_k = lm_k + lm_eos[last2 + 1, last + 1]
        else:
            lm_k = lm_k + lm_eos[last + 1]
    total = am + lm_w * lm_k if (have_lm or lm_eos is not None) else am
    beam_idx = topk_indices(total, n_best)
    tokens, token_lens = backtrack(bp, beam_idx, cfg.max_len)
    return dict(tokens=tokens, token_lens=token_lens,
                scores=torch.gather(total, 1, beam_idx),
                am_scores=torch.gather(am, 1, beam_idx),
                lm_scores=torch.gather(lm_k, 1, beam_idx))
