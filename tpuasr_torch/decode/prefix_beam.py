"""Batched CTC prefix beam search with top-P class pruning, shallow LM
fusion and graph-constrained decoding (the scan search).

Counterpart of ``tpuasr/decode/prefix_beam.py`` (an XLA ``lax.scan`` there).
Per frame and utterance:

  * classes are pruned to the top-P by emission log-prob (blank handled
    separately); with a decoding graph the pruning is per beam and
    graph-aware: classes the beam's graph state forbids are masked first,
    legal ones rank by acoustic - graph_weight * arc cost;
  * candidates are the K stays and the K*P extends; extends that spell an
    existing beam's prefix merge into it through a hash join of the extend
    hashes against the beam hashes (two 32-bit rolling hashes per prefix);
  * the top-K by acoustic + lm_weight * LM - graph_weight * graph cost
    survive. The only ordering op is a stable descending sort, whose ties
    go to the lower index as ``jax.lax.top_k``'s do.

``scan_search`` runs all frames: on a CUDA tensor the kernel of
``csrc/scan_beam.cu`` (K10's redesign: one launch for the whole frame loop,
each beam's packed (next states | cost bits) row of the (S, 2C) int32 graph
table fetched inside; its limits in ``check_scan_beam_shape``), on a CPU
tensor ``scan_search_plain``, a loop of torch ops over the frames. Both
emit packed (parent, char) backpointers; ``rebuild_prefixes`` (the backtrack
kernel of ``csrc/ctc_beam.cu`` on a CUDA tensor, ``rebuild_prefixes_plain``
on a CPU tensor) rebuilds the prefixes in one reverse pass, which lets a
call resume from another's state (``init_state`` / ``return_state``).

Hashes are uint32 in the JAX package; torch has no uint32 arithmetic, so
they are kept as the same bit patterns in int32 and computed in int64
wrapped to 32 bits (``_wrap32``): equal hashes stay equal.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpuasr_torch import _build
from tpuasr_torch.ops.gather import gather_rows_plain

NEG_INF = -1e30
_H1_MUL = 2654435761   # Knuth multiplicative hashing
_H2_MUL = 40503
_H1_INIT = 2166136261  # FNV offset basis
_H2_INIT = 5381        # djb2


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_width: int = 16          # K
    class_topk: int = 8           # P (ignored by the all-class kernel)
    max_len: int = 256            # prefix buffer length (tokens)
    blank: int = 0
    # Additive log-bias on non-blank emissions (apply_score_bias).
    token_insertion_bonus: float = 0.0
    # Weight on the n-gram LM term when a fusion table is passed.
    lm_weight: float = 0.0
    # Weight on the decoding-graph cost when ``graph`` is passed.
    graph_weight: float = 1.0
    # Cap on the graph final cost at ranking time: a hypothesis whose graph
    # state is not final is penalized by this (finite) amount, not killed.
    graph_final_cap: float = 1e4


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the same value mod 2^32, as a signed int32 in int64."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _s32(v: int) -> int:
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max + log1p(exp(min - max)), the form both beam searches use."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(torch.minimum(a, b) - m))


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def apply_score_bias(log_probs, cfg: BeamSearchConfig, token_bias=None):
    """Bias non-blank emissions for shallow fusion. token_bias: (C,) log
    prior (e.g. from a unigram LM), optional."""
    C = log_probs.shape[-1]
    bias = torch.zeros((C,), dtype=log_probs.dtype, device=log_probs.device)
    if token_bias is not None:
        bias = bias + torch.as_tensor(token_bias, dtype=log_probs.dtype,
                                      device=log_probs.device)
    if cfg.token_insertion_bonus:
        bias = bias + cfg.token_insertion_bonus
    bias[cfg.blank] = 0.0
    return log_probs + bias


def beam_init_state(B: int, cfg: BeamSearchConfig, device="cpu") -> dict:
    """Fresh beam state (beam 0 = empty prefix, the rest dead). Also the
    carry format for resumable decoding (ctc_beam_search's init_state /
    return_state). h1/h2 hold the JAX package's uint32 bits as int32."""
    K, L = cfg.beam_width, cfg.max_len
    lane = torch.arange(K, device=device)
    return dict(
        prefixes=torch.full((B, K, L), -1, dtype=torch.int32, device=device),
        plen=torch.zeros((B, K), dtype=torch.int32, device=device),
        last=torch.full((B, K), -1, dtype=torch.int32, device=device),
        last2=torch.full((B, K), -1, dtype=torch.int32, device=device),
        p_b=torch.where(lane == 0, 0.0, NEG_INF).expand(B, K).contiguous(),
        p_nb=torch.full((B, K), NEG_INF, device=device),
        # Cumulative (unweighted) LM log-prob of each prefix.
        lm=torch.zeros((B, K), device=device),
        # Distinct hashes for dead beams so they never merge with live ones.
        h1=_wrap32(_H1_INIT + lane).to(torch.int32).expand(B, K).contiguous(),
        h2=(_H2_INIT + lane).to(torch.int32).expand(B, K).contiguous(),
    )


def beam_results(state: dict, n_best: int = 1, lm_weight=0.0, lm_eos=None,
                 graph_final=None, graph_weight=1.0,
                 graph_final_cap: float = 1e4) -> dict:
    """Rank a beam state's hypotheses (the tail of ctc_beam_search).

    ``scores`` is acoustic + lm_weight * LM(prefix) (plus ln P(</s> | last)
    from ``lm_eos`` (C+1,), or P(</s> | last2, last) from a (C+1, C+1)
    matrix); with ``graph_final`` (S,) it also subtracts graph_weight *
    (path graph cost + final cost capped at graph_final_cap), reported as
    ``graph_scores`` and ``reached_final``.
    """
    am = logaddexp(state["p_b"], state["p_nb"])        # (B, K)
    dev = am.device
    lm = state.get("lm")
    if lm is None:
        lm = torch.zeros_like(am)
    last = state["last"].to(torch.int64)
    if lm_eos is not None:
        lm_eos = torch.as_tensor(lm_eos, device=dev).to(torch.float32)
        if lm_eos.ndim == 2:   # trigram context: P(</s> | last2, last)
            lm = lm + lm_eos[state["last2"].to(torch.int64) + 1, last + 1]
        else:
            lm = lm + lm_eos[last + 1]
    total = am + lm_weight * lm
    gcost = reached = None
    if graph_final is not None and "gs" in state:
        final = torch.as_tensor(graph_final, device=dev).to(torch.float32)
        fcost = final[state["gs"].to(torch.int64)]      # (B, K)
        reached = fcost < graph_final_cap
        gcost = state["gc"] + torch.clamp(fcost, max=graph_final_cap)
        total = total - graph_weight * gcost
    idx = topk_indices(total, n_best)

    def take(x):
        return torch.gather(x, 1, idx)

    tokens = torch.gather(state["prefixes"], 1,
                          idx[:, :, None].expand(-1, -1,
                                                 state["prefixes"].shape[2]))
    out = dict(tokens=tokens, token_lens=take(state["plen"]),
               scores=take(total), am_scores=take(am), lm_scores=take(lm))
    if gcost is not None:
        out["graph_scores"] = take(gcost)
        out["reached_final"] = take(reached)
    return out


# csrc/scan_beam.cu's limits: a warp a beam (at most 32 warps, 1024
# threads, a block), and up to 1024 classes (32 a lane).
MAX_K = 32
MAX_C = 1024
# SM clock parts of a frame that the kernel counts when asked (``clocks``;
# kClockParts in csrc/scan_beam.cu).
CLOCK_PARTS = ("fetch", "top-P", "extends", "lists", "wait 1", "stays",
               "wait 2", "merge", "wait 3")


def check_scan_beam_shape(K: int, C: int, P: int) -> None:
    """Raise ValueError where the scan-search kernel does not take beam K,
    C classes and class_topk P: K in [1, 32], C in [2, 1024], P in [1, C -
    1]. The kernel sizes its block (a warp a beam) and its shared memory
    itself."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the scan search kernel takes beam_width 1 to "
                         f"{MAX_K} (a warp a beam), got {K}")
    if not 2 <= C <= MAX_C:
        raise ValueError(f"the scan search kernel takes 2 to {MAX_C} "
                         f"classes, got {C}")
    if not 1 <= P <= C - 1:
        raise ValueError(f"the scan search kernel takes class_topk P in "
                         f"[1, C - 1 = {C - 1}], got {P}")


def scan_search_plain(log_probs, lengths, state: dict, K: int, P: int,
                      blank: int, max_len: int, lm_table=None,
                      lm_order: int = 0, lm_w=0.0, g_pack=None, g_w=1.0):
    """Plain version of the scan-search kernel: a loop of torch ops over
    the frames.

    log_probs (B, T, C) f32, lengths (B,), the state at the first frame
    (p_b, p_nb, lm, h1, h2, last, last2, plen (B, K); gs, gc with a graph),
    the fusion table (C+1, C) for lm_order 2 or ((C+1)^2, C) for lm_order
    3, the packed graph table g_pack (S, 2C) int32 ([next states | cost
    bits]) -> packed backpointers (T, B, K), parent * 65536 + char + 1 in
    int32 as the kernel packs them (C < 65536; parent * 2^32 + char + 1 in
    int64 past that, which only this version takes), identity past each
    length, and the state after the last frame (ints as int32, the hashes
    as their uint32 bits).
    """
    B, T, C = log_probs.shape
    L = max_len
    dev = log_probs.device
    lp_all = log_probs.to(torch.float32)
    lens = torch.as_tensor(lengths, device=dev).to(torch.int64)
    graph = g_pack is not None
    i64 = torch.int64
    p_b, p_nb = state["p_b"].to(torch.float32), state["p_nb"].to(torch.float32)
    lm = state["lm"].to(torch.float32)
    last, last2 = state["last"].to(i64), state["last2"].to(i64)
    plen = state["plen"].to(i64)
    h1, h2 = state["h1"].to(i64), state["h2"].to(i64)
    if graph:
        gs, gc = state["gs"].to(i64), state["gc"].to(torch.float32)
    k_iota = torch.arange(K, device=dev).expand(B, K)
    parent = torch.cat([torch.arange(K, device=dev),
                        torch.arange(K, device=dev).repeat_interleave(P)])
    neg_kp = torch.full((B, K * P), NEG_INF, device=dev)
    no_char = torch.full((B, K), -1, dtype=i64, device=dev)
    m1, m2 = _s32(_H1_MUL), _H2_MUL
    wide = C >= 65536
    radix = 2 ** 32 if wide else 65536
    bp = torch.empty((T, B, K), dtype=i64 if wide else torch.int32,
                     device=dev)

    for t in range(T):
        lp_t = lp_all[:, t]                             # (B, C)
        lp_blank = lp_t[:, blank]
        lp_nb_all = lp_t.clone()
        lp_nb_all[:, blank] = NEG_INF
        p_tot = logaddexp(p_b, p_nb)                    # (B, K)

        # Class selection: top-P per step, per beam and graph-aware with a
        # graph (forbidden classes masked before the sort).
        if graph:
            rows = gather_rows_plain(g_pack, gs)        # (B, K, 2C) int32
            nxt_rows = rows[:, :, :C]
            cost_rows = rows[:, :, C:].contiguous().view(torch.float32)
            sel = torch.where(nxt_rows >= 0,
                              lp_nb_all[:, None, :] - g_w * cost_rows,
                              NEG_INF)
            top_c = topk_indices(sel, P)                # (B, K, P)
            top_lp = torch.gather(lp_nb_all[:, None, :].expand(B, K, C), 2,
                                  top_c)
        else:
            top_c_b = topk_indices(lp_nb_all, P)        # (B, P)
            top_lp_b = torch.gather(lp_nb_all, 1, top_c_b)
            top_c = top_c_b[:, None, :].expand(B, K, P)
            top_lp = top_lp_b[:, None, :].expand(B, K, P)

        # ---- stay candidates (K): same prefix ----
        stay_p_b = p_tot + lp_blank[:, None]
        lp_last = torch.gather(lp_t, 1, last.clamp(0, C - 1))
        stay_p_nb = p_nb + lp_last

        # ---- extend candidates (K, P): append c ----
        is_rep = top_c == last[:, :, None]
        base = torch.where(is_rep, p_b[:, :, None], p_tot[:, :, None])
        ext_p_nb = base + top_lp
        ext_p_nb = torch.where(plen[:, :, None] >= L, NEG_INF, ext_p_nb)
        if graph:
            ext_gs = torch.gather(nxt_rows, 2, top_c).to(i64)
            g_step = torch.gather(cost_rows, 2, top_c)
            ext_p_nb = torch.where(ext_gs < 0, NEG_INF, ext_p_nb)
            ext_gc = gc[:, :, None] + torch.where(ext_gs < 0, 0.0, g_step)
            ext_gs = ext_gs.clamp(min=0)
        cu = top_c + 1
        ext_h1 = _wrap32(_wrap32(h1[:, :, None] * m1) + cu)
        ext_h2 = _wrap32(_wrap32(h2[:, :, None] * m2) + cu)
        if lm_order:
            # ln P(c | context) per extension; index 0 = "no token there".
            ridx = ((last2 + 1) * (C + 1) + last + 1 if lm_order == 3
                    else last + 1)
            ext_lm = lm[:, :, None] + torch.gather(lm_table[ridx], 2, top_c)
        else:
            ext_lm = lm[:, :, None].expand(B, K, P)

        # ---- merge: hash-join extends into existing beams ----
        match = ((ext_h1[:, :, :, None] == h1[:, None, None, :])
                 & (ext_h2[:, :, :, None] == h2[:, None, None, :]))
        contrib = torch.where(match, ext_p_nb[:, :, :, None], NEG_INF)
        cmax = contrib.amax(dim=(1, 2))
        absorbed = cmax + torch.log(
            torch.exp(contrib - cmax[:, None, None, :]).sum(dim=(1, 2))
            + 1e-38)
        stay_p_nb = logaddexp(stay_p_nb, absorbed)
        ext_p_nb = torch.where(match.any(dim=3), NEG_INF, ext_p_nb)

        # ---- candidate set: K stays + K*P unmatched extends ----
        cand_p_b = torch.cat([stay_p_b, neg_kp], 1)
        cand_p_nb = torch.cat([stay_p_nb, ext_p_nb.reshape(B, K * P)], 1)
        cand_h1 = torch.cat([h1, ext_h1.reshape(B, K * P)], 1)
        cand_h2 = torch.cat([h2, ext_h2.reshape(B, K * P)], 1)
        cand_lm = torch.cat([lm, ext_lm.reshape(B, K * P)], 1)
        ext_char = torch.cat([no_char, top_c.reshape(B, K * P)], 1)

        # ---- prune to top-K by total score ----
        total = logaddexp(cand_p_b, cand_p_nb) + lm_w * cand_lm
        if graph:
            cand_gc = torch.cat([gc, ext_gc.reshape(B, K * P)], 1)
            total = total - g_w * cand_gc
        top_idx = topk_indices(total, K)                # (B, K)

        def h(x):
            return torch.gather(x, 1, top_idx)

        sel_parent, sel_char = parent[top_idx], h(ext_char)
        extend = sel_char >= 0
        par_last = torch.gather(last, 1, sel_parent)
        new = dict(
            p_b=h(cand_p_b), p_nb=h(cand_p_nb), h1=h(cand_h1), h2=h(cand_h2),
            lm=h(cand_lm),
            plen=torch.gather(plen, 1, sel_parent) + extend.to(i64),
            last=torch.where(extend, sel_char, par_last),
            last2=torch.where(extend, par_last,
                              torch.gather(last2, 1, sel_parent)))
        if graph:
            new["gs"] = h(torch.cat([gs, ext_gs.reshape(B, K * P)], 1))
            new["gc"] = h(cand_gc)

        # ---- freeze state past each utterance's length ----
        live = (t < lens)[:, None]
        p_b = torch.where(live, new["p_b"], p_b)
        p_nb = torch.where(live, new["p_nb"], p_nb)
        h1 = torch.where(live, new["h1"], h1)
        h2 = torch.where(live, new["h2"], h2)
        lm = torch.where(live, new["lm"], lm)
        plen = torch.where(live, new["plen"], plen)
        last = torch.where(live, new["last"], last)
        last2 = torch.where(live, new["last2"], last2)
        if graph:
            gs = torch.where(live, new["gs"], gs)
            gc = torch.where(live, new["gc"], gc)
        # Frozen rows emit identity backpointers (own lane, no char).
        bp[t] = (torch.where(live, sel_parent, k_iota) * radix
                 + torch.where(live, sel_char, -1) + 1).to(bp.dtype)

    i32 = torch.int32
    final = dict(plen=plen.to(i32), last=last.to(i32), last2=last2.to(i32),
                 p_b=p_b, p_nb=p_nb, lm=lm, h1=h1.to(i32), h2=h2.to(i32))
    if graph:
        final.update(gs=gs.to(i32), gc=gc)
    return bp, final


def scan_search(log_probs, lengths, state: dict, K: int, P: int, blank: int,
                max_len: int, lm_table=None, lm_order: int = 0, lm_w=0.0,
                g_pack=None, g_w=1.0, clocks=None):
    """The scan search over all frames (see ``scan_search_plain`` for the
    arguments and results). CPU tensors take the plain version; CUDA
    tensors launch the kernel of csrc/scan_beam.cu once, or raise
    ValueError for a shape it does not take (``check_scan_beam_shape``).
    clocks: an optional (B, len(CLOCK_PARTS)) int64 CUDA tensor that
    receives each utterance's SM clock cycles by part of a frame, summed
    over its frames, as thread 0 of its block sees them."""
    if log_probs.device.type == "cpu":
        return scan_search_plain(log_probs, lengths, state, K, P, blank,
                                 max_len, lm_table, lm_order, lm_w, g_pack,
                                 g_w)
    if log_probs.device.type != "cuda":
        raise ValueError(f"scan_search: unsupported device {log_probs.device}")
    B, T, C = log_probs.shape
    dev = log_probs.device
    check_scan_beam_shape(K, C, P)
    if log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError("scan_search: log_probs must be contiguous float32")
    _build.check_tensor("scan_search: lengths", lengths, dev, (torch.int32,),
                        (B,))
    if not 0 <= blank < C:
        raise ValueError(f"scan_search: blank {blank} outside [0, {C})")
    if max_len < 1:
        raise ValueError(f"scan_search: max_len {max_len} < 1")
    if lm_order not in (0, 2, 3):
        raise ValueError(f"scan_search: lm_order {lm_order} not in (0, 2, 3)")
    if lm_order:
        _build.check_tensor("scan_search: lm_table", lm_table, dev,
                            (torch.float32,), ((C + 1) ** (lm_order - 1), C))
    S = 0
    if g_pack is not None:
        S = g_pack.shape[0]
        if S < 1:
            raise ValueError("scan_search: the graph table has no state")
        _build.check_tensor("scan_search: g_pack", g_pack, dev,
                            (torch.int32,), (S, 2 * C))
    if clocks is not None:
        _build.check_tensor("scan_search: clocks", clocks, dev,
                            (torch.int64,), (B, len(CLOCK_PARTS)))
    zeros_f = torch.zeros((B, K), dtype=torch.float32, device=dev)
    zeros_i = torch.zeros((B, K), dtype=torch.int32, device=dev)
    fst = torch.stack([state["p_b"], state["p_nb"], state["lm"],
                       state.get("gc", zeros_f)]).to(torch.float32)
    ist = torch.stack([state[f].to(torch.int32) for f in
                       ("h1", "h2", "last", "last2", "plen")]
                      + [state.get("gs", zeros_i).to(torch.int32)])
    fst, ist = fst.contiguous(), ist.contiguous()
    for name, t, dt in (("float state", fst, torch.float32),
                        ("int state", ist, torch.int32)):
        _build.check_tensor(f"scan_search: {name}", t, dev, (dt,),
                            (t.shape[0], B, K))
    fout, iout = torch.empty_like(fst), torch.empty_like(ist)
    bp = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    fn = _build.lib().tpuasr_scan_beam
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(log_probs), _build.ptr(lengths),
                  _build.ptr(g_pack) if g_pack is not None else None,
                  _build.ptr(lm_table) if lm_order else None,
                  _build.ptr(fst), _build.ptr(ist), _build.ptr(fout),
                  _build.ptr(iout), _build.ptr(bp),
                  _build.ptr(clocks) if clocks is not None else None,
                  S, B, T, C, K, P, blank, max_len, lm_order, float(lm_w),
                  float(g_w), _build.stream_ptr(log_probs))
    scan_search.launches += 1
    _build.check(code, "scan_search")
    final = dict(plen=iout[4], last=iout[2], last2=iout[3], p_b=fout[0],
                 p_nb=fout[1], lm=fout[2], h1=iout[0], h2=iout[1])
    if g_pack is not None:
        final.update(gs=iout[5], gc=fout[3])
    return bp, final


scan_search.launches = 0


def rebuild_prefixes_plain(bp, base, base_len, max_len: int):
    """Plain version of the rebuild: packed backpointers (T, B, K) (int32
    parent * 65536 + char + 1, or int64 parent * 2^32 + char + 1), the
    resumed prefixes base (B, K, max_len) and their lengths base_len (B,
    K) -> prefixes (B, K, max_len) int32 (each lane's chars after its root
    lane's base prefix, those past max_len dropped) and the root lanes at
    frame 0 (B, K) int32. A loop over the frames."""
    T, B, K = bp.shape
    L = max_len
    dev = bp.device
    i64 = torch.int64
    radix = 2 ** 32 if bp.dtype == i64 else 65536
    cur = torch.arange(K, device=dev).expand(B, K)
    chars = torch.empty((T, B, K), dtype=i64, device=dev)
    for t in range(T - 1, -1, -1):
        pk = torch.gather(bp[t].to(i64), 1, cur)
        chars[t] = pk % radix - 1
        cur = pk // radix
    chars = chars.permute(1, 2, 0)                      # (B, K, T)
    base_prefix = torch.gather(base.to(i64), 1,
                               cur[:, :, None].expand(B, K, L))
    base_len = torch.gather(base_len.to(i64), 1, cur)
    keep = chars >= 0
    pos = base_len[:, :, None] + torch.cumsum(keep.to(i64), dim=2) - 1
    pos = torch.where(keep & (pos < L), pos, L)         # slot L = discard
    buf = torch.cat([base_prefix,
                     torch.full((B, K, 1), -1, dtype=i64, device=dev)], 2)
    buf.scatter_(2, pos, torch.where(keep, chars, -1))
    return buf[:, :, :L].to(torch.int32), cur.to(torch.int32)


def rebuild_prefixes(bp, base, base_len, max_len: int):
    """The prefixes of every lane from the scan search's packed
    backpointers (JAX's reverse scan, prefix_beam.py:431-457): bp (T, B,
    K) int32, base (B, K, max_len) and base_len (B, K) -> (prefixes (B, K,
    max_len) int32, root lanes (B, K) int32). CPU tensors take
    ``rebuild_prefixes_plain``; CUDA tensors launch csrc/ctc_beam.cu's
    backtrack kernel once (a thread a lane)."""
    if bp.device.type == "cpu":
        return rebuild_prefixes_plain(bp, base, base_len, max_len)
    if bp.device.type != "cuda":
        raise ValueError(f"rebuild_prefixes: unsupported device {bp.device}")
    T, B, K = bp.shape
    dev = bp.device
    if max_len < 1:
        raise ValueError(f"rebuild_prefixes: max_len {max_len} < 1")
    _build.check_tensor("rebuild_prefixes: bp", bp, dev, (torch.int32,),
                        (T, B, K))
    base = base.to(torch.int32).contiguous()
    base_len = base_len.to(torch.int32).contiguous()
    _build.check_tensor("rebuild_prefixes: base", base, dev, (torch.int32,),
                        (B, K, max_len))
    _build.check_tensor("rebuild_prefixes: base_len", base_len, dev,
                        (torch.int32,), (B, K))
    prefixes = torch.empty((B, K, max_len), dtype=torch.int32, device=dev)
    root = torch.empty((B, K), dtype=torch.int32, device=dev)
    chars = torch.empty((T, B * K), dtype=torch.int32, device=dev)
    fn = _build.lib().tpuasr_ctc_rebuild
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(_build.ptr(bp), _build.ptr(base), _build.ptr(base_len),
                  _build.ptr(chars), _build.ptr(prefixes), _build.ptr(root),
                  T, B, K, max_len, _build.stream_ptr(bp))
    rebuild_prefixes.launches += 1
    _build.check(code, "rebuild_prefixes")
    return prefixes, root


rebuild_prefixes.launches = 0


def ctc_beam_search(log_probs, lengths, cfg: BeamSearchConfig | None = None,
                    n_best: int = 1, init_state: dict | None = None,
                    return_state: bool = False, lm_bigram=None, lm_eos=None,
                    lm_trigram=None, graph=None, lm_weight=None,
                    graph_weight=None, graph_gather_impl: str = "xla"):
    """CTC prefix beam search over a batch.

    Args:
      log_probs: (B, T, C) per-frame log-probs (blank = cfg.blank).
      lengths: (B,) valid frame counts.
      n_best: hypotheses returned per utterance (<= beam_width).
      init_state / return_state: resume from a previous call's state; also
        return the final state under "state".
      lm_bigram: (C+1, C) shallow-fusion table, row = previous class + 1
        (row 0: the empty prefix); lm_trigram: (C+1, C+1, C), exclusive
        with lm_bigram. Beams are pruned and ranked by acoustic +
        lm_weight * LM(prefix).
      lm_eos: (C+1,) ln P(</s> | last), or (C+1, C+1) with trigram context,
        added (weighted) at the final ranking.
      graph: GraphTables (decode/graph.py): a determinized decoding graph
        that constrains the search; its arrays may be numpy or torch (put
        them on the device once for repeated calls).
      lm_weight / graph_weight: overrides of the cfg fields (floats or
        0-d tensors).
      graph_gather_impl: "xla" or "pallas", the JAX package's two names for
        the row fetch; the fetch is inside the scan search here (the
        kernel on a CUDA tensor, a clamped row gather in the plain version
        on a CPU tensor), the same row copy either way.

    On a CUDA tensor: one launch of the scan-search kernel and one of the
    rebuild (limits: beam_width 1-32, C 2-1024, class_topk clipped to C - 1
    and at least 1; past them ValueError); on a CPU tensor their plain
    versions, which take any K, C and P.

    Returns dict with tokens (B, n_best, max_len) int32 padded with -1,
    token_lens (B, n_best) int32, scores / am_scores / lm_scores (B, n_best)
    float32, with a graph graph_scores and reached_final, and the state.
    """
    if cfg is None:
        cfg = BeamSearchConfig()
    if graph_gather_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown graph_gather_impl {graph_gather_impl!r}")
    if lm_bigram is not None and lm_trigram is not None:
        raise ValueError("pass lm_bigram OR lm_trigram, not both")
    B, T, C = log_probs.shape
    K, L = cfg.beam_width, cfg.max_len
    P = min(cfg.class_topk, C - 1)   # blank handled separately
    dev = log_probs.device
    lm_w = cfg.lm_weight if lm_weight is None else lm_weight
    g_w = cfg.graph_weight if graph_weight is None else graph_weight
    lp = log_probs.to(torch.float32).contiguous()
    lens = torch.as_tensor(lengths, device=dev).to(torch.int32).contiguous()

    def f32(x):
        return None if x is None else torch.as_tensor(x, device=dev).to(
            torch.float32)

    tab, order = None, 0
    if lm_trigram is not None:
        tab, order = f32(lm_trigram).reshape((C + 1) ** 2, C), 3
    elif lm_bigram is not None:
        tab, order = f32(lm_bigram), 2
    if tab is not None:
        tab = tab.contiguous()

    init = init_state if init_state is not None else beam_init_state(
        B, cfg, dev)
    if "lm" not in init:
        init = dict(init, lm=torch.zeros((B, K), device=dev))
    if "last2" not in init:
        init = dict(init, last2=torch.full((B, K), -1, dtype=torch.int32,
                                           device=dev))
    g_pack = g_final = None
    if graph is not None:
        g_next = torch.as_tensor(graph.next_state, device=dev).to(torch.int32)
        g_cost = torch.as_tensor(graph.cost, device=dev).to(torch.float32)
        g_final = f32(graph.final)
        # Next states and cost bits in one int32 row: one fetch per beam
        # and frame. The cost rides as int32 bits, never as a float.
        g_pack = torch.cat([g_next, g_cost.view(torch.int32)], 1).contiguous()
        if "gs" not in init:
            init = dict(init,
                        gs=torch.full((B, K), graph.start, dtype=torch.int32,
                                      device=dev),
                        gc=torch.zeros((B, K), device=dev))

    bp, final = scan_search(lp, lens, init, K, P, cfg.blank, L, tab, order,
                            lm_w, g_pack, g_w)
    base = init.get("prefixes")
    if base is None:
        base = torch.full((B, K, L), -1, dtype=torch.int32, device=dev)
    prefixes, _ = rebuild_prefixes(bp, base, init["plen"], L)
    final = dict(prefixes=prefixes, **final)

    out = beam_results(final, n_best, lm_weight=lm_w, lm_eos=lm_eos,
                       graph_final=g_final, graph_weight=g_w,
                       graph_final_cap=cfg.graph_final_cap)
    out["tokens"] = out["tokens"].to(torch.int32)
    out["token_lens"] = out["token_lens"].to(torch.int32)
    if return_state:
        out["state"] = final
    return out
