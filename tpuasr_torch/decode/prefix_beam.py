"""Batched CTC prefix beam search with top-P class pruning, shallow LM
fusion and graph-constrained decoding, as torch ops.

Counterpart of ``tpuasr/decode/prefix_beam.py`` (an XLA ``lax.scan`` there,
a Python loop over frames here). Per frame and utterance:

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

With a graph, each beam carries its graph state; the per-frame fetch of
one packed (next states | cost bits) row of the (S, 2C) int32 graph table
per beam is ``ops.gather.gather_rows`` (kernel K10 on a CUDA tensor). The
scan emits (parent, char) backpointers and one reverse pass rebuilds the
prefixes, which lets a call resume from another's state (``init_state`` /
``return_state``).

Hashes are uint32 in the JAX package; torch has no uint32 arithmetic, so
they are kept as the same bit patterns in int32 and computed in int64
wrapped to 32 bits (``_wrap32``): equal hashes stay equal.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuasr_torch.ops.gather import gather_rows

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
        the row fetch; both run ``gather_rows`` here (K10 on a CUDA tensor,
        the plain gather on a CPU tensor), the same clamped row copy.

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
    blank = cfg.blank
    dev = log_probs.device
    lm_w = cfg.lm_weight if lm_weight is None else lm_weight
    g_w = cfg.graph_weight if graph_weight is None else graph_weight
    lp_all = log_probs.to(torch.float32)
    lens = torch.as_tensor(lengths, device=dev).to(torch.int64)

    def f32(x):
        return None if x is None else torch.as_tensor(x, device=dev).to(
            torch.float32)

    lm_bigram, lm_trigram = f32(lm_bigram), f32(lm_trigram)
    have_lm = lm_bigram is not None or lm_trigram is not None

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

    i64 = torch.int64
    p_b, p_nb = init["p_b"].to(torch.float32), init["p_nb"].to(torch.float32)
    lm = init["lm"].to(torch.float32)
    last, last2 = init["last"].to(i64), init["last2"].to(i64)
    plen = init["plen"].to(i64)
    h1, h2 = init["h1"].to(i64), init["h2"].to(i64)
    if graph is not None:
        gs, gc = init["gs"].to(i64), init["gc"].to(torch.float32)
    k_iota = torch.arange(K, device=dev).expand(B, K)
    parent = torch.cat([torch.arange(K, device=dev),
                        torch.arange(K, device=dev).repeat_interleave(P)])
    neg_kp = torch.full((B, K * P), NEG_INF, device=dev)
    no_char = torch.full((B, K), -1, dtype=i64, device=dev)
    m1, m2 = _s32(_H1_MUL), _H2_MUL
    par_seq = torch.empty((T, B, K), dtype=i64, device=dev)
    chr_seq = torch.empty((T, B, K), dtype=i64, device=dev)

    for t in range(T):
        lp_t = lp_all[:, t]                             # (B, C)
        lp_blank = lp_t[:, blank]
        lp_nb_all = lp_t.clone()
        lp_nb_all[:, blank] = NEG_INF
        p_tot = logaddexp(p_b, p_nb)                    # (B, K)

        # Class selection: top-P per step, per beam and graph-aware with a
        # graph (forbidden classes masked before the sort).
        if graph is not None:
            rows = gather_rows(g_pack, gs)              # (B, K, 2C) int32
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
        if graph is not None:
            ext_gs = torch.gather(nxt_rows, 2, top_c).to(i64)
            g_step = torch.gather(cost_rows, 2, top_c)
            ext_p_nb = torch.where(ext_gs < 0, NEG_INF, ext_p_nb)
            ext_gc = gc[:, :, None] + torch.where(ext_gs < 0, 0.0, g_step)
            ext_gs = ext_gs.clamp(min=0)
        cu = top_c + 1
        ext_h1 = _wrap32(_wrap32(h1[:, :, None] * m1) + cu)
        ext_h2 = _wrap32(_wrap32(h2[:, :, None] * m2) + cu)
        if have_lm:
            # ln P(c | context) per extension; index 0 = "no token there".
            lm_rows = (lm_trigram[last2 + 1, last + 1]
                       if lm_trigram is not None
                       else lm_bigram[last + 1])        # (B, K, C)
            ext_lm = lm[:, :, None] + torch.gather(lm_rows, 2, top_c)
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
        if graph is not None:
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
        if graph is not None:
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
        if graph is not None:
            gs = torch.where(live, new["gs"], gs)
            gc = torch.where(live, new["gc"], gc)
        # Frozen rows emit identity backpointers (own lane, no char).
        par_seq[t] = torch.where(live, sel_parent, k_iota)
        chr_seq[t] = torch.where(live, sel_char, -1)

    # ---- prefix reconstruction: one reverse pass over the backpointers,
    # then prepend each beam's resumed prefix (the chain bottoms out at an
    # init-state beam). ----
    cur = k_iota
    chars = torch.empty((T, B, K), dtype=i64, device=dev)
    for t in range(T - 1, -1, -1):
        chars[t] = torch.gather(chr_seq[t], 1, cur)
        cur = torch.gather(par_seq[t], 1, cur)
    chars = chars.permute(1, 2, 0)                      # (B, K, T)
    base_prefix = init.get("prefixes")
    if base_prefix is None:
        base_prefix = torch.full((B, K, L), -1, dtype=torch.int32, device=dev)
    base_prefix = torch.gather(base_prefix.to(i64), 1,
                               cur[:, :, None].expand(B, K, L))
    base_len = torch.gather(init["plen"].to(i64), 1, cur)
    keep = chars >= 0
    pos = base_len[:, :, None] + torch.cumsum(keep.to(i64), dim=2) - 1
    pos = torch.where(keep & (pos < L), pos, L)         # slot L = discard
    buf = torch.cat([base_prefix,
                     torch.full((B, K, 1), -1, dtype=i64, device=dev)], 2)
    buf.scatter_(2, pos, torch.where(keep, chars, -1))
    i32 = torch.int32
    final = dict(prefixes=buf[:, :, :L].to(i32), plen=plen.to(i32),
                 last=last.to(i32), last2=last2.to(i32), p_b=p_b, p_nb=p_nb,
                 lm=lm, h1=h1.to(i32), h2=h2.to(i32))
    if graph is not None:
        final.update(gs=gs.to(i32), gc=gc)

    out = beam_results(final, n_best, lm_weight=lm_w, lm_eos=lm_eos,
                       graph_final=g_final, graph_weight=g_w,
                       graph_final_cap=cfg.graph_final_cap)
    out["tokens"] = out["tokens"].to(i32)
    out["token_lens"] = out["token_lens"].to(i32)
    if return_state:
        out["state"] = final
    return out
