"""Decoding-graph construction + device graph tables (the in-repo analog of
Kaldi's mkgraph: L [lexicon] composed with G [grammar] and compiled for the
decoder).

Counterpart of ``tpuasr/decode/graph.py`` (pure Python and numpy, copied so
that the port loads nothing of the JAX package). It BUILDS the
grammar-bearing graph from the repo's own artifacts (lexicon + ARPA LM);
``compile_graph_tables`` determinizes it into dense ``(S, C)`` next-state /
cost arrays that ``decode.prefix_beam.ctc_beam_search(graph=...)`` gathers
per beam and frame on the device (kernel K10), so the graph constrains the
beam DURING the search instead of post-hoc rescoring. The host first pass
over the composed LG (``--fst-decode`` in the JAX package) is not ported.

Pieces (all tropical semiring, costs = -ln p, lower is better):

  * :func:`ngram_to_fst` — backoff n-gram LM -> word-level WFSA G with
    epsilon backoff arcs (the standard approximate construction: tropical
    min over explicit-vs-backoff paths, exactly like Kaldi's arpa2fst).
  * :func:`compose` — WFST composition with an epsilon-sequencing filter
    (every (path-in-A, path-in-B) pair is represented by EXACTLY one
    composed path, so log-semiring posteriors over the result stay honest).
  * :func:`determinize` — weighted subset determinization over INPUT
    labels (acceptor semantics: output labels are dropped). Homophones
    therefore never block determinization; word recovery happens on the
    host by replaying the winning input string through the ORIGINAL
    transducer (:func:`graph_tokens_to_words`), which picks the min-cost
    parse — the same words the first-pass decoder would output.
  * :class:`GraphTables` / :func:`compile_graph_tables` — the dense device
    representation.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from tpuasr_torch.decode.fst import INF, WFST
from tpuasr_torch.lm.ngram import BOS, EOS, UNK, NGramLM

_BIG = 1e30


# ---------------------------------------------------------------------------
# ARPA backoff LM -> G acceptor
# ---------------------------------------------------------------------------


def ngram_to_fst(lm: NGramLM, sym2label: dict[str, int]) -> WFST:
    """Compile a backoff n-gram LM into a word-level WFSA (G).

    States are LM contexts (suffix-closed); explicit n-grams become
    word arcs of cost ``-ln p``; backoff weights become epsilon arcs to
    the shortened context; ``</s>`` probabilities become final weights.
    Like Kaldi's arpa2fst, the result scores a sentence as the tropical
    MIN over explicit/backoff paths — equal to the LM probability
    whenever the explicit n-gram exists (tested on training sentences).

    Args:
      sym2label: LM word symbol -> FST label id (must be > 0; ids are both
        ilabel and olabel). ``<s>``/``</s>``/``<unk>`` are structural and
        must not appear here.
    Start state is the ``<s>`` context.
    """
    for special in (BOS, EOS, UNK):
        if special in sym2label:
            raise ValueError(f"{special} is structural; remove it from "
                             "sym2label")
    # A state for every context (every ngram key shorter than the max
    # order) plus the empty context.
    contexts = {(): 0}
    for key in lm.ngrams:
        if len(key) < lm.order and key != (EOS,):
            contexts.setdefault(key, len(contexts))
    start_ctx = (BOS,) if (BOS,) in contexts else ()
    fst = WFST(start=contexts[start_ctx])

    def state_of(ctx: tuple) -> int:
        while ctx not in contexts:
            ctx = ctx[1:]
        return contexts[ctx]

    for key, (lp, _bow) in lm.ngrams.items():
        w = key[-1]
        src_ctx = key[:-1]
        if src_ctx not in contexts:
            continue                       # context itself never realizable
        src = contexts[src_ctx]
        if w == EOS:
            fst.set_final(src, -lp)
            continue
        if w == BOS:
            continue                       # context-only symbol
        lab = sym2label.get(w)
        if lab is None:
            continue                       # OOV for this label set (<unk>)
        dst = state_of(key[-(lm.order - 1):] if lm.order > 1 else ())
        fst.add_arc(src, dst, lab, lab, -lp)
    # Backoff epsilon arcs: context h -> h[1:], cost -ln bow. Needed even
    # at bow == 1 (cost 0) so unseen continuations can reach lower orders.
    for ctx, sid in contexts.items():
        if not ctx:
            continue
        bow = lm.ngrams.get(ctx, (0.0, 0.0))[1]
        fst.add_arc(sid, state_of(ctx[1:]), 0, 0, -bow)
    return fst


# ---------------------------------------------------------------------------
# Composition (epsilon-sequencing filter)
# ---------------------------------------------------------------------------


def compose(a: WFST, b: WFST) -> WFST:
    """Compose two WFSTs (tropical): ``a``'s outputs feed ``b``'s inputs.

    Epsilon handling uses a two-state sequencing filter: between two real
    matches, all b-alone moves (b input-epsilon) are taken BEFORE all
    a-alone moves (a output-epsilon). Since a-alone and b-alone moves
    commute, every (path-in-a, path-in-b) pair maps to exactly ONE
    composed path — no duplicated epsilon interleavings, so shortest
    paths AND log-semiring path sums over the result are both correct.
    """
    b_by_il: dict[int, dict[int, list]] = {}
    for s, arcs in b.arcs.items():
        idx: dict[int, list] = defaultdict(list)
        for arc in arcs:
            idx[arc.ilabel].append(arc)
        b_by_il[s] = idx

    out = WFST(start=0)
    states = {(a.start, b.start, 0): 0}
    stack = [(a.start, b.start, 0)]

    def state_id(key) -> int:
        sid = states.get(key)
        if sid is None:
            sid = states[key] = len(states)
            stack.append(key)
        return sid

    while stack:
        key = stack.pop()
        sa, sb, f = key
        src = states[key]
        fa, fb = a.finals.get(sa), b.finals.get(sb)
        if fa is not None and fb is not None:
            out.set_final(src, fa + fb)
        b_idx = b_by_il.get(sb, {})
        for arc_a in a.arcs.get(sa, []):
            if arc_a.olabel == 0:
                if f in (0, 1):            # a-alone: only after b is done
                    out.add_arc(src, state_id((arc_a.dst, sb, 1)),
                                arc_a.ilabel, 0, arc_a.weight)
            else:
                for arc_b in b_idx.get(arc_a.olabel, ()):
                    out.add_arc(src, state_id((arc_a.dst, arc_b.dst, 0)),
                                arc_a.ilabel, arc_b.olabel,
                                arc_a.weight + arc_b.weight)
        if f == 0:                         # b-alone moves stay in filter 0
            for arc_b in b_idx.get(0, ()):
                out.add_arc(src, state_id((sa, arc_b.dst, 0)),
                            0, arc_b.olabel, arc_b.weight)
    return out


# ---------------------------------------------------------------------------
# Weighted acceptor determinization (input labels, tropical)
# ---------------------------------------------------------------------------


def _eps_closure(flat_arcs, items: dict[int, float],
                 num_states: int) -> dict[int, float]:
    """Relax input-epsilon arcs to a fixed point (Bellman-Ford style,
    bounded by the state count — safe under negative backoff costs, which
    are acyclic by construction)."""
    for _ in range(num_states):
        changed = False
        for s in list(items):
            r = items[s]
            for (il, w, dst) in flat_arcs.get(s, ()):
                if il != 0:
                    continue
                nr = r + w
                if nr < items.get(dst, INF) - 1e-12:
                    items[dst] = nr
                    changed = True
        if not changed:
            break
    return items


def determinize(fst: WFST, max_states: int = 200_000,
                prune: float | None = None,
                quantum: float = 1e-9) -> WFST:
    """Weighted subset determinization over INPUT labels (tropical).

    Output labels are DROPPED (olabel := ilabel): the result is a
    deterministic acceptor with no input-epsilon arcs that assigns every
    input string the same min cost as ``fst`` (incl. final weights).
    Raises ``ValueError`` past ``max_states`` (the classic nontermination
    risk of weighted determinization on non-twin machines).

    Non-twin graphs — in ASR practice: L∘G with HOMOPHONES, the exact
    case Kaldi needs disambiguation symbols for — do not determinize
    exactly. Pass ``prune`` (cost units) to determinize WITH PRUNING:
    subset elements more than ``prune`` worse than the subset's best are
    dropped and residuals are keyed on a ``quantum`` grid, so the key
    space is finite and termination is GUARANTEED. The result is exact
    for any string whose best parse stays within ``prune`` of the
    in-subset best at every prefix (a grammar never recovers ~10 nats, so
    prune=10 is safe in practice); residual quantization can additionally
    drift a path's cost by ~quantum per consumed symbol. Use the pruned
    tables to STEER a search and recover exact scores/words by replaying
    the winner through the original graph (graph_tokens_to_words).
    """
    flat: dict[int, list] = {
        s: [(a.ilabel, a.weight, a.dst) for a in arcs]
        for s, arcs in fst.arcs.items()}
    n = fst.num_states

    def norm(items: dict[int, float]):
        wmin = min(items.values())
        if prune is not None:
            items = {s: r for s, r in items.items() if r - wmin <= prune}
        key = tuple(sorted((s, round((r - wmin) / quantum))
                           for s, r in items.items()))
        return wmin, key, {s: r - wmin for s, r in items.items()}

    # The initial subset keeps RAW residuals (no min-shift): a shift here
    # would be a cost shared by every path, and folding it onto the start
    # state's out-arcs double-counts if a cycle revisits the start subset.
    init = _eps_closure(flat, {fst.start: 0.0}, n)
    key0 = tuple(sorted((s, round(r, 9)) for s, r in init.items()))
    out = WFST(start=0)
    subsets = {key0: 0}
    residuals = [dict(init)]
    stack = [0]
    while stack:
        sid = stack.pop()
        items = residuals[sid]
        fw = min((r + fst.finals.get(s, INF) for s, r in items.items()),
                 default=INF)
        if fw < INF:
            out.set_final(sid, fw)
        moves: dict[int, dict[int, float]] = defaultdict(dict)
        for s, r in items.items():
            for (il, w, dst) in flat.get(s, ()):
                if il == 0:
                    continue
                nr = r + w
                cur = moves[il].get(dst)
                if cur is None or nr < cur:
                    moves[il][dst] = nr
        for il, nxt in sorted(moves.items()):
            nxt = _eps_closure(flat, nxt, n)
            wmin, key, items2 = norm(nxt)
            nid = subsets.get(key)
            if nid is None:
                if len(subsets) >= max_states:
                    raise ValueError(
                        f"determinization exceeded {max_states} states "
                        "(non-twin weighted graph?); raise max_states or "
                        "decode this graph on the host first pass")
                nid = subsets[key] = len(subsets)
                residuals.append(items2)
                stack.append(nid)
            out.add_arc(sid, nid, il, il, wmin)
    return out


# ---------------------------------------------------------------------------
# Dense device tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphTables:
    """Dense deterministic-graph tables for the on-device beam search.

    ``next_state[s, c]`` is the state after consuming class ``c`` in state
    ``s`` (-1 = the graph forbids ``c`` here); ``cost[s, c]`` the tropical
    arc cost; ``final[s]`` the final cost (``1e30`` = not final). Class 0
    (CTC blank) is never consumed by the graph.
    """
    next_state: np.ndarray            # (S, C) int32
    cost: np.ndarray                  # (S, C) float32
    final: np.ndarray                 # (S,)  float32
    start: int = 0

    @property
    def num_states(self) -> int:
        return len(self.final)


def compile_graph_tables(fst: WFST, num_classes: int,
                         max_states: int = 200_000,
                         prune: float | None = None,
                         quantum: float = 1e-9) -> GraphTables:
    """Determinize ``fst`` over input labels and flatten to dense arrays.

    Input labels must lie in ``[1, num_classes)`` (CTC class ids; 0 is
    blank/epsilon and never a graph input).

    ``prune``/``quantum``: forward to :func:`determinize`. REQUIRED in
    practice for non-twin graphs — L∘G with homophones — where exact
    weighted determinization does not terminate; a coarse ``quantum``
    (~0.1) is what actually bounds the subset count there (float-noise
    residuals otherwise never collide), at ~quantum/2 cost drift per
    consumed symbol. The tables then STEER the device search; recover
    exact scores/words by replaying winners through ``fst`` itself
    (graph_tokens_to_words).
    """
    det = determinize(fst, max_states=max_states, prune=prune,
                      quantum=quantum)
    S = max([det.start] + list(det.finals)
            + [s for s in det.arcs]
            + [a.dst for arcs in det.arcs.values() for a in arcs]) + 1
    nxt = np.full((S, num_classes), -1, np.int32)
    cost = np.zeros((S, num_classes), np.float32)
    for s, arcs in det.arcs.items():
        for a in arcs:
            if not 0 < a.ilabel < num_classes:
                raise ValueError(f"graph ilabel {a.ilabel} out of range "
                                 f"[1, {num_classes})")
            nxt[s, a.ilabel] = a.dst
            cost[s, a.ilabel] = a.weight
    final = np.full(S, _BIG, np.float32)
    for s, w in det.finals.items():
        final[s] = min(w, _BIG)
    return GraphTables(nxt, cost, final, start=det.start)


def graph_tokens_to_words(fst: WFST, tokens, token_lens,
                          offset: int = -1) -> list[list[int]]:
    """Host replay: map each winning token sequence through the ORIGINAL
    transducer (min-cost parse) to word labels. ``offset`` converts FST
    olabels to external word ids (lexicon_to_fst emits 1-based labels).
    Rows the graph rejects (can't happen for sequences produced under its
    own constraint, but dead/empty beams exist) come back empty."""
    tokens = np.asarray(tokens)
    token_lens = np.asarray(token_lens)
    out = []
    for row, ln in zip(tokens.reshape(-1, tokens.shape[-1]),
                       token_lens.reshape(-1)):
        cost, olabels = fst.score([int(t) for t in row[:int(ln)]])
        out.append([] if math.isinf(cost)
                   else [int(o) + offset for o in olabels])
    return out
