"""First-pass CTC decoding over an arbitrary WFST, on the host: the port's
counterpart of ``tpuasr/decode/fst_decode.py``.

A user arriving with a decoding graph (a Kaldi-built ``TLG.fst``, or any
L / LG / TLG in OpenFst's text or binary format, loaded as a
:class:`tpuasr_torch.decode.fst.WFST`) wants the graph to drive the search,
as Kaldi's latgen did: rescoring an already-pruned n-best cannot recover
hypotheses the graph would have kept. This module is that first pass:

* ``wfst_ctc_decode``: batched Viterbi token passing of CTC log-posteriors
  through the graph (``native/wfst_decode.cc``);
* ``wfst_ctc_decode_nbest`` and ``wfst_ctc_lattice``: the same pass keeping
  every surviving token transition as a lattice link, then exact n-best,
  word confidences from link posteriors and the pruned raw lattice
  (``native/wfst_lattice.cc``); ``write_lattice_text`` writes a lattice as
  a Kaldi-style text archive entry.

The C++ sources are the repository's, compiled as they are at first use
(``tpuasr_torch/native/build.py``). ``impl="native"`` (the default) runs
them and raises if they do not build; ``impl="py"`` runs the pure-Python
mirrors below, the plain versions the tests and chip_smoke hold the native
ones against. There is no quiet fallback from one to the other.

The CTC topology is implicit (EESEN-style token passing): graph ilabels
are CTC class ids (0 = epsilon, never blank), blanks and repeat-collapse
are handled by the decoder itself, so plain L / LG / TLG graphs work
without a T transducer. Weights are tropical costs; ``acoustic_scale``
multiplies the AM term (Kaldi's convention).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from tpuasr_torch.decode.fst import INF, WFST
from tpuasr_torch.native.build import load

__all__ = ["FlatFST", "flatten_fst", "wfst_ctc_decode",
           "wfst_ctc_decode_nbest", "wfst_ctc_lattice", "write_lattice_text"]

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_int, _float = ctypes.c_int, ctypes.c_float


def _load():
    """libwfst_decode (native/wfst_decode.cc), built first if needed."""
    return load("wfst_decode", {"wfst_ctc_decode": (
        [_f32p, _i32p, _int, _int, _int, _int, _int, _int,
         _i32p, _i32p, _i32p, _i32p, _f32p, _f32p,
         _int, _float, _int, _float, _int, _int,
         _i32p, _i32p, _i32p, _f32p, _i32p], None)})


@dataclass
class FlatFST:
    """CSR view of a WFST as consumed by the native decoder."""
    start: int
    arc_off: np.ndarray     # (S+1) int32
    ilabels: np.ndarray     # (A,) int32
    olabels: np.ndarray     # (A,) int32
    dsts: np.ndarray        # (A,) int32
    weights: np.ndarray     # (A,) float32
    finals: np.ndarray      # (S,) float32, 1e30 for non-final

    @property
    def num_states(self) -> int:
        return len(self.finals)


_BIG = np.float32(1e30)


def flatten_fst(fst: WFST) -> FlatFST:
    """Flatten to CSR arrays (cached on the WFST instance)."""
    cached = getattr(fst, "_flat_cache", None)
    if cached is not None:
        return cached
    # CSR is indexed by raw state id: size by max id + 1, not by the count
    # of distinct states (ids need not be contiguous in hand-built graphs).
    S = max([fst.start] + list(fst.finals)
            + [s for s in fst.arcs]
            + [a.dst for arcs in fst.arcs.values() for a in arcs]) + 1
    off = np.zeros(S + 1, np.int32)
    for s, arcs in fst.arcs.items():
        off[s + 1] = len(arcs)
    off = np.cumsum(off, dtype=np.int32)
    A = int(off[-1])
    il = np.zeros(A, np.int32)
    ol = np.zeros(A, np.int32)
    ds = np.zeros(A, np.int32)
    wt = np.zeros(A, np.float32)
    for s, arcs in fst.arcs.items():
        p = int(off[s])
        for i, a in enumerate(arcs):
            il[p + i], ol[p + i] = a.ilabel, a.olabel
            ds[p + i], wt[p + i] = a.dst, a.weight
    fin = np.full(S, _BIG, np.float32)
    for s, w in fst.finals.items():
        fin[s] = min(w, float(_BIG))
    flat = FlatFST(fst.start, off, il, ol, ds, wt, fin)
    fst._flat_cache = flat
    return flat


def wfst_ctc_decode(fst: WFST, log_probs, lengths, *, beam: float = 16.0,
                    max_active: int = 2000, blank: int = 0,
                    acoustic_scale: float = 1.0, max_words: int = 512,
                    num_threads: int = 0, impl: str = "native"):
    """Batched first-pass Viterbi decode of CTC posteriors over ``fst``.

    Args:
      log_probs: (B, T, C) float32 log-softmax AM outputs.
      lengths: (B,) valid frame counts.
      beam: tropical pruning beam (cost units, like Kaldi's --beam).
      max_active: token cap per frame (Kaldi's --max-active).
      acoustic_scale: weight on the AM term vs graph costs.
      num_threads: host threads over the batch (native path; <=0 = all
        hardware threads). Utterances are independent, so results are
        identical at any thread count.
      impl: "native" (native/wfst_decode.cc; a failed build raises) or
        "py" (the pure-Python mirror, the plain version).
    Returns dict:
      words: (B, max_words) int32 output labels (pad -1).
      word_lens: (B,) int32.
      frames: (B, max_words) int32 frame each word was emitted on (-1 for
        words emitted by the initial epsilon closure).
      scores: (B,) float32 = -(best path cost incl. final weight).
      reached_final: (B,) bool — False means the best live token did not
        sit on a final state and the hypothesis is partial (latgen-faster
        semantics).
    """
    log_probs = np.ascontiguousarray(log_probs, np.float32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, T, C = log_probs.shape
    flat = flatten_fst(fst)
    if impl == "native":
        lib = _load()
        words = np.full((B, max_words), -1, np.int32)
        frames = np.full((B, max_words), -1, np.int32)
        lens = np.zeros(B, np.int32)
        scores = np.zeros(B, np.float32)
        final = np.zeros(B, np.int32)
        lib.wfst_ctc_decode(
            log_probs, lengths, B, T, C, flat.num_states, len(flat.ilabels),
            flat.start, flat.arc_off, flat.ilabels, flat.olabels, flat.dsts,
            flat.weights, flat.finals, blank, beam, max_active,
            acoustic_scale, max_words, num_threads, words, frames, lens,
            scores, final)
        return dict(words=words, word_lens=lens, frames=frames,
                    scores=scores, reached_final=final.astype(bool))
    if impl != "py":
        raise ValueError(f"unknown impl {impl!r}")
    outs = [_decode_single_py(flat, log_probs[b, :int(lengths[b])], blank,
                              beam, max_active, acoustic_scale)
            for b in range(B)]
    words = np.full((B, max_words), -1, np.int32)
    frames = np.full((B, max_words), -1, np.int32)
    lens = np.zeros(B, np.int32)
    scores = np.zeros(B, np.float32)
    final = np.zeros(B, bool)
    for b, (w, f, sc, fin) in enumerate(outs):
        n = min(len(w), max_words)
        lens[b] = n
        words[b, :n] = w[:n]
        frames[b, :n] = f[:n]
        scores[b] = sc
        final[b] = fin
    return dict(words=words, word_lens=lens, frames=frames, scores=scores,
                reached_final=final)


def _decode_single_py(flat: FlatFST, lp: np.ndarray, blank: int, beam: float,
                      max_active: int, asc: float):
    """Pure-Python mirror of native/wfst_decode.cc (the plain version).

    Tokens are dicts (state, last_symbol) -> (cost, trace); the trace is a
    tuple-chain ((words...), (frames...)) — fine at oracle scale.
    """
    import heapq

    off, il, ol, ds, wt = (flat.arc_off, flat.ilabels, flat.olabels,
                           flat.dsts, flat.weights)
    C = lp.shape[1] if lp.ndim == 2 else 0

    def closure(toks, frame):
        pq = [(c, k) for k, (c, _) in toks.items()]
        heapq.heapify(pq)
        while pq:
            c, k = heapq.heappop(pq)
            cur = toks.get(k)
            if cur is None or cur[0] < c:
                continue
            s, u = k
            tr = cur[1]
            for a in range(int(off[s]), int(off[s + 1])):
                if il[a] != 0:
                    continue
                nc = c + float(wt[a])
                nk = (int(ds[a]), u)
                if nk in toks and toks[nk][0] <= nc:
                    continue
                ntr = tr if ol[a] == 0 else (tr + ((int(ol[a]), frame),))
                toks[nk] = (nc, ntr)
                heapq.heappush(pq, (nc, nk))

    def pruned(toks):
        if not toks:
            return toks
        best = min(c for c, _ in toks.values())
        cut = best + beam
        kept = {k: v for k, v in toks.items() if v[0] <= cut}
        if max_active > 0 and len(kept) > max_active:
            costs = sorted(c for c, _ in kept.values())
            cut = min(cut, costs[max_active - 1])
            kept = {k: v for k, v in kept.items() if v[0] <= cut}
        return kept

    toks = {(flat.start, blank): (0.0, ())}
    closure(toks, -1)
    T = lp.shape[0]
    for t in range(T):
        p = lp[t]
        nxt: dict = {}

        def relax(k, c, tr, nxt=nxt):
            if k not in nxt or c < nxt[k][0]:
                nxt[k] = (c, tr)

        for (s, u), (c, tr) in toks.items():
            relax((s, blank), c - asc * float(p[blank]), tr)
            if u != blank:
                relax((s, u), c - asc * float(p[u]), tr)
            for a in range(int(off[s]), int(off[s + 1])):
                k = int(il[a])
                if k == 0 or k == u or k >= C:
                    continue
                nc = c + float(wt[a]) - asc * float(p[k])
                ntr = tr if ol[a] == 0 else (tr + ((int(ol[a]), t),))
                relax((int(ds[a]), k), nc, ntr)
        toks = nxt
        closure(toks, t)
        toks = pruned(toks)

    best_f = best_any = float(INF)
    tr_f = tr_any = ()
    for (s, _), (c, tr) in toks.items():
        if c < best_any:
            best_any, tr_any = c, tr
        fw = float(flat.finals[s])
        if fw < float(_BIG) and c + fw < best_f:
            best_f, tr_f = c + fw, tr
    fin = best_f < float(_BIG)
    tr = tr_f if fin else tr_any
    score = -(best_f if fin else best_any) if (fin or best_any < INF) \
        else -float(_BIG)
    words = [w for w, _ in tr]
    frames = [f for _, f in tr]
    return words, frames, float(score), fin


# ---------------------------------------------------------------------------
# Lattice-generating decode (native/wfst_lattice.cc): n-best + posteriors.
# The reference's decoder was Kaldi's *lattice*-faster decoder; this is the
# rebuild's lattice surface — exact n-best over a lattice-beam-pruned link
# graph, link posteriors for confidence, and a raw (frame-level) lattice
# dump for Kaldi-style text export. Python mirror below is the test oracle.
# ---------------------------------------------------------------------------


def _load_lattice():
    """libwfst_lattice (native/wfst_lattice.cc), built first if needed."""
    return load("wfst_lattice", {
        "wfst_ctc_decode_nbest": (
            [_f32p, _i32p, _int, _int, _int, _int, _int, _int,
             _i32p, _i32p, _i32p, _i32p, _f32p, _f32p,
             _int, _float, _int, _float, _float, _int, _int, _int,
             _i32p, _i32p, _f32p, _i32p, _f32p, _i32p, _i32p], None),
        "wfst_ctc_lattice": (
            [_f32p, _int, _int, _int, _int, _int,
             _i32p, _i32p, _i32p, _i32p, _f32p, _f32p,
             _int, _float, _int, _float, _float, _int, _int,
             _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _f32p, _f32p, _f32p,
             _i32p, _f32p, _i32p], ctypes.c_int32)})


def wfst_ctc_decode_nbest(fst: WFST, log_probs, lengths, *,
                          beam: float = 16.0, max_active: int = 2000,
                          lat_beam: float = 8.0, nbest: int = 10,
                          blank: int = 0, acoustic_scale: float = 1.0,
                          max_words: int = 512, num_threads: int = 0,
                          impl: str = "native"):
    """Batched lattice decode of CTC posteriors: exact n-best + confidence.

    Same first pass as :func:`wfst_ctc_decode`, but every surviving token
    transition is kept as a lattice link; links within ``lat_beam`` of the
    best complete path survive pruning (Kaldi ``--lattice-beam``
    semantics); n-best word sequences are extracted EXACTLY (A* with the
    Viterbi completion cost as heuristic, duplicate word strings merged)
    and each best-hypothesis word carries its lattice link posterior.

    Returns dict:
      words: (B, nbest, max_words) int32 (pad -1); frames: same shape.
      word_lens: (B, nbest) int32; scores: (B, nbest) float32 (pad ~-1e30).
      nhyp: (B,) int32 hypotheses found (<= nbest).
      confidences: (B, max_words) float32 — posterior of each word of
        hypothesis 0 (1.0 = the lattice is certain of this word).
      reached_final: (B,) bool, as in wfst_ctc_decode.
    """
    log_probs = np.ascontiguousarray(log_probs, np.float32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, T, C = log_probs.shape
    flat = flatten_fst(fst)
    if impl == "native":
        lib = _load_lattice()
        words = np.full((B, nbest, max_words), -1, np.int32)
        frames = np.full((B, nbest, max_words), -1, np.int32)
        conf = np.zeros((B, max_words), np.float32)
        lens = np.zeros((B, nbest), np.int32)
        scores = np.zeros((B, nbest), np.float32)
        nhyp = np.zeros(B, np.int32)
        final = np.zeros(B, np.int32)
        lib.wfst_ctc_decode_nbest(
            log_probs, lengths, B, T, C, flat.num_states, len(flat.ilabels),
            flat.start, flat.arc_off, flat.ilabels, flat.olabels, flat.dsts,
            flat.weights, flat.finals, blank, beam, max_active, lat_beam,
            acoustic_scale, nbest, max_words, num_threads,
            words.reshape(-1), frames.reshape(-1), conf.reshape(-1),
            lens.reshape(-1), scores.reshape(-1), nhyp, final)
        return dict(words=words, frames=frames, word_lens=lens,
                    scores=scores, nhyp=nhyp, confidences=conf,
                    reached_final=final.astype(bool))
    if impl != "py":
        raise ValueError(f"unknown impl {impl!r}")
    words = np.full((B, nbest, max_words), -1, np.int32)
    frames = np.full((B, nbest, max_words), -1, np.int32)
    conf = np.zeros((B, max_words), np.float32)
    lens = np.zeros((B, nbest), np.int32)
    scores = np.full((B, nbest), -float(_BIG), np.float32)
    nhyp = np.zeros(B, np.int32)
    final = np.zeros(B, bool)
    for b in range(B):
        dl = _build_lattice_py(flat, log_probs[b, :int(lengths[b])], blank,
                               beam, max_active, lat_beam, acoustic_scale)
        _finish_lattice_py(dl, lat_beam)
        hyps = _nbest_py(dl, nbest, max(10000, nbest * 200))
        final[b] = dl["reached_final"]
        nhyp[b] = len(hyps)
        for i, (ws, fs, g) in enumerate(hyps):
            n = min(len(ws), max_words)
            words[b, i, :n] = ws[:n]
            frames[b, i, :n] = fs[:n]
            lens[b, i] = n
            scores[b, i] = -g
            if i == 0 and n > 0:
                conf[b, :n] = _word_conf_py(dl, ws[:n], fs[:n],
                                            int(lengths[b]))
    return dict(words=words, frames=frames, word_lens=lens, scores=scores,
                nhyp=nhyp, confidences=conf, reached_final=final)


def wfst_ctc_lattice(fst: WFST, log_probs, *, beam: float = 16.0,
                     max_active: int = 2000, lat_beam: float = 8.0,
                     blank: int = 0, acoustic_scale: float = 1.0,
                     impl: str = "native"):
    """Pruned raw (frame-level) lattice for ONE utterance.

    Returns dict with ``node_frame``/``node_state`` (N,), ``links`` as a
    structured view: ``src dst word frame graph_w ac_w post`` arrays (L,),
    plus ``best_cost`` and ``reached_final``. Node 0 is the unique source;
    the node with state -1 is the unique sink. Feed to
    :func:`write_lattice_text` for Kaldi-style text output.
    """
    lp = np.ascontiguousarray(log_probs, np.float32)
    if lp.ndim != 2:
        raise ValueError(f"one utterance: (T, C), got shape {lp.shape}")
    T, C = lp.shape
    flat = flatten_fst(fst)
    if impl == "native":
        lib = _load_lattice()
        cap_n, cap_l = 4096, 65536
        while True:
            node_frame = np.zeros(cap_n, np.int32)
            node_state = np.zeros(cap_n, np.int32)
            src = np.zeros(cap_l, np.int32)
            dst = np.zeros(cap_l, np.int32)
            word = np.zeros(cap_l, np.int32)
            frame = np.zeros(cap_l, np.int32)
            gw = np.zeros(cap_l, np.float32)
            aw = np.zeros(cap_l, np.float32)
            post = np.zeros(cap_l, np.float32)
            counts = np.zeros(2, np.int32)
            best = np.zeros(1, np.float32)
            fin = np.zeros(1, np.int32)
            rc = lib.wfst_ctc_lattice(
                lp, T, C, flat.num_states, len(flat.ilabels), flat.start,
                flat.arc_off, flat.ilabels, flat.olabels, flat.dsts,
                flat.weights, flat.finals, blank, beam, max_active,
                lat_beam, acoustic_scale, cap_n, cap_l, node_frame,
                node_state, src, dst, word, frame, gw, aw, post, counts,
                best, fin)
            if rc == 0:
                n, L = int(counts[0]), int(counts[1])
                return dict(node_frame=node_frame[:n],
                            node_state=node_state[:n], src=src[:L],
                            dst=dst[:L], word=word[:L], frame=frame[:L],
                            graph_w=gw[:L], ac_w=aw[:L], post=post[:L],
                            best_cost=float(best[0]),
                            reached_final=bool(fin[0]))
            cap_n = max(cap_n * 2, int(counts[0]) + 1)
            cap_l = max(cap_l * 2, int(counts[1]) + 1)
    if impl != "py":
        raise ValueError(f"unknown impl {impl!r}")
    dl = _build_lattice_py(flat, lp, blank, beam, max_active, lat_beam,
                           acoustic_scale)
    _finish_lattice_py(dl, lat_beam)
    nodes, links, kept, post = (dl["nodes"], dl["links"], dl["kept"],
                                dl["post"])
    remap = {0: 0}
    for li in kept:
        for n in (links[li][0], links[li][1]):
            if n not in remap:
                remap[n] = len(remap)
    if dl["sink"] not in remap:
        remap[dl["sink"]] = len(remap)
    N = len(remap)
    node_frame = np.zeros(N, np.int32)
    node_state = np.zeros(N, np.int32)
    for old, new in remap.items():
        node_frame[new] = nodes[old][2]
        node_state[new] = nodes[old][1]
    L = len(kept)
    out = dict(node_frame=node_frame, node_state=node_state,
               src=np.zeros(L, np.int32), dst=np.zeros(L, np.int32),
               word=np.zeros(L, np.int32), frame=np.zeros(L, np.int32),
               graph_w=np.zeros(L, np.float32),
               ac_w=np.zeros(L, np.float32), post=np.zeros(L, np.float32),
               best_cost=dl["best_cost"],
               reached_final=dl["reached_final"])
    for j, li in enumerate(kept):
        s, d, w, f, g, a = links[li]
        out["src"][j], out["dst"][j], out["word"][j] = (remap[s], remap[d],
                                                        w)
        out["frame"][j], out["graph_w"][j], out["ac_w"][j] = f, g, a
        out["post"][j] = post[j]
    return out


def write_lattice_text(fh, utt_id: str, lat: dict, words=None) -> None:
    """Serialize a :func:`wfst_ctc_lattice` result as a Kaldi-style text
    lattice entry: ``utt_id`` header, ``src dst word graph,acoustic`` arc
    lines (word as symbol when a :class:`SymbolTable`-like ``words`` is
    given, else the integer id), one ``state cost`` final line for the
    sink, blank-line terminated — readable by Kaldi's lattice-copy on raw
    Lattice text archives (modulo the absent ilabel alignment field,
    which Kaldi permits to be empty)."""
    fh.write(f"{utt_id}\n")
    sink = int(np.nonzero(lat["node_state"] == -1)[0][0])
    for j in range(len(lat["src"])):
        s, d = int(lat["src"][j]), int(lat["dst"][j])
        w = int(lat["word"][j])
        if d == sink:
            # final links fold into the final-cost line of their source
            continue
        name = words.sym(w) if (words is not None and w) else str(w)
        fh.write(f"{s} {d} {name} {lat['graph_w'][j]:.6g},"
                 f"{lat['ac_w'][j]:.6g},\n")
    for j in range(len(lat["src"])):
        if int(lat["dst"][j]) == sink:
            fh.write(f"{int(lat['src'][j])} "
                     f"{lat['graph_w'][j] + lat['ac_w'][j]:.6g}\n")
    fh.write("\n")


# ---- pure-Python mirror of native/wfst_lattice.cc (the plain version) ----


def _build_lattice_py(flat: FlatFST, lp, blank, beam, max_active, lat_beam,
                      asc):
    import heapq

    off, il, ol, ds, wt = (flat.arc_off, flat.ilabels, flat.olabels,
                           flat.dsts, flat.weights)
    T = lp.shape[0]
    C = lp.shape[1] if lp.ndim == 2 else 0
    nodes = []  # [alpha, state, frame, expanded]
    links = []  # (src, dst, word, frame, graph_w, ac_w)

    def add_node(alpha, state, frame):
        nodes.append([alpha, state, frame, False])
        return len(nodes) - 1

    def relax(frontier, key, state, cost, src, word, gw, aw, frame):
        nid = frontier.get(key)
        if nid is None:
            nid = add_node(cost, state, frame)
            links.append((src, nid, word, frame, gw, aw))
            frontier[key] = nid
            return nid
        n = nodes[nid]
        if cost < n[0]:
            if n[3]:  # expanded: fork (negative-eps improvement)
                nid2 = add_node(cost, state, frame)
                links.append((src, nid2, word, frame, gw, aw))
                frontier[key] = nid2
                return nid2
            n[0] = cost
            links.append((src, nid, word, frame, gw, aw))
            return nid
        if cost <= n[0] + lat_beam:
            links.append((src, nid, word, frame, gw, aw))
        return nid

    def closure(frontier, frame):
        pq = [(nodes[nid][0], k) for k, nid in frontier.items()]
        heapq.heapify(pq)
        while pq:
            c, k = heapq.heappop(pq)
            nid = frontier.get(k)
            if nid is None or nodes[nid][0] < c:
                continue
            nodes[nid][3] = True
            s, u = k
            for a in range(int(off[s]), int(off[s + 1])):
                if il[a] != 0:
                    continue
                nc = c + float(wt[a])
                nk = (int(ds[a]), u)
                prev = frontier.get(nk)
                improves = prev is None or nc < nodes[prev][0]
                relax(frontier, nk, int(ds[a]), nc, nid, int(ol[a]),
                      float(wt[a]), 0.0, frame)
                if improves:
                    heapq.heappush(pq, (nc, nk))

    def pruned(frontier):
        if not frontier:
            return frontier
        best = min(nodes[nid][0] for nid in frontier.values())
        cut = best + beam
        kept = {k: nid for k, nid in frontier.items()
                if nodes[nid][0] <= cut}
        if max_active > 0 and len(kept) > max_active:
            costs = sorted(nodes[nid][0] for nid in kept.values())
            cut = min(cut, costs[max_active - 1])
            kept = {k: nid for k, nid in kept.items()
                    if nodes[nid][0] <= cut}
        return kept

    frontier = {(flat.start, blank): add_node(0.0, flat.start, -1)}
    closure(frontier, -1)
    for t in range(T):
        p = lp[t]
        nxt: dict = {}
        for (s, u), nid in frontier.items():
            c = nodes[nid][0]
            nodes[nid][3] = True
            bl = -asc * float(p[blank])
            relax(nxt, (s, blank), s, c + bl, nid, 0, 0.0, bl, t)
            if u != blank:
                st = -asc * float(p[u])
                relax(nxt, (s, u), s, c + st, nid, 0, 0.0, st, t)
            for a in range(int(off[s]), int(off[s + 1])):
                k = int(il[a])
                if k == 0 or k == u or k >= C:
                    continue
                aw = -asc * float(p[k])
                relax(nxt, (int(ds[a]), k), int(ds[a]),
                      c + float(wt[a]) + aw, nid, int(ol[a]), float(wt[a]),
                      aw, t)
        frontier = nxt
        closure(frontier, t)
        frontier = pruned(frontier)

    best_f = float(INF)
    for (s, _), nid in frontier.items():
        fw = float(flat.finals[s])
        if fw < float(_BIG):
            best_f = min(best_f, nodes[nid][0] + fw)
    reached = best_f < float(_BIG)
    sink = add_node(float(_BIG), -1, T)
    for (s, _), nid in frontier.items():
        fw = float(flat.finals[s])
        if reached:
            if fw < float(_BIG):
                links.append((nid, sink, 0, T, fw, 0.0))
        else:
            links.append((nid, sink, 0, T, 0.0, 0.0))
    return dict(nodes=nodes, links=links, sink=sink, reached_final=reached)


def _finish_lattice_py(dl: dict, lat_beam: float) -> None:
    nodes, links, sink = dl["nodes"], dl["links"], dl["sink"]
    N = len(nodes)
    indeg = [0] * N
    out: list[list[int]] = [[] for _ in range(N)]
    for i, (s, d, *_rest) in enumerate(links):
        indeg[d] += 1
        out[s].append(i)
    order, stack = [], [n for n in range(N) if indeg[n] == 0]
    while stack:
        n = stack.pop()
        order.append(n)
        for li in out[n]:
            d = links[li][1]
            indeg[d] -= 1
            if indeg[d] == 0:
                stack.append(d)
    assert len(order) == N, "lattice must be a DAG"
    beta_v = [float(_BIG)] * N
    beta_v[sink] = 0.0
    for n in reversed(order):
        for li in out[n]:
            _s, d, _w, _f, gw, aw = links[li]
            beta_v[n] = min(beta_v[n], gw + aw + beta_v[d])
    best = beta_v[0]
    cutoff = best + lat_beam if best < float(_BIG) else float(_BIG)
    kept = [i for i, (s, d, _w, _f, gw, aw) in enumerate(links)
            if nodes[s][0] + gw + aw + beta_v[d] <= cutoff]
    alpha_l = [-float(_BIG)] * N
    beta_l = [-float(_BIG)] * N
    alpha_l[0], beta_l[sink] = 0.0, 0.0
    kin: list[list[int]] = [[] for _ in range(N)]
    kout: list[list[int]] = [[] for _ in range(N)]
    for li in kept:
        kout[links[li][0]].append(li)
        kin[links[li][1]].append(li)
    for n in order:
        for li in kin[n]:
            s, _d, _w, _f, gw, aw = links[li]
            alpha_l[n] = np.logaddexp(alpha_l[n], alpha_l[s] - gw - aw)
    for n in reversed(order):
        for li in kout[n]:
            _s, d, _w, _f, gw, aw = links[li]
            beta_l[n] = np.logaddexp(beta_l[n], beta_l[d] - gw - aw)
    total = alpha_l[sink]
    post = []
    for li in kept:
        s, d, _w, _f, gw, aw = links[li]
        post.append(float(np.exp(min(alpha_l[s] - gw - aw + beta_l[d]
                                     - total, 0.0))))
    dl.update(beta_v=beta_v, kept=kept, post=post, best_cost=best)


def _word_conf_py(dl: dict, ws, fs, T: int) -> np.ndarray:
    """Time-anchored word posteriors (mirror of the native computation):
    the confidence of best-path word i is the posterior mass of all kept
    same-word links inside its time window (midpoints between adjacent
    best-path word frames)."""
    n = len(ws)
    lo = [-2.0] + [0.5 * (fs[i] + fs[i + 1]) for i in range(n - 1)]
    hi = [0.5 * (fs[i] + fs[i + 1]) for i in range(n - 1)] + [T + 1.0]
    conf = np.zeros(n, np.float32)
    links = dl["links"]
    for j, li in enumerate(dl["kept"]):
        _s, _d, w, f, _gw, _aw = links[li]
        if w == 0:
            continue
        for i in range(n):
            if w == ws[i] and lo[i] < f <= hi[i]:
                conf[i] += dl["post"][j]
                break
    return np.minimum(conf, 1.0)


def _nbest_py(dl: dict, nbest: int, pop_budget: int):
    """A* n-best over the pruned lattice. Returns
    [(words, frames, cost)] best-first, unique word sequences."""
    import heapq

    nodes, links, sink = dl["nodes"], dl["links"], dl["sink"]
    beta_v, kept = dl["beta_v"], dl["kept"]
    kout: list[list[int]] = [[] for _ in range(len(nodes))]
    for li in kept:
        kout[links[li][0]].append(li)
    arena = [(-1, -1)]  # (parent, link)
    pq = []
    ctr = 0
    if beta_v[0] < float(_BIG):
        heapq.heappush(pq, (beta_v[0], ctr, 0, 0.0))
    seen, hyps, pops = set(), [], 0
    while pq and len(hyps) < nbest and pops < pop_budget:
        _f, _c, pi, g = heapq.heappop(pq)
        pops += 1
        node = links[arena[pi][1]][1] if arena[pi][1] >= 0 else 0
        if node == sink:
            ws, fs = [], []
            i = pi
            while arena[i][1] >= 0:
                li = arena[i][1]
                if links[li][2] != 0:
                    ws.append(links[li][2])
                    fs.append(links[li][3])
                i = arena[i][0]
            ws.reverse()
            fs.reverse()
            key = tuple(ws)
            if key not in seen:
                seen.add(key)
                hyps.append((ws, fs, g))
            continue
        for li in kout[node]:
            _s, d, _w, _fr, gw, aw = links[li]
            ng = g + gw + aw
            nf = ng + beta_v[d]
            if nf >= float(_BIG):
                continue
            arena.append((pi, li))
            ctr += 1
            heapq.heappush(pq, (nf, ctr, len(arena) - 1, ng))
    return hyps
