"""The scan-search kernel's plan and its order of work, on the CPU.

``csrc/scan_beam.cu`` runs the whole frame loop of the scan search
(``decode/prefix_beam.py``) in one launch, a block an utterance and a warp a
beam; ``csrc/ctc_beam.cu``'s backtrack kernel rebuilds the prefixes. Neither
runs here. This file holds:

  * the kernel's limits (``check_scan_beam_shape``): every shape inside
    them taken, a ValueError past each (the card tests hold the kernel's
    own shared-memory figure within the card's 227 KB);
  * an emulation, in numpy and float32, of the kernel's order of work:
    each beam's classes ranked by the 64-bit key (the float's
    order-preserving bits, then the class), the extends scored and joined
    forward against the beam hashes, each beam's top min(K, P) extends as
    its list (ranked by total, then position), the stays' absorption, the
    stays and lists ranked together at flat index K + k*K + slot, the
    packed backpointers, and the rebuild from a resumed prefix. It is held
    to ``scan_search_plain`` and ``rebuild_prefixes_plain``: every integer
    (backpointers, hashes, lengths, graph states, dead lanes included)
    exact, the floats within 1e-4; and the whole search with both
    emulations patched in gives the plain search's results;
  * on CPU tensors ``ctc_beam_search_xla`` launches no kernel, and takes
    classes past 65535 (the plain backpointers widen to int64).
"""

import numpy as np
import pytest
import torch

from tpuasr_torch.decode import (BeamSearchConfig, compile_graph_tables,
                                 compose, ctc_beam_search_xla, lexicon_to_fst,
                                 ngram_to_fst)
from tpuasr_torch.decode import prefix_beam as pbm
from tpuasr_torch.lm import train_ngram
from tpuasr_torch.ops import gather as gather_mod

NEG = np.float32(-1e30)
F = np.float32
M32 = 0xFFFFFFFF

B, T, C = 3, 10, 7
SYMS = ["<blk>", "a", "b", "c", "d", "e", "f"]
SENTS = [["a", "b", "c"], ["c", "a"], ["b", "d", "e", "a"], ["e", "f", "b"],
         ["d", "a", "c", "b"], ["f", "f", "a"]] * 2


# ---- the kernel's limits ---------------------------------------------------

@pytest.mark.parametrize("C_", [2, 3, 7, 31, 32, 33, 64, 65, 100, 256, 257,
                                1000, 1024])
def test_plan_fits_the_card(C_):
    """Every shape inside the limits is taken (the kernel sizes its block
    and shared memory itself; the card test holds that figure)."""
    for K in range(1, 33):
        for P in sorted({1, min(8, C_ - 1), C_ - 1}):
            assert pbm.check_scan_beam_shape(K, C_, P) is None


@pytest.mark.parametrize("K,C_,P,limit", [
    (0, 64, 8, "beam_width"), (33, 64, 8, "beam_width"),
    (8, 1, 1, "classes"), (8, 1025, 8, "classes"),
    (8, 64, 0, "class_topk"), (8, 64, 64, "class_topk"),
    (32, 1024, 1024, "class_topk")])
def test_plan_raises_past_each_limit(K, C_, P, limit):
    with pytest.raises(ValueError, match=limit):
        pbm.check_scan_beam_shape(K, C_, P)


# ---- the emulation of the kernel's order of work ----------------------------

def _lae(a, b):
    a, b = F(a), F(b)
    m = max(a, b)
    d = F(min(a, b) - m)
    if d < -200:
        return F(m + F(0))
    return F(m + F(np.log1p(np.exp(d))))


def _ordered(v):
    u = int(np.array([F(F(v) + F(0))], np.float32).view(np.uint32)[0])
    return (~u & M32) if u & 0x80000000 else (u | 0x80000000)


def _key64(v, c):
    """The kernel's total order of a beam's classes: higher key first."""
    return (_ordered(v) << 32) | (M32 - c)


def _u32(x):
    return int(x) & M32


def _s32(x):
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def emulate_scan(lp, lens, state, K, P, blank, L, tab=None, order=0,
                 lm_w=0.0, g_pack=None, g_w=1.0):
    """csrc/scan_beam.cu's frame loop, lane by lane, in float32."""
    lp = np.asarray(lp, np.float32)
    Bn, Tn, Cn = lp.shape
    lm_w, g_w = F(lm_w), F(g_w)
    graph = g_pack is not None
    S = 0 if g_pack is None else g_pack.shape[0]
    st = {k: np.array(v, copy=True) for k, v in state.items()}
    bp = np.zeros((Tn, Bn, K), np.int32)
    nlist = min(K, P)
    for b in range(Bn):
        f = {n: st[n][b].astype(np.float32).copy()
             for n in ("p_b", "p_nb", "lm", "gc") if n in st}
        if "gc" not in f:
            f["gc"] = np.zeros(K, np.float32)
        i = {n: st[n][b].astype(np.int64).copy()
             for n in ("h1", "h2", "last", "last2", "plen", "gs") if n in st}
        if "gs" not in i:
            i["gs"] = np.zeros(K, np.int64)
        ln = max(0, min(int(lens[b]), Tn))
        for t in range(ln):
            lpt = lp[b, t]
            cv = np.zeros((K, K), np.float32)
            mm = [0] * K
            ent = np.full(K + K * K, np.nan, np.float32)
            lst = {}
            # S1: beam k's classes ranked, its extends scored and joined.
            for k in range(K):
                pb, pnb = f["p_b"][k], f["p_nb"][k]
                lmk, gck = f["lm"][k], f["gc"][k]
                last, last2, plen = (int(i["last"][k]), int(i["last2"][k]),
                                     int(i["plen"][k]))
                if graph:
                    row = g_pack[min(max(int(i["gs"][k]), 0), S - 1)]
                    nx = row[:Cn].astype(np.int64)
                    cs = row[Cn:].astype(np.int32).view(np.float32)
                keys = []
                for c in range(Cn):
                    lpn = NEG if c == blank else lpt[c]
                    s = lpn
                    if graph:
                        s = F(lpn - F(g_w * cs[c])) if nx[c] >= 0 else NEG
                    keys.append(_key64(s, c))
                rank = [sum(kk > keys[c] for kk in keys) for c in range(Cn)]
                ptot = _lae(pb, pnb)
                ext = {}
                for c in range(Cn):
                    if rank[c] >= P:
                        continue
                    lpn = NEG if c == blank else lpt[c]
                    v = F((pb if c == last else ptot) + lpn)
                    if plen >= L:
                        v = NEG
                    gcn, gsn = gck, 0
                    if graph:
                        if nx[c] < 0:
                            v = NEG
                        gcn = F(gck + (F(0) if nx[c] < 0 else cs[c]))
                        gsn = max(int(nx[c]), 0)
                    e1 = _u32(_u32(int(i["h1"][k]) * 2654435761) + c + 1)
                    e2 = _u32(_u32(int(i["h2"][k]) * 40503) + c + 1)
                    hit = False
                    for j in range(K):
                        if (_u32(i["h1"][j]) == e1
                                and _u32(i["h2"][j]) == e2):
                            hit = True
                            cv[j, k] = v
                            mm[j] |= 1 << k
                    pn = NEG if hit else v
                    lme = F(lmk + tab[(last2 + 1) * (Cn + 1) + last + 1
                                      if order == 3 else last + 1, c]) \
                        if order else lmk
                    tt = F(_lae(NEG, pn) + F(lm_w * lme))
                    if graph:
                        tt = F(tt - F(g_w * gcn))
                    ext[rank[c]] = (tt, pn, lme, gcn, gsn, c)
                # The beam's list: its extends by (total desc, position).
                for p, (tt, *payload) in ext.items():
                    q = sum(t2 > tt or (t2 == tt and p2 < p)
                            for p2, (t2, *_) in ext.items())
                    if q < K:
                        ent[K + k * K + q] = tt
                        lst[k * K + q] = (k, *payload)
            # S2: the stays absorb the joined extends.
            stay = {}
            for j in range(K):
                pb, pnb = f["p_b"][j], f["p_nb"][j]
                spb = F(_lae(pb, pnb) + lpt[blank])
                spn = F(pnb + lpt[min(max(int(i["last"][j]), 0), Cn - 1)])
                ks = [k for k in range(K) if (mm[j] >> k) & 1]
                nun = K * P - len(ks)
                cmax = NEG if nun > 0 else F(-np.inf)
                for k in ks:
                    cmax = max(cmax, cv[j, k])
                s = F(0)
                for k in ks:
                    s = F(s + F(np.exp(F(cv[j, k] - cmax))))
                if nun > 0:
                    s = F(s + F(F(nun) * F(np.exp(F(NEG - cmax)))))
                spn = _lae(spn, F(cmax + F(np.log(F(s + F(1e-38))))))
                tt = F(_lae(spb, spn) + F(lm_w * f["lm"][j]))
                if graph:
                    tt = F(tt - F(g_w * f["gc"][j]))
                ent[j] = tt
                stay[j] = (spb, spn)
            # S3: the stays and the lists ranked together; rank s -> lane s.
            nf = {n: v.copy() for n, v in f.items()}
            ni = {n: v.copy() for n, v in i.items()}
            for e in range(K + K * K):
                if e >= K and (e - K) % K >= nlist:
                    continue
                tv = ent[e]
                r = sum(x > tv or (x == tv and e2 < e)
                        for e2, x in enumerate(ent))
                if r >= K:
                    continue
                if e < K:
                    nf["p_b"][r], nf["p_nb"][r] = stay[e]
                    nf["lm"][r], nf["gc"][r] = f["lm"][e], f["gc"][e]
                    for n in ni:
                        ni[n][r] = i[n][e]
                    bp[t, b, r] = e * 65536
                else:
                    k, pn, lme, gcn, gsn, c = lst[e - K]
                    nf["p_b"][r], nf["p_nb"][r] = NEG, pn
                    nf["lm"][r], nf["gc"][r] = lme, gcn
                    ni["h1"][r] = _s32(_u32(i["h1"][k]) * 2654435761 + c + 1)
                    ni["h2"][r] = _s32(_u32(i["h2"][k]) * 40503 + c + 1)
                    ni["last"][r], ni["last2"][r] = c, i["last"][k]
                    ni["plen"][r] = i["plen"][k] + 1
                    ni["gs"][r] = gsn
                    bp[t, b, r] = k * 65536 + c + 1
            f, i = nf, ni
        for t in range(ln, Tn):
            bp[t, b] = np.arange(K) * 65536
        for n, v in list(f.items()) + list(i.items()):
            if n in st:
                st[n][b] = v
    out = {n: torch.tensor(st[n]) for n in st if n != "prefixes"}
    for n in ("h1", "h2", "last", "last2", "plen", "gs"):
        if n in out:
            out[n] = out[n].to(torch.int32)
    return torch.tensor(bp), out


def emulate_rebuild(bp, base, base_len, L):
    """The backtrack kernel in its rebuild mode: a thread a lane."""
    bp, base, base_len = (np.asarray(x) for x in (bp, base, base_len))
    Tn, Bn, K = bp.shape
    out = np.zeros((Bn, K, L), np.int32)
    root = np.zeros((Bn, K), np.int32)
    for b in range(Bn):
        for k in range(K):
            cur, chars = k, [0] * Tn
            for t in range(Tn - 1, -1, -1):
                pk = int(bp[t, b, cur])
                chars[t] = pk % 65536 - 1
                cur = pk // 65536
            out[b, k] = base[b, cur]
            root[b, k] = cur
            pos = int(base_len[b, cur])
            for ch in chars:
                if pos >= L:
                    break
                if ch >= 0:
                    out[b, k, pos] = ch
                    pos += 1
    return torch.tensor(out), torch.tensor(root)


def _logp(seed, scale=1.5, ties=False):
    """Seeded log-probs; with ties, logits of three levels, so that classes,
    extends and candidates tie exactly and every tie rule decides."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * scale
    if ties:
        logits = np.round(logits).clip(-1, 1).astype(np.float32)
    return torch.log_softmax(torch.tensor(logits), -1)


def _graph():
    """The small LG of test_torch_prefix_beam.py, built by the port's own
    graph functions: 8 words of 1-3 classes composed with a word bigram."""
    rng = np.random.default_rng(5)
    prons, seen = [], set()
    while len(prons) < 8:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(1, 4))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons)}", p))
    sents = [[f"w{int(v)}" for v in rng.integers(0, 8,
                                                 size=int(rng.integers(2, 5)))]
             for _ in range(30)]
    lg = compose(lexicon_to_fst(prons),
                 ngram_to_fst(train_ngram(sents, order=2),
                              {w: i + 1 for i, (w, _) in enumerate(prons)}))
    return compile_graph_tables(lg, C, prune=10.0, quantum=0.1)


def _fusion(case):
    lm = train_ngram(SENTS, order=3 if "tri" in case else 2)
    if "tri" in case:
        return dict(lm_trigram=lm.fusion_tensor3(SYMS),
                    lm_eos=lm.eos_matrix(SYMS))
    return dict(lm_bigram=lm.fusion_matrix(SYMS), lm_eos=lm.eos_vector(SYMS))


# case: (K, class_topk, max_len, LM, graph)
CASES = {
    "no_lm": (4, 3, T, None, False),
    "bigram": (4, 3, T, "bigram", False),
    "trigram": (4, 3, T, "trigram", False),
    "eos": (4, 3, T, "eos", False),
    "graph_p2": (4, 2, T, None, True),
    "graph_full": (4, C - 1, T, None, True),
    "graph_bigram_k8_cap": (8, 3, 3, "bigram", True),
    "k1": (1, 2, T, None, False),
    "ties": (4, 3, T, None, False),
    "ties_graph_bigram": (4, C - 1, T, "bigram", True),
}


def _search_args(case, seed):
    K, P, L, lm, graph = CASES[case]
    kw = dict(beam_width=K, class_topk=P, max_len=L,
              lm_weight=0.6 if lm else 0.0, graph_weight=0.8)
    tabs = {}
    if lm:
        tabs = _fusion("trigram" if lm == "trigram" else "bigram")
        if lm in ("bigram", "trigram"):
            tabs.pop("lm_eos")
    tg = _graph() if graph else None
    return (_logp(seed, ties="ties" in case),
            torch.tensor([T, 6, 1], dtype=torch.int32), kw, tabs, tg)


def _kernel_inputs(lp, cfg, tabs, tg, init=None):
    """What ctc_beam_search hands scan_search."""
    K = cfg.beam_width
    state = init if init is not None else pbm.beam_init_state(B, cfg)
    state = dict(state)
    state.setdefault("lm", torch.zeros((B, K)))
    state.setdefault("last2", torch.full((B, K), -1, dtype=torch.int32))
    tab, order = None, 0
    if "lm_trigram" in tabs:
        tab = torch.tensor(tabs["lm_trigram"], dtype=torch.float32).reshape(
            (C + 1) ** 2, C)
        order = 3
    elif "lm_bigram" in tabs:
        tab, order = torch.tensor(tabs["lm_bigram"], dtype=torch.float32), 2
    g_pack = None
    if tg is not None:
        g_pack = torch.cat([torch.as_tensor(tg.next_state).to(torch.int32),
                            torch.as_tensor(tg.cost).to(torch.float32)
                            .view(torch.int32)], 1).contiguous()
        if "gs" not in state:
            state["gs"] = torch.full((B, K), tg.start, dtype=torch.int32)
            state["gc"] = torch.zeros((B, K))
    return state, tab, order, g_pack


def _check_state(got, want):
    assert set(got) == set(want)
    for n in want:
        if want[n].dtype.is_floating_point:
            torch.testing.assert_close(got[n], want[n], rtol=0, atol=1e-4,
                                       msg=n)
        else:
            assert torch.equal(got[n].to(torch.int32),
                               want[n].to(torch.int32)), n


def _emulated_search(lp, lens, cfg, **kw):
    def scan(lp_, lens_, state, K, P, blank, L, tab, order, lm_w, g_pack,
             g_w):
        return emulate_scan(lp_, lens_, {k: v.numpy() for k, v in
                                         state.items()}, K, P, blank, L,
                            None if tab is None else tab.numpy(), order,
                            float(lm_w), None if g_pack is None
                            else g_pack.numpy(), float(g_w))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pbm, "scan_search", scan)
        mp.setattr(pbm, "rebuild_prefixes", emulate_rebuild)
        return ctc_beam_search_xla(lp, lens, cfg, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_search(case):
    lp, lens, kw, tabs, tg = _search_args(case, sum(map(ord, case)))
    cfg = BeamSearchConfig(**kw)
    K, L = cfg.beam_width, cfg.max_len
    P = min(cfg.class_topk, C - 1)
    state, tab, order, g_pack = _kernel_inputs(lp, cfg, tabs, tg)
    args = (K, P, cfg.blank, L, tab, order, cfg.lm_weight, g_pack,
            cfg.graph_weight)
    bp_p, fin_p = pbm.scan_search_plain(lp, lens, state, *args)
    bp_e, fin_e = emulate_scan(
        lp.numpy(), lens.numpy(), {k: v.numpy() for k, v in state.items()},
        K, P, cfg.blank, L, None if tab is None else tab.numpy(), order,
        cfg.lm_weight, None if g_pack is None else g_pack.numpy(),
        cfg.graph_weight)
    assert torch.equal(bp_e, bp_p)
    _check_state(fin_e, fin_p)
    base = torch.full((B, K, L), -1, dtype=torch.int32)
    pre_p, root_p = pbm.rebuild_prefixes_plain(bp_p, base, state["plen"], L)
    pre_e, root_e = emulate_rebuild(bp_p, base, state["plen"], L)
    assert torch.equal(pre_e, pre_p) and torch.equal(root_e, root_p)
    # The whole search with the emulations in place of the two kernels.
    want = ctc_beam_search_xla(lp, lens, cfg, n_best=min(3, K), graph=tg,
                               return_state=True, **tabs)
    got = _emulated_search(lp, lens, cfg, n_best=min(3, K), graph=tg,
                           return_state=True, **tabs)
    for key in ("tokens", "token_lens") + (("reached_final",) if tg
                                           else ()):
        assert torch.equal(got[key], want[key]), key
    for key in ("scores", "am_scores", "lm_scores"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-4)
    _check_state(got["state"], want["state"])


def test_emulation_resumed_graph_bigram():
    """Two chunks with a graph and a bigram, the second resumed from the
    first's state: the backpointers, the state and the rebuilt prefixes
    (after the resumed prefix) of the emulation equal the plain ones."""
    lp, _, kw, tabs, tg = _search_args("graph_bigram_k8_cap", 41)
    kw.update(beam_width=4, max_len=T)
    cfg = BeamSearchConfig(**kw)
    lens = np.array([T, 8, 3], np.int32)
    cut = 4
    len1 = np.minimum(lens, cut)
    len2 = lens - len1
    first = ctc_beam_search_xla(lp[:, :cut], torch.tensor(len1), cfg,
                                graph=tg, return_state=True, **tabs)
    init = first["state"]
    K, L, P = cfg.beam_width, cfg.max_len, cfg.class_topk
    state, tab, order, g_pack = _kernel_inputs(lp, cfg, tabs, tg, init)
    args = (K, P, cfg.blank, L, tab, order, cfg.lm_weight, g_pack,
            cfg.graph_weight)
    lp2 = lp[:, cut:].contiguous()
    bp_p, fin_p = pbm.scan_search_plain(lp2, torch.tensor(len2), state,
                                        *args)
    bp_e, fin_e = emulate_scan(
        lp2.numpy(), len2, {k: v.numpy() for k, v in state.items()}, K, P,
        cfg.blank, L, tab.numpy(), order, cfg.lm_weight, g_pack.numpy(),
        cfg.graph_weight)
    assert torch.equal(bp_e, bp_p)
    _check_state(fin_e, {k: v for k, v in fin_p.items()})
    pre_p, root_p = pbm.rebuild_prefixes_plain(bp_p, init["prefixes"],
                                               init["plen"], L)
    pre_e, root_e = emulate_rebuild(bp_p, init["prefixes"], init["plen"], L)
    assert torch.equal(pre_e, pre_p) and torch.equal(root_e, root_p)
    assert int((pre_p >= 0).sum()) > int((init["prefixes"] >= 0).sum())
    want = ctc_beam_search_xla(lp2, torch.tensor(len2), cfg, n_best=2,
                               graph=tg, init_state=init, return_state=True,
                               **tabs)
    got = _emulated_search(lp2, torch.tensor(len2), cfg, n_best=2, graph=tg,
                           init_state=init, return_state=True, **tabs)
    for key in ("tokens", "token_lens", "reached_final"):
        assert torch.equal(got[key], want[key]), key
    _check_state(got["state"], want["state"])


def test_ranking_key_is_the_stable_sort_order():
    """The 64-bit key (order-preserving bits, then the class) ranks as the
    plain version's stable descending sort: ties to the lower class, -0 and
    +0 equal, NEG_INF last but in class order."""
    vals = [0.5, -0.0, 0.0, -1e30, 0.5, -3.25, -1e30, 7.0]
    keys = [_key64(v, c) for c, v in enumerate(vals)]
    order = sorted(range(len(vals)), key=lambda c: -keys[c])
    want = pbm.topk_indices(torch.tensor([vals]), len(vals))[0].tolist()
    assert order == want


def test_cpu_search_launches_nothing():
    """On CPU tensors ctc_beam_search_xla runs the plain versions: the
    kernels' counters (and K10's gather's) do not move."""
    lp, lens, kw, tabs, tg = _search_args("graph_bigram_k8_cap", 3)
    counters = (pbm.scan_search, pbm.rebuild_prefixes, gather_mod.gather_rows)
    before = [f.launches for f in counters]
    out = ctc_beam_search_xla(lp, lens, BeamSearchConfig(**kw), graph=tg,
                              **tabs)
    assert [f.launches for f in counters] == before
    assert out["tokens"].shape == (B, 1, kw["max_len"])


def test_cpu_search_takes_classes_past_16_bits():
    """The plain search packs its backpointers in int64 past 65535 classes:
    the same log-probs with the six non-blank classes moved to 65534-65539
    (the rest far below) give the same search, classes relabelled."""
    lp, lens, _, _, _ = _search_args("no_lm", 7)
    cfg = BeamSearchConfig(beam_width=4, class_topk=C - 1, max_len=12)
    wide_c = 65540
    moved = torch.arange(C) + (wide_c - C)
    moved[0] = 0
    wide = torch.full((B, T, wide_c), -1e4)
    wide[:, :, moved] = lp
    want = ctc_beam_search_xla(lp, lens, cfg, n_best=2, return_state=True)
    got = ctc_beam_search_xla(wide, lens, cfg, n_best=2, return_state=True)
    relabel = torch.where(want["tokens"] >= 0,
                          moved[want["tokens"].clamp(min=0).long()], -1)
    assert torch.equal(got["tokens"], relabel.to(torch.int32))
    assert torch.equal(got["token_lens"], want["token_lens"])
    assert torch.equal(got["scores"], want["scores"])
    assert torch.equal(got["state"]["plen"], want["state"]["plen"])
