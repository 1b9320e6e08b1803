"""Backoff n-gram language model: ARPA read/write, Witten-Bell training,
sequence scoring, n-best rescoring, and bigram shallow-fusion tables for the
on-device beam search.

Counterpart of ``tpuasr/lm/ngram.py`` (pure Python and numpy, copied so
that the port loads nothing of the JAX package). It supplies the "G"
(grammar) of the TLG decode path (Kaldi latgen walks TLG.fst = phone
topology o lexicon o grammar); the phone topology lives in the CTC beam
search and the lexicon on the host (decode/lexicon.py). The grammar scores
come two ways:

  * on-device shallow fusion — ``fusion_matrix()`` bakes the LM down to a
    dense (C+1, C) bigram log-prob table that ``ctc_beam_search`` applies
    per extension during the search (fixed-shape gather, jit-safe);
  * host-side n-best rescoring — ``rescore_nbest()`` re-ranks the beam
    search's hypotheses with full n-gram context (the analog of Kaldi
    lattice rescoring).

Log-probs are natural-log internally; ARPA files use log10 on disk (the
format's convention) and are converted on load/save.
"""

from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path

import numpy as np

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"

_LN10 = math.log(10.0)
_LOG0 = -99.0 * _LN10          # ARPA's conventional "never" score


class NGramLM:
    """ARPA-style backoff n-gram LM over string symbols.

    ``ngrams`` maps a tuple of symbols (context..., word) to
    ``(logp, backoff)`` in natural log. ``backoff`` is the weight applied
    when a *longer* context starting with this tuple is unseen.
    """

    def __init__(self, order: int,
                 ngrams: dict[tuple, tuple[float, float]]):
        self.order = order
        self.ngrams = ngrams
        self.vocab = sorted({k[-1] for k in ngrams if len(k) == 1})

    # ---- scoring ----

    def _norm_word(self, w: str) -> str:
        if (w,) in self.ngrams:
            return w
        return UNK

    def cond_logp(self, word: str, context: tuple = ()) -> float:
        """ln P(word | context) with backoff. Unknown words map to <unk>
        (or _LOG0 if the LM has no <unk> entry)."""
        w = self._norm_word(word)
        if (w,) not in self.ngrams:
            return _LOG0
        ctx = tuple(self._norm_word(c) if c not in (BOS,) else c
                    for c in context)[-(self.order - 1):] if self.order > 1 \
            else ()
        acc = 0.0
        while True:
            key = ctx + (w,)
            if key in self.ngrams:
                return acc + self.ngrams[key][0]
            if not ctx:
                return _LOG0   # unreachable if (w,) present; defensive
            ent = self.ngrams.get(ctx)
            if ent is not None:
                acc += ent[1]
            ctx = ctx[1:]

    def score(self, words: list[str], bos: bool = True,
              eos: bool = True) -> float:
        """ln P(words) = sum of conditional scores (optionally with
        sentence boundaries, matching how the LM was trained)."""
        ctx = (BOS,) if bos else ()
        total = 0.0
        seq = list(words) + ([EOS] if eos else [])
        for w in seq:
            total += self.cond_logp(w, ctx)
            ctx = (ctx + (self._norm_word(w),))[-(self.order - 1):] \
                if self.order > 1 else ()
        return total

    def perplexity(self, sentences: list[list[str]]) -> float:
        lp, n = 0.0, 0
        for s in sentences:
            lp += self.score(s)
            n += len(s) + 1      # + </s>
        return math.exp(-lp / max(n, 1))

    # ---- device-fusion tables ----

    def fusion_matrix(self, class_syms: list[str],
                      blank: int = 0) -> np.ndarray:
        """(C+1, C) float32 table M[prev+1, c] = ln P(sym_c | sym_prev),
        row 0 = sentence-initial context (<s>). The blank column is zero
        (blank never extends a prefix). Feed as ``lm_bigram`` to
        ``ctc_beam_search``."""
        C = len(class_syms)
        m = np.zeros((C + 1, C), np.float32)
        contexts = [(BOS,)] + [(s,) for s in class_syms]
        for r, ctx in enumerate(contexts):
            for c, sym in enumerate(class_syms):
                if c == blank:
                    continue
                m[r, c] = self.cond_logp(sym, ctx)
        return m

    def fusion_tensor3(self, class_syms: list[str],
                       blank: int = 0) -> np.ndarray:
        """(C+1, C+1, C) float32 trigram table T[prev2+1, prev+1, c] =
        ln P(sym_c | sym_prev2, sym_prev); index 0 on either context axis
        = "no token there yet" (sentence start). Feed as ``lm_trigram`` to
        ``ctc_beam_search`` for full-trigram on-device fusion — sized for
        phone-scale inventories (C=64 -> ~1 MB; grows as C^3)."""
        C = len(class_syms)
        t = np.zeros((C + 1, C + 1, C), np.float32)
        ctx1 = [None] + class_syms                   # prev2 axis
        ctx2 = [None] + class_syms                   # prev axis
        for r2, s2 in enumerate(ctx1):
            for r1, s1 in enumerate(ctx2):
                if s1 is None:
                    # Empty prefix: prev2 must be empty too; row is the
                    # sentence-initial distribution.
                    ctx = (BOS,)
                elif s2 is None:
                    ctx = (BOS, s1)
                else:
                    ctx = (s2, s1)
                for c, sym in enumerate(class_syms):
                    if c == blank:
                        continue
                    t[r2, r1, c] = self.cond_logp(sym, ctx)
        return t

    def eos_vector(self, class_syms: list[str]) -> np.ndarray:
        """(C+1,) v[prev+1] = ln P(</s> | sym_prev) (row 0: after <s>) —
        optional final-score term for ``beam_results``."""
        out = np.zeros((len(class_syms) + 1,), np.float32)
        out[0] = self.cond_logp(EOS, (BOS,))
        for i, s in enumerate(class_syms):
            out[i + 1] = self.cond_logp(EOS, (s,))
        return out

    def eos_matrix(self, class_syms: list[str]) -> np.ndarray:
        """(C+1, C+1) m[prev2+1, prev+1] = ln P(</s> | prev2, prev) —
        the trigram-context final-score term (pairs with fusion_tensor3)."""
        C = len(class_syms)
        out = np.zeros((C + 1, C + 1), np.float32)
        ctx = [None] + class_syms
        for r2, s2 in enumerate(ctx):
            for r1, s1 in enumerate(ctx):
                if s1 is None:
                    c = (BOS,)
                elif s2 is None:
                    c = (BOS, s1)
                else:
                    c = (s2, s1)
                out[r2, r1] = self.cond_logp(EOS, c)
        return out

    # ---- ARPA I/O ----

    @classmethod
    def load_arpa(cls, path: str | Path) -> "NGramLM":
        ngrams: dict[tuple, tuple[float, float]] = {}
        order = 1
        section = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line == "\\data\\":
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("ngram "):
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    order = max(order, section)
                    continue
                if section == 0:
                    continue
                parts = line.split("\t") if "\t" in line else line.split()
                lp = float(parts[0]) * _LN10
                if "\t" in line:
                    words = tuple(parts[1].split())
                    bow = float(parts[2]) * _LN10 if len(parts) > 2 else 0.0
                else:
                    # whitespace-only variant: lp w1..wn [bow]
                    if len(parts) == section + 2:
                        words = tuple(parts[1:-1])
                        bow = float(parts[-1]) * _LN10
                    else:
                        words = tuple(parts[1:section + 1])
                        bow = 0.0
                ngrams[words] = (lp, bow)
        return cls(order, ngrams)

    def save_arpa(self, path: str | Path) -> None:
        by_n: dict[int, list] = defaultdict(list)
        for key, (lp, bow) in self.ngrams.items():
            by_n[len(key)].append((key, lp, bow))
        with open(path, "w") as f:
            f.write("\\data\\\n")
            for n in range(1, self.order + 1):
                f.write(f"ngram {n}={len(by_n.get(n, []))}\n")
            for n in range(1, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for key, lp, bow in sorted(by_n.get(n, [])):
                    line = f"{lp / _LN10:.7f}\t{' '.join(key)}"
                    if n < self.order and bow != 0.0:
                        line += f"\t{bow / _LN10:.7f}"
                    f.write(line + "\n")
            f.write("\n\\end\\\n")


def train_ngram(sentences: list[list[str]], order: int = 3) -> NGramLM:
    """Estimate a backoff n-gram LM with Witten-Bell smoothing (the
    self-contained stand-in for a fetched Kaldi grammar: G is built from
    the corpus transcripts).

    Every context's predictive distribution sums to 1 over
    vocab ∪ {</s>, <unk>} \\ {<s>} (verified in tests/test_lm.py).
    """
    # ---- counts ----
    counts: dict[tuple, int] = defaultdict(int)
    ctx_tot: dict[tuple, int] = defaultdict(int)      # sum of counts after h
    ctx_types: dict[tuple, set] = defaultdict(set)    # distinct types after h
    unigram_n = 0
    for sent in sentences:
        toks = [BOS] + [str(w) for w in sent] + [EOS]
        L = len(toks)
        for i, w in enumerate(toks):
            if w != BOS:
                counts[(w,)] += 1
                unigram_n += 1
            for n in range(2, order + 1):
                if i - n + 1 < 0:
                    break
                key = tuple(toks[i - n + 1:i + 1])
                counts[key] += 1
                h = key[:-1]
                ctx_tot[h] += 1
                ctx_types[h].add(w)

    vocab = sorted({k[0] for k in counts if len(k) == 1})
    V = len(vocab)
    ngrams: dict[tuple, tuple[float, float]] = {}

    # ---- unigrams: add-one over vocab ∪ {<unk>} ----
    denom = unigram_n + V + 1
    for w in vocab:
        ngrams[(w,)] = (math.log((counts[(w,)] + 1) / denom), 0.0)
    ngrams[(UNK,)] = (math.log(1.0 / denom), 0.0)
    ngrams[(BOS,)] = (_LOG0, 0.0)    # never predicted; context-only

    def resolved_logp(word: str, ctx: tuple) -> float:
        """Backoff-resolved ln p(word|ctx) using what's filled so far."""
        acc = 0.0
        while True:
            key = ctx + (word,)
            if key in ngrams:
                return acc + ngrams[key][0]
            if not ctx:
                return ngrams[(UNK,)][0]
            ent = ngrams.get(ctx)
            if ent is not None:
                acc += ent[1]
            ctx = ctx[1:]

    # ---- higher orders, bottom-up (Witten-Bell) ----
    for n in range(2, order + 1):
        # First the explicit probs, then each context's backoff weight.
        hs = [h for h in ctx_tot if len(h) == n - 1]
        for h in hs:
            c_h, T_h = ctx_tot[h], len(ctx_types[h])
            for w in ctx_types[h]:
                p = counts[h + (w,)] / (c_h + T_h)
                ngrams[h + (w,)] = (math.log(p), 0.0)
        for h in hs:
            c_h, T_h = ctx_tot[h], len(ctx_types[h])
            lam = T_h / (c_h + T_h)                # leftover mass
            seen_lower = sum(math.exp(resolved_logp(w, h[1:]))
                             for w in ctx_types[h])
            bow = lam / max(1.0 - seen_lower, 1e-12)
            lp, _ = ngrams.get(h, (_LOG0, 0.0))
            ngrams[h] = (lp, math.log(bow))

    return NGramLM(order, ngrams)


def rescore_nbest(lm: NGramLM, tokens: np.ndarray, token_lens: np.ndarray,
                  am_scores: np.ndarray, id2sym: list[str],
                  lm_weight: float = 1.0, length_bonus: float = 0.0,
                  bos: bool = True, eos: bool = True) -> np.ndarray:
    """Re-rank beam hypotheses with the full n-gram LM (the host-side
    analog of Kaldi lattice rescoring).

    Args:
      tokens: (B, N, L) padded id sequences from ``ctc_beam_search``.
      token_lens: (B, N).
      am_scores: (B, N) acoustic log-probs (the search's ``scores``).
      id2sym: class id -> LM symbol.
    Returns (B, N) combined scores am + lm_weight*lm + length_bonus*len;
    rank with ``np.argsort(-out, axis=1)``.
    """
    B, N = am_scores.shape
    out = np.full((B, N), -np.inf, np.float64)
    for b in range(B):
        for n in range(N):
            ln = int(token_lens[b, n])
            if am_scores[b, n] <= -1e29:
                continue
            syms = [id2sym[t] for t in tokens[b, n, :ln]]
            out[b, n] = (float(am_scores[b, n])
                         + lm_weight * lm.score(syms, bos=bos, eos=eos)
                         + length_bonus * ln)
    return out
