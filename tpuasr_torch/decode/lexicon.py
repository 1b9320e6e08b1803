"""Host-side lexicon / symbol-table utilities: the Kaldi graph artifacts
words.txt / phones.txt / lexicon as plain data files, no Kaldi link.

Counterpart of ``tpuasr/decode/lexicon.py`` (pure Python, copied so that
the port loads nothing of the JAX package). Given the beam search's
phone-id sequences, `LexiconDecoder` maps them to word sequences by dynamic
programming over a phone-trie (Viterbi word segmentation with an insertion
penalty): L, the lexicon transducer, applied on the host after the CTC beam
search has collapsed the phone topology.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


class SymbolTable:
    """Kaldi-style 'symbol id' table (words.txt / phones.txt)."""

    def __init__(self, sym2id: dict[str, int]):
        self.sym2id = dict(sym2id)
        self.id2sym = {v: k for k, v in self.sym2id.items()}

    @classmethod
    def load(cls, path: str | Path) -> "SymbolTable":
        sym2id = {}
        for line in Path(path).read_text().splitlines():
            parts = line.split()
            if len(parts) >= 2:
                sym2id[parts[0]] = int(parts[1])
        return cls(sym2id)

    @classmethod
    def from_list(cls, symbols: list[str]) -> "SymbolTable":
        return cls({s: i for i, s in enumerate(symbols)})

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            "".join(f"{s} {i}\n" for s, i in sorted(self.sym2id.items(),
                                                    key=lambda kv: kv[1])))

    def __len__(self):
        return len(self.sym2id)

    def __getitem__(self, sym: str) -> int:
        return self.sym2id[sym]

    def sym(self, idx: int) -> str:
        return self.id2sym.get(idx, "<unk>")


@dataclasses.dataclass
class _TrieNode:
    children: dict
    word: int | None = None          # word id terminating here (if any)


class Lexicon:
    """word -> phone-id pronunciation(s); text format: 'WORD ph ph ph'."""

    def __init__(self, prons: list[tuple[int, tuple[int, ...]]]):
        """prons: [(word_id, phone_id_seq), ...]"""
        self.prons = prons
        self.root = _TrieNode({})
        for wid, phones in prons:
            node = self.root
            for p in phones:
                node = node.children.setdefault(p, _TrieNode({}))
            if node.word is None:      # keep the first (highest-prior) pron
                node.word = wid

    @classmethod
    def load(cls, path: str | Path, words: SymbolTable,
             phones: SymbolTable) -> "Lexicon":
        prons = []
        for line in Path(path).read_text().splitlines():
            parts = line.split()
            if len(parts) < 2 or parts[0] not in words.sym2id:
                continue
            try:
                seq = tuple(phones[p] for p in parts[1:])
            except KeyError:
                continue
            prons.append((words[parts[0]], seq))
        return cls(prons)


class LexiconDecoder:
    """Viterbi segmentation of a phone sequence into words.

    DP over positions: best[i] = max over words w whose pronunciation matches
    phones[j:i] of best[j] + score(w); unmatched phones can be skipped with a
    penalty so noisy CTC outputs still produce output.
    """

    def __init__(self, lexicon: Lexicon, word_score: float = 0.0,
                 skip_penalty: float = -5.0):
        self.lexicon = lexicon
        self.word_score = word_score
        self.skip_penalty = skip_penalty

    def decode(self, phones: list[int]) -> list[int]:
        n = len(phones)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[tuple[int, int | None]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        for j in range(n):
            if best[j] <= NEG / 2:
                continue
            # Option 1: skip this phone.
            if best[j] + self.skip_penalty > best[j + 1]:
                best[j + 1] = best[j] + self.skip_penalty
                back[j + 1] = (j, None)
            # Option 2: match words starting at j.
            node = self.lexicon.root
            i = j
            while i < n and phones[i] in node.children:
                node = node.children[phones[i]]
                i += 1
                if node.word is not None:
                    sc = best[j] + self.word_score
                    if sc > best[i]:
                        best[i] = sc
                        back[i] = (j, node.word)
        # Trace back.
        words = []
        i = n
        while i > 0:
            j, w = back[i]
            if w is not None:
                words.append(w)
            i = j
        return words[::-1]
