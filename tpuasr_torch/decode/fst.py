"""Minimal OpenFst-interop WFST: text + BINARY format read/write + host
n-best rescoring.

Counterpart of ``tpuasr/decode/fst.py`` (pure Python, copied so that the
port loads nothing of the JAX package). A Kaldi latgen decoder walks a
decoding graph (``TLG.fst`` + ``words.txt``) supplied as DATA. tpuasr
decomposes decoding into the on-device
beam search + lexicon/ARPA host passes, which covers its own artifacts —
this module closes the remaining interoperability hole: a user arriving
with an OpenFst graph — either the standard AT&T TEXT format
(``fstprint`` output: ``src dst ilabel olabel [weight]`` arc lines,
``state [weight]`` final lines, tropical semiring) or the BINARY file
``fstcompile``/Kaldi ``mkgraph.sh`` actually produce (``vector`` and
``const`` fst types over standard/log arcs, including embedded symbol
tables and 16-byte-aligned const files) — can load it and
rescore/transduce the beam search's n-best hypotheses through it on the
host. ``WFST.load`` sniffs the magic number and dispatches; binary
graphs can also be written back (vector-fst v2) for OpenFst tools to
consume.

Conventions:
  * weights are tropical COSTS (-ln p, lower is better), OpenFst's default;
  * ilabel 0 is <eps> (consumes no input) — consistent with CTC: the blank
    id 0 never appears in beam output, so unit ids map 1:1 to ilabels;
  * symbols: integer fields are used directly; non-integer fields resolve
    through the optional input/output SymbolTables (fstprint --isymbols /
    --osymbols style output).

Scoring is exact single-source shortest path over the composition of the
hypothesis (a linear chain) with the FST — Viterbi over (position, state)
with input-epsilon closure — not an approximation. Output labels along the
best path give the transduction (e.g. phones -> words for an L or TLG).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from pathlib import Path

import numpy as np

from tpuasr_torch.decode.lexicon import SymbolTable

INF = math.inf

# OpenFst on-disk constants (fst/fst.h, fst/symbol-table.h — public format).
FST_MAGIC = 2125659606          # kFstMagicNumber
SYMTAB_MAGIC = 2125658996       # kSymbolTableMagicNumber
_FLAG_HAS_ISYMBOLS = 0x1
_FLAG_HAS_OSYMBOLS = 0x2
_ALIGN = 16                     # MappedFile::kArchAlignment (const fsts)


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    dst: int


class _BinReader:
    """Little-endian cursor over OpenFst's WriteType wire encodings."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, fmt: str):
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def i32(self) -> int:
        return self._take("<i")

    def u32(self) -> int:
        return self._take("<I")

    def i64(self) -> int:
        return self._take("<q")

    def u64(self) -> int:
        return self._take("<Q")

    def f32(self) -> float:
        return self._take("<f")

    def string(self) -> str:
        n = self.i32()
        s = self.data[self.pos:self.pos + n]
        if len(s) != n:
            raise ValueError("truncated string field")
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def align(self, k: int) -> None:
        self.pos += -self.pos % k

    def symbol_table(self) -> SymbolTable:
        magic = self.i32()
        if magic != SYMTAB_MAGIC:
            raise ValueError(f"bad SymbolTable magic {magic}")
        self.string()                              # table name
        self.i64()                                 # available_key
        size = self.i64()
        sym2id = {}
        for _ in range(size):
            sym = self.string()
            sym2id[sym] = self.i64()
        return SymbolTable(sym2id)


class _BinWriter:
    def __init__(self):
        self._parts: list[bytes] = []

    def _put(self, fmt: str, v) -> None:
        self._parts.append(struct.pack(fmt, v))

    def i32(self, v: int) -> None:
        self._put("<i", v)

    def u64(self, v: int) -> None:
        self._put("<Q", v)

    def i64(self, v: int) -> None:
        self._put("<q", v)

    def f32(self, v: float) -> None:
        self._put("<f", v)

    def string(self, s: str) -> None:
        b = s.encode("utf-8")
        self.i32(len(b))
        self._parts.append(b)

    def symbol_table(self, table: SymbolTable, name: str) -> None:
        self.i32(SYMTAB_MAGIC)
        self.string(name)
        self.i64(max(table.sym2id.values(), default=-1) + 1)
        self.i64(len(table.sym2id))
        for sym, key in sorted(table.sym2id.items(), key=lambda kv: kv[1]):
            self.string(sym)
            self.i64(key)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class WFST:
    """Weighted FST over the tropical semiring (costs; lower = better)."""

    def __init__(self, start: int = 0):
        self.start = start
        self.arcs: dict[int, list[Arc]] = {}
        self.finals: dict[int, float] = {}
        # Symbol tables embedded in a binary file (None otherwise).
        self.isyms: SymbolTable | None = None
        self.osyms: SymbolTable | None = None

    # ---- construction ----

    def add_arc(self, src: int, dst: int, ilabel: int, olabel: int,
                weight: float = 0.0) -> None:
        self.arcs.setdefault(src, []).append(
            Arc(int(ilabel), int(olabel), float(weight), int(dst)))

    def set_final(self, state: int, weight: float = 0.0) -> None:
        self.finals[int(state)] = float(weight)

    @property
    def num_states(self) -> int:
        states = {self.start} | set(self.finals)
        for s, arcs in self.arcs.items():
            states.add(s)
            states.update(a.dst for a in arcs)
        return len(states)

    # ---- OpenFst text format ----

    @classmethod
    def load_text(cls, path: str | Path, isyms: SymbolTable | None = None,
                  osyms: SymbolTable | None = None) -> "WFST":
        """Parse ``fstprint`` output. The FIRST mentioned state is the start
        state (OpenFst convention)."""

        def sym(tok: str, table: SymbolTable | None) -> int:
            try:
                return int(tok)
            except ValueError:
                if table is None:
                    raise ValueError(
                        f"non-integer label {tok!r} needs a symbol table")
                return table[tok]

        fst = None
        for raw in Path(path).read_text().splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if fst is None:
                fst = cls(start=int(parts[0]))
            if len(parts) >= 4:            # arc: src dst il ol [w]
                w = float(parts[4]) if len(parts) >= 5 else 0.0
                fst.add_arc(int(parts[0]), int(parts[1]),
                            sym(parts[2], isyms), sym(parts[3], osyms), w)
            elif len(parts) <= 2:          # final: state [w]
                w = float(parts[1]) if len(parts) == 2 else 0.0
                fst.set_final(int(parts[0]), w)
            else:
                raise ValueError(f"unparseable FST line: {raw!r}")
        if fst is None:
            raise ValueError(f"empty FST file {path}")
        return fst

    def save_text(self, path: str | Path,
                  isyms: SymbolTable | None = None,
                  osyms: SymbolTable | None = None) -> None:
        def name(i: int, table: SymbolTable | None) -> str:
            return table.sym(i) if table is not None else str(i)

        lines = []
        done_finals = set()
        # Start state first (OpenFst: the first mentioned state IS the
        # start). A final-only start has no arc line, so its final line
        # must lead the file instead.
        if self.start not in self.arcs:
            w = self.finals.get(self.start)
            if w is None:
                raise ValueError(
                    f"start state {self.start} has no arcs and is not "
                    "final; the text format cannot express it")
            lines.append(f"{self.start} {w:.6g}" if w else f"{self.start}")
            done_finals.add(self.start)
        order = [self.start] + [s for s in sorted(self.arcs)
                                if s != self.start]
        for s in order:
            for a in self.arcs.get(s, []):
                lines.append(f"{s} {a.dst} {name(a.ilabel, isyms)} "
                             f"{name(a.olabel, osyms)} {a.weight:.6g}")
        for s, w in sorted(self.finals.items()):
            if s not in done_finals:
                lines.append(f"{s} {w:.6g}" if w else f"{s}")
        Path(path).write_text("\n".join(lines) + "\n")

    # ---- OpenFst binary format ----

    @classmethod
    def load(cls, path: str | Path, isyms: SymbolTable | None = None,
             osyms: SymbolTable | None = None) -> "WFST":
        """Auto-detect text vs binary OpenFst by magic number. Explicit
        ``isyms``/``osyms`` override any tables embedded in a binary file."""
        with open(path, "rb") as f:
            head = f.read(4)
        if len(head) == 4 and struct.unpack("<i", head)[0] == FST_MAGIC:
            fst = cls.load_binary(path)
            if isyms is not None:
                fst.isyms = isyms
            if osyms is not None:
                fst.osyms = osyms
            return fst
        return cls.load_text(path, isyms=isyms, osyms=osyms)

    @classmethod
    def load_binary(cls, path: str | Path) -> "WFST":
        """Read an OpenFst binary file as written by ``fstcompile`` /
        ``fstconvert`` / Kaldi's ``mkgraph.sh``: fst types ``vector``
        (v1/v2) and ``const`` (v2 unaligned, v1 16-byte-aligned), arc
        types ``standard`` (tropical) and ``log`` (costs read as-is).
        Embedded symbol tables land on ``.isyms``/``.osyms``."""
        data = Path(path).read_bytes()
        rd = _BinReader(data)
        magic = rd.i32()
        if magic != FST_MAGIC:
            raise ValueError(f"{path}: not an OpenFst binary file "
                             f"(magic {magic} != {FST_MAGIC})")
        fsttype = rd.string()
        arctype = rd.string()
        version = rd.i32()
        flags = rd.i32()
        rd.u64()                                   # properties (unused)
        start = rd.i64()
        numstates = rd.i64()
        numarcs = rd.i64()
        if arctype not in ("standard", "log"):
            raise ValueError(f"{path}: unsupported arc type {arctype!r} "
                             "(need standard or log)")
        isyms = rd.symbol_table() if flags & _FLAG_HAS_ISYMBOLS else None
        osyms = rd.symbol_table() if flags & _FLAG_HAS_OSYMBOLS else None

        fst = cls(start=int(start))
        fst.isyms, fst.osyms = isyms, osyms
        if fsttype == "vector":
            for s in range(numstates):
                w = rd.f32()
                if w < INF:
                    fst.set_final(s, w)
                for _ in range(rd.i64()):
                    il, ol = rd.i32(), rd.i32()
                    aw = rd.f32()
                    fst.add_arc(s, rd.i32(), il, ol, aw)
        elif fsttype == "const":
            # v1 files are written through mmap-friendly 16-byte-aligned
            # blocks; v2 dropped the padding. Rather than trust the
            # version bit alone, probe both layouts and validate the
            # state table (arc positions must tile [0, numarcs)).
            fst._read_const_body(rd, numstates, numarcs,
                                 aligned=version == 1)
        else:
            raise ValueError(f"{path}: unsupported fst type {fsttype!r} "
                             "(need vector or const)")
        return fst

    def _read_const_body(self, rd: "_BinReader", numstates: int,
                         numarcs: int, aligned: bool) -> None:
        for try_aligned in ((aligned, not aligned)):
            pos = rd.pos
            r = _BinReader(rd.data)
            r.pos = pos
            if try_aligned:
                r.align(_ALIGN)
            states = [(r.f32(), r.u32(), r.u32(), r.u32(), r.u32())
                      for _ in range(numstates)]
            # ConstFst lays each state's arcs out consecutively: pos must
            # be the running arc count and the tally must hit numarcs.
            tally, ok = 0, True
            for _, p, n, nieps, noeps in states:
                ok &= p == tally and nieps <= n and noeps <= n
                tally += n
            ok &= tally == numarcs
            if ok:
                if try_aligned:
                    r.align(_ALIGN)
                arcs = [(r.i32(), r.i32(), r.f32(), r.i32())
                        for _ in range(numarcs)]
                for s, (w, p, n, _, _) in enumerate(states):
                    if w < INF:
                        self.set_final(s, w)
                    for il, ol, aw, dst in arcs[p:p + n]:
                        self.add_arc(s, dst, il, ol, aw)
                rd.pos = r.pos
                return
        raise ValueError("const-fst state table does not tile the arc "
                         "array in either aligned or unaligned layout")

    def save_binary(self, path: str | Path,
                    isyms: SymbolTable | None = None,
                    osyms: SymbolTable | None = None) -> None:
        """Write vector-fst v2 / standard arcs — readable by OpenFst's
        own tools (``fstprint``, ``fstinfo``) and by :meth:`load_binary`.
        States must be (or are densified to) 0..n-1; symbol tables are
        embedded when given (falling back to ``self.isyms``/``osyms``)."""
        isyms = isyms if isyms is not None else self.isyms
        osyms = osyms if osyms is not None else self.osyms
        n = 0
        for s, arcs in self.arcs.items():
            n = max(n, s + 1, *(a.dst + 1 for a in arcs))
        for s in self.finals:
            n = max(n, s + 1)
        n = max(n, self.start + 1)
        wr = _BinWriter()
        wr.i32(FST_MAGIC)
        wr.string("vector")
        wr.string("standard")
        wr.i32(2)                                  # kFileVersion
        wr.i32((_FLAG_HAS_ISYMBOLS if isyms is not None else 0)
               | (_FLAG_HAS_OSYMBOLS if osyms is not None else 0))
        wr.u64(0x3)                                # kExpanded | kMutable
        wr.i64(self.start)
        wr.i64(n)
        wr.i64(sum(len(a) for a in self.arcs.values()))
        if isyms is not None:
            wr.symbol_table(isyms, "tpuasr_isyms")
        if osyms is not None:
            wr.symbol_table(osyms, "tpuasr_osyms")
        for s in range(n):
            wr.f32(self.finals.get(s, INF))
            arcs = self.arcs.get(s, [])
            wr.i64(len(arcs))
            for a in arcs:
                wr.i32(a.ilabel)
                wr.i32(a.olabel)
                wr.f32(a.weight)
                wr.i32(a.dst)
        Path(path).write_bytes(wr.getvalue())

    # ---- shortest-path scoring (composition with a linear chain) ----

    def _eps_relax(self, costs: dict[int, tuple[float, tuple]]) -> dict:
        """Closure over input-epsilon arcs (Viterbi relaxation; bounded by
        the state count, so eps-cycles with non-negative cost terminate)."""
        n = self.num_states
        for _ in range(n):
            changed = False
            for s in list(costs):
                c, outs = costs[s]
                for a in self.arcs.get(s, []):
                    if a.ilabel != 0:
                        continue
                    nc = c + a.weight
                    no = outs + ((a.olabel,) if a.olabel else ())
                    if nc < costs.get(a.dst, (INF, ()))[0]:
                        costs[a.dst] = (nc, no)
                        changed = True
            if not changed:
                break
        return costs

    def score(self, ilabels) -> tuple[float, list[int]]:
        """Min-cost path consuming ``ilabels`` exactly; returns
        (cost, output_labels). (inf, []) when the FST rejects the string
        (the analog of an LM assigning probability 0)."""
        costs = self._eps_relax({self.start: (0.0, ())})
        for lab in ilabels:
            lab = int(lab)
            nxt: dict[int, tuple[float, tuple]] = {}
            for s, (c, outs) in costs.items():
                for a in self.arcs.get(s, []):
                    if a.ilabel != lab:
                        continue
                    nc = c + a.weight
                    no = outs + ((a.olabel,) if a.olabel else ())
                    if nc < nxt.get(a.dst, (INF, ()))[0]:
                        nxt[a.dst] = (nc, no)
            costs = self._eps_relax(nxt)
            if not costs:
                return INF, []
        best, bouts = INF, []
        for s, (c, outs) in costs.items():
            if s in self.finals and c + self.finals[s] < best:
                best = c + self.finals[s]
                bouts = list(outs)
        return best, bouts

    def accepts(self, ilabels) -> bool:
        return self.score(ilabels)[0] < INF


def rescore_nbest_fst(fst: WFST, tokens: np.ndarray, token_lens: np.ndarray,
                      am_scores: np.ndarray, fst_weight: float = 1.0,
                      reject_cost: float = 1e9):
    """Re-rank beam n-best through a WFST (the host-side analog of Kaldi
    lattice rescoring with a TLG grammar).

    Args:
      tokens: (B, N, L) padded unit-id sequences from ``ctc_beam_search``.
      token_lens: (B, N); am_scores: (B, N) acoustic log-probs.
      fst_weight: weight on the FST log-prob (= minus tropical cost).
      reject_cost: cost charged to hypotheses the FST rejects — a finite
        stand-in for -inf so a fully-rejected row still ranks by AM score.
    Returns (scores (B, N), olabels: list[list[list[int]]] per hypothesis —
    the transduced output, e.g. word ids for an L/TLG).
    """
    B, N = np.asarray(am_scores).shape
    out = np.full((B, N), -np.inf, np.float64)
    olabels = [[[] for _ in range(N)] for _ in range(B)]
    for b in range(B):
        for n in range(N):
            if am_scores[b, n] <= -1e29:
                continue
            ln = int(token_lens[b, n])
            cost, outs = fst.score(tokens[b, n, :ln])
            if cost == INF:
                cost = reject_cost
            out[b, n] = float(am_scores[b, n]) - fst_weight * cost
            olabels[b][n] = outs
    return out, olabels


def lexicon_to_fst(word_prons, word_score: float = 0.0,
                   olabels=None) -> WFST:
    """Build a closure-of-words L transducer from [(word_name_or_id, pron)]
    pairs: phones in, word (1-based index) out — the tiny hand-built "TL"
    used by tests and a template for users assembling graphs in code.

    olabels: optional per-entry output labels overriding the 1-based entry
    index — pass word_id + 1 when entries are alternative prons of the
    same word, or when downstream composition (ngram_to_fst's sym2label)
    keys arcs by an external words.txt id space."""
    fst = WFST(start=0)
    fst.set_final(0, 0.0)
    nxt = 1
    for wid, (_, pron) in enumerate(word_prons):
        out_label = olabels[wid] if olabels is not None else wid + 1
        src = 0
        for i, p in enumerate(pron):
            last = i == len(pron) - 1
            dst = 0 if last else nxt
            fst.add_arc(src, dst, int(p), out_label if last else 0,
                        word_score if last else 0.0)
            if not last:
                nxt += 1
            src = dst
    return fst
