"""A Kaldi data dir into a JSON-lines manifest (the ASpIRE path): the
port's copy of ``tpuasr/data/corpus/kaldi_dir.py``, on the port's own
``data/manifest.py`` and ``decode/lexicon.py``.

Given a Kaldi-style data directory (``wav.scp``, optionally ``text``), it
writes a manifest whose token ids come from a lexicon and its word table
(phone ids), or from a units table (character or word units), or no
tokens (an inference-only manifest). No Kaldi binaries run: ``wav.scp``
entries must name plain wav files, and a pipe entry ('cmd |') raises.
"""

from __future__ import annotations

from pathlib import Path

from tpuasr_torch.data.manifest import Utterance, load_wav, write_manifest
from tpuasr_torch.decode.lexicon import Lexicon, SymbolTable


def _read_kv(path: Path) -> dict[str, str]:
    out = {}
    for line in path.read_text().splitlines():
        parts = line.split(None, 1)
        if len(parts) == 2:
            out[parts[0]] = parts[1].strip()
    return out


def _tokens(utt_id: str, transcript: str, units: SymbolTable | None,
            lexicon: Lexicon | None, words: SymbolTable | None,
            strict: bool) -> list[int]:
    """The token ids of one transcript: lexicon + words first (each word's
    first pronunciation, OOV words skipped), else units (unknown units
    skipped); with strict, a miss raises KeyError."""
    tokens: list[int] = []
    if not transcript:
        return tokens
    if lexicon is not None and words is not None:
        for w in transcript.split():
            wid = words.sym2id.get(w)
            pron = None
            if wid is not None:
                pron = next((p for vid, p in lexicon.prons if vid == wid),
                            None)
            if pron is None:
                if strict:
                    raise KeyError(f"{utt_id}: OOV word {w!r}")
                continue
            tokens.extend(pron)
    elif units is not None:
        for tok in transcript.split():
            tid = units.sym2id.get(tok)
            if tid is None:
                if strict:
                    raise KeyError(f"{utt_id}: unknown unit {tok!r}")
                continue
            tokens.append(tid)
    return tokens


def prepare_kaldi_dir(data_dir, out_manifest, units: SymbolTable = None,
                      lexicon: Lexicon = None, words: SymbolTable = None,
                      sample_rate: int = 8000,
                      strict: bool = False) -> list[Utterance]:
    """Convert a Kaldi-style data dir into a JSON-lines manifest and return
    its utterances, sorted by id. Tokenization, in priority order: lexicon
    + words (text words -> phone ids), units (whitespace tokens looked up
    directly), neither (no tokens). A wav that is missing, unreadable or
    at another rate than ``sample_rate`` is skipped, or raises with
    strict."""
    data_dir = Path(data_dir)
    wav_scp = _read_kv(data_dir / "wav.scp")
    text = _read_kv(data_dir / "text") if (data_dir / "text").exists() else {}
    utts = []
    for utt_id, wav_path in sorted(wav_scp.items()):
        if wav_path.endswith("|"):
            raise ValueError(
                f"{utt_id}: pipe wav.scp entries are not supported "
                f"(pre-convert to wav files): {wav_path!r}")
        transcript = text.get(utt_id, "")
        tokens = _tokens(utt_id, transcript, units, lexicon, words, strict)
        try:
            data, sr = load_wav(wav_path)
        except (FileNotFoundError, ValueError):
            if strict:
                raise
            continue
        if sr != sample_rate:
            if strict:
                raise ValueError(f"{utt_id}: sr {sr} != {sample_rate}")
            continue
        utts.append(Utterance(id=utt_id, wav=wav_path, tokens=tokens,
                              text=transcript, num_samples=len(data),
                              sample_rate=sr))
    write_manifest(out_manifest, utts)
    return utts
