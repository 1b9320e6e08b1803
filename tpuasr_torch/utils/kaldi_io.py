"""Kaldi ark/scp archives in pure numpy: the port's counterpart (a copy) of
``tpuasr/utils/kaldi_io.py``. Features, log-likelihoods and alignments
written here interoperate with Kaldi's tools; for the same keys and arrays
the files are byte for byte the JAX package's.

Binary FloatMatrix/DoubleMatrix ('FM'/'DM') and FloatVector/DoubleVector
('FV'/'DV') entries, read streaming from an .ark or at random through the
.scp offsets.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_BIN_HDR = b"\0B"


def _read_token(f) -> bytes:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok


def _read_basic_int(f) -> int:
    size = f.read(1)[0]
    return int.from_bytes(f.read(size), "little", signed=True)


def _read_matrix(f) -> np.ndarray:
    hdr = f.read(2)
    if hdr != _BIN_HDR:
        raise ValueError(f"not a Kaldi binary entry (got {hdr!r})")
    tok = _read_token(f)
    if tok in (b"FM", b"DM"):
        dtype = np.float32 if tok == b"FM" else np.float64
        rows = _read_basic_int(f)
        cols = _read_basic_int(f)
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype)
        return data.reshape(rows, cols).copy()
    if tok in (b"FV", b"DV"):
        dtype = np.float32 if tok == b"FV" else np.float64
        n = _read_basic_int(f)
        return np.frombuffer(f.read(n * dtype().itemsize), dtype).copy()
    raise ValueError(f"unsupported Kaldi token {tok!r}")


def _write_matrix(f, mat: np.ndarray) -> None:
    f.write(_BIN_HDR)
    if mat.ndim == 2:
        tok = b"FM " if mat.dtype == np.float32 else b"DM "
        f.write(tok)
        for d in mat.shape:
            f.write(b"\x04" + struct.pack("<i", d))
    elif mat.ndim == 1:
        tok = b"FV " if mat.dtype == np.float32 else b"DV "
        f.write(tok)
        f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    else:
        raise ValueError("only 1-D/2-D arrays")
    f.write(np.ascontiguousarray(mat).tobytes())


def write_ark_scp(prefix: str | Path, items) -> tuple[Path, Path]:
    """items: iterable of (key, ndarray[f32/f64]). Writes prefix.ark/.scp.

    The suffixes are APPENDED (prefix "out.v1" -> "out.v1.ark"), not spliced
    via with_suffix (which would mangle dotted prefixes to "out.ark").
    Duplicate keys raise: Kaldi scp consumers silently shadow earlier entries.
    """
    prefix = Path(prefix)
    ark_path = prefix.parent / (prefix.name + ".ark")
    scp_path = prefix.parent / (prefix.name + ".scp")
    seen: set[str] = set()
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for key, mat in items:
            if key in seen:
                raise ValueError(f"duplicate ark key {key!r}")
            seen.add(key)
            ark.write(key.encode() + b" ")
            offset = ark.tell()
            mat = np.asarray(mat)
            if mat.dtype not in (np.float32, np.float64):
                mat = mat.astype(np.float32)
            _write_matrix(ark, mat)
            scp.write(f"{key} {ark_path}:{offset}\n")
    return ark_path, scp_path


def read_ark(path: str | Path):
    """Yields (key, ndarray) streaming through an .ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                return
            yield key.decode(), _read_matrix(f)


def read_scp(path: str | Path):
    """Yields (key, ndarray) via scp random-access entries."""
    for key, mat in iter_scp(path):
        yield key, mat


def iter_scp(path: str | Path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, loc = line.split(None, 1)
            ark_path, offset = loc.rsplit(":", 1)
            with open(ark_path, "rb") as ark:
                ark.seek(int(offset))
                yield key, _read_matrix(ark)


def read_scp_entry(path_offset: str) -> np.ndarray:
    ark_path, offset = path_offset.rsplit(":", 1)
    with open(ark_path, "rb") as ark:
        ark.seek(int(offset))
        return _read_matrix(ark)
