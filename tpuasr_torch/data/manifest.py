"""JSON-lines manifests describing a corpus: the port's copy of
``tpuasr/data/manifest.py``.

Each line: {"id": str, "wav": path, "tokens": [int, ...], "text": str,
"num_samples": int, "sample_rate": int, "segments": [...]}
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Utterance:
    id: str
    wav: str
    tokens: list[int]
    text: str = ""
    num_samples: int = 0
    sample_rate: int = 8000
    # Time-aligned segments for frame-wise training:
    # [[token, start_sample, end_sample], ...]
    segments: list = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.num_samples / max(self.sample_rate, 1)


def write_manifest(path: str | Path, utts: list[Utterance]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for u in utts:
            f.write(json.dumps(dataclasses.asdict(u)) + "\n")


def read_manifest(path: str | Path) -> list[Utterance]:
    utts = []
    base = Path(path).parent
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            # Relative wav paths resolve against the manifest location.
            if not os.path.isabs(d["wav"]):
                d["wav"] = str(base / d["wav"])
            utts.append(Utterance(**d))
    return utts


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """wav file -> (float32 samples in [-1, 1], sample rate), mono, by
    scipy."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr
