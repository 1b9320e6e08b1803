"""Beam search configuration shared by the port's decoders.

Counterpart of the configuration half of ``tpuasr/decode/prefix_beam.py``.
The XLA-style search with top-P class pruning is not ported yet; the beam
kernel (``decode/beam.py``) searches all classes, as the Pallas kernel does.
"""

from __future__ import annotations

import dataclasses

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_width: int = 16          # K
    class_topk: int = 8           # P (ignored by the all-class kernel)
    max_len: int = 256            # prefix buffer length (tokens)
    blank: int = 0
    token_insertion_bonus: float = 0.0
    lm_weight: float = 0.0
    graph_weight: float = 1.0
    graph_final_cap: float = 1e4
