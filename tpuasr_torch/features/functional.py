"""The featurizer's constant matrices: window, rDFT, mel and DCT.

These are the JAX package's own numpy functions, loaded from
``tpuasr/features/functional.py`` by file path rather than copied, so the
constants stay byte-identical between the two packages. A plain
``import tpuasr.features.functional`` would run ``tpuasr/features/__init__.py``,
which imports the jnp featurizer and with it jax; loading the one numpy-only
file by path keeps this package free of jax. Once that ``__init__`` imports
lazily, this becomes a plain import.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_SRC = (Path(__file__).resolve().parents[2] / "tpuasr" / "features"
        / "functional.py")
_spec = importlib.util.spec_from_file_location(
    "tpuasr_torch.features._tpuasr_functional", _SRC)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

next_pow2 = _mod.next_pow2
window_vector = _mod.window_vector
rdft_matrices = _mod.rdft_matrices
mel_filterbank = _mod.mel_filterbank
dct_matrix = _mod.dct_matrix

__all__ = ["next_pow2", "window_vector", "rdft_matrices", "mel_filterbank",
           "dct_matrix"]
