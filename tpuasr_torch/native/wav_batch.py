"""The native multithreaded wav reader: ``native/wav_batch.cc`` bound by
ctypes, the port's counterpart of ``tpuasr/native/wav_batch.py`` (the
loader reaches it as ``data/native_wav.py``).

The repository's ``native/wav_batch.cc`` is compiled as it is at first use
by ``tpuasr_torch/native/build.py`` (the host C++ compiler, into
``build/tpuasr_torch/``, named by a hash of the source, the compiler's
version and its flags, under a file lock). A failed build raises
``RuntimeError`` with the compiler's output; nothing falls back to scipy
(``LoaderConfig(native_io=False)`` asks for scipy).

One call decodes a batch of files on several threads, bit for bit as
``data.manifest.load_wav`` (scipy) decodes them: PCM8/16/24/32 and float32,
channels averaged.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from tpuasr_torch._build import BUILD_DIR
from tpuasr_torch.native import build as native_build
from tpuasr_torch.native.build import CXX_FLAGS, find_cxx

__all__ = ["CXX_FLAGS", "ERROR_NAMES", "SOURCE", "build", "find_cxx", "lib",
           "load_wav_batch"]

SOURCE = native_build.SOURCE_DIR / "wav_batch.cc"
ERROR_NAMES = {1: "open failed", 2: "short read", 3: "not RIFF/WAVE",
               4: "missing fmt/data chunk", 5: "unsupported encoding"}

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def build(source: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into a shared library unless one for this source,
    compiler version and flags exists; -> its path."""
    return native_build.build(source, out_dir)


def lib() -> ctypes.CDLL:
    """The loaded reader (built first if needed)."""
    return native_build.load("wav_batch", {"wav_batch_load": (
        [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _f32p, _i32p, _i32p,
         _i32p, ctypes.c_longlong, ctypes.c_int], ctypes.c_int)})


def load_wav_batch(paths: list[str], max_samples: int, num_threads: int = 8):
    """Decode wav files in parallel -> (out (n, max_samples) f32 zero-padded
    past each length, lens (n,) i32, srs (n,) i32). Raises RuntimeError
    naming the first file that fails."""
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    lens = np.zeros((n,), np.int32)
    srs = np.zeros((n,), np.int32)
    errs = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib().wav_batch_load(arr, n, out, lens, srs, errs, max_samples,
                              num_threads)
    if rc != 0:
        i = rc - 1
        raise RuntimeError(f"wav decode failed for {paths[i]}: "
                           f"{ERROR_NAMES.get(int(errs[i]), errs[i])}")
    return out, lens, srs
