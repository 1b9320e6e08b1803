"""The native multithreaded wav reader: ``native/wav_batch.cc`` bound by
ctypes, the port's counterpart of ``tpuasr/native/wav_batch.py``.

The repository's ``native/wav_batch.cc`` is compiled as it is by the host
C++ compiler (``$CXX``, else ``g++``) at first use into
``build/tpuasr_torch/``, named by a hash of the source, the compiler's
version and its flags, under a file lock, as ``_build.py`` builds the CUDA
kernels. A failed build raises ``RuntimeError`` with the compiler's
output; nothing falls back to scipy (``LoaderConfig(native_io=False)``
asks for scipy).

One call decodes a batch of files on several threads, bit for bit as
``data.manifest.load_wav`` (scipy) decodes them: PCM8/16/24/32 and float32,
channels averaged.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tpuasr_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wav_batch.cc"
# No -march=native: the library may be loaded on another host than the
# one that built it.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
ERROR_NAMES = {1: "open failed", 2: "short read", 3: "not RIFF/WAVE",
               4: "missing fmt/data chunk", 5: "unsupported encoding"}

_lib = None
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX): the "
                           "native wav reader is built from native/"
                           "wav_batch.cc at first use")
    return found


def build(source: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into a shared library unless one for this source,
    compiler version and flags exists; -> its path."""
    source = Path(source)
    if not source.is_file():
        raise RuntimeError(f"native wav reader source {source} not found")
    cxx = find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join([cxx, version, *CXX_FLAGS]).encode())
    out_dir = Path(out_dir)
    out = out_dir / f"libwav_batch_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"the native wav reader failed to build "
                    f"({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n"
                    f"{res.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded reader (built first if needed)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        loaded.wav_batch_load.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _f32p, _i32p,
            _i32p, _i32p, ctypes.c_longlong, ctypes.c_int]
        loaded.wav_batch_load.restype = ctypes.c_int
        _lib = loaded
    return _lib


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
