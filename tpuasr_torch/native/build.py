"""Build the repository's host C++ sources (``native/*.cc``) at first use
and load them with ctypes.

Each source is compiled as it is in the repository by the host C++
compiler (``$CXX``, else ``g++``) with ``CXX_FLAGS`` into
``build/tpuasr_torch/``, one shared library a source, named by a hash of
the source, the compiler's version and the flags, so an edit or another
compiler rebuilds and an unchanged tree reuses the last build. A file lock
keeps concurrent processes from building the same library at once.
Nothing is written into ``native/``, and nothing runs at import time. A
missing compiler or a failed build raises ``RuntimeError`` with the
compiler's output; nothing falls back to a Python version.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from tpuasr_torch._build import BUILD_DIR

SOURCE_DIR = Path(__file__).resolve().parents[2] / "native"
# No -march=native: a library may be loaded on another host than the one
# that built it. Under ISO C++17 GCC contracts no a*b+c into an FMA, so the
# float results are those of the sources' written order.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_libs: dict[str, ctypes.CDLL] = {}


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX): the "
                           "host libraries are built from native/*.cc at "
                           "first use")
    return found


def build(source: Path, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into a shared library unless one for this source,
    compiler version and flags exists; -> its path."""
    source = Path(source)
    if not source.is_file():
        raise RuntimeError(f"native source {source} not found")
    cxx = find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join([cxx, version, *CXX_FLAGS]).encode())
    out_dir = Path(out_dir)
    out = out_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():          # another process built it meanwhile
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"{source.name} failed to build ({res.returncode}): "
                    f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``native/<name>.cc`` (built first if needed), with
    ``signatures``: function name -> (argtypes, restype). Loaded once a
    process."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(SOURCE_DIR / f"{name}.cc", BUILD_DIR)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib
