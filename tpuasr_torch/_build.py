"""Build the package's CUDA kernels at first use and load them with ctypes.

All sources under ``tpuasr_torch/csrc/`` are compiled by ``nvcc`` (from
``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then ``/usr/local/cuda``), one
process per source, all started together, and linked into one shared
library with a plain C interface, for ``sm_90a`` (Hopper). The
library lands in ``build/tpuasr_torch/`` at the repository root, named by a
hash of the sources, their headers (``csrc/*.cuh``) and the flags, so an
edit rebuilds and an unchanged tree reuses the last build. A file lock
keeps concurrent processes from building the same library at once.

Nothing here runs at import time. A missing ``nvcc`` or a failed build is an
error that carries the compiler's output; nothing falls back to the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "tpuasr_torch"

# Never --use_fast_math: the parity paths need IEEE expf/logf/division, and
# the int8 quantizers round at .5 boundaries that one ulp can flip.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
        "tpuasr_torch CUDA kernels are built from source at first use")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpuasr_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():          # another process built it meanwhile
            return out
        nvcc = find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = BUILD_DIR / f"obj.{os.getpid()}"
        objs.mkdir(exist_ok=True)
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in _sources():
            cmd = [nvcc, *compile_flags, "-c", "-o",
                   str(objs / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        link = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                *[str(objs / f"{src.stem}.o") for src in _sources()]]
        try:
            for cmd, proc in jobs:
                _run(cmd, proc)
            _run(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
            os.replace(tmp, out)
        finally:
            for _, proc in jobs:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
            shutil.rmtree(objs, ignore_errors=True)
    return out


def _run(cmd, proc) -> None:
    """Wait for one nvcc process; raise with its output if it failed."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{stdout}\n{stderr}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        loaded.tpuasr_error_string.argtypes = [ctypes.c_int]
        loaded.tpuasr_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if code != 0:
        msg = lib().tpuasr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(name, t, device, dtypes, shape) -> None:
    """Raise ValueError unless tensor ``t`` is on ``device``, of one of
    ``dtypes``, of ``shape`` and contiguous: what a kernel may be given."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of tensor ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
