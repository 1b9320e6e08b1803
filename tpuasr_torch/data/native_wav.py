"""The native multithreaded wav reader (``native/wav_batch.cc``), as the
loader reaches it: the names of ``tpuasr_torch/native/wav_batch.py``."""

from tpuasr_torch.native.wav_batch import (CXX_FLAGS, ERROR_NAMES, SOURCE,
                                           build, find_cxx, lib,
                                           load_wav_batch)

__all__ = ["CXX_FLAGS", "ERROR_NAMES", "SOURCE", "build", "find_cxx", "lib",
           "load_wav_batch"]
