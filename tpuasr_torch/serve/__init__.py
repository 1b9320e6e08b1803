"""Serving entry points."""

from tpuasr_torch.serve.offline import Recognizer

__all__ = ["Recognizer"]
