"""Serving entry points: offline batches (``Recognizer``) and streams
(``StreamingRecognizer``, ``BatchedStreamingRecognizer``)."""

from tpuasr_torch.serve.offline import Recognizer
from tpuasr_torch.serve.streaming import (BatchedStreamingRecognizer,
                                          StreamingRecognizer)

__all__ = ["BatchedStreamingRecognizer", "Recognizer",
           "StreamingRecognizer"]
