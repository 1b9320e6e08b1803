"""The host C++ layer: the repository's ``native/*.cc`` built at first use
into ``build/tpuasr_torch/`` (``build.py``) and bound by ctypes. The host
CTC decoders (``ctc_host.py``) and the multithreaded wav reader
(``wav_batch.py``) live here; the WFST first pass is
``tpuasr_torch.decode.fst_decode``. Counterpart of ``tpuasr/native/``,
whose libraries are built by ``make`` inside ``native/``: this package
never writes there.
"""

from tpuasr_torch.native.ctc_host import (ctc_beam_search_host,
                                          ctc_greedy_host, edit_distance_host)
from tpuasr_torch.native.wav_batch import load_wav_batch

__all__ = ["ctc_beam_search_host", "ctc_greedy_host", "edit_distance_host",
           "load_wav_batch"]
