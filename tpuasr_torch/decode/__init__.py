"""Decoders: greedy CTC collapse and the all-class CTC prefix beam search."""

from tpuasr_torch.decode.beam import beam_scan, ctc_beam_search
from tpuasr_torch.decode.greedy import greedy_decode
from tpuasr_torch.decode.prefix_beam import NEG_INF, BeamSearchConfig


def get_beam_search(impl: str = "auto"):
    """'auto' returns the all-class search, which launches the beam kernel
    for a CUDA tensor and runs its plain version for a CPU tensor. The
    scan-based 'xla' search is not ported yet."""
    if impl == "auto":
        return ctc_beam_search
    raise ValueError(f"unknown beam impl {impl!r} (tpuasr_torch has 'auto')")


__all__ = ["BeamSearchConfig", "NEG_INF", "beam_scan", "ctc_beam_search",
           "get_beam_search", "greedy_decode"]
