"""Decoders: greedy CTC collapse, the all-class beam search (kernel K3, with
shallow LM fusion), the top-P scan search (LM fusion, decoding graphs,
resumable state), the host-side lexicon, WFST and graph builders, the host
first pass over a WFST with its lattices and n-best (``fst_decode``), and
confidence scores (``confidence``).

``ctc_beam_search`` is the all-class kernel search (the JAX package's
``ctc_beam_search_pallas``); the scan search, the JAX package's
``ctc_beam_search``, is ``ctc_beam_search_xla`` here.
"""

from tpuasr_torch.decode.beam import beam_scan, ctc_beam_search
from tpuasr_torch.decode.confidence import align_confidence, beam_posterior
from tpuasr_torch.decode.fst import WFST, lexicon_to_fst, rescore_nbest_fst
from tpuasr_torch.decode.fst_decode import (wfst_ctc_decode,
                                            wfst_ctc_decode_nbest,
                                            wfst_ctc_lattice,
                                            write_lattice_text)
from tpuasr_torch.decode.graph import (GraphTables, compile_graph_tables,
                                       compose, determinize,
                                       graph_tokens_to_words, ngram_to_fst)
from tpuasr_torch.decode.greedy import greedy_decode
from tpuasr_torch.decode.lexicon import Lexicon, LexiconDecoder, SymbolTable
from tpuasr_torch.decode.prefix_beam import (NEG_INF, BeamSearchConfig,
                                             apply_score_bias,
                                             beam_init_state, beam_results)
from tpuasr_torch.decode.prefix_beam import \
    ctc_beam_search as ctc_beam_search_xla


def get_beam_search(impl: str = "auto"):
    """'auto' and 'pallas': the all-class search, which launches the beam
    kernel (K3) for a CUDA tensor and runs its plain version for a CPU
    tensor; 'xla': the top-P scan search (decode/prefix_beam.py), which
    launches the scan-search kernel (K10, the whole frame loop with the
    graph row fetch inside) and the prefix rebuild for a CUDA tensor."""
    if impl in ("auto", "pallas"):
        return ctc_beam_search
    if impl == "xla":
        return ctc_beam_search_xla
    raise ValueError(f"unknown beam impl {impl!r} (tpuasr_torch has 'auto', "
                     "'xla' and 'pallas')")


__all__ = ["BeamSearchConfig", "GraphTables", "Lexicon", "LexiconDecoder",
           "NEG_INF", "SymbolTable", "WFST", "align_confidence",
           "apply_score_bias", "beam_posterior", "beam_scan",
           "beam_init_state", "beam_results", "compile_graph_tables",
           "compose", "ctc_beam_search", "ctc_beam_search_xla",
           "determinize", "get_beam_search", "graph_tokens_to_words",
           "greedy_decode", "lexicon_to_fst", "ngram_to_fst",
           "rescore_nbest_fst", "wfst_ctc_decode", "wfst_ctc_decode_nbest",
           "wfst_ctc_lattice", "write_lattice_text"]
