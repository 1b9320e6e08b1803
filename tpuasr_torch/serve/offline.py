"""Offline batch recognition: padded wav batch -> features -> AM -> tokens.

The pipeline that ``bench.py`` times in the JAX package (bench.py:111-120
and, with a decoding graph, :213-225), as one call on one device:
``FusedFeaturizer``, the acoustic model, then greedy decoding, the CTC beam
search (optionally with shallow LM fusion), or the graph-constrained scan
search. On a CUDA device every stage with a kernel launches it; a requested
device that is absent is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import torch

from tpuasr_torch.cli.common import run_beam_search
from tpuasr_torch.decode import (BeamSearchConfig, GraphTables,
                                 ctc_beam_search_xla, greedy_decode)
from tpuasr_torch.features import FeatureConfig, FusedFeaturizer
from tpuasr_torch.features.reference import as_batch
from tpuasr_torch.utils.device import resolve_device

__all__ = ["Recognizer", "resolve_device"]


class Recognizer:
    """Recognizer(model, feat_cfg, beam_cfg, device)(wav, lengths) -> dict.

    ``beam_cfg=None`` decodes greedily. ``lm_tables``: shallow-fusion
    kwargs of the beam search (``cli.common.fusion_tables``: lm_bigram or
    lm_trigram, and lm_eos), weighted by beam_cfg.lm_weight and searched by
    ``beam_impl`` ('auto'/'pallas': the all-class kernel search; 'xla': the
    top-P scan search). ``graph``: GraphTables; the scan search then runs
    under the graph's constraint, with beam_cfg.class_topk classes per beam.
    Tables are moved to the device once, here. The result holds tokens
    (B, n_best, L) int32 padded with -1, token_lens (B, n_best), scores
    (beam only; with a graph also reached_final), log_probs (B, T', C) and
    out_lens (B,).
    """

    def __init__(self, model: torch.nn.Module, feat_cfg: FeatureConfig,
                 beam_cfg: BeamSearchConfig | None, device="cuda",
                 n_best: int = 1, beam_impl: str = "auto",
                 lm_tables: dict | None = None,
                 graph: GraphTables | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.featurizer = FusedFeaturizer(feat_cfg, self.device)
        if beam_cfg is None and (lm_tables or graph is not None):
            raise ValueError("LM fusion and graph decoding need a beam_cfg")
        self.beam_cfg = beam_cfg
        self.n_best = n_best
        self.beam_impl = beam_impl
        self.lm_tables = {k: torch.as_tensor(v, device=self.device)
                          .to(torch.float32)
                          for k, v in (lm_tables or {}).items()}
        self.graph = None
        if graph is not None:
            self.graph = GraphTables(
                torch.as_tensor(graph.next_state, device=self.device)
                .to(torch.int32),
                torch.as_tensor(graph.cost, device=self.device)
                .to(torch.float32),
                torch.as_tensor(graph.final, device=self.device)
                .to(torch.float32), start=graph.start)

    @torch.inference_mode()
    def __call__(self, wav, lengths=None) -> dict:
        wav, lengths, _ = as_batch(wav, lengths, self.device)
        feats, flens = self.featurizer.featurize(wav, lengths)
        logp, out_lens = self.model(feats, flens)
        if self.beam_cfg is None:
            toks, tok_lens = greedy_decode(logp, out_lens)
            out = dict(tokens=toks[:, None], token_lens=tok_lens[:, None],
                       scores=None)
        elif self.graph is not None:
            out = ctc_beam_search_xla(logp, out_lens, self.beam_cfg,
                                      n_best=self.n_best, graph=self.graph,
                                      **self.lm_tables)
        else:
            out = run_beam_search(self.beam_impl, logp, out_lens,
                                  self.beam_cfg, self.n_best,
                                  **self.lm_tables)
        out.update(log_probs=logp, out_lens=out_lens, feat_lens=flens)
        return out
