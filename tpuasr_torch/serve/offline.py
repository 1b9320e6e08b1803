"""Offline batch recognition: padded wav batch -> features -> AM -> tokens.

The pipeline that ``bench.py`` times in the JAX package (bench.py:111-120),
as one call on one device: ``FusedFeaturizer``, the acoustic model, then
the CTC beam search (or greedy decoding). On a CUDA device every stage with
a kernel launches it; a requested device that is absent is an error, never
a quiet move to the CPU.
"""

from __future__ import annotations

import torch

from tpuasr_torch.decode import BeamSearchConfig, ctc_beam_search, greedy_decode
from tpuasr_torch.features import FeatureConfig, FusedFeaturizer
from tpuasr_torch.features.reference import as_batch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


class Recognizer:
    """Recognizer(model, feat_cfg, beam_cfg, device)(wav, lengths) -> dict.

    ``beam_cfg=None`` decodes greedily. The result holds tokens
    (B, n_best, L) int32 padded with -1, token_lens (B, n_best), scores
    (beam only), log_probs (B, T', C) and out_lens (B,).
    """

    def __init__(self, model: torch.nn.Module, feat_cfg: FeatureConfig,
                 beam_cfg: BeamSearchConfig | None, device="cuda",
                 n_best: int = 1):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.featurizer = FusedFeaturizer(feat_cfg, self.device)
        self.beam_cfg = beam_cfg
        self.n_best = n_best

    @torch.inference_mode()
    def __call__(self, wav, lengths=None) -> dict:
        wav, lengths, _ = as_batch(wav, lengths, self.device)
        feats, flens = self.featurizer.featurize(wav, lengths)
        logp, out_lens = self.model(feats, flens)
        if self.beam_cfg is None:
            toks, tok_lens = greedy_decode(logp, out_lens)
            out = dict(tokens=toks[:, None], token_lens=tok_lens[:, None],
                       scores=None)
        else:
            out = ctc_beam_search(logp, out_lens, self.beam_cfg,
                                  n_best=self.n_best)
        out.update(log_probs=logp, out_lens=out_lens, feat_lens=flens)
        return out
