"""Corpus preparation: corpus artifacts into the JSON-lines manifests that
``tpuasr_torch.data`` reads; the port's copy of ``tpuasr/data/corpus``."""

from tpuasr_torch.data.corpus.kaldi_dir import prepare_kaldi_dir

__all__ = ["prepare_kaldi_dir"]
