"""Language models: the backoff n-gram (ARPA) behind shallow fusion in the
beam search and host n-best rescoring (see lm/ngram.py)."""

from tpuasr_torch.lm.ngram import (BOS, EOS, UNK, NGramLM, rescore_nbest,
                                   train_ngram)

__all__ = ["NGramLM", "train_ngram", "rescore_nbest", "BOS", "EOS", "UNK"]
