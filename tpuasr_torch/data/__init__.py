"""Host-side data: JSON-lines manifests, length buckets, the bucketed
batch loader and the synthetic tone and word corpora, copies of
``tpuasr/data/{manifest,bucketing,loader,synthetic}.py``; the native wav
reader (``native_wav.py``) and the device-resident corpus
(``device_corpus.py``)."""

from tpuasr_torch.data.bucketing import BucketSpec, make_buckets
from tpuasr_torch.data.loader import AudioLoader, LoaderConfig
from tpuasr_torch.data.manifest import (Utterance, load_wav, read_manifest,
                                        write_manifest)
from tpuasr_torch.data.synthetic import (SyntheticCorpus, WordCorpus,
                                        make_synthetic_corpus,
                                        make_word_corpus)

__all__ = ["AudioLoader", "BucketSpec", "LoaderConfig", "SyntheticCorpus",
           "Utterance", "WordCorpus", "load_wav", "make_buckets",
           "make_synthetic_corpus", "make_word_corpus", "read_manifest",
           "write_manifest"]
