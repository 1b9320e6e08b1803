"""Host-side data: JSON-lines manifests, length buckets and the bucketed
batch loader, copies of ``tpuasr/data/{manifest,bucketing,loader}.py``."""

from tpuasr_torch.data.bucketing import BucketSpec, make_buckets
from tpuasr_torch.data.loader import AudioLoader, LoaderConfig
from tpuasr_torch.data.manifest import (Utterance, load_wav, read_manifest,
                                        write_manifest)

__all__ = ["AudioLoader", "BucketSpec", "LoaderConfig", "Utterance",
           "load_wav", "make_buckets", "read_manifest", "write_manifest"]
