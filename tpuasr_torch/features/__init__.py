"""Featurizers: wav -> framed power spectrum -> log-mel fbank -> CMVN."""

from tpuasr_torch.features.fused import FusedFeaturizer, fbank_power
from tpuasr_torch.features.reference import (FeatureConfig, Featurizer,
                                             num_frames)

__all__ = ["FeatureConfig", "Featurizer", "FusedFeaturizer", "fbank_power",
           "num_frames"]
