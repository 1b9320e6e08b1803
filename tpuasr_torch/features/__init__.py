"""Featurizers: wav -> framed power spectrum -> log-mel fbank / MFCC ->
CMVN."""

from tpuasr_torch.features.functional import (dct_matrix, hz_to_mel,
                                              lifter_vector, mel_filterbank,
                                              mel_to_hz, next_pow2,
                                              rdft_matrices, window_vector)
from tpuasr_torch.features.fused import FusedFeaturizer, fbank_power
from tpuasr_torch.features.reference import (FeatureConfig, Featurizer,
                                             num_frames)

__all__ = ["FeatureConfig", "Featurizer", "FusedFeaturizer", "dct_matrix",
           "fbank_power", "hz_to_mel", "lifter_vector", "mel_filterbank",
           "mel_to_hz", "next_pow2", "num_frames", "rdft_matrices",
           "window_vector"]
