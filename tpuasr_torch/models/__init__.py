"""Acoustic models (inference), by the JAX package's registry names.

Common contract, as in ``tpuasr.models``:

    model(feats (B, T, F), feat_lens (B,)) -> (log_probs (B, T', C), out_lens)
"""

from tpuasr_torch.models.capsnet import CapsNetCTC
from tpuasr_torch.models.deepspeech_ctc import DeepSpeechCTC
from tpuasr_torch.models.resnet_ctc import ResNetCTC

MODEL_REGISTRY = {
    "resnet_ctc": ResNetCTC,
    "deepspeech_ctc": DeepSpeechCTC,
    "deepspeech_var": DeepSpeechCTC,   # variant: configured via kwargs
    "capsule1": CapsNetCTC,
}


def create_model(name: str, num_classes: int, **kwargs):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; tpuasr_torch has "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](num_classes=num_classes, **kwargs)


__all__ = ["CapsNetCTC", "DeepSpeechCTC", "MODEL_REGISTRY", "ResNetCTC",
           "create_model"]
