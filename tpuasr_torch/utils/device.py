"""The device rule of every entry point: the card unless the caller asks
for the CPU, and never a quiet move from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where CUDA is absent
    is a ``RuntimeError``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
