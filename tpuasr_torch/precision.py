"""Float32 without TF32 for the port's plain convolutions and matmuls.

On the card a float32 matmul runs in full float32 by default
(``torch.backends.cuda.matmul.allow_tf32`` is False), but a float32
convolution goes through cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``
is True), which keeps about three decimal digits. The JAX reference runs
both in full float32 (``Precision.HIGHEST`` in the featurizer; lower
precision moves low-energy log-mel values by 0.3-0.6), so the port turns
TF32 off for both around its forward passes and restores the caller's
settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_cudnn
