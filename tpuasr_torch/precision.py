"""Float32 without TF32 for the port's plain convolutions and matmuls.

On the card a float32 matmul runs in full float32 by default
(``torch.backends.cuda.matmul.allow_tf32`` is False), but a float32
convolution goes through cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``
is True), which keeps about three decimal digits. The JAX reference runs
both in full float32 (``Precision.HIGHEST`` in the featurizer; lower
precision moves low-energy log-mel values by 0.3-0.6), so the port turns
TF32 off for both around its forward passes and restores the caller's
settings afterwards.

``deterministic_cudnn`` asks cuDNN for its deterministic algorithms; the
port's conv backward runs under it (``models.layers._Conv2d``).

``full_fp32(bf16_sums=True)`` also keeps cuBLAS's bf16 matmuls summing in
float32 throughout: ``allow_bf16_reduced_precision_reduction``
(``torch.backends.cuda.matmul``) is True by default and lets a split
reduction round its partial sums, where JAX's bf16 products
(``preferred_element_type`` f32 on the TPU's MXU) round only the result.
The rule: training sums in full, serving does not. ``Trainer.train_step``
is the one caller that asks, around its forward and backward, so every
bf16 product of a training step sums in f32; serving and
``Trainer.evaluate`` keep cuBLAS's default, and the bf16 serving arms keep
their bits.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32(bf16_sums: bool = False):
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if bf16_sums:
        mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = prev


@contextlib.contextmanager
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev

