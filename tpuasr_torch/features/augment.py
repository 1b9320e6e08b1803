"""SpecAugment (Park et al., 2019, arXiv:1904.08779) on the device: the
port's counterpart of ``tpuasr/features/augment.py``.

Split in two so that a test can feed JAX's own random numbers to the
masks: ``draw_spec_augment`` draws them from a torch generator, and
``apply_spec_augment`` builds the masks from them exactly as JAX does, in
its float32 arithmetic. Per utterance: ``freq_masks`` frequency bands of
width w ~ U{0..freq_width} starting at int32(u * max(F - w, 1)), and
``time_masks`` time spans of width int32(u1 * (int32(time_frac * flens) +
1)) starting at int32(u2 * max(flens - w, 1)), inside the valid frames
(padding is already zero and stays so). Masked cells are multiplied by 0,
as JAX multiplies by the mask (so -x becomes -0.0).

Applied by ``Trainer._loss_fn`` with ``TrainConfig.spec_augment``, in
training only.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SpecAugmentDraw:
    """The random numbers of one batch (B utterances)."""

    freq_w: torch.Tensor      # (freq_masks, B) int32 widths in [0, freq_width]
    freq_u: torch.Tensor      # (freq_masks, B) float32 in [0, 1): the start
    time_u: torch.Tensor      # (time_masks, 2, B) float32: width, start


def draw_spec_augment(batch: int, generator: torch.Generator, *,
                      freq_masks: int = 2, freq_width: int = 12,
                      time_masks: int = 2, device=None) -> SpecAugmentDraw:
    """The masks' random numbers, on ``device`` (the generator's)."""
    device = device if device is not None else generator.device
    kw = dict(generator=generator, device=device)
    return SpecAugmentDraw(
        freq_w=torch.randint(0, freq_width + 1, (freq_masks, batch), **kw,
                             dtype=torch.int32),
        freq_u=torch.rand((freq_masks, batch), **kw, dtype=torch.float32),
        time_u=torch.rand((time_masks, 2, batch), **kw, dtype=torch.float32))


def apply_spec_augment(feats: torch.Tensor, flens: torch.Tensor,
                       draw: SpecAugmentDraw,
                       time_frac: float = 0.05) -> torch.Tensor:
    """feats (B, T, F), flens (B,) -> masked feats (same shape and dtype)."""
    B, T, F = feats.shape
    dev = feats.device
    f_iota = torch.arange(F, device=dev)[None, None, :]
    t_iota = torch.arange(T, device=dev)[None, :, None]
    keep = torch.ones((B, T, F), dtype=torch.bool, device=dev)
    for w, u in zip(draw.freq_w.to(dev), draw.freq_u.to(dev)):
        w = w.to(torch.int32)
        f0 = (u * torch.clamp(F - w, min=1).to(torch.float32)).to(torch.int32)
        w, f0 = w[:, None, None], f0[:, None, None]
        keep &= ~((f_iota >= f0) & (f_iota < f0 + w))
    fl = flens.to(dev, torch.int32)
    frac = torch.tensor(time_frac, dtype=torch.float32, device=dev)
    max_w = (frac * fl.to(torch.float32)).to(torch.int32)
    for u1, u2 in draw.time_u.to(dev):
        w = (u1 * (max_w + 1).to(torch.float32)).to(torch.int32)
        span = torch.clamp(fl - w, min=1)
        t0 = (u2 * span.to(torch.float32)).to(torch.int32)
        w, t0 = w[:, None, None], t0[:, None, None]
        keep &= ~((t_iota >= t0) & (t_iota < t0 + w))
    return feats * keep.to(feats.dtype)


def spec_augment(feats, flens, generator: torch.Generator, *,
                 freq_masks: int = 2, freq_width: int = 12,
                 time_masks: int = 2, time_frac: float = 0.05):
    """Draw, then apply: JAX's ``spec_augment`` with a torch generator in
    place of its key."""
    draw = draw_spec_augment(feats.shape[0], generator,
                             freq_masks=freq_masks, freq_width=freq_width,
                             time_masks=time_masks, device=feats.device)
    return apply_spec_augment(feats, flens, draw, time_frac=time_frac)
