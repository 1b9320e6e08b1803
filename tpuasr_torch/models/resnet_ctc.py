"""ResNet-CTC acoustic model (BASELINE config 2).

Counterpart of ``tpuasr/models/resnet_ctc.py``, in eval and in training
mode: a 5x5 stem conv with time stride 2 and freq stride 2, batch norm and
ReLU; residual stages of two 3x3 convs with batch norm, the first block of
every stage after the first striding freq by 2, a 1x1 projection with its
norm where the channels or the freq stride change; the remaining freq axis
folded into channels; dropout; a dense head, log-softmax, and zeros past
``out_lens``. Padded frames are re-zeroed after the stem, between the two
convs of a block and after each block: a norm's bias turns padded zeros
into a constant that the next conv would carry into valid frames.

The convs are cuDNN's ``F.conv2d`` in float32 with TF32 off
(``precision.full_fp32``), after an explicit pad with flax's SAME split
(the extra pad on the high side, ``layers._same_pad``): at config 2's
shape the stem pads (1, 2) on both axes and every freq-stride-2 3x3 conv
(0, 1) along freq, which no symmetric ``padding=`` of ``F.conv2d`` gives.
The modules keep flax's names (``stem``, ``stem_bn``,
``stage{si}_block{bi}.conv1/bn1/conv2/bn2/proj/bn_proj``, ``head``), so
``tpuasr_torch.convert`` maps a Flax checkpoint with its general rules.

The constructor takes the JAX model's keyword arguments under the same
names, plus ``in_features`` (the features per frame, which size the head:
the freq width after the stem and the stage strides times the last
stage's channels, 4 x 256 = 1024 at 64 mels) and ``generator`` (a seeded
flax-style init). In training (``model.train()``) the norms take the
batch's statistics over (B, T', F') with no mask, as flax's
``nn.BatchNorm``, and dropout draws its mask from the ``generator`` passed
to ``forward``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from tpuasr_torch.models.layers import (BatchNorm, FrontConv, _lecun_normal_,
                                        conv_out_length, flax_dropout,
                                        sequence_mask)
from tpuasr_torch.precision import full_fp32


class ResBlock(nn.Module):
    """Two 3x3 convs with batch norm, and the projected shortcut where the
    channels or the freq stride change (resnet_ctc.py:23-47). NCHW."""

    def __init__(self, in_channels: int, channels: int, freq_stride: int = 1,
                 generator=None):
        super().__init__()
        self.conv1 = FrontConv(in_channels, channels, (3, 3),
                               (1, freq_stride), generator=generator)
        self.bn1 = BatchNorm(channels)
        self.conv2 = FrontConv(channels, channels, (3, 3), (1, 1),
                               generator=generator)
        self.bn2 = BatchNorm(channels)
        self.proj = self.bn_proj = None
        if in_channels != channels or freq_stride != 1:
            self.proj = FrontConv(in_channels, channels, (1, 1),
                                  (1, freq_stride), generator=generator)
            self.bn_proj = BatchNorm(channels)

    def forward(self, x: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x))) * tmask
        y = self.bn2(self.conv2(y))
        if self.proj is not None:
            x = self.bn_proj(self.proj(x))
        return F.relu(x + y) * tmask


class ResNetCTC(nn.Module):
    supports_int8 = False      # no GRU for the predict CLI's --int8

    def __init__(self, num_classes: int, stem_channels: int = 32,
                 stage_channels: Sequence[int] = (32, 64, 128, 256),
                 blocks_per_stage: int = 2, time_stride: int = 2,
                 dropout: float = 0.1, in_features: int = 64, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.time_stride = time_stride
        self.dropout = dropout
        self.in_features = in_features
        self.stem = FrontConv(1, stem_channels, (5, 5), (time_stride, 2),
                              generator=generator)
        self.stem_bn = BatchNorm(stem_channels)
        self.blocks = []
        ch, width = stem_channels, -(-in_features // 2)
        for si, out_ch in enumerate(stage_channels):
            for bi in range(blocks_per_stage):
                fs = 2 if (bi == 0 and si > 0) else 1
                name = f"stage{si}_block{bi}"
                self.add_module(name, ResBlock(ch, out_ch, fs, generator))
                self.blocks.append(name)
                ch, width = out_ch, -(-width // fs)
        d = width * ch
        self.head = nn.Linear(d, num_classes)
        _lecun_normal_(self.head.weight, d, generator)
        with torch.no_grad():
            self.head.bias.zero_()
        # Initialized on the CPU, so one seed gives the same weights on any
        # device, then moved.
        if device is not None:
            self.to(device)
        self.eval()

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: torch.Generator | None = None):
        """feats (B, T, F) f32, feat_lens (B,) -> (log_probs (B, T', C),
        out_lens (B,)) with T' = ceil(T / time_stride) and padded frames
        zero. ``generator`` (on feats' device) draws the dropout mask in
        training."""
        if feats.shape[-1] != self.in_features:
            raise ValueError(f"ResNetCTC was built for {self.in_features} "
                             f"features per frame, got {feats.shape[-1]}")
        with full_fp32():
            return self._forward(feats, feat_lens, generator)

    def _forward(self, feats, feat_lens, generator):
        x = feats.to(torch.float32)[:, None]              # (B, 1, T, F)
        x = F.relu(self.stem_bn(self.stem(x)))
        out_lens = conv_out_length(feat_lens, 5, self.time_stride, "SAME")
        Tp = x.shape[2]
        tmask = sequence_mask(out_lens, Tp)[:, None, :, None].to(x.dtype)
        x = x * tmask
        for name in self.blocks:
            x = getattr(self, name)(x, tmask)
        # NHWC flatten order (f * C + c), as the Flax head's kernel reads it.
        B, C, _, Fp = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, Tp, Fp * C)
        if self.training and self.dropout > 0:
            x = flax_dropout(x, self.dropout, generator)
        logp = F.log_softmax(self.head(x), dim=-1)
        mask = sequence_mask(out_lens, Tp)
        return torch.where(mask[:, :, None], logp, 0.0), out_lens


__all__ = ["ResBlock", "ResNetCTC"]
