"""Capsule-network CTC acoustic model with dynamic routing.

Counterpart of ``tpuasr/models/capsnet.py`` (BASELINE config 4), in eval
and in training mode: a (time, freq) stem conv + batch norm + ReLU,
re-zeroed on padded frames; a primary-capsule conv (with bias) whose
channels split into capsules; squash; routing by agreement to one class
capsule per output class (kernel K8, ``ops.routing.routed_caps``, whose
backward is K8b); capsule lengths times ``logit_scale`` as logits;
log-softmax, zeroed past ``out_lens``. In training the stem's batch norm
takes the statistics of the batch over (B, T', F') with no mask and updates
its running averages with momentum 0.9, as flax's ``nn.BatchNorm``.

The constructor takes the JAX model's keyword arguments under the same
names, so a checkpoint's ``model_kwargs`` carry over, plus ``in_features``
(the mel bins), since ``W_route`` is sized here rather than at first call.
``pallas_routing`` is accepted and changes nothing: on a CUDA device the
routing always runs the K8 kernel, on the CPU its plain version, which is
the JAX einsum + ``dynamic_routing`` path. ``margin_loss`` is the
reference's frame-wise objective; as in the JAX package, nothing calls it.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from tpuasr_torch.models.layers import (BatchNorm, FrontConv, _lecun_normal_,
                                        conv_out_length, frontend_dim,
                                        sequence_mask)
from tpuasr_torch.ops.routing import dynamic_routing, routed_caps, squash
from tpuasr_torch.precision import full_fp32

class CapsNetCTC(nn.Module):
    supports_int8 = False      # no GRU for the predict CLI's --int8

    def __init__(self, num_classes: int, conv_channels: int = 64,
                 primary_caps: int = 16, primary_dim: int = 8,
                 class_dim: int = 16, routing_iters: int = 3,
                 time_stride: int = 2, pallas_routing: bool = False,
                 in_features: int = 64, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.primary_caps = primary_caps
        self.primary_dim = primary_dim
        self.class_dim = class_dim
        self.routing_iters = routing_iters
        self.time_stride = time_stride
        self.in_features = in_features
        self.stem = FrontConv(1, conv_channels, (5, 9), (time_stride, 2),
                              generator=generator)
        self.stem_bn = BatchNorm(conv_channels)
        self.primary = FrontConv(conv_channels, primary_caps * primary_dim,
                                 (3, 9), (1, 2), generator=generator,
                                 bias=True)
        n_in = frontend_dim(in_features, primary_caps)     # F'' * caps
        # flax lecun_normal on (N_in, Din, O*D): fan_in = N_in * Din.
        self.W_route = nn.Parameter(torch.empty(
            (n_in, primary_dim, num_classes * class_dim)))
        _lecun_normal_(self.W_route, n_in * primary_dim, generator)
        self.logit_scale = nn.Parameter(torch.tensor(10.0))
        # Initialized on the CPU, so one seed gives the same weights on any
        # device, then moved.
        if device is not None:
            self.to(device)
        self.eval()

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: torch.Generator | None = None):
        """feats (B, T, F) f32, feat_lens (B,) -> (log_probs (B, T', C),
        out_lens (B,)) with T' = ceil(T / time_stride), padded frames
        zero. ``generator`` is the dropout stream ``Trainer`` passes every
        model; CapsNet has no dropout and leaves it unused."""
        if feats.shape[-1] != self.in_features:
            raise ValueError(f"CapsNetCTC was built for {self.in_features} "
                             f"features per frame, got {feats.shape[-1]}")
        with full_fp32():
            return self._forward(feats, feat_lens)

    def _forward(self, feats, feat_lens):
        x = feats.to(torch.float32)[:, None]              # (B, 1, T, F)
        x = F.relu(self.stem_bn(self.stem(x)))
        out_lens = conv_out_length(feat_lens, 5, self.time_stride, "SAME")
        Tp = x.shape[2]
        # Re-zero padding (the BN bias makes zeros nonzero).
        x = x * sequence_mask(out_lens, Tp)[:, None, :, None]
        x = self.primary(x)                               # (B, caps*dim, T', F'')
        B, _, Tp, Fp = x.shape
        # NHWC order: capsule i = f * caps + cap, channel = cap * dim + d.
        u = x.permute(0, 2, 3, 1).reshape(B, Tp, Fp * self.primary_caps,
                                          self.primary_dim)
        u = squash(u).contiguous()                        # (B, T', N_in, Din)
        v = routed_caps(u, self.W_route, self.num_classes, self.class_dim,
                        self.routing_iters)               # (B, T', C, D)
        caps_len = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-8)
        logp = F.log_softmax(caps_len * self.logit_scale, dim=-1)
        mask = sequence_mask(out_lens, Tp)
        return torch.where(mask[:, :, None], logp, 0.0), out_lens


def margin_loss(caps_len, labels_onehot, m_plus=0.9, m_minus=0.1, lam=0.5):
    """Frame-wise capsule margin loss (tpuasr/models/capsnet.py:116-121):
    caps_len (..., C) and labels_onehot (..., C) -> (...)."""
    pos = torch.clamp(m_plus - caps_len, min=0.0) ** 2
    neg = torch.clamp(caps_len - m_minus, min=0.0) ** 2
    return torch.sum(labels_onehot * pos
                     + lam * (1 - labels_onehot) * neg, dim=-1)


__all__ = ["CapsNetCTC", "dynamic_routing", "margin_loss", "squash"]
