"""DeepSpeech2-style conv + BiGRU CTC acoustic model.

Counterpart of ``tpuasr/models/deepspeech_ctc.py``: a (time, freq) conv
frontend with total time stride 2, stacked bidirectional GRUs with masked
batch norm, a dense head and log-softmax; padded frames are zeroed after
each norm and in the log-probs. ``bidirectional=False`` stacks one
forward ``GRULayer`` per layer (``rnn{i}.wx``, ``wh``, ``b``; widths
``rnn_hidden`` in and out after the first) and ``explicit_pad`` pads the
convs' time by (5, 5) on both sides (freq (20, 20) and (10, 10)) instead
of XLA SAME, whose split depends on T's parity: the pair is the streaming
model (``serve/streaming.py``, whose GRU layers run K5 from the state the
previous chunk ended in); ``fused_bidir`` is ignored without the second
direction, as in JAX.

The constructor takes the JAX model's keyword arguments under the same
names, so a checkpoint's ``model_kwargs`` carry over. With ``pallas_gru``
the RNN stack follows the JAX kernel path: time-major, streamed in bf16
with ``bf16_gru``, the int8 GRU kernel with ``int8_proj``/``int8_rec``.
In float32 the port serves with the input projection inside the GRU
kernel (K2) whatever ``fused_proj`` says: that is the same math as JAX's
separate projection. ``matmul_frontend`` runs both convs as band-matrix
matmuls; ``int8_conv`` serves conv2 through K9 (int8 tap-GEMM; the
sliding conv, or the band matmuls, in training); ``fused_bidir`` runs
each BiGRU layer as one kernel for both directions (K7, K7b in training)
on its own parameter layout.

bf16 follows JAX's rounding points (``GRULayer``, ``BiGRU``): ``bf16_gru``
rounds x@Wx+b to bf16 outside the scan and runs the bf16 scan K5 (K5b in
training) with ``pallas_gru``, or the f32 scan over the rounded xp
without it; with ``fused_proj`` it runs K2 (K2b) over bf16 x and weights;
with ``fused_bidir`` K7 (K7b) over bf16 projections. ``bf16_conv`` runs
both convs in bf16 (f32 sums, bf16 output; the norms after them take
their statistics in f32 and return f32, as flax's ``nn.BatchNorm``). bf16
features (``TrainConfig.bf16_compute``) make conv1 a bf16 conv whatever
``bf16_conv`` says, as JAX's ``FrontConv`` takes its input's dtype.

``model.train()`` gives the JAX ``train=True`` forward: batch statistics
in every norm (running statistics updated in place), dropout after each
BiGRU drawn from the ``generator`` passed to ``forward``, the int8 flags
ignored (one instance trains and serves int8), and each GRU scan's
backward kernel (K5b, K2b, K7b, in f32 or bf16).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from tpuasr_torch.models.layers import (BatchNorm, BiGRU, FrontConv,
                                        GRULayer, MaskedBatchNorm,
                                        _lecun_normal_,
                                        conv_out_length, flax_dropout,
                                        frontend_dim, sequence_mask)
from tpuasr_torch.precision import full_fp32


class DeepSpeechCTC(nn.Module):
    supports_int8 = True       # the predict CLI's --int8 (K4)

    def __init__(self, num_classes: int, rnn_hidden: int = 512,
                 rnn_layers: int = 4, conv_channels: int = 32,
                 dropout: float = 0.1, axis_name=None,
                 pallas_gru: bool = False, bf16_gru: bool = False,
                 bf16_conv: bool = False, fused_bidir: bool = False,
                 fused_proj: bool = False, int8_proj: bool = False,
                 int8_rec: bool = False, bidirectional: bool = True,
                 explicit_pad: bool = False, matmul_frontend: bool = False,
                 int8_conv: bool = False, in_features: int = 64,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        # A unidirectional stack has no fused pair of directions.
        fused_bidir = fused_bidir and bidirectional
        self.bidirectional = bidirectional
        self.explicit_pad = explicit_pad
        # JAX ignores int8 outside the kernel path (layers.py:117-126).
        int8 = pallas_gru and (int8_proj or int8_rec)
        self.bf16_stream = pallas_gru and bf16_gru
        self.dropout = dropout
        # bf16_gru is JAX's bf16_kernel in every GRU form (layers.py:126,
        # :147-156, :242).
        cd = torch.bfloat16 if bf16_gru else torch.float32
        cdt = torch.bfloat16 if bf16_conv else None
        pad1 = ((5, 5), (20, 20)) if explicit_pad else "SAME"
        pad2 = ((5, 5), (10, 10)) if explicit_pad else "SAME"
        self.conv1 = FrontConv(1, conv_channels, (11, 41), (2, 2),
                               generator=generator,
                               use_matmul=matmul_frontend, padding=pad1,
                               dtype=cdt)
        self.conv1_bn = BatchNorm(conv_channels)
        # int8_conv serves only: FrontConv takes use_matmul_q8 in eval().
        self.conv2 = FrontConv(conv_channels, conv_channels, (11, 21), (1, 2),
                               generator=generator,
                               use_matmul=matmul_frontend,
                               use_matmul_q8=int8_conv, padding=pad2,
                               dtype=cdt)
        self.conv2_bn = BatchNorm(conv_channels)
        d = frontend_dim(in_features, conv_channels)
        for i in range(rnn_layers):
            self.add_module(f"rnn{i}_bn", MaskedBatchNorm(d))
            kw = dict(compute_dtype=cd, int8_proj=int8,
                      int8_rec=int8 and int8_rec,
                      fused_proj=pallas_gru and fused_proj,
                      pallas=pallas_gru, generator=generator)
            if bidirectional:
                self.add_module(f"rnn{i}", BiGRU(d, rnn_hidden,
                                                 fused_bidir=fused_bidir,
                                                 **kw))
                d = 2 * rnn_hidden
            else:
                self.add_module(f"rnn{i}", GRULayer(d, rnn_hidden, **kw))
                d = rnn_hidden
        self.rnn_layers = rnn_layers
        self.head_bn = MaskedBatchNorm(d)
        self.head = nn.Linear(d, num_classes)
        _lecun_normal_(self.head.weight, d, generator)
        with torch.no_grad():
            self.head.bias.zero_()
        # Initialized on the CPU, so one seed gives the same weights on any
        # device, then moved.
        if device is not None:
            self.to(device)
        # Built for inference, as the JAX model's train=False default;
        # model.train() switches to the training forward.
        self.eval()

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                generator: torch.Generator | None = None):
        """feats (B, T, F) f32 (or bf16, ``bf16_compute``), feat_lens (B,)
        -> (log_probs (B, T', C) f32, out_lens (B,)) with T' = ceil(T / 2)
        and padded frames zero. ``generator`` (on feats' device) draws the
        dropout masks in training."""
        with full_fp32():
            return self._forward(feats, feat_lens, generator)

    def conv_frontend(self, feats, feat_lens):
        """The two conv + norm + ReLU layers: feats (B, T, F), feat_lens
        -> (x (T', B, F'*C) f32 time-major, mask_t (T', B, 1) f32,
        out_lens (B,)), padded frames zero."""
        with full_fp32():
            return self._conv_frontend(feats, feat_lens)

    def _conv_frontend(self, feats, feat_lens):
        if feats.dtype != torch.bfloat16:
            feats = feats.to(torch.float32)
        x = feats[:, None]                                # (B, 1, T, F)
        x = F.relu(self.conv1_bn(self.conv1(x)))
        out_lens = conv_out_length(feat_lens, 11, 2, "SAME")
        tmask = sequence_mask(out_lens, x.shape[2])[:, None, :, None]
        x = x * tmask
        x = F.relu(self.conv2_bn(self.conv2(x)))
        x = x * tmask
        B, C, Tp, Fp = x.shape
        # NHWC flatten order (f * C + c), time-major for the RNN stack.
        x = x.permute(2, 0, 3, 1).reshape(Tp, B, Fp * C)
        mask_t = sequence_mask(out_lens, Tp).T[:, :, None].to(torch.float32)
        return x * mask_t, mask_t, out_lens

    def _forward(self, feats, feat_lens, generator=None):
        x, mask_t, out_lens = self._conv_frontend(feats, feat_lens)
        if self.bf16_stream:
            x = x.to(torch.bfloat16)
        for i in range(self.rnn_layers):
            x = getattr(self, f"rnn{i}_bn")(x, mask_t)
            x = getattr(self, f"rnn{i}")(x, mask_t)
            if self.training and self.dropout > 0:
                x = flax_dropout(x, self.dropout, generator)
        x = self.head_bn(x, mask_t)
        logp = F.log_softmax(self.head(x.to(torch.float32)), dim=-1)
        logp = torch.where(mask_t > 0, logp, 0.0)
        return logp.permute(1, 0, 2), out_lens
