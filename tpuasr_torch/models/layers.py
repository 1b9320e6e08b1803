"""Sequence-model building blocks (masking-aware), for serving and training.

Counterpart of ``tpuasr/models/layers.py``. Parameters keep the JAX names
and layouts except where PyTorch's own ops need another (conv kernels are
OIHW here, HWIO in JAX; see ``tpuasr_torch.convert``). The norms follow
flax's training semantics (``module.train()``): batch statistics with the
biased variance, running statistics updated in place as
``0.9 * running + 0.1 * batch``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from tpuasr_torch.ops.conv import conv_taps_q8
from tpuasr_torch.ops.gru import (gru_scan, gru_scan_bidir, gru_scan_xfused,
                                  gru_scan_xfused_q8)
from tpuasr_torch.ops.quant import quantize_per_channel
from tpuasr_torch.precision import deterministic_cudnn, full_fp32


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B,) -> (B, T) bool."""
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths[:, None])


def conv_out_length(lengths, kernel: int, stride: int, padding):
    """Output length of a strided conv along time: 'SAME' gives
    ceil(L / stride); an int p gives floor((L + 2p - k) / stride) + 1."""
    if padding == "SAME":
        return -(-lengths // stride)
    p = padding if isinstance(padding, int) else 0
    return (lengths + 2 * p - kernel) // stride + 1


def frontend_dim(in_features: int, conv_channels: int) -> int:
    """Features per frame after the two freq-stride-2 SAME convs."""
    return -(-(-(-in_features // 2)) // 2) * conv_channels


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME padding split (the extra pad on the high side)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def flax_dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep with 1 - rate, scale kept
    values by 1 / (1 - rate); the mask from ``generator`` (on x's
    device)."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), device=x.device))


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    # flax's lecun_normal: truncated normal at +-2 sigma, variance 1/fan_in,
    # sigma corrected for the truncation.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d(x, w, b, stride)`` whose backward runs cuDNN's
    deterministic algorithms, and only the backward: cuDNN's default
    weight-gradient algorithm sums in an order that changes from run to run
    (two straight train steps came out up to 6.2e-6 apart), JAX's step
    repeats. The forward keeps cuDNN's default choice."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = list(stride)
        ctx.bias = b is not None
        return F.conv2d(x, w, b, stride=stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with deterministic_cudnn():
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, w, [w.shape[0]] if ctx.bias else None, ctx.stride,
                [0, 0], [1, 1], False, [0, 0], 1,
                [need[0], need[1], ctx.bias and need[2]])
        return dx, dw, db, None


def conv2d(x, w, b, stride):
    """``F.conv2d`` without padding; under autograd through ``_Conv2d``, so
    that the train step repeats bit for bit."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv2d.apply(x, w, b, tuple(stride))
    return F.conv2d(x, w, b, stride=stride)


class FrontConv(nn.Module):
    """2-D conv over (time, freq), without a bias unless ``bias=True``
    (flax ``nn.Conv``'s default, zero-initialized). ``padding`` is "SAME"
    (XLA's split, the extra pad on the high side) or explicit
    ((t_lo, t_hi), (f_lo, f_hi)), as JAX's ``padding=[(5, 5), (20, 20)]``
    of the streaming DeepSpeech (deepspeech_ctc.py:63-64).

    Input and output are NCHW (B, C, T, F); ``weight`` is OIHW
    (Cout, Cin, Kt, Kf). The model runs it under ``precision.full_fp32``;
    in training its backward takes cuDNN's deterministic algorithms
    (``_Conv2d``).

    ``dtype`` is JAX's (layers.py:337-341): x and the weight are cast to it
    (the input's dtype when None) and the output comes back in it; a bf16
    conv (``bf16_conv``, or a bf16 input) sums in f32 and rounds its output
    to bf16, in every formulation.

    As JAX's ``FrontConv`` (layers.py:285-379), two formulations over the
    same weight: ``use_matmul`` runs Kt shifted f32 matmuls of the
    (B, T, F*Cin) rows against per-tap freq-Toeplitz band matrices;
    ``use_matmul_q8`` quantizes the band matrices per output column on
    each call and runs K9 (``ops.conv.conv_taps_q8``, time stride 1).
    ``use_matmul_q8`` serves only: in training (``train()``) the module
    takes ``use_matmul`` or the sliding conv, as the JAX model passes
    ``int8_conv and not train`` (deepspeech_ctc.py:75-78).
    """

    def __init__(self, in_channels: int, features: int, kernel_size, strides,
                 generator=None, bias: bool = False, use_matmul: bool = False,
                 use_matmul_q8: bool = False, padding="SAME", dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = (padding if padding == "SAME"
                        else tuple(tuple(p) for p in padding))
        self.use_matmul = use_matmul
        self.use_matmul_q8 = use_matmul_q8
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels, *self.kernel_size)))
        fan_in = in_channels * self.kernel_size[0] * self.kernel_size[1]
        _lecun_normal_(self.weight, fan_in, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    @staticmethod
    def band_matrices(w, F, F_out, Kf, sf, pf_lo):
        """(Kt, Kf, Cin, Cout) HWIO kernel -> (Kt, F*Cin, F_out*Cout)
        per-tap band matrices, JAX's layout (layers.py:317-331):
        M[t, (fi, ci), (fo, co)] = w[t, fi - fo*sf + pf_lo, ci, co] where
        that tap index is valid, else 0 (the zero freq padding)."""
        Kt = w.shape[0]
        fi = torch.arange(F, device=w.device)[:, None]
        fo = torch.arange(F_out, device=w.device)[None, :]
        d = fi - fo * sf + pf_lo                          # (F, F_out)
        valid = (d >= 0) & (d < Kf)
        wt = torch.where(valid[None, :, :, None, None],
                         w[:, d.clamp(0, Kf - 1)], 0.0)   # (Kt,F,Fo,Ci,Co)
        return wt.permute(0, 1, 3, 2, 4).reshape(
            Kt, F * w.shape[2], F_out * w.shape[3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kt, kf), (st, sf) = self.kernel_size, self.strides
        if self.padding == "SAME":
            pt = _same_pad(x.shape[2], kt, st)
            pf = _same_pad(x.shape[3], kf, sf)
        else:
            pt, pf = self.padding
        q8 = self.use_matmul_q8 and not self.training
        dt = self.dtype or x.dtype
        x = x.to(dt)
        weight = self.weight.to(dt)
        if not (self.use_matmul or q8):
            x = F.pad(x, (pf[0], pf[1], pt[0], pt[1]))
            bias = None if self.bias is None else self.bias.to(dt)
            return conv2d(x, weight, bias, (st, sf))
        B, Cin, T, Fq = x.shape
        Cout = self.weight.shape[0]
        T_out = (T + pt[0] + pt[1] - kt) // st + 1
        F_out = (Fq + pf[0] + pf[1] - kf) // sf + 1
        N = F_out * Cout
        w = weight.permute(2, 3, 1, 0)                    # HWIO
        # NHWC rows with the freq and channel axes flattened f * Cin + c.
        xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, 0, pt[0], pt[1]))
        xf = xp.reshape(B, T + pt[0] + pt[1], Fq * Cin)
        if q8:
            if st != 1:
                raise ValueError("use_matmul_q8 needs time stride 1 "
                                 "(ops/conv.py)")
            if (Fq * Cin) % 128 or N % 128:
                raise ValueError(f"use_matmul_q8 needs lane-aligned dims, "
                                 f"got K={Fq * Cin}, N={N}")
            # JAX quantizes the f32 kernel, whatever dtype the conv has.
            m = self.band_matrices(self.weight.permute(2, 3, 1, 0).to(
                torch.float32), Fq, F_out, kf, sf, pf[0])
            mq, sw = quantize_per_channel(m.reshape(-1, N))
            out = conv_taps_q8(xf.to(torch.float32).contiguous(),
                               mq.reshape(kt, Fq * Cin, N), sw, T_out)
        else:
            # f32 sums of each tap's products (exact for bf16 operands),
            # rounded to dt once at the end, as JAX's dot_general with
            # preferred_element_type f32 (layers.py:371-379).
            m = self.band_matrices(w, Fq, F_out, kf, sf, pf[0])
            out = x.new_zeros((B, T_out, N), dtype=torch.float32)
            for t in range(kt):
                xs = xf[:, t:t + (T_out - 1) * st + 1:st]
                out = out + xs.to(torch.float32) @ m[t].to(torch.float32)
        out = out.reshape(B, T_out, F_out, Cout).permute(0, 3, 1, 2).to(dt)
        if self.bias is not None:
            out = out + self.bias.to(dt)[None, :, None, None]
        return out


def _update_running(norm: nn.Module, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """running = momentum * running + (1 - momentum) * batch, as flax."""
    with torch.no_grad():
        m = norm.momentum
        norm.mean.copy_(m * norm.mean + (1 - m) * mean)
        norm.var.copy_(m * norm.var + (1 - m) * var)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over channel dim 1 of an NCHW tensor:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias. In training the
    statistics are over (B, T, F) with no mask -- padded frames count, as
    flax has no mask -- and the variance is flax's fast form
    max(0, E[x^2] - E[x]^2), biased."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, T, F) f32, or bf16 (a bf16 conv's output): flax takes
        the statistics in f32 and promotes the output with its f32 scale
        and bias, so it comes back f32."""
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            _update_running(self, mean.detach(), var.detach())
            mul = torch.rsqrt(var + self.epsilon) * self.scale
            return ((x - mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        return ((x - self.mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class MaskedBatchNorm(nn.Module):
    """Batch norm over the two leading (time, batch) dims that ignores
    padding: in training the statistics are over the frames where ``mask``
    (same leading dims, trailing 1 allowed) is set, the variance biased
    (tpuasr/models/layers.py:59-75); inference uses the running statistics
    and needs no mask. Math in f32, output cast back to the input dtype."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if self.training:
            if mask is None:
                raise ValueError("MaskedBatchNorm needs the mask in training")
            m = mask.to(torch.float32).reshape(*x.shape[:2], 1)
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (x32 * m).sum(dim=(0, 1)) / cnt
            var = ((x32 - mean) ** 2 * m).sum(dim=(0, 1)) / cnt
            _update_running(self, mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class GRULayer(nn.Module):
    """Unidirectional GRU over time-major (T, B, D) input, gate order
    r, z, n; padded steps freeze the state and come out as zeros.

    One route a call, in ``compute_dtype`` (f32, or bf16: JAX's
    ``bf16_kernel``), in training (``train()``, the int8 flags ignored as
    in JAX, deepspeech_ctc.py:119-120) and serving (``eval()``) alike:

    * serving with ``int8_proj``: K4 (``gru_scan_xfused_q8``), the weights
      quantized per output channel on each call as in JAX (``int8_rec``
      also quantizes wh);
    * ``fused_proj``, and every f32 serving call: K2 (``gru_scan_xfused``,
      K2b backward) over x, wx and wh in ``compute_dtype`` and b in f32
      (layers.py:142-146); f32 serving without ``fused_proj`` is the same
      math as JAX's separate projection;
    * otherwise xp = x@Wx + b by a matmul, in bf16 rounded by the product
      and again by the sum (layers.py:147-156), then ``gru_scan`` (K5, K5b
      backward) with wh in ``compute_dtype``; without ``pallas``
      (``pallas_gru=False``, JAX's lax.scan, layers.py:168-185) the f32
      scan over xp's upcast with the f32 wh.

    Streaming (``serve/streaming.py``) runs a layer's weights chunk by
    chunk instead: xp = x@Wx+b by a matmul, then K5 (``gru_scan_fwd``) from
    the state the previous chunk ended in (its ``h0``), serving only.
    """

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 compute_dtype=torch.float32, int8_proj: bool = False,
                 int8_rec: bool = False, fused_proj: bool = True,
                 generator=None, pallas: bool = True):
        super().__init__()
        self.reverse = reverse
        self.fused_proj = fused_proj
        self.pallas = pallas
        self.compute_dtype = compute_dtype
        self.int8_proj = int8_proj or int8_rec
        self.int8_rec = int8_rec
        self.wx = nn.Parameter(torch.empty((in_features, 3 * hidden)))
        self.wh = nn.Parameter(torch.empty((hidden, 3 * hidden)))
        self.b = nn.Parameter(torch.zeros(3 * hidden))
        _lecun_normal_(self.wx, in_features, generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.wh, generator=generator)

    def forward(self, x: torch.Tensor, mask_t: torch.Tensor) -> torch.Tensor:
        """x (T, B, D), mask_t (T, B, 1) f32 -> (T, B, H) in x's dtype."""
        cd = self.compute_dtype
        if self.int8_proj and not self.training:
            xc = x.to(cd).contiguous()
            b = self.b.to(torch.float32).contiguous()
            wxq, sw = quantize_per_channel(self.wx, axis=0)
            if self.int8_rec:
                whq, swh = quantize_per_channel(self.wh, axis=0)
                ys = gru_scan_xfused_q8(xc, wxq, sw, b, whq, mask_t,
                                        self.reverse, wh_scale=swh)
            else:
                ys = gru_scan_xfused_q8(xc, wxq, sw, b,
                                        self.wh.to(cd).contiguous(), mask_t,
                                        self.reverse)
        elif self.fused_proj or (cd == torch.float32 and not self.training):
            ys = gru_scan_xfused(x.to(cd).contiguous(), self.wx.to(cd),
                                 self.b, self.wh.to(cd), mask_t,
                                 self.reverse)
        else:
            # JAX's order: x@Wx rounded to cd, then + b in cd.
            T, B, D = x.shape
            with full_fp32():
                xp = (x.reshape(T * B, D).to(cd) @ self.wx.to(cd)
                      + self.b.to(cd)).reshape(T, B, -1)
            wh = self.wh.to(cd) if self.pallas else self.wh
            ys = gru_scan(xp.to(wh.dtype), wh, mask_t, self.reverse)
        ys = ys.to(x.dtype)
        return ys * mask_t.to(ys.dtype)


def reverse_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Time-major (T, B, ...) -> each row's first ``lengths[b]`` steps
    reversed, the padding left in place (JAX's layers.py:199-204)."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)[:, None]
    L = lengths.to(device=x.device, dtype=torch.long)[None, :]
    idx = torch.where(t < L, L - 1 - t, t)                 # (T, B)
    idx = idx.reshape(*idx.shape, *([1] * (x.ndim - 2))).expand_as(x)
    return torch.gather(x, 0, idx)


class BiGRU(nn.Module):
    """Concat of a forward and a reverse GRU on (T, B, D) input.

    By default two ``GRULayer``s (``fwd``, ``bwd``). With ``fused_bidir``,
    JAX's fused form (layers.py:226-260): the parameters ``fwd_wx``,
    ``fwd_wh``, ``fwd_b``, ``bwd_wx``, ``bwd_wh``, ``bwd_b`` sit on this
    module, xp_f = x@Wx_f + b_f and xp_b = reverse(x)@Wx_b + b_b are
    matmuls in ``compute_dtype`` (bf16 with ``bf16_gru``: rounded by the
    product and by the sum), and both recursions run in one kernel
    (``gru_scan_bidir``: K7, and K7b in training, in f32 or bf16). As in
    JAX, that branch ignores ``fused_proj``, ``int8_proj``, ``int8_rec``
    and ``pallas``.
    """

    def __init__(self, in_features: int, hidden: int, generator=None,
                 fused_bidir: bool = False, **kw):
        super().__init__()
        self.fused_bidir = fused_bidir
        if not fused_bidir:
            self.fwd = GRULayer(in_features, hidden, reverse=False,
                                generator=generator, **kw)
            self.bwd = GRULayer(in_features, hidden, reverse=True,
                                generator=generator, **kw)
            return
        self.compute_dtype = kw.get("compute_dtype", torch.float32)
        for pre in ("fwd", "bwd"):
            wx = nn.Parameter(torch.empty((in_features, 3 * hidden)))
            wh = nn.Parameter(torch.empty((hidden, 3 * hidden)))
            _lecun_normal_(wx, in_features, generator)
            with torch.no_grad():
                nn.init.orthogonal_(wh, generator=generator)
            setattr(self, f"{pre}_wx", wx)
            setattr(self, f"{pre}_wh", wh)
            setattr(self, f"{pre}_b", nn.Parameter(torch.zeros(3 * hidden)))

    def forward(self, x: torch.Tensor, mask_t: torch.Tensor) -> torch.Tensor:
        if self.fused_bidir:
            return self._fused_forward(x, mask_t)
        return torch.cat([self.fwd(x, mask_t), self.bwd(x, mask_t)], dim=-1)

    def _fused_forward(self, x, mask_t):
        T, B, D = x.shape
        cd = self.compute_dtype
        lengths = mask_t.reshape(T, B).sum(0).round().long()

        def proj(inp, wx, b):
            return (inp.reshape(T * B, D).to(cd) @ wx.to(cd)
                    + b.to(cd)).reshape(T, B, -1)

        with full_fp32():
            xpf = proj(x, self.fwd_wx, self.fwd_b)
            xpb = proj(reverse_sequences(x, lengths), self.bwd_wx,
                       self.bwd_b)
        ysf, ysb = gru_scan_bidir(xpf, xpb, self.fwd_wh.to(cd),
                                  self.bwd_wh.to(cd), mask_t)
        y = torch.cat([ysf.to(x.dtype),
                       reverse_sequences(ysb.to(x.dtype), lengths)], dim=-1)
        return y * mask_t.to(x.dtype)
