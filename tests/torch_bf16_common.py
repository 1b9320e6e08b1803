"""Shared setup of the bf16 training tests: DeepSpeechCTC in training mode
(batch statistics, dropout 0) on converted weights, its log-probs and the
gradients of sum(log_probs * g) against ``jax.grad`` of the Flax model.

Tolerances:

JAX's side is compiled with ``EXACT_BF16``, so that it rounds every bf16
value it names.

* log-probs: atol 2e-2. Both sides round at the same points (conv output,
  the stream after each norm, xp, ys, h before h@Wh); an f32 sum taken in
  another order can land a bf16 rounding on the other side of its boundary.
  Such flips ride the stream one ulp at a time (seen: the norms' and GRUs'
  outputs one ulp apart at most), and with a bf16 stream the head's input
  is itself bf16: one ulp of an input near 2.9 is 2^-6, which a head
  weight (lecun normal over 32 inputs) passes to a logit almost whole.
  Measured 1.1e-2 with fused_bidir.
* each gradient: within 2^-4 of its tensor's largest magnitude (16 bf16
  ulps there). Most elements agree to an ulp; the worst measured, 3.9%, is
  a GRU bias in bf16, a sum over T*B rows of bf16 dxp that JAX's CPU
  reduction rounds as it goes and the port sums in f32 and rounds once.
* the conv norms' scale and bias: their gradients are sums over B*T'*F'
  positions that cancel to near zero (0.05 out of terms summing to 113),
  so a flip in one upstream bf16 value moves them by a large share of
  their own size. They are held to 2^-7 of the sums of the terms' absolute
  values, sum |dy * x_hat| and sum |dy| (two ulps of bf16 flips per term
  is 2^-7; measured at most 5.6e-4), taken from the port's own dy and x_hat
  by hooks.
* the weight gradients that JAX rounds to bf16 (the bf16 casts' transposes:
  GRU wx and wh, the biases cast to bf16, the conv kernels of a bf16 conv)
  are bf16 values in the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpuasr.models import create_model as j_create_model
from tpuasr_torch.convert import from_jax_variables, to_jax_variables
from tpuasr_torch.models import create_model

B, T, F, C = 2, 20, 16, 16
BASE = dict(num_classes=C, rnn_hidden=16, rnn_layers=2, conv_channels=4,
            dropout=0.0)
LOGP_TOL = 2e-2
# XLA may keep a bf16 value in f32 across fused ops
# (xla_allow_excess_precision, on by default): JAX's compiled step then
# skips roundings that its own op-by-op run and the TPU program make (a
# bf16 conv's output moved log-probs by 2.2e-2 at this size). The
# reference compiles without it.
EXACT_BF16 = {"xla_allow_excess_precision": False}
GRAD_REL = 2.0 ** -4
NORM_REL = 2.0 ** -7


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = np.array([T, 13], np.int32)
    g = rng.standard_normal((B, -(-T // 2), C)).astype(np.float32)
    return feats, lens, g


def jax_grads(kw, v, feats, lens, g, bf16_feats):
    """(log-probs, grads) of the Flax model in training on variables v."""
    jm = j_create_model("deepspeech_ctc", **BASE, **kw)
    fj = jnp.asarray(feats, jnp.bfloat16 if bf16_feats else jnp.float32)

    def loss(p):
        (lp, _), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                              fj, jnp.asarray(lens), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(lp * g), lp

    step = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        v["params"]).compile(compiler_options=EXACT_BF16)
    (_, lp), grads = step(v["params"])
    grads = from_jax_variables({"params": jax.tree.map(np.asarray, grads)})
    return np.asarray(lp), grads


def _norm_sums(model):
    """Hooks on the conv norms: per channel, sum |dy * x_hat| and sum |dy|
    of the training forward's output gradient."""
    sums = {}

    def hook(name, bn):
        def fwd(mod, args, y):
            x_hat = ((y - bn.bias[:, None, None])
                     / bn.scale[:, None, None]).detach()

            def bwd(dy):
                sums[f"{name}.scale"] = (dy * x_hat).abs().sum((0, 2, 3))
                sums[f"{name}.bias"] = dy.abs().sum((0, 2, 3))
            y.register_hook(bwd)
        return fwd

    for name in ("conv1_bn", "conv2_bn"):
        bn = getattr(model, name)
        bn.register_forward_hook(hook(name, bn))
    return sums


def rounded_grads(kw, bf16_feats, names):
    """The parameters whose gradients JAX rounds to bf16."""
    out = set()
    if kw.get("bf16_gru"):
        bidir = kw.get("fused_bidir") and kw.get("bidirectional", True)
        fused = kw.get("fused_proj") and kw.get("pallas_gru") and not bidir
        # wh stays f32 in JAX's lax.scan route (pallas_gru=False), and b in
        # the fused projection's (passed in f32, layers.py:142-146).
        wh = kw.get("pallas_gru") or bidir
        for n in names:
            leaf = n.split(".")[-1]
            if not n.startswith("rnn") or "_bn" in n:
                continue
            if (leaf.endswith("wx") or (leaf.endswith("wh") and wh)
                    or (leaf.endswith("b") and not fused)):
                out.add(n)
    if kw.get("bf16_conv") or bf16_feats:
        out.add("conv1.weight")
    if kw.get("bf16_conv"):
        out.add("conv2.weight")
    return out


def check_model_grads(kw, bf16_feats=False):
    feats, lens, g = inputs()
    # The port's seeded weights, converted (Flax's init would run the
    # model's Pallas kernels eagerly in interpret mode).
    tm = create_model("deepspeech_ctc", **BASE, **kw, in_features=F,
                      generator=torch.Generator().manual_seed(0))
    v = to_jax_variables(tm.state_dict())
    lp_j, grads_j = jax_grads(kw, v, feats, lens, g, bf16_feats)
    tm.train()
    sums = _norm_sums(tm)
    ft = torch.tensor(feats)
    if bf16_feats:
        ft = ft.to(torch.bfloat16)
    lp_t, _ = tm(ft, torch.tensor(lens))
    (lp_t * torch.tensor(g)).sum().backward()
    assert lp_t.dtype == torch.float32
    np.testing.assert_allclose(lp_t.detach().numpy(), lp_j, rtol=0,
                               atol=LOGP_TOL)
    params = dict(tm.named_parameters())
    assert set(params) == set(grads_j)
    for name, p in params.items():
        want = grads_j[name].numpy()
        got = p.grad.numpy()
        tol = GRAD_REL * np.abs(want).max()
        if name in sums:
            tol = np.maximum(tol, NORM_REL * sums[name].numpy())
        np.testing.assert_array_less(np.abs(got - want), tol + 1e-12,
                                     err_msg=name)
    for name in rounded_grads(kw, bf16_feats, params):
        gr = params[name].grad
        assert torch.equal(gr, gr.to(torch.bfloat16).float()), name
