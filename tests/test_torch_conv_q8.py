"""tpuasr_torch's int8 conv frontend (K9) and band-matrix convs against the
JAX package (CPU).

The port's ``conv_taps_q8`` runs its plain version on CPU tensors; JAX's
Pallas kernel runs with ``interpret=True``, which the JAX package selects
itself off a TPU. The same numpy inputs go to both.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.models import create_model as j_create_model
from tpuasr.models.layers import FrontConv as JFrontConv
from tpuasr.ops.pallas_conv import conv_taps_q8 as j_conv_taps_q8
from tpuasr.ops.pallas_conv import reference_q8_conv_taps as j_reference
from tpuasr.ops.quant import quantize_per_channel as j_qpc
from tpuasr.ops.quant import quantize_rows as j_qrows
from tpuasr_torch.convert import from_jax_variables
from tpuasr_torch.decode import greedy_decode
from tpuasr_torch.models import create_model
from tpuasr_torch.models import layers as layers_mod
from tpuasr_torch.models.layers import FrontConv
from tpuasr_torch.ops.conv import conv_taps_q8, reference_q8_conv_taps
from tpuasr_torch.ops.quant import quantize_per_channel, quantize_rows


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Drop the executables that earlier test files in this process traced.
    A file that ran the JAX package's Pallas kernels under
    ``pltpu.force_tpu_interpret_mode()`` leaves executables whose host
    callbacks dispatch JAX ops; reused here, they can deadlock."""
    jax.clear_caches()

# tests/test_quant_conv.py's shapes: (B, T_out, Kd, N, Kt).
SHAPES = [(3, 50, 128, 256, 11), (1, 300, 128, 128, 7)]


def _case(seed, B, T, K, N, Kt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T + Kt - 1, K)).astype(np.float32)
    m = (rng.standard_normal((Kt, K, N)) * 0.1).astype(np.float32)
    mq, sw = j_qpc(jnp.asarray(m).reshape(-1, N))
    return x, np.asarray(mq).reshape(Kt, K, N), np.asarray(sw)


@pytest.mark.parametrize("shape", SHAPES, ids=["B3_T50_Kt11", "B1_T300_Kt7"])
@pytest.mark.parametrize("mode", ["im2col", "taps"])
def test_reference_and_wrapper_match_jax(shape, mode):
    """The port's plain version (both oracle modes) and its wrapper on CPU
    tensors against JAX's oracle and its Pallas kernel: rtol 1e-6 / atol
    1e-6, JAX's own bound between its kernel and its oracle (they differ by
    the f32 rounding of acc * (sx * sw) against (acc * sx) * sw)."""
    B, T, K, N, Kt = shape
    x, mq, sw = _case(1, *shape)
    want_ref = np.asarray(j_reference(jnp.asarray(x), jnp.asarray(mq),
                                      jnp.asarray(sw), T, mode=mode))
    want_kern = np.asarray(j_conv_taps_q8(jnp.asarray(x), jnp.asarray(mq),
                                          jnp.asarray(sw), T, mode=mode))
    args = (torch.tensor(x), torch.tensor(mq), torch.tensor(sw), T)
    got_ref = reference_q8_conv_taps(*args, mode=mode).numpy()
    got = conv_taps_q8(*args, mode=mode).numpy()
    assert got.shape == (B, T, N)
    np.testing.assert_array_equal(got, got_ref)
    # Same ops in the same order as JAX's oracle: equal to the last bit
    # up to XLA's and torch's f32 division (both IEEE).
    np.testing.assert_allclose(got_ref, want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_kern, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["im2col", "taps"])
def test_integer_sums_exact(mode):
    """Rows on the int8 grid with absmax 127 quantize losslessly (scale
    exactly 1), and with sw = 1 the output is the int32 sum itself:
    exactly the integer product, for the port and for JAX's kernel. The
    sums reach 1.2e6 (past 2^16): a float accumulation of the products
    would round."""
    rng = np.random.default_rng(0)
    B, T, K, N, Kt = 2, 40, 256, 128, 5
    x = rng.integers(-127, 128, size=(B, T + Kt - 1, K)).astype(np.float32)
    x[:, :, 0] = 127.0
    mq = rng.integers(-127, 128, size=(Kt, K, N)).astype(np.int8)
    sw = np.ones((N,), np.float32)
    gold = np.zeros((B, T, N), np.int64)
    for t in range(Kt):
        gold += x[:, t:t + T].astype(np.int64) @ mq[t].astype(np.int64)
    got = conv_taps_q8(torch.tensor(x), torch.tensor(mq), torch.tensor(sw),
                       T, mode=mode).numpy()
    want = np.asarray(j_conv_taps_q8(jnp.asarray(x), jnp.asarray(mq),
                                     jnp.asarray(sw), T, mode=mode))
    np.testing.assert_array_equal(got.astype(np.int64), gold)
    np.testing.assert_array_equal(want.astype(np.int64), gold)


def test_short_input_and_zero_tail():
    """T_in < T_out + Kt - 1: the missing rows count as zeros, as JAX pads
    them; all-zero rows take scale 1e-12/127 and give exact zeros."""
    x, mq, sw = _case(2, 2, 20, 128, 128, 5)
    x = x[:, :17].copy()                  # 4 of the 24 rows missing
    x[1] = 0.0
    got = conv_taps_q8(torch.tensor(x), torch.tensor(mq), torch.tensor(sw),
                       20).numpy()
    want = np.asarray(j_reference(jnp.asarray(x), jnp.asarray(mq),
                                  jnp.asarray(sw), 20))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[1].any()


def test_conv_taps_q8_checks():
    x, mq, sw = (torch.tensor(a) for a in _case(3, 1, 10, 128, 128, 3))
    with pytest.raises(ValueError, match="multiples of 128"):
        conv_taps_q8(x[..., :64].contiguous(), mq[:, :64].contiguous(), sw,
                     10)
    with pytest.raises(ValueError, match="mode"):
        conv_taps_q8(x, mq, sw, 10, mode="rows")
    with pytest.raises(NotImplementedError, match="slab"):
        conv_taps_q8(x, mq, sw, 10, mode="slab")
    with pytest.raises(ValueError, match="int8"):
        conv_taps_q8(x, mq.float(), sw, 10)


def _jax_conv(seed, x_nhwc, features, kernel, strides, **kw):
    mod = JFrontConv(features, kernel, strides=strides, padding="SAME", **kw)
    v = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    return mod, v


def _port_conv(v, cin, features, kernel, strides, **kw):
    conv = FrontConv(cin, features, kernel, strides, **kw)
    conv.load_state_dict({"weight": torch.tensor(
        np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1))})
    return conv.eval()


@pytest.mark.parametrize("kernel,strides,F,cin", [
    ((11, 21), (1, 2), 32, 32), ((11, 41), (2, 2), 64, 1),
    ((3, 5), (1, 3), 13, 4)], ids=["conv2", "conv1", "odd"])
def test_band_matrices_and_quantizers_match_jax(kernel, strides, F, cin):
    """band_matrices on the port's OIHW weight equals JAX's on the HWIO
    kernel exactly; quantize_per_channel of the flattened band matrix
    (axis 0) and quantize_rows of the flattened input rows equal JAX's bit
    for bit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 23, F, cin)).astype(np.float32)
    _, v = _jax_conv(0, x, 8, kernel, strides)
    w = np.asarray(v["params"]["kernel"])
    kt, kf = kernel
    sf = strides[1]
    pad = (max((-(-F // sf) - 1) * sf + kf - F, 0)) // 2
    F_out = -(-F // sf)
    want = np.asarray(JFrontConv.band_matrices(jnp.asarray(w), F, F_out, kf,
                                               sf, pad))
    got = FrontConv.band_matrices(torch.tensor(w), F, F_out, kf, sf, pad)
    np.testing.assert_array_equal(got.numpy(), want)
    N = F_out * 8
    mq, s = quantize_per_channel(got.reshape(-1, N))
    jmq, js = j_qpc(jnp.asarray(want).reshape(-1, N))
    np.testing.assert_array_equal(mq.numpy(), np.asarray(jmq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    rows = x.reshape(-1, F * cin)
    q, sx = quantize_rows(torch.tensor(rows))
    jq, jsx = j_qrows(jnp.asarray(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("q8", [False, True], ids=["matmul", "matmul_q8"])
def test_front_conv_matches_jax(q8):
    """FrontConv's band-matrix modes against JAX's FrontConv on the same
    input and converted kernel (conv2's shape, tests/test_quant_conv.py's
    input). f32 matmuls: atol 1e-5 (sums of 11 x 1024 products in another
    order). int8: the band matrix, its quantization and the int32 sums are
    exact, so only the dequant's rounding differs: rtol 1e-6 / atol 1e-6
    of JAX's kernel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, 32, 32)).astype(np.float32)
    jm, v = _jax_conv(0, x, 32, (11, 21), (1, 2), use_matmul=not q8,
                      use_matmul_q8=q8)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    conv = _port_conv(v, 32, 32, (11, 21), (1, 2), use_matmul=not q8,
                      use_matmul_q8=q8)
    with torch.inference_mode():
        got = conv(torch.tensor(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    if q8:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_front_conv_stride2_matmul_matches_jax():
    """conv1's shape (11 x 41, stride 2 in time and freq, one channel) in
    the f32 band-matrix mode, and the sliding conv on the same weight."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 41, 64, 1)).astype(np.float32)
    jm, v = _jax_conv(1, x, 8, (11, 41), (2, 2), use_matmul=True)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    for matmul in (True, False):
        conv = _port_conv(v, 1, 8, (11, 41), (2, 2), use_matmul=matmul)
        with torch.inference_mode():
            got = conv(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_front_conv_q8_value_errors():
    """JAX's ValueErrors (layers.py:351-357): time stride 1, and F*Cin and
    N multiples of 128."""
    conv = FrontConv(32, 32, (11, 21), (2, 2), use_matmul_q8=True).eval()
    with pytest.raises(ValueError, match="stride 1"):
        conv(torch.zeros(1, 32, 16, 32))
    for cin, cout in ((2, 8), (4, 4)):     # K = 64, N = 128; K = 128, N = 64
        conv = FrontConv(cin, cout, (11, 21), (1, 2),
                         use_matmul_q8=True).eval()
        with pytest.raises(ValueError, match="lane-aligned"):
            conv(torch.zeros(1, cin, 16, 32))
        jconv = JFrontConv(cout, (11, 21), strides=(1, 2),
                           use_matmul_q8=True)
        with pytest.raises(ValueError, match="lane-aligned"):
            jconv.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, cin)))


# The model: 64 mels and 8 conv channels, so that conv2's K = 32 * 8 = 256
# and N = 16 * 8 = 128 are lane-aligned.
B, T, F, C = 3, 48, 64, 16
BASE = dict(num_classes=C, rnn_hidden=32, rnn_layers=2, conv_channels=8,
            dropout=0.0)


def _inputs():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = np.array([T, T - 9, 5], np.int32)
    return feats, lens


def _models(kw):
    feats, lens = _inputs()
    jm = j_create_model("deepspeech_ctc", **BASE, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens),
                train=False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(100)
    for stats in v["batch_stats"].values():
        stats["mean"] = (rng.standard_normal(stats["mean"].shape)
                         * 0.1).astype(np.float32)
        stats["var"] = (1.0 + rng.random(stats["var"].shape)).astype(
            np.float32)
    tm = create_model("deepspeech_ctc", **BASE, **kw, in_features=F)
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, tm, feats, lens


@pytest.mark.parametrize("kw,tol", [
    (dict(matmul_frontend=True), 1e-4),
    (dict(int8_conv=True), 2e-3),
    (dict(int8_conv=True, matmul_frontend=True, pallas_gru=True,
          fused_proj=True), 2e-3),
], ids=["matmul_frontend", "int8_conv", "int8_conv_matmul_kernels"])
def test_model_matches_jax(kw, tol):
    """DeepSpeechCTC served with the band-matrix frontends on converted
    weights: out_lens exact, greedy tokens exact on the valid frames, and
    logp within tol. f32: summation order only (1e-4). int8_conv: conv1's
    f32 sums round differently in XLA and in torch, and a difference in
    the last bit can move an activation of conv2's input across a
    quantization boundary; that changes one int8 value of its row, by one
    step of sx = absmax/127 (about 1e-2 of the row's largest entry) times
    a weight, and it reaches the log-probs damped by the norms and the
    GRUs: 2e-3 bounds it at these widths."""
    jm, v, tm, feats, lens = _models(kw)
    lp_j, ol_j = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                          train=False)
    before = layers_mod.conv_taps_q8.launches
    with torch.inference_mode():
        lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    assert layers_mod.conv_taps_q8.launches == before   # CPU: plain version
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=tol)
    toks_t, tl_t = greedy_decode(lp_t, ol_t)
    toks_j, tl_j = greedy_decode(torch.tensor(np.asarray(lp_j)), ol_t)
    np.testing.assert_array_equal(tl_t.numpy(), tl_j.numpy())
    np.testing.assert_array_equal(toks_t.numpy(), toks_j.numpy())
    am = np.asarray(lp_j).argmax(-1)
    for i, n in enumerate(ol_t.tolist()):
        np.testing.assert_array_equal(lp_t[i, :n].argmax(-1).numpy(),
                                      am[i, :n])


def test_int8_conv_runs_k9_when_serving():
    """In eval() conv2 goes through conv_taps_q8 once per forward."""
    _, _, tm, feats, lens = _models(dict(int8_conv=True))
    calls = []

    def spy(*a, **k):
        calls.append(a[0].shape)
        return conv_taps_q8(*a, **k)

    with mock.patch.object(layers_mod, "conv_taps_q8", spy), \
            torch.inference_mode():
        tm(torch.tensor(feats), torch.tensor(lens))
    assert calls == [(B, T // 2 + 10, 32 * 8)]


def test_int8_conv_train_falls_back():
    """In training the model takes the sliding conv, as JAX's
    test_int8_conv_train_falls_back holds: K9 is never called, the
    training forward equals the model's without int8_conv, and the
    gradients are finite and non-zero."""
    _, _, tm, feats, lens = _models(dict(int8_conv=True))
    _, _, base, _, _ = _models({})
    base.load_state_dict(tm.state_dict())
    x, n = torch.tensor(feats), torch.tensor(lens)

    def fail(*a, **k):
        raise AssertionError("K9 called in training")

    tm.train()
    base.train()
    with mock.patch.object(layers_mod, "conv_taps_q8", fail):
        lp, _ = tm(x, n)
    lp_base, _ = base(x, n)
    assert torch.equal(lp, lp_base)
    (lp ** 2).sum().backward()
    grads = [p.grad for p in tm.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert tm.conv2.weight.grad.abs().max() > 0
