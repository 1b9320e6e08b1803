"""tpuasr_torch CUDA kernels against their plain versions, on the card.

Marked ``gpu``: skipped where CUDA is absent. The card's machine has no
jax, so run these without the suite's jax conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

``chip_smoke.py`` checks the same kernels at the served shapes; these keep
small ragged shapes that a kernel edit can be iterated on.
"""

import contextlib
import ctypes
from unittest import mock

import pytest
import torch

from tpuasr_torch import _build
from tpuasr_torch.decode.beam import beam_scan, beam_scan_plain
from tpuasr_torch.decode.beam import ctc_beam_search as kernel_search
from tpuasr_torch.features import FeatureConfig, fbank_power
from tpuasr_torch.features.fused import fbank_power_plain
from tpuasr_torch.features.reference import feature_tables, num_frames
from tpuasr_torch.decode.prefix_beam import BeamSearchConfig
from tpuasr_torch.losses import ctc as ctc_mod
from tpuasr_torch.ops.gather import gather_rows, gather_rows_plain
from tpuasr_torch.ops import gru as gru_mod
from tpuasr_torch.ops.conv import conv_taps_q8, reference_q8_conv_taps
from tpuasr_torch.ops.gru import (gru_scan_bidir, gru_scan_bidir_bwd,
                                  gru_scan_bidir_bwd_plain,
                                  gru_scan_bidir_fwd, gru_scan_bidir_plain,
                                  gru_scan_bwd, gru_scan_bwd_plain,
                                  gru_scan_fwd, gru_scan_plain,
                                  gru_scan_xfused, gru_scan_xfused_plain,
                                  gru_scan_xfused_q8, gru_scan_xfused_q8_plain,
                                  prev_states)
from tpuasr_torch.ops.quant import quantize_per_channel
from tpuasr_torch.models import capsnet as capsnet_mod
from tpuasr_torch.models import create_model
from tpuasr_torch.ops import routing as routing_mod
from tpuasr_torch.ops.routing import (routed_caps, routed_caps_bwd,
                                      routed_caps_bwd_plain,
                                      routed_caps_plain, squash)
from tpuasr_torch.precision import full_fp32

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("sr", [8000, 16000])
def test_fbank(dev, sr):
    cfg = FeatureConfig(sample_rate=sr)
    tabs = feature_tables(cfg, dev)
    S = 3 * sr // 2 + 17
    T = num_frames(cfg, S)
    wav = torch.randn(3, S, generator=torch.Generator().manual_seed(0)).to(dev)
    got = fbank_power(wav, tabs, cfg.hop_length, T)
    ref = fbank_power_plain(wav, tabs, cfg.hop_length, T)
    torch.testing.assert_close(torch.log(got.clamp(min=1e-10)),
                               torch.log(ref.clamp(min=1e-10)),
                               rtol=0, atol=1e-3)


def _gru_case(dev, D, H, dtype):
    g = torch.Generator().manual_seed(1)
    T, B = 37, 7
    x = torch.randn(T, B, D, generator=g).to(dev, dtype)
    wx = (torch.randn(D, 3 * H, generator=g) / D ** 0.5).to(dev)
    wh = (torch.randn(H, 3 * H, generator=g) / H ** 0.5).to(dev)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(dev)
    lens = torch.tensor([T, 30, 1, 0, 12, T, 5])
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    return x, wx, wh, b, mask.to(dev).contiguous()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k2(dev, reverse, dtype, tol):
    x, wx, wh, b, mask = _gru_case(dev, 70, 40, dtype)
    args = (x, wx.to(dtype), b, wh.to(dtype), mask, reverse)
    torch.testing.assert_close(gru_scan_xfused(*args).float(),
                               gru_scan_xfused_plain(*args).float(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rec_q8", [False, True])
def test_k4(dev, reverse, rec_q8):
    x, wx, wh, b, mask = _gru_case(dev, 70, 40, torch.bfloat16)
    wxq, sw = quantize_per_channel(wx)
    if rec_q8:
        whq, swh = quantize_per_channel(wh)
        args, kw = (x, wxq, sw, b, whq, mask, reverse), {"wh_scale": swh}
    else:
        args, kw = (x, wxq, sw, b, wh.bfloat16(), mask, reverse), {}
    torch.testing.assert_close(gru_scan_xfused_q8(*args, **kw).float(),
                               gru_scan_xfused_q8_plain(*args, **kw).float(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("C,K,max_len", [(5, 8, 40), (30, 4, 6)])
def test_k3_exact(dev, C, K, max_len):
    g = torch.Generator().manual_seed(2)
    lp = torch.log_softmax(torch.randn(6, 40, C, generator=g) * 2, -1)
    lp = lp.to(dev).contiguous()
    lens = torch.tensor([40, 0, 1, 17, 40, 3], dtype=torch.int32).to(dev)
    got = beam_scan(lp, lens, K, 0, max_len)
    ref = beam_scan_plain(lp, lens, K, 0, max_len)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("order,C,K,track", [(2, 5, 8, False),
                                             (2, 30, 4, True),
                                             (3, 9, 6, True),
                                             (2, 190, 4, False)])
def test_k3_lm_exact(dev, order, C, K, track):
    """K3 with a bigram or trigram fusion table (C=190: a bigram table too
    large to stage in shared memory, read from global memory) equals its
    plain version bit for bit, backpointers, scores, LM scores, last and
    last2 included."""
    g = torch.Generator().manual_seed(6)
    lp = torch.log_softmax(torch.randn(5, 30, C, generator=g) * 2, -1)
    tab = torch.log_softmax(torch.randn((C + 1) ** (order - 1), C,
                                        generator=g), -1)
    lp, tab = lp.to(dev).contiguous(), tab.to(dev).contiguous()
    lens = torch.tensor([30, 0, 1, 17, 30], dtype=torch.int32).to(dev)
    args = (lp, lens, K, 0, 12, tab, order, 0.7, track)
    got = beam_scan(*args)
    ref = beam_scan_plain(*args)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_k3_lm_search_trigram_eos(dev):
    """The whole kernel search with a trigram table and a 2-D eos term on
    the card, against the same search on the CPU (plain version)."""
    g = torch.Generator().manual_seed(7)
    C = 8
    lp = torch.log_softmax(torch.randn(4, 25, C, generator=g) * 2, -1)
    tri = torch.log_softmax(torch.randn(C + 1, C + 1, C, generator=g), -1)
    eos = torch.randn(C + 1, C + 1, generator=g) - 3
    lens = torch.tensor([25, 3, 0, 19])
    cfg = BeamSearchConfig(beam_width=5, max_len=25, lm_weight=0.6)
    got = kernel_search(lp.to(dev), lens.to(dev), cfg, n_best=3,
                        lm_trigram=tri.to(dev), lm_eos=eos.to(dev))
    want = kernel_search(lp, lens, cfg, n_best=3, lm_trigram=tri,
                         lm_eos=eos)
    for key in ("tokens", "token_lens"):
        assert torch.equal(got[key].cpu(), want[key])
    for key in ("scores", "am_scores", "lm_scores"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("S,W", [(5000, 128), (37, 12), (10, 7)])
def test_k10_exact(dev, S, W):
    """K10 equals the plain gather on int32 tables (W=7: the scalar path),
    float bits in the table and indices past either end included."""
    g = torch.Generator().manual_seed(8)
    table = torch.randint(-2 ** 31, 2 ** 31 - 1, (S, W), generator=g,
                          dtype=torch.int64).to(torch.int32)
    idx = torch.randint(0, S, (9, 13), generator=g, dtype=torch.int32)
    idx[0, :3] = torch.tensor([-5, S, 2 ** 31 - 1])
    table, idx = table.to(dev), idx.to(dev)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))
    with pytest.raises(ValueError, match="dtype"):
        gather_rows(table.float(), idx)


def _scan_case(dev, H, B=7, T=37):
    g = torch.Generator().manual_seed(3)
    xp = torch.randn(T, B, 3 * H, generator=g)
    wh = torch.randn(H, 3 * H, generator=g) / H ** 0.5
    dys = torch.randn(T, B, H, generator=g)
    lens = torch.tensor([T, 30, 1, 0, 12, T, 5])[:B]
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    return [t.to(dev).contiguous() for t in (xp, wh, mask, dys)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [40, 130])
def test_k5_k5b(dev, reverse, H):
    """K5 ys within 1e-5; K5b dxp and dwh within 1e-4 of their largest
    magnitude (float32 sums in another order, dWh over all T*B rows)."""
    xp, wh, mask, dys = _scan_case(dev, H)
    with full_fp32():
        ys = gru_scan_fwd(xp, wh, mask, reverse)
        ref = gru_scan_plain(xp, wh, mask, reverse)
        torch.testing.assert_close(ys, ref, rtol=0, atol=1e-5)
        ysp = prev_states(ref, reverse)
        got = gru_scan_bwd(xp, ysp, wh, mask, dys, reverse)
        want = gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse)
    for a, w in zip(got, want):
        tol = 1e-4 * w.abs().max().item()
        torch.testing.assert_close(a, w, rtol=0, atol=tol)
    assert not got[0][:, 3].any()             # a row of length 0


def test_k2_backward_route(dev):
    """gru_scan_xfused's backward on the card (K2 forward, then K5b between
    matmuls) against autograd through its plain version: each gradient
    within 1e-4 of its largest magnitude."""
    x, wx, wh, b, mask = _gru_case(dev, 70, 40, torch.float32)
    g = torch.Generator().manual_seed(5)
    dys = torch.randn(x.shape[0], x.shape[1], 40, generator=g).to(dev)
    with full_fp32():
        got = [t.clone().requires_grad_() for t in (x, wx, b, wh)]
        (gru_scan_xfused(*got, mask) * dys).sum().backward()
        ref = [t.clone().requires_grad_() for t in (x, wx, b, wh)]
        (gru_scan_xfused_plain(*ref, mask) * dys).sum().backward()
    for a, r in zip(got, ref):
        tol = 1e-4 * r.grad.abs().max().item()
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=tol)


def test_ctc_kernels(dev):
    """K6/K6b on the edge cases (no frames, empty label, repeats, an
    infeasible row, garbage labels): reachable entries within rtol 1e-5,
    unreachable where the plain version is."""
    g = torch.Generator().manual_seed(4)
    B, T, C, U = 8, 50, 9, 6
    lp = torch.log_softmax(torch.randn(B, T, C, generator=g) * 2, -1)
    labels = torch.randint(1, C, (B, U), generator=g)
    il = torch.tensor([T, 0, 44, 12, 6, 31, T, 27])
    ll = torch.tensor([U, 3, 0, 4, 4, 5, 2, 6])
    labels[3, :4] = torch.tensor([5, 5, 5, 2])
    labels[4, :4] = 7
    labels[6, 2:] = torch.tensor([-3, 99, 0, 40])
    ext, allow, valid, lp_ext = ctc_mod.prepare(lp.to(dev), labels.to(dev),
                                                ll.to(dev))
    il, ll = il.to(dev), ll.to(dev)
    cases = ((ctc_mod.ctc_alphas_kernel(lp_ext, allow, valid),
              ctc_mod.ctc_alphas_plain(lp_ext, allow, valid)),
             (ctc_mod.ctc_betas_kernel(lp_ext, allow, valid, il, ll),
              ctc_mod.ctc_betas_plain(lp_ext, allow, valid, il, ll)))
    for got, want in cases:
        reach = want > -1e29
        assert torch.equal(got > -1e29, reach)
        torch.testing.assert_close(got[reach], want[reach], rtol=1e-5,
                                   atol=1e-6)


def test_k3_exact_capsnet_classes(dev):
    """K3 at CapsNet's 48 classes (config 4), ragged lengths."""
    g = torch.Generator().manual_seed(9)
    lp = torch.log_softmax(torch.randn(5, 60, 48, generator=g) * 2, -1)
    lp = lp.to(dev).contiguous()
    lens = torch.tensor([60, 0, 1, 33, 59], dtype=torch.int32).to(dev)
    got = beam_scan(lp, lens, 8, 0, 64)
    ref = beam_scan_plain(lp, lens, 8, 0, 64)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def _routing_case(dev, B, T, I, Din, O, D, seed=10):
    """Squashed u of length ~0.9 and W of scale 0.5: the routing moves the
    coupling well away from uniform (at config 4 the largest c is about
    5x 1/O) and |v| reaches 0.9, so the tolerances bite."""
    g = torch.Generator().manual_seed(seed)
    u = squash(torch.randn(B, T, I, Din, generator=g) * 2.0)
    W = torch.randn(I, Din, O * D, generator=g) * 0.5
    return u.to(dev).contiguous(), W.to(dev).contiguous()


# (B, T, I, Din, O, D, iters). Row counts 21, 22, 9, 10, 15, 13, 14, 5
# and 6 are multiples of neither 4 nor 8 rows per block; I = 96 (the JAX
# tests' unaligned I), 95, 93, 17 and 33 (odd: a half-filled last chunk of
# 2 capsules); O*D = 21 and 30 are not multiples of 8, and D = 3 and 6
# take the kernel's unvectorized W loads; Din = 5 gives u's staged rows an
# odd length and makes the W chunks' copies 4-byte; Din = 16 fills a warp's
# lanes with a row's chunk of u, Din = 1 leaves all but two idle; O = 128
# and 96 at D = 16 read W from L2 (their chunks do not fit the shared
# memory of the 512- and 384-thread launch shapes), the others stage it.
# K8b's second pass has an instance per (Din <= 8 or <= 16, up to 256 or
# 512 class threads): O = 72 at D = 16 (288 threads) with Din = 12 takes
# the last of them.
K8_CASES = [
    (3, 7, 96, 8, 10, 4, 3),
    (2, 11, 256, 8, 48, 16, 3),
    (1, 9, 256, 8, 48, 16, 1),
    (2, 5, 95, 8, 48, 16, 3),
    (3, 5, 93, 5, 7, 3, 3),
    (1, 13, 256, 4, 5, 6, 1),
    (2, 7, 96, 8, 128, 16, 2),
    (1, 5, 64, 8, 96, 16, 3),
    (2, 3, 17, 16, 9, 8, 2),
    (1, 6, 33, 1, 4, 4, 3),
    (1, 5, 20, 12, 72, 16, 3),
]


@pytest.mark.parametrize("B,T,I,Din,O,D,iters", K8_CASES)
def test_k8(dev, B, T, I, Din, O, D, iters):
    """K8 against routed_caps_plain (einsum + dynamic_routing, TF32 off)
    within rtol 2e-5 / atol 2e-6, the JAX package's bound for its Pallas
    kernel against the einsum path: float32 sums in other orders."""
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    before = routed_caps.launches
    with full_fp32():
        got = routed_caps(u, W, O, D, iters)
        torch.cuda.synchronize()
        ref = routed_caps_plain(u, W, O, D, iters)
    assert routed_caps.launches == before + 1
    assert got.shape == (B, T, O, D)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)


def test_k8_launch_code_checked(dev):
    """A launch the kernel refuses returns its CUDA error, which the
    wrapper's check raises; the wrapper refuses such shapes, another dtype
    and a non-contiguous u before launching."""
    u, W = _routing_case(dev, 1, 3, 8, 4, 200, 16)
    v = torch.empty(1, 3, 200, 16, device=dev)
    fn = _build.lib().tpuasr_routing_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(v), 3, 8, 4, 200, 16,
              3, _build.stream_ptr(u))
    assert code != 0
    with pytest.raises(RuntimeError, match="routed_caps: CUDA error"):
        _build.check(code, "routed_caps")
    before = routed_caps.launches
    with pytest.raises(ValueError, match="at most 128 classes"):
        routed_caps(u, W, 200, 16)
    u, W = _routing_case(dev, 2, 3, 8, 4, 6, 16)
    with pytest.raises(ValueError, match="dtype"):
        routed_caps(u.double(), W, 6, 16)
    with pytest.raises(ValueError, match="contiguous"):
        routed_caps(u.transpose(2, 3).contiguous().transpose(2, 3), W, 6, 16)
    assert routed_caps.launches == before


# K8b's bound: each output within 2e-5 of its largest magnitude. Float32
# sums in other orders (dW over all rows, du over O*D terms), and the
# coupling from b rebuilt as u_hat . (v_0 + ... ) where the plain version
# adds the agreement iteration by iteration (as for K8).
K8B_TOL = 2e-5


@pytest.mark.parametrize("B,T,I,Din,O,D,iters", K8_CASES)
def test_k8b(dev, B, T, I, Din, O, D, iters):
    """K8b against routed_caps_bwd_plain (TF32 off), within K8B_TOL of
    each output's largest magnitude; a row with u = 0 (s = 0: the squash
    VJP's eps) gets du = 0; a second call gives the same bits (no
    atomics)."""
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    u[0, 0] = 0.0
    g = torch.Generator().manual_seed(11)
    dv = torch.randn(B, T, O, D, generator=g).to(dev)
    before = routed_caps_bwd.launches
    with full_fp32():
        got = routed_caps_bwd(u, W, dv, O, D, iters)
        torch.cuda.synchronize()
        ref = routed_caps_bwd_plain(u, W, dv, O, D, iters)
        again = routed_caps_bwd(u, W, dv, O, D, iters)
    assert routed_caps_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].shape == u.shape and got[1].shape == W.shape
    assert not got[0][0, 0].any()
    for a, r in zip(got, ref):
        tol = K8B_TOL * r.abs().max().item()
        torch.testing.assert_close(a, r, rtol=0, atol=tol)


def _no_plain(*a, **k):
    raise AssertionError("a plain routing version ran on CUDA tensors")


def test_routed_caps_autograd_runs_k8_then_k8b(dev):
    """Under autograd on CUDA, routed_caps launches K8 in the forward and
    K8b in the backward, once each, and runs no plain version; the
    gradients are autograd's through the plain version within K8B_TOL."""
    B, T, I, Din, O, D = 2, 11, 256, 8, 48, 16
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    tgt = torch.randn(B, T, O, D, generator=torch.Generator().manual_seed(3))
    tgt = tgt.to(dev)
    k8, k8b = routed_caps.launches, routed_caps_bwd.launches
    with full_fp32():
        ku, kW = u.clone().requires_grad_(), W.clone().requires_grad_()
        with mock.patch.object(routing_mod, "routed_caps_plain", _no_plain), \
                mock.patch.object(routing_mod, "routed_caps_bwd_plain",
                                  _no_plain):
            v = routed_caps(ku, kW, O, D)
            assert (routed_caps.launches, routed_caps_bwd.launches) == (
                k8 + 1, k8b)
            torch.sum((v - tgt) ** 2).backward()
            torch.cuda.synchronize()
        assert (routed_caps.launches, routed_caps_bwd.launches) == (
            k8 + 1, k8b + 1)
        pu, pW = u.clone().requires_grad_(), W.clone().requires_grad_()
        torch.sum((routed_caps_plain(pu, pW, O, D) - tgt) ** 2).backward()
    for a, r in ((ku.grad, pu.grad), (kW.grad, pW.grad)):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=K8B_TOL * r.abs().max().item())
    # Without a gradient, nothing is saved and only K8 runs.
    with torch.no_grad():
        routed_caps(ku, kW, O, D)
    assert routed_caps_bwd.launches == k8b + 1


def test_capsnet_training_step_on_cuda(dev):
    """A CapsNetCTC training forward and backward on CUDA (K8, K8b)
    against the same model with the plain routing: log-probs within 1e-4,
    every gradient within 1e-4 of its largest magnitude (the convs'
    gradients sum over the batch in cuDNN's order on both), the batch-norm
    statistics within 1e-6."""
    kw = dict(num_classes=12, conv_channels=8, primary_caps=4,
              primary_dim=4, class_dim=4, in_features=40)
    g = torch.Generator().manual_seed(0)
    kern = create_model("capsule1", **kw, generator=g)
    with torch.no_grad():
        kern.W_route.mul_(20.0)
    plain = create_model("capsule1", **kw)
    plain.load_state_dict(kern.state_dict())
    feats = torch.randn(3, 37, 40, generator=g).to(dev)
    lens = torch.tensor([37, 22, 5]).to(dev)
    wts = torch.randn(3, 19, 12, generator=g).to(dev)
    k8, k8b = routed_caps.launches, routed_caps_bwd.launches
    outs = []
    for model in (kern, plain):
        model.to(dev).train()
        ctx = (mock.patch.object(capsnet_mod, "routed_caps",
                                 routed_caps_plain) if model is plain
               else mock.patch.object(routing_mod, "routed_caps_plain",
                                      _no_plain))
        with full_fp32(), ctx:
            logp, ol = model(feats, lens)
            torch.sum(logp * wts).backward()
        torch.cuda.synchronize()
        outs.append((logp.detach(), ol))
    assert (routed_caps.launches, routed_caps_bwd.launches) == (k8 + 1,
                                                                k8b + 1)
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-4)
    assert torch.equal(outs[0][1], outs[1][1])
    for (name, a), b in zip(kern.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0,
                                   atol=1e-4 * b.grad.abs().max().item(),
                                   msg=name)
    for name in ("mean", "var"):
        torch.testing.assert_close(getattr(kern.stem_bn, name),
                                   getattr(plain.stem_bn, name), rtol=0,
                                   atol=1e-6)


def test_k8b_launch_code_checked(dev):
    """A launch K8b refuses returns its CUDA error; the wrapper refuses
    such shapes, another dtype and a non-contiguous dv before launching."""
    u, W = _routing_case(dev, 1, 3, 8, 4, 200, 16)
    dv = torch.zeros(1, 3, 200, 16, device=dev)
    scratch = [torch.empty(3, 200, 16, device=dev) for _ in range(2)]
    du, dW = torch.empty_like(u), torch.empty_like(W)
    fn = _build.lib().tpuasr_routing_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(dv),
              *[_build.ptr(t) for t in scratch], _build.ptr(du),
              _build.ptr(dW), _build.ptr(dW), 3, 8, 4, 200, 16, 3, 1,
              _build.stream_ptr(u))
    assert code != 0
    before = routed_caps_bwd.launches
    with pytest.raises(ValueError, match="at most 128 classes"):
        routed_caps_bwd(u, W, dv, 200, 16)
    u, W = _routing_case(dev, 2, 3, 8, 4, 6, 16)
    dv = torch.zeros(2, 3, 6, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        routed_caps_bwd(u, W, dv.double(), 6, 16)
    with pytest.raises(ValueError, match="contiguous"):
        routed_caps_bwd(u, W, dv.transpose(2, 3).contiguous().transpose(2, 3),
                        6, 16)
    with pytest.raises(ValueError, match="shape"):
        routed_caps_bwd(u, W, dv[:, :2].contiguous(), 6, 16)
    assert routed_caps_bwd.launches == before


# ---- K9: the int8 conv tap-GEMM --------------------------------------------


def _conv_case(dev, B, T, K, N, Kt, seed=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T + Kt - 1, K, generator=g)
    x[0, T // 2] *= 40.0                 # one row's scale dominates windows
    if B > 1:
        x[1] = 0.0                       # zero rows: scale 1e-12/127
    m = torch.randn(Kt, K, N, generator=g) * 0.1
    mq, sw = quantize_per_channel(m.reshape(-1, N))
    return x.to(dev), mq.reshape(Kt, K, N).to(dev), sw.to(dev)


@pytest.mark.parametrize("B,T,K,N,Kt,cut", [
    (1, 300, 128, 128, 7, 0),      # windows across the 128-row tiles
    (3, 50, 256, 256, 11, 4),      # T_in short of T_out + Kt - 1
    (2, 129, 1024, 512, 11, 0),    # conv2's widths, one row past a tile
])
def test_k9(dev, B, T, K, N, Kt, cut):
    """K9 against its plain version to f32 rounding (rtol 1e-6, atol 1e-6:
    the quantized values and int32 sums are exact, the dequant rounds in
    the plain version's order)."""
    x, mq, sw = _conv_case(dev, B, T, K, N, Kt)
    x = x[:, :x.shape[1] - cut].contiguous()
    before = conv_taps_q8.launches
    got = conv_taps_q8(x, mq, sw, T)
    assert conv_taps_q8.launches == before + 1
    want = reference_q8_conv_taps(x, mq, sw, T)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if B > 1:
        assert not got[1].any()


def test_k9_integer_sums_exact(dev):
    """Rows on the int8 grid (absmax 127, scale 1) with sw = 1: the output
    is the int32 sum, equal to the plain version's bit for bit."""
    g = torch.Generator().manual_seed(13)
    B, T, K, N, Kt = 2, 200, 1024, 256, 11
    x = torch.randint(-127, 128, (B, T + Kt - 1, K), generator=g).float()
    x[:, :, 0] = 127.0
    mq = torch.randint(-127, 128, (Kt, K, N), generator=g).to(torch.int8)
    sw = torch.ones(N)
    x, mq, sw = x.to(dev), mq.to(dev), sw.to(dev)
    assert torch.equal(conv_taps_q8(x, mq, sw, T),
                       reference_q8_conv_taps(x, mq, sw, T))


def test_k9_refuses_unported_modes(dev):
    x, mq, sw = _conv_case(dev, 1, 20, 128, 128, 3)
    for mode in ("taps", "slab"):
        with pytest.raises(NotImplementedError, match=mode):
            conv_taps_q8(x, mq, sw, 20, mode=mode)


# ---- K7 / K7b: the fused bidirectional scan ---------------------------------


def _bidir_case(dev, H, B=7, T=37, dtype=torch.float32):
    g = torch.Generator().manual_seed(14)
    xpf, xpb = (torch.randn(T, B, 3 * H, generator=g) for _ in range(2))
    whf, whb = (torch.randn(H, 3 * H, generator=g) / H ** 0.5
                for _ in range(2))
    dys = [torch.randn(T, B, H, generator=g) for _ in range(2)]
    lens = torch.tensor([T, 30, 1, 0, 12, T, 5] * 3)[:B]
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    ins = [t.to(dev, dtype).contiguous() for t in (xpf, xpb, whf, whb)]
    return ins, mask.to(dev).contiguous(), [d.to(dev) for d in dys]


@pytest.mark.parametrize("H,B", [(40, 7), (130, 20), (512, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k7(dev, H, B, dtype, tol):
    """K7 against its plain version: f32 within 1e-5 (K5's bound); bf16
    streams within 2e-2 (K2's bf16 bound: a one-ulp difference of an f32
    sum can flip a bf16 rounding of h and ride the recurrence)."""
    ins, mask, _ = _bidir_case(dev, H, B, dtype=dtype)
    before = gru_scan_bidir_fwd.launches
    got = gru_scan_bidir_fwd(*ins, mask)
    assert gru_scan_bidir_fwd.launches == before + 1
    with full_fp32():
        want = gru_scan_bidir_plain(*ins, mask)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol)
    assert not got[0][:, 3].float().any()       # a row of length 0


@pytest.mark.parametrize("H,B", [(40, 7), (130, 20), (512, 16)])
def test_k7b(dev, H, B):
    """K7b against its plain version, each output within 1e-4 of its
    largest magnitude (float32 sums in another order, dWh over all T*B
    rows); two launches give the same bits (no atomics)."""
    ins, mask, dys = _bidir_case(dev, H, B)
    with full_fp32():
        ys = gru_scan_bidir_plain(*ins, mask)
    ysp = [prev_states(y, False) for y in ys]
    args = (ins[0], ins[1], *ysp, ins[2], ins[3], mask, *dys)
    before = gru_scan_bidir_bwd.launches
    got = gru_scan_bidir_bwd(*args)
    again = gru_scan_bidir_bwd(*args)
    assert gru_scan_bidir_bwd.launches == before + 2
    with full_fp32():
        want = gru_scan_bidir_bwd_plain(*args)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())
    assert not got[0][:, 3].any()


def test_bidir_autograd_runs_k7_then_k7b(dev):
    """Under autograd on CUDA, gru_scan_bidir launches K7 in the forward
    and K7b in the backward, and no plain version; the gradients match
    autograd through the plain version within 1e-4 of their largest
    magnitude. Under no_grad only K7 runs."""
    ins, mask, dys = _bidir_case(dev, 64, 9)
    k7, k7b = gru_scan_bidir_fwd.launches, gru_scan_bidir_bwd.launches
    leaves = [t.clone().requires_grad_() for t in ins]
    with full_fp32(), \
            mock.patch.object(gru_mod, "gru_scan_bidir_plain", _no_plain), \
            mock.patch.object(gru_mod, "gru_scan_bidir_bwd_plain",
                              _no_plain):
        ys = gru_scan_bidir(*leaves, mask)
        torch.autograd.backward(ys, dys)
        torch.cuda.synchronize()
    assert (gru_scan_bidir_fwd.launches,
            gru_scan_bidir_bwd.launches) == (k7 + 1, k7b + 1)
    ref = [t.clone().requires_grad_() for t in ins]
    with full_fp32():
        torch.autograd.backward(gru_scan_bidir_plain(*ref, mask), dys)
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, rtol=0,
                                   atol=1e-4 * r.grad.abs().max().item())
    with torch.no_grad():
        gru_scan_bidir(*leaves, mask)
    assert gru_scan_bidir_bwd.launches == k7b + 1


def test_fused_bidir_training_step_on_cuda(dev):
    """A DeepSpeechCTC(fused_bidir=True) training forward and backward on
    CUDA (K7, K7b once per layer) against the same model with the plain
    scans: log-probs within 1e-4, every gradient within 1e-4 of the
    model's largest gradient magnitude. (Not of each tensor's own: a
    batch-norm scale's gradient is a sum over every frame that cancels
    to far below its terms, so its own largest entry measures the
    cancellation; the kernels' own bounds are held per output above.)"""
    kw = dict(num_classes=12, rnn_hidden=48, rnn_layers=2, conv_channels=4,
              dropout=0.0, fused_bidir=True, pallas_gru=True, in_features=40)
    g = torch.Generator().manual_seed(0)
    kern = create_model("deepspeech_ctc", **kw, generator=g)
    plain = create_model("deepspeech_ctc", **kw)
    plain.load_state_dict(kern.state_dict())
    feats = torch.randn(3, 37, 40, generator=g).to(dev)
    lens = torch.tensor([37, 22, 5]).to(dev)
    wts = torch.randn(3, 19, 12, generator=g).to(dev)
    k7, k7b = gru_scan_bidir_fwd.launches, gru_scan_bidir_bwd.launches
    outs = []
    for model in (kern, plain):
        model.to(dev).train()
        ctx = (mock.patch.multiple(
            gru_mod, gru_scan_bidir_fwd=gru_scan_bidir_plain,
            gru_scan_bidir_bwd=gru_scan_bidir_bwd_plain)
            if model is plain else contextlib.nullcontext())
        with full_fp32(), ctx:
            logp, _ = model(feats, lens)
            torch.sum(logp * wts).backward()
        torch.cuda.synchronize()
        outs.append(logp.detach())
    assert (gru_scan_bidir_fwd.launches,
            gru_scan_bidir_bwd.launches) == (k7 + 2, k7b + 2)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
    grads = [(name, a.grad, b.grad) for (name, a), b in
             zip(kern.named_parameters(), plain.parameters())]
    top = max(b.abs().max().item() for _, _, b in grads)
    for name, a, b in grads:
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * top, f"{name}: {err:.3e} > 1e-4 * {top:.3e}"
