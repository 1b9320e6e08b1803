"""tpuasr_torch CUDA kernels against their plain versions, on the card.

Marked ``gpu``: skipped where CUDA is absent. The card's machine has no
jax, so run these without the suite's jax conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

``chip_smoke.py`` checks the same kernels at the served shapes; these keep
small ragged shapes that a kernel edit can be iterated on.
"""

import contextlib
import ctypes
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from tpuasr_torch import _build
from tpuasr_torch.decode.beam import (backtrack, backtrack_plain, beam_plan,
                                      beam_scan, beam_scan_plain)
from tpuasr_torch.decode.beam import ctc_beam_search as kernel_search
from tpuasr_torch.features import FeatureConfig, fbank_power
from tpuasr_torch.features.fused import fbank_power_plain
from tpuasr_torch.features.reference import (feature_tables, frames_plain,
                                             num_frames)
from tpuasr_torch.decode import prefix_beam as pbm
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
                                  gru_scan_xfused, gru_scan_xfused_bwd,
                                  gru_scan_xfused_bwd_plain,
                                  gru_scan_xfused_plain,
                                  gru_scan_xfused_q8, gru_scan_xfused_q8_plain,
                                  prev_states)
from tpuasr_torch.ops.quant import quantize_per_channel
from tpuasr_torch.models import capsnet as capsnet_mod
from tpuasr_torch.models import create_model
from tpuasr_torch.ops import routing as routing_mod
from tpuasr_torch.ops.routing import (routed_caps, routed_caps_bwd,
                                      routed_caps_bwd_from,
                                      routed_caps_bwd_plain,
                                      routed_caps_plain, routing_plan,
                                      routing_residuals,
                                      routing_residuals_plain, routing_smem,
                                      squash)
from tpuasr_torch.precision import full_fp32

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# test_fbank's cases: (FeatureConfig fields, B, S). S = 1.5 s + 17 samples
# gives T off any tile height (148 frames at 8 kHz, 148 at 16 kHz); "B1_T1"
# is one frame of one utterance; "T65" one frame past a tile of 64.
FBANK_CASES = {
    "8000": (dict(sample_rate=8000), 3, 12017),
    "16000": (dict(sample_rate=16000), 3, 24017),
    "spectrogram8000": (dict(feature_type="spectrogram"), 2, 12017),
    "spectrogram16000": (dict(sample_rate=16000, feature_type="spectrogram"),
                         2, 24017),
    "nfft512_8000": (dict(n_fft=512), 2, 12017),
    "nfft2048_16000": (dict(sample_rate=16000, n_fft=2048), 2, 24017),
    "hop110": (dict(sample_rate=11025), 3, 16555),
    "B1_T1": (dict(), 1, 200),
    "T65": (dict(), 5, 64 * 80 + 200),
}


def _fbank_inputs(dev, case, seed=0):
    kw, nb, S = FBANK_CASES[case]
    cfg = FeatureConfig(**kw)
    tabs = feature_tables(cfg, dev)
    wav = torch.randn(nb, S, generator=torch.Generator().manual_seed(seed))
    return cfg, tabs, wav.to(dev), num_frames(cfg, S)


def _log_close(got, ref):
    torch.testing.assert_close(torch.log(got.clamp(min=1e-10)),
                               torch.log(ref.clamp(min=1e-10)),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", list(FBANK_CASES))
def test_fbank(dev, case):
    cfg, tabs, wav, T = _fbank_inputs(dev, case)
    got = fbank_power(wav, tabs, cfg.hop_length, T)
    ref = fbank_power_plain(wav, tabs, cfg.hop_length, T)
    assert got.shape == ref.shape == (wav.shape[0], T, cfg.base_dim)
    _log_close(got, ref)


@pytest.mark.parametrize("sr", [8000, 16000])
def test_fbank_wide_range(dev, sr):
    """A 1 kHz tone with noise 90 dB below it: split TF32 holds the gate
    (tests/test_torch_fbank_plan.py shows one TF32 product does not)."""
    cfg = FeatureConfig(sample_rate=sr)
    tabs = feature_tables(cfg, dev)
    S = 2 * sr
    rng = np.random.default_rng(0)
    t = np.arange(S) / sr
    wav = (0.5 * np.sin(2 * np.pi * 1000.0 * t)[None]
           + 0.5 * 10 ** -4.5 * rng.standard_normal((2, S)))
    wav = torch.as_tensor(wav.astype(np.float32), device=dev)
    T = num_frames(cfg, S)
    _log_close(fbank_power(wav, tabs, cfg.hop_length, T),
               fbank_power_plain(wav, tabs, cfg.hop_length, T))


@pytest.mark.parametrize("sr,nb", [(8000, 16), (16000, 8)])
def test_fbank_spectrogram_against_float64(dev, sr, nb):
    """The spectrogram at full size (10 s): its single bins near a spectral
    null are where rounding shows most, and there the plain float32 matmuls
    themselves lie ~2-3e-3 (log) from a float64 rDFT, more than the 1e-3
    gate against the plain version. Split TF32 keeps 22 of float32's 24
    bits of each operand (a unit roundoff 4x float32's): the kernel must
    lie at most 4x as far from float64 as the plain version does."""
    cfg = FeatureConfig(sample_rate=sr, feature_type="spectrogram")
    tabs = feature_tables(cfg, dev)
    S = 10 * sr
    wav = (torch.randn(nb, S, generator=torch.Generator().manual_seed(1))
           * 0.1).to(dev)
    T = num_frames(cfg, S)
    got = fbank_power(wav, tabs, cfg.hop_length, T).double()
    ref = fbank_power_plain(wav, tabs, cfg.hop_length, T).double()
    t64 = {k: tabs[k].double() for k in ("window", "cos", "sin", "proj")}
    x = frames_plain(wav.double(), cfg.hop_length, cfg.win_length,
                     T) * t64["window"]
    exact = ((x @ t64["cos"]) ** 2 + (x @ t64["sin"]) ** 2) @ t64["proj"]

    def err(a):
        return (torch.log(a.clamp(min=cfg.log_floor))
                - torch.log(exact.clamp(min=cfg.log_floor))).abs().max()

    assert err(got) <= 4 * err(ref)


@pytest.mark.parametrize("case", ["8000", "16000", "hop110"])
def test_fbank_two_calls_same_bits(dev, case):
    cfg, tabs, wav, T = _fbank_inputs(dev, case, seed=2)
    a = fbank_power(wav, tabs, cfg.hop_length, T)
    assert torch.equal(a, fbank_power(wav, tabs, cfg.hop_length, T))


# Plans the plan does not pick at these sizes: the mma.sync tile heights, a
# ring of 2 or 3 stages, narrow chunks (many rDFT and mel chunks), and few
# persistent CTAs, each walking several tiles.
FBANK_PLANS = {
    "M64_k2_2stages": dict(M=64, stage_k=2, stages=2),
    "M64_k2_3stages_3ctas": dict(M=64, stage_k=2, stages=3, ctas=3),
    "M64_k4_1cta": dict(M=64, stage_k=4, stages=2, ctas=1),
    "M32_chunks": dict(M=32, dft_nt=5, mel_nt=3),
    "M16_narrow": dict(M=16, dft_nt=1, mel_nt=1, stages=2),
    "M32_1cta": dict(M=32, ctas=1),
}


@pytest.mark.parametrize("case", ["8000", "hop110", "spectrogram16000"])
@pytest.mark.parametrize("forced", list(FBANK_PLANS))
def test_fbank_plans(dev, case, forced):
    from tpuasr_torch.features import fused as fused_mod
    cfg, tabs, wav, T = _fbank_inputs(dev, case, seed=3)
    real = fused_mod.fbank_plan

    def plan(B, T, hop, win, nf, n_out, n_sm=132, paired=True):
        want = FBANK_PLANS[forced]
        p = real(B, T, hop, win, nf, n_out, n_sm, paired, M=want["M"])
        dft_nt = want.get("dft_nt", p.dft_nt)
        mel_nt = want.get("mel_nt", p.mel_nt)
        stages = want.get("stages", p.stages)
        stage_k = want.get("stage_k", p.stage_k)
        p = dataclasses.replace(
            p, stage_k=stage_k, stages=stages, dft_nt=dft_nt, mel_nt=mel_nt,
            dft_chunks=-(-(p.Nd // 8) // dft_nt),
            mel_chunks=-(-(p.No // 8) // mel_nt),
            ctas=min(want.get("ctas", n_sm), p.grid[0] * B),
            smem=fused_mod.fbank_smem(p.M, hop, p.Kp, p.nfp, stage_k,
                                      8 * max(dft_nt, mel_nt), stages))
        if p.smem > fused_mod.SMEM_LIMIT:
            pytest.skip(f"{forced} does not fit {case}")
        return p

    with mock.patch.object(fused_mod, "fbank_plan", plan):
        got = fbank_power(wav, tabs, cfg.hop_length, T)
    _log_close(got, fbank_power_plain(wav, tabs, cfg.hop_length, T))


def test_fbank_plan_matches_kernel_smem(dev):
    from tpuasr_torch.features import fused as fused_mod
    fn = _build.lib().tpuasr_fbank_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    for case in FBANK_CASES:
        cfg = FeatureConfig(**FBANK_CASES[case][0])
        for B, T in ((1, 1), (8, 499), (128, 998)):
            p = fused_mod.fbank_plan(B, T, cfg.hop_length, cfg.win_length,
                                     cfg.n_freqs, cfg.base_dim)
            assert fn(p.M, cfg.hop_length, p.Kp, p.nfp, p.stage_k,
                      8 * max(p.dft_nt, p.mel_nt), p.stages) == p.smem


def test_fbank_launch_code_checked(dev):
    """The launcher refuses a plan whose shared memory is not its layout's,
    a chunk wider than its warps hold, and more CTAs than tiles, before any
    launch."""
    from tpuasr_torch.features import fused as fused_mod
    cfg, tabs, wav, T = _fbank_inputs(dev, "8000")
    p = fused_mod.fbank_plan(wav.shape[0], T, cfg.hop_length,
                             cfg.win_length, cfg.n_freqs, cfg.base_dim)
    for bad in (dict(smem=p.smem + 4), dict(dft_nt=100),
                dict(ctas=p.grid[0] * p.grid[1] + 1)):
        with mock.patch.object(fused_mod, "fbank_plan",
                               lambda *a, **k: dataclasses.replace(p, **bad)):
            with pytest.raises(RuntimeError, match="fbank_power"):
                fbank_power(wav, tabs, cfg.hop_length, T)


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


# K2 / K4 by (x dtype, kernel): K2 in f32 and bf16; K4 with the recurrence
# in x's dtype or in int8 (rec_q8), for bf16 and f32 streams.
XFUSED_KINDS = {
    "k2_f32": (torch.float32, "k2"), "k2_bf16": (torch.bfloat16, "k2"),
    "k4_bf16": (torch.bfloat16, "k4"), "k4_rec_bf16": (torch.bfloat16, "rec"),
    "k4_f32": (torch.float32, "k4"), "k4_rec_f32": (torch.float32, "rec")}


def _xfused_call(kind, T, B, D, H, reverse, dev, seed=3):
    """(kernel wrapper, plain version, args, kwargs) of one K2/K4 case with
    ragged rows: full length, length 1, all padding, and random lengths."""
    dtype, which = XFUSED_KINDS[kind]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, D, generator=g).to(dev, dtype)
    wx = (torch.randn(D, 3 * H, generator=g) / D ** 0.5).to(dev)
    wh = (torch.randn(H, 3 * H, generator=g) / H ** 0.5).to(dev)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(dev)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[:3] = torch.tensor([T, 1, 0])[:B]
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    mask = mask.to(dev).contiguous()
    if which == "k2":
        return (gru_scan_xfused, gru_scan_xfused_plain,
                (x, wx.to(dtype), b, wh.to(dtype), mask, reverse), {})
    wxq, sw = quantize_per_channel(wx)
    if which == "rec":
        whq, swh = quantize_per_channel(wh)
        return (gru_scan_xfused_q8, gru_scan_xfused_q8_plain,
                (x, wxq, sw, b, whq, mask, reverse), {"wh_scale": swh})
    return (gru_scan_xfused_q8, gru_scan_xfused_q8_plain,
            (x, wxq, sw, b, wh.to(dtype), mask, reverse), {})


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,D,H", [(37, 1, 70, 40), (37, 7, 96, 70),
                                     (21, 129, 70, 520), (1, 7, 70, 40),
                                     (9, 129, 1040, 70)])
@pytest.mark.parametrize("kind", list(XFUSED_KINDS))
def test_k2_k4_odd_shapes(dev, kind, T, B, D, H, reverse):
    """K2 and K4 against their plain versions where H is no multiple of the
    unit split (8), B none of the row pass (B=1, 7, 129), T=1, D unaligned
    (70) and aligned, both directions: f32 within 1e-4 of the largest
    magnitude, bf16 and int8 streams within 2e-2 (one bf16 ulp flipped
    and carried, as chip_smoke's gate); two launches give the same bits; a
    call counts one launch; an all-padded row stays zero."""
    kern, plain, args, kw = _xfused_call(kind, T, B, D, H, reverse, dev)
    before = kern.launches
    with full_fp32():
        got = kern(*args, **kw)
        want = plain(*args, **kw)
    assert kern.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == (T, B, H)
    tol = (1e-4 * want.abs().max().item() if got.dtype == torch.float32
           else 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert torch.equal(got, kern(*args, **kw))
    if B > 2:
        assert not got[:, 2].any()


@pytest.mark.parametrize("kind", ["k2_bf16", "k4_rec_bf16", "k2_f32"])
def test_k2_k4_refuse_an_unplannable_shape(dev, kind):
    """A shape the plan cannot hold raises ValueError before any launch:
    the counter does not move. bf16 at H=2048 needs more shared memory
    than a block has; f32 at H=3000 more units a block than K5 takes; int8
    recurrence past H=1040 is refused by its own check."""
    H = {"k2_bf16": 2048, "k4_rec_bf16": 1100, "k2_f32": 3000}[kind]
    kern, _, args, kw = _xfused_call(kind, 2, 1, 8, H, False, dev)
    before = kern.launches
    with pytest.raises(ValueError):
        kern(*args, **kw)
    assert kern.launches == before


@pytest.mark.parametrize("kind", list(XFUSED_KINDS))
@pytest.mark.parametrize("B,D,H", [(1, 70, 40), (128, 1024, 512),
                                   (16, 768, 384), (129, 512, 520)])
def test_scan_plan_matches_kernel_layout(dev, kind, B, D, H):
    """The plan's shared memory is what the recurrence kernel lays out for
    its (U, R) (the f32 recurrence, csrc/gru_bidir.cu's, for its (U, kc)):
    the launcher refuses any other."""
    dtype, which = XFUSED_KINDS[kind]
    mode = {"k2": gru_mod._MODE_K2, "k4": gru_mod._MODE_Q8,
            "rec": gru_mod._MODE_Q8_REC}[which]
    plan = gru_mod._scan_plan(B, D, H, mode, dtype, gru_mod._sm_count(dev))
    if plan.rec == "f32":
        fn = _build.lib().tpuasr_gru_bidir_fwd_smem
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
        assert fn(H, plan.U, plan.kc) == plan.smem
        return
    fn = _build.lib().tpuasr_gru_rec_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    assert fn(gru_mod._KINDS[plan.rec], H, plan.U, plan.R) == plan.smem


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


@pytest.mark.parametrize("order", [0, 2, 3])
@pytest.mark.parametrize("C", [5, 48, 64])
@pytest.mark.parametrize("K", [1, 8, 32, 33, 127])
def test_k3_exact_any_beam(dev, K, C, order):
    """K3 at every lane-list layout (K <= 8: lists of 8; K up to 32: lists
    of 32; K = 33 and 127: passes of 32) without and with LM fusion equals
    its plain version bit for bit: backpointers, scores, LM scores, last
    and last2, on ragged rows (0, 1 and full length) with the max_len cap
    reached."""
    g = torch.Generator().manual_seed(K * 100 + C + order)
    T = 12 if K > 32 else 24
    lp = torch.log_softmax(torch.randn(4, T, C, generator=g) * 2, -1)
    tab = (torch.log_softmax(torch.randn((C + 1) ** (order - 1), C,
                                         generator=g), -1).to(dev)
           if order else None)
    lens = torch.tensor([T, 0, 1, T - 3], dtype=torch.int32).to(dev)
    args = (lp.to(dev).contiguous(), lens, K, 0, T // 2, tab, order, 0.6,
            order == 3)
    before = beam_scan.launches
    got = beam_scan(*args)
    assert beam_scan.launches == before + 1
    ref = beam_scan_plain(*args)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("T,B,K,n,max_len", [(40, 6, 8, 1, 40),
                                             (40, 6, 8, 3, 7),
                                             (499, 128, 8, 1, 256),
                                             (12, 5, 127, 127, 12),
                                             (1, 1, 1, 1, 1)])
def test_backtrack_kernel_exact(dev, T, B, K, n, max_len):
    """The backtrack kernel equals backtrack_plain on seeded backpointers
    (random parents and classes, rows frozen past their length, n-best
    entries from distinct beams, the max_len cap): tokens and lengths
    exact; one launch a call."""
    g = torch.Generator().manual_seed(T + B + K + n)
    parent = torch.randint(0, K, (T, B, K), generator=g)
    ch = torch.randint(-1, 30, (T, B, K), generator=g)
    bp = (parent * 65536 + ch + 1).to(torch.int32)
    lens = torch.randint(0, T + 1, (B,), generator=g)
    for b in range(B):
        bp[lens[b]:, b] = (torch.arange(K) * 65536).to(torch.int32)
    idx = torch.stack([torch.randperm(K, generator=g)[:n] for _ in range(B)])
    before = backtrack.launches
    tok, tl = backtrack(bp.to(dev), idx.to(dev), max_len)
    assert backtrack.launches == before + 1
    want_tok, want_tl = backtrack_plain(bp, idx, max_len)
    assert torch.equal(tok.cpu(), want_tok)
    assert torch.equal(tl.cpu(), want_tl)


def test_beam_plan_matches_kernel_smem(dev):
    """K3's plan (decode/beam.py::beam_plan) reckons the shared memory of
    csrc/ctc_beam.cu's layout (tpuasr_ctc_beam_smem) for every lane-list
    layout, C and LM order, at the served batch and at one utterance."""
    fn = _build.lib().tpuasr_ctc_beam_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for K in (1, 8, 9, 32, 33, 127):
        for C in (5, 48, 64, 1000):
            for order in (0, 2, 3):
                for B in (1, 128, 1000):
                    plan = beam_plan(B, K, C, order, n_sm)
                    assert fn(K, C, plan.warps, int(plan.staged)) == plan.smem


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
    """K10's standalone gather equals the plain gather on int32 tables
    (W=7: the scalar path), float bits in the table and indices past
    either end included."""
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


def _scan_graph(C, seed=5, words=12):
    """A small LG over C classes from the port's own graph functions:
    words of 1-3 classes composed with a word bigram -> (packed (S, 2C)
    int32 table, GraphTables)."""
    from tpuasr_torch.decode import (compile_graph_tables, compose,
                                     lexicon_to_fst, ngram_to_fst)
    from tpuasr_torch.lm import train_ngram
    rng = np.random.default_rng(seed)
    prons, seen = [], set()
    while len(prons) < words:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(1, 4))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons)}", p))
    sents = [[f"w{int(v)}" for v in rng.integers(0, words,
                                                 size=int(rng.integers(2, 5)))]
             for _ in range(40)]
    lg = compose(lexicon_to_fst(prons),
                 ngram_to_fst(train_ngram(sents, order=2),
                              {w: i + 1 for i, (w, _) in enumerate(prons)}))
    g = compile_graph_tables(lg, C, prune=10.0, quantum=0.1)
    pack = torch.cat([torch.as_tensor(g.next_state).to(torch.int32),
                      torch.as_tensor(g.cost).float().view(torch.int32)], 1)
    return pack.contiguous(), g


def _scan_inputs(dev, B, T, C, K, P, order, graph, seed, ties=False):
    """Seeded log-probs (ragged lengths: full, 0, 1, the rest random), a
    fusion table of the order, the bench-like graph and a fresh state."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, C, generator=g) * 2
    if ties:
        logits = logits.round().clamp(-1, 1)
    lp = torch.log_softmax(logits, -1).to(dev).contiguous()
    lens = torch.randint(0, T + 1, (B,), generator=g).to(torch.int32)
    lens[:3] = torch.tensor([T, 0, 1])[:B]
    tab = None
    if order:
        tab = torch.log_softmax(torch.randn((C + 1) ** (order - 1), C,
                                            generator=g), -1)
        tab = tab.to(dev).contiguous()
    cfg = BeamSearchConfig(beam_width=K, class_topk=P)
    state = dict(pbm.beam_init_state(B, cfg, dev),
                 last2=torch.full((B, K), -1, dtype=torch.int32, device=dev))
    pack = None
    if graph:
        pack, gt = _scan_graph(C, seed)
        pack = pack.to(dev)
        state.update(gs=torch.full((B, K), gt.start, dtype=torch.int32,
                                   device=dev),
                     gc=torch.zeros((B, K), device=dev))
    return lp, lens.to(dev), tab, pack, state


def _scan_same(got, ref):
    """Backpointers and every integer field exact, floats within 1e-4."""
    (gbp, gs_), (rbp, rs) = got, ref
    assert torch.equal(gbp, rbp)
    assert set(gs_) == set(rs)
    for n in rs:
        if rs[n].dtype.is_floating_point:
            torch.testing.assert_close(gs_[n], rs[n], rtol=0, atol=1e-4,
                                       msg=n)
        else:
            assert torch.equal(gs_[n], rs[n].to(gs_[n].dtype)), n


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("order", [0, 2, 3])
@pytest.mark.parametrize("P", [2, "full"])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_k10_scan_search_exact(dev, K, P, order, graph):
    """The scan-search kernel against its plain version on the card: with
    and without a graph, without LM, with a bigram and a trigram, P = 2 and
    C - 1, frozen rows (lengths 0, 1 and random) and a max_len that kills
    extends: backpointers, plen, last, last2, h1, h2, gs exact (dead lanes
    included), p_b, p_nb, lm, gc within 1e-4; one launch."""
    C = 12
    P = C - 1 if P == "full" else P
    lp, lens, tab, pack, state = _scan_inputs(dev, 6, 30, C, K, P, order,
                                              graph, K * 10 + P + order)
    args = (lp, lens, state, K, P, 0, 7, tab, order, 0.6, pack, 0.8)
    before = pbm.scan_search.launches
    got = pbm.scan_search(*args)
    assert pbm.scan_search.launches == before + 1
    _scan_same(got, pbm.scan_search_plain(*args))
    assert int(got[1]["plen"].max()) >= 7      # the cap was reached


@pytest.mark.parametrize("C,P,K", [(64, 8, 8), (64, 63, 8), (40, 30, 16),
                                   (33, 9, 5), (100, 99, 8), (300, 7, 8),
                                   (1024, 1023, 8)])
def test_k10_scan_search_lane_classes(dev, C, P, K):
    """Each build of the kernel (2, 8 and 32 classes a lane: C up to 64,
    256 and 1024) and both sorts of the 2-class build (the top next_pow2(P)
    by folding where P <= 16, else the whole warp; the extends' top K the
    same way) with a graph and a bigram, ties in the log-probs."""
    lp, lens, tab, pack, state = _scan_inputs(dev, 4, 9, C, K, P, 2, True,
                                              C + P, ties=True)
    args = (lp, lens, state, K, P, 0, 256, tab, 2, 0.5, pack, 1.0)
    _scan_same(pbm.scan_search(*args), pbm.scan_search_plain(*args))


def test_k10_scan_search_largest_shape(dev):
    """K=32 (a block of 1024 threads) at C=1024, P=1023 with a graph."""
    lp, lens, tab, pack, state = _scan_inputs(dev, 3, 5, 1024, 32, 1023, 0,
                                              True, 11)
    args = (lp, lens, state, 32, 1023, 0, 8, None, 0, 0.0, pack, 1.0)
    _scan_same(pbm.scan_search(*args), pbm.scan_search_plain(*args))


@pytest.mark.parametrize("graph", [False, True])
def test_k10_search_resumed_on_the_card(dev, graph):
    """The whole search (ctc_beam_search_xla) in two chunks with a bigram,
    the second resumed from the first's state, on the card against the same
    calls on the CPU (the plain versions): tokens, token_lens,
    reached_final and every integer state field exact, scores and float
    state within 1e-4; one scan-search and one rebuild launch a call."""
    from tpuasr_torch.decode import ctc_beam_search_xla
    C, K, T = 12, 8, 30
    g = torch.Generator().manual_seed(4)
    lp = torch.log_softmax(torch.randn(5, T, C, generator=g) * 2, -1)
    lens = torch.tensor([T, 0, 1, 17, 29], dtype=torch.int32)
    bigram = torch.log_softmax(torch.randn(C + 1, C, generator=g), -1)
    eos = torch.randn(C + 1, generator=g) - 3
    gt = _scan_graph(C, 9)[1] if graph else None
    cfg = BeamSearchConfig(beam_width=K, class_topk=3, max_len=20,
                           lm_weight=0.5, graph_weight=0.8)
    cut = 12
    l1 = lens.clamp(max=cut)
    outs = {}
    for where in ("cpu", dev):
        kw = dict(lm_bigram=bigram.to(where), lm_eos=eos.to(where),
                  graph=gt)
        s0, r0 = pbm.scan_search.launches, pbm.rebuild_prefixes.launches
        a = ctc_beam_search_xla(lp[:, :cut].to(where), l1.to(where), cfg,
                                return_state=True, **kw)
        b = ctc_beam_search_xla(lp[:, cut:].contiguous().to(where),
                                (lens - l1).to(where), cfg, n_best=3,
                                init_state=a["state"], return_state=True,
                                **kw)
        launched = (pbm.scan_search.launches - s0,
                    pbm.rebuild_prefixes.launches - r0)
        assert launched == ((0, 0) if where == "cpu" else (2, 2))
        outs[str(where)] = b
    want, got = outs["cpu"], outs[str(dev)]
    keys = ("tokens", "token_lens") + (("reached_final",) if graph else ())
    for k in keys:
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("scores", "am_scores", "lm_scores"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)
    for n, v in want["state"].items():
        if v.dtype.is_floating_point:
            torch.testing.assert_close(got["state"][n].cpu(), v, rtol=0,
                                       atol=1e-4, msg=n)
        else:
            assert torch.equal(got["state"][n].cpu(), v), n


def test_k10_scan_search_raises_past_its_limits(dev):
    """On a CUDA tensor a shape the kernel does not take raises ValueError
    naming the limit, before any launch; nothing falls back."""
    from tpuasr_torch.decode import ctc_beam_search_xla
    lp = torch.log_softmax(torch.randn(2, 4, 12), -1).to(dev)
    lens = torch.tensor([4, 3], device=dev)
    before = pbm.scan_search.launches
    with pytest.raises(ValueError, match="beam_width"):
        ctc_beam_search_xla(lp, lens, BeamSearchConfig(beam_width=33))
    with pytest.raises(ValueError, match="class_topk"):
        ctc_beam_search_xla(lp, lens, BeamSearchConfig(class_topk=0))
    wide = torch.log_softmax(torch.randn(1, 2, 1025), -1).to(dev)
    with pytest.raises(ValueError, match="classes"):
        ctc_beam_search_xla(wide, torch.tensor([2], device=dev),
                            BeamSearchConfig(beam_width=4))
    assert pbm.scan_search.launches == before


def test_k10_scan_plan_matches_kernel_smem(dev):
    """csrc/scan_beam.cu's shared memory a block (tpuasr_scan_beam_smem) at
    every K it takes: 16-byte aligned and, with the kernel's static clock
    sums, within the card's 227 KB a block."""
    fn = _build.lib().tpuasr_scan_beam_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for K in range(1, pbm.MAX_K + 1):
        assert fn(K) % 16 == 0
        assert fn(K) + 8 * len(pbm.CLOCK_PARTS) <= 232448


def test_k10_scan_search_clocks(dev):
    """The clock parts of a frame: as many as the kernel counts, one
    non-negative count a part for each utterance with frames; the kernel's
    results do not change."""
    parts = _build.lib().tpuasr_scan_beam_clock_parts
    parts.restype = ctypes.c_int
    assert parts() == len(pbm.CLOCK_PARTS)
    lp, lens, tab, pack, state = _scan_inputs(dev, 4, 20, 64, 8, 8, 0, True,
                                              3)
    args = (lp, lens, state, 8, 8, 0, 256, None, 0, 0.0, pack, 1.0)
    clocks = torch.zeros((4, len(pbm.CLOCK_PARTS)), dtype=torch.int64,
                         device=dev)
    got = pbm.scan_search(*args, clocks=clocks)
    _scan_same(got, pbm.scan_search(*args))
    assert bool((clocks >= 0).all()) and int(clocks[0].sum()) > 0


@pytest.mark.parametrize("T,B,K,L", [(40, 6, 8, 40), (40, 6, 8, 7),
                                     (499, 128, 8, 256), (12, 5, 32, 12),
                                     (1, 1, 1, 1)])
def test_k10_rebuild_exact(dev, T, B, K, L):
    """The rebuild (the backtrack kernel with a base) equals
    rebuild_prefixes_plain on seeded backpointers with frozen rows, base
    prefixes of random lengths and the max_len cap: prefixes and root
    lanes exact; one launch."""
    g = torch.Generator().manual_seed(T + B + K + L)
    parent = torch.randint(0, K, (T, B, K), generator=g)
    ch = torch.randint(-1, 30, (T, B, K), generator=g)
    bp = (parent * 65536 + ch + 1).to(torch.int32)
    lens = torch.randint(0, T + 1, (B,), generator=g)
    for b in range(B):
        bp[lens[b]:, b] = (torch.arange(K) * 65536).to(torch.int32)
    base_len = torch.randint(0, L + 1, (B, K), generator=g).to(torch.int32)
    base = torch.randint(0, 30, (B, K, L), generator=g).to(torch.int32)
    base = torch.where(torch.arange(L) < base_len[:, :, None], base, -1)
    before = pbm.rebuild_prefixes.launches
    got = pbm.rebuild_prefixes(bp.to(dev), base.to(dev), base_len.to(dev), L)
    assert pbm.rebuild_prefixes.launches == before + 1
    want = pbm.rebuild_prefixes_plain(bp, base, base_len, L)
    for a, r in zip(got, want):
        assert torch.equal(a.cpu(), r)


def _scan_case(dev, H, B=7, T=37):
    g = torch.Generator().manual_seed(3)
    xp = torch.randn(T, B, 3 * H, generator=g)
    wh = torch.randn(H, 3 * H, generator=g) / H ** 0.5
    dys = torch.randn(T, B, H, generator=g)
    lens = torch.randint(0, T + 1, (B,), generator=g)
    lens[:7] = torch.tensor([T, 30, 1, 0, 12, T, 5])[:B].clamp(max=T)
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


@pytest.mark.parametrize("B,H,reverse", [(683, 512, False), (16, 640, True),
                                         (16, 1024, False), (1, 40, False),
                                         (1, 130, True)])
def test_k5b_any_batch_and_width(dev, B, H, reverse):
    """K5b at the shapes it once refused (683 rows at H=512, H=640; H=1024
    stages dhp a gate at a time) and at one row: dxp and dwh within 1e-4
    of their largest magnitude, and two calls give the same bits (dWh
    summed in a fixed order)."""
    xp, wh, mask, dys = _scan_case(dev, H, B, T=9)
    with full_fp32():
        ysp = prev_states(gru_scan_plain(xp, wh, mask, reverse), reverse)
        got = gru_scan_bwd(xp, ysp, wh, mask, dys, reverse)
        want = gru_scan_bwd_plain(xp, ysp, wh, mask, dys, reverse)
    again = gru_scan_bwd(xp, ysp, wh, mask, dys, reverse)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


# K5's forward and K2's f32 recurrence: csrc/gru_bidir.cu's row-grouped
# recurrence at one direction (ops/gru.py::_f32_rec_plan), forward and
# reverse, at the widths and batches K5 serves.
_ONE_DIR = [(H, B) for H in (384, 512, 640, 1056) for B in (1, 16, 64, 683)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B", _ONE_DIR)
def test_k5_one_direction(dev, H, B, reverse):
    """K5 against gru_scan_plain within 1e-5 at a short T (T=9: float32
    sums of H terms in another order, carried over 9 steps) on ragged rows
    (a row of length 0 stays zero); two calls give the same bits; a call
    counts one launch."""
    xp, wh, mask, _ = _scan_case(dev, H, B, T=9)
    before = gru_scan_fwd.launches
    with full_fp32():
        got = gru_scan_fwd(xp, wh, mask, reverse)
        again = gru_scan_fwd(xp, wh, mask, reverse)
        want = gru_scan_plain(xp, wh, mask, reverse)
    assert gru_scan_fwd.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if B > 3:
        assert not got[:, 3].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B", [(40, 7), (512, 64), (640, 16), (1056, 3)])
def test_k5_from_h0(dev, H, B, reverse):
    """K5 from a carried state h0 (streaming) against gru_scan_plain from
    the same h0 within 1e-5 on ragged rows (a row of length 0 keeps h0 at
    every step); a run over two chunks, the second from the first's last
    state, equals one run bit for bit."""
    xp, wh, mask, _ = _scan_case(dev, H, B, T=9)
    g = torch.Generator().manual_seed(5)
    h0 = (torch.randn(B, H, generator=g) * 0.5).to(dev)
    with full_fp32():
        got = gru_scan_fwd(xp, wh, mask, reverse, h0=h0)
        want = gru_scan_plain(xp, wh, mask, reverse, h0=h0)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        if B > 3:
            assert torch.equal(got[:, 3], h0[3].expand(9, H))
        if reverse:
            b = gru_scan_fwd(xp[4:], wh, mask[4:], True, h0=h0)
            a = gru_scan_fwd(xp[:4], wh, mask[:4], True, h0=b[0])
        else:
            a = gru_scan_fwd(xp[:4], wh, mask[:4], h0=h0)
            b = gru_scan_fwd(xp[4:], wh, mask[4:], h0=a[-1])
        assert torch.equal(torch.cat([a, b]), got)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B", [(512, 16), (384, 64)])
def test_k5_trained_length(dev, H, B, reverse):
    """K5 at the trained length (T=249) within 1e-4, chip_smoke's gate
    (sums of H terms in another order carried over 249 steps)."""
    xp, wh, mask, _ = _scan_case(dev, H, B, T=249)
    with full_fp32():
        got = gru_scan_fwd(xp, wh, mask, reverse)
        want = gru_scan_plain(xp, wh, mask, reverse)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(got, gru_scan_fwd(xp, wh, mask, reverse))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B", [(384, 16), (384, 64), (512, 683), (640, 1),
                                 (1056, 16)])
def test_k2_f32_recurrence(dev, H, B, reverse):
    """K2 in float32 (its projection, then K5's recurrence) against its
    plain version within 1e-5 at T=9; two calls give the same bits; an
    all-padded row stays zero."""
    kern, plain, args, kw = _xfused_call("k2_f32", 9, B, 96, H, reverse, dev)
    with full_fp32():
        got = kern(*args, **kw)
        want = plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, kern(*args, **kw))
    if B > 2:
        assert not got[:, 2].any()


def test_k2_backward_route(dev):
    """gru_scan_xfused's backward on the card (K2 forward, then K2b, which
    JAX's rule picks at D=70, H=40) against autograd through its plain
    version: each gradient within 1e-4 of its largest magnitude."""
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


def _xfb_case(dev, D, H, B, T=37, seed=21):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, D, generator=g)
    wx = torch.randn(D, 3 * H, generator=g) / D ** 0.5
    b = torch.randn(3 * H, generator=g) * 0.1
    wh = torch.randn(H, 3 * H, generator=g) / H ** 0.5
    dys = torch.randn(T, B, H, generator=g)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[:4] = torch.tensor([T, 1, 0, 12])[:B]
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    return [t.to(dev).contiguous() for t in (x, wx, b, wh, mask, dys)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D,H,B", [(70, 40, 7), (130, 20, 5), (512, 384, 16),
                                   (768, 384, 20), (70, 40, 1), (96, 130, 1)])
def test_k2b(dev, D, H, B, reverse):
    """K2b against its plain version: dx, dwx, db and dwh each within 1e-4
    of its largest magnitude (K5b's gate: float32 sums in other orders,
    the weight gradients over all T*B rows); two calls equal bit for bit;
    the row of length 0 gets no dx."""
    x, wx, b, wh, mask, dys = _xfb_case(dev, D, H, B)
    with full_fp32():
        ys = gru_scan_xfused_plain(x, wx, b, wh, mask, reverse)
        ysp = prev_states(ys, reverse)
        args = (x, ysp, wx, b, wh, mask, dys, reverse)
        before = gru_scan_xfused_bwd.launches
        got = gru_scan_xfused_bwd(*args)
        assert gru_scan_xfused_bwd.launches == before + 1
        want = gru_scan_xfused_bwd_plain(*args)
    for a, w in zip(got, want):
        tol = 1e-4 * w.abs().max().item()
        torch.testing.assert_close(a, w, rtol=0, atol=tol)
    assert all(torch.equal(a, c) for a, c in zip(got,
                                                 gru_scan_xfused_bwd(*args)))
    if B > 2:
        assert not got[0][:, 2].any()


@pytest.mark.parametrize("D,H,B", [(1100, 384, 2), (320, 512, 146),
                                   (768, 384, 609)])
def test_k2b_holds_the_shapes_it_once_refused(dev, D, H, B):
    """K2b at the shapes the fused kernel refused (D > 1024 at H=384; 146
    rows at H=512; 609 rows at D=768): each output within 1e-4 of its
    largest magnitude of the plain version's, two calls bit for bit."""
    x, wx, b, wh, mask, dys = _xfb_case(dev, D, H, B, T=7)
    with full_fp32():
        ysp = prev_states(gru_scan_xfused_plain(x, wx, b, wh, mask), False)
        args = (x, ysp, wx, b, wh, mask, dys)
        got = gru_scan_xfused_bwd(*args)
        want = gru_scan_xfused_bwd_plain(*args)
    again = gru_scan_xfused_bwd(*args)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


@pytest.mark.parametrize("D,H,fused", [(70, 40, True), (768, 384, True),
                                       (1024, 512, False)])
def test_xfused_backward_launches_by_rule(dev, D, H, fused):
    """_XFusedScan.backward launches K2b where JAX's rule takes the fused
    backward (xfused_bwd_is_fused), and K5b elsewhere; the gradients are
    finite either way."""
    assert gru_mod.xfused_bwd_is_fused(D, H) == fused
    x, wx, b, wh, mask, _ = _xfb_case(dev, D, H, 4, T=9)
    args = [t.requires_grad_() for t in (x, wx, b, wh)]
    k2b, k5b = gru_scan_xfused_bwd.launches, gru_scan_bwd.launches
    with full_fp32():
        gru_scan_xfused(*args, mask).sum().backward()
    assert (gru_scan_xfused_bwd.launches - k2b,
            gru_scan_bwd.launches - k5b) == ((1, 0) if fused else (0, 1))
    assert all(torch.isfinite(t.grad).all() for t in args)


def test_ctc_kernels(dev):
    """K6/K6b on the edge cases (no frames, empty label, repeats, an
    infeasible row, garbage labels, a label equal to the blank, a row
    longer than T), int32 and int64 indices, S up to 1023 (every lane
    instance): the loss within rtol 1e-5, reachable alphas within rtol 1e-5
    and unreachable where the plain version's are, the gradient within
    1e-4 of its largest magnitude, two calls bit for bit, one launch
    each."""
    g = torch.Generator().manual_seed(4)
    for (B, T, C, U), wide in (((8, 50, 9, 6), False), ((8, 50, 9, 6), True),
                               ((3, 90, 20, 40), False),
                               ((2, 300, 30, 70), True),
                               ((2, 700, 30, 300), False),
                               ((2, 1100, 64, 511), False)):
        lp = torch.log_softmax(torch.randn(B, T, C, generator=g) * 2, -1)
        labels = torch.randint(1, C, (B, U), generator=g)
        il = torch.randint(min(2 * U + 1, T), T + 1, (B,), generator=g)
        ll = torch.full((B,), U)
        if B == 8:
            il = torch.tensor([T, 0, 44, 12, 6, 31, T + 4, 27])
            ll = torch.tensor([U, 3, 0, 4, 4, 5, 2, 6])
            labels[3, :4] = torch.tensor([5, 5, 5, 2])
            labels[4, :4] = 7
            labels[5, 1] = 0
            labels[6, 2:] = torch.tensor([-3, 99, 0, 40])
        idx = torch.int64 if wide else torch.int32
        args = (lp.to(dev), labels.to(dev, idx), il.to(dev, idx),
                ll.to(dev, idx))
        w = (torch.rand(B, generator=g) + 0.5).to(dev)
        n6, n6b = ctc_mod.ctc_forward.launches, ctc_mod.ctc_backward.launches
        got = ctc_mod.ctc_forward(*args)
        want = ctc_mod.ctc_forward_plain(*args)
        gk = ctc_mod.ctc_backward(*args, got[2], got[1], w)
        gp = ctc_mod.ctc_backward_plain(*args, want[2], want[1], w)
        assert (ctc_mod.ctc_forward.launches - n6,
                ctc_mod.ctc_backward.launches - n6b) == (1, 1)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        reach = want[2] > -1e29
        assert torch.equal(got[2] > -1e29, reach)
        torch.testing.assert_close(got[2][reach], want[2][reach], rtol=1e-5,
                                   atol=1e-6)
        assert (gk - gp).abs().max() <= 1e-4 * gp.abs().max()
        again = ctc_mod.ctc_forward(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert torch.equal(gk, ctc_mod.ctc_backward(*args, again[2],
                                                    again[1], w))


def test_ctc_backward_class_limit(dev):
    """K6b at the most classes bwd_max_classes allows (U = 6: one state a
    lane, U = 40: three) against its plain version, the gradient within
    1e-4 of its largest magnitude; at one class more the C entry refuses
    the launch too, so the Python limit is the kernel's."""
    g = torch.Generator().manual_seed(5)
    for U in (6, 40):
        B, T, C = 2, 2 * U + 10, ctc_mod.bwd_max_classes(U)
        lp = torch.log_softmax(torch.randn(B, T, C, generator=g), -1).to(dev)
        labels = torch.randint(1, C, (B, U), generator=g).to(dev)
        il = torch.tensor([T, T - 3], device=dev)
        ll = torch.tensor([U, U - 2], device=dev)
        w = torch.tensor([1.0, 0.5], device=dev)
        _, ll_k, alphas = ctc_mod.ctc_forward(lp, labels, il, ll)
        gk = ctc_mod.ctc_backward(lp, labels, il, ll, alphas, ll_k, w)
        gp = ctc_mod.ctc_backward_plain(lp, labels, il, ll, alphas, ll_k, w)
        assert gp.abs().max() > 0
        assert (gk - gp).abs().max() <= 1e-4 * gp.abs().max()
        wide = torch.zeros((B, T, C + 1), device=dev)
        fn = _build.lib().tpuasr_ctc_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        code = fn(_build.ptr(wide), _build.ptr(labels), _build.ptr(il),
                  _build.ptr(ll), _build.ptr(alphas), _build.ptr(ll_k),
                  _build.ptr(w), _build.ptr(wide), B, T, C + 1, U,
                  ctc_mod.lane_states(2 * U + 1), 0, 7,
                  _build.stream_ptr(wide))
        assert code != 0
        with pytest.raises(ValueError, match="classes"):
            ctc_mod.ctc_backward(wide, labels, il, ll, alphas, ll_k, w)


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


# (B, T, I, Din, O, D, iters). Row counts 21, 22, 9, 10, 15, 13, 14, 5,
# 6, 40 and 100 are multiples of no tile's rows (routing_plan: 8 x row
# groups); I = 96 (the JAX tests' unaligned I), 95, 93, 17, 33 and 5 split
# unevenly over a cluster's CTAs, and O = 5, 7 leave a CTA one class to
# squash (test_k8_cluster_sizes takes clusters of 1, 4 and 8: CTAs with no
# capsule or no class); O*D = 21 and 30 are not multiples of 8, and D = 3
# and 6 take the kernel's unvectorized W loads; Din = 5 and 1 are not
# multiples of 4 (the producer warp copies the stages in place of TMA);
# Din = 16 fills the u rows' float4s. O = 128 at D = 16 (512 threads) and
# O = 96 at D = 16 with Din = 16 take the variant that reads W from L2; O
# = 96 at Din = 8 has three ring stages; I = 256 at O = 48, D = 16 is
# config 4's plan (16 rows, 3 stages of W and u); I = 3600 at Din = 16
# leaves no room for the tile's u block either, smaller shapes take it; D
# = 32 and 64 give 8 and 16 lanes a class (b's sums by reduce-scatter up to
# 8 lanes, by shuffles of every row beyond). K8b's second pass has an
# instance per (Din <= 8: staged V and ds for up to 384 class threads, or
# from L2 beyond; Din <= 16: up to 256 or 512 class threads): O = 72 at D
# = 16 (288 threads) with Din = 12 takes the last of them.
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
    (2, 50, 256, 8, 48, 16, 3),
    (1, 40, 5, 8, 7, 4, 3),
    (1, 10, 20, 8, 96, 16, 2),
    (1, 9, 12, 16, 96, 16, 2),
    (2, 11, 93, 16, 10, 4, 1),
    (1, 7, 3600, 16, 4, 4, 2),
    (1, 9, 10, 8, 12, 32, 2),
    (1, 5, 6, 8, 6, 64, 2),
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


@pytest.mark.parametrize("B,T,I,Din,O,D,iters", K8_CASES)
def test_k8_saving_mode(dev, B, T, I, Din, O, D, iters):
    """K8's saving mode gives the same v bit for bit, and each row's V and
    final s within 2e-5 of their largest magnitude of
    routing_residuals_plain (s sums I terms); a second call gives the same
    bits (no atomics in any sum)."""
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    with full_fp32():
        v = routed_caps(u, W, O, D, iters)
        got = routing_residuals(u, W, O, D, iters)
        again = routing_residuals(u, W, O, D, iters)
        want = routing_residuals_plain(u, W, O, D, iters)
    assert torch.equal(got[0], v)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, r in zip(got[1:], want):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=2e-5 * r.abs().max().item())


@pytest.mark.parametrize("cluster", [1, 4, 8])
@pytest.mark.parametrize("B,T,I,Din,O,D,iters", [
    (1, 21, 5, 8, 7, 4, 3),      # I, O < 8: CTAs with no capsule or class
    (2, 9, 17, 5, 3, 3, 2),      # warp copies, O = 3
    (1, 40, 256, 8, 48, 16, 3),  # config 4's widths
])
def test_k8_cluster_sizes(dev, cluster, B, T, I, Din, O, D, iters):
    """K8 and K8b at other cluster sizes than the plan's (the kernel takes
    1-8 CTAs a cluster): the same bounds as test_k8 and test_k8b."""
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    g = torch.Generator().manual_seed(11)
    dv = torch.randn(B, T, O, D, generator=g).to(dev)
    with full_fp32(), mock.patch.object(routing_mod, "_CLUSTER", cluster):
        assert routing_plan(B * T, I, Din, O, D).cluster == cluster
        got = routed_caps(u, W, O, D, iters)
        grads = routed_caps_bwd(u, W, dv, O, D, iters)
        torch.cuda.synchronize()
        ref = routed_caps_plain(u, W, O, D, iters)
        gref = routed_caps_bwd_plain(u, W, dv, O, D, iters)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)
    for a, r in zip(grads, gref):
        tol = K8B_TOL * r.abs().max().item()
        torch.testing.assert_close(a, r, rtol=0, atol=tol)


def test_routing_plan_matches_kernel_smem(dev):
    """routing_plan's shared memory is the kernel's own layout
    (tpuasr_routing_smem), for every variant the plans take."""
    fn = _build.lib().tpuasr_routing_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    for R, I, Din, O, D in ((1992, 256, 8, 48, 16), (21, 20, 5, 7, 3),
                            (14, 96, 8, 128, 16), (10, 64, 8, 96, 16),
                            (9, 12, 16, 512, 4), (35, 9, 1, 12, 16),
                            (7, 3600, 16, 4, 4)):
        plan = routing_plan(R, I, Din, O, D)
        args = (Din, O, D, plan.cluster, plan.row_groups, plan.stages,
                plan.wide)
        assert fn(*map(int, args)) == plan.smem == routing_smem(*args)


def test_k8_launch_code_checked(dev):
    """A launch the kernel refuses returns its CUDA error, which the
    wrapper's check raises; the wrapper refuses such shapes, another dtype
    and a non-contiguous u before launching."""
    u, W = _routing_case(dev, 1, 3, 8, 4, 200, 16)
    v = torch.empty(1, 3, 200, 16, device=dev)
    fn = _build.lib().tpuasr_routing_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = routing_plan(3, 8, 4, 6, 16)
    args = (plan.cluster, plan.row_groups, plan.stages, int(plan.wide))
    code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(v), None, None, 3, 8,
              4, 200, 16, 3, *args, plan.smem, _build.stream_ptr(u))
    assert code != 0
    # A plan whose shared memory is not the kernel's layout is refused.
    code = fn(_build.ptr(u), _build.ptr(W), _build.ptr(v), None, None, 3, 8,
              4, 6, 16, 3, *args, plan.smem + 16, _build.stream_ptr(u))
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


@pytest.mark.parametrize("B,T,I,Din,O,D,iters", K8_CASES)
def test_k8b_from_residuals_is_standalone(dev, B, T, I, Din, O, D, iters):
    """K8b from K8's saved V and s (the route autograd takes) equals the
    standalone routed_caps_bwd bit for bit, and autograd through
    routed_caps gives those bits too."""
    u, W = _routing_case(dev, B, T, I, Din, O, D)
    g = torch.Generator().manual_seed(11)
    dv = torch.randn(B, T, O, D, generator=g).to(dev)
    with full_fp32():
        want = routed_caps_bwd(u, W, dv, O, D, iters)
        _, V, s = routing_residuals(u, W, O, D, iters)
        got = routed_caps_bwd_from(u, W, V, s, dv, O, D)
        ku, kW = u.clone().requires_grad_(), W.clone().requires_grad_()
        routed_caps(ku, kW, O, D, iters).backward(dv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(ku.grad, want[0]) and torch.equal(kW.grad, want[1])


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
                                  _no_plain), \
                mock.patch.object(routing_mod, "routed_caps_bwd_from_plain",
                                  _no_plain), \
                mock.patch.object(routing_mod, "routing_residuals_plain",
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
    rows = [torch.empty(3, 200, 16, device=dev) for _ in range(3)]
    du, dW = torch.empty_like(u), torch.empty_like(W)
    fn = _build.lib().tpuasr_routing_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(_build.ptr(u), _build.ptr(W), *[_build.ptr(t) for t in rows],
              _build.ptr(dv), _build.ptr(du), _build.ptr(dW), _build.ptr(dW),
              3, 8, 4, 200, 16, 1, _build.stream_ptr(u))
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
    (2, 65, 1024, 512, 11, 0),     # one row past a 64-row tile
    (2, 70, 256, 384, 11, 0),      # N % 256 == 128: a part column tile
    (1, 30, 128, 128, 100, 0),     # Kt near JAX's limit: taps in groups
    (2, 40, 256, 256, 1, 0),       # one tap
    (2, 40, 256, 128, 2, 3),       # two taps, T_in short
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
    """Every body of JAX's kernel is ported: only an unknown mode is
    refused, before a launch."""
    x, mq, sw = _conv_case(dev, 1, 20, 128, 128, 3)
    before = conv_taps_q8.launches
    with pytest.raises(ValueError, match="mode"):
        conv_taps_q8(x, mq, sw, 20, mode="rows")
    assert conv_taps_q8.launches == before


@pytest.mark.parametrize("mode", ["taps", "slab"])
@pytest.mark.parametrize("B,T,K,N,Kt,cut", [
    (1, 300, 128, 128, 7, 0),      # three time blocks
    (3, 50, 256, 256, 11, 4),      # T_in short of T_out + Kt - 1
    (2, 129, 1024, 512, 11, 0),    # conv2's widths, one row past a block
    (2, 65, 1024, 512, 11, 0),     # one row past a 64-row tile
    (2, 70, 256, 384, 11, 0),      # N % 256 == 128: a part column tile
    (1, 30, 128, 128, 100, 0),     # Kt near JAX's limit
    (2, 40, 256, 256, 1, 0),       # one tap: a slab a step
    (2, 40, 256, 128, 2, 3),       # two taps, T_in short
])
def test_k9_bodies(dev, monkeypatch, mode, B, T, K, N, Kt, cut):
    """K9's taps and slab bodies against their plain versions to f32
    rounding (rtol 1e-6, atol 1e-6), chosen by mode= and by
    TPUASR_CONV_Q8_MODE; each launch counts for its body."""
    x, mq, sw = _conv_case(dev, B, T, K, N, Kt)
    x = x[:, :x.shape[1] - cut].contiguous()
    want = reference_q8_conv_taps(x, mq, sw, T, mode)
    before = conv_taps_q8.bodies[mode].launches
    got = conv_taps_q8(x, mq, sw, T, mode=mode)
    monkeypatch.setenv("TPUASR_CONV_Q8_MODE", mode)
    again = conv_taps_q8(x, mq, sw, T)
    assert conv_taps_q8.bodies[mode].launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, again)
    if B > 1:
        assert not got[1].any()


@pytest.mark.parametrize("mode", ["taps", "slab"])
def test_k9_bodies_integer_sums_exact(dev, mode):
    """Rows on the int8 grid (absmax 127, scale 1) with sw = 1: each body
    gives the int32 sum, equal to its plain version bit for bit."""
    g = torch.Generator().manual_seed(13)
    B, T, K, N, Kt = 2, 200, 1024, 256, 11
    x = torch.randint(-127, 128, (B, T + Kt - 1, K), generator=g).float()
    x[:, :, 0] = 127.0
    mq = torch.randint(-127, 128, (Kt, K, N), generator=g).to(torch.int8)
    sw = torch.ones(N)
    x, mq, sw = x.to(dev), mq.to(dev), sw.to(dev)
    assert torch.equal(conv_taps_q8(x, mq, sw, T, mode=mode),
                       reference_q8_conv_taps(x, mq, sw, T, mode))


# ---- K7 / K7b: the fused bidirectional scan ---------------------------------


def _bidir_case(dev, H, B=7, T=37, dtype=torch.float32):
    g = torch.Generator().manual_seed(14)
    xpf, xpb = (torch.randn(T, B, 3 * H, generator=g) for _ in range(2))
    whf, whb = (torch.randn(H, 3 * H, generator=g) / H ** 0.5
                for _ in range(2))
    dys = [torch.randn(T, B, H, generator=g) for _ in range(2)]
    lens = torch.tensor([T, 30, 1, 0, 12, T, 5] * (B // 7 + 1))[:B]
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    ins = [t.to(dev, dtype).contiguous() for t in (xpf, xpb, whf, whb)]
    return ins, mask.to(dev).contiguous(), [d.to(dev) for d in dys]


_K7_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]
_K7_CASES = ([(H, B, 37, dt, tol) for H, B in ((40, 7), (130, 20),
                                                (512, 16), (512, 128),
                                                (512, 129))
              for dt, tol in _K7_DTYPES]
             + [(512, 128, 249, torch.float32, 1e-4)]
             + [(H, B, 37, torch.float32, 1e-5)
                for H, B in ((640, 16), (640, 129), (1056, 7))])


@pytest.mark.parametrize("H,B,T,dtype,tol", _K7_CASES)
def test_k7(dev, H, B, T, dtype, tol):
    """K7 against its plain version: f32 within 1e-5 (K5's bound; 1e-4 at
    the trained length T=249, as chip_smoke: sums of 512 terms in another
    order carried over 249 steps); bf16 streams within 2e-2 (K2's bf16
    bound: a one-ulp difference of an f32 sum can flip a bf16 rounding of
    h and ride the recurrence); two launches give the same bits. B=128 is
    the served batch (bf16: two row groups of 64 rows a direction), B=129
    a ragged one. f32 at H=640 (both directions in one grid of 16-unit
    blocks) and H=1056 (a launch a direction) are the widths the old f32
    kernel refused."""
    ins, mask, _ = _bidir_case(dev, H, B, T, dtype=dtype)
    before = gru_scan_bidir_fwd.launches
    got = gru_scan_bidir_fwd(*ins, mask)
    again = gru_scan_bidir_fwd(*ins, mask)
    assert gru_scan_bidir_fwd.launches == before + 2
    with full_fp32():
        want = gru_scan_bidir_plain(*ins, mask)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol)
    assert not got[0][:, 3].float().any()       # a row of length 0
    assert not got[1][:, 3].float().any()


@pytest.mark.parametrize("H,B,T", [(40, 7, 37), (130, 20, 37), (512, 16, 37),
                                   (512, 75, 37), (512, 128, 37),
                                   (512, 683, 9), (640, 16, 9), (40, 1, 9),
                                   (130, 1, 9)])
def test_k7b(dev, H, B, T):
    """K7b against its plain version, each output within 1e-4 of its
    largest magnitude (float32 sums in another order, dWh over all T*B
    rows); two calls give the same bits (no atomics: dWh summed in a fixed
    order). 683 rows at H=512 and H=640 are the shapes the old kernel
    refused."""
    ins, mask, dys = _bidir_case(dev, H, B, T)
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
    if B > 3:
        assert not got[0][:, 3].any()


def test_lean_and_k5b_plans_match_kernel_smem(dev):
    """The lean plan's shared-memory reckoning (ops/gru.py::_lean_plan, at
    two directions for K7b and at one for K2b and K5b) is the kernel's own
    on this card (tpuasr_gru_lean_smem)."""
    lean = _build.lib().tpuasr_gru_lean_smem
    lean.argtypes = [ctypes.c_int] * 3
    lean.restype = ctypes.c_longlong
    n_sm = gru_mod._sm_count(dev)
    for B, H in ((16, 512), (683, 512), (7, 40), (20, 130), (16, 640),
                 (609, 384), (16, 1024), (16, 694), (16, 695), (64, 512),
                 (16, 1056)):
        for ndir in (1, 2):
            plan = gru_mod._lean_plan(B, H, ndir, n_sm)
            assert lean(H, plan.U, plan.kc) == plan.smem


def test_k7_f32_plan_matches_kernel_smem(dev):
    """K7's f32 plan (ops/gru.py::_bidir_f32_plan) and the one-direction
    plan of K5 (_f32_rec_plan) reckon the shared memory of
    csrc/gru_bidir.cu's layout (tpuasr_gru_bidir_fwd_smem), at the trained
    widths, the repaired ones and ragged ones."""
    fwd = _build.lib().tpuasr_gru_bidir_fwd_smem
    fwd.argtypes = [ctypes.c_int] * 3
    fwd.restype = ctypes.c_longlong
    n_sm = gru_mod._sm_count(dev)
    for B, H in ((16, 512), (64, 512), (128, 512), (683, 512), (7, 40),
                 (20, 130), (16, 384), (16, 571), (16, 640), (129, 640),
                 (16, 1024), (64, 1024), (7, 1056)):
        for plan in (gru_mod._bidir_f32_plan(B, H, n_sm),
                     gru_mod._f32_rec_plan(B, H, n_sm)):
            assert fwd(H, plan.U, plan.kc) == plan.smem


@pytest.mark.parametrize("M,N1,N2,ones", [(3984, 512, 1536, False),
                                          (37, 70, 120, True),
                                          (1, 3, 5, True),
                                          (2049, 130, 390, False)])
def test_weight_gradient_product(dev, M, N1, N2, ones):
    """Phase c's product a^T b (with ones, a last row of column sums of b)
    within 1e-5 of its largest magnitude of torch's in full float32, the
    same bits on two calls (slices summed in a fixed order)."""
    g = torch.Generator().manual_seed(8)
    a = torch.randn(M, N1, generator=g).to(dev)
    b = torch.randn(M, N2, generator=g).to(dev)
    got = gru_mod._tn_product(a, b, ones)
    assert torch.equal(got, gru_mod._tn_product(a, b, ones))
    with full_fp32():
        want = a.T @ b
        if ones:
            want = torch.cat([want, b.sum(0, keepdim=True)])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("H", [64, 640])
def test_bidir_autograd_runs_k7_then_k7b(dev, H):
    """Under autograd on CUDA, gru_scan_bidir launches K7 in the forward
    and K7b in the backward, and no plain version; the gradients match
    autograd through the plain version within 1e-4 of their largest
    magnitude. Under no_grad only K7 runs. H=640 is a width the old f32
    forward refused."""
    ins, mask, dys = _bidir_case(dev, H, 9, 37 if H < 512 else 9)
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


@pytest.mark.parametrize("hidden", [48, 640])
def test_fused_bidir_training_step_on_cuda(dev, hidden):
    """A DeepSpeechCTC(fused_bidir=True) training forward and backward on
    CUDA (K7, K7b once per layer) against the same model with the plain
    scans: log-probs within 1e-4, every gradient within 1e-4 of the
    model's largest gradient magnitude. (Not of each tensor's own: a
    batch-norm scale's gradient is a sum over every frame that cancels
    to far below its terms, so its own largest entry measures the
    cancellation; the kernels' own bounds are held per output above.)
    rnn_hidden=640 is a width the old f32 forward refused."""
    kw = dict(num_classes=12, rnn_hidden=hidden, rnn_layers=2,
              conv_channels=4,
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


def test_featurizer_defaults_to_the_card(dev):
    from tpuasr_torch.features import Featurizer, FusedFeaturizer
    for cls in (Featurizer, FusedFeaturizer):
        fz = cls(FeatureConfig())
        assert fz.device.type == "cuda"
        feats, flens = fz(torch.randn(2, 4000))
        assert feats.device.type == "cuda" and flens.device.type == "cuda"


@pytest.mark.parametrize("lifter", [0.0, 22.0])
def test_k1_mfcc_route(dev, lifter):
    """FusedFeaturizer(mfcc): K1's log-mel within its 1e-3 gate of the plain
    Featurizer's, then the DCT: each coefficient is a row of unit L2 norm
    over 64 log-mel values, so within sqrt(64) x 1e-3 (times the lifter's
    largest factor); one K1 launch a call; two calls the same bits."""
    from tpuasr_torch.features import Featurizer, FusedFeaturizer
    from tpuasr_torch.features import functional as F
    cfg = FeatureConfig(feature_type="mfcc", lifter=lifter, cmn=False,
                        cvn=False)
    wav = torch.randn(3, 12017, generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([12017, 9000, 4000], dtype=torch.int32)
    fused, plain = FusedFeaturizer(cfg, dev), Featurizer(cfg, dev)
    before = fbank_power.launches
    a, la = fused(wav, lens)
    assert fbank_power.launches == before + 1
    b, lb = plain(wav, lens)
    assert torch.equal(la, lb) and a.shape == (3, 148, 13)
    scale = float(F.lifter_vector(13, lifter).max()) if lifter else 1.0
    assert (a - b).abs().max().item() <= 8e-3 * scale
    assert torch.equal(a, fused(wav, lens)[0])


@pytest.mark.parametrize("train", [False, True])
def test_resnet_on_the_card_matches_the_cpu(dev, train):
    """The ResNet-CTC forward (cuDNN convs in float32, TF32 off) against
    the same weights on the CPU: log-probs within 1e-4, out_lens exact; in
    training with dropout 0 and every updated statistic within 1e-5."""
    kw = dict(num_classes=12, stem_channels=8, stage_channels=(8, 16, 16),
              blocks_per_stage=2, dropout=0.0, in_features=13)
    g = torch.Generator().manual_seed(0)
    cpu = create_model("resnet_ctc", **kw, generator=g)
    card = create_model("resnet_ctc", **kw)
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    feats = torch.randn(3, 41, 13, generator=g)
    lens = torch.tensor([41, 30, 7])
    cpu.train(train)
    card.train(train)
    with torch.no_grad():
        lp_c, ol_c = cpu(feats, lens)
        lp_g, ol_g = card(feats.to(dev), lens.to(dev))
    assert torch.equal(ol_g.cpu(), ol_c)
    torch.testing.assert_close(lp_g.cpu(), lp_c, rtol=0, atol=1e-4)
    for (name, a), b in zip(card.state_dict().items(),
                            cpu.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5, msg=name)


def test_fit_device_corpus_on_the_card_matches_the_cpu(dev, tmp_path):
    """The batches fit takes from the device-resident corpus on the card
    (two epochs, three buckets, repeat-padded batches) equal the CPU's
    bit for bit, and stream equally from the loader with prefetch 2."""
    from tpuasr_torch.data import (AudioLoader, LoaderConfig,
                                   make_synthetic_corpus)
    from tpuasr_torch.train import TrainConfig, Trainer

    corpus = make_synthetic_corpus(tmp_path, num_utts=21, vocab_size=6,
                                   seed=4)
    cfg = LoaderConfig(batch_size=8, max_label_len=8, max_buckets=3)
    tc = TrainConfig(model_kwargs=dict(rnn_hidden=16, rnn_layers=1,
                                       conv_channels=4), num_classes=6)
    card = Trainer(tc, FeatureConfig(), device=dev)
    cpu = Trainer(tc, FeatureConfig(), device="cpu")
    streamed = Trainer(dataclasses.replace(tc, device_corpus=False),
                       FeatureConfig(), device=dev)
    loaders = [AudioLoader(corpus.manifest, cfg) for _ in range(3)]
    for epoch in (0, 1):
        runs = [list(t._epoch_batches(ld, epoch))
                for t, ld in zip((card, cpu, streamed), loaders)]
        assert card._dc[1] is not None and cpu._dc[1] is not None
        assert len(runs[0]) == len(runs[1]) == len(runs[2]) > 2
        for (na, a), (nb, b), (nc, c) in zip(*runs):
            assert na == nb == nc and a["wav"].is_cuda
            for k in b:
                assert torch.equal(a[k].cpu(), b[k]), k
                assert torch.equal(c[k].cpu().to(b[k].dtype), b[k]), k


def test_native_wav_reader_on_this_machine(tmp_path):
    """The native reader builds with this machine's compiler and reads
    PCM16, float32 and stereo bit for bit as scipy does."""
    from scipy.io import wavfile

    from tpuasr_torch.data import load_wav
    from tpuasr_torch.data import native_wav

    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, size=4001).astype(np.float32)
    files = {"pcm16": (x * 32767).astype(np.int16), "float32": x,
             "stereo": (np.stack([x, -x], 1) * 32767).astype(np.int16)}
    paths = []
    for name, data in files.items():
        paths.append(str(tmp_path / f"{name}.wav"))
        wavfile.write(paths[-1], 8000, data)
    out, lens, srs = native_wav.load_wav_batch(paths, 5000)
    for j, p in enumerate(paths):
        ref, sr = load_wav(p)
        assert srs[j] == sr and lens[j] == len(ref)
        np.testing.assert_array_equal(out[j, :lens[j]], ref)
