"""The fbank kernel's host side on the CPU: its plan, its packed tables, and
its split-TF32 arithmetic emulated in torch float32.

``csrc/fbank.cu`` runs only on the card; these hold what surrounds it. The
plan must cover every (utterance, frame) and every bin column exactly once
and fit in 227 KB of shared memory wherever the first kernel (16 frames a
block, FMA in float32) did. Both table layouts are read back as the tensor
cores read them: ``mma.sync`` fragments lane by lane, and the ``wgmma``
route's K-major tiles through the shared-memory descriptor's offsets. The emulation repeats the kernel's arithmetic:
A = frames * window split into TF32 hi and lo as ``cvt.rna`` rounds, the
packed hi/lo planes of B, and per k-step of 8 the three products lo*hi,
hi*lo, hi*hi added into float32 sums, for the rDFT and for the mel stage.
It must stay within the 1e-3 log-mel gate (tests/test_features_pallas.py:36)
of ``fbank_power_plain``, also on a tone with noise 90 dB below it, where a
single TF32 product misses the gate.
"""

import numpy as np
import pytest
import torch

from tpuasr_torch.features import FeatureConfig, FusedFeaturizer
from tpuasr_torch.features.fused import (NT_MAX, SMEM_LIMIT, WARPS_N,
                                         WG_COLS, WG_MEL_COLS, WG_RINGS,
                                         _dft_cols, fbank_plan, fbank_power,
                                         fbank_power_plain, fbank_smem,
                                         fragments, pack_tables, split_tf32,
                                         tf32_round, wg_tiles)
from tpuasr_torch.features.reference import (feature_tables, frames_plain,
                                             num_frames)

LOG_TOL = 1e-3
# (sample rate, n_fft, feature type) of the configurations the plan serves.
CONFIGS = {
    "fbank8k": dict(sample_rate=8000),
    "fbank16k": dict(sample_rate=16000),
    "spec8k": dict(sample_rate=8000, feature_type="spectrogram"),
    "spec16k": dict(sample_rate=16000, feature_type="spectrogram"),
    "nfft512_8k": dict(sample_rate=8000, n_fft=512),
    "nfft2048_16k": dict(sample_rate=16000, n_fft=2048),
    "hop110": dict(sample_rate=11025),
}


def _shape(cfg: FeatureConfig):
    return (cfg.hop_length, cfg.win_length, cfg.n_freqs, cfg.base_dim)


def warp_tiles(plan, mel: bool) -> tuple[dict, int]:
    """({(chunk, holder): (rows, n-tiles)}, the most n-tiles a holder keeps)
    as the kernel assigns them. M = 64 (wgmma): warpgroup w takes all 64
    rows and n-tiles [nt_c / 2 * w, + nt_c / 2) of each chunk (one
    m64n128k8 or m64n32k8 product). M = 32 or 16 (mma.sync): warp w takes
    rows [row0, row0 + 16 * MT) and the chunk's n-tiles w % WN, w % WN +
    WN, ... (at most NT_MAX)."""
    total = (plan.No if mel else plan.Nd) // 8
    nt_c = plan.mel_nt if mel else plan.dft_nt
    chunks = plan.mel_chunks if mel else plan.dft_chunks
    out = {}
    if plan.M == 64:
        for c in range(chunks):
            for w in range(2):
                n0 = c * nt_c + nt_c // 2 * w
                out[c, w] = (range(64), list(range(n0, n0 + nt_c // 2)))
        return out, nt_c // 2
    wn_count = WARPS_N[plan.M]
    mt = plan.M // 16 // (8 // wn_count)
    for c in range(chunks):
        n0 = c * nt_c
        nt = min(nt_c, total - n0)
        for w in range(8):
            row0 = (w // wn_count) * mt * 16
            tiles = [n0 + j for j in range(w % wn_count, nt, wn_count)]
            out[c, w] = (range(row0, row0 + 16 * mt), tiles)
    return out, NT_MAX


def cta_tiles(plan, cta: int) -> list:
    """(utterance, first frame) of the tiles persistent CTA ``cta`` walks,
    in order: tiles cta, cta + ctas, ... of the B * tiles (utterance-major)."""
    tiles_t, B = plan.grid
    return [(i // tiles_t, (i % tiles_t) * plan.M)
            for i in range(cta, tiles_t * B, plan.ctas)]


@pytest.mark.parametrize("T", [1, 63, 64, 65, 998])
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_covers_the_work(name, B, T):
    cfg = FeatureConfig(**CONFIGS[name])
    hop, win, nf, n_out = _shape(cfg)
    plan = fbank_plan(B, T, hop, win, nf, n_out)
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == fbank_smem(plan.M, hop, plan.Kp, plan.nfp,
                                   plan.stage_k,
                                   8 * max(plan.dft_nt, plan.mel_nt),
                                   plan.stages)
    # Every (utterance, frame) once: tiles of M frames from 0, the last
    # holding the remainder, each walked by exactly one persistent CTA.
    tiles, nb = plan.grid
    assert nb == B and (tiles - 1) * plan.M < T <= tiles * plan.M
    assert 1 <= plan.ctas <= min(132, tiles * B)
    walked = [t for c in range(plan.ctas) for t in cta_tiles(plan, c)]
    assert sorted(walked) == [(b, t0) for b in range(B)
                              for t0 in range(0, tiles * plan.M, plan.M)]
    # Every bin column once: the interleaved (cos, sin) columns fill Nd
    # (DC and Nyquist paired: 2 columns fewer), padded with zero columns to
    # the route's chunk, and each (row, n-tile) of each product goes to
    # exactly one warp (mma.sync) or warpgroup (wgmma).
    cols = _dft_cols(nf, True)
    assert cols == _dft_cols(nf, False) - 8 * (nf % 4 == 1)
    assert cols >= 2 * nf - 2 and plan.No >= n_out
    assert plan.nfp >= (cols // 2 if plan.M < 64 else nf)
    if plan.M == 64:
        assert plan.Nd == -(-cols // WG_COLS) * WG_COLS
        assert plan.No == -(-n_out // WG_MEL_COLS) * WG_MEL_COLS
        assert (plan.dft_nt, plan.mel_nt) == (WG_COLS // 8, WG_MEL_COLS // 8)
        assert (plan.stage_k, plan.stages) in WG_RINGS
    else:
        assert plan.Nd == cols and plan.stage_k == 2
    for mel, total in ((False, plan.Nd // 8), (True, plan.No // 8)):
        seen = {}
        tiles, cap = warp_tiles(plan, mel)
        for (_, _), (rows, ntiles) in tiles.items():
            assert len(ntiles) <= cap
            for n in ntiles:
                for r in rows:
                    seen[r, n] = seen.get((r, n), 0) + 1
        assert seen == {(r, n): 1 for r in range(plan.M)
                        for n in range(total)}


def test_plan_tiles():
    """M = 64 (wgmma) at every batch, B = 1 included (the batch does not
    choose the height: M = 64 measured faster than 32 and 16 at B = 1, 4
    and 8); the 8 kHz rDFT in one chunk of 256 columns (129 bins, DC and
    Nyquist sharing a pair) with rDFT stages of 4 k-steps, 16 kHz in two
    with stages of 3; mma.sync tiles of 32 only where 64 frames' span and
    power tile leave no room (n_fft 2048 at 16 kHz)."""
    fb8 = _shape(FeatureConfig())
    plan = fbank_plan(128, 998, *fb8)
    assert (plan.M, plan.stage_k, plan.stages, plan.dft_nt,
            plan.dft_chunks) == (64, 4, 2, 32, 1)
    assert (plan.mel_nt, plan.mel_chunks, plan.grid, plan.ctas) == \
        (8, 1, (16, 128), 132)
    for B, T in ((8, 998), (8, 499), (1, 998), (128, 1), (4, 998)):
        assert fbank_plan(B, T, *fb8).M == 64
    assert fbank_plan(1, 998, *fb8).ctas == 16
    assert fbank_plan(8, 998, *fb8).ctas == 128     # one CTA a tile
    p16 = fbank_plan(32, 998, *_shape(FeatureConfig(sample_rate=16000)))
    assert (p16.M, p16.stage_k, p16.stages, p16.dft_chunks, p16.Nd) == \
        (64, 3, 2, 2, 512)
    big = fbank_plan(32, 998, *_shape(FeatureConfig(sample_rate=16000,
                                                    n_fft=2048)))
    assert (big.M, big.stage_k) == (32, 2)
    with pytest.raises(ValueError):
        fbank_plan(32, 998, *_shape(FeatureConfig(sample_rate=16000,
                                                  n_fft=2048)), M=64)


def _old_kernel_bytes(hop, win, nf):
    """Shared memory of the first kernel: its span, 16 windowed frames and
    16 power rows."""
    return 4 * (15 * hop + win + 16 * win + 16 * nf)


@pytest.mark.parametrize("sr", [8000, 11025, 16000, 22050, 44100, 48000])
def test_plan_raises_only_past_the_old_kernel(sr):
    """Over windows of 10-64 ms, hops of 10 ms to a whole window, n_fft up to
    16384, fbank and spectrogram: the plan takes every configuration the
    first kernel took, and raises ValueError only past it. (Windows under 64
    samples with n_fft over 100 times the window, within 3 KB of the old
    limit, are the one corner it refuses and the old kernel took; no
    FeatureConfig of this grid reaches it.)"""
    checked = refused = 0
    for win_ms in (10, 20, 25, 32, 50, 64):
        for hop_ms in (10, 12.5, 20, win_ms):
            for n_fft in (None, 512, 1024, 2048, 4096, 8192, 16384):
                cfg = FeatureConfig(sample_rate=sr, win_ms=win_ms,
                                    hop_ms=hop_ms, n_fft=n_fft)
                if cfg.fft_size < cfg.win_length:
                    continue
                hop, win, nf = cfg.hop_length, cfg.win_length, cfg.n_freqs
                for n_out in (64, nf):
                    for B, T in ((1, 1), (128, 998)):
                        checked += 1
                        try:
                            fbank_plan(B, T, hop, win, nf, n_out)
                        except ValueError:
                            refused += 1
                            assert _old_kernel_bytes(hop, win, nf) > \
                                SMEM_LIMIT
    assert checked > 300 and 0 < refused < checked


def test_plan_refuses_empty_shapes():
    for bad in ((0, 10), (4, 0)):
        with pytest.raises(ValueError):
            fbank_plan(*bad, 80, 200, 129, 64)


def test_tf32_round_is_cvt_rna():
    """Nearest, ties away from zero, on 10 mantissa bits; a pair (hi, lo)
    holds 22 bits of the value."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10,             # tie: away
             -(one + 2 ** -11): -(one + 2 ** -10),
             one + 2 ** -11 - 2 ** -23: one,             # below the tie
             one + 3 * 2 ** -11: one + 2 * 2 ** -10,     # tie: away
             0.0: 0.0, 2.0 ** -130: 2.0 ** -130}         # zero, subnormal
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    assert torch.all(tf32_round(x).view(torch.int32) & 0x1FFF == 0)
    v = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    hi, lo = split_tf32(v)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max().item()
    assert rel <= 2.0 ** -21


def planes(frag):
    """(hi, lo), each (N, K), back from the (K/8, N, 4, 4) fragments."""
    kt, N = frag.shape[:2]
    return tuple(frag[..., 2 * i:2 * i + 2].permute(1, 0, 3, 2)
                 .reshape(N, 8 * kt) for i in (0, 1))


def emulate_fbank(wav, tables, hop, T, single=False):
    """The kernel's arithmetic in torch float32: frames * window split into
    TF32 hi and lo, per k-step of 8 the three TF32 products lo*hi, hi*lo,
    hi*hi into float32 sums (``single``: one product of the TF32-rounded
    operands), for the rDFT, then the power in float32, then the mel stage
    the same way."""
    pk = pack_tables(tables)
    win, Kp = tables["window"].shape[0], pk["window"].shape[0]
    n_out = tables["proj"].shape[1]
    frames = torch.nn.functional.pad(frames_plain(wav, hop, win, T),
                                     (0, Kp - win))
    x = (frames * pk["window"]).reshape(-1, Kp)

    def product(a, planes):
        bh, bl = planes[0], planes[1]
        ah, al = split_tf32(a)
        if single:
            ah, bh = tf32_round(a), tf32_round(bh + bl)
        acc = torch.zeros(a.shape[0], bh.shape[0])
        for k in range(0, a.shape[1], 8):
            s = slice(k, k + 8)
            if not single:
                acc = acc + al[:, s] @ bh[:, s].T
                acc = acc + ah[:, s] @ bl[:, s].T
            acc = acc + ah[:, s] @ bh[:, s].T
        return acc

    acc = product(x, planes(pk["dft"]))
    power = acc[:, 0::2] ** 2 + acc[:, 1::2] ** 2
    if pk["nyq"] >= 0:                 # columns 0, 1: cos_0, cos_nyq
        power = torch.cat([acc[:, :1] ** 2, power[:, 1:pk["nyq"]],
                           acc[:, 1:2] ** 2], dim=1)
    power = torch.nn.functional.pad(
        power, (0, 8 * pk["mel"].shape[0] - power.shape[1]))
    return product(power, planes(pk["mel"]))[:, :n_out].reshape(
        wav.shape[0], T, n_out)


def _log_err(a, b, floor=1e-10):
    return (torch.log(a.clamp(min=floor))
            - torch.log(b.clamp(min=floor))).abs().max().item()


def _case(kw, wav):
    cfg = FeatureConfig(**kw)
    tabs = feature_tables(cfg, "cpu")
    T = num_frames(cfg, wav.shape[1])
    ref = fbank_power_plain(wav, tabs, cfg.hop_length, T)
    split = emulate_fbank(wav, tabs, cfg.hop_length, T)
    single = emulate_fbank(wav, tabs, cfg.hop_length, T, single=True)
    return _log_err(split, ref), _log_err(single, ref)


@pytest.mark.parametrize("name", ["fbank8k", "fbank16k", "spec8k",
                                  "hop110"])
def test_split_tf32_within_the_gate_on_noise(name):
    """chip_smoke's signal (seeded noise x 0.1), 1 s, two utterances."""
    kw = CONFIGS[name]
    sr = kw["sample_rate"]
    wav = torch.as_tensor((np.random.default_rng(0).standard_normal((2, sr))
                           * 0.1).astype(np.float32))
    err, _ = _case(kw, wav)
    assert err <= LOG_TOL / 10


def wide_range_signal(sr, seconds=1.0, db=90.0, seed=0):
    """A 1 kHz tone of amplitude 0.5 plus white noise ``db`` below it (noise
    standard deviation 0.5 * 10^(-db / 20)): log-mel values spanning about
    the tone's 90 dB over the noise floor (the Hamming window's leakage
    raises the bands far from the tone)."""
    n = int(sr * seconds)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    wav = 0.5 * np.sin(2 * np.pi * 1000.0 * t) \
        + 0.5 * 10 ** (-db / 20) * rng.standard_normal(n)
    return torch.as_tensor(wav[None].astype(np.float32))


@pytest.mark.parametrize("sr", [8000, 16000])
def test_wide_range_needs_the_split(sr):
    """Tone + noise 90 dB below: three TF32 products stay inside the 1e-3
    gate (they carry ~22 bits); one TF32 product (11 bits) misses it."""
    err, single = _case(dict(sample_rate=sr), wide_range_signal(sr))
    assert err <= LOG_TOL / 5
    assert single > 10 * LOG_TOL


def test_packed_table_fragments_give_re_im_pairs():
    """The interleaved rDFT table (DC and Nyquist sharing the first pair,
    their sin columns being zero) in fragment order: lane (g, tig)
    of n-tile j at k-step t loads the float4 at ((t * Nd + 8j + g) * 4 +
    tig) (a ring stage holds a chunk's columns of 2 k-steps, each run
    contiguous), which holds its TF32 operands b0 = B[8j + g][8t + tig] and
    b1 = B[8j + g][8t + tig + 4], hi then lo; the 32 lanes read 512
    contiguous bytes. Through the mma.m16n8k8 accumulator mapping, lane
    (g, tig) then holds (re_k, im_k) of bin k = 4j + tig in accumulators 0,
    1 (row g) and 2, 3 (row g + 8); lane (0, 0) of n-tile 0 holds (re_0,
    re_nyq)."""
    cfg = FeatureConfig()
    tabs = feature_tables(cfg, "cpu")
    pk = pack_tables(tabs)
    frag = pk["dft"].double()
    kt, Nd = frag.shape[:2]
    nf = tabs["cos"].shape[1]
    assert (kt, Nd) == (25, 256) and frag.shape[2:] == (4, 4)
    assert pk["nyq"] == nf - 1 == 128
    B = torch.zeros(Nd, 8 * kt, dtype=torch.float64)
    B[0], B[1] = tabs["cos"][:, 0].double(), tabs["cos"][:, -1].double()
    B[2::2] = tabs["cos"][:, 1:-1].T.double()
    B[3::2] = tabs["sin"][:, 1:-1].T.double()
    hi, lo = (x.double() for x in split_tf32(B.float()))
    flat = frag.reshape(-1, 4)
    for t in (0, 7, kt - 1):
        for j in (0, 5, Nd // 8 - 1):
            offsets = []
            for lane in range(32):
                g, tig = lane >> 2, lane & 3
                n, k = 8 * j + g, 8 * t + tig
                at = (t * Nd + n) * 4 + tig
                offsets.append(at)
                want = torch.stack([hi[n, k], hi[n, k + 4], lo[n, k],
                                    lo[n, k + 4]])
                assert torch.equal(flat[at], want)
            assert offsets == list(range(offsets[0], offsets[0] + 32))
    g = torch.Generator().manual_seed(0)
    A = torch.randn(16, 8 * kt, generator=g, dtype=torch.float64)
    hi_p, _ = planes(pk["dft"])
    D = A @ hi_p.double().T                           # (16, Nd)
    cos_hi = tf32_round(tabs["cos"]).double()
    sin_hi = tf32_round(tabs["sin"]).double()
    re, im = A[:, :200] @ cos_hi, A[:, :200] @ sin_hi
    for j in range(Nd // 8):
        for lane in range(32):
            g_, tig = lane >> 2, lane & 3
            k = j * 4 + tig
            acc = torch.stack([D[g_, 8 * j + 2 * tig],
                               D[g_, 8 * j + 2 * tig + 1],
                               D[g_ + 8, 8 * j + 2 * tig],
                               D[g_ + 8, 8 * j + 2 * tig + 1]])
            if k == 0:                  # (re_0, re_nyq): sin is 0 at both
                want = torch.stack([re[g_, 0], re[g_, nf - 1],
                                    re[g_ + 8, 0], re[g_ + 8, nf - 1]])
            else:
                want = torch.stack([re[g_, k], im[g_, k], re[g_ + 8, k],
                                    im[g_ + 8, k]])
            assert torch.allclose(acc, want, rtol=1e-12, atol=1e-9)


def test_power_tile_is_the_mel_a_fragment():
    """The rDFT epilogue's lane (g, tig) of n-tile j holds the power of bin
    4j + tig (rows g, g + 8): exactly components 2 * (j & 1) and + 1 of the
    same lane's A fragment of mel k-step j // 2 (a0, a1 for bins 8t + tig,
    a2, a3 for 8t + tig + 4), so the kernel stores it there."""
    for j in range(34):
        for tig in range(4):
            b = 4 * j + tig
            t, pos = divmod(b, 8)
            assert t == j >> 1
            assert (pos == tig) == (j % 2 == 0)
            assert (pos == tig + 4) == (j % 2 == 1)


def test_nyquist_pairing_only_where_sin_vanishes():
    """Even n_fft: sin is zero at DC and ~1e-13 at Nyquist, so the pair is
    taken; odd n_fft has no Nyquist bin, and arbitrary tables keep the
    plain layout (2 columns a bin)."""
    for n_fft, paired in ((256, True), (512, True), (255, False)):
        tabs = feature_tables(FeatureConfig(n_fft=n_fft), "cpu")
        pk = pack_tables(tabs)
        nf = tabs["cos"].shape[1]
        assert (pk["nyq"] >= 0) == paired
        kt, Nd = pk["dft"].shape[:2]
        assert Nd == -(-(2 * nf - (2 if paired else 0)) // 8) * 8
    tabs = feature_tables(FeatureConfig(), "cpu")
    tabs["sin"] = tabs["sin"] + 1e-3
    assert pack_tables(tabs)["nyq"] == -1


def test_packed_mel_and_window():
    cfg = FeatureConfig(sample_rate=11025, feature_type="spectrogram")
    tabs = feature_tables(cfg, "cpu")
    pk = pack_tables(tabs)
    win, nf = tabs["cos"].shape
    assert win == 276 and pk["window"].shape == (280,)
    assert torch.equal(pk["window"][:win], tabs["window"])
    assert torch.all(pk["window"][win:] == 0)
    assert pk["mel"].shape == (264 // 8, 264, 4, 4)
    hi, lo = planes(pk["mel"])
    assert torch.equal(hi[:nf, :nf] + lo[:nf, :nf], tabs["proj"].T)
    assert torch.all(hi[nf:] == 0) and torch.all(hi[:, nf:] == 0)
    assert torch.equal(fragments(hi + lo), pk["mel"])


def test_featurizer_packs_once_and_cpu_takes_the_plain_version():
    fz = FusedFeaturizer(FeatureConfig(), device="cpu")
    assert set(fz.tables) == {"window", "cos", "sin", "proj", "packed"}
    assert fz.tables["packed"]["dft"].shape == (25, 256, 4, 4)
    wav = torch.randn(2, 4000, generator=torch.Generator().manual_seed(1))
    T = num_frames(fz.cfg, 4000)
    before = fbank_power.launches
    got = fbank_power(wav, fz.tables, fz.cfg.hop_length, T)
    assert fbank_power.launches == before
    assert torch.equal(got, fbank_power_plain(wav, fz.tables,
                                              fz.cfg.hop_length, T))


def test_warps_cover_a_chunk_within_their_registers():
    """A chunk never holds more n-tiles than its holders can keep: NT_MAX a
    warp under mma.sync, one m64n128k8 product's 16 (64 accumulators a
    thread) a warpgroup under wgmma; the mma.sync chunks are as even as
    the count allows."""
    for M, wn in WARPS_N.items():
        assert 8 % wn == 0 and M // 16 // (8 // wn) in (1, 2)
    assert WG_COLS // 2 == 128 and WG_MEL_COLS // 2 == 32
    plan = fbank_plan(32, 998, *_shape(FeatureConfig(sample_rate=16000,
                                                     n_fft=2048)))
    assert plan.M == 32
    assert plan.dft_nt <= WARPS_N[plan.M] * NT_MAX
    assert plan.dft_nt * (plan.dft_chunks - 1) < plan.Nd // 8 <= \
        plan.dft_nt * plan.dft_chunks
    wg = fbank_plan(32, 998, *_shape(FeatureConfig(sample_rate=16000)))
    assert wg.M == 64 and wg.dft_nt * wg.dft_chunks * 8 == wg.Nd


def test_wg_tables_through_the_descriptor():
    """The wgmma route's tables, read as the kernel's B descriptors read a
    ring slot: k-step kk, plane (hi, lo) of a stage start at (2 kk + plane)
    * 8 W floats, warpgroup w's columns 128 w on; element (n, k) of a
    K-major tile without swizzle lies at start + (k // 4) * lbo + (n // 8)
    * sbo + (n % 8) * 16 + (k % 4) * 4 bytes, lbo = 16 W, sbo = 128. Each
    is the TF32 hi or lo of B[n][8t + k]; through the accumulator mapping
    (that of mma.m16n8k8 for each 8 columns) lane (g, tig) of n-tile j then
    holds (re_k, im_k) of bin 4j + tig, DC and Nyquist in the first pair."""
    cfg = FeatureConfig(sample_rate=16000)
    tabs = feature_tables(cfg, "cpu")
    pk = pack_tables(tabs)
    win, nf = tabs["cos"].shape
    kt = pk["window"].shape[0] // 8
    W = WG_COLS
    dft = pk["dft_wg"]
    assert dft.shape == (2, kt, 2, 2, W, 4)
    B = torch.zeros(2 * W, 8 * kt)
    B[0, :win], B[1, :win] = tabs["cos"][:, 0], tabs["cos"][:, -1]
    B[2:2 * nf - 2:2, :win] = tabs["cos"][:, 1:-1].T
    B[3:2 * nf - 2:2, :win] = tabs["sin"][:, 1:-1].T
    hi, lo = split_tf32(B)
    for stage_k in (4, 3, 2):
        for chunk, j in ((0, 0), (1, 5), (0, 12)):       # stage j of chunk
            k0 = j * stage_k
            ks = min(stage_k, kt - k0)
            slot = dft[chunk, k0:k0 + ks].reshape(-1)    # one bulk copy
            for kk in range(ks):
                for plane, want in ((0, hi), (1, lo)):
                    for w in (0, 1):
                        start = (2 * kk + plane) * 8 * W + 4 * 128 * w
                        for n in (0, 1, 9, 63, 127):
                            for k in range(8):
                                at = start + ((k // 4) * 16 * W + (n // 8)
                                              * 128 + (n % 8) * 16
                                              + (k % 4) * 4) // 4
                                col = chunk * W + 128 * w + n
                                assert slot[at] == want[col, 8 * (k0 + kk)
                                                        + k]
    mel = pk["mel_wg"]
    assert mel.shape == (1, pk["mel"].shape[0], 2, 2, WG_MEL_COLS, 4)
    proj_hi = torch.zeros(WG_MEL_COLS, 8 * mel.shape[1])
    proj_hi[:tabs["proj"].shape[1], :nf] = tf32_round(tabs["proj"].T)
    back = mel[0, :, 0].permute(2, 0, 1, 3).reshape(WG_MEL_COLS, -1)
    assert torch.equal(back, proj_hi)
    assert torch.equal(wg_tiles(B, W), dft)


def test_wg_accumulators_hold_re_im_pairs():
    """m64nNk8's accumulator d[4j + e] of lane (g, tig) in warp wi is row
    16 wi + g (+ 8 for e >= 2), column 8j + 2 tig (+ 1 for odd e); over the
    interleaved table that is (re, im) of bin 4j + tig, so the power tile's
    bin 4j + tig is the mel A fragment of k-step j // 2 (as under
    mma.sync), and the Nyquist bin, in DC's odd column, goes to k-step
    nyq // 8, position nyq % 8."""
    cfg = FeatureConfig()
    tabs = feature_tables(cfg, "cpu")
    pk = pack_tables(tabs)
    nf = tabs["cos"].shape[1]
    kt = pk["window"].shape[0] // 8
    hi = pk["dft_wg"][0, :, 0].permute(2, 0, 1, 3).reshape(WG_COLS, 8 * kt)
    g_ = torch.Generator().manual_seed(0)
    A = torch.randn(64, 8 * kt, generator=g_, dtype=torch.float64)
    D = A @ hi.double().T
    re = A[:, :200] @ tf32_round(tabs["cos"]).double()
    im = A[:, :200] @ tf32_round(tabs["sin"]).double()
    for wi in range(4):
        for lane in (0, 5, 31):
            g, tig = lane >> 2, lane & 3
            for j in (0, 1, 17, 31):
                k = 4 * j + tig
                d = [D[16 * wi + g + 8 * (e >= 2), 8 * j + 2 * tig + e % 2]
                     for e in range(4)]
                r0, r1 = 16 * wi + g, 16 * wi + g + 8
                if k == 0:
                    want = [re[r0, 0], re[r0, nf - 1], re[r1, 0],
                            re[r1, nf - 1]]
                else:
                    want = [re[r0, k], im[r0, k], re[r1, k], im[r1, k]]
                assert torch.allclose(torch.stack(d), torch.stack(want),
                                      rtol=1e-12, atol=1e-9)
