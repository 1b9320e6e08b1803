"""Fused featurizer: one CUDA kernel from wav to projected power spectrum.

Counterpart of ``tpuasr/features/pallas_fused.py``. The kernel
(``csrc/fbank.cu``) replaces both Pallas variants: K1,
``_make_framed_kernel`` through ``_build_call_framed`` (pallas_fused.py:109),
which frames hop-sized rows inside the kernel, and K1b, ``_fused_kernel``
through ``_build_call`` (pallas_fused.py:137), which took frames gathered
outside for hops wider than 128 lanes. The CUDA kernel frames straight from
the wav for any hop, so one kernel serves both. Its two products (the rDFT
and the mel projection) run on the tensor cores in split TF32, three
products a term (22 of float32's 24 bits; near a spectral null the kernel
lies about as far from a float64 rDFT as the plain float32 matmuls);
Tiles of 64 frames run on ``wgmma`` (two warpgroups, A
from registers); 32 or 16, where 64 frames' layout passes 227 KB of shared
memory, on ``mma.sync``. ``pack_tables`` lays the tables out for both once
and ``fbank_plan`` sizes the tiles. Log, MFCC's DCT, CMVN and the mask
stay plain torch outside the kernel, as in JAX (pallas_fused.py:257-295).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpuasr_torch import _build
from tpuasr_torch.features.reference import (Featurizer, frames_plain,
                                             mel_power_plain)

# Shared memory a block may opt into on the H100 (227 KB).
SMEM_LIMIT = 232448
# The kernel's constants (csrc/fbank.cu): n-tiles a warp holds in a chunk,
# k-steps of 8 in a ring stage, bytes of the stages' mbarriers, and warps
# along N for each mma.sync tile height M (8 warps); at M = 64 (wgmma) the
# rDFT and mel columns a chunk (half to a warpgroup), and the (rDFT k-steps
# a ring stage, stages) the plan tries in turn.
NT_MAX = 8
STAGE_K = 2
BAR_BYTES = 64
WARPS_N = {32: 8, 16: 8}
WG_COLS = 256
WG_MEL_COLS = 64
WG_RINGS = ((4, 2), (3, 2), (2, 2))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties
    away from zero, 10 mantissa bits (the low 13 bits of the float32 zero)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def fragments(b: torch.Tensor) -> torch.Tensor:
    """(N, K) K-major B, K a multiple of 8 -> (K/8, N, 4, 4) in the
    mma.m16n8k8 fragment order: [t][n][tig] = (hi b0, hi b1, lo b0, lo b1)
    with b0 = B[n][8t + tig], b1 = B[n][8t + tig + 4], hi and lo its TF32
    split. A ring stage of a chunk is then contiguous per k-step, and a
    lane's operands one 16-byte load."""
    N, K = b.shape
    hi, lo = (x.view(N, K // 8, 2, 4).permute(1, 0, 3, 2)
              for x in split_tf32(b))
    return torch.cat([hi, lo], dim=-1).contiguous()


def wg_tiles(b: torch.Tensor, W: int) -> torch.Tensor:
    """(N, K) K-major B, N a multiple of W, K of 8 -> (N/W, K/8, 2, 2, W, 4):
    [chunk][k-step][hi, lo][half][column][4], the wgmma route's layout: a
    k-step of a chunk is two K-major planes without swizzle, each half (K
    0-3, then 4-7) a run of W columns of 16 bytes, and a ring stage of a
    chunk one contiguous run."""
    N, K = b.shape
    hi, lo = (x.view(N // W, W, K // 8, 2, 4).permute(0, 2, 3, 1, 4)
              for x in split_tf32(b))
    return torch.stack([hi, lo], dim=2).contiguous()


def nyquist_pairs(tables: dict) -> bool:
    """True where sin is zero at DC and, to float32 resolution of the terms,
    at the last bin (the Nyquist bin of an even n_fft): the table then pairs
    (cos_0, cos_nyq) in its first two columns."""
    cos, sin = tables["cos"], tables["sin"]
    if cos.shape[1] < 2:
        return False
    eps = float(cos.abs().max()) * 2.0 ** -24
    return bool(sin[:, 0].abs().max() == 0
                and sin[:, -1].abs().max() <= eps)


def pack_tables(tables: dict) -> dict:
    """The kernel's operands from ``feature_tables``' four tables.

    window (Kp,): zero past win. dft (Kp/8, Nd, 4, 4): the fragments of the
    rDFT table B (Nd, Kp): columns 2k and 2k + 1 are cos_k and sin_k, zero
    past the last bin; where ``nyquist_pairs``, columns 0 and 1 are cos_0
    and cos_nyq, and "nyq" is the Nyquist bin (else -1). mel (nfp/8, No, 4,
    4): the fragments of proj transposed (No, nfp), zero past n_out and
    n_freqs. Kp, Nd, nfp and No are multiples of 8 (the mma tile). dft_wg
    and mel_wg: the same B and proj for the wgmma route (``wg_tiles``), Nd
    padded with zero columns to a multiple of WG_COLS and No of
    WG_MEL_COLS.
    """
    window, cos, sin, proj = (tables[k] for k in ("window", "cos", "sin",
                                                  "proj"))
    win, nf = cos.shape
    n_out = proj.shape[1]
    paired = nyquist_pairs(tables)
    Kp, Nd = _round_up(win, 8), _dft_cols(nf, paired)
    nfp, No = _round_up(nf, 8), _round_up(n_out, 8)
    dev = cos.device
    b = torch.zeros((Nd, Kp), dtype=torch.float32, device=dev)
    if paired:
        b[0, :win] = cos[:, 0]
        b[1, :win] = cos[:, nf - 1]
        b[2:2 * nf - 2:2, :win] = cos[:, 1:nf - 1].T
        b[3:2 * nf - 2:2, :win] = sin[:, 1:nf - 1].T
    else:
        b[0:2 * nf:2, :win] = cos.T
        b[1:2 * nf:2, :win] = sin.T
    m = torch.zeros((No, nfp), dtype=torch.float32, device=dev)
    m[:n_out, :nf] = proj.T
    w = torch.zeros((Kp,), dtype=torch.float32, device=dev)
    w[:win] = window
    b_wg = torch.zeros((_round_up(Nd, WG_COLS), Kp), dtype=torch.float32,
                       device=dev)
    b_wg[:Nd] = b
    m_wg = torch.zeros((_round_up(n_out, WG_MEL_COLS), nfp),
                       dtype=torch.float32, device=dev)
    m_wg[:No] = m
    return {"window": w, "dft": fragments(b), "mel": fragments(m),
            "dft_wg": wg_tiles(b_wg, WG_COLS),
            "mel_wg": wg_tiles(m_wg, WG_MEL_COLS),
            "nyq": nf - 1 if paired else -1}


def _dft_cols(n_freqs: int, paired: bool) -> int:
    """Columns of the rDFT table: 2 a bin, less the two zero sin columns
    where DC and Nyquist share a pair, padded to a multiple of 8."""
    return _round_up(2 * n_freqs - (2 if paired else 0), 8)


@dataclasses.dataclass(frozen=True)
class FbankPlan:
    """Launch plan of the fbank kernel.

    M frames a tile. At 64, wgmma: two warpgroups, each all 64 rows and
    half of each chunk's columns; the rDFT's Nd (a multiple of WG_COLS) in
    ``dft_chunks`` of WG_COLS columns (``dft_nt`` = 32 n-tiles), the mel
    stage's No (a multiple of WG_MEL_COLS) in chunks of WG_MEL_COLS
    (``mel_nt`` = 8). At 32 or 16, mma.sync: 8 warps, WARPS_N[M] along N,
    the rest along M, each warp MT = M / 16 / (8 / WARPS_N[M]) m-tiles; the
    rDFT's Nd / 8 n-tiles in ``dft_chunks`` chunks of ``dft_nt`` (the last
    may be smaller), the mel stage's No / 8 in ``mel_chunks`` of
    ``mel_nt``. A ring of ``stages`` slabs of 8 * max(dft_nt, mel_nt)
    columns x ``stage_k`` k-steps (2; 2 to 4 at M = 64, where a mel stage
    holds as many bytes); ``smem`` bytes; the tiles, grid (tiles an utterance,
    B), walked by ``ctas`` persistent CTAs (one an SM).
    """

    M: int
    stage_k: int
    stages: int
    dft_nt: int
    dft_chunks: int
    mel_nt: int
    mel_chunks: int
    Kp: int
    Nd: int
    nfp: int
    No: int
    smem: int
    grid: tuple[int, int]
    ctas: int


def fbank_smem(M: int, hop: int, Kp: int, nfp: int, stage_k: int,
               stage_cols: int, stages: int) -> int:
    """Shared-memory bytes of the kernel's layout (``tpuasr_fbank_smem``):
    the stages' mbarriers and release counts, the ring, the span (rows of
    min(hop, Kp) samples, stride 4 mod 8), the window and span offsets, and
    the power tile."""
    rows = M + (Kp - 1) // hop
    rlen = min(hop, Kp)
    ldh = rlen + (12 - rlen % 8) % 8
    return BAR_BYTES + 4 * (stages * stage_k * stage_cols * 16 + rows * ldh
                            + 2 * Kp + M * nfp)


def _chunks(total: int, cap: int) -> tuple[int, int]:
    """(n-tiles a chunk, chunks) for ``total`` n-tiles, at most ``cap`` a
    chunk, the chunks as even as the count allows."""
    chunks = -(-total // cap)
    return -(-total // chunks), chunks


def fbank_plan(B: int, T: int, hop: int, win: int, n_freqs: int, n_out: int,
               n_sm: int = 132, paired: bool = True,
               M: int | None = None) -> FbankPlan:
    """Tile M, chunks, ring stages, shared memory, tiles and CTAs.

    M is 64 (wgmma) with the first ring of WG_RINGS that fits 227 KB. Past
    that (a large n_fft: 64 frames' span and power tile), the
    mma.sync route: M = 32, then 16, each with 3 stages, the chunks
    narrowing (down to one n-tile), then 2 stages. ValueError past that.
    The batch does not choose M. The CTAs: one an SM, at most one a tile.
    ``paired``: the table pairs DC and Nyquist (``nyquist_pairs``). ``M``:
    take that tile height or raise (the card tests and
    tools/fbank_time.py hold the heights against each other).
    """
    if min(B, T, hop, win, n_freqs, n_out) < 1:
        raise ValueError(f"fbank_plan: empty shape B={B} T={T} hop={hop} "
                         f"win={win} n_freqs={n_freqs} n_out={n_out}")
    Kp, Nd = _round_up(win, 8), _dft_cols(n_freqs, paired and n_freqs > 1)
    nfp, No = _round_up(n_freqs, 8), _round_up(n_out, 8)

    def plan(m, stage_k, stages, dft_nt, dft_chunks, mel_nt, mel_chunks,
             nd, no, smem):
        tiles = -(-T // m)
        return FbankPlan(m, stage_k, stages, dft_nt, dft_chunks, mel_nt,
                         mel_chunks, Kp, nd, nfp, no, smem, (tiles, B),
                         min(tiles * B, n_sm))

    heights = (64, 32, 16) if M is None else (M,)
    nd_wg, no_wg = _round_up(Nd, WG_COLS), _round_up(n_out, WG_MEL_COLS)
    for stage_k, stages in WG_RINGS if 64 in heights else ():
        smem = fbank_smem(64, hop, Kp, nfp, stage_k, WG_COLS, stages)
        if smem <= SMEM_LIMIT:
            return plan(64, stage_k, stages, WG_COLS // 8, nd_wg // WG_COLS,
                        WG_MEL_COLS // 8, no_wg // WG_MEL_COLS, nd_wg, no_wg,
                        smem)
    for m in heights:
        if m == 64:
            continue
        wn = WARPS_N[m]
        caps = [wn * p for p in range(NT_MAX, 0, -1)]
        caps += [c for c in (4, 2, 1) if c < wn]
        for stages in (3, 2):
            for cap in caps:
                dft_nt, dft_chunks = _chunks(Nd // 8, cap)
                mel_nt, mel_chunks = _chunks(No // 8, cap)
                smem = fbank_smem(m, hop, Kp, nfp, STAGE_K,
                                  8 * max(dft_nt, mel_nt), stages)
                if smem <= SMEM_LIMIT:
                    return plan(m, STAGE_K, stages, dft_nt, dft_chunks, mel_nt,
                                mel_chunks, Nd, No, smem)
    raise ValueError(
        f"fbank_plan: win={win}, hop={hop}, n_freqs={n_freqs} needs more "
        f"than {SMEM_LIMIT} bytes of shared memory at "
        f"{heights[-1]} frames a CTA")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fbank_power_plain(wav: torch.Tensor, tables: dict, hop: int,
                      T: int) -> torch.Tensor:
    """Plain version of the kernel: (B, S) wav -> (B, T, out) f32."""
    frames = frames_plain(wav, hop, tables["window"].shape[0], T)
    return mel_power_plain(frames, tables)


def fbank_power(wav: torch.Tensor, tables: dict, hop: int,
                T: int) -> torch.Tensor:
    """Projected power spectrum of frames [t*hop, t*hop + win), t < T.

    wav (B, S) f32 with (T - 1) * hop + win <= S; tables from
    ``feature_tables``, with the kernel's operands under "packed"
    (``pack_tables``; packed here when missing). CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise.
    """
    win = tables["window"].shape[0]
    if wav.ndim != 2 or (T - 1) * hop + win > wav.shape[1] or T <= 0:
        raise ValueError(f"wav {tuple(wav.shape)} too short for {T} frames "
                         f"of {win} at hop {hop}")
    if wav.device.type == "cpu":
        return fbank_power_plain(wav, tables, hop, T)
    if wav.device.type != "cuda":
        raise ValueError(f"fbank_power: unsupported device {wav.device}")
    n_freqs = tables["cos"].shape[1]
    n_out = tables["proj"].shape[1]
    for name in ("window", "cos", "sin", "proj"):
        t = tables[name]
        if t.device != wav.device or t.dtype != torch.float32:
            raise ValueError(f"fbank_power: {name} must be float32 on "
                             f"{wav.device}, got {t.dtype} on {t.device}")
    if (tables["cos"].shape != (win, n_freqs)
            or tables["sin"].shape != (win, n_freqs)
            or tables["proj"].shape[0] != n_freqs):
        raise ValueError("fbank_power: inconsistent table shapes")
    B, S = wav.shape
    packed = tables.get("packed") or pack_tables(tables)
    plan = fbank_plan(B, T, hop, win, n_freqs, n_out,
                      _sm_count(wav.device.index or 0), packed["nyq"] >= 0)
    _build.check_tensor("wav", wav, wav.device, (torch.float32,), (B, S))
    if plan.M == 64:
        dft, mel = "dft_wg", "mel_wg"
        shapes = ((plan.Nd // WG_COLS, plan.Kp // 8, 2, 2, WG_COLS, 4),
                  (plan.No // WG_MEL_COLS, plan.nfp // 8, 2, 2, WG_MEL_COLS,
                   4))
    else:
        dft, mel = "dft", "mel"
        shapes = ((plan.Kp // 8, plan.Nd, 4, 4), (plan.nfp // 8, plan.No, 4,
                                                 4))
    for name, shape in (("window", (plan.Kp,)), (dft, shapes[0]),
                        (mel, shapes[1])):
        _build.check_tensor(f"packed {name}", packed[name], wav.device,
                            (torch.float32,), shape)
    out = torch.empty((B, T, n_out), dtype=torch.float32, device=wav.device)
    fn = _build.lib().tpuasr_fbank_power
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(wav.device):
        code = fn(_build.ptr(wav), _build.ptr(packed["window"]),
                  _build.ptr(packed[dft]), _build.ptr(packed[mel]),
                  _build.ptr(out), B, S, T, hop, plan.Kp, plan.Nd, plan.nfp,
                  plan.No, n_out, packed["nyq"], plan.M, plan.dft_nt,
                  plan.mel_nt, plan.stage_k, plan.stages, plan.ctas,
                  plan.smem,
                  _build.stream_ptr(wav))
        fbank_power.launches += 1
    _build.check(code, "fbank_power")
    return out


fbank_power.launches = 0


class FusedFeaturizer(Featurizer):
    """Featurizer whose framing, window, rDFT, power and mel projection run
    in one kernel on CUDA (plain torch on CPU); same interface and output
    as ``reference.Featurizer``. MFCC is the kernel's log-mel, then the DCT
    and lifter as a matmul outside it, where JAX also has them
    (pallas_fused.py:272-276); dither as in the plain path. The kernel
    frames the kaldi way only, so torch framing and ``center`` raise, as
    in JAX (pallas_fused.py:170-172). Splicing raises too: JAX's fused path
    skips it and returns ``base_dim``-wide features where ``feat_dim`` says
    otherwise. The kernel's packed tables are built once, here."""

    def __init__(self, cfg, device="cuda"):
        if cfg.center or cfg.frame_style != "kaldi":
            raise ValueError("FusedFeaturizer supports the kaldi framing "
                             "path (center=False); use Featurizer otherwise")
        if cfg.splice_left or cfg.splice_right:
            raise ValueError("FusedFeaturizer does not splice frames (the "
                             "JAX fused path drops the splice context); use "
                             "Featurizer")
        super().__init__(cfg, device)
        self.tables["packed"] = pack_tables(self.tables)

    def power_spectrum(self, wav: torch.Tensor, T: int) -> torch.Tensor:
        return fbank_power(wav, self.tables, self.cfg.hop_length, T)
