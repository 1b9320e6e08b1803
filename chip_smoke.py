"""On-card smoke test of tpuasr_torch, the PyTorch + CUDA port (one H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: Python, torch, CUDA, and the card's name and power limit;
  2. build of the CUDA kernels from tpuasr_torch/csrc, timed;
  3. the bench decoding graph (bench.py:183-201: a 200-word lexicon
     composed with a word bigram, 58,272 states), built on the host and
     timed; then each kernel against its plain PyTorch version on the
     card, with its error, tolerance, timing, the least time the card could
     take for its work (bound) and, where one PyTorch call computes the
     same function, that call's time: the serving kernels K1, K2, K4, K3
     (without and with bigram/trigram LM fusion) and K10 (the graph row
     gather) at the shapes of the served model (B=128 utterances of 10 s at
     8 kHz, C=64, a 512 x 4 BiGRU, beam K=8), K9 (the int8 conv2) at its
     shapes in that model, K7 (both GRU directions in one launch) at the
     served and trained shapes, and the training kernels K5, K5b, K7b, K6,
     K6b at the shapes of the BASELINE config-3 train step (B=16 x 5 s,
     T'=249, U=24), and K8 and K8b (CapsNet routing, forward and
     backward) at the shapes of BASELINE config 4 (B=8 and B=32 x 5 s,
     T'=249, I=256, Din=8, O=48, D=16, 3 iterations);
  4. the serving slice through Recognizer: the int8 arm (the default), the
     bf16 arm, the int8 arm with conv2 as K9 (int8_conv, bench.py's
     --int8-conv) and the bf16 arm of a fused_bidir model (K7), with
     launch counts (and cuDNN conv calls), agreement with the plain path,
     and x-real-time of the kernel path and of the plain path, and the conv
     frontend's time with and without K9; then the CapsNet arm (config 4's
     model, 48 classes), greedy and with the beam, at B=8 and B=32 x 5 s
     and on a ragged B=8 batch, with the same checks and its device time
     by kernel;
  5. the LM and graph serving arms through Recognizer: the int8 arm with
     bigram fusion, and the graph-constrained search at class_topk 8 and
     63, with launch counts, agreement with the plain path and x-real-time;
  6. a few requests through tpuasr_torch.cli.predict on wav files it
     writes: beam, beam with LM fusion, and graph decoding, and one
     `predict capsule1` beam request;
  7. the training slice through Trainer.train_step (config 3: the 512 x 4
     DeepSpeechCTC in float32, adamw, B=16 x 5 s, U=24): launch counts per
     step, step 1 against the plain path, the loss after 10 steps on the
     repeated batch, and train-step ms at B=16 and B=64; then the same
     step with fused_bidir=True (K7 and K7b in place of K5 and K5b);
  8. the CapsNet training step through Trainer.train_step (config 4:
     capsule1 with 48 classes, CTC, adamw 3e-4, B=8 x 5 s, U=16): launch
     counts per step, step 1 against the plain path, the loss after 10
     steps on the repeated batch, and train-step ms at B=8 and B=32.

Weights are random, made from a seed. The line before the last holds
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Without
a CUDA device, or if any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SR = 8000
SECONDS = 10.0
B = 128
NUM_CLASSES = 64
HIDDEN = 512
LAYERS = 4
BEAM = 8
SEED = 0
ROOT = Path(__file__).resolve().parent
# Config 3 (benchmarks/config3_deepspeech_train.py): the train step's batch.
# Config 4's train step also takes utterances of TRAIN_SECONDS.
TRAIN_B = 16
TRAIN_SECONDS = 5.0
TRAIN_U = 24
# LM fusion: weight, and the 64 unit symbols of the seeded unit LMs.
LM_WEIGHT = 0.5
UNITS = ["<blank>"] + [f"p{i}" for i in range(1, NUM_CLASSES)]
# Config 4 (benchmarks/config4_capsnet.py:22, tpuasr/utils/params.py:29-33):
# CapsNetCTC's defaults at 48 classes, B=8 x 5 s; and B=32, the batch the
# Pallas routing kernel's docstring sizes. The seeded W_route is scaled up
# (CAPS_W_SCALE) so that the routing is not flat: at the init scale every
# class capsule has length ~0.001 and the log-probs span 0.014 nats (near
# ties everywhere); scaled, they span ~6 nats.
CAPS_CLASSES = 48
CAPS_SECONDS = 5.0
CAPS_BATCHES = (8, 32)
CAPS_W_SCALE = 20.0
CAPS_UNITS = ["<blank>"] + [f"p{i}" for i in range(1, CAPS_CLASSES)]
# Config 4's train step (benchmarks/config4_capsnet.py:22-37): U=16 tokens.
CAPS_TRAIN_U = 16
# K8b's bound: du and dW each within 2e-5 of its largest magnitude (float32
# sums in other orders: dW over all B*T' rows, du over O*D terms; the
# kernel rebuilds the coupling from u_hat . (v_0 + ... + v_{iters-2})).
K8B_TOL = 2e-5
# Published H100 SXM peaks: HBM bytes/s and dense operations/s by type.
HBM_BPS = 3.35e12
PEAK = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) for moving nbytes and doing ops of type kind,
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def library_gru_ms(T, B, D, H, dtype, backward, iters=3,
                   bidirectional=False):
    """ms of torch.nn.GRU (cuDNN, b_hh = 0) on (T, B, D): the forward, or
    the backward of a kept forward. It includes the input projection."""
    gru = torch.nn.GRU(D, H, bidirectional=bidirectional).to("cuda", dtype)
    gru.flatten_parameters()
    with torch.no_grad():
        for name, p in gru.named_parameters():
            if name.startswith("bias_hh"):
                p.zero_()
    x = torch.randn(T, B, D, device="cuda", dtype=dtype,
                    requires_grad=backward)
    if not backward:
        with torch.no_grad():
            return cuda_ms(lambda: gru(x), iters)
    y, _ = gru(x)
    dy = torch.randn_like(y)
    return cuda_ms(lambda: torch.autograd.backward(y, dy, retain_graph=True),
                   iters)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the device, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """(fn(), its ms on the device from CUDA events), for a call too slow
    to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def queued_ms(fn, iters: int) -> float:
    """Mean device ms per call of a kernel too short to outrun the host:
    the stream first sleeps ~25 ms on the card while the host queues all
    the calls, so the events time the device, not the Python launch path."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 20) -> float:
    """Mean ms of fn with the L2 cache flushed before each call (a 256 MB
    write evicts the H100's 50 MB L2)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def unit_lm(order: int):
    """A seeded n-gram LM over the 64 unit symbols (Witten-Bell, 300
    sentences of 5-29 units)."""
    from tpuasr_torch.lm import train_ngram

    rng = np.random.default_rng(SEED)
    return train_ngram([[UNITS[int(v)] for v in rng.integers(
        1, NUM_CLASSES, size=int(rng.integers(5, 30)))] for _ in range(300)],
        order=order)


def bench_lexicon():
    """bench.py:183-195: seed 7, 200 words of 2-4 unit ids, 400 sentences
    of 3-8 words."""
    grng = np.random.default_rng(7)
    prons, seen = [], set()
    while len(prons) < 200:
        p = tuple(int(v) for v in
                  grng.integers(1, NUM_CLASSES, size=int(grng.integers(2, 5))))
        if p not in seen:
            seen.add(p)
            prons.append((f"w{len(prons):03d}", p))
    sents = [[f"w{int(v):03d}" for v in
              grng.integers(0, len(prons), size=int(grng.integers(3, 9)))]
             for _ in range(400)]
    return prons, sents


def bench_graph():
    """The bench LG (bench.py:196-201): the lexicon composed with a word
    bigram, determinized with prune 10, quantum 0.1, at most 400,000
    states. -> (GraphTables, seconds on the host)."""
    from tpuasr_torch.decode import (compile_graph_tables, compose,
                                     lexicon_to_fst, ngram_to_fst)
    from tpuasr_torch.lm import train_ngram

    t0 = time.perf_counter()
    prons, sents = bench_lexicon()
    lg = compose(lexicon_to_fst(prons),
                 ngram_to_fst(train_ngram(sents, order=2),
                              {w: i + 1 for i, (w, _) in enumerate(prons)}))
    tabs = compile_graph_tables(lg, NUM_CLASSES, max_states=400_000,
                                prune=10.0, quantum=0.1)
    return tabs, time.perf_counter() - t0


def lm_graph_kernels(record, lp, blens, lms, g_pack) -> None:
    """Phase 3 for K3 with LM fusion (trigram, then the served bigram) and
    K10 at the served shapes (B=128, T'=499, C=64, K=8)."""
    from tpuasr_torch.cli.common import fusion_tables
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.ops import gather as gather_mod

    Bk, T, C = lp.shape
    dev = lp.device
    # Backpointers, last and last2 exact; final scores within 1e-4 (the
    # kernel rounds every add and multiply as the plain version does, so
    # they agree bit for bit in practice); tokens and lengths of the whole
    # search exact.
    for order in (3, 2):
        tabs = {k: torch.as_tensor(v, device=dev)
                for k, v in fusion_tables(lms[order], UNITS, order).items()}
        tab = tabs["lm_trigram" if order == 3 else "lm_bigram"]
        tab = tab.reshape(-1, C).contiguous()
        args = (lp, blens, BEAM, 0, 256, tab, order, LM_WEIGHT, order == 3)
        got = beam_mod.beam_scan(*args)
        ref, pms = timed_once(lambda: beam_mod.beam_scan_plain(*args))
        same_int = all(torch.equal(got[i], ref[i]) for i in (0, 4, 5))
        err = max((got[i] - ref[i]).abs().max().item() for i in (1, 2, 3))
        cfg = BeamSearchConfig(beam_width=BEAM, max_len=256,
                               lm_weight=LM_WEIGHT)
        out_k = beam_mod.ctc_beam_search(lp, blens, cfg, **tabs)
        with mock.patch.object(beam_mod, "beam_scan", lambda *a: ref):
            out_p = beam_mod.ctc_beam_search(lp, blens, cfg, **tabs)
        same_tok = (torch.equal(out_k["tokens"], out_p["tokens"])
                    and torch.equal(out_k["token_lens"], out_p["token_lens"])
                    and torch.equal(out_k["scores"], out_p["scores"]))
        ms = cuda_ms(lambda: beam_mod.beam_scan(*args), 5)
        # Operations: the no-LM count plus the LM add, multiply and add per
        # candidate; bytes: log-probs and the table in, backpointers and
        # final state out.
        bd = bound(nbytes(lp, blens, tab, *got), 8 * Bk * T * BEAM * C,
                   "fp32")
        phase(f"[3 K3-LM] beam {'trigram' if order == 3 else 'bigram'} "
              f"table {tuple(tab.shape)} B={Bk} T={T} C={C} K={BEAM} "
              f"lm_w={LM_WEIGHT}: backpointers+last+last2 equal {same_int},"
              f" scores max_abs_err {err:.3e} (tol 1e-4), tokens+lengths+"
              f"scores equal {same_tok} (tol: exact) kernel {ms:.3f} ms "
              f"plain {pms:.3f} ms bound {bd[0]:.4f} ms ({bd[1]}); no "
              "PyTorch call computes it")
        if not (same_int and err <= 1e-4 and same_tok):
            fail(f"beam kernel with order-{order} LM fusion disagrees with "
                 "its plain version")
        record("K3-LM", "ctc_beam with LM fusion (bigram; trigram checked)",
               "tpuasr_torch/csrc/ctc_beam.cu",
               "tpuasr/decode/pallas_beam.py:455", err, ms, pms, bd)

    # K10 on the bench-scale packed table, B*K = 1,024 indices with some
    # past either end (clamped): exact.
    S, W = g_pack.shape
    idx = torch.randint(0, S, (Bk, BEAM), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(SEED + 2))
    idx[0, :4] = torch.tensor([S, S + 1000, -1, 2 ** 31 - 1])
    idx = idx.to(dev)
    got = gather_mod.gather_rows(g_pack, idx)
    ref = gather_mod.gather_rows_plain(g_pack, idx)
    exact = torch.equal(got, ref)
    flat = idx.reshape(-1).long().clamp(0, S - 1)
    ms = queued_ms(lambda: gather_mod.gather_rows(g_pack, idx), 100)
    ms_cold = cold_ms(lambda: gather_mod.gather_rows(g_pack, idx))
    host_ms = cuda_ms(lambda: gather_mod.gather_rows(g_pack, idx), 100)
    pms = queued_ms(lambda: gather_mod.gather_rows_plain(g_pack, idx), 100)
    lib = queued_ms(lambda: torch.index_select(g_pack, 0, flat), 100)
    rows = int(torch.unique(flat).numel())
    bd = bound(rows * W * 4 + nbytes(idx, got), 0, "fp32")
    phase(f"[3 K10] gather_rows table ({S}, {W}) int32 "
          f"({S * W * 4 / 2 ** 20:.1f} MiB), {idx.numel()} indices "
          f"({rows} distinct rows, 4 out of range): equal {exact} (tol: "
          f"exact) kernel {ms * 1e3:.2f} us (L2 warm), {ms_cold * 1e3:.2f} "
          f"us (L2 flushed), {host_ms * 1e3:.2f} us per call back to back "
          f"from Python (host-bound) plain {pms * 1e3:.2f} us bound "
          f"{bd[0] * 1e3:.3f} us ({bd[1]}) torch.index_select "
          f"{lib * 1e3:.2f} us")
    if not exact:
        fail("gather_rows disagrees with its plain version")
    record("K10", "gather_rows (int32 graph rows)",
           "tpuasr_torch/csrc/gather_rows.cu",
           "tpuasr/ops/pallas_gather.py:82", 0.0, ms, pms, bd, lib)


def lm_graph_slice(kernels, wrappers, model, feat_cfg, wav_d, lens_d, tabs_g,
                   lms, plain_path, card, audio_s, T_out) -> None:
    """Phase 5: the LM and graph serving arms through Recognizer."""
    from tpuasr_torch.cli.common import fusion_tables
    from tpuasr_torch.decode import BeamSearchConfig, ctc_beam_search_xla
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.serve.offline import Recognizer

    lm_cfg = BeamSearchConfig(beam_width=BEAM, max_len=256,
                              lm_weight=LM_WEIGHT)
    recs = {"int8+bigram": Recognizer(
        model, feat_cfg, lm_cfg, "cuda",
        lm_tables=fusion_tables(lms[2], UNITS, 2))}
    for P in (8, NUM_CLASSES - 1):
        recs[f"graph P={P}"] = Recognizer(
            model, feat_cfg, BeamSearchConfig(beam_width=BEAM, class_topk=P,
                                              max_len=256), "cuda",
            graph=tabs_g)

    # The counted run of the LM and graph paths: one batch per arm.
    for w in wrappers.values():
        w.launches = 0
    per_arm, outs = {}, {}
    for arm, rec in recs.items():
        before = {k: w.launches for k, w in wrappers.items()}
        outs[arm] = rec(wav_d, lens_d)
        torch.cuda.synchronize()
        per_arm[arm] = {k: w.launches - before[k] for k, w in wrappers.items()}
    phase(f"[5 lm+graph] launch counts per batch: {json.dumps(per_arm)}")
    none = {k: 0 for k in wrappers}
    want = {arm: dict(none, K1=1, K4=2 * LAYERS,
                      **({"K3": 1} if arm == "int8+bigram"
                         else {"K10": T_out})) for arm in recs}
    if per_arm != want:
        fail(f"LM/graph launch counts {per_arm} != {want}")
    kernels["K3-LM"]["launches"] = per_arm["int8+bigram"]["K3"]
    kernels["K10"]["launches"] = sum(c["K10"] for c in per_arm.values())

    # The gate is the kernel search on the same log-probs (exact) and the
    # kernel path against the plain AM and search on the same features
    # (ter_tol catches a gross fault). The whole plain path is reported
    # only: its featurizer differs from K1 by float rounding, which flips
    # int8 roundings in the AM and then near-ties of a random model's flat
    # posteriors; a graph turns such a flip into another word path.
    ter_tol = 0.2
    for arm, rec in recs.items():
        out = outs[arm]
        logp, ol = out["log_probs"], out["out_lens"]
        graph = arm.startswith("graph")
        if not (bool(torch.isfinite(out["scores"]).all())
                and tuple(out["tokens"].shape) == (B, 1, 256)):
            fail(f"{arm}: non-finite scores or tokens of shape "
                 f"{tuple(out['tokens'].shape)}")
        before = sum(w.launches for w in wrappers.values())
        with torch.inference_mode():
            feats, flens = rec.featurizer.featurize(wav_d, lens_d)

        def search(lp_):
            if graph:
                return ctc_beam_search_xla(lp_, ol, rec.beam_cfg,
                                           graph=rec.graph)
            return beam_mod.ctc_beam_search(lp_, ol, rec.beam_cfg,
                                            **rec.lm_tables)

        with plain_path(), torch.inference_mode():
            pout = rec(wav_d, lens_d)
            same = search(logp)
            am_dec = search(rec.model(feats, flens)[0])
        if sum(w.launches for w in wrappers.values()) != before + 1:
            fail(f"{arm}: the plain path launched a kernel")
        keys = ("tokens", "token_lens") + (("reached_final",) if graph
                                           else ())
        exact = all(torch.equal(same[k], out[k]) for k in keys)
        ter, same_rows = token_error_rate(out, pout)
        am_ter, am_same = token_error_rate(out, am_dec)
        extra = ""
        if graph:
            extra = (f"; reached a final state {int(out['reached_final'].sum())}"
                     f"/{B}")
        phase(f"[5 {arm}] {', '.join(keys)} == plain search on the same "
              f"logp: {exact} (tol: exact); token error rate vs plain AM + "
              f"search on the same features {am_ter:.5f} ({am_same}/{B} "
              f"identical; tol {ter_tol}), vs the whole plain path {ter:.5f} "
              f"({same_rows}/{B}); mean tokens/utt "
              f"{out['token_lens'].float().mean().item():.1f}" + extra)
        if not (exact and am_ter <= ter_tol):
            fail(f"{arm}: kernel path disagrees with the plain path")
        rt = cuda_ms(lambda: rec(wav_d, lens_d), 3)
        with plain_path():
            prt = cuda_ms(lambda: rec(wav_d, lens_d), 1)
        phase(f"[5 {arm}] B={B} x {SECONDS:.0f} s ({audio_s:.0f} s of "
              f"audio): kernel path {rt:.2f} ms = "
              f"{audio_s / (rt / 1e3):.1f}x real time; plain path "
              f"{prt:.2f} ms = {audio_s / (prt / 1e3):.1f}x real time "
              f"[{card}]")
        if arm != f"graph P={NUM_CLASSES - 1}":
            phase(f"[5 {arm}] device time of one batch by kernel "
                  f"(torch.profiler): "
                  f"{device_breakdown(lambda: rec(wav_d, lens_d), top=8)}")
    # Pruned against full-width graph search (bench.py:243-254).
    a, b = outs["graph P=8"], outs[f"graph P={NUM_CLASSES - 1}"]
    agree = sum(
        int(a["token_lens"][i, 0]) == int(b["token_lens"][i, 0])
        and torch.equal(a["tokens"][i, 0, :int(a["token_lens"][i, 0])],
                        b["tokens"][i, 0, :int(b["token_lens"][i, 0])])
        for i in range(B)) / B
    phase(f"[5 graph] graph_prune_agree (class_topk 8 vs "
          f"{NUM_CLASSES - 1}, best tokens identical) {agree:.4f}")


def kernel_name(key: str) -> str:
    """'void (anonymous namespace)::gru_scan_kernel<...>(...)' -> 'gru_scan_kernel'."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    return key.split("<")[0].split("(")[0].split("::")[-1][:48]


def device_breakdown(fn, top: int = 6) -> str:
    """The largest device self times of one call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Host-side ranges (aten ops, autograd nodes such as _GRUScanBackward)
    # also carry the device time of the kernels they launched: leave them
    # out so that each kernel counts once.
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "_", "autograd::"))]
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    parts = [f"{us / 1e3:.3f} ms x{n} {kernel_name(name)}"
             for us, n, name in rows[:top]]
    return f"total {total / 1e3:.3f} ms; " + "; ".join(parts)


def token_error_rate(hyp: dict, ref: dict) -> tuple[float, int]:
    """Edit distance of hyp's best tokens to ref's over ref's token count,
    and the number of utterances whose tokens are identical."""
    errs = total = same = 0
    ht, hl = hyp["tokens"][:, 0].cpu().numpy(), hyp["token_lens"][:, 0].cpu()
    rt, rl = ref["tokens"][:, 0].cpu().numpy(), ref["token_lens"][:, 0].cpu()
    for i in range(len(ht)):
        a, b = ht[i, :int(hl[i])], rt[i, :int(rl[i])]
        total += len(b)
        if len(a) == len(b) and (a == b).all():
            same += 1
            continue
        row = np.arange(len(b) + 1)
        for x in a:
            prev, row = row, np.empty_like(row)
            row[0] = prev[0] + 1
            sub = prev[:-1] + (b != x)
            for j in range(1, len(b) + 1):
                row[j] = min(prev[j] + 1, row[j - 1] + 1, sub[j - 1])
        errs += int(row[-1])
    return errs / max(total, 1), same


def train_kernels(record, gen) -> None:
    """Phase 3 for the training kernels: K5/K5b over xp of both layer
    widths (D=512 feeds layer 0, D=1024 the others) and both directions,
    K6/K6b on the CTC edge cases, at the config-3 step's shapes (T'=249,
    B=16, H=512, C=64, U=24), float32 with TF32 off."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.precision import full_fp32

    dev = torch.device("cuda")
    T = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)
    Bt, H = TRAIN_B, HIDDEN
    lens = torch.randint(T // 2, T + 1, (Bt,), generator=gen)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    mask = mask.to(dev).contiguous()
    macs = T * Bt * H * 3 * H
    # K5 ys: atol 1e-4 (float32 sums of 512 terms in another order, carried
    # over 249 steps). K5b: within 1e-4 of each output's largest magnitude
    # (dWh sums T*B = 3,984 outer products).
    with full_fp32():
        for D in (512, 1024):
            x = torch.randn(T, Bt, D, generator=gen).to(dev)
            wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).to(dev)
            b = (torch.randn(3 * H, generator=gen) * 0.1).to(dev)
            wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
            dys = torch.randn(T, Bt, H, generator=gen).to(dev)
            xp = (x.reshape(T * Bt, D) @ wx + b).reshape(T, Bt, 3 * H)
            for rev in (False, True):
                ys = gru_mod.gru_scan_fwd(xp, wh, mask, rev)
                ref = gru_mod.gru_scan_plain(xp, wh, mask, rev)
                err = (ys - ref).abs().max().item()
                ysp = gru_mod.prev_states(ref, rev)
                dxp, dwh = gru_mod.gru_scan_bwd(xp, ysp, wh, mask, dys, rev)
                rdxp, rdwh = gru_mod.gru_scan_bwd_plain(xp, ysp, wh, mask,
                                                        dys, rev)
                e_dxp = (dxp - rdxp).abs().max().item()
                e_dwh = (dwh - rdwh).abs().max().item()
                t_dxp = 1e-4 * rdxp.abs().max().item()
                t_dwh = 1e-4 * rdwh.abs().max().item()
                ok = err <= 1e-4 and e_dxp <= t_dxp and e_dwh <= t_dwh
                phase(f"[3 K5/K5b] gru T={T} B={Bt} D={D} H={H} reverse="
                      f"{rev}: ys max_abs_err {err:.3e} (tol 1e-4); dxp "
                      f"{e_dxp:.3e} (tol {t_dxp:.3e}), dwh {e_dwh:.3e} (tol "
                      f"{t_dwh:.3e})")
                if not ok:
                    fail(f"K5/K5b disagree at D={D} reverse={rev}")
                t5 = t5b = ()
                if D == 1024 and not rev:
                    ms = cuda_ms(
                        lambda: gru_mod.gru_scan_fwd(xp, wh, mask, rev), 10)
                    pms = cuda_ms(
                        lambda: gru_mod.gru_scan_plain(xp, wh, mask, rev), 2)
                    bms = cuda_ms(lambda: gru_mod.gru_scan_bwd(
                        xp, ysp, wh, mask, dys, rev), 10)
                    pbms = cuda_ms(lambda: gru_mod.gru_scan_bwd_plain(
                        xp, ysp, wh, mask, dys, rev), 2)
                    bd = bound(nbytes(xp, wh, mask, ys), 2 * macs, "fp32")
                    bbd = bound(nbytes(xp, ysp, wh, mask, dys, dxp, dwh),
                                6 * macs, "fp32")
                    lib = library_gru_ms(T, Bt, D, H, torch.float32, False)
                    blib = library_gru_ms(T, Bt, D, H, torch.float32, True)
                    phase(f"[3 K5] kernel {ms:.3f} ms plain {pms:.3f} ms "
                          f"bound {bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU "
                          f"forward {lib:.3f} ms")
                    phase(f"[3 K5b] kernel {bms:.3f} ms plain {pbms:.3f} ms "
                          f"bound {bbd[0]:.4f} ms ({bbd[1]}) torch.nn.GRU "
                          f"backward {blib:.3f} ms")
                    t5, t5b = (ms, pms, bd, lib), (bms, pbms, bbd, blib)
                record("K5", "gru_scan_fwd", "tpuasr_torch/csrc/gru_bptt.cu",
                       "tpuasr/ops/pallas_gru.py:163", err, *t5)
                record("K5b", "gru_scan_bwd", "tpuasr_torch/csrc/gru_bptt.cu",
                       "tpuasr/ops/pallas_gru.py:190", max(e_dxp, e_dwh),
                       *t5b)

    # K6 / K6b: ragged lengths with a row of 0 frames, an empty label, a
    # short label, repeated labels (no skip), an infeasible row and garbage
    # past a label. Reachable entries (log-prob above -1e29) within rtol
    # 1e-5; unreachable ones where the plain version has them.
    C, U = NUM_CLASSES, TRAIN_U
    lp = torch.log_softmax(torch.randn(Bt, T, C, generator=gen) * 2.0, -1)
    labels = torch.randint(1, C, (Bt, U), generator=gen)
    il = torch.randint(T // 2, T + 1, (Bt,), generator=gen)
    ll = torch.full((Bt,), U)
    il[0], il[1], ll[2], ll[3] = T, 0, 0, 5
    labels[4, :] = 7
    il[4] = 30                                 # needs 2U - 1 = 47 frames
    labels[5, :6] = 9
    ll[6] = 10
    labels[6, 10:] = torch.randint(-9, 200, (U - 10,), generator=gen)
    lp, labels, il, ll = lp.to(dev), labels.to(dev), il.to(dev), ll.to(dev)
    ext, allow, valid, lp_ext = ctc_mod.prepare(lp, labels, ll)
    S = lp_ext.shape[2]
    cases = (
        ("K6", "ctc_alphas_kernel", "tpuasr/losses/ctc_pallas.py:167",
         lambda: ctc_mod.ctc_alphas_kernel(lp_ext, allow, valid),
         lambda: ctc_mod.ctc_alphas_plain(lp_ext, allow, valid), ()),
        ("K6b", "ctc_betas_kernel", "tpuasr/losses/ctc_pallas.py:192",
         lambda: ctc_mod.ctc_betas_kernel(lp_ext, allow, valid, il, ll),
         lambda: ctc_mod.ctc_betas_plain(lp_ext, allow, valid, il, ll),
         (il, ll)))
    # The library yardstick takes the same log-probs and lengths, with the
    # labels clipped to classes and at least one frame per row.
    lab_ok = labels.clamp(0, C - 1).long()
    il_ok = il.clamp(min=1).long()
    lp_lib = lp.permute(1, 0, 2).detach().requires_grad_()

    def lib_loss():
        return torch.nn.functional.ctc_loss(
            lp_lib, lab_ok, il_ok, ll.long(), reduction="none",
            zero_infinity=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(lib_loss, 20)
    lib_fb = cuda_ms(lambda: torch.autograd.grad(lib_loss().sum(), lp_lib),
                     20)
    for key, name, replaces, kern, plain, extra in cases:
        got, want = kern(), plain()
        reach = want > -1e29
        same_reach = torch.equal(got > -1e29, reach)
        diff = (got[reach] - want[reach]).abs()
        err = diff.max().item()
        ok = same_reach and bool((diff <= 1e-5 * want[reach].abs()
                                  + 1e-6).all())
        ms = cuda_ms(kern, 20)
        pms = cuda_ms(plain, 2)
        bd = bound(nbytes(lp_ext, allow, valid, got, *extra), 12 * T * Bt * S,
                   "fp32")
        lib = lib_fwd if key == "K6" else lib_fb
        phase(f"[3 {key}] ctc T={T} B={Bt} S={S}: reachable {int(reach.sum())}"
              f" of {reach.numel()}, same reachability {same_reach}, "
              f"max_abs_err {err:.3e} (tol rtol 1e-5) kernel {ms:.4f} ms "
              f"plain {pms:.3f} ms bound {bd[0]:.5f} ms ({bd[1]}) "
              f"F.ctc_loss {'forward' if key == 'K6' else 'forward+backward'}"
              f" {lib:.4f} ms")
        if not ok:
            fail(f"{key} disagrees with its plain version")
        record(key, name, "tpuasr_torch/csrc/ctc_fb.cu", replaces, err, ms,
               pms, bd, lib)


def fused_bidir_state(state):
    """A DeepSpeechCTC state dict under the fused BiGRU's names: the same
    weights, rnn{i}.fwd.wx -> rnn{i}.fwd_wx and so on."""
    out = {}
    for k, v in state.items():
        parts = k.split(".")
        if len(parts) == 3 and parts[1] in ("fwd", "bwd"):
            k = f"{parts[0]}.{parts[1]}_{parts[2]}"
        out[k] = v
    return out


def conv_bidir_kernels(record, gen) -> None:
    """Phase 3 for K9 at config 5's conv2 (B=128 x 10 s: T'=499 rows of F=32
    x C=32 -> 16 x 32, Kt=11 taps), K7 at the serving shapes (B=128,
    T'=499, H=512, bf16 and f32) and the training shapes (config 3:
    B=16, T'=249, f32), and K7b at the training shapes."""
    import torch.nn.functional as F

    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.models.layers import (FrontConv, _same_pad,
                                            reverse_sequences)
    from tpuasr_torch.ops import conv as conv_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.ops.quant import quantize_per_channel
    from tpuasr_torch.precision import full_fp32

    dev = torch.device("cuda")
    T = -(-num_frames(FeatureConfig(), int(SR * SECONDS)) // 2)
    C, Fi, Kt, Kf = 32, 32, 11, 21
    F_out = -(-Fi // 2)
    Kd, N = Fi * C, F_out * C
    # conv2's seeded weight at flax's lecun-normal scale, folded into its
    # band matrices and quantized per column, as FrontConv does per call.
    w = torch.randn(C, C, Kt, Kf, generator=gen) / (C * Kt * Kf) ** 0.5
    pf = _same_pad(Fi, Kf, 2)
    m = FrontConv.band_matrices(w.permute(2, 3, 1, 0), Fi, F_out, Kf, 2,
                                pf[0])
    mq, sw = quantize_per_channel(m.reshape(-1, N))
    mq, sw = mq.reshape(Kt, Kd, N).to(dev), sw.to(dev)
    # conv2's input: post-ReLU activations of ragged utterances, zero past
    # each length, padded in time by SAME's (5, 5).
    lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lens[0] = T
    x = torch.relu(torch.randn(B, T, Kd, generator=gen))
    x = x * (torch.arange(T)[None, :, None] < lens[:, None, None])
    pt = _same_pad(T, Kt, 1)
    xf = F.pad(x, (0, 0, pt[0], pt[1])).to(dev).contiguous()
    del x

    def kern():
        return conv_mod.conv_taps_q8(xf, mq, sw, T)

    def plain():
        return conv_mod.reference_q8_conv_taps(xf, mq, sw, T)

    # K9 to f32 rounding: the quantized values and the int32 sums are
    # exact; the dequant rounds as the plain version does.
    got, ref = kern(), plain()
    err = (got - ref).abs().max().item()
    same = (got == ref).double().mean().item()
    ok = bool(torch.allclose(got, ref, rtol=1e-6, atol=1e-6))
    ms = cuda_ms(kern, 10)
    pms = cuda_ms(plain, 2)
    bd = bound(nbytes(xf, mq, sw, got), 2 * B * T * Kt * Kd * N, "int8")
    # The layer it replaces: the sliding conv on the same input, fp32 with
    # TF32 off, and in bf16.
    x4 = F.pad(xf.reshape(B, T + Kt - 1, Fi, C).permute(0, 3, 1, 2),
               (pf[0], pf[1]))
    w4 = w.to(dev)
    with full_fp32():
        lib = cuda_ms(lambda: F.conv2d(x4, w4, stride=(1, 2)), 10)
    x4b, w4b = x4.bfloat16(), w4.bfloat16()
    lib_bf16 = cuda_ms(lambda: F.conv2d(x4b, w4b, stride=(1, 2)), 10)
    phase(f"[3 K9] conv_taps_q8 B={B} T_out={T} Kt={Kt} Kd={Kd} N={N}: "
          f"max_abs_err {err:.3e} (tol rtol 1e-6 atol 1e-6; |out| max "
          f"{ref.abs().max().item():.3f}; {same:.6f} of the outputs equal "
          f"bit for bit) kernel {ms:.3f} ms plain {pms:.3f} ms bound "
          f"{bd[0]:.4f} ms ({bd[1]}) F.conv2d fp32 (TF32 off) {lib:.3f} ms,"
          f" bf16 {lib_bf16:.3f} ms")
    if not ok:
        fail("K9 disagrees with its plain version")
    record("K9", "conv_taps_q8 (int8 conv2, im2col)",
           "tpuasr_torch/csrc/conv_q8.cu", "tpuasr/ops/pallas_conv.py:138",
           err, ms, pms, bd, lib)
    del xf, x4, x4b, got, ref

    # K7 / K7b: xp = x@Wx + b of a 1024-wide layer, xpb from the per-row
    # reversed x, as the fused BiGRU forms them.
    H, D = HIDDEN, 2 * HIDDEN
    T_tr = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)
    shapes = (("serving", T, B, (torch.bfloat16, torch.float32)),
              ("training", T_tr, TRAIN_B, (torch.float32,)))
    for label, Tn, Bn, dtypes in shapes:
        ln = torch.randint(Tn // 2, Tn + 1, (Bn,), generator=gen)
        ln[0], ln[1] = Tn, 1
        mask = (torch.arange(Tn)[:, None] < ln[None, :]).float()[:, :, None]
        mask = mask.to(dev).contiguous()
        xs = torch.randn(Tn, Bn, D, generator=gen).to(dev)
        xr = reverse_sequences(xs, ln)
        wx = [(torch.randn(D, 3 * H, generator=gen) / D ** 0.5).to(dev)
              for _ in range(2)]
        bx = [(torch.randn(3 * H, generator=gen) * 0.1).to(dev)
              for _ in range(2)]
        wh = [(torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
              for _ in range(2)]
        macs = 2 * Tn * Bn * H * 3 * H            # both directions' h @ Wh
        for dt in dtypes:
            with full_fp32():
                xp = [(a.reshape(Tn * Bn, D).to(dt) @ wx[i].to(dt)
                       + bx[i].to(dt)).reshape(Tn, Bn, 3 * H)
                      for i, a in enumerate((xs, xr))]
            args = (*xp, wh[0].to(dt), wh[1].to(dt), mask)
            # f32: within 1e-4 (K5's bound); bf16: K2's 2e-2.
            tol = 2e-2 if dt == torch.bfloat16 else 1e-4
            got = gru_mod.gru_scan_bidir_fwd(*args)
            with full_fp32():
                ref, pms = timed_once(
                    lambda: gru_mod.gru_scan_bidir_plain(*args))
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            ms = cuda_ms(lambda: gru_mod.gru_scan_bidir_fwd(*args), 5)
            kind = "bf16" if dt == torch.bfloat16 else "fp32"
            bd = bound(nbytes(*args, *got), 2 * macs, kind)
            lib = library_gru_ms(Tn, Bn, D, H, dt, False, bidirectional=True)
            phase(f"[3 K7] gru_scan_bidir {label} {kind} T={Tn} B={Bn} "
                  f"H={H}: max_abs_err {err:.3e} (tol {tol}) kernel "
                  f"{ms:.3f} ms plain {pms:.3f} ms bound {bd[0]:.4f} ms "
                  f"({bd[1]}) torch.nn.GRU bidirectional {kind} forward "
                  f"(input projection included) {lib:.3f} ms")
            if not err <= tol:
                fail(f"K7 {label} {kind} disagrees with its plain version")
            served = label == "serving" and dt == torch.bfloat16
            record("K7", "gru_scan_bidir_fwd (bf16 serving; f32 checked)",
                   "tpuasr_torch/csrc/gru_bidir.cu",
                   "tpuasr/ops/pallas_gru.py:406", err,
                   *((ms, pms, bd, lib) if served else ()))
        if label != "training":
            continue
        # K7b: each output within 1e-4 of its largest magnitude (dWh sums
        # T*B = 3,984 outer products per direction).
        dys = [torch.randn(Tn, Bn, H, generator=gen).to(dev)
               for _ in range(2)]
        ysp = [gru_mod.prev_states(r, False) for r in ref]
        bargs = (xp[0], xp[1], *ysp, wh[0], wh[1], mask, *dys)
        got = gru_mod.gru_scan_bidir_bwd(*bargs)
        with full_fp32():
            want = gru_mod.gru_scan_bidir_bwd_plain(*bargs)
            pms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd_plain(*bargs), 2)
        errs = [(a - r).abs().max().item() for a, r in zip(got, want)]
        tols = [1e-4 * r.abs().max().item() for r in want]
        again = gru_mod.gru_scan_bidir_bwd(*bargs)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd(*bargs), 10)
        bd = bound(nbytes(*bargs, *got), 6 * macs, "fp32")
        lib = library_gru_ms(Tn, Bn, D, H, torch.float32, True,
                             bidirectional=True)
        phase(f"[3 K7b] gru_scan_bidir_bwd T={Tn} B={Bn} H={H}: dxpf, dxpb,"
              f" dwhf, dwhb max_abs_err "
              f"{', '.join(f'{e:.3e}' for e in errs)} (tol "
              f"{', '.join(f'{t:.3e}' for t in tols)}); two launches equal "
              f"bit for bit {same} kernel {ms:.3f} ms plain {pms:.3f} ms "
              f"bound {bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU bidirectional "
              f"backward {lib:.3f} ms")
        if not (all(e <= t for e, t in zip(errs, tols)) and same):
            fail("K7b disagrees with its plain version")
        record("K7b", "gru_scan_bidir_bwd", "tpuasr_torch/csrc/gru_bidir.cu",
               "tpuasr/ops/pallas_gru.py:437", max(errs), ms, pms, bd, lib)
    torch.cuda.empty_cache()


def capsnet_kernels(record, gen) -> None:
    """Phase 3 for K8 and K8b at config 4's shapes: u (B, 249, 256, 8) from
    the model's squash, W (256, 8, 48 * 16), a seeded dv for K8b, 3
    iterations, B = 8 and 32."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.ops import routing as routing_mod
    from tpuasr_torch.precision import full_fp32

    T = -(-num_frames(FeatureConfig(), int(SR * CAPS_SECONDS)) // 2)
    I, Din, O, D, iters = 256, 8, CAPS_CLASSES, 16, 3
    for Bc in CAPS_BATCHES:
        # Capsules of length ~0.9 and W of scale 0.5: the coupling moves
        # well off uniform (largest c about 5/O) and |v| reaches 0.9.
        u = routing_mod.squash(torch.randn(Bc, T, I, Din, generator=gen)
                               * 2.0).to("cuda").contiguous()
        W = (torch.randn(I, Din, O * D, generator=gen) * 0.5).to(
            "cuda").contiguous()
        dv = torch.randn(Bc, T, O, D, generator=gen).to("cuda")
        timed = Bc == CAPS_BATCHES[0]

        def kern():
            return routing_mod.routed_caps(u, W, O, D, iters)

        def plain():
            return routing_mod.routed_caps_plain(u, W, O, D, iters)

        def kern_bwd():
            return routing_mod.routed_caps_bwd(u, W, dv, O, D, iters)

        def plain_bwd():
            return routing_mod.routed_caps_bwd_plain(u, W, dv, O, D, iters)

        # K8: rtol 2e-5 / atol 2e-6, the JAX package's bound for its Pallas
        # kernel against the einsum path (float32 sums in other orders).
        with full_fp32():
            got, ref = kern(), plain()
            err = (got - ref).abs().max().item()
            ok = bool(torch.allclose(got, ref, rtol=2e-5, atol=2e-6))
            ms = cuda_ms(kern, 10)
            pms = cuda_ms(plain, 3)
        # Operations the function needs: u_hat, then the weighted sum in
        # every iteration and the agreement in all but the last
        # (tpuasr/models/capsnet.py:42-52); bytes: u and W in, v out.
        ops = Bc * T * (2 * Din * O * D * I + (4 * iters - 2) * O * D * I)
        bd = bound(nbytes(u, W, got), ops, "fp32")
        phase(f"[3 K8] routed_caps B={Bc} T={T} I={I} Din={Din} O={O} D={D}"
              f" iters={iters} ({Bc * T} rows): max_abs_err {err:.3e} (tol "
              f"rtol 2e-5 atol 2e-6; |v| max {ref.abs().max().item():.3f}) "
              f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bd[0]:.4f} ms "
              f"({bd[1]}); no PyTorch call computes it")
        if not ok:
            fail(f"K8 disagrees with its plain version at B={Bc}")
        record("K8", "routed_caps (routing forward)",
               "tpuasr_torch/csrc/routing.cu",
               "tpuasr/ops/pallas_routing.py:161", err,
               *((ms, pms, bd) if timed else ()))
        del got, ref

        # K8b: du and dW each within K8B_TOL of its largest magnitude.
        with full_fp32():
            got, ref = kern_bwd(), plain_bwd()
            errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
            tops = [r.abs().max().item() for r in ref]
            ms = cuda_ms(kern_bwd, 10)
            torch.cuda.reset_peak_memory_stats()
            pms = cuda_ms(plain_bwd, 2)
            plain_gb = torch.cuda.max_memory_allocated() / 1e9
        # Operations the gradient needs per row: u_hat, the routing to the
        # final s, du_hat, du and dW; bytes: u, W and dv in, du and dW out.
        ops = Bc * T * (6 * Din + 4 * iters - 1) * O * D * I
        bd = bound(nbytes(u, W, dv, *got), ops, "fp32")
        phase(f"[3 K8b] routed_caps_bwd B={Bc}: du max_abs_err {errs[0]:.3e}"
              f" of |du| max {tops[0]:.3e} (rel {errs[0] / tops[0]:.2e}), dW "
              f"{errs[1]:.3e} of {tops[1]:.3e} (rel {errs[1] / tops[1]:.2e};"
              f" tol {K8B_TOL:g} of each) kernel {ms:.3f} ms plain "
              f"{pms:.3f} ms (peak memory {plain_gb:.2f} GB) bound "
              f"{bd[0]:.4f} ms ({bd[1]}); no PyTorch call computes it")
        if not all(e <= K8B_TOL * t for e, t in zip(errs, tops)):
            fail(f"K8b disagrees with its plain version at B={Bc}")
        record("K8b", "routed_caps_bwd (routing backward)",
               "tpuasr_torch/csrc/routing_bwd.cu",
               "tpuasr/ops/pallas_routing.py:180", max(errs),
               *((ms, pms, bd) if timed else ()))
        del u, W, dv, got, ref
    torch.cuda.empty_cache()


def capsnet_model(dev):
    """Config 4's CapsNetCTC, seeded, W_route scaled by CAPS_W_SCALE."""
    from tpuasr_torch.models import create_model

    model = create_model("capsule1", num_classes=CAPS_CLASSES,
                         in_features=64,
                         generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.W_route.mul_(CAPS_W_SCALE)
    return model.to(dev)


def capsnet_slice(kernels, wrappers, card, plain_path) -> None:
    """Phase 4 for config 4: the CapsNet arm through Recognizer, greedy and
    with the K3 beam (K=8, C=48), on B=8 and B=32 x 5 s of seeded noise and
    on a ragged B=8 batch (2.5-5 s)."""
    from tpuasr_torch.decode import BeamSearchConfig, greedy_decode
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.serve.offline import Recognizer

    feat_cfg = FeatureConfig()
    model = capsnet_model("cuda")
    bcfg = BeamSearchConfig(beam_width=BEAM, max_len=256)
    recs = {"greedy": Recognizer(model, feat_cfg, None, "cuda"),
            "beam": Recognizer(model, feat_cfg, bcfg, "cuda")}
    S = int(SR * CAPS_SECONDS)
    T_out = -(-num_frames(feat_cfg, S) // 2)
    batches = {}
    for n in CAPS_BATCHES:
        rng = np.random.default_rng(SEED + n)
        wav = (rng.standard_normal((n, S)) * 0.1).astype(np.float32)
        batches[f"B={n}"] = (torch.as_tensor(wav, device="cuda"),
                             torch.full((n,), S, dtype=torch.int32,
                                        device="cuda"))
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(S // 2, S + 1, size=8).astype(np.int32)
    lens[0] = S
    wav = (rng.standard_normal((8, S)) * 0.1).astype(np.float32)
    wav[np.arange(S)[None, :] >= lens[:, None]] = 0.0
    batches["B=8 ragged"] = (torch.as_tensor(wav, device="cuda"),
                             torch.as_tensor(lens, device="cuda"))
    arms = {f"{dec} {b}": (dec, b) for b in batches
            for dec in ("greedy", "beam")}

    # The counted run of the CapsNet path: one batch per arm.
    for w in wrappers.values():
        w.launches = 0
    per_arm, outs = {}, {}
    for arm, (dec, b) in arms.items():
        before = {k: w.launches for k, w in wrappers.items()}
        outs[arm] = recs[dec](*batches[b])
        torch.cuda.synchronize()
        per_arm[arm] = {k: w.launches - before[k] for k, w in wrappers.items()}
    phase(f"[4 capsnet] launch counts per batch: {json.dumps(per_arm)}")
    none = {k: 0 for k in wrappers}
    want = {arm: dict(none, K1=1, K8=1, **({"K3": 1} if dec == "beam"
                                          else {}))
            for arm, (dec, _) in arms.items()}
    if per_arm != want:
        fail(f"CapsNet launch counts {per_arm} != {want}")
    kernels["K8"]["launches"] = sum(c["K8"] for c in per_arm.values())

    # Gates. logp of the AM alone on identical features within 1e-4 of the
    # plain AM (only K8 differs, by float32 summation order); the whole
    # plain path within 2e-2 (its featurizer differs from K1 by up to 1e-3
    # in log-mel, which this model amplifies about 4x); out_lens exact; the
    # beam's tokens equal the plain search's on the same log-probs
    # (exact). Greedy tokens are compared by token error rate: near-ties of
    # a random model can flip on a 1e-6 difference (tol 0.01 against the
    # plain AM, 0.05 against the whole plain path: gross faults only).
    for arm, (dec, b) in arms.items():
        out, rec = outs[arm], recs[dec]
        wav_d, lens_d = batches[b]
        n = wav_d.shape[0]
        logp, ol = out["log_probs"], out["out_lens"]
        if not (bool(torch.isfinite(logp).all())
                and tuple(logp.shape) == (n, T_out, CAPS_CLASSES)):
            fail(f"capsnet {arm}: non-finite log-probs or shape "
                 f"{tuple(logp.shape)}")
        before = sum(w.launches for w in wrappers.values())
        with torch.inference_mode():
            feats, flens = rec.featurizer.featurize(wav_d, lens_d)
        with plain_path(), torch.inference_mode():
            pout = rec(wav_d, lens_d)
            am_lp, am_ol = rec.model(feats, flens)
            if dec == "beam":
                same = beam_mod.ctc_beam_search(logp, ol, bcfg)
                am_dec = beam_mod.ctc_beam_search(am_lp, am_ol, bcfg)
            else:
                toks, tl = greedy_decode(am_lp, am_ol)
                am_dec = dict(tokens=toks[:, None], token_lens=tl[:, None])
        if sum(w.launches for w in wrappers.values()) != before + 1:
            fail(f"capsnet {arm}: the plain path launched a kernel")
        err = (logp - pout["log_probs"]).abs().max().item()
        am_err = (logp - am_lp).abs().max().item()
        lens_ok = (torch.equal(ol, pout["out_lens"])
                   and torch.equal(ol, am_ol))
        exact = dec != "beam" or all(torch.equal(same[k], out[k])
                                     for k in ("tokens", "token_lens"))
        ter, same_rows = token_error_rate(out, pout)
        am_ter, am_same = token_error_rate(out, am_dec)
        phase(f"[4 capsnet {arm}] logp max_abs_err vs plain AM on the same "
              f"features {am_err:.3e} (tol 1e-4), vs the whole plain path "
              f"{err:.3e} (tol 2e-2); out_lens equal {lens_ok}"
              + (f"; tokens == plain beam on the same logp: {exact}"
                 if dec == "beam" else "")
              + f"; token error rate vs plain AM {am_ter:.5f} ({am_same}/{n}"
              f" identical; tol 0.01), vs whole plain path {ter:.5f} "
              f"({same_rows}/{n}; tol 0.05); mean tokens/utt "
              f"{out['token_lens'].float().mean().item():.1f}")
        if not (am_err <= 1e-4 and err <= 2e-2 and lens_ok and exact
                and am_ter <= 0.01 and ter <= 0.05):
            fail(f"capsnet {arm}: kernel path disagrees with the plain path")
        if b == "B=8 ragged":
            continue
        audio_s = float(lens_d.sum()) / SR
        rt = cuda_ms(lambda: rec(wav_d, lens_d), 10)
        phase(f"[4 capsnet {arm}] x {CAPS_SECONDS:.0f} s ({audio_s:.0f} s "
              f"of audio): {rt:.3f} ms per batch (CUDA events, mean of 10 "
              f"after a warm-up) = {audio_s / (rt / 1e3):.1f}x real time "
              f"[{card}]")
        phase(f"[4 capsnet {arm}] device time of one batch by kernel "
              f"(torch.profiler): "
              f"{device_breakdown(lambda: rec(wav_d, lens_d), top=8)}")
        if dec == "greedy":
            with plain_path():
                prt = cuda_ms(lambda: rec(wav_d, lens_d), 2)
            phase(f"[4 capsnet {arm}] plain path {prt:.3f} ms per batch = "
                  f"{audio_s / (prt / 1e3):.1f}x real time [{card}]")


def train_phase(tag, cfg, U, sizes, want, count, patches, kernels,
                wrappers, card, prepare=None, check=None) -> None:
    """A train step through Trainer on the card, on a batch of seeded noise
    (sizes[0] utterances of TRAIN_SECONDS, U tokens each): the launch counts
    of one step (which must equal want; the counts of the kernels in count
    are kept), step 1 against the plain path (patches) within rtol 1e-4 on
    the same weights and dropout stream, the loss over 10 more steps on the
    repeated batch, and train-step ms at each batch size in sizes.
    prepare(model) adjusts the seeded weights in place; check(trainer,
    batch, fresh_state, metrics, plain_path) adds checks of step 1, where
    fresh_state() gives a state with step 1's weights."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import Trainer

    S = int(SR * TRAIN_SECONDS)

    def make_batch(n):
        rng = np.random.default_rng(SEED)
        wav = (rng.standard_normal((n, S)) * 0.2).astype(np.float32)
        tok = rng.integers(1, cfg.num_classes, (n, U)).astype(np.int32)
        return {k: torch.as_tensor(v, device="cuda") for k, v in dict(
            wav=wav, wav_lens=np.full((n,), S, np.int32), tokens=tok,
            token_lens=np.full((n,), U, np.int32),
            real=np.ones((n,), np.float32)).items()}

    def new_state(trainer, weights=None):
        state = trainer.init_state()
        with torch.no_grad():
            if weights is not None:
                state.model.load_state_dict(weights)
            elif prepare is not None:
                prepare(state.model)
        return state

    def timed(trainer, state, batch, n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state, m = trainer.train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        return state, m, start.elapsed_time(end) / n

    @contextlib.contextmanager
    def plain_path():
        with contextlib.ExitStack() as stack:
            for mod, name, fn in patches:
                stack.enter_context(mock.patch.object(mod, name, fn))
            yield

    trainer = Trainer(cfg, FeatureConfig(), device="cuda")
    batch = make_batch(sizes[0])
    state = new_state(trainer)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_params = sum(p.numel() for p in state.model.parameters())

    # The counted run of the training path: one step.
    for w in wrappers.values():
        w.launches = 0
    state, m1 = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers}, **want)
    phase(f"[{tag}] {n_params} parameters; launch counts per step: "
          f"{json.dumps(counts)}")
    if counts != want:
        fail(f"{tag}: launch counts {counts} != {want}")
    for k in count:
        kernels[k]["launches"] += counts[k]

    # Step 1 on the plain path: same weights, same dropout stream.
    plain = new_state(trainer, init)
    before = sum(w.launches for w in wrappers.values())
    with plain_path():
        t0 = time.perf_counter()
        plain, p1 = trainer.train_step(plain, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if sum(w.launches for w in wrappers.values()) != before:
        fail(f"{tag}: the plain training path launched a kernel")
    got = {k: float(v) for k, v in m1.items()}
    ref = {k: float(v) for k, v in p1.items()}
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
    phase(f"[{tag}] step 1: loss {got['loss']:.6f} grad_norm "
          f"{got['grad_norm']:.6f}; plain path {ref['loss']:.6f} "
          f"{ref['grad_norm']:.6f} ({plain_s:.2f} s, host clock); relative "
          f"differences {rel['loss']:.3e} {rel['grad_norm']:.3e} (tol 1e-4)")
    if not (all(np.isfinite(list(got.values())))
            and max(rel.values()) <= 1e-4):
        fail(f"{tag}: the training step disagrees with its plain path")
    del plain
    if check is not None:
        check(trainer, batch, lambda: new_state(trainer, init), got,
              plain_path)

    # Step 2 warms up; then 10 timed steps on the repeated batch.
    state, m2 = trainer.train_step(state, batch)
    loss2 = float(m2["loss"])
    state, m12, ms = timed(trainer, state, batch, 10)
    loss12 = float(m12["loss"])
    phase(f"[{tag}] loss step 2 {loss2:.4f} -> step 12 {loss12:.4f} "
          "(must fall)")
    if not (np.isfinite(loss12) and loss12 < loss2):
        fail(f"{tag}: the loss did not fall over 10 steps on the repeated "
             "batch")
    results = [(sizes[0], ms, trainer, state, batch)]
    for n in sizes[1:]:
        tr = Trainer(cfg, FeatureConfig(), device="cuda")
        bt = make_batch(n)
        st, _ = tr.train_step(new_state(tr), bt)
        st, mn, ms_n = timed(tr, st, bt, 10)
        if not np.isfinite(float(mn["loss"])):
            fail(f"{tag}: non-finite loss at B={n}")
        results.append((n, ms_n, tr, st, bt))
    for n, ms_n, tr, st, bt in results:
        phase(f"[{tag}] B={n} x {TRAIN_SECONDS:.0f} s f32: train step "
              f"{ms_n:.2f} ms (CUDA events, mean of 10 after a warm-up) = "
              f"{n / (ms_n / 1e3):.1f} utt/s [{card}]")
        phase(f"[{tag}] B={n} device time of one step by kernel "
              f"(torch.profiler): "
              f"{device_breakdown(lambda: tr.train_step(st, bt), top=8)}")
    torch.cuda.synchronize()


def train_slice(kernels, wrappers, card) -> None:
    """Phase 7: config 3's train step through Trainer on the card (the 512
    x 4 DeepSpeechCTC in float32, adamw, B=16 and 64 x 5 s, U=24)."""
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.train import TrainConfig

    cfg = TrainConfig(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                      warmup_steps=1,
                      model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                        pallas_gru=True))
    counted = dict(K5=2 * LAYERS, K5b=2 * LAYERS, K6=1, K6b=1)
    ctc_patches = ((ctc_mod, "ctc_alphas_kernel", ctc_mod.ctc_alphas_plain),
                   (ctc_mod, "ctc_betas_kernel", ctc_mod.ctc_betas_plain))
    patches = ((gru_mod, "gru_scan_fwd", gru_mod.gru_scan_plain),
               (gru_mod, "gru_scan_bwd", gru_mod.gru_scan_bwd_plain),
               *ctc_patches)
    train_phase("7 train", cfg, TRAIN_U, (TRAIN_B, 64), counted, counted,
                patches, kernels, wrappers, card)
    # The same step with fused_bidir=True: K7 and K7b once per layer, no
    # K5/K5b. Its K7 launches add to the serving arm's.
    cfg = dataclasses.replace(cfg, model_kwargs=dict(cfg.model_kwargs,
                                                     fused_bidir=True))
    patches = ((gru_mod, "gru_scan_bidir_fwd", gru_mod.gru_scan_bidir_plain),
               (gru_mod, "gru_scan_bidir_bwd",
                gru_mod.gru_scan_bidir_bwd_plain), *ctc_patches)
    train_phase("7 train fused_bidir", cfg, TRAIN_U, (TRAIN_B, 64),
                dict(K7=LAYERS, K7b=LAYERS, K6=1, K6b=1), ("K7", "K7b"),
                patches, kernels, wrappers, card)


def capsnet_train_slice(kernels, wrappers, card) -> None:
    """Phase 8: config 4's train step through Trainer on the card
    (benchmarks/config4_capsnet.py:22-37: capsule1 with 48 classes, CTC,
    adamw 3e-4, warmup_steps=1, B=8 and 32 x 5 s, U=16).

    The weights are the seeded init with W_route scaled by CAPS_W_SCALE, as
    in the serving phase: at the init scale the routing is nearly flat
    (class capsules of length ~0.001), and the coupling would stay near
    uniform. A grad-norm within rtol 1e-4 of the plain path is mostly the
    convs' gradients, so the phase also prints W_route's share of it and
    holds W_route's gradient itself to the plain path's."""
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.models import capsnet as capsnet_mod
    from tpuasr_torch.ops import routing as routing_mod
    from tpuasr_torch.precision import full_fp32
    from tpuasr_torch.train import TrainConfig

    cfg = TrainConfig(model="capsule1", num_classes=CAPS_CLASSES,
                      warmup_steps=1)
    patches = ((capsnet_mod, "routed_caps", routing_mod.routed_caps_plain),
               (ctc_mod, "ctc_alphas_kernel", ctc_mod.ctc_alphas_plain),
               (ctc_mod, "ctc_betas_kernel", ctc_mod.ctc_betas_plain))

    def check(trainer, batch, fresh_state, got, plain_path):
        # The gradients of step 1 on both paths: W_route's share of the
        # grad-norm, and its gradient's error against the plain path's,
        # within 1e-4 of its largest magnitude (as the card test holds the
        # model's gradients): besides K8b's own error, K8's forward error
        # reaches dv through the logits (logit_scale 10) and the CTC loss.
        def grads(ctx):
            st = fresh_state()
            with full_fp32(), ctx:
                loss, _, _ = trainer._loss_fn(st.model,
                                              trainer._batch(batch), True)
                loss.backward()
            return st.model.W_route.grad

        gk = grads(contextlib.nullcontext())
        gp = grads(plain_path())
        norm = gk.norm().item()
        err = (gk - gp).abs().max().item() / gp.abs().max().item()
        phase(f"[8 capsnet train] step 1: W_route's gradient norm "
              f"{norm:.6f} = {norm / got['grad_norm']:.4f} of the "
              f"grad-norm; its max error against the plain path {err:.2e} "
              f"of its largest magnitude (tol 1e-4)")
        if not err <= 1e-4:
            fail("the CapsNet step's W_route gradient disagrees with the "
                 "plain path")

    train_phase("8 capsnet train", cfg, CAPS_TRAIN_U, CAPS_BATCHES,
                dict(K8=1, K8b=1, K6=1, K6b=1), ("K8b",), patches, kernels,
                wrappers, card,
                prepare=lambda model: model.W_route.mul_(CAPS_W_SCALE),
                check=check)


def main() -> int:
    # ---- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    phase(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase(card)

    sys.path.insert(0, str(ROOT))
    from tpuasr_torch import _build
    from tpuasr_torch.convert import save_npz, to_jax_variables
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.decode import prefix_beam as prefix_beam_mod
    from tpuasr_torch.features import FeatureConfig, fbank_power
    from tpuasr_torch.features import fused as fused_mod
    from tpuasr_torch.features.reference import feature_tables, num_frames
    from tpuasr_torch.lm import train_ngram
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.models import capsnet as capsnet_mod
    from tpuasr_torch.models import create_model
    from tpuasr_torch.models import layers as layers_mod
    from tpuasr_torch.ops import conv as conv_mod
    from tpuasr_torch.ops import gather as gather_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.ops import routing as routing_mod
    from tpuasr_torch.ops.quant import quantize_per_channel
    from tpuasr_torch.serve.offline import Recognizer

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    phase(f"[2 build] {time.perf_counter() - t0:.2f} s -> "
          f"{lib_path.relative_to(ROOT)}")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    kernels = {}

    # ---- 3. the bench decoding graph, then each kernel ---------------------
    tabs_g, g_secs = bench_graph()
    g_pack = torch.cat([torch.as_tensor(tabs_g.next_state),
                        torch.as_tensor(tabs_g.cost).view(torch.int32)],
                       1).to(dev).contiguous()
    phase(f"[3 graph] bench LG (200 words, word bigram, prune 10, quantum "
          f"0.1): graph_states {tabs_g.num_states}, built in {g_secs:.2f} s "
          f"(host clock, Python)")

    def record(key, name, source, replaces, err, ms=None, plain_ms=None,
               bound_ms=None, library_ms=None):
        k = kernels.setdefault(key, dict(name=name, route="cuda",
                                         source=source, replaces=replaces,
                                         launches=0, max_abs_err=0.0,
                                         ms=None, plain_ms=None,
                                         bound_ms=None, bound_by=None,
                                         library_ms=None))
        k["max_abs_err"] = max(k["max_abs_err"], float(err))
        if ms is not None:
            k["ms"], k["plain_ms"] = ms, plain_ms
        if bound_ms is not None:
            k["bound_ms"], k["bound_by"] = bound_ms
        if library_ms is not None:
            k["library_ms"] = library_ms

    # Kernels against their plain versions.
    # K1 / K1b: log-mel (after the log floor) within 1e-3, the JAX
    # featurizer parity tolerance (tests/test_features_pallas.py:36); the
    # kernel and the plain matmuls are both fp32, summed in other orders.
    for sr, nb, key in ((8000, B, "K1"), (16000, 32, None)):
        cfg = FeatureConfig(sample_rate=sr)
        tabs = feature_tables(cfg, dev)
        S = int(sr * SECONDS)
        T = num_frames(cfg, S)
        wav = (torch.randn(nb, S, generator=gen) * 0.1).to(dev)
        hop = cfg.hop_length
        got = fbank_power(wav, tabs, hop, T)
        ref = fused_mod.fbank_power_plain(wav, tabs, hop, T)
        err = (torch.log(got.clamp(min=cfg.log_floor))
               - torch.log(ref.clamp(min=cfg.log_floor))).abs().max().item()
        tol = 1e-3
        ms = cuda_ms(lambda: fbank_power(wav, tabs, hop, T), 20)
        pms = cuda_ms(lambda: fused_mod.fbank_power_plain(wav, tabs, hop, T),
                      5)
        phase(f"[3 K1{'' if key else 'b'}] fbank {sr} Hz B={nb} T={T} "
              f"win={cfg.win_length} hop={hop}: log-mel max_abs_err {err:.3e}"
              f" (tol {tol}) kernel {ms:.3f} ms plain {pms:.3f} ms")
        if not err <= tol:
            fail(f"fbank kernel disagrees at {sr} Hz: {err} > {tol}")
        nf, nm = tabs["cos"].shape[1], tabs["proj"].shape[1]
        flops = 2 * nb * T * (2 * cfg.win_length * nf + nf * nm)
        bd = bound(nbytes(wav, got, *tabs.values()), flops, "fp32")
        phase(f"[3 K1{'' if key else 'b'}] bound {bd[0]:.4f} ms ({bd[1]}); "
              "no single PyTorch call computes it")
        if key:
            record(key, "fbank_power", "tpuasr_torch/csrc/fbank.cu",
                   "tpuasr/features/pallas_fused.py:109", err, ms, pms, bd)

    # K2 / K4 at the served layer shapes. ys is bf16: one bf16 ulp is
    # 3.9e-3 near 1, and the kernel sums x@Wx and h@Wh in another order
    # than the plain matmuls, so a rounding can flip and ride the
    # recurrence for a few steps: tol 2e-2 (int8 sums are exact).
    T_out = -(-num_frames(FeatureConfig(), int(SR * SECONDS)) // 2)
    lens = torch.randint(T_out // 2, T_out + 1, (B,), generator=gen)
    lens[0] = T_out
    mask = (torch.arange(T_out)[:, None] < lens[None, :]).float()[:, :, None]
    mask = mask.to(dev).contiguous()
    gru_tol = 2e-2
    H = HIDDEN
    for D in (512, 1024):
        x = torch.randn(T_out, B, D, generator=gen).to(dev, torch.bfloat16)
        wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).to(dev)
        wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
        bias = (torch.randn(3 * H, generator=gen) * 0.1).to(dev)
        wxb, whb = wx.bfloat16(), wh.bfloat16()
        wxq, sw = quantize_per_channel(wx)
        whq, swh = quantize_per_channel(wh)
        cases = (
            ("K2", "bf16", gru_mod.gru_scan_xfused,
             gru_mod.gru_scan_xfused_plain, (x, wxb, bias, whb, mask), {}),
            ("K4", "int8", gru_mod.gru_scan_xfused_q8,
             gru_mod.gru_scan_xfused_q8_plain,
             (x, wxq, sw, bias, whb, mask), {}),
            ("K4", "int8+rec_q8", gru_mod.gru_scan_xfused_q8,
             gru_mod.gru_scan_xfused_q8_plain,
             (x, wxq, sw, bias, whq, mask), {"wh_scale": swh}),
        )
        for key, label, kern, plain, args, kw in cases:
            for rev in (False, True):
                got = kern(*args, reverse=rev, **kw)
                ref = plain(*args, reverse=rev, **kw)
                err = (got.float() - ref.float()).abs().max().item()
                timed = D == 1024 and not rev
                ms = pms = bd = lib = None
                if timed:
                    ms = cuda_ms(lambda: kern(*args, reverse=rev, **kw), 3)
                    pms = cuda_ms(lambda: plain(*args, reverse=rev, **kw), 1)
                    macs = T_out * B * (D + H) * 3 * H
                    bd = bound(nbytes(*[a for a in args if torch.is_tensor(a)],
                                      got),
                               2 * macs, "bf16" if key == "K2" else "int8")
                    lib = library_gru_ms(T_out, B, D, H, torch.bfloat16,
                                         False)
                phase(f"[3 {key}] gru {label} T={T_out} B={B} D={D} H={H} "
                      f"reverse={rev}: max_abs_err {err:.3e} (tol {gru_tol})"
                      + (f" kernel {ms:.3f} ms plain {pms:.3f} ms bound "
                         f"{bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU bf16 "
                         f"{lib:.3f} ms" if timed else ""))
                if not err <= gru_tol:
                    fail(f"{key} {label} D={D} reverse={rev}: {err}")
                if key == "K2":
                    record("K2", "gru_scan_xfused (bf16)",
                           "tpuasr_torch/csrc/gru_scan.cu",
                           "tpuasr/ops/pallas_gru.py:615", err, ms, pms, bd,
                           lib)
                else:   # times kept: the served int8 + rec_q8 arm
                    record("K4", "gru_scan_xfused_q8 (int8, rec_q8)",
                           "tpuasr_torch/csrc/gru_scan.cu",
                           "tpuasr/ops/pallas_gru.py:1020", err,
                           *((ms, pms, bd, lib) if label == "int8+rec_q8"
                             else ()))

    # K3 on identical log-probs: backpointers, final scores, tokens and
    # lengths must be exactly equal (same float ops in the same order).
    lp = torch.log_softmax(torch.randn(B, T_out, NUM_CLASSES, generator=gen)
                           * 2.0, dim=-1).to(dev).contiguous()
    blens = torch.randint(1, T_out + 1, (B,), generator=gen).to(torch.int32)
    blens[0], blens[1], blens[2] = T_out, 0, 1
    blens = blens.to(dev)
    bcfg = BeamSearchConfig(beam_width=BEAM, max_len=256)
    got = beam_mod.beam_scan(lp, blens, BEAM, 0, bcfg.max_len)
    ref = beam_mod.beam_scan_plain(lp, blens, BEAM, 0, bcfg.max_len)
    same_bp = torch.equal(got[0], ref[0])
    same_sc = torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    out_k = beam_mod.ctc_beam_search(lp, blens, bcfg)
    with mock.patch.object(beam_mod, "beam_scan", beam_mod.beam_scan_plain):
        out_p = beam_mod.ctc_beam_search(lp, blens, bcfg)
    same_tok = (torch.equal(out_k["tokens"], out_p["tokens"])
                and torch.equal(out_k["token_lens"], out_p["token_lens"]))
    ms = cuda_ms(lambda: beam_mod.beam_scan(lp, blens, BEAM, 0, 256), 5)
    pms = cuda_ms(lambda: beam_mod.beam_scan_plain(lp, blens, BEAM, 0, 256),
                  1)
    sc_err = (got[1] - ref[1]).abs().max().item()
    phase(f"[3 K3] beam B={B} T={T_out} C={NUM_CLASSES} K={BEAM}: "
          f"backpointers equal {same_bp}, final scores equal {same_sc}, "
          f"tokens+lengths equal {same_tok} (tol: exact) kernel {ms:.3f} ms"
          f" plain {pms:.3f} ms")
    if not (same_bp and same_sc and same_tok):
        fail("beam kernel disagrees with its plain version")
    # Operations: about 5 per (frame, beam, class) candidate (two
    # log-add-exps and a compare); bytes: log-probs in, backpointers and
    # final scores out.
    bd = bound(nbytes(lp, blens, *got), 5 * B * T_out * BEAM * NUM_CLASSES,
               "fp32")
    phase(f"[3 K3] bound {bd[0]:.4f} ms ({bd[1]}); no PyTorch call computes "
          "it")
    record("K3", "ctc_beam (no LM)", "tpuasr_torch/csrc/ctc_beam.cu",
           "tpuasr/decode/pallas_beam.py:455", sc_err, ms, pms, bd)

    # K3 with LM fusion and K10, on the graph built above.
    lms = {order: unit_lm(order) for order in (2, 3)}
    lm_graph_kernels(record, lp, blens, lms, g_pack)

    # K5 / K5b / K6 / K6b at the config-3 train step's shapes.
    train_kernels(record, gen)

    # K9, K7 and K7b at config 5's and config 3's shapes.
    conv_bidir_kernels(record, gen)

    # K8 and K8b at config 4's shapes.
    capsnet_kernels(record, gen)

    # ---- 4. the full slice through Recognizer ---------------------------------
    feat_cfg = FeatureConfig(sample_rate=SR, n_mels=64)
    arms = {
        "int8": dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                     int8_proj=True, int8_rec=True),
        "bf16": dict(pallas_gru=True, bf16_gru=True, fused_proj=True),
        # bench.py:92-98 with --int8-conv: conv2 as K9.
        "int8+int8_conv": dict(pallas_gru=True, bf16_gru=True,
                               fused_proj=True, int8_proj=True,
                               int8_rec=True, int8_conv=True),
        # A fused_bidir checkpoint served in bf16: K7 per layer.
        "bf16+fused_bidir": dict(pallas_gru=True, bf16_gru=True,
                                 fused_bidir=True),
    }
    base = dict(num_classes=NUM_CLASSES, rnn_hidden=HIDDEN,
                rnn_layers=LAYERS, in_features=feat_cfg.n_mels)
    model0 = create_model("deepspeech_ctc", **base, **arms["int8"],
                          generator=torch.Generator().manual_seed(SEED))
    state = model0.state_dict()
    S = int(SR * SECONDS)
    wav = (np.random.default_rng(SEED).standard_normal((B, S))
           * 0.1).astype(np.float32)
    wav_lens = np.full((B,), S, np.int32)
    wav_d = torch.as_tensor(wav, device=dev)
    lens_d = torch.as_tensor(wav_lens, device=dev)
    audio_s = float(wav_lens.sum()) / SR

    wrappers = {"K1": fused_mod.fbank_power,
                "K2": gru_mod.gru_scan_xfused,
                "K4": gru_mod.gru_scan_xfused_q8,
                "K9": conv_mod.conv_taps_q8,
                "K7": gru_mod.gru_scan_bidir_fwd,
                "K7b": gru_mod.gru_scan_bidir_bwd,
                "K3": beam_mod.beam_scan,
                "K10": gather_mod.gather_rows,
                "K8": routing_mod.routed_caps,
                "K8b": routing_mod.routed_caps_bwd,
                "K5": gru_mod.gru_scan_fwd,
                "K5b": gru_mod.gru_scan_bwd,
                "K6": ctc_mod.ctc_alphas_kernel,
                "K6b": ctc_mod.ctc_betas_kernel}
    serving = ("K1", "K2", "K4", "K9", "K7", "K3")
    plain_patches = (
        (fused_mod, "fbank_power", fused_mod.fbank_power_plain),
        (layers_mod, "gru_scan_xfused", gru_mod.gru_scan_xfused_plain),
        (layers_mod, "gru_scan_xfused_q8", gru_mod.gru_scan_xfused_q8_plain),
        (layers_mod, "conv_taps_q8", conv_mod.reference_q8_conv_taps),
        (gru_mod, "gru_scan_bidir_fwd", gru_mod.gru_scan_bidir_plain),
        (beam_mod, "beam_scan", beam_mod.beam_scan_plain),
        (prefix_beam_mod, "gather_rows", gather_mod.gather_rows_plain),
        (capsnet_mod, "routed_caps", routing_mod.routed_caps_plain),
    )

    @contextlib.contextmanager
    def plain_path():
        with contextlib.ExitStack() as stack:
            for mod, name, fn in plain_patches:
                stack.enter_context(mock.patch.object(mod, name, fn))
            yield

    recs = {}
    for arm, flags in arms.items():
        model = create_model("deepspeech_ctc", **base, **flags, device=dev)
        model.load_state_dict(fused_bidir_state(state)
                              if flags.get("fused_bidir") else state)
        recs[arm] = Recognizer(model, feat_cfg, bcfg, dev)

    # The counted run of the main path: every arm, one batch each; the
    # cuDNN convs (F.conv2d calls) are counted beside the kernels.
    for w in wrappers.values():
        w.launches = 0
    per_arm, outs, convs = {}, {}, {}
    conv2d = torch.nn.functional.conv2d

    def counted_conv2d(*a, **k):
        convs[arm] += 1
        return conv2d(*a, **k)

    for arm, rec in recs.items():
        before = {k: w.launches for k, w in wrappers.items()}
        convs[arm] = 0
        with mock.patch.object(torch.nn.functional, "conv2d",
                               counted_conv2d):
            outs[arm] = rec(wav_d, lens_d)
        torch.cuda.synchronize()
        per_arm[arm] = {k: w.launches - before[k] for k, w in wrappers.items()}
    launches = {k: w.launches for k, w in wrappers.items()}
    phase(f"[4 slice] launch counts per batch: {json.dumps(per_arm)}; "
          f"cuDNN conv calls per batch: {json.dumps(convs)}")
    none = {k: 0 for k in wrappers}
    want = {"int8": dict(none, K1=1, K4=2 * LAYERS, K3=1),
            "bf16": dict(none, K1=1, K2=2 * LAYERS, K3=1),
            "int8+int8_conv": dict(none, K1=1, K9=1, K4=2 * LAYERS, K3=1),
            "bf16+fused_bidir": dict(none, K1=1, K7=LAYERS, K3=1)}
    want_convs = {arm: 1 if arm == "int8+int8_conv" else 2 for arm in arms}
    if per_arm != want or convs != want_convs:
        fail(f"launch counts {per_arm} != {want} or cuDNN convs {convs} != "
             f"{want_convs}")
    for k in serving:
        n = launches[k]
        kernels[k]["launches"] = n
        if n == 0:
            fail(f"kernel {k} was not launched on the main path")

    # logp of the kernel path against the plain path: the bf16 stream
    # rounds at the same places in both, but a one-ulp difference in an
    # fp32 sum can flip a bf16 (or int8) rounding and move a log-prob by
    # ~1e-2 after four layers: tol 5e-2, end to end and for the AM alone on
    # identical features. Tokens: the kernel path's must equal the plain
    # beam's on the same log-probs (exact). The token error rate between the
    # two paths is reported: the random-weight model's posteriors are flat,
    # so those log-prob differences flip near-ties in the search; ter_tol
    # only catches a gross fault (a broken path decodes at a TER near 1).
    slice_tol = 5e-2
    ter_tol = 0.2
    for arm, rec in recs.items():
        out = outs[arm]
        logp, ol = out["log_probs"], out["out_lens"]
        if not bool(torch.isfinite(logp).all()):
            fail(f"{arm}: non-finite log-probs")
        if tuple(logp.shape) != (B, T_out, NUM_CLASSES):
            fail(f"{arm}: log-probs shape {tuple(logp.shape)}")
        before = sum(w.launches for w in wrappers.values())
        with torch.inference_mode():
            feats, flens = rec.featurizer.featurize(wav_d, lens_d)
        with plain_path(), torch.inference_mode():
            pout = rec(wav_d, lens_d)
            same_lp_dec = beam_mod.ctc_beam_search(logp, ol, bcfg)
            am_lp, _ = rec.model(feats, flens)
            am_dec = beam_mod.ctc_beam_search(am_lp, ol, bcfg)
        if sum(w.launches for w in wrappers.values()) != before + 1:
            fail("the plain path launched a kernel")
        err = (logp - pout["log_probs"]).abs().max().item()
        am_err = (logp - am_lp).abs().max().item()
        exact = (torch.equal(same_lp_dec["tokens"], out["tokens"])
                 and torch.equal(same_lp_dec["token_lens"],
                                 out["token_lens"]))
        ter, same_rows = token_error_rate(out, pout)
        am_ter, am_same = token_error_rate(out, am_dec)
        phase(f"[4 slice {arm}] logp max_abs_err vs plain path {err:.3e}, "
              f"AM alone on the same features {am_err:.3e} (tol "
              f"{slice_tol}); tokens == plain beam on the same logp: "
              f"{exact}; token error rate vs plain path {ter:.5f} "
              f"({same_rows}/{B} identical; tol {ter_tol}), vs plain AM + "
              f"beam on the same features {am_ter:.5f} ({am_same}/{B}); "
              f"out_lens equal {torch.equal(ol, pout['out_lens'])}; "
              f"mean tokens/utt "
              f"{out['token_lens'].float().mean().item():.1f}")
        if not (err <= slice_tol and am_err <= slice_tol and exact
                and ter <= ter_tol and torch.equal(ol, pout["out_lens"])):
            fail(f"{arm}: kernel path disagrees with the plain path")
        rt = cuda_ms(lambda: rec(wav_d, lens_d), 5)
        with plain_path():
            prt = cuda_ms(lambda: rec(wav_d, lens_d), 2)
        phase(f"[4 slice {arm}] B={B} x {SECONDS:.0f} s ({audio_s:.0f} s of "
              f"audio): kernel path {rt:.2f} ms = "
              f"{audio_s / (rt / 1e3):.1f}x real time; plain path "
              f"{prt:.2f} ms = {audio_s / (prt / 1e3):.1f}x real time "
              f"[{card}]")
        phase(f"[4 slice {arm}] device time of one batch by kernel "
              f"(torch.profiler): {device_breakdown(lambda: rec(wav_d, lens_d))}")

    # The conv frontend alone (both convs, their norms and ReLUs) on the
    # same features: cuDNN fp32 against conv1 in cuDNN and conv2 as K9.
    with torch.inference_mode():
        feats, flens = recs["int8"].featurizer.featurize(wav_d, lens_d)
        fe = {arm: cuda_ms(lambda: recs[arm].model.conv_frontend(
            feats, flens), 10) for arm in ("int8", "int8+int8_conv")}
    phase(f"[4 slice] conv frontend B={B}: int8 arm {fe['int8']:.3f} ms "
          f"(cuDNN fp32, TF32 off), int8+int8_conv arm "
          f"{fe['int8+int8_conv']:.3f} ms (conv2 as K9) (CUDA events, mean "
          f"of 10) [{card}]")
    # The two int8 arms' batches in turns, so that drift between them
    # does not read as a difference.
    turns = {"int8": [], "int8+int8_conv": []}
    for arm in ("int8", "int8+int8_conv", "int8+int8_conv", "int8"):
        turns[arm].append(cuda_ms(lambda: recs[arm](wav_d, lens_d), 5))
    phase(f"[4 slice] in turns (int8, int8+int8_conv, int8+int8_conv, "
          f"int8; mean of 5 each): int8 arm "
          f"{', '.join(f'{v:.2f}' for v in turns['int8'])} ms, "
          f"int8+int8_conv arm "
          f"{', '.join(f'{v:.2f}' for v in turns['int8+int8_conv'])} ms a "
          f"batch [{card}]")

    # The CapsNet arm (config 4).
    capsnet_slice(kernels, wrappers, card, plain_path)

    # ---- 5. the LM and graph serving arms --------------------------------
    lm_graph_slice(kernels, wrappers, recs["int8"].model, feat_cfg, wav_d,
                   lens_d, tabs_g, lms, plain_path, card, audio_s, T_out)

    # ---- 6. requests through the CLI --------------------------------------
    from scipy.io import wavfile
    from tpuasr_torch.cli import predict

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        meta = dict(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                    model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                      **arms["int8"]))
        save_npz(to_jax_variables(state), tmp / "w.npz", meta=meta)
        (tmp / "units.txt").write_text(
            "\n".join(["<blank>"] + [f"p{i}" for i in range(1, NUM_CLASSES)]))
        rng = np.random.default_rng(SEED + 1)
        paths = []
        for i, sec in enumerate((2.0, 3.5, 5.0)):
            p = tmp / f"req{i}.wav"
            wavfile.write(p, SR, (rng.standard_normal(int(SR * sec))
                                  * 3000).astype(np.int16))
            paths.append(str(p))
        # A unit LM as ARPA, and the bench lexicon (unit names) with its
        # word bigram for the graph.
        lms[2].save_arpa(tmp / "units.arpa")
        prons, sents = bench_lexicon()
        (tmp / "words.txt").write_text(
            "".join(f"{w} {i}\n" for i, (w, _) in enumerate(prons)))
        (tmp / "lexicon.txt").write_text("".join(
            f"{w} {' '.join(UNITS[u] for u in pr)}\n" for w, pr in prons))
        train_ngram(sents, order=2).save_arpa(tmp / "words.arpa")
        # Config 4's CapsNet (48 units) for the capsule1 request.
        save_npz(to_jax_variables(capsnet_model("cpu").state_dict()),
                 tmp / "caps.npz",
                 meta=dict(model="capsule1", num_classes=CAPS_CLASSES))
        (tmp / "caps_units.txt").write_text("\n".join(CAPS_UNITS))
        ds = ["deepspeech_ctc", *paths, "--weights", str(tmp / "w.npz"),
              "--units", str(tmp / "units.txt")]
        requests = {
            "beam": [*ds, "--beam"],
            "beam+lm-fusion": [*ds, "--beam", "--lm",
                               str(tmp / "units.arpa"), "--lm-fusion",
                               "--lm-weight", str(LM_WEIGHT)],
            "graph-decode": [*ds, "--graph-decode", "--lexicon",
                             str(tmp / "lexicon.txt"), "--words",
                             str(tmp / "words.txt"), "--lm",
                             str(tmp / "words.arpa")],
            "capsule1 beam": ["capsule1", *paths, "--weights",
                              str(tmp / "caps.npz"), "--units",
                              str(tmp / "caps_units.txt"), "--beam"],
        }
        for name, argv in requests.items():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = predict.main([*argv, "--beam-width", str(BEAM),
                                   "--device", "cuda"])
            lines = [ln for ln in buf.getvalue().strip().splitlines()
                     if not ln.startswith("#")]
            phase(f"[6 cli {name}] predict rc={rc}, {len(lines)} transcripts "
                  f"in {time.perf_counter() - t0:.2f} s (host clock, load "
                  "included)")
            if rc != 0 or len(lines) != len(paths) or not all(
                    ln.startswith(p + "\t") for ln, p in zip(lines, paths)):
                fail(f"predict {name} output: {lines}")
            for ln in lines:
                words = ln.split(chr(9))[1].split()
                unit = "w" if name == "graph-decode" else "p"
                if not all(t.startswith(unit) for t in words):
                    fail(f"predict {name}: unexpected symbols in {ln!r}")
                phase(f"    {Path(ln.split(chr(9))[0]).name}: "
                      f"{len(words)} {'words' if unit == 'w' else 'tokens'}")

    # ---- 7. the training slice through Trainer.train_step ---------------------
    train_slice(kernels, wrappers, card)

    # ---- 8. the CapsNet training step through Trainer.train_step ----------
    capsnet_train_slice(kernels, wrappers, card)

    order = ("K1", "K2", "K4", "K9", "K7", "K3", "K3-LM", "K10", "K8", "K8b",
             "K5", "K5b", "K7b", "K6", "K6b")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
