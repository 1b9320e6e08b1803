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
     same function, that call's time: the serving kernels K1 (and K1b, the
     same kernel at 16 kHz, B=32: its plan, two calls bit for bit, the
     cuFFT pipeline's time beside it, and once a tone with noise 90 dB
     below it), K2, K4, K3 (without and with bigram/trigram LM fusion;
     with the backtrack kernel of its packed backpointers, and the
     search's wall time against its device time), K10 (the scan-search
     kernel: the graph-constrained search's whole frame loop with its row
     fetch inside, at class_topk 8 and 63, every state field against the
     plain loop, and its SM cycles a frame by part), K10-rebuild (the
     prefix rebuild from its backpointers) and K10-gather (the standalone
     row gather) at the shapes of the served model (B=128 utterances of 10 s
     at 8 kHz, C=64, a 512 x 4 BiGRU, beam K=8; K2/K4 also on ragged
     batches of 1 and 129 rows, with the projection and the recurrence
     of one call timed apart), K2 in float32 at the deepspeech_var train step's
     forward shapes (H=384, D=512 and 768, B=16 and 64), K9 (the int8
     conv2) at its shapes in that model beside the bf16 and fp32
     F.conv2d, K7 (both GRU directions in one launch) at the served
     shape in bf16 and K7-f32 (its float32 recurrence) at every batch the
     fused_bidir train step runs (B=16, 64, 128 at T'=249) and at the
     served shape, with its plan, beside cuDNN, and at H=640 and H=1056
     (widths its old kernel refused), and the training kernels K5, K5b,
     K7b, K6, K6b at the shapes of the BASELINE config-3 train step (B=16
     x 5 s, T'=249, U=24; K5b also at B=64, K7b at B=64 and 128, the
     batches the train phases run, each beside cuDNN; K6 and K6b, the CTC
     loss's forward and backward, on edge cases, at B=16 and 64, at config
     4's B=8 and at S=1023, with the device launches of one loss forward
     and backward), K5's forward (the
     f32 recurrence of csrc/gru_bidir.cu at one direction, which K2's f32
     recurrence also runs) at H=512 and 384, B=16 and 64, both scan senses,
     and once at H=640 and 1056, K2b
     (the fused-projection scan's backward) at the deepspeech_var step's
     shapes (H=384, D=512 and 768; timed at B=16 and 64 beside cuDNN and
     the recompute route), K2b's, K5b's and K7b's three phases (pre-scan
     products, lean recurrence, post-scan products) timed apart, K5b, K7b
     and K2b once each at the shapes their old kernels refused (B=683 at
     H=512, H=640, B=146 at D=320 and H=512, B=609 at D=768), K9's taps
     and slab bodies beside its im2col body, and K8 and
     K8b (CapsNet routing, forward and backward) at the shapes of BASELINE
     config 4 (B=8 and B=32 x 5 s, T'=249, I=256, Din=8, O=48, D=16, 3
     iterations): K8 with its launch plan, the clusters the card holds at
     once and the cost of its saving mode (V and s for the backward), two
     calls the same bits; K8b from the saved V and s (the train step's
     route) and standalone from (u, W, dv), the two bit for bit the same,
     two calls the same bits; then BASELINE config 1: K1's MFCC route
     (FusedFeaturizer(mfcc), made with no device, at B=128 x 10 s and
     B=1) against the plain Featurizer(mfcc) on the card (the log-mel
     within 1e-3, the MFCC within sqrt(64) x 1e-3), two calls bit for bit,
     K1 at B=1 timed beside its plain version, and the plain Featurizer
     with torch framing (fbank and MFCC) against a float64 numpy/scipy
     reference of config 1's frames;
  4. the serving slice through Recognizer: the int8 arm (the default), the
     bf16 arm, the int8 arm with conv2 as K9 (int8_conv, bench.py's
     --int8-conv; once with each of K9's three bodies, chosen by
     TPUASR_CONV_Q8_MODE) and the bf16 arm of a fused_bidir model (K7), with
     launch counts (and cuDNN conv calls), agreement with the plain path,
     and x-real-time of the kernel path and of the plain path, and the conv
     frontend's time with and without K9; then the CapsNet arm (config 4's
     model, 48 classes), greedy and with the beam, at B=8 and B=32 x 5 s
     and on a ragged B=8 batch, with the same checks and its device time
     by kernel; then the ResNet-CTC arm (config 2: the preset's model, 64
     classes, greedy, and with the beam), at B=128 x 10 s and on a ragged
     B=128 batch, with launch counts and cuDNN conv calls, agreement with
     the plain path, x-real-time, wall against device time, device time by
     kernel, and the conv stack's time against its float32 bound;
  5. the LM and graph serving arms through Recognizer: the int8 arm with
     bigram fusion, and the graph-constrained search at class_topk 8 and
     63 (one K10 and one K10-rebuild launch a batch), with launch counts,
     agreement with the plain path, x-real-time, and a graph batch's wall
     time against its device time;
  6. a few requests through tpuasr_torch.cli.predict on wav files it
     writes: beam, beam with LM fusion, and graph decoding, one
     `predict capsule1` beam request and one `predict resnet_ctc`; then
     tpuasr_torch.cli.test resnet_ctc over a manifest of 8 written wavs
     with transcripts, greedy and with the beam, its WER against
     utils.metrics.wer over Recognizer's hypotheses;
  7. the training slice through Trainer.train_step (config 3: the 512 x 4
     DeepSpeechCTC in float32, adamw, B=16 x 5 s, U=24): launch counts per
     step, step 1 against the plain path, the loss after 10 steps on the
     repeated batch, and train-step ms at B=16 and B=64; then the same
     step with fused_bidir=True (K7 in f32 and K7b in place of K5 and
     K5b), also at B=128;
  8. the CapsNet training step through Trainer.train_step (config 4:
     capsule1 with 48 classes, CTC, adamw 3e-4, B=8 x 5 s, U=16): launch
     counts per step, step 1 against the plain path, the loss after 10
     steps on the repeated batch, and train-step ms at B=8 and B=32;
  9. the deepspeech_var preset's train step (384 x 6, adamw 3e-4, clip 5,
     with the Pallas GRU and the fused projection) through Trainer at
     config 3's batch: K2 and K2b in every GRU direction, with the same
     checks and timings as phase 7; then the same step with the backward
     forced to the recompute route (K5b between matmuls);
 10. config 2's model trained through Trainer (the ResNet-CTC preset in
     float32, adamw 5e-4, clip 5, B=16 x 5 s, U=24): K6 and K6b once a
     step, the checks and timings of phase 7, then once with dither=1.0
     (two steps from one seed the same bits; the loss not the undithered
     one);
 11. the training loop: ``python -m tpuasr_torch.cli.batch_train
     deepspeech_ctc --preset`` run in this process on a synthetic corpus of
     64 utterances (8 of them the dev set), at config 3's width and batch
     with the fused featurizer, SpecAugment, accumulation over 2
     micro-batches and the device-resident corpus, 2 epochs: K1, K5, K5b,
     K6 and K6b launched; the store on the card; the logged losses finite
     and falling; train and dev rows in metrics.csv; the checkpoints that
     keep=5 leaves, each optimizer state in optax's layout; a second
     straight run against the first, and a run of one epoch resumed for
     the second against the first, each bit for bit with
     ``torch.backends.cudnn.deterministic`` unset (the convs' backward
     takes cuDNN's deterministic algorithms itself);
     ``tpuasr_torch.cli.test --checkpoint`` against ``Trainer.evaluate``'s
     greedy tokens; and, on 56 utterances of 5-15 s (config 3's lengths),
     the epoch loop's ms a step, utterances a second and the device's idle
     share, from the device corpus, and streamed with prefetch 2 and 0;
 12. streaming, config 6 (benchmarks/config6_streaming.py): the 512 x 4
     unidirectional explicit-pad DeepSpeechCTC, 64 classes, 8 kHz, 64
     mels, no CMVN. K5 from a carried state h0 (T'=5, B=64 and T'=249,
     B=16) against its plain version and a chunked run against one run,
     timed with its bound; one 10 s utterance through StreamingRecognizer
     in 100 ms chunks, greedy and with the beam, its tokens equal to the
     offline greedy decode and the one-shot scan search on the card, its
     log-probs within STREAM_TOL of the offline model's; 64 sessions
     through BatchedStreamingRecognizer (JAX's measure(): 2 warm-up ticks,
     30 timed), greedy and beam: the tick's median and p95, the real-time
     margin and the streams a card holds, launches a tick (K1, K5, K10,
     K10-rebuild, cuDNN conv calls), one tick's kernels against their
     plain versions on its own inputs from the carried state (K1, K5 from
     each layer's h0, the log-probs against the plain path's tick, K10 and
     its rebuild from the resumed beam), the device's idle share and time
     by kernel, every slot against a solo stream; one ``python -m
     tpuasr_torch.cli.stream --beam --timestamps`` request;
 13. bf16 training, config 3's bf16 points (benchmarks/
     config3_deepspeech_train.py:40-45, :82-83): bf16_compute with the
     TPU's pallas_gru, bf16_gru and bf16_conv on the 512 x 4
     DeepSpeechCTC, adamw, B=64 and 128 x 5 s, U=24, through Trainer:
     K5-bf16 and K5b-bf16 in every direction, K6 and K6b once a step,
     step 1 against the plain path (BF16_STEP_TOL), the loss over 10
     steps, and the B=64 step beside phase 7's f32 one with the device
     time by kernel of both; then fused_bidir with bf16_gru at B=16 (K7
     and K7b-bf16), and the deepspeech_var preset with fused_proj and
     bf16_gru at B=16 (K2 in bf16 and K2b-bf16), once more with the
     backward forced to the recompute route (K5b-bf16 on the rounded xp).
     Phase 3 holds K5-bf16, K5b-bf16, K7b-bf16 (T'=249, H=512, B=16 and
     64) and K2b-bf16 (deepspeech_var's D=512 and 768, H=384, B=16)
     against their plain versions, timed beside their bound and
     torch.nn.GRU in bf16 (K5b-, K7b- and K2b-bf16's phases timed apart),
     and tells the lean recurrence's rounding of dhp apart from none
     (``lean_round_control``);
 14. the host first pass over the bench LG (native/wfst_decode.cc and
     native/wfst_lattice.cc, built at first use by
     tpuasr_torch/native/build.py) on config 5's int8 arm: the arm's batch
     with K3 and the graph arm's search on its log-probs counted, the
     log-probs copied to the host once; wfst_ctc_decode on all 128
     utterances by the host clock with its thread count; against the
     Python versions (impl="py", in worker processes) the 1-best on 4
     utterances, the n-best (3) and the lattice on 2 (and the n-best cut
     to 2 s); the share of 1-best words equal to the graph arm's; the host
     beam search (native/ctc_host.cc) against K3; align_confidence and
     beam_posterior on the card against the CPU; and three CLI requests on
     phase 6's setting (predict --fst-decode with n-best, confidences,
     lattices and word times; predict --beam --confidence --align
     --dump-loglikes; cli.test --fst-decode --align --write-segments
     --dump-loglikes), whose Kaldi archives must equal the phase's
     log-probs and alignments bit for bit.

Weights are random, made from a seed. The line before the last holds
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Without
a CUDA device, or if any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import shutil
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
# Config 2 (benchmarks/config2_resnet_infer.py:24-31): ResNet-CTC at its
# preset (utils/params.py's "resnet_ctc"), 64 classes, 64 mels, greedy,
# B=128 x 10 s; trained at config 3's batch (B=16 x 5 s, U=24) with the
# preset's adamw 5e-4, clip 5. RESNET_TOL bounds the arm's log-probs
# against the plain path, whose only difference is K1's split-TF32 rounding
# of the power spectrum (its log-mel gate is 1e-3): the model runs float32
# end to end, with no bf16 or int8 rounding to flip as in the DeepSpeech
# arms (5e-2). Measured 2.6e-5 at B=128 on an H100 80GB HBM3 at 700 W:
# 1e-3 leaves 38x.
RESNET_TOL = 1e-3
# Published H100 SXM peaks: HBM bytes/s and dense operations/s by type.
HBM_BPS = 3.35e12
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}


def bound_mixed(nbytes: float, ops: dict) -> tuple[float, str]:
    """The least time (ms) for moving nbytes and doing the operations of
    ops, which maps a type to its count, each type at its own peak, one
    after the other; and which of the two bounds it."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """``bound_mixed`` for work of one type."""
    return bound_mixed(nbytes, {kind: ops})


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
    states. -> (GraphTables, the composed LG as a WFST, seconds on the
    host)."""
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
    return tabs, lg, time.perf_counter() - t0


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

    # K10's standalone gather (JAX's public gather_rows; no serving path
    # launches it since the scan-search kernel fetches its rows itself) on
    # the bench-scale packed table, B*K = 1,024 indices with some past
    # either end (clamped): exact.
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
    phase(f"[3 K10-gather] gather_rows table ({S}, {W}) int32 "
          f"({S * W * 4 / 2 ** 20:.1f} MiB), {idx.numel()} indices "
          f"({rows} distinct rows, 4 out of range): equal {exact} (tol: "
          f"exact) kernel {ms * 1e3:.2f} us (L2 warm), {ms_cold * 1e3:.2f} "
          f"us (L2 flushed), {host_ms * 1e3:.2f} us per call back to back "
          f"from Python (host-bound) plain {pms * 1e3:.2f} us bound "
          f"{bd[0] * 1e3:.3f} us ({bd[1]}) torch.index_select "
          f"{lib * 1e3:.2f} us")
    if not exact:
        fail("gather_rows disagrees with its plain version")
    record("K10-gather", "gather_rows (int32 graph rows, standalone)",
           "tpuasr_torch/csrc/gather_rows.cu",
           "tpuasr/ops/pallas_gather.py:82", 0.0, ms, pms, bd, lib)


def scan_kernels(record, lp, blens, g_pack, start) -> None:
    """Phase 3 for K10, the scan-search kernel (the scan search's whole
    frame loop with the graph row fetch inside), and its prefix rebuild, at
    the served shapes (B=128, T'=499, C=64, K=8) on the bench LG, at
    class_topk 8 and 63, against the plain versions on the same inputs."""
    from tpuasr_torch.decode import BeamSearchConfig, beam_init_state
    from tpuasr_torch.decode import prefix_beam as pbm
    from tpuasr_torch.ops.gather import gather_rows_plain

    Bk, T, C = lp.shape
    dev = lp.device
    L = 256
    # The rows this run's search needs: the distinct graph states its
    # beams visit (counted from the plain version's fetches).
    visited = set()

    def counting_gather(table, idx):
        visited.update(torch.unique(idx).tolist())
        return gather_rows_plain(table, idx)

    for P in (NUM_CLASSES - 1, 8):
        cfg = BeamSearchConfig(beam_width=BEAM, class_topk=P, max_len=L)
        state = dict(beam_init_state(Bk, cfg, dev),
                     last2=torch.full((Bk, BEAM), -1, dtype=torch.int32,
                                      device=dev),
                     gs=torch.full((Bk, BEAM), start, dtype=torch.int32,
                                   device=dev),
                     gc=torch.zeros((Bk, BEAM), device=dev))
        args = (lp, blens, state, BEAM, P, 0, L, None, 0, 0.0, g_pack, 1.0)
        frames = max(int(blens.clamp(0, T).sum()), 1)
        pbm.scan_search.launches = 0
        got_bp, got = pbm.scan_search(*args)
        if pbm.scan_search.launches != 1:
            fail("scan_search did not launch its kernel once")
        # The reference, with the rows counted (untimed); then the plain
        # version's time without the counting, after a warm-up call.
        visited.clear()
        with mock.patch.object(pbm, "gather_rows_plain", counting_gather):
            ref_bp, ref = pbm.scan_search_plain(*args)
        rows = len(visited)
        pms = cuda_ms(lambda: pbm.scan_search_plain(*args), 1)
        ints = ("plen", "last", "last2", "h1", "h2", "gs")
        floats = ("p_b", "p_nb", "lm", "gc")
        same = {n: torch.equal(got[n], ref[n]) for n in ints}
        same["backpointers"] = torch.equal(got_bp, ref_bp)
        errs = {n: (got[n] - ref[n]).abs().max().item() for n in floats}
        err = max(errs.values())
        ms = cuda_ms(lambda: pbm.scan_search(*args), 5)
        clocks = torch.zeros((Bk, len(pbm.CLOCK_PARTS)), dtype=torch.int64,
                             device=dev)
        pbm.scan_search(*args, clocks=clocks)
        per = clocks.sum(0).double().cpu() / frames
        parts = ", ".join(f"{n} {v:.0f}" for n, v in
                          zip(pbm.CLOCK_PARTS, per.tolist()))
        # Over the frames within each length only (the kernel neither reads
        # nor ranks the rest): bytes, those frames' log-probs, the lengths,
        # each needed graph row once, the state in and out, and all T
        # frames' backpointers out; operations, per such frame and beam a
        # key per class (2) and per extend about 10 for its score plus 2
        # per beam for the join.
        state_bytes = 2 * 10 * 4 * Bk * BEAM
        bd = bound(frames * C * 4 + nbytes(blens, got_bp) + rows * 2 * C * 4
                   + state_bytes,
                   frames * BEAM * (2 * C + P * (10 + 2 * BEAM)), "fp32")
        phase(f"[3 K10] scan_search B={Bk} T={T} C={C} K={BEAM} P={P} on "
              f"the bench LG ({g_pack.shape[0]} states; {rows} rows "
              f"visited): equal (tol: exact) "
              f"{json.dumps(same)}; max_abs_err (tol 1e-4) "
              f"{json.dumps({n: float(f'{v:.3e}') for n, v in errs.items()})}"
              f" kernel {ms:.4f} ms ({ms / T * 1e3:.2f} us a frame) plain "
              f"{pms:.3f} ms bound {bd[0]:.5f} ms ({bd[1]}); no PyTorch call "
              f"computes it; SM cycles a frame (thread 0): {parts}")
        if not (all(same.values()) and err <= 1e-4):
            fail(f"the scan-search kernel disagrees with its plain version "
                 f"at P={P}")
        record("K10", "scan_search (the scan search's frame loop, with the "
               "graph row fetch inside)", "tpuasr_torch/csrc/scan_beam.cu",
               "tpuasr/ops/pallas_gather.py:82", err, ms, pms, bd)

    # The rebuild of the prefixes from the backpointers, from an empty
    # prefix and from a resumed one (the first call's prefixes and lengths,
    # a max_len that cuts rows): prefixes and root lanes exact.
    base = torch.full((Bk, BEAM, L), -1, dtype=torch.int32, device=dev)
    rb_same = True
    for b0, bl, cap in ((base, state["plen"], L),
                        (pbm.rebuild_prefixes(got_bp, base, state["plen"],
                                              L)[0][:, :, :40].contiguous(),
                         got["plen"].clamp(max=40), 40)):
        pbm.rebuild_prefixes.launches = 0
        kp = pbm.rebuild_prefixes(got_bp, b0, bl, cap)
        if pbm.rebuild_prefixes.launches != 1:
            fail("rebuild_prefixes did not launch its kernel once")
        pp = pbm.rebuild_prefixes_plain(got_bp, b0, bl, cap)
        rb_same &= all(torch.equal(a, r) for a, r in zip(kp, pp))
    rb_ms = queued_ms(lambda: pbm.rebuild_prefixes(got_bp, base,
                                                   state["plen"], L), 20)
    rb_pms = cuda_ms(lambda: pbm.rebuild_prefixes_plain(got_bp, base,
                                                        state["plen"], L), 2)
    # Bytes: one backpointer a frame for each lane's walk, the base rows
    # and lengths in, the prefixes and roots out.
    rb_bd = bound(4 * (Bk * BEAM * T + 2 * Bk * BEAM * L + 3 * Bk * BEAM), 0,
                  "fp32")
    phase(f"[3 K10-rebuild] rebuild_prefixes B={Bk} T={T} K={BEAM} "
          f"max_len={L}: prefixes+roots equal rebuild_prefixes_plain "
          f"{rb_same} (empty base; resumed base capped at 40) (tol: exact) "
          f"kernel {rb_ms:.4f} ms plain {rb_pms:.3f} ms bound "
          f"{rb_bd[0]:.5f} ms ({rb_bd[1]}); no PyTorch call computes it")
    if not rb_same:
        fail("the rebuild kernel disagrees with rebuild_prefixes_plain")
    record("K10-rebuild", "rebuild_prefixes (the scan search's prefix "
           "rebuild)", "tpuasr_torch/csrc/ctc_beam.cu",
           "tpuasr/decode/prefix_beam.py:431", 0.0, rb_ms, rb_pms, rb_bd)


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
    # A graph arm's batch: one scan-search launch for all frames and one
    # rebuild, no standalone gather.
    want = {arm: dict(none, K1=1, K4=2 * LAYERS,
                      **({"K3": 1, "K3-backtrack": 1} if arm == "int8+bigram"
                         else {"K10": 1, "K10-rebuild": 1})) for arm in recs}
    if per_arm != want:
        fail(f"LM/graph launch counts {per_arm} != {want}")
    kernels["K3-LM"]["launches"] = per_arm["int8+bigram"]["K3"]
    for k in ("K10", "K10-rebuild", "K10-gather"):
        kernels[k]["launches"] = sum(c[k] for c in per_arm.values())

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
        # A batch's wall time: host clock around synchronised calls.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            rec(wav_d, lens_d)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        with plain_path():
            prt = cuda_ms(lambda: rec(wav_d, lens_d), 1)
        phase(f"[5 {arm}] B={B} x {SECONDS:.0f} s ({audio_s:.0f} s of "
              f"audio): kernel path {rt:.2f} ms = "
              f"{audio_s / (rt / 1e3):.1f}x real time, wall {wall:.2f} ms a "
              f"batch (host clock); plain path "
              f"{prt:.2f} ms = {audio_s / (prt / 1e3):.1f}x real time "
              f"[{card}]")
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
    """'void (anonymous namespace)::gru_rec_kernel<...>(...)' ->
    'gru_rec_kernel'."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    return key.split("<")[0].split("(")[0].split("::")[-1][:48]


def device_rows(prof) -> list:
    """The rows of a torch.profiler session's sums by name that are device
    work (kernels, copies, fills). Host-side ranges (aten ops, autograd
    nodes such as _GRUScanBackward, a schedule's ProfilerStep spans) also
    carry the device time of the kernels they launched, and CUPTI's own
    module loading and buffer requests show up as rows with device time:
    all are left out, so that each kernel counts once."""
    return [e for e in prof.key_averages()
            if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "_", "autograd::",
                                      "ProfilerStep"))
            and "Loading" not in e.key and "Buffer Request" not in e.key]


def device_breakdown(fn, top: int = 6) -> str:
    """The largest device self times of one call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in device_rows(prof)]
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    parts = [f"{us / 1e3:.3f} ms x{n} {kernel_name(name)}"
             for us, n, name in rows[:top]]
    return (f"total {total / 1e3:.3f} ms in {sum(r[1] for r in rows)} "
            "launches; " + "; ".join(parts))


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


# The token error rate a serving arm may show against its plain path. The
# random-weight models' posteriors are flat, so ulp differences between the
# two paths flip near-ties in the search; this only catches a gross fault
# (a broken path decodes at a TER near 1).
TER_TOL = 0.2


def check_serving_arm(tag, rec, out, wav_d, lens_d, T_out, wrappers,
                      plain_path, card, tol, am_tol, top=6, timed=True,
                      plain_timed=True):
    """A serving arm's counted batch ``out`` (of ``rec`` on wav_d, lens_d)
    against the plain path (``plain_path``: every kernel's plain version):
    finite log-probs of shape (B, T_out, C); the features against K1's
    plain version; the log-probs against the whole plain path within
    ``tol`` and against the AM alone on the same features within
    ``am_tol``; out_lens equal; with a beam, the tokens equal to the plain
    beam's on the same log-probs; the token error rate against the plain
    path (at most TER_TOL) and against the plain AM decoded on the same
    features. With ``timed``: the batch's time by CUDA events and by the
    host clock, the device time by kernel (``top`` rows) and, with
    ``plain_timed``, the plain path's time."""
    from tpuasr_torch.decode import beam as beam_mod
    from tpuasr_torch.decode import greedy_decode

    bcfg = rec.beam_cfg
    logp, ol = out["log_probs"], out["out_lens"]
    if not (bool(torch.isfinite(logp).all())
            and tuple(logp.shape) == (B, T_out, NUM_CLASSES)):
        fail(f"{tag}: non-finite log-probs or shape {tuple(logp.shape)}")
    before = sum(w.launches for w in wrappers.values())
    with torch.inference_mode():
        feats, flens = rec.featurizer.featurize(wav_d, lens_d)
    with plain_path(), torch.inference_mode():
        pout = rec(wav_d, lens_d)
        pfeats, _ = rec.featurizer.featurize(wav_d, lens_d)
        am_lp, am_ol = rec.model(feats, flens)
        if bcfg is None:
            toks, n = greedy_decode(am_lp, am_ol)
            am_dec = dict(tokens=toks[:, None], token_lens=n[:, None])
        else:
            same = beam_mod.ctc_beam_search(logp, ol, bcfg)
            # The plain search is deterministic: on the same bits it
            # decodes the same tokens, so it runs again only where the
            # AM's log-probs differ.
            am_dec = (same if torch.equal(am_lp, logp)
                      else beam_mod.ctc_beam_search(am_lp, ol, bcfg))
    if sum(w.launches for w in wrappers.values()) != before + 1:
        fail(f"{tag}: the plain path launched a kernel")
    err = (logp - pout["log_probs"]).abs().max().item()
    am_err = (logp - am_lp).abs().max().item()
    f_err = (feats - pfeats).abs().max().item()
    lens_ok = torch.equal(ol, pout["out_lens"]) and torch.equal(ol, am_ol)
    exact = bcfg is None or all(torch.equal(same[k], out[k])
                                for k in ("tokens", "token_lens"))
    ter, same_rows = token_error_rate(out, pout)
    am_ter, am_same = token_error_rate(out, am_dec)
    phase(f"[{tag}] features max_abs_err vs plain {f_err:.3e}; logp "
          f"max_abs_err vs the whole plain path {err:.3e} (tol {tol}), vs "
          f"the AM alone on the same features {am_err:.3e} (tol {am_tol}); "
          f"out_lens equal {lens_ok}"
          + (f"; tokens == plain beam on the same logp: {exact}"
             if bcfg is not None else "")
          + f"; token error rate vs plain path {ter:.5f} ({same_rows}/{B} "
          f"identical; tol {TER_TOL}), vs the plain AM decoded on the same "
          f"features {am_ter:.5f} ({am_same}/{B}); mean tokens/utt "
          f"{out['token_lens'].float().mean().item():.1f}")
    if not (err <= tol and am_err <= am_tol and lens_ok and exact
            and ter <= TER_TOL):
        fail(f"{tag}: kernel path disagrees with the plain path")
    if not timed:
        return
    audio_s = float(lens_d.sum()) / SR
    rt = cuda_ms(lambda: rec(wav_d, lens_d), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        rec(wav_d, lens_d)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    plain = ""
    if plain_timed:
        with plain_path():       # warmed up by the check above
            prt = cuda_ms(lambda: rec(wav_d, lens_d), 1, warmup=0)
        plain = (f"; plain path {prt:.3f} ms = "
                 f"{audio_s / (prt / 1e3):.1f}x real time")
    phase(f"[{tag}] B={B} x {SECONDS:.0f} s ({audio_s:.0f} s of audio): "
          f"kernel path {rt:.3f} ms a batch (CUDA events, mean of 5 after a "
          f"warm-up) = {audio_s / (rt / 1e3):.1f}x real time; wall "
          f"{wall:.3f} ms a batch (host clock, mean of 3){plain} [{card}]")
    phase(f"[{tag}] device time of one batch by kernel (torch.profiler): "
          f"{device_breakdown(lambda: rec(wav_d, lens_d), top=top)}")


def train_kernels(record, gen) -> None:
    """Phase 3 for the training kernels: K5/K5b over xp of both layer
    widths (D=512 feeds layer 0, D=1024 the others) and both directions
    at the config-3 step's shapes (T'=249, B=16, H=512), float32 with TF32
    off; then K6/K6b (ctc_kernels)."""
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
                same_fwd = torch.equal(ys, gru_mod.gru_scan_fwd(xp, wh, mask,
                                                                rev))
                ysp = gru_mod.prev_states(ref, rev)
                dxp, dwh = gru_mod.gru_scan_bwd(xp, ysp, wh, mask, dys, rev)
                rdxp, rdwh = gru_mod.gru_scan_bwd_plain(xp, ysp, wh, mask,
                                                        dys, rev)
                e_dxp = (dxp - rdxp).abs().max().item()
                e_dwh = (dwh - rdwh).abs().max().item()
                t_dxp = 1e-4 * rdxp.abs().max().item()
                t_dwh = 1e-4 * rdwh.abs().max().item()
                same = all(torch.equal(a, c) for a, c in zip(
                    (dxp, dwh),
                    gru_mod.gru_scan_bwd(xp, ysp, wh, mask, dys, rev)))
                ok = (err <= 1e-4 and e_dxp <= t_dxp and e_dwh <= t_dwh
                      and same and same_fwd)
                parts = ""
                if D == 1024 and not rev:      # K5b's three phases apart
                    parts = "; " + bwd_phases(gru_mod, "K5b", (
                        xp, ysp, wh, mask, dys, rev))
                phase(f"[3 K5/K5b] gru T={T} B={Bt} D={D} H={H} reverse="
                      f"{rev}: ys max_abs_err {err:.3e} (tol 1e-4), two "
                      f"calls equal bit for bit {same_fwd}; dxp "
                      f"{e_dxp:.3e} (tol {t_dxp:.3e}), dwh {e_dwh:.3e} (tol "
                      f"{t_dwh:.3e}); two calls equal bit for bit {same}"
                      f"{parts}")
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
                record("K5", "gru_scan_fwd", "tpuasr_torch/csrc/gru_bidir.cu",
                       "tpuasr/ops/pallas_gru.py:163", err, *t5)
                record("K5b", "gru_scan_bwd", "tpuasr_torch/csrc/gru_lean.cu",
                       "tpuasr/ops/pallas_gru.py:190", max(e_dxp, e_dwh),
                       *t5b)
        # K5b at B=64 beside cuDNN, on the same layer's weights.
        B64 = 64
        x64 = torch.randn(T, B64, D, generator=gen).to(dev)
        xp64 = (x64.reshape(T * B64, D) @ wx + b).reshape(T, B64, 3 * H)
        m64 = torch.ones(T, B64, 1, device=dev)
        ysp64 = gru_mod.prev_states(gru_mod.gru_scan_fwd(xp64, wh, m64),
                                    False)
        dys64 = torch.randn(T, B64, H, generator=gen).to(dev)
        a64 = (xp64, ysp64, wh, m64, dys64, False)
        got64 = gru_mod.gru_scan_bwd(*a64)
        want64 = gru_mod.gru_scan_bwd_plain(*a64)
        errs64 = [(a - w).abs().max().item() for a, w in zip(got64, want64)]
        tols64 = [1e-4 * w.abs().max().item() for w in want64]
        same64 = all(torch.equal(a, c) for a, c in zip(
            got64, gru_mod.gru_scan_bwd(*a64)))
        ms64 = cuda_ms(lambda: gru_mod.gru_scan_bwd(*a64), 10)
        lib64 = library_gru_ms(T, B64, D, H, torch.float32, True)
        bd64 = bound(nbytes(xp64, ysp64, wh, m64, dys64, xp64, wh),
                     6 * T * B64 * H * 3 * H, "fp32")
        phase(f"[3 K5b] B={B64} D={D}: dxp, dwh max_abs_err "
              f"{errs64[0]:.3e}, {errs64[1]:.3e} (tol {tols64[0]:.3e}, "
              f"{tols64[1]:.3e}); two calls equal bit for bit {same64}; "
              f"kernel {ms64:.3f} ms bound {bd64[0]:.4f} ms ({bd64[1]}) "
              f"torch.nn.GRU backward {lib64:.3f} ms; faster: "
              f"{ms64 < lib64}; {bwd_phases(gru_mod, 'K5b', a64)}")
        if not (all(e <= t for e, t in zip(errs64, tols64)) and same64):
            fail("K5b disagrees with its plain version at B=64")
        record("K5b", "gru_scan_bwd", "tpuasr_torch/csrc/gru_lean.cu",
               "tpuasr/ops/pallas_gru.py:190", max(errs64))
        del x64, xp64, ysp64, dys64, a64, got64, want64
    one_direction_checks(record, gru_mod, gen, T)
    # K5b at the shapes the old kernel refused (683 rows at H=512; H=640),
    # at a short T: within 1e-4 of each output's largest magnitude.
    for Bq, Hq in ((683, 512), (16, 640)):
        Tq = 9
        xq = torch.randn(Tq, Bq, 3 * Hq, generator=gen).to(dev)
        whq = (torch.randn(Hq, 3 * Hq, generator=gen) / Hq ** 0.5).to(dev)
        mq = (torch.arange(Tq)[:, None]
              < torch.randint(0, Tq + 1, (Bq,), generator=gen)[None, :])
        mq = mq.float()[:, :, None].to(dev).contiguous()
        dq = torch.randn(Tq, Bq, Hq, generator=gen).to(dev)
        with full_fp32():
            ysq = gru_mod.prev_states(gru_mod.gru_scan_plain(xq, whq, mq),
                                      False)
            got = gru_mod.gru_scan_bwd(xq, ysq, whq, mq, dq)
            want = gru_mod.gru_scan_bwd_plain(xq, ysq, whq, mq, dq)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        tols = [1e-4 * w.abs().max().item() for w in want]
        same = all(torch.equal(a, c) for a, c in zip(
            got, gru_mod.gru_scan_bwd(xq, ysq, whq, mq, dq)))
        phase(f"[3 K5b] repaired shape T={Tq} B={Bq} H={Hq}: dxp, dwh "
              f"max_abs_err {errs[0]:.3e}, {errs[1]:.3e} (tol {tols[0]:.3e}, "
              f"{tols[1]:.3e}); two calls equal bit for bit {same}")
        if not (all(e <= t for e, t in zip(errs, tols)) and same):
            fail(f"K5b disagrees with its plain version at B={Bq} H={Hq}")
        record("K5b", "gru_scan_bwd", "tpuasr_torch/csrc/gru_lean.cu",
               "tpuasr/ops/pallas_gru.py:190", max(errs))

    ctc_kernels(record, gen, T)


def ctc_batch(gen, B, T, C, U, edge):
    """A seeded CTC batch on the card: log-probs (B, T, C), int32 labels
    (B, U), int64 input and label lengths. edge adds a row of 0 frames, an
    empty label, a short label, repeated labels (no skip), an infeasible
    row, a label equal to the blank, garbage (negative, >= C) past a label,
    and a row longer than T."""
    lp = torch.log_softmax(torch.randn(B, T, C, generator=gen) * 2.0, -1)
    labels = torch.randint(1, C, (B, U), generator=gen, dtype=torch.int32)
    il = torch.randint(max(T // 2, 2 * U + 1), T + 1, (B,), generator=gen)
    ll = torch.full((B,), U)
    il[0] = T
    if edge:
        il[1], ll[2], ll[3] = 0, 0, 5
        labels[4, :] = 7
        il[4] = 30                             # needs 2U - 1 frames
        labels[5, :6] = 9
        ll[6] = 10
        labels[6, 10:] = torch.randint(-9, 200, (U - 10,), generator=gen)
        labels[7, 3] = 0
        il[8] = T + 5
    return lp.cuda(), labels.cuda(), il.cuda(), ll.cuda()


def device_launches(calls) -> dict:
    """{kernel name: launches} of the device work (kernels, copies, fills)
    of the calls in `calls` (each a function), from torch.profiler's sums by
    name. CUPTI drops the records of a session's first calls while it
    allocates its buffers (milliseconds; seen on the card), so a caller
    compares the counts with each other, over many calls, not with the
    number of calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in device_rows(prof):
        name = kernel_name(e.key)
        counts[name] = counts.get(name, 0) + e.count
    return counts


def ctc_kernels(record, gen, T) -> None:
    """Phase 3's K6 (ctc_forward: the loss from the log-probs, labels and
    lengths, with the alphas) and K6b (ctc_backward: the (B, T, C)
    gradient) against their plain versions: the edge cases at config 3's
    train shape (B=16, T'=249, C=64, U=24), config 3 at B=16 and B=64,
    config 4 at B=8 (C=48, U=16: S=33) and S=1023 (U=511, B=4). Gates: the
    loss within rtol 1e-5 (atol 1e-6), the reachable alphas (above -1e29)
    within rtol 1e-5 with the same reachability, the gradient within 1e-4
    of its largest magnitude, two calls the same bits. Then, at config 3's
    B=16: the kernels' ms beside the plain versions', the bound and
    aten's _ctc_loss and _ctc_loss_backward (one call each, the same
    functions), the whole loss (ctc_loss) forward and forward+backward
    beside F.ctc_loss's, and the device launches of a loss forward and of
    its backward (torch.profiler, over 50 calls each)."""
    from tpuasr_torch.losses import ctc as ctc_mod

    C, U = NUM_CLASSES, TRAIN_U
    cases = (("edge cases", TRAIN_B, T, C, U, True),
             ("config 3", TRAIN_B, T, C, U, False),
             ("config 3", 64, T, C, U, False),
             ("config 4", 8, T, CAPS_CLASSES, CAPS_TRAIN_U, False),
             ("S=1023", 4, 1100, C, 511, False))
    for label, Bc, Tc, Cc, Uc, edge in cases:
        lp, labels, il, ll = ctc_batch(gen, Bc, Tc, Cc, Uc, edge)
        g = (torch.rand(Bc, generator=gen) + 0.5).cuda()
        got = ctc_mod.ctc_forward(lp, labels, il, ll)
        want = ctc_mod.ctc_forward_plain(lp, labels, il, ll)
        gk = ctc_mod.ctc_backward(lp, labels, il, ll, got[2], got[1], g)
        gp = ctc_mod.ctc_backward_plain(lp, labels, il, ll, want[2], want[1],
                                        g)
        again = ctc_mod.ctc_forward(lp, labels, il, ll)
        same = all(torch.equal(x, y) for x, y in zip(got, again)) and \
            torch.equal(gk, ctc_mod.ctc_backward(lp, labels, il, ll,
                                                 again[2], again[1], g))
        reach = want[2] > -1e29
        same_reach = torch.equal(got[2] > -1e29, reach)
        a_err = (got[2][reach] - want[2][reach]).abs()
        a_ok = bool((a_err <= 1e-5 * want[2][reach].abs() + 1e-6).all())
        l_err = (got[0] - want[0]).abs()
        l_ok = bool((l_err <= 1e-5 * want[0].abs() + 1e-6).all())
        g_err = (gk - gp).abs().max().item()
        g_tol = 1e-4 * gp.abs().max().item()
        zero = int((got[0] == 0).sum())
        phase(f"[3 K6/K6b] ctc {label} B={Bc} T={Tc} C={Cc} S={2 * Uc + 1}: "
              f"loss max_abs_err {l_err.max().item():.3e} (rtol 1e-5; "
              f"{zero} rows zeroed), alphas reachable {int(reach.sum())} of "
              f"{reach.numel()}, same reachability {same_reach}, "
              f"max_abs_err {a_err.max().item():.3e} (rtol 1e-5); grad "
              f"max_abs_err {g_err:.3e} (tol {g_tol:.3e}); two calls equal "
              f"bit for bit {same}")
        if not (same and same_reach and a_ok and l_ok and g_err <= g_tol
                and torch.isfinite(gk).all()):
            fail(f"K6/K6b disagree with their plain versions ({label}, "
                 f"B={Bc})")
        record("K6", "ctc_forward", "tpuasr_torch/csrc/ctc_fb.cu",
               "tpuasr/losses/ctc_pallas.py:167",
               max(l_err.max().item(), a_err.max().item()))
        record("K6b", "ctc_backward", "tpuasr_torch/csrc/ctc_fb.cu",
               "tpuasr/losses/ctc_pallas.py:192", g_err)

    # Times at config 3's train step (B=16), on a batch without edge rows.
    lp, labels, il, ll = ctc_batch(gen, TRAIN_B, T, C, U, False)
    g = torch.ones(TRAIN_B, device="cuda")
    loss, llv, alphas = ctc_mod.ctc_forward(lp, labels, il, ll)
    fwd = (lp, labels, il, ll)
    bwd = (*fwd, alphas, llv, g)
    ms = queued_ms(lambda: ctc_mod.ctc_forward(*fwd), 20)
    bms = queued_ms(lambda: ctc_mod.ctc_backward(*bwd), 20)
    pms = cuda_ms(lambda: ctc_mod.ctc_forward_plain(*fwd), 2)
    pbms = cuda_ms(lambda: ctc_mod.ctc_backward_plain(*bwd), 2)
    # The bytes the loss needs: each row's distinct classes' emissions over
    # its frames (K6 to the frame ll is read at, K6b below the length), the
    # alphas of those frames and valid states written once and read once,
    # the gradient written once, labels, lengths, ll, loss and g. Operations:
    # ~12 a state and frame in each recursion, ~5 more for an occupancy.
    lens = il.clamp(0, T).tolist()
    lab_n = ll.tolist()
    fb = fwd_elems = bwd_elems = 0
    for b in range(TRAIN_B):
        ncls = len(set(labels[b, :lab_n[b]].clamp(0, C - 1).tolist()) | {0})
        nf = max(lens[b], 1)
        fwd_elems += nf * (2 * lab_n[b] + 1)
        bwd_elems += lens[b] * (2 * lab_n[b] + 1)
        fb += nf * ncls
    small = nbytes(labels, il, ll) + 3 * 4 * TRAIN_B
    bd_f = bound(4 * (fb + fwd_elems) + small, 12 * fwd_elems, "fp32")
    bd_b = bound(4 * (fb + bwd_elems + TRAIN_B * T * C) + small,
                 17 * bwd_elems, "fp32")
    # aten's CTC: the same two functions, one call each (labels clipped to
    # the classes, lengths at least one frame).
    lp_t = lp.permute(1, 0, 2)
    lab_ok = labels.clamp(0, C - 1).long()
    il_ok, ll_ok = il.clamp(1, T), ll
    nll, la = torch.ops.aten._ctc_loss.Tensor(lp_t, lab_ok, il_ok, ll_ok, 0,
                                              True)
    lib_f = queued_ms(lambda: torch.ops.aten._ctc_loss.Tensor(
        lp_t, lab_ok, il_ok, ll_ok, 0, True), 20)
    lib_b = queued_ms(lambda: torch.ops.aten._ctc_loss_backward.Tensor(
        g, lp_t, lab_ok, il_ok, ll_ok, nll, la, 0, True), 20)
    x = lp.clone().requires_grad_()
    x_t = lp_t.detach().clone().requires_grad_()

    def port_fb():
        return torch.autograd.grad(ctc_mod.ctc_loss(x, labels, il, ll), x, g)

    def lib_fb():
        return torch.autograd.grad(torch.nn.functional.ctc_loss(
            x_t, lab_ok, il_ok, ll_ok, reduction="none", zero_infinity=True),
            x_t, g)

    with torch.no_grad():
        port_fwd = queued_ms(lambda: ctc_mod.ctc_loss(lp, labels, il, ll), 20)
        f_fwd = queued_ms(lambda: torch.nn.functional.ctc_loss(
            lp_t, lab_ok, il_ok, ll_ok, reduction="none",
            zero_infinity=True), 20)
    port_fwdbwd = queued_ms(port_fb, 20)
    f_fwdbwd = queued_ms(lib_fb, 20)
    # Device launches a loss forward and a backward: over 50 calls each,
    # every launch per K6 (or K6b) launch the profiler kept.
    n_f = device_launches(
        [lambda: ctc_mod.ctc_loss(x, labels, il, ll)] * 50)
    outs = [ctc_mod.ctc_loss(x, labels, il, ll) for _ in range(50)]
    n_b = device_launches(
        [lambda o=o: torch.autograd.grad(o, x, g) for o in outs])
    del outs
    phase(f"[3 K6] ctc_forward B={TRAIN_B} T={T} C={C} S={2 * U + 1}: kernel "
          f"{ms:.4f} ms, plain {pms:.3f} ms, bound {bd_f[0]:.5f} ms "
          f"({bd_f[1]}), aten._ctc_loss {lib_f:.4f} ms")
    phase(f"[3 K6b] ctc_backward B={TRAIN_B} T={T} C={C}: kernel {bms:.4f} "
          f"ms, plain {pbms:.3f} ms, bound {bd_b[0]:.5f} ms ({bd_b[1]}), "
          f"aten._ctc_loss_backward {lib_b:.4f} ms")
    phase(f"[3 ctc_loss] B={TRAIN_B}: forward {port_fwd:.4f} ms (F.ctc_loss "
          f"{f_fwd:.4f}), forward+backward {port_fwdbwd:.4f} ms (F.ctc_loss "
          f"{f_fwdbwd:.4f}); device launches of 50 forwards {n_f}, of 50 "
          f"backwards {n_b} (the profiler keeps the later calls' records)")
    k6, k6b = n_f.get("ctc_fwd_kernel", 0), n_b.get("ctc_bwd_kernel", 0)
    if not (k6 and sum(n_f.values()) <= 2 * k6 and k6b
            and sum(n_b.values()) <= 2 * k6b):
        fail(f"one CTC loss forward and backward should be K6 and K6b with "
             f"at most one other launch each: {n_f}, {n_b}")
    record("K6", "ctc_forward", "tpuasr_torch/csrc/ctc_fb.cu",
           "tpuasr/losses/ctc_pallas.py:167", 0.0, ms, pms, bd_f, lib_f)
    record("K6b", "ctc_backward", "tpuasr_torch/csrc/ctc_fb.cu",
           "tpuasr/losses/ctc_pallas.py:192", 0.0, bms, pbms, bd_b, lib_b)


def xfused_cases(gru_mod, quantize_per_channel, x, wx, wh, bias, mask):
    """K2/K4's served cases on one layer: (key, label, kernel, plain, args,
    kwargs) for bf16 K2, int8 K4 and int8 K4 with rec_q8."""
    wxq, sw = quantize_per_channel(wx)
    whq, swh = quantize_per_channel(wh)
    return (
        ("K2", "bf16", gru_mod.gru_scan_xfused,
         gru_mod.gru_scan_xfused_plain,
         (x, wx.bfloat16(), bias, wh.bfloat16(), mask), {}),
        ("K4", "int8", gru_mod.gru_scan_xfused_q8,
         gru_mod.gru_scan_xfused_q8_plain,
         (x, wxq, sw, bias, wh.bfloat16(), mask), {}),
        ("K4", "int8+rec_q8", gru_mod.gru_scan_xfused_q8,
         gru_mod.gru_scan_xfused_q8_plain,
         (x, wxq, sw, bias, whq, mask), {"wh_scale": swh}),
    )


def xfused_split(gru_mod, key, args, kw) -> str:
    """The two launches of one K2/K4 call timed apart (CUDA events, mean
    of 3): the projection over all T*B rows, then the recurrence, with the
    plan they ran under."""
    if key == "K2":
        x, wx, b, wh, mask = args
        sw = swh = None
        mode = gru_mod._MODE_K2
    else:
        x, wx, sw, b, wh, mask = args
        swh = kw.get("wh_scale")
        mode = gru_mod._MODE_Q8_REC if swh is not None else gru_mod._MODE_Q8
    T, Bn, D = x.shape
    H = wh.shape[0]
    plan = gru_mod._scan_plan(Bn, D, H, mode, x.dtype,
                              gru_mod._sm_count(x.device))
    wxp, whp = gru_mod._pack_proj(wx, plan), gru_mod._pack_rec(wh, plan)
    mask2 = mask.reshape(T, Bn)
    xp = gru_mod._project(plan, x, wxp, b, sw)
    p_ms = cuda_ms(lambda: gru_mod._project(plan, x, wxp, b, sw), 3)
    r_ms = cuda_ms(lambda: gru_mod._recur(plan, xp, whp, swh, mask2, False,
                                          x.dtype), 3)
    return (f"one launch = projection ({plan.proj}) {p_ms:.3f} ms + "
            f"recurrence ({plan.rec}) {r_ms:.3f} ms = {r_ms / T * 1e3:.2f} "
            f"us a step (plan U={plan.U} R={plan.R} row groups {plan.rg} "
            f"grid={plan.grid} smem={plan.smem} B)")


def xfused_f32_kernels(record, gen, gru_mod) -> None:
    """K2 in float32 at the deepspeech_var train step's forward shapes
    (phase 9: T'=249, H=384, D=512 and 768, B=16 and 64, both directions)
    against its plain version, each output within 1e-4 of its largest
    magnitude; timed at D=768, B=16 beside its bound and cuDNN's float32
    GRU forward on the same layer."""
    from tpuasr_torch.precision import full_fp32

    T, H, tol = 249, 384, 1e-4
    for D in (512, 768):
        for Bt in (TRAIN_B, 64):
            x = torch.randn(T, Bt, D, generator=gen).cuda()
            wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).cuda()
            wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).cuda()
            b = (torch.randn(3 * H, generator=gen) * 0.1).cuda()
            ln = torch.randint(T // 2, T + 1, (Bt,), generator=gen)
            ln[0] = T
            mask = (torch.arange(T)[:, None] < ln[None, :]).float()
            mask = mask[:, :, None].cuda().contiguous()
            args = (x, wx, b, wh, mask)
            for rev in (False, True):
                with full_fp32():
                    got = gru_mod.gru_scan_xfused(*args, rev)
                    ref = gru_mod.gru_scan_xfused_plain(*args, rev)
                abs_err = (got - ref).abs().max().item()
                err = abs_err / ref.abs().max().item()
                timed = D == 768 and Bt == TRAIN_B and not rev
                extra = ""
                ms = pms = bd = lib = None
                if timed:
                    with full_fp32():
                        ms = cuda_ms(lambda: gru_mod.gru_scan_xfused(
                            *args, False), 10)
                        pms = cuda_ms(lambda: gru_mod.gru_scan_xfused_plain(
                            *args, False), 1)
                        lib = library_gru_ms(T, Bt, D, H, torch.float32,
                                             False)
                    bd = bound(nbytes(*args, got),
                               2 * T * Bt * (D + H) * 3 * H, "fp32")
                    extra = (f" kernel {ms:.3f} ms plain {pms:.3f} ms bound "
                             f"{bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU f32 "
                             f"{lib:.3f} ms")
                phase(f"[3 K2-f32] gru f32 T={T} B={Bt} D={D} H={H} "
                      f"reverse={rev}: max_abs_err {abs_err:.3e} = "
                      f"{err:.3e} of the largest magnitude (tol {tol})"
                      f"{extra}")
                if timed:
                    with full_fp32():
                        split = xfused_split(gru_mod, "K2", args, {})
                    phase(f"[3 K2-f32] gru f32 D={D} B={Bt}: {split}")
                if not err <= tol:
                    fail(f"K2 f32 D={D} B={Bt} reverse={rev}: {err}")
                record("K2-f32", "gru_scan_xfused (f32)",
                       "tpuasr_torch/csrc/gru_scan.cu",
                       "tpuasr/ops/pallas_gru.py:615", abs_err, ms, pms, bd,
                       lib)


def xfb_kernels(record, gen) -> None:
    """Phase 3 for K2b, the fused-projection scan's backward, at the
    shapes of the deepspeech_var train step (phase 9: T'=249, B=16, H=384,
    D=512 for layer 1 and 768 for layers 2-6, both directions, float32):
    against its plain version, two calls bit for bit, and timed at D=768
    and B=16 and 64 beside the recompute route (xp by a matmul, K5b, three
    matmuls) and cuDNN's GRU backward, its three phases apart; then at the
    shapes the old fused kernel refused, at a short T."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.precision import full_fp32
    from tpuasr_torch.utils.params import preset_for

    dev = torch.device("cuda")
    T = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)
    H = preset_for("deepspeech_var")[0]["rnn_hidden"]
    for D in (512, 2 * H):
        for Bt in ((TRAIN_B, 64) if D == 2 * H else (TRAIN_B,)):
            lens = torch.randint(T // 2, T + 1, (Bt,), generator=gen)
            lens[0], lens[1] = T, 1
            mask = (torch.arange(T)[:, None] < lens[None, :]).float()
            mask = mask[:, :, None].to(dev).contiguous()
            x = torch.randn(T, Bt, D, generator=gen).to(dev)
            wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).to(dev)
            b = (torch.randn(3 * H, generator=gen) * 0.1).to(dev)
            wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
            dys = torch.randn(T, Bt, H, generator=gen).to(dev)
            if not gru_mod.xfused_bwd_is_fused(D, H):
                fail(f"JAX's rule does not take K2b at D={D}, H={H}")
            for rev in ((False, True) if Bt == TRAIN_B else (False,)):
                with full_fp32():
                    ys = gru_mod.gru_scan_xfused_plain(x, wx, b, wh, mask,
                                                       rev)
                    ysp = gru_mod.prev_states(ys, rev)
                    args = (x, ysp, wx, b, wh, mask, dys, rev)
                    got = gru_mod.gru_scan_xfused_bwd(*args)
                    want, pms = timed_once(
                        lambda: gru_mod.gru_scan_xfused_bwd_plain(*args))
                # Each output within 1e-4 of its largest magnitude (K5b's
                # gate; dWx and dWh sum T*B outer products).
                errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
                tols = [1e-4 * w.abs().max().item() for w in want]
                same = all(torch.equal(a, c) for a, c in
                           zip(got, gru_mod.gru_scan_xfused_bwd(*args)))
                phase(f"[3 K2b] gru_scan_xfused_bwd T={T} B={Bt} D={D} H={H}"
                      f" reverse={rev}: dx, dwx, db, dwh max_abs_err "
                      f"{', '.join(f'{e:.3e}' for e in errs)} (tol "
                      f"{', '.join(f'{t:.3e}' for t in tols)}); two launches"
                      f" equal bit for bit {same}")
                if not (all(e <= t for e, t in zip(errs, tols)) and same):
                    fail(f"K2b disagrees with its plain version at D={D} "
                         f"B={Bt} reverse={rev}")
                timing = ()
                if D == 2 * H and not rev:
                    ms = cuda_ms(lambda: gru_mod.gru_scan_xfused_bwd(*args),
                                 10)

                    def recompute():
                        with full_fp32():
                            xp = (x.reshape(T * Bt, D) @ wx + b).reshape(
                                T, Bt, 3 * H)
                            dxp, dwh = gru_mod.gru_scan_bwd(xp, ysp, wh, mask,
                                                            dys, rev)
                            dxp2 = dxp.reshape(T * Bt, 3 * H)
                            return (dxp2 @ wx.T, x.reshape(T * Bt, D).T @ dxp2,
                                    dxp2.sum(0), dwh)

                    rms = cuda_ms(recompute, 10)
                    # 9 B H (D + H) multiply-adds a step: xp, dx and dWx
                    # against Wx, hp, dhp Wh^T and dWh against Wh.
                    bd = bound(nbytes(x, ysp, wx, b, wh, mask, dys, *got),
                               18 * T * Bt * H * (D + H), "fp32")
                    lib = library_gru_ms(T, Bt, D, H, torch.float32, True)
                    phase(f"[3 K2b] B={Bt} D={D}: kernel {ms:.3f} ms plain "
                          f"{pms:.3f} ms (one call) bound {bd[0]:.4f} ms "
                          f"({bd[1]}); the recompute route (xp matmul, K5b, "
                          f"three matmuls) {rms:.3f} ms; torch.nn.GRU "
                          f"backward {lib:.3f} ms; faster than both: "
                          f"{ms < min(rms, lib)}; "
                          f"{bwd_phases(gru_mod, 'K2b', args)}")
                    if Bt == TRAIN_B:
                        timing = (ms, pms, bd, lib)
                record("K2b", "gru_scan_xfused_bwd",
                       "tpuasr_torch/csrc/gru_lean.cu",
                       "tpuasr/ops/pallas_gru.py:736", max(errs), *timing)
    # The shapes the old fused kernel refused (146 rows at H=512, D=320;
    # 609 rows at D=768, H=384), at a short T.
    for Bq, Dq, Hq in ((146, 320, 512), (609, 768, 384)):
        Tq = 9
        lens = torch.randint(0, Tq + 1, (Bq,), generator=gen)
        mask = (torch.arange(Tq)[:, None] < lens[None, :]).float()
        mask = mask[:, :, None].to(dev).contiguous()
        x = torch.randn(Tq, Bq, Dq, generator=gen).to(dev)
        wx = (torch.randn(Dq, 3 * Hq, generator=gen) / Dq ** 0.5).to(dev)
        b = (torch.randn(3 * Hq, generator=gen) * 0.1).to(dev)
        wh = (torch.randn(Hq, 3 * Hq, generator=gen) / Hq ** 0.5).to(dev)
        dys = torch.randn(Tq, Bq, Hq, generator=gen).to(dev)
        with full_fp32():
            ysp = gru_mod.prev_states(
                gru_mod.gru_scan_xfused_plain(x, wx, b, wh, mask), False)
            args = (x, ysp, wx, b, wh, mask, dys)
            got = gru_mod.gru_scan_xfused_bwd(*args)
            want = gru_mod.gru_scan_xfused_bwd_plain(*args)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        tols = [1e-4 * w.abs().max().item() for w in want]
        phase(f"[3 K2b] repaired shape T={Tq} B={Bq} D={Dq} H={Hq}: dx, dwx,"
              f" db, dwh max_abs_err {', '.join(f'{e:.3e}' for e in errs)} "
              f"(tol {', '.join(f'{t:.3e}' for t in tols)})")
        if not all(e <= t for e, t in zip(errs, tols)):
            fail(f"K2b disagrees with its plain version at B={Bq} D={Dq} "
                 f"H={Hq}")
        record("K2b", "gru_scan_xfused_bwd", "tpuasr_torch/csrc/gru_lean.cu",
               "tpuasr/ops/pallas_gru.py:736", max(errs))
    torch.cuda.empty_cache()


def one_direction_checks(record, gru_mod, gen, T) -> None:
    """K5's forward (gru_scan_fwd: csrc/gru_bidir.cu's recurrence at one
    direction, planned by _f32_rec_plan; K2's f32 recurrence runs it too)
    at config 3's H=512 and deepspeech_var's H=384, B=16 and 64, T'=249,
    both scan senses, on ragged rows: within 1e-4 of gru_scan_plain, two
    calls bit for bit; timed forward at each shape with its plan. Then
    once at H=640 (B=16) and H=1056 (B=7), T'=37, within 1e-5."""
    from tpuasr_torch.precision import full_fp32

    dev = torch.device("cuda")
    n_sm = gru_mod._sm_count(dev)
    shapes = [(H, Bn, T, 1e-4) for H in (HIDDEN, 384) for Bn in (TRAIN_B, 64)]
    shapes += [(640, TRAIN_B, 37, 1e-5), (1056, 7, 37, 1e-5)]
    for H, Bn, Tn, tol in shapes:
        xp = torch.randn(Tn, Bn, 3 * H, generator=gen).to(dev)
        wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
        ln = torch.randint(Tn // 2, Tn + 1, (Bn,), generator=gen)
        ln[0] = Tn
        mask = (torch.arange(Tn)[:, None] < ln[None, :]).float()[:, :, None]
        mask = mask.to(dev).contiguous()
        plan = gru_mod._f32_rec_plan(Bn, H, n_sm)
        errs, same = [], True
        with full_fp32():
            for rev in (False, True):
                got = gru_mod.gru_scan_fwd(xp, wh, mask, rev)
                want = gru_mod.gru_scan_plain(xp, wh, mask, rev)
                errs.append((got - want).abs().max().item())
                same &= torch.equal(got, gru_mod.gru_scan_fwd(xp, wh, mask,
                                                              rev))
        timing = ""
        if Tn == T:
            ms = cuda_ms(lambda: gru_mod.gru_scan_fwd(xp, wh, mask), 10)
            timing = (f"; {ms:.3f} ms ({ms / Tn * 1e3:.2f} us a step)")
        phase(f"[3 K5] gru_scan_fwd T={Tn} B={Bn} H={H}: max_abs_err "
              f"forward {errs[0]:.3e}, reverse {errs[1]:.3e} (tol {tol}); two "
              f"calls equal bit for bit {same}; plan U={plan.U}, {plan.rg} "
              f"row group(s), grid {plan.grid}, kc {plan.kc}{timing}")
        if not (max(errs) <= tol and same):
            fail(f"K5's forward disagrees with gru_scan_plain at B={Bn} "
                 f"H={H}")
        record("K5", "gru_scan_fwd", "tpuasr_torch/csrc/gru_bidir.cu",
               "tpuasr/ops/pallas_gru.py:163", max(errs))
        del xp, wh


def bwd_phases(gru_mod, key, args) -> str:
    """The three phases of one K2b call (key "K2b", the arguments of
    gru_scan_xfused_bwd), K5b call ("K5b", those of gru_scan_bwd) or K7b
    call ("K7b", those of gru_scan_bidir_bwd) timed apart with CUDA events
    (mean of 10): the pre-scan products (hp, and K2b's xp), the lean
    recurrence, the post-scan products (the weight gradients, and K2b's
    dx); and the recurrence's plan. With bf16 streams the recurrence is
    the tensor-core body over the streams as they are, as the wrappers run
    it."""
    if key == "K5b":
        xp, ysp, wh, mask, dys, rev = args
        T, B, _ = xp.shape
        ndir = 1

        def pre():
            return gru_mod._hp(ysp, wh)

        dirs = [(xp, pre(), ysp, dys, wh)]
    elif key == "K2b":
        x, ysp, wx, b, wh, mask, dys, rev = args
        T, B, _ = x.shape
        ndir = 1

        def pre():
            return gru_mod._xfb_pre(x, ysp, wx, b, wh)

        xp, hp = pre()
        dirs = [(xp, hp, ysp, dys, wh)]
    else:
        xpf, xpb, yspf, yspb, whf, whb, mask, dysf, dysb = args
        T, B, _ = xpf.shape
        ndir, rev = 2, False

        def pre():
            return gru_mod._hp(yspf, whf), gru_mod._hp(yspb, whb)

        hpf, hpb = pre()
        dirs = [(xpf, hpf, yspf, dysf, whf), (xpb, hpb, yspb, dysb, whb)]
    H = dirs[0][-1].shape[0]
    bf16 = dirs[0][-1].dtype == torch.bfloat16
    lean = gru_mod._lean_bf16 if bf16 else gru_mod._lean
    plan = gru_mod._lean_plan(B, H, ndir, gru_mod._sm_count(mask.device),
                              bf16)
    m2 = mask.reshape(T, B).contiguous()
    outs = lean(plan, dirs, m2, rev)
    if key == "K2b":
        def post():
            return gru_mod._xfb_post(x, ysp, wx, *outs[0])
    else:
        def post():
            return [gru_mod._dwh(d[2], o[1]) for d, o in zip(dirs, outs)]
    pre_ms, post_ms = cuda_ms(pre, 10), cuda_ms(post, 10)
    rec_ms = cuda_ms(lambda: lean(plan, dirs, m2, rev), 10)
    return (f"phases: pre-scan products {pre_ms:.3f} ms, lean recurrence "
            f"{rec_ms:.3f} ms ({rec_ms / T * 1e3:.2f} us a step; U={plan.U},"
            f" {plan.rg} row group(s), {plan.ndir} direction(s) a grid of "
            f"{plan.grid}, chunks of {plan.kc}), post-scan products "
            f"{post_ms:.3f} ms")


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
    x C=32 -> 16 x 32, Kt=11 taps), K7 at the serving shape (B=128,
    T'=499, H=512, bf16), K7-f32 at it and at the fused_bidir train step's
    (config 3's layer: B=16, 64 and 128, T'=249), and K7-f32 at H=640 and
    H=1056."""
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
    # The yardstick is the bf16 conv: the int8 arm exists to beat it.
    phase(f"[3 K9] conv_taps_q8 B={B} T_out={T} Kt={Kt} Kd={Kd} N={N}: "
          f"max_abs_err {err:.3e} (tol rtol 1e-6 atol 1e-6; |out| max "
          f"{ref.abs().max().item():.3f}; {same:.6f} of the outputs equal "
          f"bit for bit) kernel {ms:.3f} ms plain {pms:.3f} ms bound "
          f"{bd[0]:.4f} ms ({bd[1]}) F.conv2d bf16 {lib_bf16:.3f} ms, fp32 "
          f"(TF32 off) {lib:.3f} ms; faster than the bf16 conv: "
          f"{ms < lib_bf16}")
    if not ok:
        fail("K9 disagrees with its plain version")
    record("K9", "conv_taps_q8 (int8 conv2, im2col)",
           "tpuasr_torch/csrc/conv_q8.cu", "tpuasr/ops/pallas_conv.py:138",
           err, ms, pms, bd, lib_bf16)
    # The taps and slab bodies (TPUASR_CONV_Q8_MODE) on the same input, to
    # f32 rounding as im2col; the same operations, bound and library call.
    for mode in ("taps", "slab"):
        got = conv_mod.conv_taps_q8(xf, mq, sw, T, mode=mode)
        ref = conv_mod.reference_q8_conv_taps(xf, mq, sw, T, mode)
        err = (got - ref).abs().max().item()
        same = (got == ref).double().mean().item()
        ok = bool(torch.allclose(got, ref, rtol=1e-6, atol=1e-6))
        ms = cuda_ms(lambda: conv_mod.conv_taps_q8(xf, mq, sw, T, mode=mode),
                     10)
        pms = cuda_ms(lambda: conv_mod.reference_q8_conv_taps(xf, mq, sw, T,
                                                              mode), 2)
        phase(f"[3 K9-{mode}] conv_taps_q8 mode={mode} B={B} T_out={T}: "
              f"max_abs_err {err:.3e} (tol rtol 1e-6 atol 1e-6; {same:.6f} "
              f"of the outputs equal bit for bit) kernel {ms:.3f} ms plain "
              f"{pms:.3f} ms bound {bd[0]:.4f} ms ({bd[1]}) F.conv2d bf16 "
              f"{lib_bf16:.3f} ms, fp32 {lib:.3f} ms; faster than the bf16 "
              f"conv: {ms < lib_bf16}")
        if not ok:
            fail(f"K9 {mode} disagrees with its plain version")
        record(f"K9-{mode}", f"conv_taps_q8 (int8 conv2, {mode})",
               "tpuasr_torch/csrc/conv_q8.cu",
               "tpuasr/ops/pallas_conv.py:138", err, ms, pms, bd, lib_bf16)
    del xf, x4, x4b, got, ref

    # K7: xp = x@Wx + b of a 1024-wide layer, xpb from the per-row
    # reversed x, as the fused BiGRU forms them. bf16 (K7) at the served
    # shape; f32 (K7-f32) at every batch the fused_bidir train step runs
    # (B=16, 64, 128 at T'=249) and at the served shape.
    H, D = HIDDEN, 2 * HIDDEN
    T_tr = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)
    n_sm = gru_mod._sm_count(dev)
    shapes = (("serving", T, B, (torch.bfloat16, torch.float32)),
              *(("training", T_tr, Bn, (torch.float32,))
                for Bn in (TRAIN_B, 64, 128)))
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
            bf16 = dt == torch.bfloat16
            with full_fp32():
                xp = [(a.reshape(Tn * Bn, D).to(dt) @ wx[i].to(dt)
                       + bx[i].to(dt)).reshape(Tn, Bn, 3 * H)
                      for i, a in enumerate((xs, xr))]
            args = (*xp, wh[0].to(dt), wh[1].to(dt), mask)
            # f32: within 1e-4 (K5's bound at the trained length: sums of
            # 512 terms in another order, carried over the steps); bf16:
            # K2's 2e-2.
            tol = 2e-2 if bf16 else 1e-4
            got = gru_mod.gru_scan_bidir_fwd(*args)
            again = gru_mod.gru_scan_bidir_fwd(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            with full_fp32():
                ref, pms = timed_once(
                    lambda: gru_mod.gru_scan_bidir_plain(*args))
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            ms = cuda_ms(lambda: gru_mod.gru_scan_bidir_fwd(*args), 5)
            kind = "bf16" if bf16 else "fp32"
            bd = bound(nbytes(*args, *got), 2 * macs, kind)
            if bf16:
                lib = library_gru_ms(Tn, Bn, D, H, dt, False,
                                     bidirectional=True)
                lib_s = f"{lib:.3f} ms"
                # bf16: K2's recurrence over both directions in one grid.
                plan = gru_mod._scan_plan(Bn, H, H, gru_mod._MODE_K2, dt,
                                          n_sm, ndir=2)
                how = (f"plan {plan.ndir} directions x {plan.rg} row groups "
                       f"x {-(-H // plan.U)} groups of U={plan.U}, "
                       f"R={plan.R}, grid={plan.grid}")
            else:
                # cuDNN in full f32 (TF32 off), as the kernel; and with
                # PyTorch's default, which lets cuDNN's RNNs use TF32.
                with full_fp32():
                    lib = library_gru_ms(Tn, Bn, D, H, dt, False,
                                         bidirectional=True)
                lib_tf32 = library_gru_ms(Tn, Bn, D, H, dt, False,
                                          bidirectional=True)
                lib_s = (f"{lib:.3f} ms (TF32 off; {lib_tf32:.3f} ms with "
                         f"PyTorch's default, TF32 allowed)")
                plan = gru_mod._bidir_f32_plan(Bn, H, n_sm)
                how = (f"plan {plan.ndir} direction(s) a grid x {plan.rg} "
                       f"row group(s) x {-(-H // plan.U)} groups of "
                       f"U={plan.U}, chunks of {plan.kc}, grid={plan.grid}, "
                       f"{plan.smem} bytes of shared memory a block")
            key = "K7" if bf16 else "K7-f32"
            phase(f"[3 {key}] gru_scan_bidir {label} {kind} T={Tn} B={Bn} "
                  f"H={H}: max_abs_err {err:.3e} (tol {tol}); two launches "
                  f"equal bit for bit {same}; kernel {ms:.3f} ms "
                  f"({ms / Tn * 1e3:.2f} us a step; {how}) plain {pms:.3f} "
                  f"ms bound {bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU "
                  f"bidirectional {kind} forward (input projection "
                  f"included) {lib_s}; faster than the library call: "
                  f"{ms < lib}")
            if not (err <= tol and same):
                fail(f"{key} {label} T={Tn} B={Bn} disagrees with its plain "
                     f"version or two launches differ")
            # The kernels line: bf16 at the served shape, f32 at the
            # counted train step's (B=16).
            timed = label == "serving" if bf16 else Bn == TRAIN_B
            record(key, "gru_scan_bidir_fwd (bf16 serving)" if bf16 else
                   "gru_scan_bidir_fwd (f32 training)",
                   "tpuasr_torch/csrc/gru_scan.cu" if bf16 else
                   "tpuasr_torch/csrc/gru_bidir.cu",
                   "tpuasr/ops/pallas_gru.py:406", err,
                   *((ms, pms, bd, lib) if timed else ()))
            del xp, args, got, again, ref
        torch.cuda.empty_cache()
    # K7-f32 at the widths the old kernel refused (H >= 571), at a short T:
    # H=640 (both directions in one grid) and H=1056 (a launch each).
    for Hq in (640, 1056):
        Tq, Bq = 9, TRAIN_B
        ln = torch.randint(0, Tq + 1, (Bq,), generator=gen)
        ln[0] = Tq
        mq = (torch.arange(Tq)[:, None] < ln[None, :]).float()[:, :, None]
        args = ([torch.randn(Tq, Bq, 3 * Hq, generator=gen).to(dev)
                 for _ in range(2)]
                + [(torch.randn(Hq, 3 * Hq, generator=gen) / Hq ** 0.5).to(
                    dev) for _ in range(2)] + [mq.to(dev).contiguous()])
        got = gru_mod.gru_scan_bidir_fwd(*args)
        same = all(torch.equal(a, b) for a, b in zip(
            got, gru_mod.gru_scan_bidir_fwd(*args)))
        with full_fp32():
            ref = gru_mod.gru_scan_bidir_plain(*args)
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        plan = gru_mod._bidir_f32_plan(Bq, Hq, n_sm)
        phase(f"[3 K7-f32] repaired width T={Tq} B={Bq} H={Hq}: max_abs_err "
              f"{err:.3e} (tol 1e-5); two launches equal bit for bit {same}; "
              f"plan {plan.ndir} direction(s) a grid x {plan.rg} row "
              f"group(s) x {-(-Hq // plan.U)} groups of U={plan.U}, chunks "
              f"of {plan.kc}, grid={plan.grid}, {plan.smem} bytes a block")
        if not (err <= 1e-5 and same):
            fail(f"K7-f32 disagrees with its plain version at H={Hq}")
        record("K7-f32", "gru_scan_bidir_fwd (f32 training)",
               "tpuasr_torch/csrc/gru_bidir.cu",
               "tpuasr/ops/pallas_gru.py:406", err)
        del args, got, ref
    torch.cuda.empty_cache()


def bidir_bwd_kernels(record, gen) -> None:
    """Phase 3 for K7b, the fused BiGRU's float32 backward, at config 3's
    layer (T'=249, H=512; D=1024 for cuDNN) at every batch the
    fused_bidir train step runs (B=16, 64 and 128): against its plain
    backward (each output within 1e-4 of its largest magnitude: dWh sums
    T*B outer products per direction), two calls bit for bit, its time
    beside cuDNN's bidirectional backward and its three phases apart; then
    at the shapes the old kernel refused (683 rows at H=512; H=640), at a
    short T."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.precision import full_fp32

    dev = torch.device("cuda")
    T = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)
    H, D = HIDDEN, 2 * HIDDEN
    shapes = [(T, Bn, H) for Bn in (TRAIN_B, 64, 128)]
    shapes += [(9, 683, H), (9, TRAIN_B, 640)]
    for Tn, Bn, Hn in shapes:
        ln = torch.randint(Tn // 2, Tn + 1, (Bn,), generator=gen)
        ln[0], ln[1] = Tn, 1
        mask = (torch.arange(Tn)[:, None] < ln[None, :]).float()[:, :, None]
        mask = mask.to(dev).contiguous()
        xp = [torch.randn(Tn, Bn, 3 * Hn, generator=gen).to(dev)
              for _ in range(2)]
        wh = [(torch.randn(Hn, 3 * Hn, generator=gen) / Hn ** 0.5).to(dev)
              for _ in range(2)]
        dys = [torch.randn(Tn, Bn, Hn, generator=gen).to(dev)
               for _ in range(2)]
        with full_fp32():
            ys = gru_mod.gru_scan_bidir_plain(*xp, *wh, mask)
            ysp = [gru_mod.prev_states(y, False) for y in ys]
            bargs = (xp[0], xp[1], *ysp, wh[0], wh[1], mask, *dys)
            n0 = gru_mod.gru_scan_bidir_bwd.launches
            got = gru_mod.gru_scan_bidir_bwd(*bargs)
            launches = gru_mod.gru_scan_bidir_bwd.launches - n0
            want = gru_mod.gru_scan_bidir_bwd_plain(*bargs)
        errs = [(a - r).abs().max().item() for a, r in zip(got, want)]
        tols = [1e-4 * r.abs().max().item() for r in want]
        again = gru_mod.gru_scan_bidir_bwd(*bargs)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        msg = (f"[3 K7b] gru_scan_bidir_bwd T={Tn} B={Bn} H={Hn}: dxpf, "
               f"dxpb, dwhf, dwhb max_abs_err "
               f"{', '.join(f'{e:.3e}' for e in errs)} (tol "
               f"{', '.join(f'{t:.3e}' for t in tols)}); two calls equal "
               f"bit for bit {same}; {launches} count(s) a call")
        timing = ()
        if Tn == T:
            ms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd(*bargs), 10)
            bd = bound(nbytes(*bargs, *got), 6 * 2 * Tn * Bn * Hn * 3 * Hn,
                       "fp32")
            lib = library_gru_ms(Tn, Bn, D, Hn, torch.float32, True,
                                 bidirectional=True)
            msg += (f"; kernel {ms:.3f} ms bound {bd[0]:.4f} ms ({bd[1]}) "
                    f"torch.nn.GRU bidirectional backward {lib:.3f} ms; "
                    f"faster: {ms < lib}; "
                    f"{bwd_phases(gru_mod, 'K7b', bargs)}")
            if Bn == TRAIN_B:
                with full_fp32():
                    pms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd_plain(
                        *bargs), 2)
                msg += f"; plain {pms:.3f} ms"
                timing = (ms, pms, bd, lib)
        phase(msg)
        if not (all(e <= t for e, t in zip(errs, tols)) and same):
            fail(f"K7b at B={Bn} H={Hn} disagrees with its plain version")
        record("K7b", "gru_scan_bidir_bwd", "tpuasr_torch/csrc/gru_lean.cu",
               "tpuasr/ops/pallas_gru.py:437", max(errs), *timing)
        del xp, ys, ysp, dys, bargs, got, again, want
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
            again = kern()
            err = (got - ref).abs().max().item()
            ok = bool(torch.allclose(got, ref, rtol=2e-5, atol=2e-6))
            ms = cuda_ms(kern, 10)
            save_ms = cuda_ms(lambda: routing_mod.routing_residuals(
                u, W, O, D, iters), 10)
            pms = cuda_ms(plain, 3)
        # Operations the function needs: u_hat, then the weighted sum in
        # every iteration and the agreement in all but the last
        # (tpuasr/models/capsnet.py:42-52); bytes: u and W in, v out.
        ops = Bc * T * (2 * Din * O * D * I + (4 * iters - 2) * O * D * I)
        bd = bound(nbytes(u, W, got), ops, "fp32")
        plan = routing_mod.routing_plan(Bc * T, I, Din, O, D)
        clusters = routing_mod.max_active_clusters(Bc * T, I, Din, O, D)
        phase(f"[3 K8] routed_caps B={Bc} T={T} I={I} Din={Din} O={O} D={D}"
              f" iters={iters} ({Bc * T} rows): max_abs_err {err:.3e} (tol "
              f"rtol 2e-5 atol 2e-6; |v| max {ref.abs().max().item():.3f}) "
              f"kernel {ms:.3f} ms, saving V and s {save_ms:.3f} ms (+"
              f"{save_ms - ms:.3f}) plain {pms:.3f} ms bound {bd[0]:.4f} ms "
              f"({bd[1]}); no PyTorch call computes it; plan: {plan.tiles} "
              f"tiles of {plan.rows} rows, clusters of {plan.cluster} CTAs "
              f"x {plan.threads} threads, {plan.stages} stages, "
              f"{plan.smem} B shared; {clusters} clusters at once "
              f"(cudaOccupancyMaxActiveClusters)")
        if not ok:
            fail(f"K8 disagrees with its plain version at B={Bc}")
        if not torch.equal(got, again):
            fail(f"K8: two calls differ at B={Bc}")
        record("K8", "routed_caps (routing forward)",
               "tpuasr_torch/csrc/routing.cu",
               "tpuasr/ops/pallas_routing.py:161", err,
               *((ms, pms, bd) if timed else ()))
        del got, ref, again

        # K8b: du and dW each within K8B_TOL of its largest magnitude, from
        # K8's saved V and s (the train step's route) and standalone from
        # (u, W, dv), which must give the same bits; and two calls the same.
        with full_fp32():
            _, V, sv = routing_mod.routing_residuals(u, W, O, D, iters)

            def kern_res():
                return routing_mod.routed_caps_bwd_from(u, W, V, sv, dv, O,
                                                        D)

            got, ref = kern_res(), plain_bwd()
            again, alone = kern_res(), kern_bwd()
            errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
            tops = [r.abs().max().item() for r in ref]
            ms = cuda_ms(kern_res, 10)
            alone_ms = cuda_ms(kern_bwd, 10)
            torch.cuda.reset_peak_memory_stats()
            pms = cuda_ms(plain_bwd, 2)
            plain_gb = torch.cuda.max_memory_allocated() / 1e9
        # Operations the gradient needs per row from V and s: u_hat, b,
        # du_hat, du and dW; bytes: u, W, V, s and dv in, du and dW out.
        ops = Bc * T * (6 * Din + 3) * O * D * I
        bd = bound(nbytes(u, W, V, sv, dv, *got), ops, "fp32")
        phase(f"[3 K8b] routed_caps_bwd B={Bc}: du max_abs_err {errs[0]:.3e}"
              f" of |du| max {tops[0]:.3e} (rel {errs[0] / tops[0]:.2e}), dW "
              f"{errs[1]:.3e} of {tops[1]:.3e} (rel {errs[1] / tops[1]:.2e};"
              f" tol {K8B_TOL:g} of each) kernel from saved V and s "
              f"{ms:.3f} ms, standalone (K8 saving, then K8b) {alone_ms:.3f}"
              f" ms; plain {pms:.3f} ms (peak memory {plain_gb:.2f} GB) "
              f"bound {bd[0]:.4f} ms ({bd[1]}); no PyTorch call computes it")
        if not all(e <= K8B_TOL * t for e, t in zip(errs, tops)):
            fail(f"K8b disagrees with its plain version at B={Bc}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K8b: two calls differ at B={Bc}")
        if not all(torch.equal(a, b) for a, b in zip(got, alone)):
            fail(f"K8b from saved V and s differs from the standalone "
                 f"routed_caps_bwd at B={Bc}")
        record("K8b", "routed_caps_bwd (routing backward)",
               "tpuasr_torch/csrc/routing_bwd.cu",
               "tpuasr/ops/pallas_routing.py:180", max(errs),
               *((ms, pms, bd) if timed else ()))
        del V, sv, again, alone
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
    want = {arm: dict(none, K1=1, K8=1,
                      **({"K3": 1, "K3-backtrack": 1} if dec == "beam"
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
                wrappers, card, prepare=None, check=None,
                entries=None, tol=1e-4) -> dict:
    """A train step through Trainer on the card, on a batch of seeded noise
    (sizes[0] utterances of TRAIN_SECONDS, U tokens each): the launch counts
    of one step (which must equal want; the counts of the kernels in count
    are kept), step 1 against the plain path (patches) within rtol tol on
    the same weights and dropout stream, the loss over 10 more steps on the
    repeated batch, and train-step ms at each batch size in sizes. The
    launches of the wrappers in count add to their kernel entries, or to
    the entry that entries names for a wrapper.
    prepare(model) adjusts the seeded weights in place; check(trainer,
    batch, fresh_state, metrics, plain_path) adds checks of step 1, where
    fresh_state() gives a state with step 1's weights. Returns {batch: (ms
    a step, device time by kernel)}."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import Trainer

    S = int(SR * TRAIN_SECONDS)
    entries = entries or {}

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
        kernels[entries.get(k, k)]["launches"] += counts[k]

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
          f"differences {rel['loss']:.3e} {rel['grad_norm']:.3e} (tol "
          f"{tol:.3e})")
    if not (all(np.isfinite(list(got.values())))
            and max(rel.values()) <= tol):
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
    kw = cfg.model_kwargs
    dtype = ("bf16" if cfg.bf16_compute or kw.get("bf16_gru")
             or kw.get("bf16_conv") else "f32")
    times = {}
    for n, ms_n, tr, st, bt in results:
        phase(f"[{tag}] B={n} x {TRAIN_SECONDS:.0f} s {dtype}: train step "
              f"{ms_n:.2f} ms (CUDA events, mean of 10 after a warm-up) = "
              f"{n / (ms_n / 1e3):.1f} utt/s [{card}]")
        rows = device_breakdown(lambda: tr.train_step(st, bt), top=8)
        phase(f"[{tag}] B={n} device time of one step by kernel "
              f"(torch.profiler): {rows}")
        times[n] = (ms_n, rows)
    torch.cuda.synchronize()
    return times


def train_slice(kernels, wrappers, card) -> dict:
    """Phase 7: config 3's train step through Trainer on the card (the 512
    x 4 DeepSpeechCTC in float32, adamw, B=16 and 64 x 5 s, U=24). Returns
    the f32 step's {batch: (ms, device time by kernel)}."""
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.train import TrainConfig

    cfg = TrainConfig(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                      warmup_steps=1,
                      model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                        pallas_gru=True))
    counted = dict(K5=2 * LAYERS, K5b=2 * LAYERS, K6=1, K6b=1)
    ctc_patches = ((ctc_mod, "ctc_forward", ctc_mod.ctc_forward_plain),
                   (ctc_mod, "ctc_backward", ctc_mod.ctc_backward_plain))
    patches = ((gru_mod, "gru_scan_fwd", gru_mod.gru_scan_plain),
               (gru_mod, "gru_scan_bwd", gru_mod.gru_scan_bwd_plain),
               *ctc_patches)
    f32_times = train_phase("7 train", cfg, TRAIN_U, (TRAIN_B, 64), counted,
                            counted, patches, kernels, wrappers, card)
    # The same step with fused_bidir=True: K7 (in f32: the K7-f32 entry)
    # and K7b once per layer, no K5/K5b.
    cfg = dataclasses.replace(cfg, model_kwargs=dict(cfg.model_kwargs,
                                                     fused_bidir=True))
    patches = ((gru_mod, "gru_scan_bidir_fwd", gru_mod.gru_scan_bidir_plain),
               (gru_mod, "gru_scan_bidir_bwd",
                gru_mod.gru_scan_bidir_bwd_plain), *ctc_patches)
    train_phase("7 train fused_bidir", cfg, TRAIN_U, (TRAIN_B, 64, 128),
                dict(K7=LAYERS, K7b=LAYERS, K6=1, K6b=1), ("K7", "K7b"),
                patches, kernels, wrappers, card, entries={"K7": "K7-f32"})
    return f32_times


def var_train_slice(kernels, wrappers, card) -> None:
    """Phase 9: the deepspeech_var preset's train step through Trainer on
    the card (tpuasr/utils/params.py:13-16: 384 x 6, conv 32, dropout 0.1,
    adamw 3e-4, clip 5; trained with the Pallas GRU and the fused
    projection, tpuasr/cli/batch_train.py:91-101), float32, 64 classes and
    64 mels, at config 3's batch (B=16 and 64 x 5 s, U=24). JAX's rule takes
    K2b for every GRU direction of this model; the step runs a second time
    with the rule forced to the recompute route (K5b between matmuls), so
    that the two backwards stand side by side."""
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.models import layers as layers_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.train import TrainConfig
    from tpuasr_torch.utils.params import preset_for

    kwargs, train = preset_for("deepspeech_var")
    cfg = TrainConfig(model="deepspeech_var", num_classes=NUM_CLASSES,
                      warmup_steps=1, **train,
                      model_kwargs=dict(kwargs, pallas_gru=True,
                                        fused_proj=True))
    dirs = 2 * kwargs["rnn_layers"]
    patches = ((layers_mod, "gru_scan_xfused", gru_mod.gru_scan_xfused_plain),
               (ctc_mod, "ctc_forward", ctc_mod.ctc_forward_plain),
               (ctc_mod, "ctc_backward", ctc_mod.ctc_backward_plain))
    train_phase("9 train deepspeech_var", cfg, TRAIN_U, (TRAIN_B, 64),
                dict(K2=dirs, K2b=dirs, K6=1, K6b=1), ("K2", "K2b"), patches,
                kernels, wrappers, card, entries={"K2": "K2-f32"})
    with mock.patch.object(gru_mod, "xfused_bwd_is_fused",
                           lambda D, H: False):
        train_phase("9 train deepspeech_var recompute", cfg, TRAIN_U,
                    (TRAIN_B, 64), dict(K2=dirs, K5b=dirs, K6=1, K6b=1), (),
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
               (ctc_mod, "ctc_forward", ctc_mod.ctc_forward_plain),
               (ctc_mod, "ctc_backward", ctc_mod.ctc_backward_plain))

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


def resnet_train_slice(kernels, wrappers, card) -> None:
    """Phase 10: config 2's model trained through Trainer on the card at
    config 3's batch (B=16 x 5 s, U=24): ResNet-CTC at its preset in
    float32 (cuDNN's conv forward and backward, TF32 off), adamw 5e-4,
    clip 5; K6 and K6b once a step, the checks and timings of train_phase.
    Then once with dither=1.0: two first steps from the same seed give the
    same bits (the dithered features and the loss), and the loss differs
    from the undithered step's."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.train import TrainConfig, Trainer
    from tpuasr_torch.utils.params import preset_for

    kwargs, train = preset_for("resnet_ctc")
    cfg = TrainConfig(model="resnet_ctc", num_classes=NUM_CLASSES,
                      warmup_steps=1, model_kwargs=kwargs, **train)
    counted = dict(K6=1, K6b=1)
    patches = ((ctc_mod, "ctc_forward", ctc_mod.ctc_forward_plain),
               (ctc_mod, "ctc_backward", ctc_mod.ctc_backward_plain))

    def check(trainer, batch, fresh_state, got, plain_path):
        dtr = Trainer(cfg, FeatureConfig(dither=1.0), device="cuda")
        b = dtr._batch(batch)
        with torch.no_grad():
            f1 = dtr.featurizer.featurize(b["wav"], b["wav_lens"],
                                          dtr._step_generator(0, 1))[0]
            f2 = dtr.featurizer.featurize(b["wav"], b["wav_lens"],
                                          dtr._step_generator(0, 1))[0]
        runs = [dtr.train_step(fresh_state(), batch)[1] for _ in range(2)]
        same = torch.equal(f1, f2) and torch.equal(runs[0]["loss"],
                                                   runs[1]["loss"])
        loss = float(runs[0]["loss"])
        gn = [float(m["grad_norm"]) for m in runs]
        phase(f"[10 train resnet_ctc] dither 1.0: two first steps from the "
              f"same seed: dithered features and loss the same bits {same} "
              f"(loss {loss:.6f}; grad_norm {gn[0]:.6f}, {gn[1]:.6f}); "
              f"undithered loss {got['loss']:.6f}")
        if not (same and np.isfinite(loss) and loss != got["loss"]):
            fail("resnet_ctc train: dither is not reproducible from its "
                 "seed, or changes nothing")

    train_phase("10 train resnet_ctc", cfg, TRAIN_U, (TRAIN_B,), counted,
                counted, patches, kernels, wrappers, card, check=check)


# Phase 11: optax's state dict of chain(clip_by_global_norm, adamw) in
# MultiSteps (accum_steps 2), as flax's to_state_dict gives it in optax
# 0.2.6 (tuples as "0", "1", ... maps, namedtuples as maps of their fields,
# empty states as {}). "params" stands for a tree of the parameters' keys
# and shapes; None for an int32 0-d count.
ADAMW_ACCUM_LAYOUT = {
    "mini_step": None, "gradient_step": None,
    "inner_opt_state": {"0": {}, "1": {
        "0": {"count": None, "mu": "params", "nu": "params"},
        "1": {}, "2": {"count": None}}},
    "acc_grads": "params", "skip_state": {}}
# Phase 11's corpus: 64 synthetic utterances at 8 kHz, the last 8 the dev
# set; the vocabulary is the corpus's (8 units with the blank).
LOOP_UTTS, LOOP_DEV, LOOP_VOCAB = 64, 8, 8


def layout_errors(tree, layout, params, where="opt_state") -> list:
    """Where ``tree`` departs from ``layout`` (ADAMW_ACCUM_LAYOUT's form)."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(np.shape(t))

    if layout is None:
        ok = (isinstance(tree, np.ndarray) and tree.shape == ()
              and tree.dtype == np.int32)
        return [] if ok else [f"{where}: not an int32 count"]
    if layout == "params":
        return [] if shapes(tree) == shapes(params) else [
            f"{where}: not the parameters' tree"]
    if not isinstance(tree, dict) or list(tree) != list(layout):
        keys = list(tree) if isinstance(tree, dict) else type(tree).__name__
        return [f"{where}: keys {keys} != {list(layout)}"]
    return [e for k in layout
            for e in layout_errors(tree[k], layout[k], params,
                                   f"{where}/{k}")]


def leaf_diffs(a, b, where="") -> dict:
    """{path: max |a - b|} of the leaves of two checkpoint trees that are
    not bit for bit equal."""
    if isinstance(a, dict):
        out = {}
        for k in a:
            out.update(leaf_diffs(a[k], b[k], f"{where}/{k}"))
        return out
    a, b = np.asarray(a), np.asarray(b)
    if a.tobytes() == b.tobytes():
        return {}
    return {where: float(np.max(np.abs(a.astype(np.float64)
                                       - b.astype(np.float64))))}


def device_busy_ms(prof) -> float:
    """The union of the device's busy intervals (kernels, copies, fills)
    in a torch.profiler session, in ms (a schedule's ProfilerStep spans,
    which cover a step's idle gaps, left out)."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and e.time_range.end > e.time_range.start
        and "Loading" not in e.name and "Buffer Request" not in e.name
        and not e.name.startswith("ProfilerStep"))
    busy, end = 0.0, -np.inf
    for s0, s1 in spans:
        if s1 <= end:
            continue
        busy += s1 - max(s0, end)
        end = s1
    return busy / 1e3


def train_loop_slice(kernels, wrappers, card) -> None:
    """Phase 11: the training loop on the card through ``python -m
    tpuasr_torch.cli.batch_train`` (in this process): config 3's model at
    full width (the deepspeech_ctc preset: 512 x 4 BiGRU, float32, adamw
    3e-4, clip 5) at batch 16, with the fused featurizer, SpecAugment,
    accumulation over 2 micro-batches and the device-resident corpus, on a
    synthetic corpus; its checkpoints, two straight runs against each
    other and a resumed run against a straight one (bit for bit, cuDNN's
    switch unset), ``test --checkpoint`` against
    ``Trainer.evaluate``, and the epoch loop's time at config 3's lengths
    with and without the prefetch thread."""
    from tpuasr_torch.cli import batch_train
    from tpuasr_torch.cli import test as cli_test
    from tpuasr_torch.data import (AudioLoader, LoaderConfig,
                                   make_synthetic_corpus, read_manifest,
                                   write_manifest)
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import TrainConfig, Trainer
    from tpuasr_torch.train.checkpoints import (latest_checkpoint,
                                                restore_checkpoint)
    from tpuasr_torch.utils.msgpack import unpackb
    from tpuasr_torch.utils.params import preset_for

    tmp = Path(tempfile.mkdtemp(prefix="tpuasr_loop_"))
    corpus = make_synthetic_corpus(tmp / "c", num_utts=LOOP_UTTS,
                                   vocab_size=LOOP_VOCAB, seed=SEED)
    utts = read_manifest(corpus.manifest)
    write_manifest(tmp / "train.jsonl", utts[:-LOOP_DEV])
    write_manifest(tmp / "dev.jsonl", utts[-LOOP_DEV:])
    units = str(corpus.root / "units.txt")
    steps = len(AudioLoader(tmp / "train.jsonl",
                            LoaderConfig(batch_size=TRAIN_B)).batch_plan(0))
    every = 1
    common = ["deepspeech_ctc", "--train-manifest", str(tmp / "train.jsonl"),
              "--dev-manifest", str(tmp / "dev.jsonl"), "--units", units,
              "--preset", "--fused-featurizer", "--spec-augment",
              "--accum-steps", "2", "--batch-size", str(TRAIN_B),
              "--log-every", "1", "--warmup-steps", "2",
              "--ckpt-every-steps", str(every), "--device", "cuda"]

    def train(name, *extra):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = batch_train.main([*common, "--log-dir", str(tmp / name),
                                   *extra])
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"[11] batch_train {name} rc={rc}")
        return time.perf_counter() - t0

    # The counted run of the loop: 2 epochs; the device corpus is caught
    # where the Trainer builds it.
    built = []
    orig = Trainer._device_corpus_for

    def spy(self, loader):
        dc = orig(self, loader)
        built.append(dc)
        return dc

    for w in wrappers.values():
        w.launches = 0
    with mock.patch.object(Trainer, "_device_corpus_for", spy):
        secs = train("a", "--num-epochs", "2")
    counts = {k: w.launches for k, w in wrappers.items()}
    phase(f"[11 loop] batch_train deepspeech_ctc --preset: 2 epochs of "
          f"{steps} steps (B={TRAIN_B}, {LOOP_UTTS - LOOP_DEV} utterances) "
          f"in {secs:.2f} s (host clock, set-up and dev evaluation "
          f"included); launch counts {json.dumps(counts)}")
    for key in ("K1", "K5", "K5b", "K6", "K6b"):
        if counts[key] == 0:
            fail(f"[11] kernel {key} was not launched by the training loop")
    for key, n in counts.items():
        entry = {"K2": "K2-f32"}.get(key, key)
        kernels[entry]["launches"] += n
    dc = built[0] if built else None
    if dc is None or not all(t.is_cuda for st in dc._stores.values()
                             for t in st.values()):
        fail("[11] the corpus store is not on the device")
    phase(f"[11 loop] device-resident corpus: {len(dc._stores)} buckets, "
          f"{dc.nbytes / 2**20:.2f} MiB on {dc.device}")

    with open(tmp / "a" / "metrics.csv") as f:
        rows = [(int(st), n, float(v))
                for st, n, v in list(csv.reader(f))[1:]]
    losses = [v for _, n, v in rows if n == "train/loss"]
    names = {n for _, n, _ in rows}
    dev_rows = [(st, n, round(v, 4)) for st, n, v in rows
                if n.startswith("dev")]
    phase(f"[11 loop] train/loss by step: "
          f"{', '.join(f'{v:.3f}' for v in losses)}; dev rows {dev_rows}")
    if not (len(losses) == 2 * steps and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        fail("[11] the logged losses are not all finite or did not fall")
    if not {"train/loss", "dev/loss", "dev/ter"} <= names:
        fail(f"[11] metrics.csv lacks train or dev rows: {names}")
    saved = sorted({s for s in range(1, 2 * steps + 1) if s % every == 0}
                   | {2 * steps})[-5:]
    got = sorted(p.name for p in (tmp / "a" / "ckpt").iterdir())
    want = sorted(f"ckpt_{s:08d}.{x}" for s in saved for x in ("json",
                                                               "msgpack"))
    if got != want:
        fail(f"[11] checkpoints {got} != {want} (keep=5)")
    errs = []
    for p in sorted((tmp / "a" / "ckpt").glob("*.msgpack")):
        tree = unpackb(p.read_bytes())
        errs += layout_errors(tree["opt_state"], ADAMW_ACCUM_LAYOUT,
                              tree["params"], p.name)
    if errs:
        fail(f"[11] optimizer state not in optax's layout: {errs[:5]}")
    phase(f"[11 loop] {len(saved)} checkpoints kept (steps "
          f"{', '.join(map(str, saved))}), each opt_state in optax's "
          "MultiSteps(chain(clip, adamw)) layout")

    # Determinism, then resume, both bit for bit with cuDNN's switch left
    # as the caller has it (unset): the convs' backward takes cuDNN's
    # deterministic algorithms itself (models/layers.py::_Conv2d). A
    # second straight run against the first; then a run of one epoch, and
    # that run's final checkpoint (epoch 1, the middle of the straight run)
    # resumed for the second epoch, against the first straight run. JAX's
    # resume restarts the saved epoch from its first batch, so only a
    # checkpoint written at an epoch's end (the final one, whose meta names
    # the next epoch) continues the straight run batch for batch.
    def final(name):
        return unpackb(latest_checkpoint(tmp / name / "ckpt").read_bytes())

    if torch.backends.cudnn.deterministic:
        fail("[11] torch.backends.cudnn.deterministic is set: the gate is "
             "for the step as callers run it")
    train("a2", "--num-epochs", "2")
    d_twice = leaf_diffs(final("a"), final("a2"))
    top = sorted(d_twice.items(), key=lambda kv: -kv[1])[:8]
    phase(f"[11 determinism] two straight runs, cudnn.deterministic unset: "
          f"{len(d_twice)} leaves differ (largest {top}); gate: bit for bit")
    if d_twice:
        fail(f"[11] two straight runs differ: {top}")
    train("b", "--num-epochs", "1")
    train("c", "--num-epochs", "2", "--continue-from",
          str(tmp / "b" / "ckpt"))
    fs, fc = final("a"), final("c")
    if not (int(fs["step"]) == int(fc["step"]) == 2 * steps):
        fail(f"[11] final steps {int(fs['step'])} {int(fc['step'])}")
    d_resume = leaf_diffs(fs, fc)
    phase(f"[11 resume] step {int(fc['step'])}, cudnn.deterministic unset: "
          f"the resumed run against the straight run: {len(d_resume)} leaves "
          f"differ (max {max(d_resume.values(), default=0.0):.3e}); gate: "
          "bit for bit")
    if d_resume:
        fail(f"[11] resume: {sorted(d_resume.items())[:8]}")

    # test --checkpoint against Trainer.evaluate on the same manifest.
    kwargs, overrides = preset_for("deepspeech_ctc")
    cfg = TrainConfig(model="deepspeech_ctc", num_classes=LOOP_VOCAB,
                      model_kwargs=kwargs, fused_featurizer=True,
                      spec_augment=True, accum_steps=2, **overrides)
    feat = FeatureConfig()
    tr = Trainer(cfg, feat, device="cuda")
    tree, _ = restore_checkpoint(tmp / "a" / "ckpt")
    state = tr.load_state_tree(tr.init_state(), tree)
    ev = tr.evaluate(state, AudioLoader(
        tmp / "dev.jsonl", LoaderConfig(batch_size=TRAIN_B, shuffle=False)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_test.main(["deepspeech_ctc", "--manifest",
                            str(tmp / "dev.jsonl"), "--checkpoint",
                            str(tmp / "a" / "ckpt"), "--units", units,
                            "--device", "cuda", "--batch-size",
                            str(TRAIN_B)])
    lines = out.getvalue().strip().splitlines()
    names_u = Path(units).read_text().splitlines()
    want_h = {k: " ".join(names_u[t] for t in v)
              for k, v in ev["hyps"].items()}
    got_h = dict(ln.split("\t") for ln in lines[:-1])
    phase(f"[11 test --checkpoint] rc={rc}: {lines[-1]}; Trainer.evaluate "
          f"ter {ev['ter']:.4f}, loss {ev['loss']:.4f}; hypotheses equal: "
          f"{got_h == want_h}")
    if rc != 0 or got_h != want_h or len(got_h) != LOOP_DEV:
        fail(f"[11] test --checkpoint {got_h} != evaluate {want_h}")

    # The epoch loop's time at config 3's lengths: 56 utterances of 5-15 s
    # (tones of 1 s), read anew every epoch (cache_bytes=0, as a corpus
    # larger than the loader's cache is), from the device corpus, and
    # streamed with the prefetch thread and without it, in turns (each turn
    # a warm-up epoch, then 2 timed epochs), then one profiled epoch each.
    from torch.profiler import ProfilerActivity, profile
    long = make_synthetic_corpus(tmp / "long", num_utts=LOOP_UTTS - LOOP_DEV,
                                 vocab_size=LOOP_VOCAB, min_tokens=5,
                                 max_tokens=15, tone_ms=1000.0,
                                 seed=SEED + 1)
    loader = AudioLoader(long.manifest, LoaderConfig(batch_size=TRAIN_B,
                                                     cache_bytes=0))
    long_s = sum(u.num_samples for u in read_manifest(long.manifest)) / SR
    state = tr.init_state()
    modes = {"device corpus": ("auto", 2),
             "streaming, prefetch 2": (False, 2),
             "streaming, prefetch 0": (False, 0)}
    next_epoch = 0

    def epochs(label, count):
        nonlocal state, next_epoch
        tr.cfg.device_corpus, tr.cfg.prefetch = modes[label]
        n = k = 0
        for _ in range(count):
            for n_real, batch in tr._epoch_batches(loader, next_epoch):
                state, _ = tr.train_step(state, batch)
                n, k = n + n_real, k + 1
            next_epoch += 1
        torch.cuda.synchronize()
        return n, k

    turns = {label: [] for label in modes}
    for label in [*modes, *reversed(modes)]:
        epochs(label, 1)
        t0 = time.perf_counter()
        n, k = epochs(label, 2)
        turns[label].append((time.perf_counter() - t0, n, k))
    for label in modes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, k = epochs(label, 1)
            wall_p = time.perf_counter() - t0
        busy = device_busy_ms(prof) / k
        steps_ms = [w * 1e3 / k_ for w, _, k_ in turns[label]]
        rate = ", ".join(f"{n_ / w:.1f}" for w, n_, _ in turns[label])
        phase(f"[11 loop time] {label}, {LOOP_UTTS - LOOP_DEV} utterances "
              f"of 5-15 s ({long_s:.1f} s of audio): ms a step "
              f"{', '.join(f'{v:.2f}' for v in steps_ms)} (two turns of 2 "
              f"epochs, {turns[label][0][2]} steps, host clock), {rate} "
              f"utt/s; one epoch under torch.profiler: wall "
              f"{wall_p * 1e3 / k:.2f} ms a step, device busy {busy:.2f} "
              f"ms a step, idle {100 * (1 - busy * k / (wall_p * 1e3)):.1f}%"
              f" of that wall, {100 * (1 - busy / np.mean(steps_ms)):.1f}% "
              f"of the turns' mean [{card}]")
    shutil.rmtree(tmp, ignore_errors=True)


def cli_test_requests(tmp, model, feat_cfg, dev) -> None:
    """Phase 6 for config 2's scoring: python -m tpuasr_torch.cli.test
    resnet_ctc over a manifest of 8 wavs with transcripts written to tmp
    (with the weights tmp/resnet.npz and units tmp/units.txt of model),
    greedy and with the beam; its WER must be utils.metrics.wer over
    Recognizer's hypotheses of the same batches."""
    from scipy.io import wavfile
    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.cli.common import out_frames
    from tpuasr_torch.data import (AudioLoader, LoaderConfig, Utterance,
                                   write_manifest)
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.serve.offline import Recognizer
    from tpuasr_torch.utils.metrics import wer

    rng = np.random.default_rng(SEED + 12)
    utts = []
    for i in range(8):
        n = int(rng.integers(int(SR * 1.5), int(SR * 4.0)))
        p = tmp / f"dev{i}.wav"
        wavfile.write(p, SR, (rng.standard_normal(n) * 3000)
                      .astype(np.int16))
        toks = rng.integers(1, NUM_CLASSES, int(rng.integers(3, 12)))
        utts.append(Utterance(id=f"dev{i}", wav=p.name,
                              tokens=toks.tolist(),
                              text=" ".join(UNITS[t] for t in toks),
                              num_samples=n))
    write_manifest(tmp / "dev.jsonl", utts)
    for dec in ("greedy", "beam"):
        argv = ["resnet_ctc", "--manifest", str(tmp / "dev.jsonl"),
                "--checkpoint", str(tmp / "resnet.npz"), "--units",
                str(tmp / "units.txt"), "--batch-size", "4",
                "--device", "cuda"]
        if dec == "beam":
            argv += ["--beam", "--beam-width", str(BEAM)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = test_cli.main(argv)
        lines = buf.getvalue().strip().splitlines()
        secs = time.perf_counter() - t0
        refs, hyps = [], []
        loader = AudioLoader(tmp / "dev.jsonl",
                             LoaderConfig(batch_size=4, shuffle=False))
        for batch in loader:
            S_b = batch["wav"].shape[1]
            cfg = (None if dec == "greedy" else BeamSearchConfig(
                beam_width=BEAM, max_len=out_frames(
                    feat_cfg, S_b, model)))
            out = Recognizer(model, feat_cfg, cfg, dev)(
                batch["wav"], batch["wav_lens"])
            for j in np.flatnonzero(batch["real"]):
                refs.append(batch["tokens"][j][:batch["token_lens"][j]]
                            .tolist())
                hyps.append(out["tokens"][j, 0][:int(
                    out["token_lens"][j, 0])].tolist())
        want = f"utterances: 8  token-error-rate: {wer(refs, hyps):.4f}"
        phase(f"[6 cli test.py resnet_ctc {dec}] rc={rc}, "
              f"{len(lines) - 1} hypotheses, '{lines[-1] if lines else ''}'"
              f" in {secs:.2f} s (host clock, load included); "
              f"utils.metrics.wer over Recognizer's hypotheses: '{want}'")
        if rc != 0 or len(lines) != 9 or lines[-1] != want:
            fail(f"test.py resnet_ctc {dec}: {lines[-2:]} != {want}")


def wide_range_wav(n: int, S: int, sr: int, db: float = 90.0) -> np.ndarray:
    """n utterances of a 1 kHz tone of amplitude 0.5 plus white noise db
    below it (tests/test_torch_fbank_plan.py::wide_range_signal)."""
    rng = np.random.default_rng(SEED)
    t = np.arange(S) / sr
    return (0.5 * np.sin(2 * np.pi * 1000.0 * t)[None]
            + 0.5 * 10 ** (-db / 20) * rng.standard_normal((n, S))
            ).astype(np.float32)


def stft_mel_ms(wav, tabs, cfg, T) -> float:
    """ms of the cuFFT pipeline for the same function: torch.stft with the
    window zero-padded to n_fft, center=False, the wav padded so that the
    last frame fits, then the power, then @ proj. A yardstick only: the
    port never calls it, and it is several calls."""
    n_fft, hop = cfg.fft_size, cfg.hop_length
    window = torch.nn.functional.pad(tabs["window"],
                                     (0, n_fft - cfg.win_length))
    pad = max(0, (T - 1) * hop + n_fft - wav.shape[1])

    def run():
        x = torch.nn.functional.pad(wav, (0, pad))
        spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft,
                          window=window, center=False, return_complex=True)
        p = spec.real ** 2 + spec.imag ** 2
        return p[:, :, :T].transpose(1, 2) @ tabs["proj"]

    return cuda_ms(run, 5)


def fbank_kernels(record, gen, dev) -> None:
    """K1 (8 kHz, B=128 x 10 s) and K1b (16 kHz, B=32): log-mel (after the
    log floor) within 1e-3 of the plain version, the JAX featurizer parity
    tolerance (tests/test_features_pallas.py:36); the kernel's split-TF32
    products (three a term, 22 bits) and the plain float32 matmuls lie about
    as far from a float64 rDFT (tools/fbank_time.py --precision), summed in
    other orders. Two calls the same bits; the plan;
    kernel, plain and cuFFT-pipeline times; the bound at float32 precision
    on the tensor cores (3 TF32 products a term at 495 TFLOP/s) and, beside
    it, the float32 FMA bound (67 TFLOP/s). Then the wide-range gate once:
    a tone with noise 90 dB below it, where one TF32 product would miss.
    Then the spectrogram at full size (8 kHz B=16 and 16 kHz B=8 x 10 s)
    against a float64 rDFT: its single bins near a spectral null are where
    rounding shows most, and the plain float32 matmuls themselves lie
    ~2-3e-3 from float64 there, more than the 1e-3 gate against the plain
    version allows. Split TF32 keeps 22 of float32's 24 bits of each
    operand, a unit roundoff 4x float32's, so the kernel is held to lie at
    most 4x as far from float64 as the plain version does."""
    from tpuasr_torch.features import FeatureConfig, fbank_power
    from tpuasr_torch.features import fused as fused_mod
    from tpuasr_torch.features.reference import (feature_tables,
                                                 frames_plain, num_frames)
    tol = 1e-3
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def log_err(a, b, floor):
        return (torch.log(a.clamp(min=floor))
                - torch.log(b.clamp(min=floor))).abs().max().item()

    for sr, nb, key, line in ((8000, B, "K1", 109), (16000, 32, "K1b", 137)):
        cfg = FeatureConfig(sample_rate=sr)
        tabs = feature_tables(cfg, dev)
        tabs["packed"] = fused_mod.pack_tables(tabs)
        S = int(sr * SECONDS)
        T = num_frames(cfg, S)
        wav = (torch.randn(nb, S, generator=gen) * 0.1).to(dev)
        hop, win = cfg.hop_length, cfg.win_length
        nf, nm = tabs["cos"].shape[1], tabs["proj"].shape[1]
        plan = fused_mod.fbank_plan(nb, T, hop, win, nf, nm, n_sm,
                                    tabs["packed"]["nyq"] >= 0)
        got = fbank_power(wav, tabs, hop, T)
        same = torch.equal(got, fbank_power(wav, tabs, hop, T))
        ref = fused_mod.fbank_power_plain(wav, tabs, hop, T)
        err = log_err(got, ref, cfg.log_floor)
        ms = cuda_ms(lambda: fbank_power(wav, tabs, hop, T), 20)
        pms = cuda_ms(lambda: fused_mod.fbank_power_plain(wav, tabs, hop, T),
                      5)
        fft_ms = stft_mel_ms(wav, tabs, cfg, T)
        flops = 2 * nb * T * (2 * win * nf + nf * nm)
        tables = ("dft_wg", "mel_wg") if plan.M == 64 else ("dft", "mel")
        moved = nbytes(wav, got, tabs["packed"]["window"],
                       *(tabs["packed"][k] for k in tables))
        bd = bound(moved, 3 * flops, "tf32")
        bd32 = bound(moved, flops, "fp32")
        phase(f"[3 {key}] fbank {sr} Hz B={nb} T={T} win={win} hop={hop}: "
              f"plan M={plan.M} ({'wgmma' if plan.M == 64 else 'mma.sync'}) "
              f"stages={plan.stages} of {plan.stage_k} rDFT k-steps, rDFT "
              f"{plan.dft_chunks} "
              f"chunk(s) of {plan.dft_nt} n-tiles, mel {plan.mel_chunks} of "
              f"{plan.mel_nt}, smem {plan.smem} B, grid {plan.grid}; log-mel "
              f"max_abs_err {err:.3e} (tol {tol}); two calls equal bit for "
              f"bit {same}; kernel {ms:.4f} ms plain {pms:.4f} ms cuFFT "
              f"pipeline {fft_ms:.4f} ms")
        phase(f"[3 {key}] bound {bd[0]:.4f} ms ({bd[1]}: 3 x "
              f"{flops / 1e9:.2f} GFLOP in TF32 at 495 TFLOP/s; "
              f"{moved / 1e6:.1f} MB {moved / HBM_BPS * 1e3:.4f} ms); float32 "
              f"FMA bound {bd32[0]:.4f} ms; kernel at {ms / bd[0]:.2f}x its "
              "bound; no single PyTorch call computes it")
        if not err <= tol:
            fail(f"fbank kernel disagrees at {sr} Hz: {err} > {tol}")
        if not same:
            fail(f"fbank kernel: two calls differ at {sr} Hz")
        record(key, "fbank_power" + ("" if key == "K1" else
                                     " (16 kHz, hop > 128 lanes)"),
               "tpuasr_torch/csrc/fbank.cu",
               f"tpuasr/features/pallas_fused.py:{line}", err, ms, pms, bd)

    cfg = FeatureConfig()
    tabs = feature_tables(cfg, dev)
    S = int(SR * SECONDS)
    T = num_frames(cfg, S)
    wav = torch.as_tensor(wide_range_wav(8, S, SR), device=dev)
    got = fbank_power(wav, tabs, cfg.hop_length, T)
    ref = fused_mod.fbank_power_plain(wav, tabs, cfg.hop_length, T)
    err = log_err(got, ref, cfg.log_floor)
    lo = torch.log(ref.clamp(min=cfg.log_floor))
    phase(f"[3 K1] wide range (1 kHz tone, noise 90 dB below, B=8 x 10 s): "
          f"log-mel from {lo.min().item():.2f} to {lo.max().item():.2f}, "
          f"max_abs_err {err:.3e} (tol {tol})")
    if not err <= tol:
        fail(f"fbank kernel disagrees on the wide-range signal: {err} > "
             f"{tol}")
    record("K1", "fbank_power", "tpuasr_torch/csrc/fbank.cu",
           "tpuasr/features/pallas_fused.py:109", err)

    g64 = torch.Generator().manual_seed(SEED)
    for sr, nb in ((8000, 16), (16000, 8)):
        cfg = FeatureConfig(sample_rate=sr, feature_type="spectrogram")
        tabs = feature_tables(cfg, dev)
        S = int(sr * SECONDS)
        T = num_frames(cfg, S)
        wav = (torch.randn(nb, S, generator=g64) * 0.1).to(dev)
        got = fbank_power(wav, tabs, cfg.hop_length, T)
        ref = fused_mod.fbank_power_plain(wav, tabs, cfg.hop_length, T)
        t64 = {k: tabs[k].double() for k in ("window", "cos", "sin", "proj")}
        x = frames_plain(wav.double(), cfg.hop_length, cfg.win_length,
                         T) * t64["window"]
        exact = ((x @ t64["cos"]) ** 2 + (x @ t64["sin"]) ** 2) @ t64["proj"]
        got, ref = got.double(), ref.double()
        ek = log_err(got, exact, cfg.log_floor)
        ep = log_err(ref, exact, cfg.log_floor)
        phase(f"[3 K1] spectrogram {sr} Hz B={nb} x {SECONDS:g} s "
              f"({tabs['cos'].shape[1]} bins): largest log difference from "
              f"a float64 rDFT: kernel {ek:.3e}, plain {ep:.3e} (gate: the "
              f"kernel at most 4x the plain's); kernel-plain "
              f"{log_err(got, ref, cfg.log_floor):.3e}")
        if not ek <= 4 * ep:
            fail(f"fbank kernel's spectrogram at {sr} Hz lies more than 4x "
                 f"as far from float64 as the plain version: {ek} > 4 x "
                 f"{ep}")


def resnet_model(dev):
    """Config 2's ResNet-CTC at its preset, 64 classes, 64 mels, seeded."""
    from tpuasr_torch.models import create_model
    from tpuasr_torch.utils.params import preset_for

    return create_model("resnet_ctc", num_classes=NUM_CLASSES,
                        in_features=64, **preset_for("resnet_ctc")[0],
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(dev)


def resnet_slice(kernels, wrappers, card, plain_path) -> None:
    """Phase 4 for config 2: the ResNet-CTC arm through Recognizer, greedy
    (config 2's decode) and with the K3 beam (K=8), on B=128 x 10 s of
    seeded noise and on a ragged B=128 batch (5-10 s). Launch counts and
    cuDNN conv calls per batch; log-probs against the plain path (K1's
    plain version, the same model) within RESNET_TOL and against the AM
    alone on the same features; greedy token error rate against the plain
    path; x-real-time, wall against device time, device time by kernel;
    the conv stack's time against its float32 bound, counted from the
    conv calls' shapes in the counted run."""
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.precision import full_fp32
    from tpuasr_torch.serve.offline import Recognizer

    feat_cfg = FeatureConfig()
    model = resnet_model("cuda")
    S = int(SR * SECONDS)
    T_out = -(-num_frames(feat_cfg, S) // 2)
    bcfg = BeamSearchConfig(beam_width=BEAM, max_len=T_out)
    recs = {"greedy": Recognizer(model, feat_cfg, None, "cuda"),
            "beam": Recognizer(model, feat_cfg, bcfg, "cuda")}
    rng = np.random.default_rng(SEED + 11)
    wav = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    batches = {"B=128": (torch.as_tensor(wav, device="cuda"),
                         torch.full((B,), S, dtype=torch.int32,
                                    device="cuda"))}
    lens = rng.integers(S // 2, S + 1, size=B).astype(np.int32)
    lens[0] = S
    wav = wav.copy()
    wav[np.arange(S)[None, :] >= lens[:, None]] = 0.0
    batches["B=128 ragged"] = (torch.as_tensor(wav, device="cuda"),
                               torch.as_tensor(lens, device="cuda"))
    arms = {f"{dec} {b}": (dec, b) for b in batches
            for dec in ("greedy", "beam")}

    # The counted run of the ResNet path: one batch per arm; the cuDNN
    # convs (F.conv2d calls) counted beside the kernels, with their shapes.
    conv2d = torch.nn.functional.conv2d
    convs, flops, calls = {}, {}, []

    def counted_conv2d(x, w, *a, **k):
        out = conv2d(x, w, *a, **k)
        convs[arm] += 1
        flops[arm] += 2 * out.numel() * w[0].numel()
        if arm == "greedy B=128":
            calls.append((x, w, a, k))
        return out

    for w in wrappers.values():
        w.launches = 0
    per_arm, outs = {}, {}
    for arm, (dec, b) in arms.items():
        before = {k: w.launches for k, w in wrappers.items()}
        convs[arm] = flops[arm] = 0
        with mock.patch.object(torch.nn.functional, "conv2d",
                               counted_conv2d):
            outs[arm] = recs[dec](*batches[b])
        torch.cuda.synchronize()
        per_arm[arm] = {k: w.launches - before[k] for k, w in wrappers.items()}
    phase(f"[4 resnet] launch counts per batch: {json.dumps(per_arm)}; "
          f"cuDNN conv calls per batch: {json.dumps(convs)}")
    none = {k: 0 for k in wrappers}
    want = {arm: dict(none, K1=1, **({"K3": 1, "K3-backtrack": 1}
                                     if dec == "beam" else {}))
            for arm, (dec, _) in arms.items()}
    n_convs = 1 + sum(1 + 1 + (blk.proj is not None) for blk in (
        getattr(model, name) for name in model.blocks))
    if per_arm != want or set(convs.values()) != {n_convs}:
        fail(f"ResNet launch counts {per_arm} != {want} or conv calls "
             f"{convs} != {n_convs} each")
    for k in ("K1", "K3", "K3-backtrack"):
        kernels[k]["launches"] += sum(c[k] for c in per_arm.values())

    # Log-probs within RESNET_TOL of the whole plain path (K1's plain
    # version feeds the same model) and within 1e-4 of the AM alone on the
    # same features: both run the same fp32 convs.
    for arm, (dec, b) in arms.items():
        check_serving_arm(f"4 resnet {arm}", recs[dec], outs[arm],
                          *batches[b], T_out, wrappers, plain_path, card,
                          tol=RESNET_TOL, am_tol=1e-4, top=10,
                          timed=b == "B=128", plain_timed=dec == "greedy")

    # The conv stack of the counted greedy batch, alone, against its fp32
    # bound from the calls' shapes.
    rec = recs["greedy"]
    wav_d, lens_d = batches["B=128"]

    def conv_stack():
        for x, w, a, k in calls:
            conv2d(x, w, *a, **k)

    with torch.inference_mode():
        feats, flens = rec.featurizer.featurize(wav_d, lens_d)
        am_ms = cuda_ms(lambda: rec.model(feats, flens), 5)
        with full_fp32():
            conv_ms = cuda_ms(conv_stack, 5)
        # A yardstick the port does not use: the same convs in cuDNN's
        # TF32 (parity needs float32).
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        tf32_ms = cuda_ms(conv_stack, 5)
        torch.backends.cudnn.allow_tf32 = tf32
    arm = "greedy B=128"
    bd = flops[arm] / PEAK["fp32"] * 1e3
    phase(f"[4 resnet {arm}] the AM alone {am_ms:.3f} ms; its {len(calls)} "
          f"convs (cuDNN, fp32, TF32 off) {conv_ms:.3f} ms for "
          f"{flops[arm] / 1e12:.3f} TFLOP, fp32 bound {bd:.3f} ms at 67 "
          f"TFLOP/s: {bd / conv_ms:.3f} of it (the same convs in TF32, not "
          f"used: {tf32_ms:.3f} ms) [{card}]")
    del calls


def config1_featurizer(dev, card) -> int:
    """Phase 3 for BASELINE config 1 (benchmarks/config1_featparity.py):
    K1's MFCC route, FusedFeaturizer(mfcc) made with no device (the card),
    at B=128 x 10 s and at config 1's single utterance (B=1), against the
    plain Featurizer(mfcc) on the card: the route's log-mel within K1's
    1e-3 gate, and the MFCC within sqrt(n_mels) x 1e-3 (each DCT row has
    unit L2 norm over the 64 log-mel values); two calls the same bits; K1
    at B=1 timed beside its plain version. Then the plain Featurizer with
    torch framing, fbank and MFCC, against a float64 numpy/scipy reference
    of config 1's frames (rDFT, mel, log, scipy.fft.dct ortho). Returns
    K1's launches in the counted run of config 1's path (the MFCC
    featurizer at B=128, then at B=1)."""
    import scipy.fft
    from tpuasr_torch.features import (FeatureConfig, Featurizer,
                                       FusedFeaturizer, fbank_power)
    from tpuasr_torch.features import functional as F
    from tpuasr_torch.features import fused as fused_mod
    from tpuasr_torch.features.reference import num_frames

    tol = 1e-3
    cfg = FeatureConfig(feature_type="mfcc", cmn=False, cvn=False)
    S = int(SR * SECONDS)
    T = num_frames(cfg, S)
    rng = np.random.default_rng(SEED + 7)
    wav = torch.as_tensor((rng.standard_normal((B, S)) * 0.1)
                          .astype(np.float32), device=dev)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    fused, plain = FusedFeaturizer(cfg), Featurizer(cfg)
    if fused.device.type != "cuda" or plain.device.type != "cuda":
        fail("a featurizer made with no device is not on the card")

    # The counted run of config 1's path: B=128, then B=1.
    fbank_power.launches = 0
    with torch.inference_mode():
        got, glen = fused.featurize(wav, lens)
        got1, _ = fused.featurize(wav[:1], lens[:1])
    torch.cuda.synchronize()
    launches = fbank_power.launches
    if launches != 2:
        fail(f"config 1: the MFCC featurizer launched K1 {launches} times "
             "for two calls")
    with torch.inference_mode():
        ref, rlen = plain.featurize(wav, lens)
        ref1, _ = plain.featurize(wav[:1], lens[:1])
        same = torch.equal(got, fused.featurize(wav, lens)[0])
        floor = cfg.log_floor
        lm_k = torch.log(fbank_power(wav, fused.tables, cfg.hop_length, T)
                         .clamp(min=floor))
        lm_p = torch.log(fused_mod.fbank_power_plain(
            wav, fused.tables, cfg.hop_length, T).clamp(min=floor))
    lm_err = (lm_k - lm_p).abs().max().item()
    err = max((got - ref).abs().max().item(),
              (got1 - ref1).abs().max().item())
    mfcc_tol = tol * cfg.n_mels ** 0.5
    phase(f"[3 K1 mfcc] config 1's MFCC route B={B} x {SECONDS:g} s (T={T},"
          f" 13 coefficients): log-mel max_abs_err {lm_err:.3e} (tol {tol}),"
          f" MFCC max_abs_err vs plain Featurizer {err:.3e} (tol "
          f"{mfcc_tol:.1e}); frame lengths equal "
          f"{torch.equal(glen, rlen)}; two calls equal bit for bit {same}; "
          f"K1 launches in the counted run {launches}")
    if not (lm_err <= tol and err <= mfcc_tol and same
            and torch.equal(glen, rlen)):
        fail("config 1: the MFCC route disagrees with the plain featurizer")

    tabs = fused.tables
    w1 = wav[:1].contiguous()
    ms = queued_ms(lambda: fbank_power(w1, tabs, cfg.hop_length, T), 50)
    pms = queued_ms(lambda: fused_mod.fbank_power_plain(
        w1, tabs, cfg.hop_length, T), 50)
    with torch.inference_mode():
        fz_ms = cuda_ms(lambda: fused(w1), 20)
        pfz_ms = cuda_ms(lambda: plain(w1), 20)
    phase(f"[3 K1] config 1 single utterance B=1 x {SECONDS:g} s: kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms (device, queued); the whole MFCC"
          f" featurizer call {fz_ms:.3f} ms, plain {pfz_ms:.3f} ms (CUDA "
          f"events, mean of 20) [{card}]")

    t = np.arange(S) / SR
    x1 = (0.3 * np.sin(2 * np.pi * 440.0 * t)
          + 0.1 * rng.standard_normal(S)).astype(np.float32)
    devs = {}
    for ftype in ("fbank", "mfcc"):
        c = FeatureConfig(feature_type=ftype, frame_style="torch",
                          cmn=False, cvn=False)
        with torch.inference_mode():
            ours = Featurizer(c)(x1)[0].cpu().numpy().astype(np.float64)
        win = F.window_vector(c.window, c.win_length, c.periodic_window,
                              dtype=np.float64)
        off = (c.fft_size - c.win_length) // 2
        idx = (np.arange(ours.shape[0])[:, None] * c.hop_length + off
               + np.arange(c.win_length)[None, :])
        power = np.abs(np.fft.rfft(x1.astype(np.float64)[idx] * win,
                                   n=c.fft_size, axis=-1)) ** 2
        mel = power @ F.mel_filterbank(c.fft_size, c.n_mels, c.sample_rate,
                                       c.fmin, c.fmax, c.htk_mel,
                                       dtype=np.float64)
        want = np.log(np.maximum(mel, c.log_floor))
        if ftype == "mfcc":
            want = scipy.fft.dct(want, type=2, norm="ortho",
                                 axis=-1)[:, :c.n_mfcc]
        devs[ftype] = float(np.abs(ours - want).max())
    phase(f"[3 config1] torch framing, B=1 x {SECONDS:g} s (440 Hz tone + "
          f"noise), plain Featurizer on the card against a float64 numpy/"
          f"scipy reference: max abs deviation fbank {devs['fbank']:.3e}, "
          f"MFCC {devs['mfcc']:.3e} (tol {tol})")
    if not max(devs.values()) <= tol:
        fail(f"config 1: the featurizer deviates from float64 by {devs}")
    return launches


# Phase 12, config 6 (benchmarks/config6_streaming.py:26-42): 64 lockstep
# sessions of 100 ms chunks on the 512 x 4 unidirectional explicit-pad
# DeepSpeechCTC, 64 classes, 8 kHz, 64 mels, no CMVN; greedy and the beam
# (beam_width 8, class_topk 8); 2 warm-up ticks, then 30 timed. The solo
# stream is one utterance of STREAM_SECONDS. The seeded head is scaled by
# STREAM_HEAD_SCALE: at the init scale the top two log-probs of a frame lie
# close enough that the chunked and the whole-utterance computations,
# float32 sums in other orders, could flip a near tie. STREAM_TOL bounds
# the stream's log-probs against the offline model's on the same audio
# (both run K1, cuDNN's fp32 convs at other lengths, the GRU projection as
# a matmul against K2's f32 tiles): tighter than phase 4's 5e-2, as
# nothing here rounds to bf16 or int8. K5_H0_TOL bounds K5 from h0 against
# its plain version (the f32 GRU kernels' 1e-4).
STREAM_N = 64
STREAM_CHUNK = SR * 100 // 1000
STREAM_TICKS = 30
STREAM_WARMUP = 2
STREAM_SECONDS = 10.0
STREAM_HEAD_SCALE = 8.0
STREAM_TOL = 1e-3
K5_H0_TOL = 1e-4


def k5_from_h0(record, gru_mod, gen, card) -> None:
    """K5 (gru_scan_fwd) from a carried state h0 at the streaming tick's
    T'=5, B=64, H=512 and at T'=249, B=16: against gru_scan_plain from the
    same h0, and a run over two chunks (the second from the first's last
    state) against one run over the concatenated steps; the tick's shape
    timed with its bound, beside the plain version and cuDNN's GRU."""
    dev = torch.device("cuda")
    H = HIDDEN
    for Tn, Bn in ((5, STREAM_N), (249, TRAIN_B)):
        xp = torch.randn(2 * Tn, Bn, 3 * H, generator=gen).to(dev)
        wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).to(dev)
        h0 = (torch.randn(Bn, H, generator=gen) * 0.5).to(dev)
        mask = torch.ones(2 * Tn, Bn, 1, device=dev)
        whole = gru_mod.gru_scan_fwd(xp, wh, mask, h0=h0)
        want = gru_mod.gru_scan_plain(xp, wh, mask, h0=h0)
        first = gru_mod.gru_scan_fwd(xp[:Tn], wh, mask[:Tn], h0=h0)
        second = gru_mod.gru_scan_fwd(xp[Tn:], wh, mask[Tn:],
                                      h0=first[-1])
        chunked = torch.cat([first, second])
        err = (whole - want).abs().max().item()
        err_c = (chunked - whole).abs().max().item()
        timing = ""
        if Tn == 5:
            args = (xp[:Tn], wh, mask[:Tn])
            ms = queued_ms(lambda: gru_mod.gru_scan_fwd(*args, h0=h0), 50)
            pms = cuda_ms(lambda: gru_mod.gru_scan_plain(*args, h0=h0), 3)
            bd = bound(nbytes(*args, h0, whole[:Tn]),
                       2 * Tn * Bn * H * 3 * H, "fp32")
            lib = library_gru_ms(Tn, Bn, H, H, torch.float32, False, 20)
            timing = (f"; kernel {ms:.4f} ms a call (queued) plain "
                      f"{pms:.3f} ms bound {bd[0]:.5f} ms ({bd[1]}) "
                      f"torch.nn.GRU f32 {lib:.4f} ms (with its input "
                      f"projection) [{card}]")
        phase(f"[12 K5 h0] gru_scan_fwd from h0 T={2 * Tn} B={Bn} H={H}: "
              f"max_abs_err {err:.3e} (tol {K5_H0_TOL}); two chunks of "
              f"{Tn} (the second from the first's last state) against one "
              f"run: max_abs_err {err_c:.3e} (tol {K5_H0_TOL}), bit for bit "
              f"{torch.equal(chunked, whole)}{timing}")
        if not (err <= K5_H0_TOL and err_c <= K5_H0_TOL):
            fail(f"K5 from h0 disagrees at T={Tn} B={Bn}")
        record("K5", "gru_scan_fwd", "tpuasr_torch/csrc/gru_bidir.cu",
               "tpuasr/ops/pallas_gru.py:163", max(err, err_c))


def stream_model(dev):
    """Config 6's model: the unidirectional explicit-pad DeepSpeechCTC at
    full width, seeded, its head scaled by STREAM_HEAD_SCALE."""
    from tpuasr_torch.models import create_model

    model = create_model("deepspeech_ctc", num_classes=NUM_CLASSES,
                         rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                         bidirectional=False, explicit_pad=True,
                         in_features=64,
                         generator=torch.Generator().manual_seed(SEED + 6))
    with torch.no_grad():
        model.head.weight.mul_(STREAM_HEAD_SCALE)
    return model.to(dev)


def stream_tick_check(rec, tick, plain_path, record, dec) -> None:
    """One tick of the 64 slots from their carried state (queues, GRU
    states, beams after the timed ticks), its kernels held against their
    plain versions on the inputs the tick gives them: K1 on the tick's
    samples (log-mel within the fbank gate, 1e-3), K5 on each layer's xp
    from its carried h0 (K5_H0_TOL), the tick's log-probs against the same
    tick run by the plain path (plain_path, every kernel's plain version)
    from a copy of the state (STREAM_TOL; greedy tokens exact), and in beam
    mode K10 and K10-rebuild against scan_search_plain and
    rebuild_prefixes_plain from the tick's resumed beam state on the
    kernels' log-probs (phase 3's gates: tokens and the integer state,
    prefixes included, exact; scores within 1e-4)."""
    import copy

    from tpuasr_torch.decode import prefix_beam as pbm
    from tpuasr_torch.features import fused as fused_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.serve import streaming as streaming_mod

    s = rec._s
    memo = {id(m): m for m in s.model.modules()}
    memo[id(s.feat)] = s.feat
    twin = copy.deepcopy(rec, memo)
    seen = {k: [] for k in ("K1", "K5", "beam", "logp", "plain")}

    def spy(key, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            seen[key].append((a, k, out))
            return out
        return call

    with mock.patch.object(s.feat, "power_spectrum",
                           spy("K1", s.feat.power_spectrum)), \
            mock.patch.object(streaming_mod, "gru_scan_fwd",
                              spy("K5", streaming_mod.gru_scan_fwd)), \
            mock.patch.object(streaming_mod, "ctc_beam_search",
                              spy("beam", streaming_mod.ctc_beam_search)), \
            mock.patch.object(s, "advance", spy("logp", s.advance)):
        toks = rec.feed(tick)
    with plain_path(), mock.patch.object(twin._s, "advance",
                                         spy("plain", twin._s.advance)):
        plain_toks = twin.feed(tick)
    (wav, T), _, power = seen["K1"][0]
    floor = rec.cfg.log_floor
    ref = fused_mod.fbank_power_plain(wav, s.feat.tables, rec.cfg.hop_length,
                                      T)
    e1 = (torch.log(power.clamp(min=floor))
          - torch.log(ref.clamp(min=floor))).abs().max().item()
    e5 = max((ys - gru_mod.gru_scan_plain(*a, **k)).abs().max().item()
             for a, k, ys in seen["K5"])
    lp, plp = seen["logp"][0][2], seen["plain"][0][2]
    e_lp = (lp - plp).abs().max().item()
    ok = (e1 <= 1e-3 and e5 <= K5_H0_TOL and e_lp <= STREAM_TOL
          and len(seen["K5"]) == LAYERS)
    what = (f"K1 on wav {tuple(wav.shape)} -> T={T}: log-mel max_abs_err "
            f"{e1:.3e} (tol 1e-3); K5 on {len(seen['K5'])} layers' xp "
            f"{tuple(seen['K5'][0][0][0].shape)} from their carried h0: "
            f"max_abs_err {e5:.3e} (tol {K5_H0_TOL}); log-probs "
            f"{tuple(lp.shape)} against the plain path's tick from a copy "
            f"of the state: max_abs_err {e_lp:.3e} (tol {STREAM_TOL})")
    record("K1", "fbank_power", "tpuasr_torch/csrc/fbank.cu",
           "tpuasr/features/pallas_fused.py:109", e1)
    record("K5", "gru_scan_fwd", "tpuasr_torch/csrc/gru_bidir.cu",
           "tpuasr/ops/pallas_gru.py:163", e5)
    if dec == "greedy":
        same = toks == plain_toks
        what += f"; greedy tokens equal the plain path's: {same}"
        ok &= same
    else:
        (lp_in, lens, cfg), kw, got = seen["beam"][0]
        with plain_path():
            want = pbm.ctc_beam_search(lp_in, lens, cfg, **kw)
        pairs = {n: (got["state"][n], want["state"][n])
                 for n in got["state"]}
        pairs.update((n, (got[n], want[n])) for n in ("tokens", "token_lens"))
        same = {n: torch.equal(a, b) for n, (a, b) in pairs.items()
                if not a.is_floating_point()}
        e10 = max((a - b).abs().max().item() for a, b in pairs.values()
                  if a.is_floating_point())
        what += (f"; K10 + K10-rebuild (B={lp_in.shape[0]} T'="
                 f"{lp_in.shape[1]} K={cfg.beam_width} P={cfg.class_topk}) "
                 f"from the resumed beam state against the plain search on "
                 f"the same log-probs: equal (tol: exact) "
                 f"{json.dumps(same)}; scores max_abs_err {e10:.3e} (tol "
                 f"1e-4)")
        ok &= all(same.values()) and e10 <= 1e-4
        record("K10", "scan_search (the scan search's frame loop, with the "
               "graph row fetch inside)", "tpuasr_torch/csrc/scan_beam.cu",
               "tpuasr/ops/pallas_gather.py:82", e10)
    phase(f"[12 tick {dec}] one tick of {STREAM_N} slots against the "
          f"plain versions: {what}")
    if not ok:
        fail(f"[12] a {dec} tick's kernels disagree with their plain "
             f"versions")


def streaming_slice(record, kernels, wrappers, card, plain_path) -> None:
    """Phase 12: config 6 on the card. K5 from h0; one utterance through
    StreamingRecognizer in 100 ms chunks, greedy and with the beam, against
    the offline model and the one-shot scan search on the same audio; 64
    sessions through BatchedStreamingRecognizer (2 warm-up ticks, then 30
    timed: the tick's median and p95, the real-time margin, device time by
    kernel, the device's idle share, launches a tick), every slot against
    a solo recognizer; one ``python -m tpuasr_torch.cli.stream --beam
    --timestamps`` request."""
    from scipy.io import wavfile
    from tpuasr_torch.cli import stream as stream_cli
    from tpuasr_torch.convert import to_jax_variables
    from tpuasr_torch.decode import (BeamSearchConfig, ctc_beam_search_xla,
                                     greedy_decode)
    from tpuasr_torch.features import FeatureConfig, FusedFeaturizer
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.serve import (BatchedStreamingRecognizer,
                                    StreamingRecognizer)
    from tpuasr_torch.train.checkpoints import save_checkpoint
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 12)
    k5_from_h0(record, gru_mod, gen, card)

    feat_cfg = FeatureConfig(sample_rate=SR, n_mels=64, cmn=False, cvn=False)
    model = stream_model(dev)
    bcfg = BeamSearchConfig(beam_width=BEAM, class_topk=8)
    rng = np.random.default_rng(SEED)
    # benchmarks/config6_streaming.py:46-47: a seeded normal x 0.1.
    audio = (rng.standard_normal((STREAM_N, STREAM_CHUNK * (
        STREAM_WARMUP + STREAM_TICKS + 6))) * 0.1).astype(np.float32)
    utt = (rng.standard_normal(int(SR * STREAM_SECONDS)) * 0.1).astype(
        np.float32)
    counted = ("K1", "K5", "K10", "K10-rebuild")
    conv2d = torch.nn.functional.conv2d
    convs = [0]

    def counted_conv2d(*a, **k):
        convs[0] += 1
        return conv2d(*a, **k)

    # The offline model and the one-shot scan search on the utterance.
    with torch.inference_mode():
        fz = FusedFeaturizer(feat_cfg, dev)
        wav_d = torch.as_tensor(utt[None], device=dev)
        feats, flens = fz.featurize(wav_d, torch.tensor([len(utt)],
                                                        device=dev))
        logp, out_lens = model(feats, flens)
        toks, tlens = greedy_decode(logp, out_lens)
        off_greedy = toks[0, :int(tlens[0])].tolist()
        ref = ctc_beam_search_xla(logp, out_lens, bcfg)
        off_beam = ref["tokens"][0, 0, :int(ref["token_lens"][0, 0])].tolist()
    T_off = int(out_lens[0])

    # Solo: the utterance in 100 ms chunks, greedy and with the beam.
    for dec in ("greedy", "beam"):
        rec = StreamingRecognizer(model, feat_cfg, decode=dec,
                                  beam_cfg=bcfg if dec == "beam" else None,
                                  keep_logp=True, device=dev)
        t0 = time.perf_counter()
        for s in range(0, len(utt), STREAM_CHUNK):
            rec.feed(utt[s:s + STREAM_CHUNK])
        rec.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hist = np.concatenate(rec.logp_history)
        err = (float(np.abs(hist - logp[0, :T_off].cpu().numpy()).max())
               if hist.shape == (T_off, NUM_CLASSES) else float("inf"))
        want = off_greedy if dec == "greedy" else off_beam
        what = ("greedy decode" if dec == "greedy"
                else "one-shot scan search")
        phase(f"[12 solo {dec}] {STREAM_SECONDS:.0f} s in "
              f"{len(utt) // STREAM_CHUNK} chunks of 100 ms in {secs:.2f} s "
              f"(host clock): {len(rec.tokens)} tokens, equal to the "
              f"offline {what} ({len(want)} tokens): {rec.tokens == want}; "
              f"log-probs {hist.shape} against the offline model's "
              f"max_abs_err {err:.3e} (tol {STREAM_TOL})")
        if rec.tokens != want or not err <= STREAM_TOL:
            fail(f"[12] solo {dec} stream disagrees with the offline path")

    # Batched: JAX's measure() (config6_streaming.py:53-70), then one tick
    # more under torch.profiler, then every slot against a solo stream.
    def chunk_of(i, t):
        return audio[i, t * STREAM_CHUNK:(t + 1) * STREAM_CHUNK]

    for dec in ("greedy", "beam"):
        rec = BatchedStreamingRecognizer(
            model, feat_cfg, STREAM_N, decode=dec,
            beam_cfg=bcfg if dec == "beam" else None, device=dev)
        for t in range(STREAM_WARMUP):
            rec.feed({i: chunk_of(i, t) for i in range(STREAM_N)})
        lat = []
        for w in wrappers.values():
            w.launches = 0
        convs[0] = 0
        with mock.patch.object(torch.nn.functional, "conv2d", counted_conv2d):
            for t in range(STREAM_WARMUP, STREAM_WARMUP + STREAM_TICKS):
                tick = {i: chunk_of(i, t) for i in range(STREAM_N)}
                t0 = time.perf_counter()
                rec.feed(tick)
                lat.append(time.perf_counter() - t0)
        counts = {k: wrappers[k].launches for k in counted}
        for k in counted:
            kernels[k]["launches"] += counts[k]
        want = {"K1": 1, "K5": LAYERS,
                "K10": int(dec == "beam"), "K10-rebuild": int(dec == "beam")}
        per = {k: counts[k] / STREAM_TICKS for k in counted}
        lat = np.array(lat) * 1e3
        med, p95 = float(np.median(lat)), float(np.quantile(lat, 0.95))
        margin = 100.0 / med
        phase(f"[12 batched {dec}] {STREAM_N} streams x 100 ms chunks, "
              f"{STREAM_TICKS} ticks after {STREAM_WARMUP}: tick median "
              f"{med:.3f} ms, p95 {p95:.3f} ms (host clock around feed, "
              f"which syncs once); real-time margin {margin:.1f}x, "
              f"{int(STREAM_N * margin)} streams a card at real time; "
              f"launches a tick {json.dumps(per)}, cuDNN conv calls a tick "
              f"{convs[0] / STREAM_TICKS} [{card}]")
        if per != {k: float(v) for k, v in want.items()} or \
                convs[0] != 2 * STREAM_TICKS:
            fail(f"[12] {dec} launches a tick {per} != {want}, or cuDNN "
                 f"convs {convs[0]} != {2 * STREAM_TICKS}")
        # One tick fed outside the profiler (held against the plain
        # versions), one as the profiler's warm-up step (it drops a
        # session's first device records), then 4 kept.
        ticks = range(STREAM_WARMUP + STREAM_TICKS,
                      STREAM_WARMUP + STREAM_TICKS + 6)
        kept = len(ticks) - 2
        stream_tick_check(rec, {i: chunk_of(i, ticks[0])
                                for i in range(STREAM_N)},
                          plain_path, record, dec)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=kept,
                                       repeat=1)) as prof:
            for j, t in enumerate(ticks[1:]):
                if j == 1:
                    t0 = time.perf_counter()
                rec.feed({i: chunk_of(i, t) for i in range(STREAM_N)})
                torch.cuda.synchronize()
                prof.step()
            wall = (time.perf_counter() - t0) * 1e3 / kept
        busy = device_busy_ms(prof) / kept
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in device_rows(prof)), reverse=True)
        parts = "; ".join(f"{us / 1e3 / kept:.3f} ms x{n / kept:g} "
                          f"{kernel_name(name)}" for us, n, name in rows[:10])
        phase(f"[12 batched {dec}] {kept} ticks under torch.profiler (after "
              f"a warm-up step): wall {wall:.3f} ms a tick, device busy "
              f"{busy:.3f} ms, idle {100 * (1 - busy / wall):.1f}% of that "
              f"wall, {100 * (1 - busy / med):.1f}% of the untraced tick "
              f"median [{card}]")
        phase(f"[12 batched {dec}] device time of a tick by kernel (the "
              f"mean of {kept}): total "
              f"{sum(r[0] for r in rows) / 1e3 / kept:.3f} ms in "
              f"{sum(r[1] for r in rows) / kept:g} launches; {parts}")
        n_fed = ticks[-1] + 1
        # Every slot against a solo stream fed the same chunks: the running
        # hypotheses, then the flushed ones.
        bad = []
        running = [list(x) for x in rec.tokens]
        finals = [rec.flush(i) for i in range(STREAM_N)]
        finals = finals if dec == "beam" else [list(x) for x in rec.tokens]
        solo = StreamingRecognizer(model, feat_cfg, decode=dec,
                                   beam_cfg=bcfg if dec == "beam" else None,
                                   device=dev)
        for i in range(STREAM_N):
            solo.reset()
            for t in range(n_fed):
                solo.feed(chunk_of(i, t))
            r = list(solo.tokens)
            solo.flush()
            if r != running[i] or list(solo.tokens) != finals[i]:
                bad.append(i)
        phase(f"[12 batched {dec}] every slot's tokens (running after "
              f"{n_fed} ticks, then flushed) equal a solo stream's on the "
              f"same audio: {not bad} (slots apart: {bad}; "
              f"{sum(map(len, finals))} tokens in all)")
        if bad:
            fail(f"[12] batched {dec} slots {bad} differ from solo streams")

    # One request through the CLI, in this process.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wavfile.write(tmp / "s.wav", SR,
                      np.clip(utt * 32768, -32768, 32767).astype(np.int16))
        state = to_jax_variables({k: v.cpu()
                                  for k, v in model.state_dict().items()})
        save_checkpoint(tmp / "ckpt", dict(step=np.int32(0), **state), 0,
                        meta=dict(model="deepspeech_ctc",
                                  num_classes=NUM_CLASSES,
                                  model_kwargs=dict(
                                      rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                      bidirectional=False,
                                      explicit_pad=True),
                                  feature=dataclasses.asdict(feat_cfg)))
        (tmp / "units.txt").write_text("\n".join(UNITS))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = stream_cli.main([str(tmp / "s.wav"), "--checkpoint",
                                  str(tmp / "ckpt"), "--units",
                                  str(tmp / "units.txt"), "--chunk-ms",
                                  "100", "--beam", "--timestamps",
                                  "--device", "cuda"])
        lines = buf.getvalue().strip().splitlines()
    phase(f"[12 cli stream --beam --timestamps] rc={rc}, {len(lines)} "
          f"lines in {time.perf_counter() - t0:.2f} s (host clock, load "
          f"included); last: {lines[-2][:80]!r} / {lines[-1][:80]!r}")
    if rc != 0 or not lines[-2].startswith("# transcript: p") or \
            not lines[-1].startswith("# align: p"):
        fail(f"[12] cli stream output: {lines[-3:]}")


# bf16 streams: a kernel and its plain version round at the same points, so
# they differ only where an f32 sum in another order flips a bf16 rounding
# of h or dhp, which then rides the next steps: ys within 8e-3 (one ulp
# near 1 and its echo, test_k2_bf16_matches_jax's bound), each gradient
# within 2^-6 of its largest magnitude (four bf16 ulps there).
BF16_YS_TOL = 8e-3
BF16_GRAD_REL = 2.0 ** -6
# Step 1 of a bf16 train step against its plain path: loss and grad-norm
# within one bf16 ulp relative (2^-8). Both sum many stream elements, each
# one ulp apart at most where a flip happened, as often up as down.
BF16_STEP_TOL = 2.0 ** -8


# The lean recurrence's rounding of dhp in bf16, held apart from none. Rows
# never mix in the backward, so a flipped bf16 rounding of dhp rides only
# its own row: over the first 8 BPTT steps, the median over rows of dhp's
# relative L2 error is within 2^-14 of the plain version that rounds dhp
# and beyond it from the plain version that does not (on the CPU at this
# shape: f64 sums for dhp@Wh^T 7.4e-8 away from the rounding one, the
# unrounded one 4.6e-4 away). The tensor-core body always rounds (its ring
# holds bf16), so the unrounded arm is the plain version with wh in f32.
LEAN_ROUND_GATE = 2.0 ** -14


def lean_round_control(gru_mod, T, gen) -> None:
    """Phase 3's negative control for the lean recurrence's bf16 body:
    K5b-bf16's phase b (T'=249, B=16, H=512, full rows, bf16 streams)
    against gru_bwd_lean_plain with wh in bf16 (dhp rounded for dhp@Wh^T)
    and with wh's values in f32 (no rounding), the median row's error over
    the first 8 BPTT steps (gated: within the first, beyond the second)
    and over the whole scan (printed)."""
    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    B, H = TRAIN_B, HIDDEN
    mask = torch.ones((T, B, 1), device=dev)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    xp, wh, dys = rnd(T, B, 3 * H), rnd(H, 3 * H, scale=H ** -0.5), \
        rnd(T, B, H)
    ysp = gru_mod.prev_states(gru_mod.gru_scan_plain(xp, wh, mask), False)
    hp = gru_mod._hp(ysp, wh)
    plan = gru_mod._lean_plan(B, H, 1, gru_mod._sm_count(dev), True)
    (_, dhp), = gru_mod._lean_bf16(plan, [(xp, hp, ysp, dys, wh)],
                                   mask.reshape(T, B), False)
    errs = {}
    for name, w in (("rounding", wh), ("unrounded", wh.to(f32))):
        _, want = gru_mod.gru_bwd_lean_plain(xp.to(f32), hp, ysp.to(f32), w,
                                             mask, dys.to(f32))
        errs[name] = [((dhp[sl] - want[sl]).norm(dim=(0, 2))
                       / want[sl].norm(dim=(0, 2))).median().item()
                      for sl in (slice(T - 8, T), slice(0, T))]
    r, u = errs["rounding"], errs["unrounded"]
    phase(f"[3 K5b-bf16 dhp rounding control] T={T} B={B} H={H}: the "
          f"kernel's dhp relative L2 error, median row, first 8 BPTT steps "
          f"/ whole scan: against the plain version that rounds dhp "
          f"{r[0]:.3e} / {r[1]:.3e}, against the unrounded one {u[0]:.3e} "
          f"/ {u[1]:.3e} (gate {LEAN_ROUND_GATE:.3e}: the first within, "
          f"the second beyond)")
    if not r[0] <= LEAN_ROUND_GATE < u[0]:
        fail("the lean recurrence's rounding of dhp is not told apart from "
             "none")


# The bound of a bf16 backward counts the work of its route: the bf16
# products hp = ysp Wh and dhp Wh^T, and the weight gradients as three bf16
# products each (dhp, or K2b's dxp, split into hi + mid + lo), all on the
# tensor cores. The yardstick before (those gradients as one f32 product
# on the FMA units) is printed beside it.
BF16_BOUND_NOTE = "the f32-FMA weight gradients' bound"


def bf16_bwd_ops(macs: int) -> dict:
    """Operations of K5b-bf16 (K7b-bf16 with both directions' macs), macs =
    T B H 3H a direction: hp, dhp Wh^T, and dWh's three split terms."""
    return {"bf16": 2 * macs * (1 + 1 + 3)}


def bf16_train_kernels(record, gen, card) -> None:
    """Phase 3 for the bf16 forms of K5, K5b, K7b and K2b (config 3's bf16
    points: T'=249, H=512, B=16 and 64; K2b at the deepspeech_var step's
    D=512 and 768, H=384, B=16): each against its plain version, two calls
    bit for bit, timed at the batch phase 13 runs beside the plain version,
    the bound (bf16 products on the tensor cores, the weight gradients'
    f32 sums on the FMA units) and torch.nn.GRU in bf16."""
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features.reference import num_frames
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.utils.params import preset_for

    dev = torch.device("cuda")
    bf = torch.bfloat16
    T = -(-num_frames(FeatureConfig(), int(SR * TRAIN_SECONDS)) // 2)

    def mask_of(Bn):
        ln = torch.randint(T // 2, T + 1, (Bn,), generator=gen)
        ln[0], ln[1] = T, 1
        m = (torch.arange(T)[:, None] < ln[None, :]).float()[:, :, None]
        return m.to(dev).contiguous()

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    def errors(got, want):
        errs = [(a.float() - w.float()).abs().max().item()
                for a, w in zip(got, want)]
        tols = [BF16_GRAD_REL * w.float().abs().max().item() for w in want]
        return errs, tols

    def fmt(v):
        return ", ".join(f"{e:.3e}" for e in v)

    H = HIDDEN
    lean_round_control(gru_mod, T, gen)
    for Bn in (TRAIN_B, 64):
        mask = mask_of(Bn)
        for rev in (False, True):
            xp, wh = rnd(T, Bn, 3 * H), rnd(H, 3 * H, scale=H ** -0.5)
            dys = rnd(T, Bn, H)
            ys = gru_mod.gru_scan_fwd(xp, wh, mask, rev)
            ref = gru_mod.gru_scan_plain(xp, wh, mask, rev)
            err = (ys.float() - ref.float()).abs().max().item()
            same_f = torch.equal(ys, gru_mod.gru_scan_fwd(xp, wh, mask, rev))
            ysp = gru_mod.prev_states(ref, rev)
            args = (xp, ysp, wh, mask, dys, rev)
            got = gru_mod.gru_scan_bwd(*args)
            want = gru_mod.gru_scan_bwd_plain(*args)
            errs, tols = errors(got, want)
            same = all(torch.equal(a, c) for a, c in zip(
                got, gru_mod.gru_scan_bwd(*args)))
            msg = (f"[3 K5/K5b-bf16] gru bf16 T={T} B={Bn} H={H} reverse="
                   f"{rev}: ys max_abs_err {err:.3e} (tol {BF16_YS_TOL}), "
                   f"two calls equal {same_f}; dxp, dwh {fmt(errs)} (tol "
                   f"{fmt(tols)}), two calls equal {same}; dtypes "
                   f"{ys.dtype}, {got[0].dtype}, {got[1].dtype}")
            t5 = t5b = ()
            if Bn == 64 and not rev:
                macs = T * Bn * H * 3 * H
                ms = cuda_ms(lambda: gru_mod.gru_scan_fwd(xp, wh, mask), 10)
                pms = cuda_ms(lambda: gru_mod.gru_scan_plain(xp, wh, mask), 1)
                bms = cuda_ms(lambda: gru_mod.gru_scan_bwd(*args), 10)
                pbms = cuda_ms(lambda: gru_mod.gru_scan_bwd_plain(*args), 1)
                bd = bound_mixed(nbytes(xp, wh, mask, ys), {"bf16": 2 * macs})
                bbd = bound_mixed(nbytes(*args[:5], *got), bf16_bwd_ops(macs))
                old = bound_mixed(nbytes(*args[:5], *got),
                                  {"bf16": 4 * macs, "fp32": 2 * macs})
                lib = library_gru_ms(T, Bn, 2 * H, H, bf, False)
                blib = library_gru_ms(T, Bn, 2 * H, H, bf, True)
                msg += (f"; K5-bf16 kernel {ms:.3f} ms plain {pms:.3f} ms "
                        f"bound {bd[0]:.4f} ms ({bd[1]}) torch.nn.GRU bf16 "
                        f"forward {lib:.3f} ms; K5b-bf16 kernel {bms:.3f} ms "
                        f"plain {pbms:.3f} ms bound {bbd[0]:.4f} ms "
                        f"({bbd[1]}; {BF16_BOUND_NOTE} {old[0]:.4f} ms) "
                        f"torch.nn.GRU bf16 backward {blib:.3f} ms; "
                        f"{bwd_phases(gru_mod, 'K5b', args)} [{card}]")
                t5, t5b = (ms, pms, bd, lib), (bms, pbms, bbd, blib)
            phase(msg)
            if not (err <= BF16_YS_TOL and same_f and same and all(
                    e <= t for e, t in zip(errs, tols))
                    and ys.dtype == got[0].dtype == got[1].dtype == bf):
                fail(f"K5/K5b-bf16 disagree at B={Bn} reverse={rev}")
            record("K5-bf16", "gru_scan_fwd (bf16: K2's recurrence over xp)",
                   "tpuasr_torch/csrc/gru_scan.cu",
                   "tpuasr/ops/pallas_gru.py:163", err, *t5)
            record("K5b-bf16", "gru_scan_bwd (bf16)",
                   "tpuasr_torch/csrc/gru_lean.cu",
                   "tpuasr/ops/pallas_gru.py:190", max(errs), *t5b)
        # K7b-bf16: both directions, forward in time under one mask.
        xps = [rnd(T, Bn, 3 * H) for _ in range(2)]
        whs = [rnd(H, 3 * H, scale=H ** -0.5) for _ in range(2)]
        dyss = [rnd(T, Bn, H) for _ in range(2)]
        ysb = gru_mod.gru_scan_bidir_plain(*xps, *whs, mask)
        bargs = (*xps, *[gru_mod.prev_states(y, False) for y in ysb], *whs,
                 mask, *dyss)
        got = gru_mod.gru_scan_bidir_bwd(*bargs)
        want = gru_mod.gru_scan_bidir_bwd_plain(*bargs)
        errs, tols = errors(got, want)
        same = all(torch.equal(a, c) for a, c in zip(
            got, gru_mod.gru_scan_bidir_bwd(*bargs)))
        msg = (f"[3 K7b-bf16] gru_scan_bidir_bwd bf16 T={T} B={Bn} H={H}: "
               f"dxpf, dxpb, dwhf, dwhb max_abs_err {fmt(errs)} (tol "
               f"{fmt(tols)}); two calls equal {same}")
        t7 = ()
        if Bn == 64:
            macs = 2 * T * Bn * H * 3 * H
            ms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd(*bargs), 10)
            pms = cuda_ms(lambda: gru_mod.gru_scan_bidir_bwd_plain(*bargs), 1)
            bd = bound_mixed(nbytes(*bargs, *got), bf16_bwd_ops(macs))
            old = bound_mixed(nbytes(*bargs, *got),
                              {"bf16": 4 * macs, "fp32": 2 * macs})
            lib = library_gru_ms(T, Bn, 2 * H, H, bf, True,
                                 bidirectional=True)
            msg += (f"; kernel {ms:.3f} ms plain {pms:.3f} ms bound "
                    f"{bd[0]:.4f} ms ({bd[1]}; {BF16_BOUND_NOTE} "
                    f"{old[0]:.4f} ms) torch.nn.GRU bf16 "
                    f"bidirectional backward {lib:.3f} ms; "
                    f"{bwd_phases(gru_mod, 'K7b', bargs)} [{card}]")
            t7 = (ms, pms, bd, lib)
        phase(msg)
        if not (same and all(e <= t for e, t in zip(errs, tols))):
            fail(f"K7b-bf16 disagrees with its plain version at B={Bn}")
        record("K7b-bf16", "gru_scan_bidir_bwd (bf16)",
               "tpuasr_torch/csrc/gru_lean.cu",
               "tpuasr/ops/pallas_gru.py:437", max(errs), *t7)
        del xps, dyss, ysb, bargs, got, want
    # K2b-bf16 at the deepspeech_var step's shapes (phase 13's B=16).
    Hv = preset_for("deepspeech_var")[0]["rnn_hidden"]
    mask = mask_of(TRAIN_B)
    for D in (512, 3 * 256):
        for rev in (False, True):
            x, wx = rnd(T, TRAIN_B, D), rnd(D, 3 * Hv, scale=D ** -0.5)
            b = (torch.randn(3 * Hv, generator=gen) * 0.1).to(dev)
            wh, dys = rnd(Hv, 3 * Hv, scale=Hv ** -0.5), rnd(T, TRAIN_B, Hv)
            ys = gru_mod.gru_scan_xfused_plain(x, wx, b, wh, mask, rev)
            args = (x, gru_mod.prev_states(ys, rev), wx, b, wh, mask, dys,
                    rev)
            got = gru_mod.gru_scan_xfused_bwd(*args)
            want = gru_mod.gru_scan_xfused_bwd_plain(*args)
            errs, tols = errors(got, want)
            same = all(torch.equal(a, c) for a, c in zip(
                got, gru_mod.gru_scan_xfused_bwd(*args)))
            msg = (f"[3 K2b-bf16] gru_scan_xfused_bwd bf16 T={T} "
                   f"B={TRAIN_B} D={D} H={Hv} reverse={rev}: dx, dwx, db, "
                   f"dwh max_abs_err {fmt(errs)} (tol {fmt(tols)}); two "
                   f"calls equal {same}; dtypes "
                   f"{', '.join(str(a.dtype) for a in got)}")
            t2 = ()
            if D == 768 and not rev:
                n = T * TRAIN_B * 3 * Hv
                ms = cuda_ms(lambda: gru_mod.gru_scan_xfused_bwd(*args), 10)
                pms = cuda_ms(lambda: gru_mod.gru_scan_xfused_bwd_plain(
                    *args), 1)
                bd = bound_mixed(nbytes(*args[:7], *got), {
                    "bf16": 2 * n * (2 * D + 2 * Hv) + 6 * n * (D + Hv)})
                old = bound_mixed(nbytes(*args[:7], *got), {
                    "bf16": 2 * n * (2 * D + 2 * Hv),
                    "fp32": 2 * n * (D + Hv)})
                lib = library_gru_ms(T, TRAIN_B, D, Hv, bf, True)
                msg += (f"; kernel {ms:.3f} ms plain {pms:.3f} ms bound "
                        f"{bd[0]:.4f} ms ({bd[1]}; {BF16_BOUND_NOTE} "
                        f"{old[0]:.4f} ms) torch.nn.GRU bf16 backward "
                        f"{lib:.3f} ms; {bwd_phases(gru_mod, 'K2b', args)} "
                        f"[{card}]")
                t2 = (ms, pms, bd, lib)
            phase(msg)
            if not (same and all(e <= t for e, t in zip(errs, tols))
                    and [a.dtype for a in got]
                    == [bf, bf, torch.float32, bf]):
                fail(f"K2b-bf16 disagrees at D={D} reverse={rev}")
            record("K2b-bf16", "gru_scan_xfused_bwd (bf16)",
                   "tpuasr_torch/csrc/gru_lean.cu",
                   "tpuasr/ops/pallas_gru.py:736", max(errs), *t2)
    torch.cuda.empty_cache()


def bf16_train_slice(kernels, wrappers, card, f32_times) -> None:
    """Phase 13: config 3's bf16 points through Trainer on the card
    (benchmarks/config3_deepspeech_train.py:40-45, :82-83: B64_bf16 and
    B128_bf16 train with bf16_compute and, on the chip, pallas_gru,
    bf16_gru and bf16_conv): the 512 x 4 DeepSpeechCTC, 64 classes and
    mels, adamw, B=64 and 128 x 5 s, U=24. K5-bf16 and K5b-bf16 in every
    GRU direction, K6 and K6b once a step; step 1 against the plain path
    within BF16_STEP_TOL; the B=64 step beside phase 7's f32 one. Then
    fused_bidir with bf16_gru and bf16_compute at B=16 (K7 in bf16 and
    K7b-bf16 once a layer), and the deepspeech_var preset with fused_proj
    and bf16_gru at B=16 (K2 in bf16 and K2b-bf16 in every direction), once
    more with the backward forced to the recompute route (K5b-bf16 on the
    rounded xp)."""
    from tpuasr_torch.losses import ctc as ctc_mod
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.train import TrainConfig
    from tpuasr_torch.utils.params import preset_for

    ctc_patches = ((ctc_mod, "ctc_forward", ctc_mod.ctc_forward_plain),
                   (ctc_mod, "ctc_backward", ctc_mod.ctc_backward_plain))
    tpu = dict(pallas_gru=True, bf16_gru=True, bf16_conv=True)
    cfg = TrainConfig(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                      warmup_steps=1, bf16_compute=True,
                      model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                        **tpu))
    counted = {"K5-bf16": 2 * LAYERS, "K5b-bf16": 2 * LAYERS, "K6": 1,
               "K6b": 1}
    patches = ((gru_mod, "gru_scan_fwd", gru_mod.gru_scan_plain),
               (gru_mod, "gru_scan_bwd", gru_mod.gru_scan_bwd_plain),
               *ctc_patches)
    times = train_phase("13 train bf16", cfg, TRAIN_U, (64, 128), counted,
                        counted, patches, kernels, wrappers, card,
                        tol=BF16_STEP_TOL)
    (b_ms, b_rows), (f_ms, f_rows) = times[64], f32_times[64]
    phase(f"[13 train bf16] B=64 step {b_ms:.2f} ms against phase 7's f32 "
          f"B=64 step {f_ms:.2f} ms ({f_ms / b_ms:.2f}x) [{card}]; device "
          f"time by kernel, bf16: {b_rows}; f32: {f_rows}")
    cfg = TrainConfig(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                      warmup_steps=1, bf16_compute=True,
                      model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                        pallas_gru=True, bf16_gru=True,
                                        fused_bidir=True))
    patches = ((gru_mod, "gru_scan_bidir_fwd", gru_mod.gru_scan_bidir_plain),
               (gru_mod, "gru_scan_bidir_bwd",
                gru_mod.gru_scan_bidir_bwd_plain), *ctc_patches)
    train_phase("13 train bf16 fused_bidir", cfg, TRAIN_U, (TRAIN_B,),
                {"K7": LAYERS, "K7b-bf16": LAYERS, "K6": 1, "K6b": 1},
                ("K7", "K7b-bf16"), patches, kernels, wrappers, card,
                tol=BF16_STEP_TOL)
    kwargs, train = preset_for("deepspeech_var")
    cfg = TrainConfig(model="deepspeech_var", num_classes=NUM_CLASSES,
                      warmup_steps=1, **train,
                      model_kwargs=dict(kwargs, pallas_gru=True,
                                        fused_proj=True, bf16_gru=True))
    dirs = 2 * kwargs["rnn_layers"]
    patches = ((gru_mod, "_xfused_k2",
                lambda x, wx, b, wh, mask, rev:
                gru_mod.gru_scan_xfused_plain(x, wx, b, wh, mask, rev)),
               (gru_mod, "gru_scan_xfused_bwd",
                gru_mod.gru_scan_xfused_bwd_plain),
               (gru_mod, "gru_scan_bwd", gru_mod.gru_scan_bwd_plain),
               *ctc_patches)
    train_phase("13 train bf16 deepspeech_var", cfg, TRAIN_U, (TRAIN_B,),
                {"K2": dirs, "K2b-bf16": dirs, "K6": 1, "K6b": 1},
                ("K2", "K2b-bf16"), patches, kernels, wrappers, card,
                tol=BF16_STEP_TOL)
    with mock.patch.object(gru_mod, "xfused_bwd_is_fused",
                           lambda D, H: False):
        train_phase("13 train bf16 deepspeech_var recompute", cfg, TRAIN_U,
                    (TRAIN_B,), {"K2": dirs, "K5b-bf16": dirs, "K6": 1,
                                 "K6b": 1}, ("K5b-bf16",), patches, kernels,
                    wrappers, card, tol=BF16_STEP_TOL)


# Phase 14: the host first pass over the bench LG (native/wfst_decode.cc and
# native/wfst_lattice.cc, built by tpuasr_torch/native/build.py) on config
# 5's int8 arm's log-probs. Its plain versions, the Python mirrors
# (impl="py"), take tens of seconds an utterance at T'=499 on the bench
# LG, so they run on a few utterances only, in worker processes beside the
# other checks: the 1-best on FST_ORACLE_UTTS, the n-best and the lattice
# on FST_LATTICE_UTTS, also cut to FST_SHORT_T frames (2 s): on 10 s of
# the random model's log-probs the n-best's A* can exhaust its 10,000-pop
# budget before a path reaches the sink (in the JAX package too; ROADMAP
# Queue 3), and at 2 s it finds hypotheses to compare. The n-best's word
# confidences are float32 forward-backward sums in the native library and
# float64 in Python: a posterior is exp(alpha + beta - total), three sums
# as large as the best path's cost, so they agree to FST_CONF_ULPS float32
# ulps of that cost (relative): a fixed 1e-5 is below float32's
# resolution there.
FST_ORACLE_UTTS = 4
FST_LATTICE_UTTS = 2
FST_SHORT_T = 100
FST_SCORE_RTOL = 1e-5
FST_CONF_ULPS = 32
# The host prefix beam search (native/ctc_host.cc) against K3: at the
# served width (16, 8 classes a step) the share that agree is printed; at
# a wide beam (64, every class; tests/test_native.py's setting) on the
# first HOST_BEAM_UTTS utterances, cut to their first HOST_BEAM_T frames,
# tokens are exact and scores within 1e-4. The random model's posteriors
# are near uniform (the Viterbi path's per-frame posterior, utt_conf, is
# ~0.03), so near-ties abound: the host's map merge and K3 (equal to the
# scan search and their plain versions) then keep different beams further
# in; the share at full length is printed.
HOST_BEAM_UTTS = 8
HOST_BEAM_T = 16
HOST_BEAM_RTOL = 1e-4
GRAPH_AGREE_UTTS = 32


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (vendor, model name, family
    and model numbers) and its architecture, for host-clock figures."""
    import platform
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    name = " ".join(fields.get(k, "") for k in ("vendor_id", "model name"))
    return (f"{name.strip() or 'CPU'} (family {fields.get('cpu family', '?')}"
            f" model {fields.get('model', '?')}, {platform.machine()})")


def request_files(tmp: Path, state, flags) -> list:
    """Phase 6's request setting under tmp: the int8 arm's weights
    (w.npz, 512 x 4, 64 classes), units.txt and three seeded wavs of 2.0,
    3.5 and 5.0 s; -> the wavs' paths."""
    from scipy.io import wavfile
    from tpuasr_torch.convert import save_npz, to_jax_variables

    meta = dict(model="deepspeech_ctc", num_classes=NUM_CLASSES,
                model_kwargs=dict(rnn_hidden=HIDDEN, rnn_layers=LAYERS,
                                  **flags))
    save_npz(to_jax_variables(state), tmp / "w.npz", meta=meta)
    (tmp / "units.txt").write_text("\n".join(UNITS))
    rng = np.random.default_rng(SEED + 1)
    paths = []
    for i, sec in enumerate((2.0, 3.5, 5.0)):
        p = tmp / f"req{i}.wav"
        wavfile.write(p, SR, (rng.standard_normal(int(SR * sec))
                              * 3000).astype(np.int16))
        paths.append(str(p))
    return paths


def run_cli(main, argv) -> tuple:
    """(rc, stdout lines, host seconds) of one CLI main in this process."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines(), time.perf_counter() - t0


def fst_slice(kernels, wrappers, rec, tabs_g, lg, state, flags, wav_d,
              lens_d, card, audio_s) -> None:
    """Phase 14: the host first pass over the bench LG on config 5's int8
    arm (B=128 x 10 s, 512 x 4, C=64) through Recognizer: the counted run
    (the arm with K3, then the graph arm's K10 and rebuild on its
    log-probs), the 1-best on all 128 utterances by the host clock, its
    words against the graph arm's, the plain Python versions of the 1-best,
    n-best and lattice, the host beam search against K3, the confidences on
    the card against the CPU, and three CLI requests whose archives must be
    this phase's log-probs and alignments bit for bit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tpuasr_torch.decode import (BeamSearchConfig, ctc_beam_search_xla,
                                     graph_tokens_to_words, wfst_ctc_decode,
                                     wfst_ctc_decode_nbest, wfst_ctc_lattice)
    from tpuasr_torch.decode.fst_decode import flatten_fst
    from tpuasr_torch.native import ctc_beam_search_host
    from tpuasr_torch.serve.offline import Recognizer

    feat_cfg = rec.featurizer.cfg
    gcfg = BeamSearchConfig(beam_width=BEAM, class_topk=8, max_len=256)
    grec = Recognizer(rec.model, feat_cfg, gcfg, rec.device, graph=tabs_g)

    # The counted run: the int8 arm's batch (K1, K4 a layer and direction,
    # K3 and its backtrack), then the graph arm's search on its log-probs.
    for w in wrappers.values():
        w.launches = 0
    out = rec(wav_d, lens_d)
    with torch.inference_mode():
        gout = ctc_beam_search_xla(out["log_probs"], out["out_lens"], gcfg,
                                   graph=grec.graph)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers}, K1=1, K4=2 * LAYERS, K3=1,
                **{"K3-backtrack": 1, "K10": 1, "K10-rebuild": 1})
    phase(f"[14 fst] launch counts of the batch and its graph search: "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    if counts != want:
        fail(f"[14] launch counts {counts} != {want}")
    for k, n in counts.items():
        kernels[k]["launches"] += n

    logp, ol = out["log_probs"], out["out_lens"]
    lp_np, ol_np = logp.cpu().numpy(), ol.cpu().numpy()
    Bn, T, C = lp_np.shape
    flat = flatten_fst(lg)
    n_cpu = os.cpu_count()
    affinity = len(os.sched_getaffinity(0))
    cpu = host_cpu()

    # The 1-best first pass on every utterance, on all hardware threads.
    t0 = time.perf_counter()
    fb = wfst_ctc_decode(lg, lp_np, ol_np)
    fb_s = time.perf_counter() - t0
    phase(f"[14 fst] wfst_ctc_decode B={Bn} T'={T} on the bench LG "
          f"({flat.num_states} states, {len(flat.ilabels)} arcs), beam 16, "
          f"max_active 2000: {fb_s:.3f} s = {Bn / fb_s:.2f} utterances/s = "
          f"{audio_s / fb_s:.1f}x real time (host clock, {n_cpu} hardware "
          f"threads, {affinity} in this process's affinity, {cpu}) [{card}];"
          f" reached a final state {int(fb['reached_final'].sum())}/{Bn}, "
          f"mean words/utt {fb['word_lens'].mean():.1f}")

    # The plain versions and the host beam searches in worker processes
    # (spawned: this process holds the card), longest first.
    short = min(FST_SHORT_T, T)
    ol_short = np.minimum(ol_np, short)
    jobs = [(("nbest", i), wfst_ctc_decode_nbest,
             (lg, lp_np[i:i + 1], ol_np[i:i + 1]), dict(nbest=3, impl="py"))
            for i in range(FST_LATTICE_UTTS)]
    jobs += [(("lattice", i), wfst_ctc_lattice,
              (lg, lp_np[i, :ol_np[i]]), dict(impl="py"))
             for i in range(FST_LATTICE_UTTS)]
    jobs += [(("1best", i), wfst_ctc_decode,
              (lg, lp_np[i:i + 1], ol_np[i:i + 1]), dict(impl="py"))
             for i in range(FST_ORACLE_UTTS)]
    jobs += [(("host_wide", t), ctc_beam_search_host,
              (np.ascontiguousarray(lp_np[:HOST_BEAM_UTTS, :t]),
               np.minimum(ol_np[:HOST_BEAM_UTTS], t)),
              dict(beam_width=64, class_topk=C - 1, max_len=t))
             for t in (T, HOST_BEAM_T)]
    jobs += [(("nbest_short", i), wfst_ctc_decode_nbest,
              (lg, lp_np[i:i + 1, :short], ol_short[i:i + 1]),
              dict(nbest=3, impl="py")) for i in range(FST_LATTICE_UTTS)]
    jobs += [(("host_served", 0), ctc_beam_search_host, (lp_np, ol_np),
              dict(beam_width=16, class_topk=8, max_len=256))]
    # The graph arm's words: its tokens replayed through the LG (host
    # Python, ~1 s an utterance), on the first GRAPH_AGREE_UTTS.
    g_toks = gout["tokens"][:GRAPH_AGREE_UTTS, 0].cpu().numpy()
    g_lens = gout["token_lens"][:GRAPH_AGREE_UTTS, 0].cpu().numpy()
    jobs += [(("replay", i), graph_tokens_to_words,
              (lg, g_toks[i:i + 4], g_lens[i:i + 4]), dict(offset=0))
             for i in range(0, len(g_toks), 4)]
    t_pool = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(len(jobs), n_cpu),
                             mp_context=ctx) as pool:
        futures = {key: pool.submit(fn, *a, **kw) for key, fn, a, kw in jobs}
        # Meanwhile on the card and in this process: the graph arm's words
        # against the first pass's (reported: a random model), the
        # confidences, and the CLI requests.
        fst_confidences(out)
        fst_requests(rec, state, flags, lg)
        res = {key: f.result() for key, f in futures.items()}
    pool_s = time.perf_counter() - t_pool
    gw = [w for i in range(0, len(g_toks), 4) for w in res[("replay", i)]]
    agree = np.mean([gw[i] == fb["words"][i, :fb["word_lens"][i]].tolist()
                     for i in range(len(gw))])
    phase(f"[14 fst] 1-best words equal to the graph arm's (K10, class_topk "
          f"8, its tokens replayed through the LG) on {agree:.4f} of the "
          f"first {len(gw)} utterances (reported, not gated: the model is "
          f"untrained)")
    fst_oracle_gates(lg, lp_np, ol_np, ol_short, short, fb, res)
    host_beam_gates(logp, ol, lp_np, res)
    phase(f"[14 fst] plain versions and host beams: {len(jobs)} jobs in "
          f"{min(len(jobs), n_cpu)} worker processes, {pool_s:.1f} s "
          f"(host clock, {cpu})")


@torch.inference_mode()
def fst_confidences(out) -> None:
    """align_confidence of K3's best hypotheses (the batch ``out``) on the
    card against the same call on CPU copies (spans exact, confidences
    within 1e-5); and beam_posterior of K3's 8-best scores against float64
    numpy."""
    from tpuasr_torch.decode import (BeamSearchConfig, align_confidence,
                                     beam_posterior)
    from tpuasr_torch.decode import beam as beam_mod

    logp, ol = out["log_probs"], out["out_lens"]
    toks, tl = out["tokens"][:, 0], out["token_lens"][:, 0]
    U = max(1, int(tl.max()))
    toks = toks[:, :U].clamp(min=0).contiguous()
    dev_cf = align_confidence(logp, toks, tl, ol)
    cpu_cf = align_confidence(logp.cpu(), toks.cpu(), tl.cpu(), ol.cpu())
    spans = all(torch.equal(dev_cf[k].cpu(), cpu_cf[k])
                for k in ("token_starts", "token_ends", "feasible"))
    errs = {k: float(((dev_cf[k].cpu() - cpu_cf[k]).abs()
                      / cpu_cf[k].abs().clamp(min=1e-30)).max())
            for k in ("token_conf", "utt_conf")}
    nb = beam_mod.ctc_beam_search(logp, ol, BeamSearchConfig(
        beam_width=BEAM, max_len=256), n_best=BEAM)
    post = beam_posterior(nb["scores"]).cpu()
    bp_err = float((post - beam_posterior(nb["scores"].cpu())).abs().max())
    # Against float64: score - logsumexp(scores) cancels in float32, so a
    # posterior p carries p times a few ulps of the scores' magnitude.
    s = nb["scores"].cpu().numpy().astype(np.float64)
    ref = np.exp(s - s.max(1, keepdims=True))
    ref /= ref.sum(1, keepdims=True)
    post = post.numpy().astype(np.float64)
    ulp = np.spacing(np.abs(s).max(1, keepdims=True).astype(np.float32))
    f64 = float((np.abs(post - ref) / (ref * ulp + 1e-30)).max())
    phase(f"[14 confidence] align_confidence on the card against the CPU: "
          f"spans and feasibility equal {spans} (tol: exact), token_conf "
          f"and utt_conf relative error {errs['token_conf']:.3e} / "
          f"{errs['utt_conf']:.3e} (tol 1e-5), mean utt_conf "
          f"{float(dev_cf['utt_conf'].mean()):.4f}; beam_posterior of K3's "
          f"{BEAM}-best on the card against the CPU max_abs_err "
          f"{bp_err:.3e} (tol 1e-6), against float64 numpy {f64:.2f} ulps "
          f"of the scores' magnitude relative (tol 4), mean top posterior "
          f"{post[:, 0].mean():.4f}")
    if not (spans and max(errs.values()) <= 1e-5 and bp_err <= 1e-6
            and f64 <= 4):
        fail("[14] confidences on the card disagree with the CPU")


def fst_requests(rec, state, flags, lg) -> None:
    """Phase 14's CLI requests on phase 6's setting: predict --fst-decode
    with the lattice engine's n-best, confidences, lattice and word times;
    predict --beam --confidence --align --dump-loglikes; cli.test
    --fst-decode --align --write-segments --dump-loglikes over a manifest of
    the request wavs with word transcripts. The archives must hold this
    phase's log-probs and alignments (the int8 arm on the same batches)
    bit for bit."""
    from tpuasr_torch.cli import predict
    from tpuasr_torch.cli import test as test_cli
    from tpuasr_torch.data import (AudioLoader, LoaderConfig, Utterance,
                                   load_wav, read_manifest, write_manifest)
    from tpuasr_torch.losses import ctc_align
    from tpuasr_torch.utils import kaldi_io

    prons, _ = bench_lexicon()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = request_files(tmp, state, flags)
        lg.save_text(tmp / "lg.fst")
        (tmp / "lg_words.txt").write_text("<eps> 0\n" + "".join(
            f"{w} {i + 1}\n" for i, (w, _) in enumerate(prons)))
        dev = rec.device
        ds = ["deepspeech_ctc", *paths, "--weights", str(tmp / "w.npz"),
              "--units", str(tmp / "units.txt"), "--device", dev.type]
        fst = ["--fst", str(tmp / "lg.fst"), "--fst-osyms",
               str(tmp / "lg_words.txt")]
        rc, lines, secs = run_cli(predict.main, [
            *ds, "--fst-decode", *fst, "--fst-nbest", "3", "--confidence",
            "--write-lattice", str(tmp / "lat.txt"), "--align"])
        hyps = [ln for ln in lines if not ln.startswith("#")]
        lat_n = (tmp / "lat.txt").read_text().count("\n\n") \
            if (tmp / "lat.txt").exists() else 0
        phase(f"[14 cli predict --fst-decode --fst-nbest 3 --confidence "
              f"--write-lattice --align] rc={rc}, {len(hyps)} hypotheses, "
              f"{lat_n} lattices, {sum(ln.startswith('# conf:') for ln in lines)}"
              f" conf and {sum(ln.startswith('# align:') for ln in lines)} "
              f"align lines in {secs:.2f} s (host clock, load included)")
        if rc != 0 or lat_n != len(paths) or not all(
                w.startswith("w") for ln in hyps
                for w in ln.split("\t")[-1].split()):
            fail(f"[14] predict --fst-decode output: {lines}")

        rc, lines, secs = run_cli(predict.main, [
            *ds, "--beam", "--beam-width", str(BEAM), "--confidence",
            "--align", "--dump-loglikes", str(tmp / "lp")])
        # This phase's log-probs of the same padded batch.
        wavs = [load_wav(p)[0] for p in paths]
        S = max(len(w) for w in wavs)
        batch = np.zeros((len(wavs), S), np.float32)
        for i, w in enumerate(wavs):
            batch[i, :len(w)] = w
        ref = rec(batch, np.array([len(w) for w in wavs], np.int32))
        got = list(kaldi_io.read_ark(tmp / "lp.ark"))
        same = [k for k, _ in got] == [Path(p).stem for p in paths] and all(
            np.array_equal(m, ref["log_probs"][i, :int(ref["out_lens"][i])]
                           .cpu().numpy()) for i, (_, m) in enumerate(got))
        phase(f"[14 cli predict --beam --confidence --align --dump-loglikes] "
              f"rc={rc}, {sum(ln.startswith('# conf: utt') for ln in lines)} "
              f"conf and {sum(ln.startswith('# align:') for ln in lines)} "
              f"align lines in {secs:.2f} s; the ark's {len(got)} matrices "
              f"equal this phase's log-probs bit for bit: {same}")
        if rc != 0 or not same:
            fail(f"[14] predict --dump-loglikes: rc {rc}, {lines[-3:]}")

        rng = np.random.default_rng(SEED + 14)
        utts = []
        for i, p in enumerate(paths):
            ws = rng.integers(0, len(prons), size=int(rng.integers(2, 6)))
            utts.append(Utterance(
                id=f"req{i}", wav=p, text=" ".join(prons[w][0] for w in ws),
                tokens=[u for w in ws for u in prons[w][1]],
                num_samples=len(wavs[i])))
        write_manifest(tmp / "req.jsonl", utts)
        rc, lines, secs = run_cli(test_cli.main, [
            "deepspeech_ctc", "--manifest", str(tmp / "req.jsonl"),
            "--checkpoint", str(tmp / "w.npz"), "--units",
            str(tmp / "units.txt"), "--device", dev.type, "--fst-decode", *fst,
            "--align", str(tmp / "ali"), "--write-segments",
            str(tmp / "seg.jsonl"), "--dump-loglikes", str(tmp / "tlp")])
        want_ali, want_lp = {}, {}
        for b in AudioLoader(tmp / "req.jsonl", LoaderConfig(
                batch_size=16, max_label_len=64, shuffle=False)):
            o = rec(b["wav"], b["wav_lens"])
            with torch.inference_mode():
                al = ctc_align(o["log_probs"], torch.as_tensor(
                    b["tokens"], device=dev), o["out_lens"],
                    torch.as_tensor(b["token_lens"], device=dev))
            for j in np.flatnonzero(b["real"]):
                n = int(o["out_lens"][j])
                want_ali[b["ids"][j]] = al["frame_labels"][j, :n].cpu()\
                    .numpy().astype(np.float32)
                want_lp[b["ids"][j]] = o["log_probs"][j, :n].cpu().numpy()
        got_ali = dict(kaldi_io.read_ark(tmp / "ali.ark"))
        got_lp = dict(kaldi_io.read_ark(tmp / "tlp.ark"))
        same = (got_ali.keys() == want_ali.keys() == got_lp.keys()
                and all(np.array_equal(got_ali[k], want_ali[k])
                        and np.array_equal(got_lp[k], want_lp[k])
                        for k in want_ali))
        segs = [u.segments for u in read_manifest(tmp / "seg.jsonl")]
        phase(f"[14 cli test --fst-decode --align --write-segments "
              f"--dump-loglikes] rc={rc}, '{lines[-1] if lines else ''}' in "
              f"{secs:.2f} s; alignments and log-probs equal this phase's "
              f"bit for bit: {same}; {sum(bool(s) for s in segs)}/"
              f"{len(segs)} utterances with aligned segments")
        if rc != 0 or not same or "final-reached" not in lines[-1]:
            fail(f"[14] cli.test --fst-decode: rc {rc}, {lines[-4:]}")


def fst_oracle_gates(lg, lp_np, ol_np, ol_short, short, fb, res) -> None:
    """The native first pass, n-best and lattice against their Python
    versions (``res``, computed in the pool)."""
    from tpuasr_torch.decode import wfst_ctc_decode_nbest, wfst_ctc_lattice

    ints = ("words", "frames", "word_lens", "nhyp", "reached_final")
    bad = []
    srel = 0.0
    for i in range(FST_ORACLE_UTTS):
        py = res[("1best", i)]
        for k in ints[:3] + ints[4:]:
            if not np.array_equal(fb[k][i], py[k][0]):
                bad.append(f"1best {i} {k}")
        srel = max(srel, abs(float(fb["scores"][i]) / float(py["scores"][0])
                             - 1))
    phase(f"[14 fst] 1-best against impl='py' on {FST_ORACLE_UTTS} "
          f"utterances: words, frames, reached_final equal "
          f"{not bad} (tol: exact); scores relative error {srel:.3e} (tol "
          f"{FST_SCORE_RTOL})")
    nrel = crel = 0.0
    nhyp = []
    for tag, lens, T_cut in (("nbest", ol_np, None),
                             ("nbest_short", ol_short, short)):
        for i in range(FST_LATTICE_UTTS):
            lp = lp_np[i:i + 1] if T_cut is None else lp_np[i:i + 1, :T_cut]
            nat = wfst_ctc_decode_nbest(lg, lp, lens[i:i + 1], nbest=3)
            py = res[(tag, i)]
            for k in ints:
                if not np.array_equal(nat[k], py[k]):
                    bad.append(f"{tag} {i} {k}")
            n = int(nat["nhyp"][0])
            nhyp.append(n)
            if n:
                nrel = max(nrel, float(np.abs(nat["scores"][0, :n]
                                              / py["scores"][0, :n] - 1)
                                       .max()))
                L = int(nat["word_lens"][0, 0])
                # FST_CONF_ULPS float32 ulps of the best path's cost.
                tol = FST_CONF_ULPS * np.spacing(
                    np.float32(abs(py["scores"][0, 0])))
                c, d = nat["confidences"][0, :L], py["confidences"][0, :L]
                crel = max(crel, float((np.abs(c - d)
                                        / np.maximum(d, 1e-30)).max() / tol)
                           if L else 0.0)
    lat_rows = []
    for i in range(FST_LATTICE_UTTS):
        nat = wfst_ctc_lattice(lg, lp_np[i, :ol_np[i]])
        py = res[("lattice", i)]
        rel = abs(nat["best_cost"] / py["best_cost"] - 1)
        if not (rel <= FST_SCORE_RTOL
                and nat["reached_final"] == py["reached_final"]):
            bad.append(f"lattice {i}")
        lat_rows.append(f"{len(nat['src'])}/{len(py['src'])} links, "
                        f"source outflow {nat['post'][nat['src'] == 0].sum():.5f}"
                        f", best_cost relative error {rel:.3e}")
    phase(f"[14 fst] n-best (nbest 3) against impl='py' on "
          f"{FST_LATTICE_UTTS} utterances at T'={lp_np.shape[1]} and cut to "
          f"{short} frames: hypotheses {nhyp}; words, frames, lengths, nhyp, "
          f"reached_final equal {not bad} (tol: exact); scores relative "
          f"error {nrel:.3e} (tol {FST_SCORE_RTOL}); confidences' relative "
          f"error {crel:.3f} of the tolerance ({FST_CONF_ULPS} float32 ulps "
          f"of the best cost); lattices (native/py): {'; '.join(lat_rows)}")
    if bad or srel > FST_SCORE_RTOL or nrel > FST_SCORE_RTOL or crel > 1.0:
        fail(f"[14] the native first pass disagrees with impl='py': {bad}")


@torch.inference_mode()
def host_beam_gates(logp, ol, lp_np, res) -> None:
    """The host beam search (``res``, computed in the pool) against K3 on
    the same log-probs: at the served width the share of equal tokens; at
    a wide beam on the first HOST_BEAM_UTTS utterances the share at full
    length, and at their first HOST_BEAM_T frames tokens exact and scores
    within HOST_BEAM_RTOL."""
    from tpuasr_torch.decode import BeamSearchConfig
    from tpuasr_torch.decode import beam as beam_mod

    T = lp_np.shape[1]
    n = HOST_BEAM_UTTS

    def agree(host, dev):
        """Per utterance: equal tokens; and the scores' relative error."""
        same = [int(host["token_lens"][i]) == int(dev["token_lens"][i, 0])
                and np.array_equal(
                    host["tokens"][i, :int(host["token_lens"][i])],
                    dev["tokens"][i, 0, :int(dev["token_lens"][i, 0])]
                    .cpu().numpy()) for i in range(len(host["scores"]))]
        rel = np.abs(host["scores"] / dev["scores"][:, 0].cpu().numpy() - 1)
        return np.array(same), float(rel.max())

    served, _ = agree(res[("host_served", 0)], beam_mod.ctc_beam_search(
        logp, ol, BeamSearchConfig(beam_width=16, max_len=256)))
    full, full_rel = agree(res[("host_wide", T)], beam_mod.ctc_beam_search(
        logp[:n], ol[:n], BeamSearchConfig(beam_width=64, max_len=T)))
    cut, rel = agree(res[("host_wide", HOST_BEAM_T)],
                     beam_mod.ctc_beam_search(
                         logp[:n, :HOST_BEAM_T].contiguous(),
                         ol[:n].clamp(max=HOST_BEAM_T),
                         BeamSearchConfig(beam_width=64,
                                          max_len=HOST_BEAM_T)))
    phase(f"[14 host beam] ctc_beam_search_host against K3 on the same "
          f"log-probs: beam 16 (host class_topk 8) tokens equal on "
          f"{served.mean():.4f} of {len(lp_np)} utterances (reported); beam "
          f"64 with every class on the first {n}: at T'={T} "
          f"{int(full.sum())}/{n} equal, scores relative error "
          f"{full_rel:.3e} (reported), at their first {HOST_BEAM_T} frames "
          f"tokens equal {bool(cut.all())} (tol: exact), scores relative "
          f"error {rel:.3e} (tol {HOST_BEAM_RTOL})")
    if not (cut.all() and rel <= HOST_BEAM_RTOL):
        fail("[14] the host beam search disagrees with K3 at a wide beam")


def main() -> int:
    # ---- 1. environment -------------------------------------------------
    clock = [("start", time.perf_counter())]     # (phase, its end)
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
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.features import fused as fused_mod
    from tpuasr_torch.features.reference import num_frames
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
    from tpuasr_torch.serve import streaming as streaming_mod
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
    tabs_g, lg, g_secs = bench_graph()
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
    fbank_kernels(record, gen, dev)
    k1_config1 = config1_featurizer(dev, card)

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
        for key, label, kern, plain, args, kw in xfused_cases(
                gru_mod, quantize_per_channel, x, wx, wh, bias, mask):
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
                if timed:
                    phase(f"[3 {key}] gru {label} D={D}: "
                          + xfused_split(gru_mod, key, args, kw))
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
    # Ragged batches at the served widths: B=1, and B=129 (no multiple of
    # a row pass or a tile) with one all-padded row, which must stay zero.
    D = 1024
    for Bn in (1, 129):
        x = torch.randn(T_out, Bn, D, generator=gen).to(dev, torch.bfloat16)
        ln = torch.randint(1, T_out + 1, (Bn,), generator=gen)
        ln[0] = T_out
        if Bn > 1:
            ln[1] = 0
        mk = (torch.arange(T_out)[:, None] < ln[None, :]).float()[:, :, None]
        mk = mk.to(dev).contiguous()
        for key, label, kern, plain, args, kw in xfused_cases(
                gru_mod, quantize_per_channel, x, wx, wh, bias, mk):
            for rev in (False, True):
                got = kern(*args, reverse=rev, **kw)
                ref = plain(*args, reverse=rev, **kw)
                err = (got.float() - ref.float()).abs().max().item()
                pad = Bn > 1 and bool(got[:, 1].any())
                phase(f"[3 {key}] gru {label} ragged T={T_out} B={Bn} D={D} "
                      f"H={H} reverse={rev}: max_abs_err {err:.3e} (tol "
                      f"{gru_tol}); all-padded row nonzero: {pad}")
                if not err <= gru_tol or pad:
                    fail(f"{key} {label} ragged B={Bn} reverse={rev}: {err}")
                kernels[key]["max_abs_err"] = max(
                    kernels[key]["max_abs_err"], err)
    # K2 in float32, the deepspeech_var train step's forward (T'=249,
    # H=384, D=512 then 768, B=16 and 64): within 1e-4 of each output's
    # largest magnitude (f32 sums in other orders, carried by the
    # recurrence), under full_fp32() for the plain matmuls.
    xfused_f32_kernels(record, gen, gru_mod)

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
    with mock.patch.object(beam_mod, "beam_scan", beam_mod.beam_scan_plain), \
            mock.patch.object(beam_mod, "backtrack", beam_mod.backtrack_plain):
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

    # The backtrack of K3's packed backpointers (JAX's reverse scan,
    # pallas_beam.py:612-629) as one launch: tokens and lengths exactly
    # those of backtrack_plain, for the 1-best and for 3-best lists with a
    # max_len cap that cuts rows.
    bt_same = True
    for n_best, cap in ((1, bcfg.max_len), (3, 40)):
        idx = torch.argsort(-(got[1] + got[2]), dim=1)[:, :n_best]
        bt = beam_mod.backtrack(got[0], idx, cap)
        bt_p = beam_mod.backtrack_plain(got[0], idx, cap)
        bt_same &= all(torch.equal(a, r) for a, r in zip(bt, bt_p))
    idx = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    bt_ms = queued_ms(lambda: beam_mod.backtrack(got[0], idx, 256), 20)
    bt_pms = cuda_ms(lambda: beam_mod.backtrack_plain(got[0], idx, 256), 2)
    # Bytes: one backpointer read a frame for each utterance's walk, the
    # tokens and lengths written.
    bt_bd = bound(4 * (B * T_out + B * 256 + B), 0, "fp32")
    phase(f"[3 K3-backtrack] B={B} T={T_out} K={BEAM}: tokens+lengths equal "
          f"backtrack_plain {bt_same} (1-best; 3-best capped at 40) (tol: "
          f"exact) kernel {bt_ms:.4f} ms plain {bt_pms:.3f} ms bound "
          f"{bt_bd[0]:.5f} ms ({bt_bd[1]}); no PyTorch call computes it")
    if not bt_same:
        fail("the backtrack kernel disagrees with backtrack_plain")
    record("K3-backtrack", "backtrack", "tpuasr_torch/csrc/ctc_beam.cu",
           "tpuasr/decode/pallas_beam.py:612", 0.0, bt_ms, bt_pms, bt_bd)
    # The whole search's wall time (host clock, synchronised) against the
    # device time of one call.
    beam_mod.ctc_beam_search(lp, blens, bcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        beam_mod.ctc_beam_search(lp, blens, bcfg)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    dev_t = device_breakdown(
        lambda: beam_mod.ctc_beam_search(lp, blens, bcfg))
    phase(f"[3 K3] ctc_beam_search B={B} T={T_out} K={BEAM}: wall {wall:.3f}"
          f" ms a call (host clock) against device time {dev_t}")

    # K3 with LM fusion, K10's standalone gather, and K10 (the scan-search
    # kernel) with its rebuild, on the graph built above.
    lms = {order: unit_lm(order) for order in (2, 3)}
    lm_graph_kernels(record, lp, blens, lms, g_pack)
    scan_kernels(record, lp, blens, g_pack, tabs_g.start)

    # K5 / K5b / K6 / K6b at the config-3 train step's shapes.
    train_kernels(record, gen)

    # K2b at the deepspeech_var train step's shapes.
    xfb_kernels(record, gen)

    # K9 and K7 at config 5's and config 3's shapes; K7b at config 3's.
    conv_bidir_kernels(record, gen)
    bidir_bwd_kernels(record, gen)
    bf16_train_kernels(record, gen, card)

    # K8 and K8b at config 4's shapes.
    capsnet_kernels(record, gen)

    clock.append(("1-3", time.perf_counter()))

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
    # The int8 + int8_conv arm once more with each of K9's other bodies,
    # chosen by TPUASR_CONV_Q8_MODE as in JAX (conv_body below).
    for body in ("taps", "slab"):
        arms[f"int8+int8_conv/{body}"] = arms["int8+int8_conv"]

    def conv_body(arm):
        """The environment of an arm's calls: TPUASR_CONV_Q8_MODE names
        K9's body for the arms that carry one, and is unset otherwise."""
        env = {k: v for k, v in os.environ.items()
               if k != "TPUASR_CONV_Q8_MODE"}
        if "/" in arm:
            env["TPUASR_CONV_Q8_MODE"] = arm.split("/")[1]
        return mock.patch.dict(os.environ, env, clear=True)

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
                "K9": conv_mod.conv_taps_q8.bodies["im2col"],
                "K9-taps": conv_mod.conv_taps_q8.bodies["taps"],
                "K9-slab": conv_mod.conv_taps_q8.bodies["slab"],
                "K7": gru_mod.gru_scan_bidir_fwd,
                "K7b": gru_mod.gru_scan_bidir_bwd,
                "K3": beam_mod.beam_scan,
                "K3-backtrack": beam_mod.backtrack,
                "K10": prefix_beam_mod.scan_search,
                "K10-rebuild": prefix_beam_mod.rebuild_prefixes,
                "K10-gather": gather_mod.gather_rows,
                "K8": routing_mod.routed_caps,
                "K8b": routing_mod.routed_caps_bwd,
                "K5": gru_mod.gru_scan_fwd,
                "K5b": gru_mod.gru_scan_bwd,
                "K2b": gru_mod.gru_scan_xfused_bwd,
                "K5-bf16": gru_mod.gru_scan_fwd.bf16,
                "K5b-bf16": gru_mod.gru_scan_bwd.bf16,
                "K2b-bf16": gru_mod.gru_scan_xfused_bwd.bf16,
                "K7b-bf16": gru_mod.gru_scan_bidir_bwd.bf16,
                "K6": ctc_mod.ctc_forward,
                "K6b": ctc_mod.ctc_backward}
    serving = ("K1", "K2", "K4", "K9", "K9-taps", "K9-slab", "K7", "K3",
               "K3-backtrack")
    plain_patches = (
        (fused_mod, "fbank_power", fused_mod.fbank_power_plain),
        (layers_mod, "gru_scan_xfused", gru_mod.gru_scan_xfused_plain),
        (layers_mod, "gru_scan_xfused_q8", gru_mod.gru_scan_xfused_q8_plain),
        (layers_mod, "conv_taps_q8",
         lambda *a: conv_mod.reference_q8_conv_taps(
             *a, mode=conv_mod.resolve_mode(None))),
        (gru_mod, "gru_scan_bidir_fwd", gru_mod.gru_scan_bidir_plain),
        (streaming_mod, "gru_scan_fwd", gru_mod.gru_scan_plain),
        (beam_mod, "beam_scan", beam_mod.beam_scan_plain),
        (beam_mod, "backtrack", beam_mod.backtrack_plain),
        (prefix_beam_mod, "scan_search", prefix_beam_mod.scan_search_plain),
        (prefix_beam_mod, "rebuild_prefixes",
         prefix_beam_mod.rebuild_prefixes_plain),
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
                               counted_conv2d), conv_body(arm):
            outs[arm] = rec(wav_d, lens_d)
        torch.cuda.synchronize()
        per_arm[arm] = {k: w.launches - before[k] for k, w in wrappers.items()}
    launches = {k: w.launches for k, w in wrappers.items()}
    phase(f"[4 slice] launch counts per batch: {json.dumps(per_arm)}; "
          f"cuDNN conv calls per batch: {json.dumps(convs)}")
    none = {k: 0 for k in wrappers}
    beam = {"K3": 1, "K3-backtrack": 1}
    want = {"int8": dict(none, K1=1, K4=2 * LAYERS, **beam),
            "bf16": dict(none, K1=1, K2=2 * LAYERS, **beam),
            "int8+int8_conv": dict(none, K1=1, K9=1, K4=2 * LAYERS, **beam),
            "bf16+fused_bidir": dict(none, K1=1, K7=LAYERS, **beam)}
    for body in ("taps", "slab"):
        want[f"int8+int8_conv/{body}"] = dict(none, K1=1, K4=2 * LAYERS,
                                              **beam, **{f"K9-{body}": 1})
    want_convs = {arm: 1 if arm.startswith("int8+int8_conv") else 2
                  for arm in arms}
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
    # identical features.
    for arm, rec in recs.items():
        with conv_body(arm):
            # K9's other bodies share the int8 + int8_conv arm's plain
            # path: checked against it, its time not taken again.
            check_serving_arm(f"4 slice {arm}", rec, outs[arm], wav_d,
                              lens_d, T_out, wrappers, plain_path, card,
                              tol=5e-2, am_tol=5e-2,
                              plain_timed="/" not in arm)

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

    # The ResNet-CTC arm (config 2); K1's count takes config 1's path too.
    resnet_slice(kernels, wrappers, card, plain_path)
    kernels["K1"]["launches"] += k1_config1

    clock.append(("4", time.perf_counter()))

    # ---- 5. the LM and graph serving arms --------------------------------
    lm_graph_slice(kernels, wrappers, recs["int8"].model, feat_cfg, wav_d,
                   lens_d, tabs_g, lms, plain_path, card, audio_s, T_out)

    clock.append(("5", time.perf_counter()))

    # ---- 6. requests through the CLI --------------------------------------
    from tpuasr_torch.cli import predict
    from tpuasr_torch.utils.params import preset_for

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = request_files(tmp, state, arms["int8"])
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
        # Config 2's ResNet-CTC (64 units) for the resnet_ctc requests.
        rmodel = resnet_model("cpu")
        save_npz(to_jax_variables(rmodel.state_dict()), tmp / "resnet.npz",
                 meta=dict(model="resnet_ctc", num_classes=NUM_CLASSES,
                           model_kwargs=preset_for("resnet_ctc")[0]))
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
            "resnet_ctc greedy": ["resnet_ctc", *paths, "--weights",
                                  str(tmp / "resnet.npz"), "--units",
                                  str(tmp / "units.txt")],
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

        cli_test_requests(tmp, rmodel, feat_cfg, dev)

    clock.append(("6", time.perf_counter()))

    # ---- 7. the training slice through Trainer.train_step ---------------------
    f32_times = train_slice(kernels, wrappers, card)
    clock.append(("7", time.perf_counter()))

    # ---- 8. the CapsNet training step through Trainer.train_step ----------
    capsnet_train_slice(kernels, wrappers, card)
    clock.append(("8", time.perf_counter()))

    # ---- 9. the deepspeech_var train step, with K2b -----------------------
    var_train_slice(kernels, wrappers, card)
    clock.append(("9", time.perf_counter()))

    # ---- 10. the ResNet-CTC train step (config 2's model) -----------------
    resnet_train_slice(kernels, wrappers, card)
    clock.append(("10", time.perf_counter()))

    # ---- 11. the training loop: batch_train, checkpoints, resume ----------
    train_loop_slice(kernels, wrappers, card)
    clock.append(("11", time.perf_counter()))

    # ---- 12. streaming (config 6) ------------------------------------------
    streaming_slice(record, kernels, wrappers, card, plain_path)
    clock.append(("12", time.perf_counter()))

    # ---- 13. bf16 training: config 3's bf16 points -------------------------
    bf16_train_slice(kernels, wrappers, card, f32_times)
    clock.append(("13", time.perf_counter()))

    # ---- 14. the host first pass over the bench LG ------------------------
    fst_slice(kernels, wrappers, recs["int8"], tabs_g, lg, state,
              arms["int8"], wav_d, lens_d, card, audio_s)
    clock.append(("14", time.perf_counter()))
    phase("[time] seconds by phase (host clock): " + json.dumps(
        {name: round(t - clock[i][1], 1)
         for i, (name, t) in enumerate(clock[1:])})
        + f"; {clock[-1][1] - clock[0][1]:.1f} s in all")

    order = ("K1", "K1b", "K2", "K2-f32", "K4", "K9", "K9-taps", "K9-slab",
             "K7", "K7-f32", "K3", "K3-LM", "K3-backtrack", "K10",
             "K10-rebuild", "K10-gather", "K8", "K8b",
             "K5", "K5b", "K7b", "K2b", "K6", "K6b",
             "K5-bf16", "K5b-bf16", "K2b-bf16", "K7b-bf16")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
