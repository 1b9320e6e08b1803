"""tpuasr_torch's ``BatchedStreamingRecognizer`` against the JAX package's
and against the port's ``StreamingRecognizer`` (CPU), on the setup of
``torch_streaming_common.py``: slots advanced in lockstep through regular
and ragged ticks, flushes and a mid-stream attach; tokens exact.
"""

import pytest

from torch_streaming_common import (bigram, feed, make_setup, tone,
                                    toy_graph)
from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.serve.streaming import \
    BatchedStreamingRecognizer as JBatchedStreamingRecognizer
from tpuasr_torch.decode import BeamSearchConfig
from tpuasr_torch.serve import (BatchedStreamingRecognizer,
                                StreamingRecognizer)


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


# ---- BatchedStreamingRecognizer ---------------------------------------------

def _batched_script():
    """Three slots: three regular ticks of 1600 samples, two ragged ticks
    (slots 0 and 1 fed 2200 and 1000, then 1000 and 2200: the first holds
    slot 0 back, the second lets it catch up), slot 2's audio ended,
    flushed and attached again mid-stream with other audio, then ticks of
    1600 until the three streams end together and are flushed. The
    attached slot's first
    chunk is 1760 samples, the others' leftover 160 plus 1600, so that
    every slot has 20 frames a tick and none is held back when flushed
    (JAX's flush would drop held-back frames:
    ``test_jax_batched_flush_drops_held_back_frames_and_the_port_does_not``).
    -> (streams, ops): ops are ("feed", {slot: (stream, start, end)}),
    ("flush", slot, stream) and ("attach", slot)."""
    streams = [tone(12800, 700, 1.0, 0), tone(12800, 1200, 0.8, 3),
               tone(8000, 900, 0.5, 5), tone(4960, 1400, 0.6, 7)]
    ops = []
    pos = {0: 0, 1: 0, 2: 0}
    slot_stream = {0: 0, 1: 1, 2: 2}

    def tick(sizes):
        step = {}
        for slot, n in sizes.items():
            k = slot_stream[slot]
            step[slot] = (k, pos[slot], pos[slot] + n)
            pos[slot] += n
        ops.append(("feed", step))

    for _ in range(3):
        tick({0: 1600, 1: 1600, 2: 1600})
    tick({0: 2200, 1: 1000, 2: 1600})
    tick({0: 1000, 1: 2200, 2: 1600})
    ops.append(("flush", 2, 2))
    ops.append(("attach", 2))
    slot_stream[2], pos[2] = 3, 0
    tick({0: 1600, 1: 1600, 2: 1760})
    live = {0, 1, 2}
    while live:
        tick({i: 1600 for i in live})
        for i in sorted(live):
            if pos[i] >= len(streams[slot_stream[i]]):
                ops.append(("flush", i, slot_stream[i]))
                live.discard(i)
    return streams, ops


def _run_batched(rec, streams, ops):
    """-> {stream: final tokens} and each stream's chunk boundaries."""
    final, chunks = {}, {}
    for op in ops:
        if op[0] == "feed":
            rec.feed({slot: streams[k][a:b]
                      for slot, (k, a, b) in op[1].items()})
            for k, a, b in op[1].values():
                chunks.setdefault(k, []).append((a, b))
        elif op[0] == "flush":
            rec.flush(op[1])
            final[op[2]] = list(rec.tokens[op[1]])
        else:
            rec.attach(op[1])
    return final, chunks


@pytest.mark.parametrize("mode", ["greedy", "beam", "beam_bigram", "graph"])
def test_batched_matches_jax_and_solo(setup, mode):
    """BatchedStreamingRecognizer with 3 slots through regular ticks, ragged
    ticks, a flush and a mid-stream attach: every stream's tokens equal a
    solo recognizer's fed the same chunks (greedy; beam with class_topk 4,
    with bigram fusion, and under the graph, whose per-beam state the
    attach resets to the start state) and, but under the graph, JAX's
    batched recognizer's under the same calls."""
    s = setup
    streams, ops = _batched_script()
    jkw, tkw, jcfg, tcfg = {}, {}, None, None
    if mode != "greedy":
        cfg = dict(beam_width=4, class_topk=4)
        if mode == "beam_bigram":
            cfg["lm_weight"] = 0.3
            jkw = tkw = bigram([["t1", "t2", "t3"], ["t2", "t3", "t4"],
                                 ["t3", "t4", "t5"]])
        if mode == "graph":
            cfg["graph_weight"] = 0.8
            jt, tt = toy_graph()
            jkw, tkw = dict(graph=jt), dict(graph=tt)
        jcfg, tcfg = JBeamSearchConfig(**cfg), BeamSearchConfig(**cfg)
    dec = "greedy" if mode == "greedy" else "beam"
    tb = BatchedStreamingRecognizer(s["tm"], s["fc"], n_streams=3,
                                    decode=dec, beam_cfg=tcfg, device="cpu",
                                    **tkw)
    got, chunks = _run_batched(tb, streams, ops)
    assert set(got) == {0, 1, 2, 3} and all(got.values())
    if mode != "graph":
        jb = JBatchedStreamingRecognizer(s["v"], s["jfc"], n_streams=3,
                                         decode=dec, beam_cfg=jcfg, **jkw)
        assert _run_batched(jb, streams, ops)[0] == got
    for k, w in enumerate(streams):
        solo = StreamingRecognizer(s["tm"], s["fc"], decode=dec,
                                   beam_cfg=tcfg, device="cpu", **tkw)
        for a, b in chunks[k]:
            solo.feed(w[a:b])
        solo.flush()
        assert solo.tokens == got[k], k


def test_jax_batched_flush_drops_held_back_frames_and_the_port_does_not(
        setup):
    """The reference's fault: lockstep holds back the samples of a slot fed
    more than the slowest, and JAX's flush (streaming.py:763-782) drops
    them with the last partial frame, so the stream loses audio. Slot 1 is
    fed 1600 samples a tick and slot 0 1000, for 5 ticks, then slot 1 is
    flushed with 3000 samples held back: JAX's tokens for it are a solo
    recognizer's on the first 5000 samples and miss the tail's; the port
    featurizes the held-back frames at the flush and equals a solo
    recognizer fed all 8000."""
    s = setup
    w0, w1 = tone(5000, 700, 1.0, 0), tone(8000, 1200, 0.8, 3)
    jb = JBatchedStreamingRecognizer(s["v"], s["jfc"], n_streams=2)
    tb = BatchedStreamingRecognizer(s["tm"], s["fc"], n_streams=2,
                                    device="cpu")
    for rec in (jb, tb):
        for t in range(5):
            rec.feed({0: w0[1000 * t:1000 * (t + 1)],
                      1: w1[1600 * t:1600 * (t + 1)]})
        rec.flush(1)
    solo_all = feed(StreamingRecognizer(s["tm"], s["fc"], device="cpu"),
                     w1, 1600)
    solo_cut = feed(StreamingRecognizer(s["tm"], s["fc"], device="cpu"),
                     w1[:5000], 1600)
    assert tb.tokens[1] == solo_all
    assert list(jb.tokens[1]) == solo_cut != solo_all
