"""Scoring a manifest with the port against the JAX package (CPU): the
metrics, the manifest reader and writer, the length buckets, the
``AudioLoader``'s batches and ``python -m tpuasr_torch.cli.test``.

The same seeded data go through both packages: token sequences for the
metrics, sample counts for the buckets, and a manifest of wavs written
here for the loader and the command. The command runs beside the JAX
``test.py`` (``tpuasr.cli.test.main``) on the same weights in every
decoding mode, and both must score the same hypotheses to the same line.
"""

import contextlib
import dataclasses
import io
import json

import flax.serialization
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuasr.data import AudioLoader as JAudioLoader
from tpuasr.data import LoaderConfig as JLoaderConfig
from tpuasr.data import make_buckets as j_make_buckets
from tpuasr.data import read_manifest as j_read_manifest
from tpuasr.data import write_manifest as j_write_manifest
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.utils.metrics import edit_distance as j_edit_distance
from tpuasr.utils.metrics import wer as j_wer
from tpuasr_torch.cli import test as test_cli
from tpuasr_torch.convert import save_npz, to_jax_variables
from tpuasr_torch.data import (AudioLoader, LoaderConfig, Utterance,
                               make_buckets, read_manifest, write_manifest)
from tpuasr_torch.decode import lexicon_to_fst
from tpuasr_torch.lm import train_ngram
from tpuasr_torch.models import create_model
from tpuasr_torch.utils.metrics import edit_distance, wer


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


C = 12
ARCH = dict(stem_channels=8, stage_channels=(8, 16), blocks_per_stage=1,
            dropout=0.0)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    refs, hyps = [], []
    for _ in range(200):
        r = rng.integers(0, 6, size=int(rng.integers(0, 12))).tolist()
        h = rng.integers(0, 6, size=int(rng.integers(0, 12))).tolist()
        assert edit_distance(r, h) == j_edit_distance(r, h)
        refs.append(r)
        hyps.append(h)
    assert wer(refs, hyps) == j_wer(refs, hyps)
    assert wer([], []) == j_wer([], []) == 0.0
    assert edit_distance(list("kitten"), list("sitting")) == 3


def _corpus(tmp_path, n=11, seed=0, samples=(4000, 16000)):
    """n written 8 kHz wavs (0.5-2 s by default) with seeded tokens and
    texts, and their manifest (relative wav paths)."""
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        S = int(rng.integers(*samples))
        wavfile.write(tmp_path / f"u{i}.wav", 8000,
                      (rng.standard_normal(S) * 3000).astype(np.int16))
        toks = rng.integers(1, C, size=int(rng.integers(1, 9))).tolist()
        utts.append(Utterance(id=f"u{i}", wav=f"u{i}.wav", tokens=toks,
                              text=" ".join(f"w{t}" for t in toks),
                              num_samples=S))
    write_manifest(tmp_path / "m.jsonl", utts)
    return tmp_path / "m.jsonl"


def test_manifest_round_trip(tmp_path):
    path = _corpus(tmp_path, n=4)
    utts = read_manifest(path)
    jutts = j_read_manifest(path)
    assert [dataclasses.asdict(u) for u in utts] == [
        dataclasses.asdict(u) for u in jutts]
    assert utts[0].wav == str(tmp_path / "u0.wav")
    utts[1].segments = [[3, 0, 800]]
    write_manifest(tmp_path / "sub" / "a.jsonl", utts)
    j_write_manifest(tmp_path / "sub" / "b.jsonl", j_read_manifest(
        tmp_path / "sub" / "a.jsonl"))
    assert ((tmp_path / "sub" / "a.jsonl").read_text()
            == (tmp_path / "sub" / "b.jsonl").read_text())
    back = read_manifest(tmp_path / "sub" / "a.jsonl")
    assert back[1].segments == [[3, 0, 800]]
    assert back[2].duration == utts[2].num_samples / 8000


@pytest.mark.parametrize("kw", [dict(), dict(max_waste=0.05),
                                dict(max_buckets=3, quantum=800),
                                dict(max_buckets=1), dict(min_buckets=4)])
def test_make_buckets_matches_jax(kw):
    rng = np.random.default_rng(1)
    for lens in (rng.integers(2000, 80000, size=300),
                 rng.integers(100, 200, size=7), [16000] * 5):
        a, b = make_buckets(lens, **kw), j_make_buckets(lens, **kw)
        assert a.boundaries == b.boundaries
        for n in (1, 2000, 16000, 79999, 10 ** 6):
            assert a.bucket_of(n) == b.bucket_of(n)


@pytest.mark.parametrize("cfg", [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=3, shuffle=True, seed=5, max_label_len=5),
    dict(batch_size=4, shuffle=True, drop_last=True, bucket_quantum=800,
         cache_bytes=0),
])
def test_audio_loader_batches_equal_jax(tmp_path, cfg):
    path = _corpus(tmp_path)
    ours = AudioLoader(path, LoaderConfig(**cfg))
    theirs = JAudioLoader(path, JLoaderConfig(**cfg))
    assert ours.buckets.boundaries == theirs.buckets.boundaries
    for epoch in (0, 1):
        assert ours.batch_plan(epoch) == theirs.batch_plan(epoch)
    assert len(ours) == len(theirs)
    for _ in range(2):          # two epochs: the second reads the cache
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a["ids"] == b["ids"]
            for k in ("wav", "wav_lens", "tokens", "token_lens", "real"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_audio_loader_refuses_what_it_does_not_port(tmp_path):
    path = _corpus(tmp_path, n=2)
    for kw in (dict(unlabeled_frames=True),
               dict(frame_label_cfg=JFeatureConfig())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AudioLoader(path, LoaderConfig(**kw))


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """One manifest and one seeded ResNet for every command below: the
    weights as the port's .npz and as the JAX command's msgpack checkpoint
    with its .json metadata; units, a unit LM, a lexicon of 10 words with
    its words.txt and word bigram, and the lexicon as an L transducer
    (olabel i + 1 is word i)."""
    tmp = tmp_path_factory.mktemp("scored")
    # 0.3-0.9 s: two length buckets of three, each batch of 4 with a
    # padding row.
    path = _corpus(tmp, n=6, samples=(2400, 7200))
    tm = create_model("resnet_ctc", num_classes=C, in_features=64, **ARCH,
                      generator=torch.Generator().manual_seed(0))
    meta = dict(model="resnet_ctc", num_classes=C, model_kwargs=ARCH)
    v = to_jax_variables(tm.state_dict())
    save_npz(v, tmp / "w.npz", meta=meta)
    (tmp / "w.msgpack").write_bytes(flax.serialization.msgpack_serialize(v))
    (tmp / "w.json").write_text(json.dumps(meta))
    units = ["<blank>"] + [f"u{i}" for i in range(1, C)]
    (tmp / "units.txt").write_text("\n".join(units))
    rng = np.random.default_rng(2)
    train_ngram([[units[int(v)] for v in rng.integers(1, C, size=6)]
                 for _ in range(40)], order=3).save_arpa(tmp / "units.arpa")
    prons = []
    while len(prons) < 10:
        p = tuple(int(v) for v in rng.integers(1, C,
                                               size=int(rng.integers(1, 4))))
        if p not in [q for _, q in prons]:
            prons.append((f"w{len(prons)}", p))
    (tmp / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, (w, _) in enumerate(prons)))
    (tmp / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(units[p] for p in pr)}\n" for w, pr in prons))
    train_ngram([[f"w{int(v)}" for v in rng.integers(0, 10, size=4)]
                 for _ in range(40)], order=2).save_arpa(tmp / "words.arpa")
    lexicon_to_fst(prons).save_text(tmp / "l.fst")
    (tmp / "fst_words.txt").write_text("<eps> 0\n" + "".join(
        f"{w} {i + 1}\n" for i, (w, _) in enumerate(prons)))
    return tmp, path, units


def _run(cli, argv, monkeypatch):
    """(rc, stdout lines, the (refs, hyps) of every ``wer`` call) of one
    command's ``main``."""
    calls = []

    def recording_wer(refs, hyps):
        calls.append(([list(r) for r in refs], [list(h) for h in hyps]))
        return j_wer(refs, hyps)

    monkeypatch.setattr(cli, "wer", recording_wer)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue().strip().splitlines(), calls


# (the port's decode flags, the JAX command's). The port's "auto" beam is
# the all-class search, JAX's "pallas" one (what its "auto" picks on a
# TPU; interpreted here, so only the plain beam takes it); "xla" is the
# top-P scan search in both.
MODES = {
    "greedy": ([], []),
    "beam": (["--beam"], ["--beam", "--beam-impl", "pallas"]),
    "fusion": (["--beam", "--beam-impl", "xla", "--lm", "units.arpa",
                "--lm-fusion"],) * 2,
    "rescore": (["--beam", "--beam-impl", "xla", "--lm", "units.arpa"],) * 2,
    "rescore_words": (["--beam", "--beam-impl", "xla", "--lm", "units.arpa",
                       "--lexicon", "lexicon.txt", "--words", "words.txt"],)
    * 2,
    "fst_rescore": (["--beam", "--beam-impl", "xla", "--fst", "l.fst",
                     "--fst-osyms", "fst_words.txt"],) * 2,
    "graph": (["--graph-decode", "--lexicon", "lexicon.txt", "--words",
               "words.txt", "--lm", "words.arpa", "--graph-topk", "4"],) * 2,
    "graph_fst": (["--graph-decode", "--fst", "l.fst", "--fst-osyms",
                   "fst_words.txt"],) * 2,
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_test_prints_the_jax_pipelines_wer(scored, mode, monkeypatch):
    """``cli.test`` against the JAX ``test.py`` on the same weights and
    manifest, in every decoding mode: the same summary line, the same
    references and hypotheses handed to ``wer`` (unit tokens, words from
    the lexicon, the n-best entry that rescoring picks, the graph's words),
    and one printed line an utterance that shows those hypotheses."""
    import tpuasr.cli.test as j_test_cli
    tmp, path, units = scored
    ours, theirs = ([str(tmp / a) if (tmp / a).exists() else a for a in x]
                    for x in MODES[mode])
    common = ["resnet_ctc", "--manifest", str(path), "--units",
              str(tmp / "units.txt"), "--batch-size", "4", "--beam-width",
              "4"]
    rc, lines, calls = _run(test_cli, common + [
        "--checkpoint", str(tmp / "w.npz"), "--device", "cpu"] + ours,
        monkeypatch)
    jrc, jlines, jcalls = _run(j_test_cli, common + [
        "--checkpoint", str(tmp / "w.msgpack")] + theirs, monkeypatch)
    assert rc == jrc == 0
    assert lines[-1] == jlines[-1]
    assert calls == jcalls
    # The token error rate comes first, then the word error rate with a
    # lexicon; a graph decode scores words only. The printed line is the
    # words where there are words, else the unit tokens.
    word_mode = "--words" in ours or "--graph-decode" in ours
    assert len(calls) == (2 if mode == "rescore_words" else 1)
    hyps = calls[-1][1] if word_mode else calls[0][1]
    assert len(lines) == len(hyps) + 1 == 7
    assert sorted(ln.split("\t")[0] for ln in lines[:-1]) == [
        f"u{i}" for i in range(6)]
    for ln, h in zip(lines[:-1], hyps):
        text = " ".join(h) if word_mode else " ".join(units[t] for t in h)
        assert ln.split("\t")[1] == text


# The JAX command's host outputs, each flag once: (its arguments, the
# archive or manifest it writes under OUT). OUT is each command's own
# directory.
HOST_FLAGS = {
    "align": (["--align", "OUT/ali"], "ali"),
    "dump_loglikes": (["--dump-loglikes", "OUT/lp.v1"], "lp.v1"),
    "write_segments": (["--align", "OUT/ali", "--write-segments",
                        "OUT/seg.jsonl"], "seg.jsonl"),
    "fst_decode": (["--fst-decode", "--fst", "l.fst", "--fst-osyms",
                    "fst_words.txt"], None),
}


@pytest.mark.parametrize("flag", list(HOST_FLAGS))
def test_cli_test_refuses_unported_flags(scored, flag, monkeypatch):
    """The four flags ``cli.test`` once refused as unported now run beside
    JAX's ``test.py`` on the same weights: the same summary and '# wrote'
    lines and the same hypotheses handed to ``wer``; the alignments' frame
    labels exact, the log-probs within 1e-4 (the model's bound against
    JAX), the manifest's aligned segments equal; ``--fst-decode`` scores
    the first pass's words over the lexicon transducer."""
    import tpuasr.cli.test as j_test_cli
    from tpuasr.utils import kaldi_io as j_kaldi_io
    from tpuasr_torch.utils import kaldi_io

    tmp, path, units = scored
    extra, written = HOST_FLAGS[flag]
    got = {}
    for tag, cli, weights, dev in (
            ("port", test_cli, "w.npz", ["--device", "cpu"]),
            ("jax", j_test_cli, "w.msgpack", [])):
        out = tmp / f"host_{flag}_{tag}"
        out.mkdir()
        argv = ["resnet_ctc", "--manifest", str(path), "--units",
                str(tmp / "units.txt"), "--batch-size", "4", "--checkpoint",
                str(tmp / weights), *dev,
                *[str(tmp / a) if (tmp / a).exists()
                  else a.replace("OUT", str(out)) for a in extra]]
        rc, lines, calls = _run(cli, argv, monkeypatch)
        assert rc == 0
        got[tag] = ([ln.replace(str(out), "OUT") for ln in lines
                     if ln.startswith(("#", "utterances:"))], calls, out)
    (lines, calls, out), (jlines, jcalls, jout) = got["port"], got["jax"]
    assert lines == jlines and calls == jcalls
    assert len(lines) == (1 if written is None
                          else 1 + len(extra) // 2)
    if flag == "fst_decode":
        assert "final-reached" in lines[-1] and len(calls[0][1]) == 6
    elif flag == "write_segments":
        from tpuasr_torch.data import read_manifest
        segs = [(u.id, u.segments) for u in read_manifest(out / written)]
        assert segs == [(u.id, u.segments)
                        for u in j_read_manifest(jout / written)]
        assert any(s for _, s in segs)
    else:
        a = list(kaldi_io.read_ark(out / f"{written}.ark"))
        b = list(j_kaldi_io.read_ark(jout / f"{written}.ark"))
        assert [k for k, _ in a] == [k for k, _ in b]
        assert sorted(k for k, _ in a) == [f"u{i}" for i in range(6)]
        for (_, x), (_, y) in zip(a, b):
            if flag == "align":
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
