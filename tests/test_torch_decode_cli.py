"""The port's decoding surface beside the JAX package's, on the CPU: the
synthetic word corpus (``make_word_corpus``), ``python -m
tpuasr_torch.cli.lmtool`` and ``python -m tpuasr_torch.cli.predict`` /
``tpuasr_torch.cli.test`` with the host first pass (``--fst-decode``,
``--fst-nbest``, ``--confidence``, ``--write-lattice``, ``--align``), the
forced alignment and confidences of greedy and beam hypotheses, the Kaldi
archives (``--dump-loglikes``, ``--align PREFIX``) and ``--write-segments``.

One seeded ResNet-CTC serves both packages (the port's ``.npz``, and the
same variables as the JAX commands' msgpack checkpoint). The graph is a
lexicon with homophones composed with a word bigram trained by ``lmtool``
on the corpus, so the first pass decides between words that only the
grammar tells apart. Printed lines and archive keys must be equal; the
log-probs in the archives agree within 1e-4 (the model's bound against
JAX, ``tests/test_torch_resnet.py``), the alignments exactly.
"""

import contextlib
import io
import json
import shutil

import flax.serialization
import numpy as np
import pytest
import torch

from tpuasr.data import make_word_corpus as j_make_word_corpus
from tpuasr.utils import kaldi_io as j_kaldi_io
from tpuasr_torch.cli import lmtool, predict
from tpuasr_torch.cli import test as test_cli
from tpuasr_torch.convert import save_npz, to_jax_variables
from tpuasr_torch.data import make_word_corpus, read_manifest
from tpuasr_torch.decode import compose, lexicon_to_fst, ngram_to_fst
from tpuasr_torch.lm import NGramLM
from tpuasr_torch.models import create_model
from tpuasr_torch.utils import kaldi_io

# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]

C = 10
ARCH = dict(stem_channels=8, stage_channels=(8, 16), blocks_per_stage=1,
            dropout=0.0)
CORPUS = dict(num_utts=6, num_words=12, vocab_size=C, words_per_utt=(1, 3),
              pron_len=(2, 3), markov=0.5, homophones=2, seed=3)
LP_TOL = 1e-4


def _corpus_files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_make_word_corpus_bytes_equal_jax(tmp_path):
    """The same wavs, manifest, units, lexicon.txt and words.txt as JAX's
    for one seed, with homophones and Markov word order; a shared lexicon
    (``word_prons``) carries over to a second split."""
    ours = make_word_corpus(tmp_path / "a", **CORPUS)
    theirs = j_make_word_corpus(tmp_path / "b", **CORPUS)
    assert ours.word_prons == theirs.word_prons
    homophones = [p for _, p in ours.word_prons]
    assert len(set(homophones)) == len(homophones) - 2
    files = _corpus_files(tmp_path / "a")
    assert files == _corpus_files(tmp_path / "b")
    for f in files:
        a, b = (tmp_path / "a" / f).read_bytes(), (tmp_path / "b" / f)\
            .read_bytes()
        if f.suffix == ".jsonl":      # wav paths name each root
            a = a.replace(str(tmp_path / "a").encode(), b"ROOT")
            b = b.replace(str(tmp_path / "b").encode(), b"ROOT")
        assert a == b, f
    dev = make_word_corpus(tmp_path / "a", num_utts=3, seed=4, split="dev",
                           word_prons=ours.word_prons, vocab_size=C)
    jdev = j_make_word_corpus(tmp_path / "b", num_utts=3, seed=4,
                              split="dev", word_prons=theirs.word_prons,
                              vocab_size=C)
    assert [u.text for u in read_manifest(dev.manifest)] == [
        u.text for u in read_manifest(jdev.manifest)]


def _run(main, argv):
    """(rc, stdout lines) of one command's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue().strip().splitlines()


def test_lmtool_matches_jax(tmp_path):
    """train (from text, from a manifest with and without units), ppl and
    score: the same lines and the same ARPA bytes."""
    import tpuasr.cli.lmtool as j_lmtool
    c = make_word_corpus(tmp_path / "c", **CORPUS)
    text = tmp_path / "text.txt"
    text.write_text("".join(u.text + "\n" for u in read_manifest(c.manifest)))
    units = str(c.root / "units.txt")
    for name, src in (("words", ["--text", str(text), "--order", "2"]),
                      ("units", ["--manifest", str(c.manifest), "--units",
                                 units]),
                      ("ids", ["--manifest", str(c.manifest), "--order",
                               "4"])):
        outs = []
        for tool, tag in ((lmtool, "port"), (j_lmtool, "jax")):
            out = tmp_path / f"{name}.{tag}.arpa"
            rc, lines = _run(tool.main, ["train", *src, "--out", str(out)])
            assert rc == 0
            outs.append((lines[0].replace(str(out), "OUT"),
                         out.read_bytes()))
            ppl_src = (["--text", str(text)] if name == "words"
                       else ["--manifest", str(c.manifest)]
                       + (["--units", units] if name == "units" else []))
            outs.append(_run(tool.main, ["ppl", "--lm", str(out), *ppl_src]))
            words = (text.read_text().split()[:4] if name == "words"
                     else ["p1", "p2", "zz"])
            outs.append(_run(tool.main, ["score", "--lm", str(out), *words]))
        assert outs[:3] == outs[3:], name
    with pytest.raises(SystemExit, match="--manifest or --text"):
        _run(lmtool.main, ["ppl", "--lm", str(tmp_path / "words.port.arpa")])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The word corpus, one seeded ResNet as the port's .npz and as JAX's
    msgpack checkpoint, a word bigram trained by lmtool, the LG graph (the
    lexicon with its homophones composed with the bigram, olabel = word id
    + 1) as OpenFst text with its output symbols, and three wavs to
    transcribe, two of them with the same basename."""
    tmp = tmp_path_factory.mktemp("served")
    c = make_word_corpus(tmp / "c", **CORPUS)
    tm = create_model("resnet_ctc", num_classes=C, in_features=64, **ARCH,
                      generator=torch.Generator().manual_seed(1))
    meta = dict(model="resnet_ctc", num_classes=C, model_kwargs=ARCH)
    v = to_jax_variables(tm.state_dict())
    save_npz(v, tmp / "w.npz", meta=meta)
    (tmp / "w.msgpack").write_bytes(flax.serialization.msgpack_serialize(v))
    (tmp / "w.json").write_text(json.dumps(meta))
    (tmp / "text.txt").write_text(
        "".join(u.text + "\n" for u in read_manifest(c.manifest)))
    assert _run(lmtool.main, ["train", "--text", str(tmp / "text.txt"),
                              "--order", "2", "--out",
                              str(tmp / "words.arpa")])[0] == 0
    prons = c.word_prons
    lg = compose(lexicon_to_fst(prons),
                 ngram_to_fst(NGramLM.load_arpa(tmp / "words.arpa"),
                              {w: i + 1 for i, (w, _) in enumerate(prons)}))
    lg.save_text(tmp / "lg.fst")
    (tmp / "lg_words.txt").write_text("<eps> 0\n" + "".join(
        f"{w} {i + 1}\n" for i, (w, _) in enumerate(prons)))
    wavs = sorted((c.root / "wav").glob("*.wav"))[:2]
    (tmp / "again").mkdir()
    shutil.copy(wavs[0], tmp / "again" / wavs[0].name)
    wavs = [str(w) for w in wavs] + [str(tmp / "again" / wavs[0].name)]
    return tmp, c, wavs


def _pair(served, cli, jcli, argv, jargv):
    """Run the port's and the JAX command on the same arguments; -> (port
    lines, JAX lines) with each one's output directory written as OUT."""
    tmp = served[0]
    got = {}
    for tag, main, extra in (("port", cli.main, argv), ("jax", jcli.main,
                                                        jargv)):
        d = tmp / tag
        d.mkdir(exist_ok=True)
        args = [a.replace("OUT", str(d)) for a in extra]
        rc, lines = _run(main, args)
        assert rc == 0
        got[tag] = [ln.replace(str(d), "OUT") for ln in lines]
    return got["port"], got["jax"]


def _ark_pair(tmp, prefix):
    a = list(kaldi_io.read_ark(tmp / "port" / f"{prefix}.ark"))
    b = list(j_kaldi_io.read_ark(tmp / "jax" / f"{prefix}.ark"))
    assert [k for k, _ in a] == [k for k, _ in b]
    return a, b


def _lattice_rows(path):
    rows = []
    for line in path.read_text().splitlines():
        f = line.replace(",", " ").split()
        rows.append((f[:3], [float(x) for x in f[3:]]) if len(f) == 5
                    else (f[:1], [float(x) for x in f[1:]]))
    return rows


# (the port's extra arguments, the JAX command's); OUT is each one's own
# output directory. The scan search ("xla") is the beam both run the same.
PREDICT = {
    "fst": ["--fst-decode", "--fst", "lg.fst", "--fst-osyms", "lg_words.txt",
            "--align"],
    "fst_lattice": ["--fst-decode", "--fst", "lg.fst", "--fst-osyms",
                    "lg_words.txt", "--fst-nbest", "3", "--confidence",
                    "--write-lattice", "OUT/lat.txt", "--align",
                    "--fst-beam", "12", "--fst-lattice-beam", "6"],
    "beam": ["--beam", "--beam-impl", "xla", "--beam-width", "4", "--nbest",
             "2", "--confidence", "--align", "--dump-loglikes", "OUT/lp"],
    "greedy": ["--confidence", "--align", "--dump-loglikes", "OUT/lp.v1"],
    "greedy_align": ["--align"],
}


@pytest.mark.parametrize("mode", list(PREDICT))
def test_predict_prints_the_jax_lines(served, mode):
    import tpuasr.cli.predict as j_predict
    tmp, c, wavs = served
    extra = [str(tmp / a) if (tmp / a).exists() else a
             for a in PREDICT[mode]]
    units = ["--units", str(c.root / "units.txt")]
    ours, theirs = _pair(
        served, predict, j_predict,
        ["resnet_ctc", *wavs, "--weights", str(tmp / "w.npz"), *units,
         "--device", "cpu", *extra],
        ["resnet_ctc", *wavs, "--checkpoint", str(tmp / "w.msgpack"),
         *units, *extra])
    assert ours == theirs
    if mode != "fst_lattice":         # there, up to 3 hypotheses a wav
        per = 2 if mode == "beam" else 1
        assert [ln.split("\t")[0] for ln in ours if ln[0] != "#"] == [
            w for w in wavs for _ in range(per)]
    if "--align" in extra:
        assert sum(ln.startswith("# align:") for ln in ours) >= 1
    if "--dump-loglikes" in extra:
        prefix = extra[extra.index("--dump-loglikes") + 1].split("/")[-1]
        a, b = _ark_pair(tmp, prefix)
        assert [k for k, _ in a] == [wavs[0].split("/")[-1][:-4],
                                     wavs[1].split("/")[-1][:-4],
                                     wavs[0].split("/")[-1][:-4] + "-2"]
        for (_, x), (_, y) in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=LP_TOL)
    if mode == "fst_lattice":
        assert sum(ln.startswith("# conf:") for ln in ours) >= 1
        assert any("\t[1] " in ln for ln in ours)
        ra = _lattice_rows(tmp / "port" / "lat.txt")
        rb = _lattice_rows(tmp / "jax" / "lat.txt")
        assert [r[0] for r in ra] == [r[0] for r in rb]
        for (_, x), (_, y) in zip(ra, rb):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


def test_predict_first_pass_rules(served):
    tmp, c, wavs = served
    base = ["resnet_ctc", wavs[0], "--weights", str(tmp / "w.npz"),
            "--device", "cpu"]
    for extra, msg in ((["--fst-decode"], "requires --fst"),
                       (["--fst-decode", "--fst", str(tmp / "lg.fst"),
                         "--beam"], "replaces --beam/--lm"),
                       (["--graph-decode", "--fst-decode", "--fst",
                         str(tmp / "lg.fst")], "replaces --beam/--fst-decode"),
                       (["--fst", str(tmp / "lg.fst")], "--fst requires")):
        with pytest.raises(SystemExit, match=msg):
            _run(predict.main, base + extra)


def test_cli_test_first_pass_with_alignment_and_archives(served,
                                                         monkeypatch):
    """``cli.test --fst-decode --align --write-segments --dump-loglikes``
    beside JAX's test.py: the same summary and '# wrote' lines and word
    hypotheses, frame labels exact, segments equal, log-probs within
    LP_TOL."""
    import tpuasr.cli.test as j_test_cli
    from tpuasr.utils.metrics import wer as j_wer
    tmp, c, _ = served
    calls = {}

    def recorder(tag):
        def rec_wer(refs, hyps):
            calls[tag] = ([list(r) for r in refs], [list(h) for h in hyps])
            return j_wer(refs, hyps)
        return rec_wer

    monkeypatch.setattr(test_cli, "wer", recorder("port"))
    monkeypatch.setattr(j_test_cli, "wer", recorder("jax"))
    extra = ["--fst-decode", "--fst", str(tmp / "lg.fst"), "--fst-osyms",
             str(tmp / "lg_words.txt"), "--align", "OUT/ali",
             "--write-segments", "OUT/seg.jsonl", "--dump-loglikes",
             "OUT/lp", "--batch-size", "4", "--units",
             str(c.root / "units.txt")]
    ours, theirs = _pair(
        served, test_cli, j_test_cli,
        ["resnet_ctc", "--manifest", str(c.manifest), "--checkpoint",
         str(tmp / "w.npz"), "--device", "cpu", *extra],
        ["resnet_ctc", "--manifest", str(c.manifest), "--checkpoint",
         str(tmp / "w.msgpack"), *extra])
    assert [ln for ln in ours if ln.startswith("#")] + ours[-1:] == theirs
    assert "final-reached" in ours[-1]
    assert calls["port"] == calls["jax"]
    a, b = _ark_pair(tmp, "ali")
    assert len(a) == 6
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for (_, x), (_, y) in zip(*_ark_pair(tmp, "lp")):
        np.testing.assert_allclose(x, y, rtol=0, atol=LP_TOL)
    segs = [(u.id, u.segments) for u in read_manifest(tmp / "port"
                                                      / "seg.jsonl")]
    assert segs == [(u.id, u.segments) for u in read_manifest(
        tmp / "jax" / "seg.jsonl")]
    assert any(s for _, s in segs)
