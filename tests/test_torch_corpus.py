"""The port's training-input modules against the JAX package's (CPU): the
loader's waveform augmentation (``augment``, ``gain_range``,
``noise_std``) and ``prepare_kaldi_dir``.

Both are host numpy code: the port's batches and manifests must equal
JAX's exactly (same seeds, same draws in the same order).
"""

import numpy as np
import pytest
from scipy.io import wavfile

from tpuasr.data import AudioLoader as JAudioLoader
from tpuasr.data import LoaderConfig as JLoaderConfig
from tpuasr.data.corpus import prepare_kaldi_dir as j_prepare
from tpuasr.data.manifest import read_manifest as j_read_manifest
from tpuasr.decode.lexicon import Lexicon as JLexicon
from tpuasr.decode.lexicon import SymbolTable as JSymbolTable
from tpuasr_torch.data import (AudioLoader, LoaderConfig,
                               make_synthetic_corpus, read_manifest)
from tpuasr_torch.data.corpus import prepare_kaldi_dir
from tpuasr_torch.data.device_corpus import DeviceCorpus, try_build
from tpuasr_torch.decode.lexicon import Lexicon, SymbolTable


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return make_synthetic_corpus(root, num_utts=11, vocab_size=6, seed=3,
                                 max_tokens=4)


@pytest.mark.parametrize("noise_std,gain_range", [
    (0.01, (0.8, 1.2)), (0.0, (0.5, 1.5))])
def test_augmented_batches_equal_jax(corpus, noise_std, gain_range):
    """augment=True over two epochs (the augmentation stream runs on across
    epochs, as JAX's): every batch field equal to JAX's bit for bit."""
    kw = dict(batch_size=4, max_label_len=8, seed=5, augment=True,
              noise_std=noise_std, gain_range=gain_range, max_buckets=2)
    jl = JAudioLoader(str(corpus.manifest), JLoaderConfig(**kw))
    tl = AudioLoader(str(corpus.manifest), LoaderConfig(**kw))
    n = 0
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            assert set(jb) == set(tb)
            for k in jb:
                if k == "ids":
                    assert jb[k] == tb[k]
                else:
                    assert jb[k].dtype == tb[k].dtype, k
                    np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            n += 1
    assert n == 2 * len(tl.batch_plan(0))
    # The augmentation changed the waveforms.
    plain = AudioLoader(str(corpus.manifest), LoaderConfig(
        **dict(kw, augment=False)))
    assert not np.array_equal(next(iter(plain))["wav"],
                              next(iter(AudioLoader(
                                  str(corpus.manifest),
                                  LoaderConfig(**kw))))["wav"])


def test_device_corpus_still_refuses_augment(corpus):
    """The device-resident corpus gathers fixed waveforms, so with augment
    it raises as JAX's does, and try_build streams instead."""
    loader = AudioLoader(str(corpus.manifest), LoaderConfig(
        batch_size=4, max_label_len=8, augment=True))
    assert try_build(loader, "cpu") is None
    with pytest.raises(ValueError, match="augment"):
        DeviceCorpus(loader, "cpu")


@pytest.fixture
def kaldi_dir(tmp_path):
    # tests/test_corpus_prep.py's data dir (its rng fixture: seed 0).
    rng = np.random.default_rng(0)
    d = tmp_path / "data"
    d.mkdir()
    wavs = {}
    for i, uid in enumerate(["utt_a", "utt_b"]):
        path = tmp_path / f"{uid}.wav"
        wavfile.write(path, 8000,
                      (rng.standard_normal(8000 * (i + 1)) * 3000)
                      .astype(np.int16))
        wavs[uid] = str(path)
    (d / "wav.scp").write_text(
        "".join(f"{k} {v}\n" for k, v in wavs.items()))
    (d / "text").write_text("utt_a cat dog\nutt_b dog\n")
    return d


def _both(kaldi_dir, tmp_path, jkw, tkw):
    """The two packages' utterances and manifest files, compared."""
    ju = j_prepare(kaldi_dir, tmp_path / "j.jsonl", **jkw)
    tu = prepare_kaldi_dir(kaldi_dir, tmp_path / "t.jsonl", **tkw)
    assert [vars(u) for u in tu] == [vars(u) for u in ju]
    assert ((tmp_path / "t.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())
    assert ([vars(u) for u in read_manifest(tmp_path / "t.jsonl")]
            == [vars(u) for u in j_read_manifest(tmp_path / "j.jsonl")])
    return tu


def test_prepare_with_lexicon(kaldi_dir, tmp_path):
    jwords = JSymbolTable.from_list(["<eps>", "cat", "dog"])
    words = SymbolTable.from_list(["<eps>", "cat", "dog"])
    jlex = JLexicon([(jwords["cat"], (1, 2, 3)), (jwords["dog"], (4, 5, 6))])
    lex = Lexicon([(words["cat"], (1, 2, 3)), (words["dog"], (4, 5, 6))])
    utts = _both(kaldi_dir, tmp_path, dict(lexicon=jlex, words=jwords),
                 dict(lexicon=lex, words=words))
    assert [u.tokens for u in utts] == [[1, 2, 3, 4, 5, 6], [4, 5, 6]]
    assert utts[0].num_samples == 8000


def test_prepare_with_units(kaldi_dir, tmp_path):
    syms = ["<blank>", "cat", "dog"]
    utts = _both(kaldi_dir, tmp_path,
                 dict(units=JSymbolTable.from_list(syms)),
                 dict(units=SymbolTable.from_list(syms)))
    assert utts[0].tokens == [1, 2]


def test_pipe_entries_rejected(kaldi_dir, tmp_path):
    (kaldi_dir / "wav.scp").write_text("utt_x sox a.flac -t wav - |\n")
    for fn in (j_prepare, prepare_kaldi_dir):
        with pytest.raises(ValueError, match="pipe"):
            fn(kaldi_dir, tmp_path / "m.jsonl")


def test_missing_wav_skipped_or_strict(kaldi_dir, tmp_path):
    (kaldi_dir / "wav.scp").write_text("utt_missing /nope/missing.wav\n")
    assert _both(kaldi_dir, tmp_path, {}, {}) == []
    for fn in (j_prepare, prepare_kaldi_dir):
        with pytest.raises(FileNotFoundError):
            fn(kaldi_dir, tmp_path / "m.jsonl", strict=True)
