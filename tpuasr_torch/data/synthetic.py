"""Synthetic tone corpora for tests, smoke training and accuracy runs: the
port's copy of ``make_synthetic_corpus`` and ``make_word_corpus`` in
``tpuasr/data/synthetic.py``. For the same arguments they write the same
wav bytes, the same manifest and (the word corpus) the same ``lexicon.txt``
and ``words.txt``.

Each vocabulary token is a distinct pure tone; an utterance is a sequence of
tone segments plus noise. A model that learns tone -> token exercises the
whole wav -> featurizer -> AM -> CTC -> decode pipeline, with no download.
The word corpus spells words from a lexicon of phone tones in confusable
pairs, with homophones that only a grammar can tell apart.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from tpuasr_torch.data.manifest import Utterance, write_manifest


@dataclasses.dataclass
class SyntheticCorpus:
    root: Path
    manifest: Path
    vocab: list      # token names, index = id (0 = <blank>)
    sample_rate: int


@dataclasses.dataclass
class WordCorpus:
    root: Path
    manifest: Path
    vocab: list          # phone names, index = id (0 = <blank>)
    sample_rate: int
    lexicon: Path        # 'WORD ph ph ph' lines
    words_txt: Path      # Kaldi-style word symbol table
    word_prons: list     # [(word_name, (phone_id, ...)), ...] in word-id order


def make_synthetic_corpus(root, num_utts: int = 32, vocab_size: int = 8,
                          sample_rate: int = 8000, min_tokens: int = 2,
                          max_tokens: int = 6, tone_ms: float = 150.0,
                          noise: float = 0.05, seed: int = 0,
                          split: str = "train",
                          markov: float = 0.0) -> SyntheticCorpus:
    """Write wavs + manifest under root; returns corpus description.

    Token id k (1..vocab_size-1) is a tone at 300 + 170*k Hz; id 0 is the CTC
    blank and never appears in transcripts.

    markov: probability that each token is the successor (prev mod V-1 + 1)
    of the previous one instead of uniform random — gives transcripts n-gram
    structure so a language model carries real signal (LM-gain tests).
    """
    from scipy.io import wavfile

    root = Path(root)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tone_n = int(sample_rate * tone_ms / 1000.0)
    utts = []
    for i in range(num_utts):
        n_tok = int(rng.integers(min_tokens, max_tokens + 1))
        if markov <= 0.0:
            toks = rng.integers(1, vocab_size, size=n_tok).tolist()
        else:
            toks = [int(rng.integers(1, vocab_size))]
            while len(toks) < n_tok:
                if rng.random() < markov:
                    toks.append(toks[-1] % (vocab_size - 1) + 1)
                else:
                    toks.append(int(rng.integers(1, vocab_size)))
        segments = [[int(k), j * tone_n, (j + 1) * tone_n]
                    for j, k in enumerate(toks)]
        segs = []
        for k in toks:
            freq = 300.0 + 170.0 * k
            t = np.arange(tone_n) / sample_rate
            # Random phase + amplitude jitter so the task isn't trivial.
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.4, 0.8)
            seg = amp * np.sin(2 * np.pi * freq * t + ph)
            # Hann ramp to avoid clicks.
            ramp = int(0.01 * sample_rate)
            env = np.ones(tone_n)
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] = np.linspace(1, 0, ramp)
            segs.append(seg * env)
        wav = np.concatenate(segs)
        wav = wav + noise * rng.standard_normal(len(wav))
        wav16 = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
        name = f"{split}_{i:04d}"
        path = root / "wav" / f"{name}.wav"
        wavfile.write(path, sample_rate, wav16)
        utts.append(Utterance(
            id=name, wav=str(path), tokens=[int(t) for t in toks],
            text=" ".join(f"t{t}" for t in toks),
            num_samples=len(wav16), sample_rate=sample_rate,
            segments=segments))
    manifest = root / f"{split}.jsonl"
    write_manifest(manifest, utts)
    vocab = ["<blank>"] + [f"t{k}" for k in range(1, vocab_size)]
    (root / "units.txt").write_text("\n".join(vocab) + "\n")
    return SyntheticCorpus(root=root, manifest=manifest, vocab=vocab,
                           sample_rate=sample_rate)


def _phone_freq(k: int, confusable_hz: float) -> float:
    """Phone id -> tone frequency, arranged in CONFUSABLE PAIRS.

    Phones (2p-1, 2p) share pair center 300 + 160*p Hz and differ by only
    ``confusable_hz`` — well inside one mel bin at the low end, so the AM's
    per-frame posteriors genuinely smear between pair members and beam
    search's path-probability aggregation has something to fix that greedy
    per-frame argmax cannot (an accuracy harness needs acoustic ambiguity,
    not just noise).
    """
    pair = (k + 1) // 2
    sign = 1.0 if k % 2 == 0 else -1.0
    return 300.0 + 160.0 * pair + sign * confusable_hz / 2.0


def make_word_corpus(root, num_utts: int = 300, num_words: int = 40,
                     vocab_size: int = 14, sample_rate: int = 8000,
                     words_per_utt=(3, 8), pron_len=(2, 4),
                     tone_ms=(80.0, 140.0), noise=(0.25, 0.6),
                     confusable_hz: float = 35.0,
                     freq_jitter_hz: float = 10.0, seed: int = 0,
                     split: str = "train", markov: float = 0.0,
                     homophones: int = 0,
                     word_prons: list | None = None) -> WordCorpus:
    """Harder word-level synthetic corpus for accuracy harnesses.

    Differences vs ``make_synthetic_corpus`` (which stays the cheap smoke
    corpus): a word lexicon (transcripts are word sequences; tokens are the
    concatenated phone pronunciations), confusable phone pairs, per-token
    duration + frequency jitter, and a per-utterance SNR sweep. Writes
    ``lexicon.txt`` + ``words.txt`` next to the manifest so word-level WER
    can be scored through ``tpuasr_torch.decode.Lexicon``/``LexiconDecoder``.

    Pass ``word_prons`` (from a previous call's return) to share the SAME
    lexicon between train and eval splits.

    ``homophones``: the last N words REUSE the pronunciations of the first
    N words (real-language ambiguity the lexicon alone cannot resolve —
    only grammar context can pick the right word, so a grammar-bearing
    decode must beat any lexicon-only decode on such a corpus; word
    sampling is Markov-biased, see ``markov``, so context IS informative).
    """
    from scipy.io import wavfile

    root = Path(root)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    if word_prons is None:
        # Unique random pronunciations over the phone inventory.
        seen = set()
        word_prons = []
        pron_rng = np.random.default_rng(1000 + num_words)
        while len(word_prons) < num_words:
            L = int(pron_rng.integers(pron_len[0], pron_len[1] + 1))
            pron = tuple(int(p) for p in
                         pron_rng.integers(1, vocab_size, size=L))
            if pron in seen:
                continue
            seen.add(pron)
            word_prons.append((f"w{len(word_prons):03d}", pron))
        for h in range(min(homophones, num_words // 2)):
            i = len(word_prons) - 1 - h
            word_prons[i] = (word_prons[i][0], word_prons[h][1])
    W = len(word_prons)

    utts = []
    for i in range(num_utts):
        n_words = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        wids = [int(rng.integers(0, W))]
        while len(wids) < n_words:
            if markov > 0.0 and rng.random() < markov:
                wids.append((wids[-1] + 1) % W)
            else:
                wids.append(int(rng.integers(0, W)))
        toks = [p for w in wids for p in word_prons[w][1]]
        segs, segments, pos = [], [], 0
        for k in toks:
            tone_n = int(sample_rate
                         * rng.uniform(tone_ms[0], tone_ms[1]) / 1000.0)
            freq = (_phone_freq(k, confusable_hz)
                    + rng.uniform(-freq_jitter_hz, freq_jitter_hz))
            t = np.arange(tone_n) / sample_rate
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.35, 0.8)
            seg = amp * np.sin(2 * np.pi * freq * t + ph)
            ramp = max(1, int(0.008 * sample_rate))
            env = np.ones(tone_n)
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] = np.linspace(1, 0, ramp)
            segs.append(seg * env)
            segments.append([int(k), pos, pos + tone_n])
            pos += tone_n
        wav = np.concatenate(segs)
        snr_noise = rng.uniform(noise[0], noise[1])
        wav = wav + snr_noise * rng.standard_normal(len(wav))
        wav16 = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
        name = f"{split}_{i:04d}"
        path = root / "wav" / f"{name}.wav"
        wavfile.write(path, sample_rate, wav16)
        utts.append(Utterance(
            id=name, wav=str(path), tokens=[int(t) for t in toks],
            text=" ".join(word_prons[w][0] for w in wids),
            num_samples=len(wav16), sample_rate=sample_rate,
            segments=segments))
    manifest = root / f"{split}.jsonl"
    write_manifest(manifest, utts)
    vocab = ["<blank>"] + [f"p{k}" for k in range(1, vocab_size)]
    (root / "units.txt").write_text("\n".join(vocab) + "\n")
    lexicon = root / "lexicon.txt"
    lexicon.write_text("".join(
        f"{w} {' '.join(vocab[p] for p in pron)}\n"
        for w, pron in word_prons))
    words_txt = root / "words.txt"
    words_txt.write_text("".join(
        f"{w} {i}\n" for i, (w, _) in enumerate(word_prons)))
    return WordCorpus(root=root, manifest=manifest, vocab=vocab,
                      sample_rate=sample_rate, lexicon=lexicon,
                      words_txt=words_txt, word_prons=word_prons)
