"""A synthetic tone corpus for tests and smoke training: the port's copy of
``make_synthetic_corpus`` in ``tpuasr/data/synthetic.py``. For the same
arguments it writes the same wav bytes and the same manifest.

Each vocabulary token is a distinct pure tone; an utterance is a sequence of
tone segments plus noise. A model that learns tone -> token exercises the
whole wav -> featurizer -> AM -> CTC -> decode pipeline, with no download.
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
