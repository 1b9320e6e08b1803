"""Bucketed batch loader: the port's copy of ``tpuasr/data/loader.py``.

Fixed bucket shapes, wav decode on the host, featurization on the device
afterwards, a deterministic (seeded, resumable by epoch) batch plan, and an
LRU cache of decoded waveforms under a byte budget. With ``native_io`` (the
default) a batch's uncached wavs are decoded in one call by the native
multithreaded reader (``data/native_wav.py``, ``native/wav_batch.cc``),
bit for bit what ``manifest.load_wav`` (scipy) gives; JAX falls back to
scipy when its library is not built, the port raises instead.
``native_io=False`` reads every wav by scipy. ``augment`` scales each
utterance by a gain drawn from ``gain_range`` and, with ``noise_std`` > 0,
adds Gaussian noise, drawn from the loader's own
``np.random.default_rng(seed + 104729)`` in JAX's order (one stream over
the loader's life, one gain then one noise vector per row), so the batches
equal JAX's bit for bit. Per-frame labels (``frame_label_cfg``,
``unlabeled_frames``) are not ported: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from tpuasr_torch.data.bucketing import BucketSpec, make_buckets
from tpuasr_torch.data.manifest import Utterance, load_wav, read_manifest


@dataclasses.dataclass
class LoaderConfig:
    """The JAX ``LoaderConfig``: same fields and defaults."""

    batch_size: int = 8
    max_label_len: int = 64
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False
    max_waste: float = 0.2
    max_buckets: int = 6
    bucket_quantum: int = 1
    frame_label_cfg: object = None
    unlabeled_frames: bool = False
    augment: bool = False
    gain_range: tuple = (0.8, 1.2)
    noise_std: float = 0.0
    native_io: bool = True
    cache_bytes: int = 1 << 30


def _unsupported(cfg: LoaderConfig) -> list[str]:
    bad = {"frame_label_cfg (frame-wise objectives, ROADMAP Queue 1 item 12)":
           cfg.frame_label_cfg is not None,
           "unlabeled_frames (ROADMAP Queue 1 item 12)": cfg.unlabeled_frames}
    return [name for name, on in bad.items() if on]


class AudioLoader:
    """Iterates fixed-shape batches:
    dict(wav (B, S_bucket) f32, wav_lens (B,) i32, tokens (B, U) i32
    (pad 0), token_lens (B,) i32, ids list[str], real (B,) bool).

    Batches are homogeneous in bucket, so an epoch touches at most
    ``len(buckets)`` distinct shapes; a short last batch of a bucket
    repeats its utterances, flagged ``real`` False.
    """

    def __init__(self, manifest, cfg: LoaderConfig | None = None,
                 bucket_spec: BucketSpec | None = None):
        self.cfg = cfg or LoaderConfig()
        bad = _unsupported(self.cfg)
        if bad:
            raise NotImplementedError(
                f"tpuasr_torch's AudioLoader does not port {', '.join(bad)}")
        self.utts: list[Utterance] = (
            read_manifest(manifest) if not isinstance(manifest, list)
            else manifest)
        if not self.utts:
            raise ValueError("empty manifest")
        lens = [u.num_samples for u in self.utts]
        self.buckets = bucket_spec or make_buckets(
            lens, max_waste=self.cfg.max_waste,
            max_buckets=self.cfg.max_buckets,
            quantum=self.cfg.bucket_quantum)
        self._cache: collections.OrderedDict[str, np.ndarray] = (
            collections.OrderedDict())
        self._cache_nbytes = 0
        self._scratch: dict[str, np.ndarray] = {}   # batch-local, no budget
        self.epoch = 0
        self._aug_rng = np.random.default_rng(self.cfg.seed + 104729)

    # -- deterministic, resumable batch plan --------------------------------

    def batch_plan(self, epoch: int) -> list[list[int]]:
        """List of batches (utterance indices), grouped by bucket."""
        order = np.arange(len(self.utts))
        if self.cfg.shuffle:
            rng = np.random.default_rng(self.cfg.seed + epoch)
            rng.shuffle(order)
        by_bucket: dict[int, list[int]] = {}
        for i in order:
            b = self.buckets.bucket_of(self.utts[i].num_samples)
            if b < 0:
                b = len(self.buckets.boundaries) - 1  # truncate overlong
            by_bucket.setdefault(b, []).append(int(i))
        plan = []
        B = self.cfg.batch_size
        for b, idxs in sorted(by_bucket.items()):
            for s in range(0, len(idxs), B):
                chunk = idxs[s:s + B]
                if len(chunk) < B:
                    if self.cfg.drop_last:
                        continue
                    # Repeat-pad to a full batch (fixed shapes); the
                    # repeated rows are flagged by `real`.
                    chunk = (chunk * ((B // len(chunk)) + 1))[:B]
                plan.append(chunk)
        if self.cfg.shuffle:
            rng = np.random.default_rng(self.cfg.seed * 7919 + epoch)
            rng.shuffle(plan)
        return plan

    def _cache_get(self, uid: str) -> np.ndarray | None:
        data = self._scratch.get(uid)
        if data is not None:
            return data
        data = self._cache.get(uid)
        if data is not None:
            self._cache.move_to_end(uid)   # LRU touch
        return data

    def _cache_put(self, uid: str, data: np.ndarray) -> None:
        if self.cfg.cache_bytes <= 0:
            self._scratch[uid] = data      # cleared at the next make_batch
            return
        prev = self._cache.pop(uid, None)
        if prev is not None:
            self._cache_nbytes -= prev.nbytes
        self._cache[uid] = data
        self._cache_nbytes += data.nbytes
        # Evict LRU entries past the budget, always keeping the newest one.
        while (self._cache_nbytes > self.cfg.cache_bytes
               and len(self._cache) > 1):
            _, old = self._cache.popitem(last=False)
            self._cache_nbytes -= old.nbytes

    def _wav(self, u: Utterance) -> np.ndarray:
        data = self._cache_get(u.id)
        if data is None:
            data, sr = load_wav(u.wav)
            if sr != u.sample_rate:
                raise ValueError(f"{u.id}: sr {sr} != {u.sample_rate}")
            self._cache_put(u.id, data)
        return data

    def _prefetch(self, utts: list[Utterance]) -> None:
        """Decode a batch's uncached wavs with the native reader in one
        call (JAX's rule: only when two or more are uncached)."""
        if not self.cfg.native_io:
            return
        todo = [u for u in utts if self._cache_get(u.id) is None]
        if len(todo) < 2:
            return
        from tpuasr_torch.data.native_wav import load_wav_batch
        out, lens, srs = load_wav_batch([u.wav for u in todo],
                                        max(u.num_samples for u in todo))
        for j, u in enumerate(todo):
            if srs[j] != u.sample_rate:
                raise ValueError(f"{u.id}: sr {srs[j]} != {u.sample_rate}")
            self._cache_put(u.id, out[j, :lens[j]].copy())

    def make_batch(self, idxs: list[int]) -> dict:
        self._scratch = {}
        utts = [self.utts[i] for i in idxs]
        self._prefetch(utts)
        bucket = max(self.buckets.bucket_of(u.num_samples) for u in utts)
        if bucket < 0:
            bucket = len(self.buckets.boundaries) - 1
        S = self.buckets.padded_len(bucket)
        B = len(utts)
        U = self.cfg.max_label_len
        wav = np.zeros((B, S), np.float32)
        wav_lens = np.zeros((B,), np.int32)
        tokens = np.zeros((B, U), np.int32)
        token_lens = np.zeros((B,), np.int32)
        real = np.zeros((B,), bool)
        seen = set()
        cfg = self.cfg
        for j, u in enumerate(utts):
            data = self._wav(u)[:S]
            if cfg.augment:
                data = data * self._aug_rng.uniform(*cfg.gain_range)
                if cfg.noise_std > 0:
                    data = data + self._aug_rng.normal(
                        0.0, cfg.noise_std, size=len(data)).astype(
                            np.float32)
            wav[j, :len(data)] = data
            wav_lens[j] = len(data)
            toks = u.tokens[:U]
            tokens[j, :len(toks)] = toks
            token_lens[j] = len(toks)
            real[j] = u.id not in seen
            seen.add(u.id)
        return dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                    token_lens=token_lens, ids=[u.id for u in utts],
                    real=real)

    def __iter__(self):
        for chunk in self.batch_plan(self.epoch):
            yield self.make_batch(chunk)
        self.epoch += 1

    def __len__(self):
        return len(self.batch_plan(self.epoch))
