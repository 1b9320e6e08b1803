"""A device-resident training corpus: the port's counterpart of
``tpuasr/data/device_corpus.py``.

A corpus that fits a byte budget is decoded once and uploaded to the
device once, as one store per length bucket: wav (N_b, S_b) f32,
wav_lens and token_lens (N_b,) i32, tokens (N_b, U) i32, padded and
truncated by exactly the rules of ``AudioLoader.make_batch``. Each batch of
``batches(epoch)`` then follows the loader's own ``batch_plan(epoch)`` (the
same utterances in the same order) and is gathered on the device by
``index_select`` (JAX uses ``jnp.take``, not a kernel). ``real`` is
recomputed on the device: a row that repeats an earlier row of the batch
(the repeat-padded last batch of a bucket) is not real. Batches are bit for
bit the streaming loader's, without ``ids``.

``augment`` draws host random numbers per epoch, which a gather cannot
reproduce: ``DeviceCorpus`` raises ``ValueError`` on it as JAX's does (and
``try_build`` then returns None: stream instead), and on a corpus over
``max_bytes``. Frame labels are not ported (the loader refuses them).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuasr_torch.data.loader import AudioLoader
from tpuasr_torch.utils.device import resolve_device


class DeviceCorpus:
    """Whole-corpus residency on ``device`` (the card unless the caller
    asks for the CPU) for an ``AudioLoader``."""

    def __init__(self, loader: AudioLoader, device="cuda",
                 max_bytes: int = 4 << 30):
        cfg = loader.cfg
        if cfg.augment:
            raise ValueError("augment uses host RNG state per epoch; "
                             "stream instead")
        self.device = resolve_device(device)
        self.loader = loader
        nb = len(loader.buckets.boundaries)
        by_bucket: dict[int, list[int]] = {}
        self._row_of = np.zeros((len(loader.utts), 2), np.int64)
        for i, u in enumerate(loader.utts):
            b = loader.buckets.bucket_of(u.num_samples)
            if b < 0:
                b = nb - 1
            rows = by_bucket.setdefault(b, [])
            self._row_of[i] = (b, len(rows))
            rows.append(i)
        total = 0
        for b, rows in by_bucket.items():
            S = loader.buckets.padded_len(b)
            total += len(rows) * (S * 4 + cfg.max_label_len * 4 + 8)
        if total > max_bytes:
            raise ValueError(f"corpus store {total / 2**20:.0f} MiB exceeds "
                             f"budget {max_bytes / 2**20:.0f} MiB; stream")
        self.nbytes = total
        self._stores: dict[int, dict[str, torch.Tensor]] = {}
        for b, rows in sorted(by_bucket.items()):
            S = loader.buckets.padded_len(b)
            N = len(rows)
            wav = np.zeros((N, S), np.float32)
            wav_lens = np.zeros((N,), np.int32)
            tokens = np.zeros((N, cfg.max_label_len), np.int32)
            token_lens = np.zeros((N,), np.int32)
            for r, i in enumerate(rows):
                u = loader.utts[i]
                data = loader._wav(u)[:S]
                wav[r, :len(data)] = data
                wav_lens[r] = len(data)
                toks = u.tokens[:cfg.max_label_len]
                tokens[r, :len(toks)] = toks
                token_lens[r] = len(toks)
            store = dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                         token_lens=token_lens)
            self._stores[b] = {k: torch.from_numpy(v).to(self.device)
                               for k, v in store.items()}
        # The store is the cache now: do not hold the corpus twice.
        loader._cache.clear()
        loader._cache_nbytes = 0

    def batches(self, epoch: int):
        """Yield (n_real_utts, device batch): the streaming loader's plan,
        order and contents, gathered on the device."""
        for chunk in self.loader.batch_plan(epoch):
            b = int(self._row_of[chunk[0], 0])
            rows = torch.from_numpy(self._row_of[np.asarray(chunk), 1]).to(
                self.device)
            yield len(set(chunk)), gather_batch(self._stores[b], rows)


def gather_batch(store: dict, rows: torch.Tensor) -> dict:
    out = {k: torch.index_select(v, 0, rows) for k, v in store.items()}
    # A row is real at its first occurrence only.
    same = rows[:, None] == rows[None, :]
    out["real"] = ~torch.tril(same, diagonal=-1).any(dim=1)
    return out


def try_build(loader: AudioLoader, device="cuda",
              max_bytes: int = 4 << 30) -> DeviceCorpus | None:
    """A DeviceCorpus, or None where the loader must stream (augment, or
    over the budget)."""
    try:
        return DeviceCorpus(loader, device, max_bytes=max_bytes)
    except ValueError:
        return None
