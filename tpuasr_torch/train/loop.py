"""The CTC training step and the epoch loop around it on one device:
``Trainer.train_step``, ``fit`` and ``evaluate``.

Counterpart of ``tpuasr/train/loop.py``. The step: featurize (the plain
``Featurizer``, or ``FusedFeaturizer`` with ``fused_featurizer``) ->
SpecAugment (``spec_augment``, training only) -> the acoustic model in
training mode -> per-utterance CTC NLL (K6/K6b on the card) -> mean over
the batch's real rows -> gradients (K5b for every GRU scan) -> the
optimizer chain (global-norm clip, adamw | adam | nesterov sgd, in
``optax.MultiSteps`` with ``accum_steps`` > 1), in float32 with TF32
off, forward and backward. ``bf16_compute`` casts the features to bf16
before the model, for every model, as JAX does (loop.py:234-235); the
model's own flags (``bf16_gru``, ``bf16_conv``) say where it computes in
bf16, bf16 matmuls sum in full f32 (``precision.full_fp32``), and
the parameters, gradients and optimizer state stay f32. The convs'
backward takes cuDNN's deterministic algorithms (``models.layers._Conv2d``),
so two straight runs give the same bits. PyTorch runs the step eagerly and
updates the model's parameters and batch statistics in place;
``TrainState`` carries the model, the optimizer state and the step count
(a host int).

A batch is a dict of ``wav`` (B, S) f32, ``wav_lens`` (B,), ``tokens``
(B, U) int, ``token_lens`` (B,) and ``real`` (B,) (0 for padding rows), as
the loaders give it; numpy arrays or tensors.

Each step draws its random numbers from streams of its own, a function of
(seed, step, stream), as JAX folds the step into its key (loop.py:332):
stream 0 dropout, stream 1 dither (JAX's fold_in(key, 1)), stream 2
SpecAugment (JAX's fold_in(key, 7)).

``fit`` keeps JAX's epoch loop (loop.py:420-487): the batches of each
epoch from the device-resident corpus (``device_corpus``, "auto" by
default) or from the streaming loader, decoded and packed ahead by a host
thread (``prefetch``; the copy to the card stays on the main thread's
stream); the loss read to the host only at log points; checkpoints every
``ckpt_every_steps`` and at the end (``train/checkpoints.py``, JAX's
msgpack format, so either package resumes the other's); ``continue_from``
a checkpoint file or directory, which restarts the saved epoch from its
first batch while the step count goes on; the dev set evaluated after each
epoch; ``train/loss``, ``dev/loss`` and ``dev/ter`` rows in
``metrics.csv``.

Not ported (they raise ``NotImplementedError``): objectives other than
"ctc", and Grain.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from tpuasr_torch.convert import (from_jax_variables, sorted_tree,
                                  to_jax_variables)
from tpuasr_torch.decode import greedy_decode
from tpuasr_torch.features import FeatureConfig, Featurizer, FusedFeaturizer
from tpuasr_torch.features.augment import spec_augment
from tpuasr_torch.losses import get_ctc_loss
from tpuasr_torch.models import create_model
from tpuasr_torch.precision import full_fp32
from tpuasr_torch.train.checkpoints import restore_checkpoint, save_checkpoint
from tpuasr_torch.train.optim import OptState, Optimizer, global_norm
from tpuasr_torch.utils.device import resolve_device
from tpuasr_torch.utils.logger import MetricsWriter, init_logger
from tpuasr_torch.utils.metrics import wer


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig`` (loop.py:36-100), same fields and defaults."""

    model: str = "deepspeech_ctc"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    num_classes: int = 64
    optimizer: str = "adamw"         # adamw | adam | sgd
    lr: float = 3e-4
    weight_decay: float = 1e-6
    momentum: float = 0.9
    warmup_steps: int = 200
    grad_clip: float = 5.0
    num_epochs: int = 10
    seed: int = 0
    log_every: int = 10
    ckpt_dir: str | None = None
    ckpt_every_steps: int = 500
    continue_from: str | None = None
    bf16_compute: bool = False
    ctc_impl: str = "auto"           # auto | ref | fb | pallas
    fused_featurizer: bool = False
    objective: str = "ctc"
    label_stride: int = 2
    ssvae_alpha: float = 1.0
    prefetch: int = 2
    device_corpus: bool | str = "auto"
    device_corpus_bytes: int = 4 << 30
    use_grain: bool = False
    grain_workers: int = 0
    spec_augment: bool = False
    sa_freq_masks: int = 2
    sa_freq_width: int = 12
    sa_time_masks: int = 2
    sa_time_frac: float = 0.05
    accum_steps: int = 1
    lr_schedule: str = "warmup"
    decay_steps: int = 10000
    min_lr_frac: float = 0.05


def _unsupported(cfg: TrainConfig) -> list[str]:
    bad = {"objective != 'ctc' (ROADMAP Queue 1 item 12)":
           cfg.objective != "ctc",
           "use_grain (ROADMAP Queue 1 item 5)": cfg.use_grain}
    return [name for name, on in bad.items() if on]


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module            # parameters and batch statistics
    opt_state: OptState

    def variables(self) -> dict:
        """The model's state as a Flax variable tree of numpy arrays."""
        return to_jax_variables(self.model.state_dict())


class Trainer:
    """Trainer(cfg, feat_cfg, device, logger): ``train_step``,
    ``eval_step``, ``fit`` and ``evaluate``.

    The device defaults to the card; a CUDA device that is absent is an
    error (``resolve_device``), never a quiet move to the CPU.
    """

    def __init__(self, cfg: TrainConfig, feat_cfg: FeatureConfig | None = None,
                 device="cuda", logger=None):
        self.cfg = cfg
        self.feat_cfg = feat_cfg or FeatureConfig()
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"tpuasr_torch's Trainer does not port {', '.join(bad)}")
        self.device = resolve_device(device)
        fz = FusedFeaturizer if cfg.fused_featurizer else Featurizer
        self.featurizer = fz(self.feat_cfg, self.device)
        self._ctc = get_ctc_loss(cfg.ctc_impl)
        self.optimizer = Optimizer(cfg)
        self.log = logger or init_logger()
        self._dc = None                  # (loader, DeviceCorpus | None)

    # ---- state ----

    def init_state(self, variables: dict | None = None) -> TrainState:
        """A fresh state: the model's weights from ``cfg.seed`` (a torch
        generator, so not JAX's values), or from a Flax variable tree
        ``{"params": ..., "batch_stats": ...}`` such as the JAX Trainer's
        ``init_state`` gives."""
        cfg = self.cfg
        model = create_model(cfg.model, num_classes=cfg.num_classes,
                             in_features=self.feat_cfg.feat_dim,
                             generator=torch.Generator().manual_seed(cfg.seed),
                             **cfg.model_kwargs)
        if variables is not None:
            tree = {k: variables[k] for k in ("params", "batch_stats")
                    if k in variables}
            model.load_state_dict(from_jax_variables(tree))
        model.to(self.device)
        params = [p for p in model.parameters()]
        return TrainState(step=0, model=model,
                          opt_state=self.optimizer.init(params))

    def state_tree(self, state: TrainState) -> dict:
        """The checkpoint tree of ``state``: flax's ``to_state_dict`` of
        JAX's ``TrainState`` (step, params, batch_stats, opt_state)."""
        variables = sorted_tree(to_jax_variables(state.model.state_dict()))
        names = [n for n, _ in state.model.named_parameters()]
        return {"step": np.asarray(state.step, np.int32),
                "params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": self.optimizer.state_tree(state.opt_state,
                                                       names)}

    def load_state_tree(self, state: TrainState, tree: dict) -> TrainState:
        """``state`` with the weights, optimizer state and step of a
        checkpoint tree (the port's or JAX's)."""
        model = state.model
        model.load_state_dict(from_jax_variables(
            {k: tree[k] for k in ("params", "batch_stats") if k in tree}))
        names, params = zip(*model.named_parameters())
        opt_state = self.optimizer.load_state_tree(tree["opt_state"],
                                                   list(params), list(names))
        return TrainState(step=int(tree["step"]), model=model,
                          opt_state=opt_state)

    # ---- steps ----

    def _host_batch(self, batch: dict) -> dict:
        """A loader batch as host tensors, pinned for the copy to the card
        (done on the prefetch thread)."""
        out = {}
        for k in ("wav", "wav_lens", "tokens", "token_lens", "real"):
            v = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = v.pin_memory() if self.device.type == "cuda" else v
        return out

    def _batch(self, batch: dict) -> dict:
        out = {}
        for k in ("wav", "wav_lens", "tokens", "token_lens", "real"):
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = torch.as_tensor(v).to(self.device, non_blocking=True)
        out["wav"] = out["wav"].to(torch.float32).contiguous()
        return out

    def _step_generator(self, step: int, stream: int) -> torch.Generator:
        """A random stream of one step, a function of (seed, step, stream),
        as JAX folds the step into its key (loop.py:332): stream 0 draws
        dropout, stream 1 dither (JAX's fold_in(key, 1), loop.py:221),
        stream 2 SpecAugment (JAX's fold_in(key, 7), loop.py:226-232).
        Stream 0 keeps the dropout seed it had before dither was ported;
        stream s sits s * 2**40 above every stream-0 seed of a real run."""
        g = torch.Generator(self.device)
        g.manual_seed((self.cfg.seed + 1) * 1_000_003 + step
                      + stream * (1 << 40))
        return g

    def _loss_fn(self, model, batch: dict, train: bool, step: int = 0):
        """-> (loss, log_probs, out_lens); loss = the mean CTC NLL over the
        real rows (loop.py:217-283, objective "ctc"). In training the
        featurizer dithers, SpecAugment masks and the model drops out, each
        from its stream of ``step``."""
        cfg = self.cfg
        dither = (self._step_generator(step, 1)
                  if train and self.feat_cfg.dither > 0 else None)
        with torch.no_grad():
            feats, flens = self.featurizer.featurize(
                batch["wav"], batch["wav_lens"], generator=dither)
            if train and cfg.spec_augment:
                feats = spec_augment(
                    feats, flens, self._step_generator(step, 2),
                    freq_masks=cfg.sa_freq_masks,
                    freq_width=cfg.sa_freq_width,
                    time_masks=cfg.sa_time_masks,
                    time_frac=cfg.sa_time_frac)
            if cfg.bf16_compute:
                feats = feats.to(torch.bfloat16)
        model.train(train)
        logp, out_lens = model(feats, flens, generator=(
            self._step_generator(step, 0) if train else None))
        losses = self._ctc(logp.to(torch.float32), batch["tokens"], out_lens,
                           batch["token_lens"])
        w = batch["real"].to(torch.float32)
        loss = torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1.0)
        return loss, logp, out_lens

    def train_step(self, state: TrainState, batch: dict):
        """One update, in place. -> (state, {"loss", "grad_norm"}) with the
        gradient norm before clipping; both 0-d tensors on the device."""
        model = state.model
        batch = self._batch(batch)
        params = [p for p in model.parameters()]
        for p in params:
            p.grad = None
        # TF32 off for the backward too: cuDNN's conv gradients would
        # otherwise run in TF32 (torch.backends.cudnn.allow_tf32 is True).
        with full_fp32(bf16_sums=True):
            loss, _, _ = self._loss_fn(model, batch, True, state.step)
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        gnorm = global_norm(grads)
        opt_state = self.optimizer.update(params, grads, state.opt_state)
        for p in params:
            p.grad = None
        state = TrainState(step=state.step + 1, model=model,
                           opt_state=opt_state)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """Loss with running statistics, and greedy tokens."""
        batch = self._batch(batch)
        with torch.no_grad():
            loss, logp, out_lens = self._loss_fn(state.model, batch, False)
        toks, tok_lens = greedy_decode(logp, out_lens)
        return {"loss": loss, "tokens": toks, "token_lens": tok_lens}

    # ---- epoch loop ----

    def ckpt_meta(self, epoch: int) -> dict:
        """Everything predict/test need to rebuild the model from a
        checkpoint (JAX's keys)."""
        return {"epoch": epoch, "model": self.cfg.model,
                "num_classes": self.cfg.num_classes,
                "model_kwargs": self.cfg.model_kwargs,
                "feature": dataclasses.asdict(self.feat_cfg)}

    def _device_corpus_for(self, loader):
        """The loader's device-resident corpus (built once per loader), or
        None where it must stream."""
        if self._dc is not None and self._dc[0] is loader:
            return self._dc[1]
        from tpuasr_torch.data.device_corpus import DeviceCorpus, try_build
        cfg = self.cfg
        if cfg.device_corpus == "auto":
            dc = try_build(loader, self.device,
                           max_bytes=cfg.device_corpus_bytes)
        else:
            dc = DeviceCorpus(loader, self.device,
                              max_bytes=cfg.device_corpus_bytes)
        if dc is not None:
            self.log.info("device-resident corpus: %.0f MiB on %s, "
                          "%d buckets", dc.nbytes / 2 ** 20, self.device,
                          len(dc._stores))
        self._dc = (loader, dc)
        return dc

    def _epoch_batches(self, train_loader, epoch: int):
        """Yield (n_real_utts, device batch) for one epoch, in the loader's
        deterministic order: gathered from the device-resident corpus, or
        streamed, with ``prefetch`` > 0 by a host thread that decodes and
        packs up to ``prefetch`` batches ahead (the copy to the device runs
        here, on the main thread's stream)."""
        if self.cfg.device_corpus:
            dc = self._device_corpus_for(train_loader)
            if dc is not None:
                yield from dc.batches(epoch)
                return
        train_loader.epoch = epoch
        src = iter(train_loader)
        if self.cfg.prefetch <= 0:
            for batch in src:
                yield int(batch["real"].sum()), self._batch(batch)
            return
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        err: list[BaseException] = []
        stop = threading.Event()      # the consumer left the epoch early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                for batch in src:
                    if not put((int(batch["real"].sum()),
                                self._host_batch(batch))):
                        return
            except BaseException as e:    # raised on the main thread
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=work, daemon=True,
                             name="tpuasr_torch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item[0], self._batch(item[1])
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join()

    def fit(self, train_loader, dev_loader=None,
            metrics_dir: str | None = None) -> TrainState:
        cfg = self.cfg
        writer = MetricsWriter(metrics_dir) if metrics_dir else None
        state = self.init_state()
        self.log.info("model %s: %.2fM params", cfg.model,
                      sum(p.numel() for p in state.model.parameters()) / 1e6)
        start_epoch = 0
        if cfg.continue_from:
            tree, meta = restore_checkpoint(cfg.continue_from,
                                            self.state_tree(state))
            state = self.load_state_tree(state, tree)
            start_epoch = meta.get("epoch", 0)
            self.log.info("resumed from %s (step %d, epoch %d)",
                          cfg.continue_from, state.step, start_epoch)
        for epoch in range(start_epoch, cfg.num_epochs):
            t_epoch = time.perf_counter()
            n_utts = 0
            # closing(): a step that raises stops the prefetch thread now,
            # not when the traceback lets the generator go.
            with contextlib.closing(
                    self._epoch_batches(train_loader, epoch)) as batches:
                for n_real, batch in batches:
                    state, m = self.train_step(state, batch)
                    n_utts += n_real
                    if state.step % cfg.log_every == 0:
                        loss = float(m["loss"])   # the host reads it here
                        self.log.info(
                            "epoch %d step %d loss %.4f gnorm %.3f", epoch,
                            state.step, loss, float(m["grad_norm"]))
                        if writer:
                            writer.scalar("train/loss", loss, state.step)
                    if (cfg.ckpt_dir
                            and state.step % cfg.ckpt_every_steps == 0):
                        save_checkpoint(
                            cfg.ckpt_dir, self.state_tree(state), state.step,
                            meta=self.ckpt_meta(epoch))
            dt = time.perf_counter() - t_epoch
            self.log.info("epoch %d done in %.1fs (%.1f utt/s)", epoch, dt,
                          n_utts / max(dt, 1e-9))
            if dev_loader is not None:
                dev = self.evaluate(state, dev_loader)
                self.log.info("epoch %d dev loss %.4f ter %.4f", epoch,
                              dev["loss"], dev["ter"])
                if writer:
                    writer.scalar("dev/loss", dev["loss"], state.step)
                    writer.scalar("dev/ter", dev["ter"], state.step)
        if cfg.ckpt_dir:
            save_checkpoint(cfg.ckpt_dir, self.state_tree(state), state.step,
                            meta=self.ckpt_meta(cfg.num_epochs))
        if writer:
            writer.close()
        return state

    def evaluate(self, state: TrainState, loader) -> dict:
        """Mean loss over the real utterances, token error rate of greedy
        decoding, and each real utterance's greedy tokens (``hyps``, by
        id)."""
        tot_loss, n = 0.0, 0
        refs, hyps, by_id = [], [], {}
        for batch in loader:
            out = self.eval_step(state, batch)
            real = np.asarray(batch["real"])
            w = real.sum()
            tot_loss += float(out["loss"]) * w
            n += w
            toks = out["tokens"].cpu().numpy()
            tlens = out["token_lens"].cpu().numpy()
            for j in range(len(real)):
                if not real[j]:
                    continue
                refs.append(np.asarray(batch["tokens"][j])
                            [:batch["token_lens"][j]].tolist())
                hyps.append(toks[j][:tlens[j]].tolist())
                by_id[batch["ids"][j]] = hyps[-1]
        return {"loss": tot_loss / max(n, 1), "ter": wer(refs, hyps),
                "hyps": by_id}
