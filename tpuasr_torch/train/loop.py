"""The CTC training step on one device: ``Trainer.train_step``.

Counterpart of ``tpuasr/train/loop.py`` for its step: featurize (the plain
``Featurizer``, or ``FusedFeaturizer`` with ``fused_featurizer``) -> the
acoustic model in training mode -> per-utterance CTC NLL (K6/K6b on the
card) -> mean over the batch's real rows -> gradients (K5b for every GRU
scan) -> global-norm clip and the optimizer, all in float32 with TF32 off,
forward and backward. PyTorch runs the step eagerly and updates the
model's parameters and batch statistics in place; ``TrainState`` carries
the model, the optimizer state and the step count.

A batch is a dict of ``wav`` (B, S) f32, ``wav_lens`` (B,), ``tokens``
(B, U) int, ``token_lens`` (B,) and ``real`` (B,) (0 for padding rows), as
the JAX loaders give it; numpy arrays or tensors.

With ``FeatureConfig.dither > 0`` the step featurizes with dither noise
drawn from a stream of its own, a function of (seed, step) apart from the
dropout stream, as JAX folds 1 into the step's key (loop.py:219-224).

Not ported (they raise ``NotImplementedError``): ``fit()`` with its loaders,
checkpoints and logging, SpecAugment, gradient accumulation, objectives
other than "ctc", the device-resident corpus, Grain and bf16 compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuasr_torch.convert import from_jax_variables, to_jax_variables
from tpuasr_torch.decode import greedy_decode
from tpuasr_torch.features import FeatureConfig, Featurizer, FusedFeaturizer
from tpuasr_torch.losses import get_ctc_loss
from tpuasr_torch.models import create_model
from tpuasr_torch.precision import full_fp32
from tpuasr_torch.utils.device import resolve_device
from tpuasr_torch.train.optim import OptState, Optimizer, global_norm


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
    bad = {"objective != 'ctc'": cfg.objective != "ctc",
           "spec_augment": cfg.spec_augment,
           "accum_steps > 1": cfg.accum_steps > 1,
           "device_corpus=True": cfg.device_corpus is True,
           "use_grain": cfg.use_grain,
           "bf16_compute": cfg.bf16_compute}
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
    """Trainer(cfg, feat_cfg, device)``.train_step(state, batch)``.

    The device defaults to the card; a CUDA device that is absent is an
    error (``resolve_device``), never a quiet move to the CPU.
    """

    def __init__(self, cfg: TrainConfig, feat_cfg: FeatureConfig | None = None,
                 device="cuda"):
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

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "Trainer.fit (loaders, checkpoints, logging) is not ported; "
            "drive train_step")

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

    # ---- steps ----

    def _batch(self, batch: dict) -> dict:
        out = {}
        for k in ("wav", "wav_lens", "tokens", "token_lens", "real"):
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = torch.as_tensor(v).to(self.device)
        out["wav"] = out["wav"].to(torch.float32).contiguous()
        return out

    def _step_generator(self, step: int, stream: int) -> torch.Generator:
        """A random stream of one step, a function of (seed, step, stream),
        as JAX folds the step into its key (loop.py:332): stream 0 draws
        dropout, stream 1 dither (JAX's fold_in(key, 1), loop.py:221).
        Stream 0 keeps the dropout seed it had before dither was ported;
        stream 1 sits 2**40 above every stream-0 seed of a real run."""
        g = torch.Generator(self.device)
        g.manual_seed((self.cfg.seed + 1) * 1_000_003 + step
                      + stream * (1 << 40))
        return g

    def _loss_fn(self, model, batch: dict, train: bool, step: int = 0):
        """-> (loss, log_probs, out_lens); loss = the mean CTC NLL over the
        real rows (loop.py:217-283, objective "ctc"). In training the
        featurizer dithers and the model drops out, each from its stream
        of ``step``."""
        dither = (self._step_generator(step, 1)
                  if train and self.feat_cfg.dither > 0 else None)
        with torch.no_grad():
            feats, flens = self.featurizer.featurize(
                batch["wav"], batch["wav_lens"], generator=dither)
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
        with full_fp32():
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
