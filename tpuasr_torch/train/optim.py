"""The optimizer of ``tpuasr.train.loop.make_optimizer`` (loop.py:111-134).

optax's chain, reproduced on tensors so the numbers come out the same:

    clip_by_global_norm(grad_clip)     g <- g / |g| * max_norm iff |g| >= max
    then adamw | adam | nesterov sgd   with the learning rate of the
                                       schedule at the update count (from 0)

adamw is optax's: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias-corrected moments, weight decay added to the Adam direction for every
parameter, then scaled by -lr. The schedules are optax's ``linear_schedule``
(0 -> lr over ``warmup_steps``; so the first update is zero) and
``warmup_cosine_decay_schedule``. ``torch.nn.utils.clip_grad_norm_`` is not
the same clip: it adds 1e-6 to the norm and always rescales.

With ``accum_steps`` k > 1 the chain is wrapped as
``optax.MultiSteps(chain, every_k_schedule=k)`` (optax 0.2.6): each call
folds the raw gradient into a running mean, ``acc + (g - acc) / (m + 1)``
at mini-step m; every k-th call applies the whole chain, clip included, to
that mean and resets it; the calls in between leave the parameters as they
are. The chain's count, and so the schedule, advances only on applied
updates (the first applied update runs at the warmup's lr 0).

``state_tree``/``load_state_tree`` carry ``OptState`` to and from optax's
state dict as flax's ``to_state_dict`` gives it, the layout of JAX's
checkpoints (``train/checkpoints.py``): tuples as maps "0", "1", ...,
namedtuples as maps of their fields, empty states as {}, per-parameter
leaves under their Flax names and layouts (``convert.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpuasr_torch.convert import (from_jax_variables, sorted_tree,
                                  to_jax_variables)


def make_schedule(cfg):
    """step count (0-based) -> learning rate, as optax."""
    lr = cfg.lr
    warmup = max(cfg.warmup_steps, 1)

    def linear(count):
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return (0.0 - lr) * frac + lr

    if cfg.lr_schedule == "warmup":
        return linear
    if cfg.lr_schedule == "cosine":
        decay = max(cfg.decay_steps, cfg.warmup_steps + 1) - warmup
        alpha = cfg.min_lr_frac if lr != 0.0 else 0.0

        def cosine(count):
            if count < warmup:
                return linear(count)
            c = min(count - warmup, decay)
            cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
            return lr * ((1.0 - alpha) * cos + alpha)

        return cosine
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


@dataclasses.dataclass
class OptState:
    count: int = 0                    # updates applied so far
    mu: list | None = None            # first moments (adam) / trace (sgd)
    nu: list | None = None            # second moments (adam)
    # MultiSteps (accum_steps > 1): the calls since the last applied update,
    # the updates applied, and the running mean of the raw gradients.
    mini_step: int = 0
    gradient_step: int = 0
    acc: list | None = None


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, as optax.global_norm."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Optimizer:
    """``update(params, grads, state)`` applies one step in place."""

    def __init__(self, cfg):
        if cfg.optimizer not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params) -> OptState:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        acc = zeros() if self.cfg.accum_steps > 1 else None
        if self.cfg.optimizer == "sgd":
            return OptState(mu=zeros(), acc=acc)
        return OptState(mu=zeros(), nu=zeros(), acc=acc)

    @torch.no_grad()
    def update(self, params, grads, state: OptState) -> OptState:
        """One call of the chain (of MultiSteps with accum_steps > 1)."""
        k = self.cfg.accum_steps
        if k <= 1:
            return self._apply(params, grads, state)
        m = state.mini_step
        for a, g in zip(state.acc, grads):
            a.add_((g - a) / float(m + 1))
        if m + 1 < k:
            return dataclasses.replace(state, mini_step=m + 1)
        new = self._apply(params, state.acc, state)
        for a in state.acc:
            a.zero_()
        return dataclasses.replace(new, mini_step=0,
                                   gradient_step=state.gradient_step + 1)

    def _apply(self, params, grads, state: OptState) -> OptState:
        """The chain: clip, then the optimizer at the scheduled rate."""
        cfg = self.cfg
        gnorm = global_norm(grads)
        clip = gnorm >= cfg.grad_clip
        grads = [torch.where(clip, g / gnorm * cfg.grad_clip, g)
                 for g in grads]
        lr = self.schedule(state.count)
        count = state.count + 1
        if cfg.optimizer == "sgd":
            m = cfg.momentum
            for p, g, tr in zip(params, grads, state.mu):
                tr.mul_(m).add_(g)                       # trace = g + m trace
                p.add_(g + m * tr, alpha=-lr)            # nesterov
            return dataclasses.replace(state, count=count)
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if cfg.optimizer == "adamw":
                u = u + cfg.weight_decay * p
            p.add_(u, alpha=-lr)
        return dataclasses.replace(state, count=count)

    # ---- optax's state dict ----

    def state_tree(self, state: OptState, names: list[str]) -> dict:
        """optax's ``to_state_dict`` of this chain's state; ``names`` are
        the parameters' names in the order of the state's lists."""
        def tree(ts):
            return sorted_tree(to_jax_variables(dict(zip(names, ts)))
                               ["params"])

        def count(n):
            return np.asarray(n, np.int32)

        if self.cfg.optimizer == "sgd":
            inner = {"0": {"trace": tree(state.mu)},
                     "1": {"count": count(state.count)}}
        else:
            inner = {"0": {"count": count(state.count), "mu": tree(state.mu),
                           "nu": tree(state.nu)}}
            if self.cfg.optimizer == "adamw":
                inner["1"] = {}                   # add_decayed_weights
            inner[str(len(inner))] = {"count": count(state.count)}
        chain = {"0": {}, "1": inner}             # clip_by_global_norm, opt
        if self.cfg.accum_steps <= 1:
            return chain
        return {"mini_step": count(state.mini_step),
                "gradient_step": count(state.gradient_step),
                "inner_opt_state": chain, "acc_grads": tree(state.acc),
                "skip_state": {}}

    def load_state_tree(self, tree: dict, params: list, names: list[str]
                        ) -> OptState:
        """``OptState`` from optax's state dict (``state_tree``'s layout),
        its tensors like ``params``."""
        def tensors(sub):
            sd = from_jax_variables({"params": sub})
            bad = [n for n, p in zip(names, params)
                   if n not in sd or sd[n].shape != p.shape]
            if bad:
                raise ValueError(f"optimizer state does not match the "
                                 f"parameters at {bad}")
            return [sd[n].to(p.device, p.dtype) for n, p in zip(names, params)]

        state = OptState()
        if self.cfg.accum_steps > 1:
            if "inner_opt_state" not in tree:
                raise ValueError("accum_steps > 1 needs a MultiSteps state")
            state.mini_step = int(tree["mini_step"])
            state.gradient_step = int(tree["gradient_step"])
            state.acc = tensors(tree["acc_grads"])
            tree = tree["inner_opt_state"]
        elif "inner_opt_state" in tree:
            raise ValueError("a MultiSteps state needs accum_steps > 1")
        inner = tree["1"]
        sched = inner[str(len(inner) - 1)]["count"]
        if self.cfg.optimizer == "sgd":
            if "trace" not in inner["0"]:
                raise ValueError("not an sgd state")
            state.mu = tensors(inner["0"]["trace"])
        else:
            if "nu" not in inner["0"]:
                raise ValueError(f"not an {self.cfg.optimizer} state")
            if len(inner) != (3 if self.cfg.optimizer == "adamw" else 2):
                raise ValueError(f"not an {self.cfg.optimizer} chain")
            if int(inner["0"]["count"]) != int(sched):
                raise ValueError("adam and schedule counts differ")
            state.mu = tensors(inner["0"]["mu"])
            state.nu = tensors(inner["0"]["nu"])
        state.count = int(sched)
        return state
