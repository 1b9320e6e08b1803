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
"""

from __future__ import annotations

import dataclasses
import math

import torch


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
        zeros = [torch.zeros_like(p) for p in params]
        if self.cfg.optimizer == "sgd":
            return OptState(mu=zeros)
        return OptState(mu=zeros, nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params, grads, state: OptState) -> OptState:
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
            return OptState(count=count, mu=state.mu)
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
        return OptState(count=count, mu=state.mu, nu=state.nu)
