"""Training: the CTC train step of the JAX ``tpuasr.train`` on one device."""

from tpuasr_torch.train.loop import TrainConfig, Trainer, TrainState
from tpuasr_torch.train.optim import Optimizer

__all__ = ["Optimizer", "TrainConfig", "TrainState", "Trainer"]
