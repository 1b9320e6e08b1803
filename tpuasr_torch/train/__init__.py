"""Training: the CTC train step and epoch loop of the JAX ``tpuasr.train``
on one device, and its checkpoints (JAX's msgpack format)."""

from tpuasr_torch.train.loop import TrainConfig, Trainer, TrainState
from tpuasr_torch.train.optim import Optimizer

__all__ = ["Optimizer", "TrainConfig", "TrainState", "Trainer"]
