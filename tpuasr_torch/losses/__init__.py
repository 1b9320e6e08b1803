"""CTC losses, by the JAX package's names (tpuasr/losses/__init__.py).

* ``ctc_loss_ref``: the alpha recursion with the gradient by autograd; the
  test oracle.
* ``ctc_loss``: alpha-beta forward-backward with the analytic gradient; its
  recursions are the CUDA kernels K6/K6b for CUDA tensors and their plain
  versions for CPU tensors.

Conventions as in JAX: blank 0, log-probabilities (B, T, C), per-utterance
negative log-likelihood without length normalization.
"""

from tpuasr_torch.losses.ctc import ctc_loss
from tpuasr_torch.losses.ctc_ref import ctc_loss_ref


def get_ctc_loss(impl: str = "fb"):
    """impl: 'ref' (autograd through the recursion), or 'fb', 'pallas' or
    'auto', which in the port are one function: the analytic
    forward-backward, whose recursions run where the tensors are (the
    kernels on the card, the plain versions on the CPU)."""
    if impl == "ref":
        return ctc_loss_ref
    if impl in ("fb", "pallas", "auto"):
        return ctc_loss
    raise ValueError(f"unknown CTC impl {impl!r}")


__all__ = ["ctc_loss", "ctc_loss_ref", "get_ctc_loss"]
