"""Row gather from an int32 table (K10): kernel, plain version, wrapper.

Counterpart of ``tpuasr/ops/pallas_gather.py::gather_rows``, the JAX
package's public row gather: the CUDA kernel of ``csrc/gather_rows.cu`` for
a CUDA tensor, ``gather_rows_plain`` for a CPU tensor. Both compute
``table[clamp(idx, 0, S - 1)]``, the semantics of XLA's gather. The
graph-constrained beam search no longer calls it: its kernel
(``csrc/scan_beam.cu``) fetches each beam's row itself, and its plain
version calls ``gather_rows_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from tpuasr_torch import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: table (S, W), idx (...) -> (..., W)."""
    return table[idx.to(torch.int64).clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, S - 1)]`` for an int32 (S, W) table.

    idx (...) int32 or int64 -> (..., W) int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (int32 table only: the packed
    graph table carries float bits that must not pass through a float).
    """
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.ndim != 2 or table.shape[0] == 0:
        raise ValueError(f"gather_rows: table must be (S, W) with S > 0, got "
                         f"{tuple(table.shape)}")
    S, W = table.shape
    _build.check_tensor("gather_rows: table", table, table.device,
                        (torch.int32,), (S, W))
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    _build.check_tensor("gather_rows: idx", flat, table.device,
                        (torch.int32,), flat.shape)
    out = torch.empty((flat.numel(), W), dtype=torch.int32,
                      device=table.device)
    if flat.numel() == 0:
        return out.reshape(*idx.shape, W)
    fn = _build.lib().tpuasr_gather_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        code = fn(_build.ptr(table), _build.ptr(flat), _build.ptr(out), S, W,
                  flat.numel(), _build.stream_ptr(table))
    gather_rows.launches += 1
    _build.check(code, "gather_rows")
    return out.reshape(*idx.shape, W)


gather_rows.launches = 0
