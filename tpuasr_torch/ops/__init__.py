"""GRU scan kernels and int8 quantization."""

from tpuasr_torch.ops.gru import (gru_scan, gru_scan_bwd, gru_scan_fwd,
                                  gru_scan_xfused, gru_scan_xfused_q8)
from tpuasr_torch.ops.quant import (quantize_per_channel, quantize_rows,
                                    reference_q8_gru_scan)

__all__ = ["gru_scan", "gru_scan_bwd", "gru_scan_fwd", "gru_scan_xfused",
           "gru_scan_xfused_q8", "quantize_per_channel",
           "quantize_rows", "reference_q8_gru_scan"]
