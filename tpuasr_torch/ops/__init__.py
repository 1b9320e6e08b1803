"""GRU scan kernels, the int8 conv kernel and int8 quantization."""

from tpuasr_torch.ops.conv import conv_taps_q8, reference_q8_conv_taps
from tpuasr_torch.ops.gru import (gru_scan, gru_scan_bidir, gru_scan_bwd,
                                  gru_scan_fwd, gru_scan_xfused,
                                  gru_scan_xfused_q8)
from tpuasr_torch.ops.quant import (quantize_per_channel, quantize_rows,
                                    reference_q8_gru_scan)

__all__ = ["conv_taps_q8", "gru_scan", "gru_scan_bidir", "gru_scan_bwd",
           "gru_scan_fwd", "gru_scan_xfused", "gru_scan_xfused_q8",
           "quantize_per_channel", "quantize_rows", "reference_q8_conv_taps",
           "reference_q8_gru_scan"]
