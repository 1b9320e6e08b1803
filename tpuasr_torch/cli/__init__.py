"""Command-line entry points (``python -m tpuasr_torch.cli.predict``)."""
