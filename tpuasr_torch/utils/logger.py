"""Logging: the port's copy of ``tpuasr/utils/logger.py``.

``init_logger`` logs to stdout, and to ``<log_dir>/<name>.log`` when a
directory is given, in JAX's format. ``MetricsWriter`` appends
``step,name,value`` rows to ``<log_dir>/metrics.csv`` as JAX's does. JAX's
writer also writes TensorBoard scalars when ``tensorflow`` imports; the
port writes none (neither ``tensorflow`` nor ``tensorboard`` is installed
beside the card), so the CSV is the record.
"""

from __future__ import annotations

import csv
import logging
import sys
from pathlib import Path


def init_logger(name: str = "tpuasr", log_dir: str | None = None,
                level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / f"{name}.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Scalar metrics -> ``metrics.csv`` (appended, header once)."""

    def __init__(self, log_dir: str):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.dir / "metrics.csv"
        self._csv = open(self._csv_path, "a", newline="")
        self._writer = csv.writer(self._csv)
        if self._csv.tell() == 0:
            self._writer.writerow(["step", "name", "value"])

    def scalar(self, name: str, value: float, step: int):
        self._writer.writerow([step, name, float(value)])
        self._csv.flush()

    def close(self):
        self._csv.close()
