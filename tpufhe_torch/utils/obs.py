"""Observability helpers: logging, wall-clock timing, byte formatting.

The port's copy of tpufhe/utils/obs.py, the counterpart of the
reference's example-level surface: `log` + `env_logger` initialization
(examples/sealpir.rs:38, examples/mulpir.rs:49), the `timeit!` /
`timeit_n!` macros (examples/util.rs:18-48) and `indicatif::HumanBytes`
(examples/mulpir.rs:104-111). The library stays silent; the example
applications opt in.

TPUFHE_LOG=debug|info|warning|error sets the level of the "tpufhe_torch"
logger tree (env_logger's RUST_LOG).
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

logger = logging.getLogger("tpufhe_torch")


def init_logging(default: str | None = None) -> logging.Logger:
    """env_logger::init: configure the tpufhe_torch logger from TPUFHE_LOG
    (falling back to `default`, or warning)."""
    level_name = os.environ.get("TPUFHE_LOG", default or "warning").upper()
    level = getattr(logging, level_name, logging.WARNING)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s",
                              "%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


def human_bytes(n: int) -> str:
    """indicatif::HumanBytes: 1536 -> '1.50 KiB'."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            if unit == "B":
                return f"{int(n)} B"
            return f"{n:.2f} {unit}"
        n /= 1024
    raise AssertionError("unreachable")


@contextmanager
def timeit(label: str, report: dict | None = None, key: str | None = None,
           n: int = 1):
    """timeit! / timeit_n!: logs the (per-iteration) wall time of the block
    at info level and records its seconds into report[key or label] when a
    report is given. The block must end with the work done (on a CUDA
    device, a synchronize)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) / max(n, 1)
        if dt >= 1.0:
            disp = f"{dt:.2f} s"
        elif dt >= 1e-3:
            disp = f"{dt * 1e3:.2f} ms"
        else:
            disp = f"{dt * 1e6:.0f} us"
        logger.info("%s: %s", label, disp)
        if report is not None:
            report[key or label] = dt
