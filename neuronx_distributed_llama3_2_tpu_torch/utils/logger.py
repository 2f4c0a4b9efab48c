"""Rank-0-only logger with env-controlled level.

Replaces the reference's ``utils/logger.py`` (get_logger :16-51, NXD_LOG_LEVEL
:20,103). "Rank 0" is the ``torch.distributed`` rank when a process group is
up, and every process otherwise.
"""

from __future__ import annotations

import logging
import os
import sys


class _Rank0Filter(logging.Filter):
    """Suppress records on non-zero ranks, deciding *lazily at emit time*
    so that a logger made before ``init_process_group`` still filters
    correctly once the group is up."""

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.CRITICAL:
            return True  # a crashing rank must never be silenced
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return True
        return dist.get_rank() == 0


def get_logger(
    name: str = "nxdt_torch", rank0_only: bool = True
) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_nxdt_rank0_only", None) == rank0_only:
        return logger
    # (re)configure — either first call or the rank0_only policy changed
    for h in list(logger.handlers):
        logger.removeHandler(h)
    level = os.environ.get("NXDT_LOG_LEVEL", "INFO").upper()
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    )
    if rank0_only:
        handler.addFilter(_Rank0Filter())
    logger.addHandler(handler)
    logger.propagate = False
    logger._nxdt_rank0_only = rank0_only  # type: ignore[attr-defined]
    return logger
