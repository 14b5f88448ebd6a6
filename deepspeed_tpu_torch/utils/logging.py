"""Rank-filtered logging.

Counterpart of the JAX package's ``utils/logging.py`` (logger +
``log_dist``): same API, but "rank" is the ``torch.distributed`` rank when
a process group is up, else the ``RANK`` environment variable.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    log = logging.getLogger(name)
    log.setLevel(level)
    log.propagate = False
    if not log.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        log.addHandler(handler)
    return log


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DS_TPU_LOG_LEVEL", "info").lower(),
                         logging.INFO)
)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (``[-1]`` or None = all)."""
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else []
    if not ranks or (-1 in ranks) or (my_rank in ranks):
        logger.log(level, f"[Rank {my_rank}] {message}")
