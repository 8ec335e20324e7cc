"""Logging utilities (the port of ``deepspeed_tpu/utils/logging.py``).

Same logger name, format and ``DSTPU_LOG_LEVEL`` switch as the JAX
package; ``log_dist`` filters by the ``torch.distributed`` rank instead
of ``jax.process_index()``.
"""

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


class LoggerFactory:

    @staticmethod
    def create_logger(name: str = "DeepSpeedTPU", level=logging.INFO) -> logging.Logger:
        """Create a logger with a stdout stream handler."""
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="DeepSpeedTPU",
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO),
)


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# one-line which-path logging, once per hashable key (typically a
# (reason, *shape) tuple)
_ONCE_KEYS = set()


def log_once(key, msg: str, warn: bool = False) -> None:
    if key in _ONCE_KEYS:
        return
    _ONCE_KEYS.add(key)
    (logger.warning if warn else logger.info)(msg)


def reset_once_logging() -> None:
    """Test hook: forget which (reason, shape) lines were emitted."""
    _ONCE_KEYS.clear()


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level=logging.INFO) -> None:
    """Log ``message`` only on the listed ranks.

    ``ranks=None`` or ``ranks=[-1]`` logs on every process.
    """
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else []
    should_log = not ranks or (-1 in ranks) or (my_rank in ranks)
    if should_log:
        logger.log(level, f"[Rank {my_rank}] {message}")
