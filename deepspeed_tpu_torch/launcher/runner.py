"""The restart policy of the port's launcher (the part of
``deepspeed_tpu/launcher/runner.py`` that the serving fleet needs).

A supervised process that exits with the graceful preemption drain's
code (``runtime/elastic.RESUMABLE_EXIT_CODE``, 85) or the hang
watchdog's ``os._exit`` code (``utils/health.STALL_EXIT_CODE``, 87) is
relaunched; any other exit is a genuine failure and is not.
"""

from typing import Optional

from deepspeed_tpu_torch.runtime.elastic import RESUMABLE_EXIT_CODE
from deepspeed_tpu_torch.utils.health import STALL_EXIT_CODE

__all__ = ["RESTARTABLE_EXIT_CODES", "restart_eligible"]

#: exit codes a supervisor answers with a relaunch: the preemption drain
#: (85) and the watchdog's exit (87)
RESTARTABLE_EXIT_CODES = (RESUMABLE_EXIT_CODE, STALL_EXIT_CODE)


def restart_eligible(rc: Optional[int]) -> bool:
    """True when exit code ``rc`` should be answered with a relaunch
    (the serving fleet's replica supervision, ``inference/fleet.py``)."""
    return rc in RESTARTABLE_EXIT_CODES
