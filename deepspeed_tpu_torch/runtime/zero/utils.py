"""ZeRO utilities (the port of ``deepspeed_tpu/runtime/zero/utils.py``,
after the reference's ``deepspeed/runtime/zero/utils.py``)."""

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.optimizers import Adam, FusedAdam, Lamb
from deepspeed_tpu_torch.utils.logging import logger

# the JAX package's list less Adam8bit and SGD, which the port lacks
ZERO_SUPPORTED_OPTIMIZERS = [Adam, FusedAdam, Lamb, DeepSpeedCPUAdam]


def is_zero_supported_optimizer(optimizer) -> bool:
    """(reference zero/utils.py is_zero_supported_optimizer)"""
    logger.info(
        f"Checking ZeRO support for optimizer="
        f"{optimizer.__class__.__name__} type={type(optimizer)}")
    return type(optimizer) in ZERO_SUPPORTED_OPTIMIZERS
