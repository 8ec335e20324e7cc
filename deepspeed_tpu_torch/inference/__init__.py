"""Paged serving engine of the port (see ``inference/engine.py``)."""

from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.scheduler import (FinishedRequest,
                                                     Request, Scheduler)

__all__ = ["InferenceEngine", "Request", "FinishedRequest", "Scheduler"]
