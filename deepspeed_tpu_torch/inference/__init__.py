"""Paged serving engine of the port (see ``inference/engine.py``) and the
serving fleet over it (``inference/fleet.py``)."""

from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.fleet import (FleetRouter, ReplicaHandle,
                                                 ReplicaProcess,
                                                 launch_replica_processes)
from deepspeed_tpu_torch.inference.scheduler import (FinishedRequest,
                                                     Request, Scheduler)

__all__ = ["InferenceEngine", "Request", "FinishedRequest", "Scheduler",
           "FleetRouter", "ReplicaHandle", "ReplicaProcess",
           "launch_replica_processes"]
