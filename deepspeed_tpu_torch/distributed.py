"""Process-group bootstrap (the port of ``deepspeed_tpu/distributed.py``).

The JAX package runs one process per host and calls
``jax.distributed.initialize``; the port runs one process per device and
calls ``torch.distributed.init_process_group``, as the reference engine
did (``engine.py:139``). The rendezvous comes from the launcher's
environment (``launcher/runner.py``):

- torch's ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, which the port's launcher sets for every child (a
  child joins its group even at a world of one);
- or the JAX launcher's ``DSTPU_COORDINATOR`` (``host:port``),
  ``DSTPU_NUM_PROCESSES`` and ``DSTPU_PROCESS_ID``, with the rank taken
  from ``OMPI_COMM_WORLD_RANK`` under ``DSTPU_PROCESS_ID_FROM_MPI``;
  these join only above one process, as in JAX.

The backend follows the device: ``nccl`` on the card, ``gloo`` only when
the caller asks for the CPU. A process started without either
environment stays a single process: nothing is initialised.
"""

import os
from typing import Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["init_distributed", "is_initialized", "local_rank"]


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name, "")
    return int(val) if val.strip() else default


def local_rank() -> int:
    """This process's device index on its host (``LOCAL_RANK``, or the MPI
    local rank; 0 when neither is set)."""
    if "LOCAL_RANK" in os.environ:
        return _env_int("LOCAL_RANK", 0)
    return _env_int("OMPI_COMM_WORLD_LOCAL_RANK", 0)


def _rendezvous(coordinator_address, num_processes, process_id):
    """``(tcp address, world size, rank)`` from the arguments and the
    environment, or None for a single process."""
    if coordinator_address is not None:
        return (f"tcp://{coordinator_address}", int(num_processes),
                int(process_id))
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                              "MASTER_PORT")):
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                _env_int("WORLD_SIZE", 1), _env_int("RANK", 0))
    coordinator = env.get("DSTPU_COORDINATOR")
    nprocs = _env_int("DSTPU_NUM_PROCESSES", 0)
    pid = _env_int("DSTPU_PROCESS_ID", -1)
    if pid < 0 and env.get("DSTPU_PROCESS_ID_FROM_MPI"):
        # the OpenMPI runner's path: identity from the MPI rank
        pid = _env_int("OMPI_COMM_WORLD_RANK", -1)
    if coordinator and nprocs > 1 and pid >= 0:
        return f"tcp://{coordinator}", nprocs, pid
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> None:
    """Join the launcher's process group (or the one the arguments name:
    ``coordinator_address`` as ``host:port``); a no-op for a single
    process and when a group exists. ``device`` picks the backend:
    ``nccl`` unless it is the CPU, where ``gloo`` runs. On the card the
    process then takes device ``LOCAL_RANK``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    found = _rendezvous(coordinator_address, num_processes, process_id)
    if found is None:
        return
    address, world, rank = found
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: the launcher asks for a process group "
                "and no CUDA device is available; pass device='cpu' for "
                "gloo")
        torch.cuda.set_device(local_rank())
    logger.info(f"init_process_group({backend}, {address}, world_size="
                f"{world}, rank={rank})")
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)


def is_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()
