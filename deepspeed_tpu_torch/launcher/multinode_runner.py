"""Multi-node transports of the port's launcher (the port of
``deepspeed_tpu/launcher/multinode_runner.py``).

Each runner wraps a remote-execution transport and renders the command
of one process. The port runs one process per device, so a host with
``n`` slots gets ``n`` commands, each with torch's rendezvous variables
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) beside the JAX launcher's
``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` / ``DSTPU_PROCESS_ID``.
``mpirun`` starts every process in one command; ``init_distributed``
then takes the rank from ``OMPI_COMM_WORLD_RANK``.
"""

import os
import shlex
import shutil
import sys
from typing import Dict, List

__all__ = ["MultiNodeRunner", "SSHRunner", "PDSHRunner", "OpenMPIRunner",
           "make_runner"]

_LOCAL = ("localhost", "127.0.0.1")


class MultiNodeRunner:
    """Base: renders the command that runs process ``process_id`` on
    ``host`` (its ``local_rank``-th device there)."""

    name = "base"

    def __init__(self, args, world_info: Dict[str, List[int]]):
        self.args = args
        self.world_info = world_info

    def backend_exists(self) -> bool:
        raise NotImplementedError

    def _remote_shell_line(self, process_id: int, num_processes: int,
                           coordinator: str, exports: Dict[str, str],
                           local_rank: int = 0, local_size: int = 1) -> str:
        addr, port = coordinator.rsplit(":", 1)
        env_parts = [f"{k}={shlex.quote(v)}"
                     for k, v in sorted(exports.items())]
        env_parts += [
            f"DSTPU_COORDINATOR={coordinator}",
            f"DSTPU_NUM_PROCESSES={num_processes}",
            f"DSTPU_PROCESS_ID={process_id}",
            f"MASTER_ADDR={addr}",
            f"MASTER_PORT={port}",
            f"RANK={process_id}",
            f"WORLD_SIZE={num_processes}",
            f"LOCAL_RANK={local_rank}",
            f"LOCAL_WORLD_SIZE={local_size}",
        ]
        return (f"cd {shlex.quote(os.getcwd())} && "
                + " ".join(env_parts)
                + f" {shlex.quote(sys.executable)} -u "
                + shlex.quote(self.args.user_script) + " "
                + " ".join(map(shlex.quote, self.args.user_args)))

    def get_cmd(self, host: str, process_id: int, num_processes: int,
                coordinator: str, exports: Dict[str, str],
                local_rank: int = 0, local_size: int = 1) -> List[str]:
        raise NotImplementedError


class SSHRunner(MultiNodeRunner):
    """Plain ssh per process (the default)."""

    name = "ssh"

    def backend_exists(self) -> bool:
        return shutil.which("ssh") is not None

    def get_cmd(self, host, process_id, num_processes, coordinator, exports,
                local_rank=0, local_size=1):
        line = self._remote_shell_line(process_id, num_processes,
                                       coordinator, exports, local_rank,
                                       local_size)
        if host in _LOCAL:
            return ["/bin/sh", "-c", line]
        return ["ssh", "-o", "StrictHostKeyChecking=no", host, line]


class PDSHRunner(MultiNodeRunner):
    """pdsh transport (reference ``PDSHRunner:35``), one command per
    process (each process's env differs)."""

    name = "pdsh"

    def backend_exists(self) -> bool:
        return shutil.which("pdsh") is not None

    def get_cmd(self, host, process_id, num_processes, coordinator, exports,
                local_rank=0, local_size=1):
        line = self._remote_shell_line(process_id, num_processes,
                                       coordinator, exports, local_rank,
                                       local_size)
        if host in _LOCAL:
            return ["/bin/sh", "-c", line]
        return ["pdsh", "-R", "ssh", "-w", host, line]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun transport (reference ``OpenMPIRunner:78``): one command
    that starts a process per slot; each takes its rank from
    ``OMPI_COMM_WORLD_RANK`` (``DSTPU_PROCESS_ID_FROM_MPI``) and its
    device from ``OMPI_COMM_WORLD_LOCAL_RANK``."""

    name = "openmpi"

    def backend_exists(self) -> bool:
        return shutil.which("mpirun") is not None

    def get_cmd_all(self, hosts: List[str], coordinator: str,
                    exports: Dict[str, str]) -> List[str]:
        slots = [len(self.world_info[h]) for h in hosts]
        cmd = ["mpirun", "-np", str(sum(slots)),
               "--host", ",".join(f"{h}:{n}" for h, n in zip(hosts, slots)),
               "--allow-run-as-root",
               "-wdir", os.getcwd()]
        for k, v in sorted(exports.items()):
            if k == "DSTPU_PROCESS_ID":
                # a stale per-rank id from the operator's shell would
                # shadow OMPI_COMM_WORLD_RANK on every rank
                continue
            cmd += ["-x", f"{k}={v}"]
        cmd += ["-x", f"DSTPU_COORDINATOR={coordinator}",
                "-x", f"DSTPU_NUM_PROCESSES={sum(slots)}",
                "-x", "DSTPU_PROCESS_ID_FROM_MPI=1"]
        cmd += [sys.executable, "-u", self.args.user_script]
        cmd += self.args.user_args
        return cmd

    def get_cmd(self, host, process_id, num_processes, coordinator, exports,
                local_rank=0, local_size=1):
        raise RuntimeError("OpenMPIRunner launches all processes in one "
                           "mpirun; use get_cmd_all")


def make_runner(launcher: str, args, world_info) -> MultiNodeRunner:
    runners = {"ssh": SSHRunner, "pdsh": PDSHRunner, "openmpi": OpenMPIRunner}
    if launcher not in runners:
        raise ValueError(f"unknown launcher {launcher!r}; "
                         f"choose from {sorted(runners)}")
    return runners[launcher](args, world_info)
