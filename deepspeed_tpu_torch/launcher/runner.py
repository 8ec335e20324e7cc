"""The port's launcher, ``dstpu`` (the port of
``deepspeed_tpu/launcher/runner.py``).

    python -m deepspeed_tpu_torch.launcher.runner [--num_gpus N] \\
        train.py --deepspeed_config ds.json
    python -m deepspeed_tpu_torch.launcher.runner --hostfile hosts \\
        train.py ...

One process per device, as the reference launcher ran
(``deepspeed/launcher/launch.py``), where the JAX package runs one per
host: a local launch spawns one child per local slot (``--num_gpus``, or
the hostfile's ``slots``, default the card count), and a multi-host
launch renders one command per device (``launcher/multinode_runner.py``).
Each child gets torch's ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, which
``init_distributed`` reads (``distributed.py``), beside the JAX
launcher's exports (``collect_env_exports``, ``DSTPU_WORLD_INFO``,
``DSTPU_RESTART_COUNT``).

A wave of children exits with the resumable code 85 if any child did,
else with the first nonzero code; when a child fails the others are
stopped. ``--supervise`` relaunches the wave on the preemption drain's
code (85) and the hang watchdog's (87), sleeping ``backoff * 2**n``
before relaunch ``n + 1``; any other nonzero exit is a genuine failure.
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.runtime.elastic import (RESTART_COUNT_ENV,
                                                 RESUMABLE_EXIT_CODE)
from deepspeed_tpu_torch.utils.health import STALL_EXIT_CODE
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["RESTARTABLE_EXIT_CODES", "restart_eligible", "parse_args",
           "supervise", "fetch_hostfile", "parse_resource_filter",
           "encode_world_info", "decode_world_info", "collect_env_exports",
           "local_children_env", "wave_exit_code", "main"]

#: exit codes a supervisor answers with a relaunch: the preemption drain
#: (85) and the watchdog's exit (87)
RESTARTABLE_EXIT_CODES = (RESUMABLE_EXIT_CODE, STALL_EXIT_CODE)


def restart_eligible(rc: Optional[int]) -> bool:
    """True when exit code ``rc`` should be answered with a relaunch
    (:func:`supervise` and the serving fleet's replica supervision,
    ``inference/fleet.py``)."""
    return rc in RESTARTABLE_EXIT_CODES


DLTS_HOSTFILE = "/job/hostfile"
ENV_FILE = ".deepspeed_env"
EXPORT_ENVS = ["PYTHONPATH", "PATH", "LD_LIBRARY_PATH", "CUDA_", "NCCL_",
               "DSTPU_"]


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed-TPU torch launcher: run a training script "
                    "on every GPU of one or more hosts, one process per "
                    "GPU")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="Hostfile path: lines of '<hostname> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Host filter, e.g. 'worker-0@worker-1'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Host exclusion filter")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="Limit number of hosts")
    parser.add_argument("--num_gpus", type=int, default=-1,
                        help="Processes (GPUs) per host; default the "
                             "hostfile's slots, else the local card count")
    parser.add_argument("--master_port", type=int, default=29500,
                        help="Rendezvous port of the process group")
    parser.add_argument("--master_addr", type=str, default="",
                        help="Rendezvous address (default: first host)")
    parser.add_argument("--launcher", type=str, default="ssh",
                        choices=["ssh", "pdsh", "openmpi", "local"],
                        help="Multi-node transport (reference supports "
                             "pdsh/openmpi/mvapich, multinode_runner.py)")
    parser.add_argument("--force_multi", action="store_true",
                        help="Treat as multi-node even for one host")
    parser.add_argument("--supervise", action="store_true",
                        help="Relaunch the job (with exponential backoff) "
                             "whenever it exits with the resumable "
                             f"preemption code {RESUMABLE_EXIT_CODE} or "
                             f"the hang-watchdog code {STALL_EXIT_CODE}")
    parser.add_argument("--max_restarts", type=int, default=3,
                        help="Supervisor: give up after this many "
                             "resumable restarts (default 3)")
    parser.add_argument("--restart_backoff", type=float, default=1.0,
                        help="Supervisor: base backoff seconds before a "
                             "relaunch; doubles per restart (default 1.0)")
    parser.add_argument("user_script", type=str,
                        help="User training script")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def supervise(run_once: Callable[[int], int], max_restarts: int = 3,
              backoff: float = 1.0, sleep: Callable[[float], None] = None
              ) -> int:
    """Relaunch-on-preemption loop. ``run_once(restart_count)`` launches
    the job and returns its exit code; the loop relaunches only on
    :data:`RESTARTABLE_EXIT_CODES`, sleeping ``backoff * 2**restart``
    seconds between lives, and returns any other code at once, or the
    restartable code once ``max_restarts`` are spent."""
    sleep = time.sleep if sleep is None else sleep
    restarts = 0
    while True:
        rc = run_once(restarts)
        if not restart_eligible(rc):
            if rc != 0:
                logger.error(f"dstpu supervisor: job failed (exit {rc}); "
                             "not a preemption — giving up")
            return rc
        if restarts >= max_restarts:
            logger.error(
                f"dstpu supervisor: restartable exit but max_restarts="
                f"{max_restarts} exhausted; giving up with exit {rc}")
            return rc
        delay = backoff * (2 ** restarts)
        restarts += 1
        kind = "preemption drain" if rc == RESUMABLE_EXIT_CODE \
            else "watchdog kill"
        logger.warning(
            f"dstpu supervisor: {kind} (exit {rc}); relaunch "
            f"{restarts}/{max_restarts} in {delay:.1f}s")
        sleep(delay)


def fetch_hostfile(hostfile_path: str) -> Optional[Dict[str, int]]:
    """Parse '<hostname> slots=<n>' lines (reference runner.py:115)."""
    if not os.path.isfile(hostfile_path):
        logger.warning(f"Unable to find hostfile, will proceed with training "
                       f"with local resources only: {hostfile_path}")
        return None
    resource_pool: "OrderedDict[str, int]" = OrderedDict()
    with open(hostfile_path, "r") as fd:
        for line in fd.readlines():
            line = line.strip()
            if line == "" or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                key, slot_count = slots.split("=")
                if key != "slots":
                    raise ValueError(f"expected slots=<n>, got {slots}")
                slot_count = int(slot_count)
            except ValueError:
                logger.error(f"Hostfile is not formatted correctly, unable to "
                             f"proceed with training: '{line}'")
                raise ValueError(f"bad hostfile line: '{line}'")
            if hostname in resource_pool:
                logger.error(f"Hostfile contains duplicate hosts, unable to "
                             f"proceed with training: {hostname}")
                raise ValueError(f"duplicate host: {hostname}")
            resource_pool[hostname] = slot_count
    return resource_pool


def _parse_filter_str(s: str) -> Dict[str, Optional[List[int]]]:
    """Parse 'host1@host2:0,2' style filters (reference runner.py:143):
    host -> list of slot indices (None = all slots)."""
    out: "OrderedDict[str, Optional[List[int]]]" = OrderedDict()
    if not s:
        return out
    for term in s.split("@"):
        term = term.strip()
        if ":" in term:
            host, slot_str = term.split(":")
            out[host] = [int(x) for x in slot_str.split(",")]
        else:
            out[term] = None
    return out


def parse_resource_filter(host_info: Dict[str, int], include_str: str = "",
                          exclude_str: str = "") -> Dict[str, List[int]]:
    """Apply include/exclude filters to the host pool."""
    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually exclusive")

    full = OrderedDict(
        (host, list(range(slots))) for host, slots in host_info.items())

    if include_str:
        inc = _parse_filter_str(include_str)
        filtered = OrderedDict()
        for host, slots in inc.items():
            if host not in full:
                raise ValueError(f"include host {host} not in hostfile")
            use = slots if slots is not None else full[host]
            for s in use:
                if s not in full[host]:
                    raise ValueError(f"include slot {host}:{s} does not exist")
            filtered[host] = use
        return filtered

    if exclude_str:
        exc = _parse_filter_str(exclude_str)
        for host, slots in exc.items():
            if host not in full:
                raise ValueError(f"exclude host {host} not in hostfile")
            if slots is not None:
                for s in slots:
                    if s not in full[host]:
                        raise ValueError(
                            f"exclude slot {host}:{s} does not exist")
        filtered = OrderedDict()
        for host, slots in full.items():
            if host in exc:
                if exc[host] is None:
                    continue  # exclude whole host
                keep = [s for s in slots if s not in exc[host]]
                if keep:
                    filtered[host] = keep
            else:
                filtered[host] = slots
        return filtered

    return full


def encode_world_info(resource_pool: Dict[str, List[int]]) -> str:
    """Base64-encode the host->slots map for env transport
    (reference runner.py:245)."""
    world_info = json.dumps(resource_pool)
    return base64.urlsafe_b64encode(world_info.encode("utf-8")).decode("utf-8")


def decode_world_info(encoded: str) -> Dict[str, List[int]]:
    return json.loads(base64.urlsafe_b64decode(encoded).decode("utf-8"))


def collect_env_exports() -> Dict[str, str]:
    """Env vars to propagate to the children, plus .deepspeed_env
    overrides (reference runner.py:345-351)."""
    exports = {}
    for var, val in os.environ.items():
        if any(var == v or (v.endswith("_") and var.startswith(v))
               for v in EXPORT_ENVS):
            exports[var] = val
    env_file = os.path.join(os.path.expanduser("~"), ENV_FILE)
    for candidate in [ENV_FILE, env_file]:
        if os.path.isfile(candidate):
            with open(candidate) as f:
                for line in f:
                    line = line.strip()
                    if "=" in line and not line.startswith("#"):
                        key, val = line.split("=", 1)
                        exports[key.strip()] = val.strip()
    return exports


def local_children_env(n: int, master_addr: str, master_port: int,
                       exports: Dict[str, str]) -> List[Dict[str, str]]:
    """The environment of each of ``n`` local children: this process's,
    the exports, and torch's rendezvous variables of rank ``i``."""
    envs = []
    for i in range(n):
        env = os.environ.copy()
        env.update(exports)
        env.update(RANK=str(i), LOCAL_RANK=str(i), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR=master_addr,
                   MASTER_PORT=str(master_port))
        envs.append(env)
    return envs


def wave_exit_code(codes: List[int]) -> int:
    """A wave's exit code: the resumable 85 if any process gave it (one
    drained process and the others stopped still read as a preemption),
    else the first nonzero code, else 0."""
    if RESUMABLE_EXIT_CODE in codes:
        return RESUMABLE_EXIT_CODE
    return next((c for c in codes if c != 0), 0)


def _wait_wave(procs: List[subprocess.Popen]) -> int:
    """Wait for every process of a wave; once one fails, stop the others
    (they would wait on it in a collective)."""
    stopped = False
    while any(p.poll() is None for p in procs):
        if not stopped and any(p.returncode not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            stopped = True
        time.sleep(0.05)
    return wave_exit_code([p.returncode for p in procs])


def _local_slots(args, resource_pool) -> int:
    if args.num_gpus > 0:
        return args.num_gpus
    if resource_pool:
        return next(iter(resource_pool.values()))
    import torch
    return max(1, torch.cuda.device_count())


def main(args=None):
    args = parse_args(args)
    resource_pool = fetch_hostfile(args.hostfile)
    if resource_pool is None and args.force_multi:
        resource_pool = OrderedDict(localhost=max(args.num_gpus, 1))

    exports = collect_env_exports()
    if resource_pool is None or args.launcher == "local":
        n = _local_slots(args, resource_pool)
        exports["DSTPU_WORLD_INFO"] = encode_world_info(
            {"localhost": list(range(n))})
        cmd = [sys.executable, "-u", args.user_script] + args.user_args
        logger.info(f"dstpu local launch, {n} processes: {' '.join(cmd)}")

        def run_local(restarts: int) -> int:
            exports[RESTART_COUNT_ENV] = str(restarts)
            envs = local_children_env(n, args.master_addr or "127.0.0.1",
                                      args.master_port, exports)
            return _wait_wave([subprocess.Popen(cmd, env=env)
                               for env in envs])

        rc = (supervise(run_local, max_restarts=args.max_restarts,
                        backoff=args.restart_backoff)
              if args.supervise else run_local(0))
        if rc != 0:
            sys.exit(rc)
        return

    active = parse_resource_filter(resource_pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    if args.num_gpus > 0:
        active = OrderedDict((h, s[:args.num_gpus])
                             for h, s in active.items())

    hosts = list(active.keys())
    coordinator = f"{args.master_addr or hosts[0]}:{args.master_port}"
    exports["DSTPU_WORLD_INFO"] = encode_world_info(active)

    from deepspeed_tpu_torch.launcher.multinode_runner import make_runner
    runner = make_runner(args.launcher, args, active)
    nonlocal_hosts = [h for h in hosts
                      if h not in ("localhost", "127.0.0.1")]
    if (nonlocal_hosts or args.launcher == "openmpi") and \
            not runner.backend_exists():
        raise RuntimeError(
            f"launcher backend '{args.launcher}' not found on PATH "
            f"(hosts: {hosts})")
    world = sum(len(s) for s in active.values())

    def run_wave(restarts: int) -> int:
        exports[RESTART_COUNT_ENV] = str(restarts)
        procs = []
        if args.launcher == "openmpi":
            cmd = runner.get_cmd_all(hosts, coordinator, exports)
            logger.info(f"dstpu mpirun launch: {' '.join(cmd[:8])} ...")
            procs.append(subprocess.Popen(cmd))
        else:
            rank = 0
            for host, slots in active.items():
                for local in range(len(slots)):
                    cmd = runner.get_cmd(host, rank, world, coordinator,
                                         exports, local_rank=local,
                                         local_size=len(slots))
                    logger.info(f"dstpu launching on {host}: process "
                                f"{rank}/{world} (local {local})")
                    procs.append(subprocess.Popen(cmd))
                    rank += 1
        return _wait_wave(procs)

    exit_code = (supervise(run_wave, max_restarts=args.max_restarts,
                           backoff=args.restart_backoff)
                 if args.supervise else run_wave(0))
    if exit_code != 0:
        sys.exit(exit_code)


if __name__ == "__main__":
    main()
