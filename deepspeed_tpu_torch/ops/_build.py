"""Build and load the port's CUDA kernels.

Each source under ``deepspeed_tpu_torch/csrc/`` compiles with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
through ``ctypes`` (no PyTorch headers, so a build takes seconds). The
build happens at first use, from the checkout's sources only, into
``deepspeed_tpu_torch/.build/`` (listed in ``.gitignore``); the library
name carries a hash of the source, the shared headers and the flags, so
an edited source or header builds anew and an unchanged one loads what
is there. :func:`build_all` starts
one ``nvcc`` per source, all at once. :func:`arrival_counts` keeps the
counters of the kernels whose splits merge in the same launch.

:func:`build_host` builds a host C++ source the same way with ``g++``
(``csrc/Makefile``'s flags): the ZeRO-Offload CPU Adam of
``csrc/adam/cpu_adam.cpp``, loaded by ``ops/adam/cpu_adam.py``.
"""

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# csrc/Makefile's flags for the host libraries
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-Wall"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # source name -> nvcc's output (ptxas -v)
_arrivals: dict = {}   # (owner, device index, stream) -> int32 counters


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels build from source at first use")
    return found


def _target(name: str) -> str:
    """The library path of ``csrc/<name>``, named by a hash of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for part in (name, *headers):
        with open(os.path.join(CSRC, part), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every listed source (default: all ``csrc/*.cu``) that has
    no up-to-date library yet, one ``nvcc`` process per source, started
    together. Returns {source name: library path}; raises with nvcc's
    output if any build fails."""
    if names is None:
        names = sorted(n for n in os.listdir(CSRC) if n.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time per checkout
        procs = {}
        for n, so in targets.items():
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            build_logs[n] = out
            if p.returncode != 0:
                failed.append(f"{n}:\n{out}")
            else:
                os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        _loaded[name] = lib
    return lib


def _host_compilers() -> List[str]:
    """The C++ compilers to try, in order: ``$CXX``, ``g++`` on the path,
    the system's ``/usr/bin/g++`` (each once)."""
    found = []
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 "/usr/bin/g++"):
        if cand and os.path.isfile(cand) and cand not in found:
            found.append(cand)
    return found


def build_host(source: str) -> str:
    """The library of the host C++ file ``source`` (a path), compiled with
    :data:`HOST_FLAGS` into ``.build/`` under a name that hashes the
    source and the flags, at first use and under the build lock, written
    to a temporary name and renamed into place, so no process loads a
    half-written file. The compilers of :func:`_host_compilers` are tried
    in turn (a toolchain's ``g++`` may lack the OpenMP runtime that
    ``-fopenmp`` links); raises when the source is missing or every
    compiler fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    compilers = _host_compilers()
    if not compilers:
        raise RuntimeError(f"no C++ compiler ($CXX or g++) to build {source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):         # another process built it meanwhile
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        errors = []
        for cxx in compilers:
            p = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, source],
                               capture_output=True, text=True)
            build_logs[os.path.basename(source)] = \
                f"{cxx}\n{p.stdout}{p.stderr}"
            if p.returncode == 0:
                os.replace(tmp, so)
                return so
            errors.append(f"{cxx}:\n{p.stdout}{p.stderr}")
        raise RuntimeError(f"the build of {source} failed with every "
                           "compiler:\n" + "\n".join(errors))


def arrival_counts(owner: str, device, stream: int, n: int):
    """At least ``n`` int32 arrival counters of ``owner``'s split kernel on
    ``device`` and ``stream``: the CTA of a split that arrives last merges
    and sets its count back to zero, so the counters are zero between
    launches and are zeroed once, when made or grown. They must exist
    before a CUDA graph captures a launch on ``stream`` (the program
    set's eager pass makes them): zeroing them inside a capture would put
    a memset into the graph, so that raises."""
    import torch
    key = (owner, device.index, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{owner}: arrival counters for stream {stream} made inside "
                f"a CUDA graph capture; run the launch once before "
                f"capturing it")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrivals[key] = buf
    return buf


def ptxas_summary(log: str) -> List[dict]:
    """Per kernel of one ``build_logs`` entry: its (mangled) name,
    registers per thread, and the bytes of its stack frame, spill stores
    and spill loads, as ``ptxas -v`` reports them."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
