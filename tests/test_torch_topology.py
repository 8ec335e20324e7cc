"""The port's topology, mesh rank math and launcher
(``parallel/topology.py``, ``parallel/mesh.py``, ``distributed.py``,
``launcher/runner.py``, ``launcher/multinode_runner.py``) against the JAX
package on the same inputs, and a local launch of two gloo children.
"""

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
from tests import torch_dist_worker as W

REPO = pathlib.Path(__file__).resolve().parents[1]


def _topo_modules():
    import deepspeed_tpu.parallel.topology as jt
    import deepspeed_tpu_torch.parallel.topology as tt
    return jt, tt


def _coords(c):
    return tuple(c._asdict().items())


# the cases of tests/unit/test_topology.py, each a function of the
# topology module: the port must give JAX's answer
TOPOLOGY_CASES = {
    "2d_mapping": lambda m: (
        [m.ProcessTopology(["x", "y"], [2, 2]).get_rank(x=a, y=b)
         for a in range(2) for b in range(2)],
        _coords(m.ProcessTopology(["x", "y"], [2, 2]).get_coord(1))),
    "roundtrip": lambda m: [
        _coords(m.ProcessTopology(["a", "b", "c"], [2, 3, 4]).get_coord(r))
        for r in range(24)],
    "axis_comm_lists": lambda m: (
        m.PipeDataParallelTopology(2, 2).get_axis_comm_lists("data"),
        m.PipeDataParallelTopology(2, 2).get_axis_comm_lists("pipe"),
        m.PipeDataParallelTopology(2, 2).get_axis_comm_lists("model")),
    "filter_match": lambda m: (
        m.PipeModelDataParallelTopology(2, 2, 2).filter_match(pipe=0,
                                                              model=0),
        m.PipeModelDataParallelTopology(2, 2, 2).filter_match(pipe=1)),
    "axis_list": lambda m: m.PipeDataParallelTopology(2, 4).get_axis_list(
        "pipe", 1),
    "rank_repr": lambda m: [
        m.PipeModelDataParallelTopology(2, 2, 2).get_rank_repr(r)
        for r in range(8)],
    "split_axis": lambda m: [
        _coords(m.ProcessTopology(["pipe", "data"], [2, 8]).split_axis(
            "data", "data_inter", "data_intra", 4).get_coord(r))
        for r in range(16)],
    "3d_sizes": lambda m: (
        m.PipeModelDataParallelTopology(2, 2, 4).world_size(),
        m.PipeModelDataParallelTopology(2, 2, 4).get_dim("data"),
        m.PipeModelDataParallelTopology(2, 2, 4).get_dim("absent"),
        str(m.PipeModelDataParallelTopology(2, 2, 4))),
    "grid_getters": lambda m: [
        (g.get_data_parallel_rank(), g.get_model_parallel_rank(),
         g.get_pipe_parallel_rank(), g.get_data_parallel_world_size(),
         g.get_model_parallel_world_size(), g.get_pipe_parallel_world_size(),
         g.get_data_parallel_group(), g.get_model_parallel_group(),
         g.is_first_stage(), g.is_last_stage(), g.stage_to_global(1),
         g.p2p_pairs())
        for r in range(8) for g in [m.ParallelGrid(
            m.PipeModelDataParallelTopology(2, 2, 2), process_index=r)]],
}


def _errors(m):
    out = []
    for fn in (lambda: m.ProcessTopology(["x"], [1, 2]),
               lambda: m.ProcessTopology(["x", "x"], [1, 2]),
               lambda: m.ProcessTopology(["x"], [0]),
               lambda: m.ProcessTopology(["x", "y"], [2, 2]).get_rank(x=0),
               lambda: m.ProcessTopology(["x"], [2]).get_rank(x=2),
               lambda: m.ProcessTopology(["x"], [2]).get_coord(2),
               lambda: m.ProcessTopology(["d"], [6]).split_axis(
                   "d", "o", "i", 4),
               lambda: m.ProcessTopology(["d"], [6]).split_axis(
                   "e", "o", "i", 2),
               lambda: m.ProcessTopology(["d", "i"], [6, 1]).split_axis(
                   "d", "o", "i", 2)):
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


TOPOLOGY_CASES["errors"] = _errors


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_topology_gives_jax_answers(case):
    jt, tt = _topo_modules()
    assert TOPOLOGY_CASES[case](tt) == TOPOLOGY_CASES[case](jt)


def test_parallel_grid_defaults_to_the_process_group():
    """Without a group a process is rank 0 of a data axis of one; JAX's
    default is every device on data (its rank: the first local
    device's)."""
    from deepspeed_tpu_torch.parallel.topology import ParallelGrid
    g = ParallelGrid()
    assert (g.world_size, g.global_rank, g.get_data_parallel_world_size(),
            g.get_data_parallel_rank()) == (1, 0, 1, 0)


MESH_INPUTS = [
    ("resolve", (None, 8)), ("resolve", ({"data": -1, "model": 2}, 8)),
    ("resolve", ({"model": 2, "pipe": 2, "data": 2}, 8)),
    ("resolve", ({"data": -1, "model": -1}, 8)),
    ("resolve", ({"data": -1, "model": 3}, 8)),
    ("resolve", ({"zz": 2, "data": 4}, 8)),
    ("order", ({"model": 2, "data_intra": 2, "foo": 1, "pipe": 1},)),
    ("split", ({"data": 8}, 4)), ("split", ({"data": 8, "model": 1}, 2)),
    ("split", ({"data": 8}, 3)), ("split", ({"model": 8}, 2)),
    ("split", ({"data": 8}, 1)), ("split", ({"data": -1}, 2)),
    ("split", ({"data_inter": 2, "data_intra": 4}, 4)),
    ("split", ({"data_inter": 2, "data_intra": 4}, 2)),
]


def _mesh_call(m, kind, args):
    fn = {"resolve": m.resolve_axis_sizes, "order": m._order_axes,
          "split": m.split_data_axis}[kind]
    try:
        out = fn(*args)
        return ("ok", list(out.items()))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("i", range(len(MESH_INPUTS)))
def test_mesh_axis_rules_equal_jax(i):
    import deepspeed_tpu.parallel.mesh as jm
    import deepspeed_tpu_torch.parallel.mesh as tm
    kind, args = MESH_INPUTS[i]
    assert _mesh_call(tm, kind, args) == _mesh_call(jm, kind, args)


def test_local_mesh_accessors():
    from deepspeed_tpu_torch.parallel.mesh import (
        axis_size, build_mesh, data_axis_names, data_axis_size, data_rank,
        data_sharding, replicated, single_device_mesh)
    mesh = build_mesh(None, "cpu")
    assert list(mesh.mesh_dim_names) == ["data"] and data_axis_size(mesh) == 1
    hier = build_mesh({"data_inter": 1, "data_intra": 1}, "cpu")
    assert data_axis_names(hier) == ("data_inter", "data_intra")
    assert data_rank(hier) == 0 and axis_size(hier, "model") == 1
    assert data_sharding(mesh) == (0, 1) and replicated(mesh) == (0, 1)
    one = single_device_mesh()
    assert one.mesh_dim_names == ("pipe", "data", "model")
    from deepspeed_tpu_torch.parallel.mesh import (RowSlice,
                                                   mesh_from_topology)
    from deepspeed_tpu_torch.parallel.topology import \
        PipeDataParallelTopology
    topo_mesh = mesh_from_topology(PipeDataParallelTopology(1, 1), "cpu")
    assert tuple(topo_mesh.mesh_dim_names) == ("pipe", "data")
    rows = RowSlice(1, 2)
    assert rows.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="equal parts"):
        rows.rows(7)


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #
def _runner_modules():
    import deepspeed_tpu.launcher.runner as jr
    import deepspeed_tpu_torch.launcher.runner as tr
    return jr, tr


ARGS = [["train.py"], ["-H", "h", "-i", "w0@w1:0,2", "--num_nodes", "2",
                       "--master_port", "123", "--launcher", "pdsh",
                       "--supervise", "--max_restarts", "5",
                       "--restart_backoff", "0.5", "t.py", "--a", "1"],
        ["--force_multi", "--master_addr", "10.0.0.1", "x.py"]]


@pytest.mark.parametrize("i", range(len(ARGS)))
def test_parse_args_equal_jax(i):
    jr, tr = _runner_modules()
    got, want = vars(tr.parse_args(ARGS[i])), vars(jr.parse_args(ARGS[i]))
    assert got.pop("num_gpus") == -1       # the port's one extra flag
    assert got == want


def test_hostfile_filters_and_world_info_equal_jax(tmp_path):
    jr, tr = _runner_modules()
    hf = tmp_path / "hostfile"
    hf.write_text("# hosts\nworker-0 slots=4\n\nworker-1 slots=2\n")
    pool = tr.fetch_hostfile(str(hf))
    assert pool == jr.fetch_hostfile(str(hf))
    assert tr.fetch_hostfile(str(tmp_path / "none")) is None
    for inc, exc in (("", ""), ("worker-1", ""), ("worker-0:1,3", ""),
                     ("", "worker-0:0"), ("", "worker-1")):
        got = tr.parse_resource_filter(pool, inc, exc)
        assert got == jr.parse_resource_filter(pool, inc, exc)
        enc = tr.encode_world_info(got)
        assert enc == jr.encode_world_info(got)
        assert tr.decode_world_info(enc) == jr.decode_world_info(enc)
    for inc, exc in (("w9", ""), ("", "w9"), ("worker-0:9", ""),
                     ("a", "b")):
        for m in (tr, jr):
            with pytest.raises(ValueError):
                m.parse_resource_filter(pool, inc, exc)
    for bad in ("host slots=x\n", "host cores=2\n", "a slots=1\na slots=2\n"):
        hf.write_text(bad)
        for m in (tr, jr):
            with pytest.raises(ValueError):
                m.fetch_hostfile(str(hf))


def test_env_exports_equal_jax(tmp_path, monkeypatch):
    """On an environment without CUDA/NCCL or TPU/JAX/XLA variables (the
    two packages' own prefixes), with a ``.deepspeed_env``."""
    jr, tr = _runner_modules()
    for k in list(os.environ):
        if k.startswith(("CUDA_", "NCCL_", "TPU_", "JAX_", "XLA_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("DSTPU_X", "1")
    monkeypatch.setenv("NOT_EXPORTED", "2")
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".deepspeed_env").write_text("# c\nA=b=c\nPATH=/x\n")
    got = tr.collect_env_exports()
    assert got == jr.collect_env_exports()
    assert got["A"] == "b=c" and got["DSTPU_X"] == "1"
    assert "NOT_EXPORTED" not in got


@pytest.mark.parametrize("codes,want,restarts", [
    ([85, 0], 0, 1), ([87, 85, 0], 0, 2), ([1], 1, 0), ([85, 85], 85, 1),
    ([0], 0, 0)])
def test_supervise_relaunches_on_85_and_87(codes, want, restarts):
    """Relaunch on the drain's 85 and the watchdog's 87 after backoff *
    2**n, give up at once on 1, stop after max_restarts; as JAX's."""
    jr, tr = _runner_modules()
    for m in (tr, jr):
        calls, sleeps, it = [], [], iter(codes)

        def run(n):
            calls.append(n)
            return next(it)
        rc = m.supervise(run, max_restarts=1 if codes == [85, 85] else 3,
                         backoff=0.5, sleep=sleeps.append)
        assert rc == want and calls == list(range(restarts + 1))
        assert sleeps == [0.5 * 2 ** n for n in range(restarts)]


@pytest.mark.parametrize("local,world,want", [("", 8, 0), ("4", 4, 0),
                                              ("4", 8, 4), ("1", 8, 0),
                                              ("3", 8, 0)])
def test_natural_intra_size_from_the_local_world(monkeypatch, local, world,
                                                 want):
    """Devices per host when the group spans hosts of 2 or more devices
    each, else 0 (JAX's hint: devices per process)."""
    from deepspeed_tpu_torch.parallel import mesh
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(mesh, "_world", lambda: world)
    assert mesh.natural_intra_size() == want


def test_wave_exit_code():
    from deepspeed_tpu_torch.launcher.runner import wave_exit_code
    assert wave_exit_code([0, 0]) == 0
    assert wave_exit_code([1, 85, 2]) == 85
    assert wave_exit_code([0, 3, 2]) == 3


def test_runner_command_lines_are_pinned(monkeypatch):
    """One command per device: the ssh and pdsh lines carry torch's
    rendezvous variables beside JAX's; mpirun starts a process per slot
    and takes ranks from OMPI_COMM_WORLD_RANK."""
    from deepspeed_tpu_torch.launcher.multinode_runner import make_runner
    monkeypatch.chdir("/")
    args = SimpleNamespace(user_script="train.py", user_args=["--x", "a b"])
    world = {"w0": [0, 1], "w1": [0, 1]}
    line = ("cd / && A=1 DSTPU_COORDINATOR=w0:29500 DSTPU_NUM_PROCESSES=4 "
            "DSTPU_PROCESS_ID=3 MASTER_ADDR=w0 MASTER_PORT=29500 RANK=3 "
            "WORLD_SIZE=4 LOCAL_RANK=1 LOCAL_WORLD_SIZE=2 "
            f"{sys.executable} -u train.py --x 'a b'")
    ssh = make_runner("ssh", args, world).get_cmd(
        "w1", 3, 4, "w0:29500", {"A": "1"}, local_rank=1, local_size=2)
    assert ssh == ["ssh", "-o", "StrictHostKeyChecking=no", "w1", line]
    pdsh = make_runner("pdsh", args, world).get_cmd(
        "w1", 3, 4, "w0:29500", {"A": "1"}, local_rank=1, local_size=2)
    assert pdsh == ["pdsh", "-R", "ssh", "-w", "w1", line]
    assert make_runner("ssh", args, world).get_cmd(
        "localhost", 3, 4, "w0:29500", {"A": "1"}, 1, 2)[:2] == \
        ["/bin/sh", "-c"]
    mpi = make_runner("openmpi", args, world)
    assert mpi.get_cmd_all(["w0", "w1"], "w0:29500",
                           {"A": "1", "DSTPU_PROCESS_ID": "7"}) == [
        "mpirun", "-np", "4", "--host", "w0:2,w1:2", "--allow-run-as-root",
        "-wdir", "/", "-x", "A=1", "-x", "DSTPU_COORDINATOR=w0:29500",
        "-x", "DSTPU_NUM_PROCESSES=4", "-x", "DSTPU_PROCESS_ID_FROM_MPI=1",
        sys.executable, "-u", "train.py", "--x", "a b"]
    with pytest.raises(RuntimeError, match="get_cmd_all"):
        mpi.get_cmd("w0", 0, 4, "w0:29500", {})
    with pytest.raises(ValueError, match="unknown launcher"):
        make_runner("mvapich", args, world)


def test_rendezvous_from_the_environment(monkeypatch):
    """torch's variables first, then JAX's coordinator form (above one
    process, the MPI rank under DSTPU_PROCESS_ID_FROM_MPI); nothing set:
    a single process."""
    from deepspeed_tpu_torch import distributed as d
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES",
              "DSTPU_PROCESS_ID", "DSTPU_PROCESS_ID_FROM_MPI",
              "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert d._rendezvous(None, None, None) is None
    d.init_distributed(device="cpu")          # a no-op
    assert not d.is_initialized()
    monkeypatch.setenv("DSTPU_COORDINATOR", "h:9")
    monkeypatch.setenv("DSTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("DSTPU_PROCESS_ID", "0")
    assert d._rendezvous(None, None, None) is None      # one process
    monkeypatch.setenv("DSTPU_NUM_PROCESSES", "4")
    monkeypatch.delenv("DSTPU_PROCESS_ID")
    monkeypatch.setenv("DSTPU_PROCESS_ID_FROM_MPI", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "2")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    assert d._rendezvous(None, None, None) == ("tcp://h:9", 4, 2)
    assert d.local_rank() == 1
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "a"),
                 ("MASTER_PORT", "5"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    assert d._rendezvous(None, None, None) == ("tcp://a:5", 1, 1)
    assert d.local_rank() == 0
    # the backend follows the device: nccl unless the CPU is asked for,
    # and without a card that raises before any group is made
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            d.init_distributed()
        assert not d.is_initialized()
    assert d._rendezvous("x:1", 2, 0) == ("tcp://x:1", 2, 0)


class _Resolved(Exception):
    pass


def test_engine_joins_the_group_before_it_picks_its_device(monkeypatch):
    """Under the launcher a rank with no explicit device trains on device
    LOCAL_RANK: the engine joins the group (which binds the process to
    that device) before it resolves its default device. A card is faked
    here: the engine stops as soon as its device is known."""
    import torch
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime import engine as eng
    bound, made, got = [0], [], []
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "5")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: bound.__setitem__(0, i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: bound[0])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: made.append(backend))

    real = eng.resolve_device

    def resolve(device):
        got.append(real(device))
        raise _Resolved

    monkeypatch.setattr(eng, "resolve_device", resolve)
    with pytest.raises(_Resolved):
        deepspeed_tpu_torch.initialize(
            model=lambda p, b: p, model_parameters={"w": torch.zeros(2)},
            config={"train_micro_batch_size_per_gpu": 1})
    assert made == ["nccl"]
    assert got == [torch.device("cuda", 1)]


CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
if os.environ["DSTPU_RESTART_COUNT"] == "0":
    sys.exit(85)          # the first wave drains, as a preemption would
from tests import torch_dist_worker as W
res = W.launched(None)
with open(sys.argv[1] + "." + res["env"]["RANK"], "w") as f:
    json.dump(res, f)
"""


def test_local_launch_of_two_gloo_children(tmp_path):
    """``python -m deepspeed_tpu_torch.launcher.runner --num_gpus 2
    --supervise``: the first wave exits 85 and is relaunched once; then
    each child gets its rank, local rank and world size, joins the gloo
    group and builds a ``{"data": 2}`` mesh, and the launcher exits 0."""
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(repo=str(REPO)))
    out = tmp_path / "res"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", "2", "--master_port", str(W.free_port()),
         "--supervise", "--max_restarts", "1", "--restart_backoff", "0",
         str(script), str(out)], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    res = [json.loads((tmp_path / f"res.{r}").read_text()) for r in (0, 1)]
    for r, got in enumerate(res):
        assert got["env"]["RANK"] == got["env"]["LOCAL_RANK"] == str(r)
        assert got["env"]["WORLD_SIZE"] == got["env"]["LOCAL_WORLD_SIZE"] \
            == "2"
        assert got["backend"] == "gloo"
        assert got["mesh"] == [["data"], [2]]
        assert (got["data_size"], got["data_rank"]) == (2, r)
        # a mesh smaller than the group raises (JAX takes a device subset)
        assert "one process per device" in got["smaller_mesh"]
    from deepspeed_tpu_torch.launcher.runner import decode_world_info
    assert decode_world_info(res[0]["env"]["DSTPU_WORLD_INFO"]) == \
        {"localhost": [0, 1]}
    assert "relaunch 1/1" in p.stdout + p.stderr
