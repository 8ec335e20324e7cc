"""Ranks of the port's data-parallel CPU tests, spawned over gloo.

:func:`spawn` starts ``world`` processes with the ``spawn`` method (never
``fork`` of a process that has imported torch), each with torch's
rendezvous environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` from a socket bound to a free port) and
one torch thread, runs one of this module's jobs on the payload, and
returns every rank's result. The engines join the group through
``init_distributed`` when ``initialize(..., device="cpu")`` builds them.
This module imports torch and the port only, so the ranks start without
JAX.
"""

import os
import pickle
import socket
import tempfile

import numpy as np

# the tiny GPT-2 of the ZeRO tests: a vocab of 255 leaves wte's first dim
# odd, so ZeRO shards it on its second; "extra" (3, 5) divides by no data
# degree and stays replicated
MODEL = dict(vocab_size=255, max_position_embeddings=32, hidden_size=64,
             num_layers=2, num_heads=2, embd_dropout=0.0, attn_dropout=0.0,
             resid_dropout=0.0)
DROPOUT = dict(embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
EXTRA_SHAPE = (3, 5)
EXTRA_WEIGHT = 1e-2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, world: int, payload, timeout: float = 600.0):
    """Run ``job(payload)`` on ``world`` gloo ranks; their results in rank
    order. Raises if a rank fails or outlives ``timeout``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_entry,
                             args=(r, world, port, job, payload,
                                   os.path.join(d, f"rank{r}.pkl")))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        if alive or any(c != 0 for c in codes):
            raise RuntimeError(f"{job}: ranks exited {codes}"
                               f"{' (timed out)' if alive else ''}")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _entry(rank, world, port, job, payload, out_path):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    torch.set_num_threads(1)
    try:
        result = globals()[job](payload)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def loss_fn(dropout: bool = False):
    """The tiny GPT-2's fp32 loss plus ``EXTRA_WEIGHT * sum(extra**2)``
    (the JAX tests build the same sum)."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss_fn
    cfg = GPT2Config(**dict(MODEL, **(DROPOUT if dropout else {})))
    base = gpt2_loss_fn(cfg, dtype=torch.float32, deterministic=not dropout)

    def fn(params, batch, seed):
        core = {k: v for k, v in params.items() if k != "extra"}
        return base(core, batch, seed) + \
            EXTRA_WEIGHT * (params["extra"].float() ** 2).sum()
    return fn


def host(tree):
    from deepspeed_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().float().cpu().numpy().copy(), tree)


def train(payload):
    """Each case of ``payload["cases"]``: an engine over
    ``payload["params"]`` with the case's config (loading ``load`` first),
    ``steps`` train_batch calls over the case's global batches, the
    params after each call, then ``synchronize`` and ``save``."""
    import deepspeed_tpu_torch as dt
    out = {}
    for case in payload["cases"]:
        eng, *_ = dt.initialize(
            model=loss_fn(case.get("dropout", False)),
            model_parameters=payload["params"], config=case["config"],
            device="cpu", seed=case.get("seed", 0))
        if case.get("load"):
            eng.load_checkpoint(case["load"])
        it = iter(case["batches"])
        losses, windows = [], []
        for _ in range(case["steps"]):
            losses.append(float(eng.train_batch(it)))
            windows.append(host(eng.params))
        eng.synchronize()
        res = {"losses": losses, "windows": windows,
               "params": host(eng.module_params),
               "global_steps": eng.global_steps,
               "dp": eng.dp_world_size, "rank": eng.dp_rank,
               "dims": None if eng._part is None else list(eng._part.dims)}
        if eng.zero_cpu_offload:
            res["masters"] = [m.copy() for m in eng.optimizer.master_params]
        if case.get("save"):
            res["tag"] = eng.save_checkpoint(case["save"])
        eng.close()
        out[case["name"]] = res
    return out


def launched(payload):
    """A child of the launcher: what it was handed, and the mesh it
    builds over its group."""
    import torch
    from deepspeed_tpu_torch.distributed import init_distributed
    from deepspeed_tpu_torch.parallel.mesh import (build_mesh,
                                                   data_axis_size,
                                                   data_rank)
    init_distributed(device="cpu")
    mesh = build_mesh({"data": 2}, "cpu")
    try:        # JAX would run on a subset of its devices
        build_mesh({"data": 1}, "cpu")
        smaller = None
    except ValueError as e:
        smaller = str(e)
    return {"smaller_mesh": smaller,
            "env": {k: os.environ.get(k) for k in
                    ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                     "MASTER_ADDR", "MASTER_PORT", "DSTPU_WORLD_INFO")},
            "backend": torch.distributed.get_backend(),
            "mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
            "data_size": data_axis_size(mesh), "data_rank": data_rank(mesh)}


def extra_leaf(seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randn(*EXTRA_SHAPE).astype(
        np.float32) * 0.1
