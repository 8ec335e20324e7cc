"""Device-mesh construction (the port of ``deepspeed_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` with named axes; the
port builds a ``torch.distributed.device_mesh.DeviceMesh`` over its
process group, with the same axis names as its dim names, one process
per device. A single process without a group gets a :class:`LocalMesh`
of the same names and sizes (all 1), so the accessors answer alike.

Canonical axis names (any subset may be present, size-1 axes are legal):
``pipe``, ``data`` (ZeRO shards along it too), ``data_inter`` /
``data_intra`` (the data axis split in two, major first), ``expert``,
``seq`` and ``model`` (innermost, so tensor-parallel peers are adjacent
ranks).

Where JAX runs on the first devices when the axes ask for fewer than
exist (its elastic resume), the port raises: every process of the group
must hold a place in the mesh.
"""

import math
import os
from typing import Dict, NamedTuple, Optional, Tuple

from deepspeed_tpu_torch.parallel.topology import ProcessTopology

__all__ = ["CANONICAL_AXIS_ORDER", "DATA_SUB_AXES", "LocalMesh",
           "RowSlice", "data_axis_names", "data_axis_size",
           "split_data_axis", "resolve_axis_sizes", "natural_intra_size",
           "build_mesh", "mesh_from_topology", "data_sharding",
           "replicated", "axis_size", "single_device_mesh", "data_rank"]

CANONICAL_AXIS_ORDER = ("pipe", "data", "data_inter", "data_intra",
                        "expert", "seq", "model")

# the hierarchical split of the data axis, major (slow wire) first
DATA_SUB_AXES = ("data_inter", "data_intra")


class LocalMesh(NamedTuple):
    """The mesh of a single process with no process group: the axis names
    and sizes of a ``DeviceMesh`` (every size 1) and nothing to talk to."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_type: str = "cpu"

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0


class RowSlice(NamedTuple):
    """The rows of a global batch this rank takes: block ``index`` of
    ``count`` equal blocks along the leading dim (the device's part of
    JAX's ``NamedSharding(mesh, PartitionSpec("data"))``)."""
    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"into {self.count} equal parts")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def take(self, batch):
        """``batch`` (a dict / list / tuple tree of arrays or tensors)
        with every leaf cut to this rank's rows; 0-d leaves stay."""
        from deepspeed_tpu_torch.utils.tree import tree_map
        if self.count == 1:
            return batch
        return tree_map(lambda x: x[self.rows(x.shape[0])]
                        if getattr(x, "ndim", 0) else x, batch)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axis_names(mesh):
    """The mesh's data-parallel axis names, major->minor: ``("data",)``,
    ``("data_inter", "data_intra")`` for a hierarchical mesh, or ``()``
    when no data axis exists."""
    names = tuple(mesh.mesh_dim_names)
    if "data" in names:
        return ("data",)
    present = tuple(a for a in DATA_SUB_AXES if a in names)
    if present and len(present) != 2:
        raise ValueError(
            f"hierarchical data mesh needs both of {DATA_SUB_AXES}, "
            f"got axes {names}")
    return present


def data_axis_size(mesh) -> int:
    """Total data-parallel degree (product over the data axes), 1 if none."""
    sizes = _sizes(mesh)
    size = 1
    for a in data_axis_names(mesh):
        size *= sizes[a]
    return size


def data_rank(mesh) -> int:
    """This process's coordinate along the data axes (their product,
    major first): which block of a global batch's rows it takes."""
    sizes = _sizes(mesh)
    idx = 0
    for a in data_axis_names(mesh):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def split_data_axis(axes: Dict[str, int], intra: int) -> Dict[str, int]:
    """Rewrite a ``{'data': W, ...}`` axes dict into the hierarchical form
    ``{'data_inter': W // intra, 'data_intra': intra, ...}``, with
    ``data_intra`` minor so its peers are adjacent ranks."""
    axes = dict(axes)
    if intra < 2:
        raise ValueError(f"hierarchical intra size must be >= 2, got {intra}")
    if "data" not in axes:
        if all(a in axes for a in DATA_SUB_AXES):
            # already split explicitly in mesh.axes: it must agree with
            # the requested intra size
            if axes["data_intra"] != intra:
                raise ValueError(
                    f"mesh.axes gives data_intra={axes['data_intra']} but "
                    f"quantized_comm.hierarchical={intra}; make them "
                    "match (or drop one)")
            return axes
        raise ValueError(
            f"cannot split: no 'data' axis in {axes}")
    W = axes.pop("data")
    if W == -1 or W % intra != 0:
        raise ValueError(
            f"data axis size {W} is not divisible by hierarchical intra "
            f"size {intra} (set mesh.axes.data explicitly)")
    axes["data_inter"] = W // intra
    axes["data_intra"] = intra
    return axes


def _order_axes(axes: Dict[str, int]) -> Dict[str, int]:
    """Order axes canonically (major → minor); unknown axes go last."""
    ordered = {}
    for name in CANONICAL_AXIS_ORDER:
        if name in axes:
            ordered[name] = axes[name]
    for name, size in axes.items():
        if name not in ordered:
            ordered[name] = size
    return ordered


def resolve_axis_sizes(axes: Optional[Dict[str, int]],
                       n_devices: int) -> Dict[str, int]:
    """Concrete axis sizes for an axes dict that may carry one ``-1``
    (inferred), ordered canonically: what :func:`build_mesh` applies."""
    if not axes:
        return {"data": n_devices}
    axes = _order_axes(dict(axes))
    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {axes}")
    if unknown:
        known = math.prod(v for v in axes.values() if v != -1)
        if n_devices % known != 0:
            raise ValueError(
                f"cannot infer axis {unknown[0]}: {n_devices} devices not "
                f"divisible by {known}")
        axes[unknown[0]] = n_devices // known
    return axes


def _world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def natural_intra_size() -> int:
    """Devices per host (``LOCAL_WORLD_SIZE``, which the launcher sets; one
    process per device), the intra-host hint of a hierarchical split: 0
    when the group spans one host, or hosts have fewer than 2 devices."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    world = _world()
    if local < 2 or world <= local or world % local:
        return 0
    return local


def build_mesh(axes: Optional[Dict[str, int]] = None,
               device_type: Optional[str] = None):
    """A named-axis mesh over the process group: ``axes`` maps axis name
    -> size, at most one size -1 (inferred); default every process on
    ``data``. The sizes must multiply to the group's size (1 without a
    group, which gives a :class:`LocalMesh`). ``device_type`` defaults to
    ``cuda`` when a card is present."""
    import torch
    import torch.distributed as dist
    n = _world()
    axes = resolve_axis_sizes(axes, n)
    size = math.prod(axes.values())
    if size != n:
        raise ValueError(
            f"mesh axes {axes} require {size} devices but the process "
            f"group has {n}: the port runs one process per device and "
            "every process must hold a place in the mesh")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    names, dims = tuple(axes), tuple(axes.values())
    if not (dist.is_available() and dist.is_initialized()):
        return LocalMesh(names, dims, device_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, dims, mesh_dim_names=names)


def mesh_from_topology(topo: ProcessTopology, device_type=None):
    """Mesh whose named axes mirror a ProcessTopology's axes/dims."""
    return build_mesh(dict(zip(topo.axes, topo.dims)),
                      device_type=device_type)


def data_sharding(mesh, batch_axis: str = "data") -> RowSlice:
    """The rows of a global batch this rank takes: its block along
    ``batch_axis`` (both data sub-axes on a hierarchical mesh); all rows
    when the mesh lacks the axis."""
    if batch_axis == "data" and batch_axis not in mesh.mesh_dim_names:
        if data_axis_names(mesh):
            return RowSlice(data_rank(mesh), data_axis_size(mesh))
    if batch_axis not in mesh.mesh_dim_names:
        return replicated(mesh)
    return RowSlice(mesh.get_local_rank(batch_axis),
                    _sizes(mesh)[batch_axis])


def replicated(mesh) -> RowSlice:
    """Every row of a global batch."""
    del mesh
    return RowSlice(0, 1)


def axis_size(mesh, name: str) -> int:
    """Size of a mesh axis, 1 if absent."""
    return _sizes(mesh).get(name, 1)


def single_device_mesh(device_type: str = "cpu") -> LocalMesh:
    """1-device mesh with the canonical axes, for tests and one card."""
    return LocalMesh(("pipe", "data", "model"), (1, 1, 1), device_type)
