"""Named-axis process topology: the rank math of N-D parallelism (the
port of ``deepspeed_tpu/parallel/topology.py``, copied).

The reference built NCCL process groups from these coordinate lists; the
port answers the same host-side questions (checkpoint naming, stage
adjacency, the ranks of a group) and names the axes of its
``DeviceMesh`` after them (``parallel/mesh.py``). The layout is
row-major: the last axis varies fastest with rank.
"""

from collections import namedtuple
from typing import List, Optional, Sequence


class ProcessTopology:
    """Maps ranks <-> coordinates on a named-axis cartesian grid.

    Axes are ordered major-to-minor: the LAST axis varies fastest with rank
    (row-major), matching the reference's convention where e.g. with axes
    ['x','y'] rank 1 is (x=0, y=1).
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axis names in {axes}")
        for d in dims:
            if d < 1:
                raise ValueError(f"axis dims must be >= 1, got {dims}")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        # row-major strides: stride of axis i = product of dims after i
        self._strides = []
        s = 1
        for d in reversed(self.dims):
            self._strides.append(s)
            s *= d
        self._strides.reverse()
        self._world_size = s

    def world_size(self) -> int:
        return self._world_size

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_rank(self, **coords) -> int:
        """Rank of the process at the given full coordinate."""
        if sorted(coords.keys()) != sorted(self.axes):
            raise ValueError(
                f"get_rank() requires all axes {self.axes}, got "
                f"{list(coords)}")
        rank = 0
        for ax, stride, dim in zip(self.axes, self._strides, self.dims):
            c = coords[ax]
            if not 0 <= c < dim:
                raise ValueError(f"coord {ax}={c} out of range [0,{dim})")
            rank += c * stride
        return rank

    def get_coord(self, rank: int):
        """Coordinate namedtuple of ``rank``."""
        if not 0 <= rank < self._world_size:
            raise ValueError(
                f"rank {rank} out of range [0,{self._world_size})")
        coords = {}
        for ax, stride, dim in zip(self.axes, self._strides, self.dims):
            coords[ax] = (rank // stride) % dim
        return self.ProcessCoord(**coords)

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_",
                      outer_sep="-") -> str:
        """String like 'pipe_0-model_1' used in checkpoint filenames
        (reference topology.py:88: omits data axis since DP ranks share
        weights)."""
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        coord = self.get_coord(rank)
        for ax in axes:
            names.append(f"{ax}{inner_sep}{getattr(coord, ax)}")
        return outer_sep.join(names)

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        """All ranks whose coordinate along ``axis`` equals ``idx``."""
        return [r for r in range(self._world_size)
                if getattr(self.get_coord(r), axis) == idx]

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that differ only along ``axis`` — exactly the
        process groups the reference built for NCCL (topology.py:131); here
        they seed host-side group logic and tests."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        seen = set()
        for rank in range(self._world_size):
            coord = self.get_coord(rank)
            key = tuple(getattr(coord, a) for a in other_axes)
            if key in seen:
                continue
            seen.add(key)
            group = [r for r in range(self._world_size)
                     if all(getattr(self.get_coord(r), a) == k
                            for a, k in zip(other_axes, key))]
            lists.append(group)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match all given axis=value filters
        (reference topology.py:171)."""
        def matches(rank):
            coord = self.get_coord(rank)
            return all(getattr(coord, ax) == v
                       for ax, v in filter_kwargs.items())
        return [r for r in range(self._world_size) if matches(r)]

    def split_axis(self, axis: str, outer_name: str, inner_name: str,
                   inner_size: int) -> "ProcessTopology":
        """New topology with ``axis`` (size W) split into
        ``outer_name`` (W // inner_size, major) x ``inner_name``
        (inner_size, minor), preserving every rank's position.

        Because the layout is row-major, splitting an axis in place keeps
        rank <-> coordinate assignments consistent: a rank's old ``axis``
        coordinate c becomes (outer=c // inner_size, inner=c %
        inner_size). This is the host-side mirror of
        ``parallel.mesh.split_data_axis`` (hierarchical ZeRO++-style
        collectives put the bandwidth-heavy hop on the minor/inner axis,
        whose peers are rank-adjacent: on one host, NVLink peers).
        """
        if axis not in self.axes:
            raise ValueError(f"no axis {axis!r} in {self.axes}")
        W = self.dims[self.axes.index(axis)]
        if inner_size < 1 or W % inner_size != 0:
            raise ValueError(
                f"axis {axis!r} size {W} not divisible by {inner_size}")
        if outer_name in self.axes or inner_name in self.axes:
            raise ValueError(
                f"split names {outer_name!r}/{inner_name!r} collide with "
                f"existing axes {self.axes}")
        axes, dims = [], []
        for a, d in zip(self.axes, self.dims):
            if a == axis:
                axes += [outer_name, inner_name]
                dims += [W // inner_size, inner_size]
            else:
                axes.append(a)
                dims.append(d)
        return ProcessTopology(axes, dims)

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """2D pipe × data grid (reference topology.py:235). ZeRO-style DP shards
    within a pipeline stage."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3D pipe × data × model hybrid grid (reference topology.py:246).

    'model' is the minor axis so tensor-parallel peers are adjacent ranks,
    on one host's NVLink, where the per-layer all-reduces are cheapest.
    """

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class ParallelGrid:
    """The MPU ("model parallel unit") facade over a topology.

    Implements the mpu protocol the reference engine consumes
    (topology.py:405-455: get_{data,model,pipe,slice}_parallel_{rank,
    world_size,group}) so client code written against Megatron-style mpu
    objects ports over. "Groups" are returned as axis *names*, as the JAX
    package returns them: the names of the port's ``DeviceMesh`` dims
    (``mesh.get_group(name)`` gives the process group). The default
    topology puts every rank of the process group on ``data``.
    """

    def __init__(self, topology: Optional[ProcessTopology] = None,
                 process_index: Optional[int] = None):
        import torch.distributed as dist

        joined = dist.is_available() and dist.is_initialized()
        if topology is None:
            world = dist.get_world_size() if joined else 1
            topology = PipeDataParallelTopology(1, world)
        self._topo = topology
        if process_index is not None:
            self.global_rank = process_index
        else:
            # one process per device: this process's rank in the group
            self.global_rank = dist.get_rank() if joined else 0
        self.world_size = topology.world_size()

        self.data_parallel_size = max(1, topology.get_dim("data"))
        self.pipe_parallel_size = max(1, topology.get_dim("pipe"))
        self.model_parallel_size = max(1, topology.get_dim("model"))

    # -- coordinate lookups (one process per device) --
    def _coord_axis(self, axis: str, default: int = 0) -> int:
        if self._topo.get_dim(axis) == 0:
            return default
        return getattr(self._topo.get_coord(self.global_rank), axis)

    def get_global_rank(self) -> int:
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self) -> int:
        return self._coord_axis("data")

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_data_parallel_group(self) -> str:
        return "data"

    # model (tensor) parallel
    def get_model_parallel_rank(self) -> int:
        return self._coord_axis("model")

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def get_model_parallel_group(self) -> str:
        return "model"

    # alias used by some clients for tensor-slicing groups
    get_slice_parallel_rank = get_model_parallel_rank
    get_slice_parallel_world_size = get_model_parallel_world_size
    get_slice_parallel_group = get_model_parallel_group

    # pipeline parallel
    def get_pipe_parallel_rank(self) -> int:
        return self._coord_axis("pipe")

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self) -> str:
        return "pipe"

    def get_stage_id(self) -> int:
        return self.get_pipe_parallel_rank()

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id: int, **kwargs) -> int:
        """Global rank of the same (data, model) coordinate at another
        pipeline stage (reference topology.py:391)."""
        me = self._topo.get_coord(self.global_rank)._asdict()
        me.update(kwargs)
        me["pipe"] = stage_id
        return self._topo.get_rank(**me)

    def p2p_pairs(self) -> List[List[int]]:
        """Adjacent-stage rank pairs, incl. wraparound (reference
        topology.py:372 _build_p2p_groups); deduped, no self-pairs."""
        if self.pipe_parallel_size < 2:
            return []
        pairs = set()
        for rank in range(self.world_size):
            coord = self._topo.get_coord(rank)
            nxt = dict(coord._asdict())
            nxt["pipe"] = (coord.pipe + 1) % self.pipe_parallel_size
            other = self._topo.get_rank(**nxt)
            if other != rank:
                pairs.add(tuple(sorted((rank, other))))
        return [list(p) for p in sorted(pairs)]

    @property
    def topology(self) -> ProcessTopology:
        return self._topo
