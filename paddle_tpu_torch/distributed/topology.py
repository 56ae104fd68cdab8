"""Rank layout and process groups.

Counterpart of ``paddle_tpu/distributed/topology.py``
(``CommunicateTopology`` :34, ``HybridCommunicateGroup`` :81).  There a
"group" is a named axis of one device mesh that XLA lowers collectives
over; here every rank is a process, and a group is a
``torch.distributed`` process group over the ranks that differ only
along some axes.

:class:`Mesh` lays ranks out row-major over its named axes in the order
given — ``Mesh({"dp": 2, "pp": 2, "mp": 2})`` puts rank r where the JAX
tests' ``mesh_of((2, 2, 2), ("dp", "pp", "mp"))`` puts device r — and
holds one process group for every slice of every non-empty set of its
axes whose size is above 1.  ``torch.distributed.new_group`` is
collective, so :meth:`Mesh.build_groups` creates every group on every
rank in one fixed order, members or not.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

def axes_of(entry) -> tuple:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class CommunicateTopology:
    """Rank <-> coordinate over named dims, row-major (the reference's
    topology.py:36)."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = list(itertools.product(*[range(d)
                                                   for d in self._dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return math.prod(self._dims)

    def get_rank(self, **kwargs):
        return self._coord2rank[tuple(kwargs[n]
                                      for n in self._parallel_names)]

    def get_coord(self, rank):
        return self.coordinate[rank]

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on ``axis_name`` is ``index``."""
        ax = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self.coordinate) if c[ax] == index]

    def get_comm_list(self, axis_name):
        """The groups of ranks that differ only along ``axis_name``."""
        return self.get_comm_lists((axis_name,))

    def get_comm_lists(self, axes):
        """The groups of ranks that differ only along ``axes``, each
        listed row-major over the mesh's own axis order."""
        idx = [self._parallel_names.index(a) for a in axes]
        fixed = [i for i in range(len(self._dims)) if i not in idx]
        groups = {}
        for r, c in enumerate(self.coordinate):
            groups.setdefault(tuple(c[i] for i in fixed), []).append(r)
        return list(groups.values())


class Mesh:
    """Named axes over the ranks of one process group.

    ``shape`` is an ordered mapping {axis: size} (the layout order); the
    product of the sizes is the world size.  ``rank`` is this process's
    rank, ``device`` its ``torch.device``, ``backend`` "nccl" or "gloo",
    ``transport`` how collectives reach the device ("nccl"; "host" for
    CPU tensors over gloo; "staged" for CUDA tensors over gloo, through
    pinned host memory).  Groups exist after :meth:`build_groups`."""

    def __init__(self, shape, rank: int = 0, device=None,
                 backend: str = "gloo", transport: str = "host"):
        self.names = tuple(shape)
        self.dims = tuple(int(shape[n]) for n in self.names)
        self.shape = dict(zip(self.names, self.dims))
        self.topo = CommunicateTopology(self.names, self.dims)
        self.rank = int(rank)
        self.coords = dict(zip(self.names, self.topo.get_coord(self.rank)))
        self.device = device
        self.backend = backend
        self.transport = transport
        self._groups: dict = {}
        self.pinned: dict = {}      # staging buffers (collective.py)

    @property
    def world_size(self) -> int:
        return math.prod(self.dims)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name, a tuple, None);
        an axis the mesh lacks has size 1."""
        return math.prod(self.shape.get(a, 1) for a in axes_of(axes))

    def coord(self, axis) -> int:
        return self.coords.get(axis, 0)

    def index(self, axes) -> int:
        """This rank's index along ``axes`` taken as one dim, the first
        axis major (the JAX spec entry ``("mp", "dp")``'s order)."""
        i = 0
        for a in axes_of(axes):
            i = i * self.shape.get(a, 1) + self.coord(a)
        return i

    def active(self, axes) -> tuple:
        """The axes of ``axes`` that this mesh has with a size above 1,
        in the mesh's own order."""
        want = set(axes_of(axes))
        return tuple(a for a in self.names
                     if a in want and self.shape[a] > 1)

    def ranks(self, axes) -> list:
        """The global ranks of this rank's group along ``axes``."""
        act = self.active(axes)
        if not act:
            return [self.rank]
        for grp in self.topo.get_comm_lists(act):
            if self.rank in grp:
                return grp
        raise AssertionError("rank outside its own mesh")

    def peer(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along ``axis`` (wrapping)."""
        c = dict(self.coords)
        c[axis] = (c[axis] + offset) % self.shape[axis]
        return self.topo.get_rank(**c)

    def build_groups(self):
        """Create every group — each non-empty set of the axes above
        size 1, each of its slices — in one order on every rank."""
        import torch.distributed as dist

        act = [a for a in self.names if self.shape[a] > 1]
        for k in range(1, len(act) + 1):
            for axes in itertools.combinations(act, k):
                for grp in self.topo.get_comm_lists(axes):
                    pg = dist.new_group(grp)
                    if self.rank in grp:
                        self._groups[axes] = pg
        return self

    def group(self, axes):
        """The process group of this rank's slice along ``axes``, or None
        where that slice is this rank alone."""
        act = self.active(axes)
        if not act:
            return None
        try:
            return self._groups[act]
        except KeyError:
            raise RuntimeError(
                f"no process group for axes {act}: build_groups() has not "
                f"run on this mesh") from None

    @property
    def meta(self) -> dict:
        return {"shape": dict(self.shape), "rank": self.rank,
                "world_size": self.world_size, "backend": self.backend,
                "transport": self.transport, "device": str(self.device)}

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"{self.backend}, {self.transport})")


@dataclass
class CommGroup:
    """A communicator handle: the mesh axis, its ranks and the process
    group (None for a single rank)."""

    axis: str | None
    ranks: list
    group: object = None
    id: int = 0

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks


class HybridCommunicateGroup:
    """The reference's dp x pp x sharding x mp view of a :class:`Mesh`
    (topology.py:117)."""

    AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                "model": "mp"}

    def __init__(self, mesh: Mesh):
        self._mesh = mesh
        self.global_rank = mesh.rank
        self.nranks = mesh.world_size

    def _group(self, ref_name):
        ax = self.AXIS_MAP[ref_name]
        return CommGroup(ax, self._mesh.ranks(ax), self._mesh.group(ax))

    def get_data_parallel_world_size(self):
        return self._mesh.size("dp")

    def get_model_parallel_world_size(self):
        return self._mesh.size("mp")

    def get_pipe_parallel_world_size(self):
        return self._mesh.size("pp")

    def get_sharding_parallel_world_size(self):
        return self._mesh.size("sharding")

    def get_data_parallel_rank(self):
        return self._mesh.coord("dp")

    def get_model_parallel_rank(self):
        return self._mesh.coord("mp")

    def get_stage_id(self):
        return self._mesh.coord("pp")

    def get_sharding_parallel_rank(self):
        return self._mesh.coord("sharding")

    def get_data_parallel_group(self):
        return self._group("data")

    def get_model_parallel_group(self):
        return self._group("model")

    def get_pipe_parallel_group(self):
        return self._group("pipe")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_p2p_next_rank(self):
        return self._mesh.peer("pp", 1) if "pp" in self._mesh.shape \
            else self.global_rank

    def get_p2p_prev_rank(self):
        return self._mesh.peer("pp", -1) if "pp" in self._mesh.shape \
            else self.global_rank

    def topology(self):
        return self._mesh.topo
