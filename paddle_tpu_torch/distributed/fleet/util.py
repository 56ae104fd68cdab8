"""fleet.util — ``UtilBase``, counterpart of
``paddle_tpu/distributed/fleet/util.py`` (the reference's
fleet/base/util_factory.py).

Cross-trainer utilities for training scripts: numeric ``all_reduce`` /
``all_gather`` over the worker world, a ``barrier``, deterministic file
sharding and rank-gated printing.  A worker is a trainer process: with
a role maker its ``worker_num`` / ``worker_index`` set the world, else
``torch.distributed``'s default process group does (one rank when none
is initialized).  Where the JAX package gathers through
``multihost_utils`` (util.py:62-71), the collectives here run over the
default process group — a gloo group gathers the host tensors, an NCCL
one (a card a rank, ``env.placement``) the same values staged on the
rank's card — and with one rank every op is the identity.  Imports no
torch at module level.
"""
from __future__ import annotations

import numpy as np

__all__ = ["UtilBase"]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class UtilBase:
    def __init__(self, role_maker=None):
        self._role = role_maker

    # -- world shape ---------------------------------------------------------
    def _world(self) -> int:
        if self._role is not None:
            return int(self._role.worker_num())
        dist = _dist()
        return dist.get_world_size() if dist is not None else 1

    def _rank(self) -> int:
        if self._role is not None:
            return int(self._role.worker_index())
        dist = _dist()
        return dist.get_rank() if dist is not None else 0

    # -- collectives ---------------------------------------------------------
    def all_reduce(self, input, mode: str = "sum", comm_world="worker"):
        """Reduce a host numpy value across the worker processes."""
        arr = np.asarray(input)
        if mode not in ("sum", "max", "min"):
            raise ValueError(f"all_reduce mode must be sum/max/min, "
                             f"got {mode!r}")
        if self._world() <= 1:
            return arr
        g = self._process_allgather(arr)
        return {"sum": g.sum, "max": g.max, "min": g.min}[mode](axis=0)

    def all_gather(self, input, comm_world="worker"):
        """Gather one scalar/array per worker process; returns a list."""
        if self._world() <= 1:
            return [np.asarray(input)]
        return list(self._process_allgather(np.asarray(input)))

    def barrier(self, comm_world="worker"):
        if self._world() <= 1:
            return
        self._require_group().barrier()

    def _require_group(self):
        dist = _dist()
        if dist is None or dist.get_world_size() != self._world():
            raise RuntimeError(
                f"UtilBase: a world of {self._world()} workers needs "
                f"torch.distributed's default process group of that size "
                f"(env.init_process)")
        return dist

    def _process_allgather(self, arr: np.ndarray) -> np.ndarray:
        """Every worker's ``arr`` stacked along a new dim 0 in rank order
        (each the same shape and dtype): host tensors over gloo, staged
        on the rank's current card over NCCL (which takes no host
        tensor)."""
        import torch

        dist = self._require_group()
        t = torch.from_numpy(np.array(arr, order="C"))   # 0-d stays 0-d
        if dist.get_backend() == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(outs, t)
        return np.stack([o.cpu().numpy() for o in outs])

    # -- host-side helpers ---------------------------------------------------
    def get_file_shard(self, files):
        """This rank's slice of ``files`` — contiguous blocks, remainder
        spread over the first ranks (reference get_file_shard contract:
        every file assigned exactly once, sizes differ by at most one)."""
        if not isinstance(files, (list, tuple)):
            raise TypeError("files must be a list of paths")
        n, w, r = len(files), self._world(), self._rank()
        base, rem = divmod(n, w)
        start = r * base + min(r, rem)
        return list(files[start:start + base + (1 if r < rem else 0)])

    def print_on_rank(self, message, rank_id: int = 0):
        if self._rank() == int(rank_id):
            print(message, flush=True)
