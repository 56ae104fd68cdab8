"""Start ranks as processes — counterpart of
``paddle_tpu/distributed/spawn.py`` (:16).

``spawn(fn, args, nprocs)`` runs ``fn(*args)`` in ``nprocs`` new
processes, each a rank of one process group, and returns their return
values in rank order.  The start method is "spawn": a forked child of a
process that has loaded JAX or CUDA is unsafe.  The rendezvous is a
``file://`` store in a fresh temporary directory, so that concurrent
callers (pytest-xdist workers) never race for a port; the return values
come back through pickles in the same directory.  On the CPU each rank
runs one intra-op thread (``torch.set_num_threads(1)``).  A rank that
raises fails the call with its traceback, and its peers are stopped.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, Sequence


def _worker(rank, world, init_method, out_dir, fn, args, device, timeout_s):
    import torch

    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    os.environ["PADDLE_TPU_INIT_METHOD"] = init_method
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    from . import env

    env.init_process(rank, world, init_method, device, timeout_s)
    try:
        out = fn(*args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(func: Callable, args: Sequence = (), nprocs: int = 1,
          device=None, timeout_s: float = 600) -> list:
    """Run ``func(*args)`` on ``nprocs`` ranks; see the module docstring.
    ``device``: "cpu" for CPU ranks, None for the card placement
    (``env.placement``).  ``timeout_s`` bounds every collective."""
    import torch.multiprocessing as tmp

    with tempfile.TemporaryDirectory(prefix="ranks_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        tmp.start_processes(_worker, args=(nprocs, init, d, func,
                                           tuple(args), device, timeout_s),
                            nprocs=nprocs, join=True, start_method="spawn")
        outs = []
        for r in range(nprocs):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return outs
