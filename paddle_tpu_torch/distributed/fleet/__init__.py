"""The fleet's pieces in the port — counterpart of
``paddle_tpu/distributed/fleet``: ``base`` (``zero_shard_spec``),
``strategy`` (``DistributedStrategy``), ``metrics``, ``util``
(``UtilBase``), ``utils`` (``LocalFS``), ``data_generator``, ``dataset``
(``InMemoryDataset`` / ``QueueDataset``) and ``comm_opt`` (DGC,
LocalSGD).  Each is a submodule loaded at first use, so that importing
the package loads no torch.  ``Fleet``, ``ShardedTrainStep`` and the
strategy compiler need the Paddle-compat surface and are not ported.
"""
import importlib

__all__ = ["base", "comm_opt", "data_generator", "dataset", "metrics",
           "strategy", "util", "utils"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
