"""Data ingestion — the port's counterpart of ``paddle_tpu/io``'s native
half: ``native_reader`` (``BlockingBatchQueue``, ``TokenShardReader`` over
the C++ runtime ``csrc/host/io_runtime.cpp``, and ``DevicePrefetcher``).
The ``DataLoader`` half of the JAX package's ``io/__init__.py`` needs the
Paddle-compat surface and is not ported.  Importing this package loads no
torch: a data-generator or reader process starts without it.
"""
import importlib

__all__ = ["native_reader"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
