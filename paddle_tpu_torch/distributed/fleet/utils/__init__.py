"""fleet.utils — the filesystem abstraction (counterpart of
``paddle_tpu/distributed/fleet/utils``)."""
from .fs import FS, HDFSClient, LocalFS  # noqa: F401

__all__ = ["FS", "LocalFS", "HDFSClient"]
