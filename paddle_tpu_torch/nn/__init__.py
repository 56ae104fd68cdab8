"""The port's slice of ``paddle_tpu/nn``: gradient clipping."""
from .clip import (  # noqa: F401
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
