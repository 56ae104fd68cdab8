"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``):
objects an optimizer's ``weight_decay=`` takes, folded into its update."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
