"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
