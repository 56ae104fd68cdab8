"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD, Adadelta, Adafactor, Adagrad, Adam, Adamax, AdamW, L1Decay, L2Decay,
    Lamb, Lars, Momentum, Optimizer, RMSProp,
)

__all__ = ["SGD", "Adadelta", "Adafactor", "Adagrad", "Adam", "Adamax",
           "AdamW", "L1Decay", "L2Decay", "Lamb", "Lars", "Momentum",
           "Optimizer", "RMSProp", "lr"]
