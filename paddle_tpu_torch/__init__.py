"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, laid out module for module like it
(``paddle_tpu_torch/text/gpt.py`` is the counterpart of
``paddle_tpu/text/gpt.py``).  It needs only torch and numpy at run time.
Every Pallas kernel on a ported path is a CUDA kernel written by hand for
Hopper (``csrc/``), built at first use by ``ops/_build.py``; each sits
beside a plain PyTorch twin that computes the same function and serves
tensors that lie on the CPU.

Entry points (``text.gpt.init_params``, ``text.generate.generate``,
``text.serving.DecodeServer``) run on the card unless the caller passes
``device="cpu"``; asking for the default on a machine without a card
raises instead of falling back.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, else what
    the caller names.  Raises when the answer is a card this machine does
    not have — the port never moves work to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch paths on the CPU")
        if dev.index is None:      # name the card, as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
