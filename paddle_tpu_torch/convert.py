"""Carry a JAX-package GPT across: its parameter tree and its config.

The port imports nothing of JAX; callers hand over host values —
``jax.device_get(params)`` (a tree of numpy arrays) and the JAX
``GPTConfig`` object, read by attribute.  Names and the stacked
[L, ...] block layout are kept, so both packages compute the same
function on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .text import gpt

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "max_seq_len", "ffn_ratio", "num_kv_heads", "pos_embed",
               "norm", "activation")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: no torch.from_numpy path
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX GPT parameter tree of numpy arrays -> the same tree of torch
    tensors on ``device``, dtypes kept (bf16 leaves convert exactly).
    Dense models only: an MoE ``blocks["moe"]`` subtree raises."""
    if isinstance(tree.get("blocks", {}).get("moe"), dict):
        raise NotImplementedError("MoE parameter trees are not ported yet")
    out = {}
    for name, leaf in tree.items():
        if name == "blocks":
            out[name] = {k: _tensor(v, device) for k, v in leaf.items()}
        else:
            out[name] = _tensor(leaf, device)
    return out


def _dtype_name(d) -> str:
    return getattr(d, "__name__", None) or np.dtype(d).name


def config_from_jax(jcfg) -> gpt.GPTConfig:
    """The port's ``GPTConfig`` from a JAX ``GPTConfig``'s field values
    (compute dtype mapped by name).  MoE configs raise."""
    if getattr(jcfg, "moe", None) is not None:
        raise NotImplementedError("MoE configs are not ported yet")
    kw = {f: getattr(jcfg, f) for f in _CFG_FIELDS}
    kw["dtype"] = _DTYPES[_dtype_name(jcfg.dtype)]
    return gpt.GPTConfig(**kw)
