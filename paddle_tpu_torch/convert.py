"""Carry a JAX-package GPT across: its parameter tree, its config and its
optimizer state.

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
               "max_seq_len", "ffn_ratio", "dropout", "remat", "remat_policy",
               "use_flash", "num_kv_heads", "pos_embed", "norm", "activation")


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
    (compute dtype mapped by name; ``use_flash`` is carried as it is;
    ``GPTConfig`` validates ``remat_policy``).  MoE configs raise (not
    ported yet)."""
    if getattr(jcfg, "moe", None) is not None:
        raise NotImplementedError("MoE configs are not ported yet")
    kw = {f: getattr(jcfg, f) for f in _CFG_FIELDS}
    kw["dtype"] = _DTYPES[_dtype_name(jcfg.dtype)]
    return gpt.GPTConfig(**kw)


def opt_state_from_jax(tree, device="cpu"):
    """A JAX optimizer state (``init_state``'s tree: the parameter tree's
    dicts with a tuple of arrays at each leaf, as numpy arrays from
    ``jax.device_get`` — Adam's ``(m, v)``, Momentum's ``(v,)``,
    Adafactor's factored ``(rows, cols)`` or full ``(v,)`` plus its first
    moment, SGD's ``()``) -> the port's state tree on ``device``, shapes
    and dtypes kept.  With the step count carried beside it, a run
    resumes mid-trajectory in the port."""
    if isinstance(tree, dict):
        return {k: opt_state_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tensor(a, device) for a in tree)
    raise TypeError(f"unexpected optimizer-state leaf {type(tree).__name__}")
