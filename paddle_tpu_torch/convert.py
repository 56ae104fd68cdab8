"""Carry JAX-package state across: a GPT's parameter tree, its config and
its optimizer state; a device sparse table's state; a DGC state.

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
from .text.moe import MoEConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_CFG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "max_seq_len", "ffn_ratio", "dropout", "remat", "remat_policy",
               "use_flash", "num_kv_heads", "pos_embed", "norm", "activation",
               "sp_sub_block")
_MOE_FIELDS = ("num_experts", "capacity_factor", "router_noise",
               "aux_loss_weight", "top_k")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: no torch.from_numpy path
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX GPT parameter tree of numpy arrays -> the same tree of torch
    tensors on ``device``, nesting and dtypes kept (bf16 leaves convert
    exactly; an MoE ``blocks["moe"]`` subtree stays a dict, its float32
    ``router_w`` float32)."""
    return {name: (params_from_jax(leaf, device) if isinstance(leaf, dict)
                   else _tensor(leaf, device))
            for name, leaf in tree.items()}


def _dtype_name(d) -> str:
    return getattr(d, "__name__", None) or np.dtype(d).name


def config_from_jax(jcfg) -> gpt.GPTConfig:
    """The port's ``GPTConfig`` from a JAX ``GPTConfig``'s field values
    (compute dtype mapped by name; ``use_flash`` is carried as it is;
    ``GPTConfig`` validates ``remat_policy``; a ``MoEConfig`` mapped
    field by field)."""
    kw = {f: getattr(jcfg, f) for f in _CFG_FIELDS}
    kw["dtype"] = _DTYPES[_dtype_name(jcfg.dtype)]
    if getattr(jcfg, "moe", None) is not None:
        kw["moe"] = MoEConfig(**{f: getattr(jcfg.moe, f)
                                 for f in _MOE_FIELDS})
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


def table_state_from_jax(state, device="cpu"):
    """A JAX ``SparseTableState`` (``rows`` [rows_total, D] and ``accum``
    [rows_total], as numpy arrays from ``jax.device_get``, or a
    ``(rows, accum)`` pair) -> the port's ``distributed.ps.
    SparseTableState`` of float32 tensors on ``device``, the row layout
    kept (V + 1 rows padded to the JAX mesh's shard count; the rows past
    V are zero).  ``SparseEmbeddingTable.set_state`` takes it under any
    padding and keeps its own shard."""
    from .distributed.ps import SparseTableState

    rows, accum = ((state.rows, state.accum) if hasattr(state, "rows")
                   else state)
    return SparseTableState(
        torch.from_numpy(np.array(rows, np.float32)).to(device),
        torch.from_numpy(np.array(accum, np.float32)).to(device))


def dgc_state_from_jax(state, device="cpu"):
    """A JAX ``DGCState`` (``u`` and ``v``, trees of numpy arrays from
    ``jax.device_get``, or a ``(u, v)`` pair) -> the port's
    ``distributed.fleet.comm_opt.DGCState`` of float32 tensors on
    ``device``, the tree and each leaf's (stacked) shape kept — a run
    resumes its next ``dgc_compress`` round in the port."""
    from .distributed.fleet.comm_opt import DGCState

    u, v = (state.u, state.v) if hasattr(state, "u") else state

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(x) for k, x in tree.items()}
        return torch.from_numpy(np.array(tree, np.float32)).to(device)

    return DGCState(conv(u), conv(v))
