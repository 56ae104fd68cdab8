"""Activation-checkpointing policy names -> what the block wrapper runs.

Counterpart of ``paddle_tpu/ops/remat_policies.py``: the same names,
aliases and ``ValueError``, resolved to ``torch.utils.checkpoint`` terms
instead of ``jax.checkpoint`` policies.

Accepted names (aliases map to the same policy):
* ``None`` / ``"none"`` / ``"full"`` / ``"nothing_saveable"`` — save
  nothing: full recompute, maximum memory saving;
* ``"dots"`` / ``"dots_saveable"`` — keep matmul outputs, recompute only
  cheap elementwise ops (``jax.checkpoint_policies.checkpoint_dots``);
* ``"dots_no_batch"`` / ``"dots_with_no_batch_dims_saveable"`` — keep
  only non-batch matmul outputs (weights-stationary contractions);
* ``"everything"`` / ``"everything_saveable"`` — keep all residuals
  (the checkpoint becomes a no-op; useful for A/B isolation).

A selective policy names aten ops only.  The hand-written kernels are
launched through ctypes into a buffer from ``torch.empty``/``empty_like``,
so a policy sees the allocation and not the kernel that fills it: were
the allocation saved, the recompute's kernel would write into the
forward's output.  So the policies save matmul outputs and nothing else,
and ``"everything"`` bypasses the checkpoint instead of saving every op.
As under JAX's ``checkpoint_dots`` (a ``pallas_call`` is no
``dot_general``), the flash forward and the LayerNorm kernels run again
in the recompute.

The reference's ``PADDLE_TPU_REMAT_PREVENT_CSE`` is an XLA compile knob
(optimization barriers against common-subexpression elimination); eager
PyTorch eliminates nothing, so the port has no such flag.
"""
from __future__ import annotations

import functools

import torch

_ALIASES = {
    None: None, "none": None, "full": None, "nothing_saveable": None,
    "dots": "dots", "dots_saveable": "dots",
    "dots_no_batch": "dots_no_batch",
    "dots_with_no_batch_dims_saveable": "dots_no_batch",
    "everything": "everything", "everything_saveable": "everything",
}

# the matmul outputs each selective policy keeps: JAX's dots are every
# dot_general; "no batch" drops the batched products (bmm: the attention
# scores on the plain path and the stacked qkv projection)
_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def canonical(name: str | None) -> str | None:
    """Alias → canonical policy name (None / 'dots' / 'dots_no_batch' /
    'everything').  Estimators must key on THIS, not the raw string, or
    alias spellings silently desynchronize memory models from the
    program run."""
    if name not in _ALIASES:
        raise ValueError(
            f"unknown recompute/remat policy {name!r}; choose from "
            f"{sorted(k for k in _ALIASES if isinstance(k, str))} or None")
    return _ALIASES[name]


def resolve(name: str | None):
    """Policy name → the block wrapper: ``wrap(fn)`` returns ``fn`` run
    under a non-reentrant ``torch.utils.checkpoint`` (plain for full
    recompute, selective — keeping the policy's matmul outputs — for the
    dots policies), or ``fn`` itself for ``"everything"``.  The RNG state
    is not stashed: the port's draws are counter-based (``rng.py``)."""
    canon = canonical(name)
    if canon == "everything":
        return lambda fn: fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    kw = {}
    if canon is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_SAVED_OPS[canon]))
    return lambda fn: functools.partial(
        checkpoint, fn, use_reentrant=False, preserve_rng_state=False, **kw)
