"""LoRA fine-tuning for the GPT family (low-rank adapters).

Counterpart of ``paddle_tpu/text/lora.py``.  The adapters are ordinary
leaves of the parameter tree — ``<name>_lora_a`` [L, ..., in, r] and
``<name>_lora_b`` [L, ..., r, out] next to the frozen weight ``<name>`` in
``params["blocks"]`` — and every weight consumer resolves through
``woq.w``, which adds ``a @ b`` after (de)quantization.  One mechanism
therefore covers LoRA over a float base, QLoRA over an int8/int4 base
(``woq.quantize_gpt_*``, adapters float32), and adapted decode without
merging (``generate`` and the forward read the same accessor).  The
served form — many adapters over one base, gathered per slot — is
``text/adapters.py``.

``b`` starts at zero, so an adapted model is the base model bit for bit
at step 0; the alpha/r scale is folded into ``a``'s init std.  ``a`` is
drawn from the port's counter-based ``rng.normal`` under the key (an int,
``rng.py``), not from ``jax.random``'s stream: carry JAX adapters across
with ``convert.params_from_jax`` where the same numbers are needed.

    params = lora_init(base_params, cfg, rank=8, key=0)
    init, step = build_lora_train_step(cfg, AdamW(learning_rate=1e-3))
    state = init(params)
    state, loss = step(state, tokens, lr)          # trains ONLY adapters
    adapted = join_lora(state.base, state.adapters)
    merged = merge_lora(adapted)                   # fold for deploy
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from . import gpt, woq
from .. import rng
from .gpt_hybrid import value_and_grad

__all__ = ["lora_init", "split_lora", "join_lora", "merge_lora",
           "stack_adapters", "unstack_adapters", "LoraTrainState",
           "build_lora_train_step"]

_SUFFIX_A, _SUFFIX_B = "_lora_a", "_lora_b"


def lora_init(params: dict, cfg: gpt.GPTConfig, rank: int = 8,
              key=None, alpha: float = 16.0,
              targets: tuple = ("qkv_w", "q_w", "kv_w", "proj_w")) -> dict:
    """Attach zero-``b`` adapters to the targeted block weights (the
    attention projections by default; add ``"fc_w"`` / ``"out_w"`` for
    the MLP), on a float or woq-quantized base (QLoRA).  ``a`` of target
    i is ``rng.normal(rng.fold_in(key, i), ...)`` times ``(alpha / rank)
    / sqrt(in)`` (kaiming scale times the conventional alpha/r), float32
    on the base's device; ``key`` defaults to ``rng.seed_key(0)``."""
    if key is None:
        key = rng.seed_key(0)
    out = dict(params)
    blocks = dict(params["blocks"])
    for i, name in enumerate(targets):
        base = blocks.get(name)
        if base is None:
            continue
        shp = woq.logical_shape(blocks, name)
        a = rng.normal(rng.fold_in(key, i), shp[:-1] + (rank,),
                       base.device) * ((alpha / rank) / math.sqrt(shp[-2]))
        blocks[name + _SUFFIX_A] = a
        blocks[name + _SUFFIX_B] = torch.zeros(
            shp[:-2] + (rank, shp[-1]), dtype=torch.float32,
            device=base.device)
    out["blocks"] = blocks
    return out


def split_lora(params: dict):
    """(frozen_base, adapters): adapters is the trainable sub-tree."""
    blocks = params["blocks"]
    ad = {k: v for k, v in blocks.items()
          if k.endswith(_SUFFIX_A) or k.endswith(_SUFFIX_B)}
    base_blocks = {k: v for k, v in blocks.items() if k not in ad}
    return dict(params, blocks=base_blocks), ad


def join_lora(base: dict, adapters: dict) -> dict:
    """Recombine a split state into one adapted param tree (the form
    every consumer — forward, generate, evaluation — takes)."""
    return dict(base, blocks=dict(base["blocks"], **adapters))


def stack_adapters(adapter_list: list) -> dict:
    """Stack N adapter sub-trees (``split_lora(tree)[1]`` dicts) into one
    tree of ``[N, ...]`` float32 leaves — the AdapterPool storage form.
    Every adapter must carry the same target set at the same rank (one
    gathered shape serves every slot)."""
    if not adapter_list:
        raise ValueError("stack_adapters: empty adapter list")
    ref = adapter_list[0]
    names = set(ref)
    ranks = {k: ref[k].shape[-1] for k in ref if k.endswith(_SUFFIX_A)}
    if not names or not ranks:
        raise ValueError(
            "stack_adapters: first entry has no lora leaves (pass "
            "split_lora(tree)[1] dicts)")
    for i, ad in enumerate(adapter_list[1:], start=1):
        if set(ad) != names:
            raise ValueError(
                f"stack_adapters: adapter {i} targets {sorted(set(ad))} "
                f"!= adapter 0 targets {sorted(names)} (same targets "
                f"across the pool)")
        for k, r in ranks.items():
            if ad[k].shape[-1] != r:
                raise ValueError(
                    f"stack_adapters: adapter {i} leaf {k} rank "
                    f"{ad[k].shape[-1]} != adapter 0 rank {r} (same rank "
                    f"across the pool)")
        for k in names:
            if tuple(ad[k].shape) != tuple(ref[k].shape):
                raise ValueError(
                    f"stack_adapters: adapter {i} leaf {k} shape "
                    f"{tuple(ad[k].shape)} != {tuple(ref[k].shape)}")
    return {k: torch.stack([torch.as_tensor(ad[k]).float()
                            for ad in adapter_list])
            for k in sorted(names)}


def unstack_adapters(stacked: dict) -> list:
    """Inverse of :func:`stack_adapters`: ``[N, ...]`` leaves back to N
    per-adapter sub-trees."""
    if not stacked:
        raise ValueError("unstack_adapters: empty tree")
    ns = {v.shape[0] for v in stacked.values()}
    if len(ns) != 1:
        raise ValueError(
            f"unstack_adapters: inconsistent leading axes {sorted(ns)}")
    (n,) = ns
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def merge_lora(params: dict) -> dict:
    """Fold the adapters into the base weights (the deploy artifact):
    ``(base + a @ b)`` in float32, cast back to the base's dtype.  Float
    bases only — merging into an int8/int4 base would re-quantize and
    change the model."""
    blocks = dict(params["blocks"])
    names = [k[: -len(_SUFFIX_A)] for k in blocks if k.endswith(_SUFFIX_A)]
    for name in names:
        base = blocks[name]
        if base.dtype == torch.int8:
            raise NotImplementedError(
                "merge_lora on a quantized base: dequantize first (the "
                "merge would re-quantize and change the model)")
        delta = blocks.pop(name + _SUFFIX_A).float() \
            @ blocks.pop(name + _SUFFIX_B).float()
        blocks[name] = (base.float() + delta).to(base.dtype)
    return dict(params, blocks=blocks)


@dataclasses.dataclass
class LoraTrainState:
    base: Any          # frozen (possibly quantized) weights
    adapters: Any      # trainable low-rank leaves
    opt_state: Any
    step: Any


def build_lora_train_step(cfg: gpt.GPTConfig, optimizer):
    """One-card LoRA train step: the loss, its gradients and the update
    over ONLY the adapter leaves.  Returns (init, step):

    * ``init(params_with_lora) -> LoraTrainState``: the split tree, the
      optimizer's state of the adapters, step 0 (an int32 tensor on the
      base's device);
    * ``step(state, tokens, lr) -> (state, loss)``: tokens [B, T + 1]
      (a tensor or an array), the loss a 0-d float32 tensor.

    Autograd runs over fresh leaves of the adapters alone; the frozen
    base is read in place and never copied or written (the JAX step
    donates its state so XLA aliases the base through — the tensors
    simply stay where they are here).  ``PADDLE_TPU_FUSED_CE=1`` and
    ``PADDLE_TPU_FUSED_LN=1`` pick the loss head and norms as for the
    full train step."""

    def init(params_with_lora) -> LoraTrainState:
        base, adapters = split_lora(params_with_lora)
        if not adapters:
            raise ValueError("build_lora_train_step: the tree carries no "
                             "lora leaves (lora_init first)")
        dev = next(iter(adapters.values())).device
        return LoraTrainState(base=base, adapters=adapters,
                              opt_state=optimizer.init_state(adapters),
                              step=torch.zeros((), dtype=torch.int32,
                                               device=dev))

    def loss_of(adapters, base, tokens):
        return gpt.loss_fn(join_lora(base, adapters), tokens, cfg)

    def step(state: LoraTrainState, tokens, lr):
        dev = state.step.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        loss, grads = value_and_grad(loss_of, state.adapters, state.base,
                                     tokens)
        n = state.step + 1
        adapters, opt_state = optimizer.apply_gradients(
            grads, state.adapters, state.opt_state, lr=lr, step=n)
        return LoraTrainState(base=state.base, adapters=adapters,
                              opt_state=opt_state, step=n), loss

    return init, step
