"""The GPT train step on one card.

Counterpart of ``paddle_tpu/text/gpt_hybrid.py``'s
``build_gpt_train_step`` (gpt_hybrid.py:551-766) on its pure path (one
device: no dp/mp/pp/sp mesh, no ZeRO), with the same contract:
``step_fn(state, tokens, key, lr) -> (state, loss)``.

Parameters are fp32 masters (``gpt.init_master_params``), cast to
``cfg.dtype`` at each use inside the forward.  Gradients come from
PyTorch's autograd through the hand-written kernels' backward functions
(flash attention; the fused loss head under ``PADDLE_TPU_FUSED_CE=1``).
``accum > 1`` follows the JAX step exactly: the batch is cut into
``accum`` micro-batches, whose gradients accumulate in a **bf16** carry as
``carry + (g * (1/accum)).to(bf16)`` and whose losses sum as
``l * (1/accum)``; the optimizer receives the bf16 grads.  (A trajectory
accumulated in fp32 would not match the JAX one.)  The carry is updated
in place, which saves a copy of the gradient tree per micro-batch.
Each micro-batch draws its dropout and an MoE model's router noise under
its own key (``rng.fold_in(key, i)``, where the JAX step splits its key
over the micro-batches).  An MoE tree's expert leaves (``blocks["moe"]``,
``router_w`` float32) take the same bf16 carry and the same update; the
aux loss is part of ``gpt.loss_fn``'s value.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import resolve_device, rng
from . import gpt


class GPTTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: Any


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _build(pairs):
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def value_and_grad(loss, params, *args):
    """(loss(params', *args) detached, grads tree) where params' are the
    leaves of ``params`` as fresh autograd leaves (the masters themselves
    are not touched)."""
    pairs = list(_leaves(params))
    leaves = [t.detach().requires_grad_(True) for _, t in pairs]
    value = loss(_build((p, t) for (p, _), t in zip(pairs, leaves)), *args)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), _build((p, g) for (p, _), g in zip(pairs, grads))


def build_gpt_train_step(cfg: gpt.GPTConfig, optimizer, accum: int = 1,
                         device=None):
    """One-card GPT train step.  Returns (init_fn, step_fn, meta):

    * ``init_fn(seed=0) -> GPTTrainState``: fp32 master params drawn from
      ``seed`` on the device, the optimizer's initial state, step 0;
    * ``step_fn(state, tokens, key, lr) -> (state, loss)``: tokens
      [B, T + 1] (tensor or array; B divisible by ``accum``), ``key``
      the dropout and router-noise key (an int or an int64 tensor on the
      device, ``rng.py``; None: neither), ``lr`` a number, or None for the
      optimizer's own (its scheduler's current value); the loss a 0-d
      fp32 tensor on the device (no host sync);
    * ``meta``: the axis sizes (all 1 here), ``accum`` and the device.

    Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if accum < 1:
        raise ValueError(f"accum {accum} must be >= 1")

    def init_fn(seed: int = 0) -> GPTTrainState:
        params = gpt.init_master_params(cfg, seed, dev)
        return GPTTrainState(params, optimizer.init_state(params),
                             torch.zeros((), dtype=torch.int32, device=dev))

    def loss_fn(params, tokens, key):
        return gpt.loss_fn(params, tokens, cfg, key=key)

    def step_fn(state: GPTTrainState, tokens, key, lr):
        tokens = torch.as_tensor(tokens, device=dev).long()
        if accum > 1:
            B = tokens.shape[0]
            if B % accum:
                raise ValueError(
                    f"batch size {B} must divide by accum {accum}")
            micro = tokens.reshape((accum, B // accum) + tokens.shape[1:])
            inv = 1.0 / accum
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {path: torch.zeros_like(t, dtype=torch.bfloat16)
                     for path, t in _leaves(state.params)}
            for i, t in enumerate(micro):
                k = None if key is None else rng.fold_in(key, i)
                l, g = value_and_grad(loss_fn, state.params, t, k)
                for path, gl in _leaves(g):
                    grads[path].add_((gl * inv).to(torch.bfloat16))
                del g
                loss = loss + l * inv
            grads = _build(grads.items())
        else:
            loss, grads = value_and_grad(loss_fn, state.params, tokens, key)
        step = state.step + 1
        new_p, new_o = optimizer.apply_gradients(
            grads, state.params, state.opt_state, lr=lr, step=step)
        return GPTTrainState(new_p, new_o, step), loss

    meta = dict(dp=1, pp=1, mp=1, sp=1, n_micro=1, accum=accum, device=dev)
    return init_fn, step_fn, meta
