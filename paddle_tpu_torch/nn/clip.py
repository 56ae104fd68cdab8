"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip is a pure transform of a gradient tree — nested dicts of
tensors, ``None`` where a leaf has no gradient — as the JAX package's
``apply_pytree``; an optimizer given ``grad_clip=`` applies it first in
``apply_gradients``.  The eager ``__call__`` over Paddle (param, grad)
Tensor pairs belongs to the Paddle-compat surface and is not ported yet.
"""
from __future__ import annotations

import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError(
            "the eager (param, grad) clip surface is not ported; use "
            "apply_pytree on a gradient tree")

    def apply_pytree(self, grads, sum_squares=None):
        """grads: tree of tensors -> the clipped tree (pure).
        ``sum_squares`` (a norm clip's): what a step whose leaves are
        split across ranks passes to reduce the tree of per-leaf sums of
        squares to the whole tree's — each leaf summed over the ranks it
        is split across (``text/gpt_hybrid.py``)."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_pytree(self, grads, sum_squares=None):
        return _map(lambda g: torch.clamp(g, self.min, self.max), grads)


class ClipGradByNorm(ClipGradBase):
    """Each leaf scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        n = torch.sqrt(torch.sum(g.float() ** 2))
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(n, 1e-12),
                                1.0)
        return (g.float() * scale).to(g.dtype)

    def apply_pytree(self, grads, sum_squares=None):
        if sum_squares is not None:
            raise NotImplementedError(
                "ClipGradByNorm over leaves split across ranks is not "
                "ported yet (ROADMAP A2); use ClipGradByGlobalNorm")
        return _map(self._clip_one, grads)


class ClipGradByGlobalNorm(ClipGradBase):
    """Every leaf scaled by one factor, so that the norm of all the
    gradients together is at most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _scale(self, leaves, sum_squares=None, grads=None):
        if sum_squares is None:
            sq = sum(torch.sum(g.float() ** 2) for g in leaves)
        else:
            sq = sum_squares(_map(lambda g: torch.sum(g.float() ** 2),
                                  grads))
        gnorm = torch.sqrt(sq)
        return torch.clamp_max(
            self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)

    def apply_pytree(self, grads, sum_squares=None):
        s = self._scale(list(_leaves(grads)), sum_squares, grads)
        return _map(lambda g: (g.float() * s).to(g.dtype), grads)
