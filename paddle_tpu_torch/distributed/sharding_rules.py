"""Name-pattern -> placement rules for arbitrary models.

Counterpart of ``paddle_tpu/distributed/sharding_rules.py``
(``match_sharding_rules`` :38, ``apply_sharding_rules``).  Users give
ordered ``(regex, spec)`` rules over the "/"-joined key paths of a nested
tree (dicts and lists) and get the matching tree of specs.  A spec is the
port's placement of one tensor (``gpt.param_shardings``'s form): a tuple
with one entry a dim — None (whole) or a mesh axis name (split over it) —
and ``()`` for replicated.

Scalars (and one-element tensors) are never partitioned.  With
``strict`` a leaf no rule matches raises (a silently replicated big weight
is the classic sharding bug); otherwise it takes ``default``.
"""
from __future__ import annotations

import math
import re
from typing import Sequence, Tuple

import torch

__all__ = ["match_sharding_rules", "apply_sharding_rules", "leaf_paths"]


def _is_leaf(v) -> bool:
    """Dicts and lists are the containers; a spec (a tuple) is a leaf."""
    return not isinstance(v, (dict, list))


def leaf_paths(tree, prefix: str = "", sep: str = "/"):
    """[(path, leaf)] of a nested tree of dicts and lists, depth first in
    insertion order; list items are named by their index."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = []
    for k, v in items:
        out.extend(leaf_paths(v, f"{prefix}{sep}{k}" if prefix else str(k),
                              sep))
    return out


def _rebuild(tree, fn, prefix: str = "", sep: str = "/"):
    if _is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}{sep}{k}" if prefix else str(k),
                            sep) for k, v in tree.items()}
    return [_rebuild(v, fn, f"{prefix}{sep}{i}" if prefix else str(i), sep)
            for i, v in enumerate(tree)]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


_UNMATCHED = ("no sharding rule matches parameter {name!r} (shape "
              "{shape}); add a rule or pass strict=False")


def match_sharding_rules(rules: Sequence[Tuple[str, tuple]], params,
                         default=None, strict: bool = True,
                         sep: str = "/", one_element: bool = True,
                         unmatched: str = _UNMATCHED):
    """Ordered ``(regex, spec)`` rules -> a tree of specs matching
    ``params``: each leaf's ``sep``-joined path takes the spec of the
    first rule whose pattern ``re.search``-es it; a scalar takes ``()``
    (and, with ``one_element``, a one-element tensor too); an unmatched
    leaf raises ``ValueError(unmatched.format(name=, shape=))`` under
    ``strict``, else takes ``default`` (``()`` when None)."""
    def pick(name, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or (one_element and math.prod(shape) == 1):
            return ()
        for pat, spec in rules:
            if re.search(pat, name):
                return tuple(spec)
        if strict:
            raise ValueError(unmatched.format(name=name, shape=shape))
        return tuple(default) if default is not None else ()

    return _rebuild(params, pick, sep=sep)


def apply_sharding_rules(rules, params, mesh, default=None,
                         strict: bool = True):
    """(this rank's blocks of ``params``, the tree of specs): each leaf
    cut along its spec's split dims to the block of ``mesh``'s rank
    (``topology.Mesh``: chunk ``mesh.index(axes)`` of ``mesh.size(axes)``
    per dim) — the JAX call's placed arrays seen from one rank, each
    block a copy on the CPU."""
    from ..text.gpt import shard_leaf

    specs = match_sharding_rules(rules, params, default=default,
                                 strict=strict)
    flat = dict(leaf_paths(specs))
    placed = _rebuild(params, lambda name, leaf: shard_leaf(
        torch.as_tensor(leaf), flat[name], mesh))
    return placed, specs
