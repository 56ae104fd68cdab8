"""ZeRO's layout rule — counterpart of ``zero_shard_spec`` in
``paddle_tpu/distributed/fleet/base.py`` (:198-221).

A spec is a tuple with one entry a dim: None (replicated), an axis name,
or a tuple of names (the dim split over their product, the first axis
major) — the JAX ``PartitionSpec``'s entries.  ``fleet.ShardedTrainStep``
is not ported (ROADMAP A2).
"""
from __future__ import annotations

from ..topology import axes_of


def zero_shard_spec(spec, shape, axis_name="sharding", mesh=None):
    """ZeRO: ``axis_name`` added onto the first dim of ``shape`` that its
    size divides (and is no shorter than), after that dim's own axes —
    the JAX rule, so each shard's shape equals JAX's.  Returns ``spec``
    unchanged when the axis has size 1, is already used, or divides no
    dim."""
    size = mesh.size(axis_name) if mesh is not None else 1
    if size <= 1:
        return spec
    parts = list(spec) if spec is not None else []
    parts += [None] * (len(shape) - len(parts))
    used = {a for p in parts for a in axes_of(p)}
    if axis_name in used:
        return spec
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if dim % size == 0 and dim >= size:
            parts[i] = (*axes_of(p), axis_name) if p is not None \
                else axis_name
            return tuple(parts)
    return spec


def zero_dim(spec, zspec):
    """The dim ``zero_shard_spec`` split (None when it split none)."""
    if zspec is None or zspec == spec:
        return None
    spec = tuple(spec or ()) + (None,) * (len(zspec) - len(spec or ()))
    for i, (a, b) in enumerate(zip(spec, zspec)):
        if a != b:
            return i
    return None
