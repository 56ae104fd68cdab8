"""Distributed metrics — counterpart of
``paddle_tpu/distributed/fleet/metrics.py`` (the reference's
fleet/metrics/metric.py: sum / max / min / auc / acc over all trainers).

Stats are global by default; when the caller built per-rank stats (one
block per rank stacked along dim 0), ``stacked=world`` reduces them.
Plain numpy, the same arithmetic as the JAX package's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sum", "max", "min", "auc", "acc"]


def _reduce(local, op: str, stacked: int | None):
    arr = np.asarray(local)
    if not stacked or stacked <= 1:
        return arr
    n = int(stacked)
    if arr.ndim == 0 or arr.shape[0] % n:
        from ...framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"stacked={n} needs the leading dim to be a multiple of {n}; "
            f"got shape {arr.shape}",
            hint="stack each rank's local stat along dim 0")
    blocks = arr.reshape((n, arr.shape[0] // n) + arr.shape[1:])
    if op == "sum":
        return blocks.sum(0)
    if op == "max":
        return blocks.max(0)
    if op == "min":
        return blocks.min(0)
    raise ValueError(op)


def sum(local, stacked: int | None = None):  # noqa: A001 - reference API name
    return _reduce(local, "sum", stacked)


def max(local, stacked: int | None = None):  # noqa: A001
    return _reduce(local, "max", stacked)


def min(local, stacked: int | None = None):  # noqa: A001
    return _reduce(local, "min", stacked)


def acc(correct, total, stacked: int | None = None):
    """Global accuracy from (correct, total) counts; ``stacked=world``
    when each rank's scalar is stacked along dim 0 (reference
    fleet.metrics.acc all_reduces the two scalars)."""
    c = np.asarray(sum(np.atleast_1d(np.asarray(correct)), stacked),
                   np.float64)
    t = np.asarray(sum(np.atleast_1d(np.asarray(total)), stacked),
                   np.float64)
    return float(c.sum() / np.maximum(t.sum(), 1.0))


def auc(stat_pos, stat_neg, stacked: int | None = None):
    """AUC from positive/negative score histograms (reference
    fleet/metrics/metric.py:auc — trapezoid over merged buckets).

    stat_pos/stat_neg: [num_buckets] global counts, or [world*num_buckets]
    per-rank stacked with ``stacked=world``; bucket i holds scores in
    [i/B, (i+1)/B)."""
    pos = np.asarray(sum(np.asarray(stat_pos, np.float64), stacked))
    neg = np.asarray(sum(np.asarray(stat_neg, np.float64), stacked))
    pos = np.atleast_1d(pos).reshape(-1)
    neg = np.atleast_1d(neg).reshape(-1)
    tot_pos = tot_neg = 0.0
    area = 0.0
    # walk buckets from high score to low (reference order)
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_pos + tot_pos) * neg[i] / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0.0 or tot_neg == 0.0:
        return 0.5
    return float(area / (tot_pos * tot_neg))
