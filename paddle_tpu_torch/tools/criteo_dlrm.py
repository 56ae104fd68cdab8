"""The Criteo Kaggle Display Advertising configuration as DLRM runs it —
what ``chip_smoke.py``'s parameter-server phase trains and tables.

Source: facebookresearch/dlrm, ``bench/dlrm_s_criteo_kaggle.sh`` (and
the Kaggle row counts its data loader reports): 26 categorical slots and
13 dense features, embedding dim 16, bottom MLP 13-512-256-64-16, dot
interaction of the 27 vectors, top MLP 512-256-1 over the 367 features
(16 + 27 * 26 / 2), BCE, mini-batch 128, learning rate 0.1.  The 26
slots' rows, one table of :data:`TOTAL_ROWS` = 33,762,577 rows with each
slot at its offset, hold 2.16 GB at dim 16 in fp32 (plus a 135 MB
adagrad accumulator).

The dataset is not used: ids come from a seed, each slot's under a Zipf
law over its row count (a continuous power law of exponent
:data:`ZIPF_S`, inverted, floored: low ranks hot), dense features are
standard normals, and the label is a fixed rule of the ids (the parity
of slot 0's rank) so that the model can learn it.  Only the table sizes
and the model's widths are the source's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
        8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
        15, 286181, 105, 142572)
OFFSETS = np.concatenate([[0], np.cumsum(ROWS)[:-1]]).astype(np.int64)
TOTAL_ROWS = int(sum(ROWS))             # 33,762,577
SLOTS, DENSE, DIM = len(ROWS), 13, 16
BOTTOM = (DENSE, 512, 256, 64, DIM)
TOP = (DIM + (SLOTS + 1) * SLOTS // 2, 512, 256, 1)
BATCH = 128
LR = 0.1
ZIPF_S = 1.1


def sample_ranks(rng, n: int, rows=ROWS, s: float = ZIPF_S) -> np.ndarray:
    """[n, slots] int64 ranks, slot j's in [0, rows[j]) under the power
    law."""
    u = rng.random((n, len(rows)))
    top = (np.asarray(rows, np.float64) + 1.0) ** (1.0 - s) - 1.0
    x = (1.0 + u * top) ** (1.0 / (1.0 - s))
    return np.minimum(np.floor(x).astype(np.int64) - 1,
                      np.asarray(rows, np.int64) - 1)


def rows_at(scale: int = 1) -> tuple:
    """Each slot's rows cut to 1/``scale`` (at least one): a smaller
    table of the same shape."""
    return tuple(max(1, r // scale) for r in ROWS)


def batch(rng, n: int = BATCH, scale: int = 1):
    """(global ids [n, 26], {"dense": [n, 13] fp32, "y": [n] fp32}) on the
    table of ``rows_at(scale)`` (``sum`` of them rows)."""
    rows = rows_at(scale)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    ranks = sample_ranks(rng, n, rows)
    dense = rng.standard_normal((n, DENSE)).astype(np.float32)
    y = (ranks[:, 0] % 2).astype(np.float32)
    return ranks + offsets, {"dense": dense, "y": y}


def init_params(seed: int = 0, device="cpu") -> dict:
    """DLRM's initialisation: W ~ N(0, sqrt(2 / (in + out))), b ~ N(0,
    sqrt(1 / out)), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, dims in (("bot", BOTTOM), ("top", TOP)):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"{name}{i}_w"] = torch.from_numpy(
                (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)))
                .astype(np.float32)).to(device)
            params[f"{name}{i}_b"] = torch.from_numpy(
                (rng.standard_normal(b) * np.sqrt(1.0 / b))
                .astype(np.float32)).to(device)
    return params


def _mlp(params, name, n, x, last_relu):
    for i in range(n):
        x = x @ params[f"{name}{i}_w"] + params[f"{name}{i}_b"]
        if i < n - 1 or last_relu:
            x = F.relu(x)
    return x


def dense_apply(params, embeds, batch) -> torch.Tensor:
    """The DLRM step's loss: bottom MLP over the dense features, the dot
    interaction of its output with the 26 pulled rows (the 351 pairs
    below the diagonal), the top MLP, BCE with logits.  ``embeds`` are
    the unique pulled rows and ``batch["_inv"]`` [B, 26] indexes them."""
    x = _mlp(params, "bot", len(BOTTOM) - 1, batch["dense"], True)
    t = torch.cat([x[:, None], embeds[batch["_inv"]]], dim=1)   # [B, 27, D]
    z = t @ t.transpose(1, 2)
    li, lj = torch.tril_indices(SLOTS + 1, SLOTS + 1, -1, device=z.device)
    r = torch.cat([x, z[:, li, lj]], dim=1)
    logit = _mlp(params, "top", len(TOP) - 1, r, False)[:, 0]
    return F.binary_cross_entropy_with_logits(logit, batch["y"])


def step_flops(n: int = BATCH) -> int:
    """Matmul FLOPs of one forward + backward (3x the forward's)."""
    mlp = sum(a * b for dims in (BOTTOM, TOP)
              for a, b in zip(dims[:-1], dims[1:]))
    inter = (SLOTS + 1) ** 2 * DIM
    return 3 * 2 * n * (mlp + inter)
