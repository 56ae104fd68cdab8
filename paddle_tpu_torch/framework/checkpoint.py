"""Sharded checkpoint save / resume, in the JAX package's on-disk format.

Counterpart of ``paddle_tpu/framework/checkpoint.py`` (``save_sharded``
:44, ``available_steps`` :104, ``latest_step`` :119, ``verify_step``
:156, ``load_sharded`` :169, ``AutoCheckpoint`` :244; the reference's
fleet save_persistables and auto_checkpoint.py).  Either package loads
what the other saved:

    <dir>/step_<N>/manifest.json            (the finalizing rank's)
    <dir>/step_<N>/manifest.<rank>.json     (every rank's own)
    <dir>/step_<N>/<leaf-path>.c<chunk>.npy

A tree is nested dicts (keys sorted, as ``jax.tree_util`` flattens
them), lists, tuples and NamedTuples; a leaf's file name is its
``jax.tree_util.keystr`` path with every run of other characters than
``[A-Za-z0-9_.-]`` made one ``_``.  A leaf is a tensor or numpy array
that the process holds whole, or a :class:`Shard` — this rank's block
of a global array, with its starts (a row shard of a device table:
``[r * Vs, 0]``).  Each rank writes its own chunks: the JAX
multi-process protocol with ranks in place of hosts (``rank`` /
``world`` from ``torch.distributed`` when a process group is up).
Whole leaves are written by rank 0 alone, as JAX writes a replicated
array's replica 0.  A chunk's id is its starts joined by ``-`` ("0-0"
for a whole 2-d leaf, as for a one-device ``jax.Array``; "0" for a
scalar); a loader reads the ids from the manifests.  One rank's save is
atomic (a temporary directory renamed); a multi-rank save is finalized
by rank 0 without a barrier, as in JAX, and :func:`verify_step` tells a
torn step from a whole one.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, NamedTuple

import numpy as np


class Shard(NamedTuple):
    """This rank's block of a global array: ``data`` (a tensor or numpy
    array) at ``starts`` inside a global array of ``shape``."""

    data: Any
    starts: tuple
    shape: tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=""):
    """[(keystr path, leaf)] in ``jax.tree_util``'s order."""
    if isinstance(tree, Shard):
        return [(path, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += _flatten(getattr(tree, f), f"{path}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, Shard):
        return next(leaves)
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _name(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", path).strip("_")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):        # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rank_world():
    try:
        import torch.distributed as dist
    except ImportError:
        return 0, 1
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _cid(starts) -> str:
    return "-".join(str(int(s)) for s in starts) or "0"


def save_sharded(tree: Any, ckpt_dir: str, step: int):
    """Write one checkpoint (see the module docstring); call it on every
    rank.  Returns the step's directory."""
    flat = _flatten(tree)
    pid, count = _rank_world()
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + f".tmp{pid}" if count > 1 else final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in flat:
        name = _name(path)
        if isinstance(leaf, Shard):
            data = _host(leaf.data)
            starts = [int(s) for s in leaf.starts]
            shape = [int(s) for s in leaf.shape]
        else:
            if pid != 0:
                continue            # a whole leaf: replica 0 writes it
            data = _host(leaf)
            shape = list(data.shape)
            starts = [0] * data.ndim
        cid = _cid(starts)
        np.save(os.path.join(tmp, f"{name}.c{cid}.npy"), data)
        manifest["leaves"][name] = {
            "shape": shape, "dtype": data.dtype.name,
            "chunks": {cid: {"starts": starts, "shape": list(data.shape)}}}
    with open(os.path.join(tmp, f"manifest.{pid}.json"), "w") as f:
        json.dump(manifest, f)
    if count == 1:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    else:   # every rank moves its own files in; rank 0 finalizes
        os.makedirs(final, exist_ok=True)
        for fn in os.listdir(tmp):
            os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
        os.rmdir(tmp)
        if pid == 0:
            with open(os.path.join(final, "manifest.json"), "w") as f:
                json.dump(manifest, f)
    return final


_STEP_DIR = re.compile(r"step_(\d+)")


def available_steps(ckpt_dir: str) -> list[int]:
    """Every step with a finalized manifest, ascending (a listed step may
    still be torn: :func:`verify_step`)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := _STEP_DIR.fullmatch(d))
                  and os.path.exists(os.path.join(ckpt_dir, d,
                                                  "manifest.json")))


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _merged_manifest(d: str) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for fn in os.listdir(d):
        if fn.startswith("manifest.") and fn != "manifest.json":
            with open(os.path.join(d, fn)) as f:
                part = json.load(f)
            for name, meta in part["leaves"].items():
                manifest["leaves"].setdefault(name, meta)
                manifest["leaves"][name]["chunks"].update(meta["chunks"])
    return manifest


def _verified_manifest(d: str):
    """The merged manifest when every leaf's chunks are present and cover
    it, else None."""
    try:
        manifest = _merged_manifest(d)
    except (OSError, json.JSONDecodeError):
        return None
    for name, meta in manifest["leaves"].items():
        total = int(np.prod(meta["shape"])) if meta["shape"] else 1
        got = 0
        for cid, cm in meta["chunks"].items():
            if not os.path.exists(os.path.join(d, f"{name}.c{cid}.npy")):
                return None
            got += int(np.prod(cm["shape"])) if cm["shape"] else 1
        if got != total:
            return None
    return manifest


def verify_step(ckpt_dir: str, step: int) -> bool:
    """Whether one checkpoint is globally complete — the same verdict on
    every rank, from the same files."""
    return _verified_manifest(
        os.path.join(ckpt_dir, f"step_{step}")) is not None


def _read_slice(d, name, meta, req_start, req_stop):
    """The global slice [req_start, req_stop) of one leaf, assembled from
    the chunks that overlap it (each read through a numpy mmap)."""
    dtype = np.dtype(meta["dtype"])
    out = np.empty([b - a for a, b in zip(req_start, req_stop)], dtype)
    covered = np.zeros(out.shape, bool)
    for cid, cm in meta["chunks"].items():
        cstart = cm["starts"]
        cstop = [a + b for a, b in zip(cstart, cm["shape"])]
        ia = [max(a, c) for a, c in zip(req_start, cstart)]
        ib = [min(b, c) for b, c in zip(req_stop, cstop)]
        if any(a >= b for a, b in zip(ia, ib)):
            continue
        try:
            src = np.load(os.path.join(d, f"{name}.c{cid}.npy"),
                          mmap_mode="r")
        except OSError:
            continue                 # listed but unreadable: a hole
        src_sl = tuple(slice(a - c, b - c) for a, b, c in zip(ia, ib, cstart))
        dst_sl = tuple(slice(a - r, b - r)
                       for a, b, r in zip(ia, ib, req_start))
        out[dst_sl] = src[src_sl]
        covered[dst_sl] = True
    if out.size and not covered.all():
        missing = int(out.size - covered.sum())
        raise ValueError(
            f"checkpoint leaf {name!r}: chunks cover only "
            f"{out.size - missing}/{out.size} elements of the requested "
            f"slice (incomplete multi-rank save or missing chunk files in "
            f"{d!r})")
    return out


def _as_like(arr: np.ndarray, like):
    """``arr`` as a tensor on ``like``'s device when ``like`` is a tensor,
    else as it is."""
    if hasattr(like, "detach"):
        import torch

        return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return arr


def load_sharded(ckpt_dir: str, step: int, target: Any, manifest=None):
    """The checkpoint read into ``target``'s structure: a whole leaf reads
    the global array (a tensor on the target leaf's device), a
    :class:`Shard` only its own block (returned as a Shard of the same
    starts).  ``manifest``: one merged already (from a verify)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    if manifest is None:
        manifest = _merged_manifest(d)
    out = []
    for path, leaf in _flatten(target):
        name = _name(path)
        meta = manifest["leaves"][name]
        shape = list(meta["shape"])
        if isinstance(leaf, Shard):
            if list(leaf.shape) != shape:
                raise ValueError(f"checkpoint leaf {name!r}: global shape "
                                 f"{shape}, the target's {list(leaf.shape)}")
            start = [int(s) for s in leaf.starts]
            stop = [a + b for a, b in zip(start, leaf.data.shape)]
            arr = _read_slice(d, name, meta, start, stop)
            out.append(Shard(_as_like(arr, leaf.data), tuple(start),
                             tuple(shape)))
        else:
            arr = _read_slice(d, name, meta, [0] * len(shape), shape)
            out.append(_as_like(arr, leaf))
    return _unflatten(target, iter(out))


class AutoCheckpoint:
    """Periodic checkpoint and resume (auto_checkpoint.py's role): the job
    directory from ``PADDLE_TPU_CKPT_DIR``, the newest ``keep_max`` kept,
    resume from the newest loadable step."""

    def __init__(self, ckpt_dir: str | None = None, every_steps: int = 100,
                 keep_max: int = 2):
        self.dir = ckpt_dir or os.environ.get("PADDLE_TPU_CKPT_DIR", ".ckpt")
        self.every = every_steps
        self.keep_max = keep_max

    def resume(self, target):
        """(state, step): the newest globally complete checkpoint read
        into ``target``'s structure, or (target, 0) when there is none.
        A torn step is skipped for the next older one on every rank
        alike."""
        for s in reversed(available_steps(self.dir)):
            manifest = _verified_manifest(
                os.path.join(self.dir, f"step_{s}"))
            if manifest is None:
                warnings.warn(
                    f"checkpoint step_{s} in {self.dir} is torn "
                    f"(missing chunks); falling back to an older one")
                continue
            try:
                return load_sharded(self.dir, s, target,
                                    manifest=manifest), s
            except (OSError, json.JSONDecodeError) as e:
                torn = e             # raced away mid-read
            except ValueError as e:
                if "chunks cover only" not in str(e):
                    raise            # a structural mismatch is an error
                torn = e
            warnings.warn(f"checkpoint step_{s} in {self.dir} is torn "
                          f"({torn!r}); falling back to an older one")
        return target, 0

    def maybe_save(self, state, step: int):
        if step % self.every:
            return False
        save_sharded(state, self.dir, step)
        self._gc()
        return True

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.dir)
                       if (m := _STEP_DIR.fullmatch(d)))
        for s in steps[: -self.keep_max]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
