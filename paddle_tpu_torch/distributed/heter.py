"""Heterogeneous PS training — host-resident sparse tables, dense math on
the card.

Counterpart of ``paddle_tpu/distributed/heter.py`` (``HeterTrainer`` :53;
``_recover`` :109, ``_with_recovery`` :128, ``_prepare`` :154,
``_drain_deferred`` :196, ``_push`` :227, ``_compute_push_apply`` :266,
``train_step`` :281, ``train_stream`` :285) — the reference's
HeterCpuWorker pull -> compute -> push cycle (framework/fleet/heter_ps).
The huge sparse table lives on the PS servers (``ps_service.py``); the
dense step runs on the trainer's device (the card unless
``device="cpu"``): the unique ids are pulled, the rows copied to the
device, ``dense_apply``'s loss differentiated over the dense params and
the pulled rows together (``torch.autograd.grad``), the row grads pushed
(server-side adagrad) and the dense params updated by the port's
functional ``optimizer.apply_gradients``.

Two execution shapes:

* :meth:`HeterTrainer.train_step` — synchronous pull -> compute -> push;
* :meth:`HeterTrainer.train_stream` — batch N+1's pull runs on a prefetch
  thread while the device computes batch N.  On a card the rows go
  through pinned staging on a side stream, with an event the compute
  stream waits on, so the copy never serializes against the compute.
  Rows pulled one step early are one push stale (the reference's
  async-pipeline semantics).

Fault tolerance and bounded-time degradation are JAX's: a lost server is
retried through recovery (reconnect, re-create the table, reload
``snapshot_dir`` onto exactly the restarted shards); with
``degrade="stale"`` and ``op_budget`` a pull past its budget is served
from the row cache and a push past it is deferred, queued in order per
shard and drained on later steps; ``stats`` counts both.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from .. import resolve_device

__all__ = ["HeterTrainer"]


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


class HeterTrainer:
    """Pull-compute-push training over a ``PSClient`` and a dense step.

    ``dense_apply(params, embeds, batch) -> loss`` is a torch function:
    ``embeds`` are the [n_unique, dim] pulled rows, ``batch["_inv"]`` the
    [B, S] indices into them.  ``dense_params`` is a dict tree of tensors
    (moved to the trainer's device); ``optimizer`` a port optimizer.
    ``vocab`` (and ``snapshot_dir``) arm the recovery path."""

    def __init__(self, client, table_id: int, dim: int,
                 dense_params, dense_apply: Callable, optimizer,
                 sparse_lr: float = 0.05, vocab: int | None = None,
                 snapshot_dir: str | None = None, max_retries: int = 3,
                 retry_interval: float = 0.5, degrade: str = "block",
                 op_budget: float | None = None, device=None):
        if degrade not in ("block", "stale"):
            raise ValueError(f"degrade must be 'block' or 'stale', "
                             f"got {degrade!r}")
        self.device = resolve_device(device)
        self.client = client
        self.tid = table_id
        self.dim = dim
        self.params = _rebuild(dense_params, iter([
            torch.as_tensor(p).to(self.device)
            for p in _leaves(dense_params, [])]))
        self.opt = optimizer
        self.opt_state = optimizer.init_state(self.params)
        self.sparse_lr = sparse_lr
        self.vocab = vocab
        self.snapshot_dir = snapshot_dir
        self.max_retries = max_retries
        self.retry_interval = retry_interval
        self.degrade = degrade
        self.op_budget = op_budget
        self._apply_fn = dense_apply
        # degradation state: last-known rows for stale reads, queued
        # (shard, ids, grads) for deferred pushes, and observability
        self._row_cache: dict[int, np.ndarray] = {}
        self._deferred: list[tuple[int, np.ndarray, np.ndarray]] = []
        # heuristic server-health flag (benign race under train_stream:
        # the feeder writes it, the consumer reads it)
        self._last_pull_stale = False
        self.stats = {"stale_pulls": 0, "stale_rows": 0,
                      "deferred_pushes": 0, "drained_pushes": 0}
        self._step = 0
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)

    # -- fault tolerance -----------------------------------------------------
    def _recover(self):
        """Reconnect and re-provision restarted (empty) servers; a snapshot
        is restored ONLY onto shards whose table was just re-created."""
        self.client.reset_connections()
        if self.vocab is not None:
            fresh = self.client.create_table(self.tid, self.vocab, self.dim)
            if self.snapshot_dir is not None:
                for s, was_fresh in fresh.items():
                    if not was_fresh:
                        continue
                    try:
                        self.client.load_shard(s, self.snapshot_dir)
                    except (RuntimeError, ConnectionError, OSError):
                        pass  # no snapshot yet: keep the fresh init

    def _with_recovery(self, fn, budget: float | None = None):
        """Retry ``fn`` through recovery, bounded by ``budget`` seconds of
        wall clock when given; exhaustion raises (degradation is the
        caller's policy)."""
        deadline = None if budget is None else time.monotonic() + budget
        attempt = 0
        while True:
            try:
                return fn()
            except (RuntimeError, ConnectionError, OSError):
                out_of_time = (deadline is not None
                               and time.monotonic() >= deadline)
                if out_of_time or (deadline is None
                                   and attempt >= self.max_retries):
                    raise
                time.sleep(min(self.retry_interval * (attempt + 1),
                               max(0.0, deadline - time.monotonic())
                               if deadline is not None else 60.0))
                attempt += 1
                try:
                    self._recover()
                except (RuntimeError, ConnectionError, OSError):
                    continue  # server still down: the next attempt retries

    # -- the two step phases -------------------------------------------------
    def _pull_rows(self, uniq: np.ndarray) -> np.ndarray:
        try:
            rows = self._with_recovery(
                lambda: self.client.pull_sparse(self.tid, uniq),
                budget=self.op_budget)
            rows = rows.reshape(len(uniq), self.dim)
            if self.degrade == "stale":
                for j, u in enumerate(uniq):
                    self._row_cache[int(u)] = rows[j].copy()
                self._last_pull_stale = False
            return rows
        except (RuntimeError, ConnectionError, OSError):
            if self.degrade != "stale":
                raise
            # budget exhausted mid-pull: serve last-known rows (zeros for
            # never-seen ids) so the step completes in bounded time
            rows = np.zeros((len(uniq), self.dim), np.float32)
            miss = 0
            for j, u in enumerate(uniq):
                cached = self._row_cache.get(int(u))
                if cached is not None:
                    rows[j] = cached
                else:
                    miss += 1
            self.stats["stale_pulls"] += 1
            self.stats["stale_rows"] += len(uniq) - miss
            self._last_pull_stale = True
            return rows

    def _to_device(self, rows: np.ndarray, inv: np.ndarray):
        """(embeds, inv, event): on a card through pinned staging on the
        side stream, the event marking the copies' end; on the CPU plain
        tensors and no event."""
        if not self._cuda:
            return torch.from_numpy(rows), torch.from_numpy(inv), None
        h_rows = torch.from_numpy(rows).pin_memory()
        h_inv = torch.from_numpy(inv).pin_memory()
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            embeds = h_rows.to(self.device, non_blocking=True)
            d_inv = h_inv.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return embeds, d_inv, ev

    def _prepare(self, ids: np.ndarray):
        """Host / PS half: unique, pad, pull, the copy to the device (safe
        on a prefetch thread)."""
        ids = np.asarray(ids, np.int64)
        uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
        # pad the unique count to the next power of two, as the JAX trainer
        # does (both push the same padded ids); pad slots repeat uniq[0]
        # and no inv entry points at them, so their grads are exactly zero
        pad_to = 1 << (len(uniq) - 1).bit_length()
        if pad_to != len(uniq):
            uniq = np.concatenate(
                [uniq, np.full(pad_to - len(uniq), uniq[0], np.int64)])
        rows = self._pull_rows(uniq)
        embeds, d_inv, ev = self._to_device(
            np.ascontiguousarray(rows, np.float32),
            inv.reshape(ids.shape).astype(np.int64))
        return uniq, d_inv, embeds, ev

    def _drain_deferred(self):
        """Retry queued pushes under the op budget, in order within a
        shard; returns the shards that still hold queued deltas (new grads
        for those shards must queue behind them)."""
        if not self._deferred:
            return set()
        deadline = None if self.op_budget is None \
            else time.monotonic() + self.op_budget
        remaining = []
        blocked: set[int] = set()  # first failure blocks that shard's rest
        timed_out = False
        for item in self._deferred:
            s, i, g = item
            timed_out = timed_out or (deadline is not None
                                      and time.monotonic() >= deadline)
            if timed_out or s in blocked:
                remaining.append(item)
                continue
            try:
                self.client.push_sparse_shard(s, self.tid, i, g,
                                              lr=self.sparse_lr)
                self.stats["drained_pushes"] += 1
            except (RuntimeError, ConnectionError, OSError):
                blocked.add(s)
                remaining.append(item)
        self._deferred = remaining
        return {s for s, _, _ in remaining}

    def _push(self, uniq: np.ndarray, grads: np.ndarray):
        """Per-SHARD pushes, each with its own retry (adagrad is not
        idempotent: a whole-fan retry would apply twice where a shard had
        succeeded)."""
        backlogged: set[int] = set()
        if self.degrade == "stale":
            # skip the drain while the server is known down (this step's
            # pull degraded): probing a dead shard costs a socket timeout
            if self._last_pull_stale:
                backlogged = {s for s, _, _ in self._deferred}
            else:
                backlogged = self._drain_deferred()
        srv = uniq % self.client.S
        local = uniq // self.client.S
        for s in range(self.client.S):
            m = srv == s
            if not m.any():
                continue
            if s in backlogged:
                self._deferred.append((s, local[m], grads[m]))
                self.stats["deferred_pushes"] += 1
                continue
            try:
                self._with_recovery(
                    lambda s=s, i=local[m], g=grads[m]:
                    self.client.push_sparse_shard(s, self.tid, i, g,
                                                  lr=self.sparse_lr),
                    budget=self.op_budget)
            except (RuntimeError, ConnectionError, OSError):
                if self.degrade != "stale":
                    raise
                self._deferred.append((s, local[m], grads[m]))
                self.stats["deferred_pushes"] += 1

    def _batch(self, batch, inv):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                v = v.to(self.device, non_blocking=True)
            out[k] = v
        out["_inv"] = inv
        return out

    def _grads(self, embeds, batch):
        """loss and the grads over (dense params, pulled rows) together."""
        leaves = [p.detach().requires_grad_(True)
                  for p in _leaves(self.params, [])]
        embeds = embeds.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._apply_fn(_rebuild(self.params, iter(leaves)),
                                  embeds, batch)
            grads = torch.autograd.grad(loss, leaves + [embeds])
        return loss.detach(), list(grads[:-1]), grads[-1]

    def _compute_push_apply(self, prepared, batch) -> float:
        """Device half and push: one backward, the PS push, the dense
        update."""
        uniq, inv, embeds, ev = prepared
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            embeds.record_stream(cur)
            inv.record_stream(cur)
        loss, gp, ge = self._grads(embeds, self._batch(batch, inv))
        self._push(uniq, ge.cpu().numpy())
        self._step += 1
        self.params, self.opt_state = self.opt.apply_gradients(
            _rebuild(self.params, iter(gp)), self.params, self.opt_state,
            lr=self.opt.get_lr(), step=self._step)
        return float(loss)

    # -- public API ----------------------------------------------------------
    def train_step(self, ids: np.ndarray, batch) -> float:
        """ids: int64 [B, S] sparse feature ids of this batch."""
        return self._compute_push_apply(self._prepare(ids), batch)

    def train_stream(self, batches: Iterable, prefetch: int = 2):
        """Pipelined epoch over ``(ids, batch)`` pairs: a prefetch thread
        pulls (and copies) batch N+1's rows while the device computes
        batch N.  Yields each step's loss."""
        q: _queue.Queue = _queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def feeder():
            try:
                for ids, batch in batches:
                    prepared = self._prepare(ids)
                    while not stop.is_set():
                        try:
                            q.put((prepared, batch), timeout=0.2)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(None)
            except BaseException as e:  # surfaced at the consumer
                q.put(e)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                prepared, batch = item
                yield self._compute_push_apply(prepared, batch)
        finally:
            stop.set()
            while True:  # unblock a feeder stuck on a full queue
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
