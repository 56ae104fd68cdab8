"""Device sparse-embedding tables — the in-device "parameter server".

Counterpart of ``paddle_tpu/distributed/ps.py`` (``_merge_duplicate_ids``
:29, ``SparseTableState`` :50, ``SparseEmbeddingTable`` :57,
``TheOnePS`` :158, ``DistributedGraphTable`` :188; the reference's
CommonSparseTable and ``distributed_lookup_table``).  A table is a
``[rows_total, D]`` float32 tensor plus a ``[rows_total]`` adagrad
accumulator on an explicit device — the card unless ``device="cpu"`` —
laid out as in JAX: V + 1 rows (row V the dummy row that the duplicate
merge sends repeats to), padded to a multiple of the shard count.  A
push touches only the referenced rows (``index_add_``); no dense
``[V, D]`` gradient ever exists.

Over a ``topology.Mesh`` (``mesh=``, ``axis=``) rank r holds rows
``[r * Vs, (r + 1) * Vs)``: ``pull`` of ids every rank holds is a masked
local gather and one all-reduce over the axis group (what XLA inserts
for the JAX sharded gather; the other ranks add exact zeros, so the sum
is the row itself); ``push`` merges duplicates identically on every
rank, and each rank applies only its own rows, with no exchange.

Deviations from JAX (ROADMAP C): the initial rows are the port's
counter-based ``rng.normal`` under ``seed`` (held to JAX's by law: mean
and std); carry a JAX state across with ``convert.table_state_from_jax``.
On a card the duplicate sums run in ``index_add_``'s atomic order, not a
fixed one.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import resolve_device, rng

_INIT_CHUNK = 1 << 24        # elements drawn at a time at init


def _merge_duplicate_ids(ids, grads, vocab_size: int):
    """Merge per-occurrence grads of duplicate ids, with static shapes and
    no host sync.

    Returns (slot_ids [N], merged [N, D]): group g of the sorted unique
    ids sits at position g (its id and its summed grad), positions past
    the last group hold ``vocab_size`` and zero grads."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    s_ids = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = s_ids[1:] != s_ids[:-1]
    seg = torch.cumsum(first, 0) - 1
    merged = torch.zeros((n, grads.shape[1]), dtype=grads.dtype,
                         device=grads.device)
    merged.index_add_(0, seg, grads[order])
    # every member of a group writes the same id: the value is defined
    out_ids = torch.full((n,), vocab_size, dtype=ids.dtype, device=ids.device)
    out_ids[seg] = s_ids
    return out_ids, merged


class SparseTableState(NamedTuple):
    """One table's state: rows [rows, D] and the adagrad accumulator
    [rows] (zeros under sgd) — on a mesh, this rank's row shard."""

    rows: Any
    accum: Any


class SparseEmbeddingTable:
    """Row-sharded embedding table with sparse adagrad / sgd pushes (see
    the module docstring)."""

    def __init__(self, vocab_size: int, dim: int, mesh=None,
                 axis: str | None = "mp", optimizer: str = "adagrad",
                 lr: float = 0.05, initializer_std: float = 0.01,
                 seed: int = 0, device=None):
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"optimizer must be 'adagrad' or 'sgd', got "
                             f"{optimizer!r}")
        self.vocab_size = vocab_size
        self.dim = dim
        self.optimizer = optimizer
        self.lr = lr
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.size(axis) if mesh is not None else 1
        self.n_shards = n_shards
        self.shard = mesh.coord(axis) if n_shards > 1 else 0
        self.device = (torch.device(mesh.device) if mesh is not None
                       else resolve_device(device))
        self._rows_total = -((vocab_size + 1) // -n_shards) * n_shards
        self._rows_local = self._rows_total // n_shards
        self._start = self.shard * self._rows_local
        rows = torch.empty((self._rows_local, dim), dtype=torch.float32,
                           device=self.device)
        key = rng.seed_key(seed)
        per = max(1, _INIT_CHUNK // dim)
        with torch.no_grad():
            for a in range(0, self._rows_local, per):
                b = min(a + per, self._rows_local)
                block = rng.normal(key, (b - a, dim), self.device,
                                   offset=(self._start + a) * dim)
                rows[a:b] = initializer_std * block
            live = max(0, min(vocab_size - self._start, self._rows_local))
            rows[live:] = 0.0
        self.state = SparseTableState(
            rows, torch.zeros(self._rows_local, dtype=torch.float32,
                              device=self.device))

    @property
    def rows_total(self) -> int:
        return self._rows_total

    # -- client API (pull_sparse / push_sparse) -----------------------------
    def _ids(self, ids):
        return torch.as_tensor(ids).to(self.device, torch.int64)

    def pull(self, ids):
        """ids [...] -> embeddings [..., D] (the pull_sparse role)."""
        ids = self._ids(ids)
        if self.n_shards == 1:
            return self.state.rows[ids]
        from . import collective

        local = ids - self._start
        mine = (local >= 0) & (local < self._rows_local)
        got = self.state.rows[local.clamp(0, self._rows_local - 1)]
        got = torch.where(mine[..., None], got, 0.0)
        return collective.all_reduce_(got, self.mesh, self.axis)

    def push(self, ids, grads, lr: float | None = None):
        """Apply merged sparse gradients to the touched rows only."""
        ids = self._ids(ids).reshape(-1)
        grads = torch.as_tensor(grads).to(self.device, torch.float32)
        grads = grads.reshape(-1, self.dim)
        self.state = self._push_impl(self.state, ids, grads,
                                     self.lr if lr is None else lr)
        return self

    def _push_impl(self, st: SparseTableState, ids, grads, lr):
        slot_ids, merged = _merge_duplicate_ids(ids, grads, self.vocab_size)
        local = slot_ids - self._start
        mine = (local >= 0) & (local < self._rows_local)
        local = local.clamp(0, self._rows_local - 1)
        rows, accum = st.rows, st.accum
        with torch.no_grad():
            if self.optimizer == "adagrad":
                g2 = torch.sum(merged * merged, dim=-1) / self.dim
                accum.index_add_(0, local, torch.where(mine, g2, 0.0))
                denom = torch.sqrt(accum[local])[:, None] + 1e-8
                upd = -lr * merged / denom
            else:
                upd = -lr * merged
            rows.index_add_(0, local, torch.where(mine[:, None], upd, 0.0))
        return SparseTableState(rows, accum)

    # -- embedding-layer style forward with autograd ------------------------
    def lookup_and_grad_fn(self, ids):
        """(embeddings, push_fn): push_fn(d_embeddings[, lr]) applies the
        sparse update — the distributed_lookup_table fwd / bwd pair as an
        explicit handshake (the embeddings are a leaf autograd can reach:
        ``torch.autograd.grad(loss, emb)`` gives d_embeddings)."""
        emb = self.pull(ids).detach().requires_grad_(True)

        def push_fn(d_emb, lr=None):
            self.push(ids, d_emb.detach(), lr)

        return emb, push_fn

    # -- state ---------------------------------------------------------------
    def set_state(self, state):
        """Install whole-table ``(rows, accum)`` (of any padding: rows past
        V are zero in every layout) — this rank keeps its own shard."""
        rows, accum = state
        full = torch.zeros((self._rows_total, self.dim), dtype=torch.float32)
        acc = torch.zeros(self._rows_total, dtype=torch.float32)
        n = min(self.vocab_size + 1, rows.shape[0])
        full[:n] = torch.as_tensor(rows[:n]).to("cpu", torch.float32)
        acc[:n] = torch.as_tensor(accum[:n]).to("cpu", torch.float32)
        sl = slice(self._start, self._start + self._rows_local)
        self.state = SparseTableState(full[sl].to(self.device),
                                      acc[sl].to(self.device))
        return self

    def _ckpt_tree(self):
        from ..framework.checkpoint import Shard

        if self.n_shards == 1:
            return {"rows": self.state.rows, "accum": self.state.accum}
        return {"rows": Shard(self.state.rows, (self._start, 0),
                              (self._rows_total, self.dim)),
                "accum": Shard(self.state.accum, (self._start,),
                               (self._rows_total,))}

    # -- persistence (fleet.save_persistables for tables) -------------------
    def save(self, dirname: str, step: int = 0):
        from ..framework.checkpoint import save_sharded

        save_sharded(self._ckpt_tree(), dirname, step)

    def load(self, dirname: str, step: int = 0):
        from ..framework.checkpoint import Shard, load_sharded

        out = load_sharded(dirname, step, self._ckpt_tree())
        rows, accum = out["rows"], out["accum"]
        if isinstance(rows, Shard):
            rows, accum = rows.data, accum.data
        self.state = SparseTableState(rows, accum)
        return self


class TheOnePS:
    """Table registry and facade (TheOnePSRuntime / PSClient role)."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        self.device = device
        self._tables: dict[int, SparseEmbeddingTable] = {}

    def create_table(self, table_id: int, vocab_size: int, dim: int, **kw):
        kw.setdefault("device", self.device)
        t = SparseEmbeddingTable(vocab_size, dim, mesh=self.mesh, **kw)
        self._tables[table_id] = t
        return t

    def table(self, table_id: int) -> SparseEmbeddingTable:
        return self._tables[table_id]

    def pull_sparse(self, table_id: int, ids):
        return self._tables[table_id].pull(ids)

    def push_sparse(self, table_id: int, ids, grads, lr=None):
        return self._tables[table_id].push(ids, grads, lr)

    def save(self, dirname: str):
        for tid, t in self._tables.items():
            t.save(f"{dirname}/table_{tid}")

    def load(self, dirname: str):
        for tid, t in self._tables.items():
            t.load(f"{dirname}/table_{tid}")


class DistributedGraphTable:
    """Client-side handle on the PS service's graph table (reference
    common_graph_table.cc + graph_brpc_client): storage and sampling live
    server-side (``csrc/host/ps_table.cpp`` ``pgt_*``); edges shard by
    ``src % num_servers``, so each server owns the whole out-neighbourhood
    of its nodes.  Binds one table id on a ``ps_service.PSClient``."""

    def __init__(self, client, tid: int = 0, seed: int = 0):
        self.client = client
        self.tid = tid
        client.create_graph_table(tid, seed=seed)

    def add_edges(self, src, dst, weights=None):
        self.client.add_edges(self.tid, src, dst, weights)

    def sample_neighbors(self, ids, k: int):
        return self.client.sample_neighbors(self.tid, ids, k)

    def degrees(self, ids):
        return self.client.node_degrees(self.tid, ids)

    def set_node_feat(self, ids, feats):
        self.client.set_node_feat(self.tid, ids, feats)

    def get_node_feat(self, ids):
        """([n..., dim] features, [n...] found mask) — takes the [n, k]
        output of :meth:`sample_neighbors` as it is (-1 padding comes back
        zero-filled with found=False)."""
        return self.client.get_node_feat(self.tid, ids)

    def random_nodes(self, k: int):
        return self.client.random_sample_nodes(self.tid, k)

    def stat(self):
        return self.client.graph_stat(self.tid)
