"""Row-sharded device tables on the ranks of a process group: what the
CPU tests (``tests/test_torch_ps_table.py``, gloo ranks) and
``chip_smoke.py``'s PS phase (d) run on each rank through
``distributed.spawn``.

:func:`run_table` builds a ``SparseEmbeddingTable`` over a mesh of one
axis ``"mp"`` spanning the world, optionally installs a whole-table
state (``state``) or loads a checkpoint (``load_dir``), applies the
case's pushes, pulls ``pull_ids``, optionally saves (``save_dir``), and
returns the gathered rows and accumulator with the pulls — as numpy, so
that they pickle back to the caller (``gather_to=0``: rank 0's alone).
Each push's and pull's wall (synchronized) comes back too, and the wall
clock at each stage (``marks``).

:func:`small_table_vs_cpu` and :func:`small_heter_vs_cpu` hold a device
table and a ``HeterTrainer`` on a card against the same on the CPU
(``tests/test_torch_kernels_cuda.py`` and the smoke's PS phase (a)).
JAX-free: the ranks import torch only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..distributed import collective, env
from ..distributed.ps import SparseEmbeddingTable


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_table(case, mesh=None):
    """One case on this rank, over ``mesh`` (a mesh whose ``"mp"`` spans
    the world; None: made here)."""
    marks = {"entered": time.time()}    # wall clock: comparable across ranks
    if mesh is None:
        world = torch.distributed.get_world_size()
        mesh = env.init_parallel_env({"mp": world},
                                     device=case.get("device"))
    dev = torch.device(mesh.device)
    marks["mesh"] = time.time()
    t = SparseEmbeddingTable(case["vocab"], case["dim"], mesh=mesh,
                             axis="mp", optimizer=case.get("optimizer",
                                                           "adagrad"),
                             lr=case.get("lr", 0.05),
                             seed=case.get("seed", 0))
    if case.get("state") is not None:
        t.set_state(case["state"])
    if case.get("load_dir"):
        t.load(case["load_dir"])
    marks["table"] = time.time()
    out = {"rows_local": t.state.rows.shape[0], "rank": mesh.rank,
           "push_ms": [], "pull_ms": [], "marks": marks}
    for ids, grads in case.get("pushes", ()):
        ids = torch.as_tensor(ids).to(dev)
        grads = torch.as_tensor(grads).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        t.push(ids, grads)
        _sync(dev)
        out["push_ms"].append((time.perf_counter() - t0) * 1e3)
    marks["pushed"] = time.time()
    if case.get("pull_ids") is not None:
        ids = torch.as_tensor(case["pull_ids"]).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        got = t.pull(ids)
        _sync(dev)
        out["pull_ms"].append((time.perf_counter() - t0) * 1e3)
        out["pulls"] = got.cpu().numpy()
    if case.get("save_dir"):
        t.save(case["save_dir"])
    marks["pulled"] = time.time()
    rows = collective.all_gather(t.state.rows, mesh, "mp")
    accum = collective.all_gather(t.state.accum, mesh, "mp")
    if case.get("gather_to") in (None, mesh.rank):
        out["rows"], out["accum"] = rows.cpu().numpy(), accum.cpu().numpy()
    del rows, accum
    marks["gathered"] = time.time()
    del t
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_tables(cases):
    """Every case on this rank, in order."""
    return [run_table(case) for case in cases]


def duplicate_pushes(seed, n, batch, vocab, dim, hot=3):
    """``n`` push batches whose ids come from a ``1 / hot`` share of the
    rows (duplicates in every batch)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, max(1, vocab // hot), batch).astype(np.int64),
             rng.standard_normal((batch, dim)).astype(np.float32))
            for _ in range(n)]


def small_table_vs_cpu(device, vocab=4096, dim=16, n=20, batch=512,
                       rtol=1e-6, atol=1e-7):
    """A ``vocab`` x ``dim`` adagrad table on ``device`` and on the CPU
    from one state, ``n`` pushes with duplicates: for rows and
    accumulator, the largest ``|dev - cpu| / (rtol * |cpu| + atol)`` (at
    most 1: within rtol relative, atol absolute)."""
    cpu = SparseEmbeddingTable(vocab, dim, seed=0, device="cpu")
    dev = SparseEmbeddingTable(vocab, dim, seed=0, device=device)
    dev.set_state(cpu.state)
    for ids, g in duplicate_pushes(0, n, batch, vocab, dim):
        cpu.push(ids, g)
        dev.push(torch.from_numpy(ids).to(dev.device),
                 torch.from_numpy(g).to(dev.device))

    def excess(a, b):
        a, b = a.cpu().double(), b.double()
        return float(((a - b).abs() / (rtol * b.abs() + atol)).max())

    return excess(dev.state.rows, cpu.state.rows), excess(dev.state.accum,
                                                         cpu.state.accum)


class RecordingClient:
    """Forwards to a ``PSClient``, recording each shard push."""

    def __init__(self, client):
        self._c = client
        self.pushes = []

    def __getattr__(self, k):
        return getattr(self._c, k)

    def push_sparse_shard(self, s, tid, ids, grads, lr=0.05):
        self.pushes.append((s, np.array(ids), np.array(grads)))
        return self._c.push_sparse_shard(s, tid, ids, grads, lr=lr)


def classifier_apply(params, embeds, batch):
    """tests/test_heter.py's dense step: mean-pool the slot rows,
    classify."""
    feats = embeds[batch["_inv"]].mean(dim=1)
    lp = torch.log_softmax(feats @ params["w"] + params["b"], dim=-1)
    return -lp.gather(1, batch["y"][:, None]).mean()


def small_heter_vs_cpu(device, workdir, steps=20, V=64, D=8, C=2, S=4,
                       lr=0.01, sparse_lr=0.1):
    """tests/test_heter.py's V = 64 trainer on ``device`` and on the CPU,
    each on its own two-server cluster of one seed, from one numpy dense
    init, on the same batches, Adam(lr): the per-step losses, the first
    step's pushes, the rows and the dense params of both."""
    from .. import optimizer as optim
    from ..distributed import ps_service
    from ..distributed.heter import HeterTrainer

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((D, C)).astype(np.float32) * 0.1
    ids = rng.integers(0, V, (steps, 64, S)).astype(np.int64)
    ys = torch.from_numpy((ids[:, :, 0] % C).astype(np.int64))
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        procs, eps = ps_service.start_servers(2, f"{workdir}/{name}")
        client = ps_service.PSClient(eps)
        try:
            client.create_table(0, V, D, seed=2)
            rec = RecordingClient(client)
            tr = HeterTrainer(rec, table_id=0, dim=D,
                              dense_params={"w": torch.from_numpy(w0),
                                            "b": torch.zeros(C)},
                              dense_apply=classifier_apply,
                              optimizer=optim.Adam(learning_rate=lr),
                              sparse_lr=sparse_lr, device=dev)
            losses = []
            for i in range(steps):
                losses.append(tr.train_step(ids[i], {"y": ys[i]}))
                if i == 0:
                    first = list(rec.pushes)
            out[name] = {"losses": losses, "first_pushes": first,
                         "rows": client.pull_sparse(0, np.arange(V)),
                         "params": {k: v.cpu().numpy()
                                    for k, v in tr.params.items()}}
        finally:
            client.shutdown_servers()
            client.close()
            for p in procs:
                p.wait(timeout=30)
    return out
