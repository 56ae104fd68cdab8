"""The port's HeterTrainer (paddle_tpu_torch/distributed/heter.py) on the
CPU: host tables on PS servers, the dense step under torch autograd —
the JAX package's trainer on the same inputs, and twins of
tests/test_heter.py's four cases.

The parity case runs each package's trainer on its own two-server
cluster of the same seed (the servers draw the same rows), from the same
numpy dense init, on the same batches with Adam(0.01): losses within
1e-4 over 20 steps, and the first step's pushed row grads within 1e-9 of
JAX's (both start from the same state).  Adam turns last-bit gradient
differences into lr-sized steps (ROADMAP C), so the dense params are
compared by the share of elements past lr/10; the servers' adagrad does
the same to rows whose grads nearly cancel (at init p ~ 0.5 for every
example, so a row seen under both labels gets a grad of ~1e-8 whose last
bits decide the direction of a sparse_lr-sized step), and Adam's
different steps then move every later grad: the rows are held within
2e-3, a fiftieth of sparse_lr (measured: 10.7% of elements past 1e-4,
at most 5.6e-4 off).  The
overlap, kill-one-server recovery and bounded-time degradation cases
assert what their JAX cases assert; ``stats`` counts depend on timing,
so they are held to the JAX test's bounds, not to equal counts.  One
cluster of each package serves the module (each test on a table of its
own); the kill case keeps a cluster of its own.
"""
import itertools
import os
import signal
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.distributed.heter import HeterTrainer
from paddle_tpu_torch.distributed.ps_service import PSClient
from paddle_tpu_torch.tools.ps_check import RecordingClient, classifier_apply
from test_torch_ps_service import build_native, cluster_of, start

_TIDS = itertools.count(10)
LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    from paddle_tpu.distributed.ps_service import PSClient as JClient

    build_native()
    tmp = tmp_path_factory.mktemp("heter")
    with cluster_of(2, tmp / "port") as port, \
            cluster_of(2, tmp / "jax", "jax", client_cls=JClient) as jax_:
        yield port, jax_


def t_apply(params, embeds, batch):
    loss = classifier_apply(params, embeds, batch)
    if "big" in params:   # device work for the overlap case to hide
        loss = loss + 1e-9 * torch.tanh(params["big"] @ params["big"]).sum()
    return loss


def make_trainer(client, rng, D=8, C=2, big=0, **kw):
    params = {"w": rng.standard_normal((D, C)).astype(np.float32) * 0.1,
              "b": np.zeros(C, np.float32)}
    if big:
        params["big"] = rng.standard_normal((big, big)).astype(
            np.float32) * 0.01
    return HeterTrainer(client, table_id=kw.pop("tid"), dim=D,
                        dense_params={k: torch.from_numpy(v)
                                      for k, v in params.items()},
                        dense_apply=t_apply,
                        optimizer=toptim.Adam(learning_rate=LR),
                        sparse_lr=0.1, device="cpu", **kw)


def test_trainer_matches_jax(clusters):
    """20 steps of each package's trainer on its own same-seed cluster."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.distributed.heter import HeterTrainer as JTrainer

    port, jax_ = clusters
    tid, V, D, C, S = next(_TIDS), 64, 8, 2, 4
    for c in clusters:
        c.create_table(tid, V, D, seed=2)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((D, C)).astype(np.float32) * 0.1
    ids = rng.integers(0, V, (20, 64, S)).astype(np.int64)
    ys = (ids[:, :, 0] % C).astype(np.int64)

    def j_apply(params, embeds, batch):
        feats = embeds[batch["_inv"]].mean(axis=1)
        lp = jax.nn.log_softmax(feats @ params["w"] + params["b"])
        return -jnp.take_along_axis(lp, batch["y"][:, None], 1).mean()

    jrec, trec = RecordingClient(jax_), RecordingClient(port)
    jt = JTrainer(jrec, table_id=tid, dim=D,
                  dense_params={"w": jnp.asarray(w0),
                                "b": jnp.zeros(C, jnp.float32)},
                  dense_apply=j_apply,
                  optimizer=paddle.optimizer.Adam(learning_rate=LR),
                  sparse_lr=0.1)
    tt = HeterTrainer(trec, table_id=tid, dim=D,
                      dense_params={"w": torch.from_numpy(w0),
                                    "b": torch.zeros(C)},
                      dense_apply=t_apply,
                      optimizer=toptim.Adam(learning_rate=LR),
                      sparse_lr=0.1, device="cpu")
    jl, tl = [], []
    for i in range(20):
        jl.append(jt.train_step(ids[i], {"y": jnp.asarray(ys[i])}))
        tl.append(tt.train_step(ids[i], {"y": torch.from_numpy(ys[i])}))
        if i == 0:    # one push a shard, the same padded ids
            assert len(trec.pushes) == len(jrec.pushes) == 2
            for (ts, ti, tg), (js, ji, jg) in zip(trec.pushes, jrec.pushes):
                assert ts == js
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.pull_sparse(tid, np.arange(V)),
                               jax_.pull_sparse(tid, np.arange(V)),
                               rtol=0, atol=2e-3)
    for k in ("w", "b"):
        diff = np.abs(tt.params[k].numpy() - np.asarray(jt.params[k]))
        assert (diff > LR / 10).mean() <= 0.05 and diff.max() <= 20 * LR, k


def test_heter_trainer_converges(clusters):
    """Sparse ids -> PS pull -> dense classifier -> push: the loss drops
    and the table rows move."""
    port = clusters[0]
    tid, V, S, N = next(_TIDS), 64, 4, 256
    port.create_table(tid, V, 8, seed=2)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (N, S)).astype(np.int64)
    labels = torch.from_numpy((ids[:, 0] % 2).astype(np.int64))
    trainer = make_trainer(port, rng, tid=tid)
    before = port.pull_sparse(tid, np.arange(V)).copy()
    losses = []
    for _ in range(60):
        sel = rng.integers(0, N, 64)
        losses.append(trainer.train_step(ids[sel], {"y": labels[sel]}))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert not np.allclose(before, port.pull_sparse(tid, np.arange(V)))


class _SlowPullClient:
    """PS round-trip latency: a GIL-free sleep before each pull — what
    train_stream's prefetch thread exists to hide."""

    def __init__(self, client, delay):
        self._c = client
        self.delay = delay

    def __getattr__(self, k):
        return getattr(self._c, k)

    def pull_sparse(self, tid, ids):
        time.sleep(self.delay)
        return self._c.pull_sparse(tid, ids)


def test_train_stream_overlaps_pull(clusters):
    """With pull latency equal to the step's compute (measured on a
    warm-up step), the streamed epoch beats sync pull -> compute -> push
    by the JAX case's margin (< 0.88 of its wall)."""
    port = clusters[0]
    tid, V, S, N = next(_TIDS), 64, 4, 10
    port.create_table(tid, V, 8, seed=2)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (N, 64, S)).astype(np.int64)
    ys = torch.from_numpy((ids[:, :, 0] % 2).astype(np.int64))
    slow = _SlowPullClient(port, delay=0.0)
    trainer = make_trainer(slow, rng, big=500, tid=tid)
    batches = [(ids[i], {"y": ys[i]}) for i in range(N)]
    trainer.train_step(*batches[0])
    t0 = time.perf_counter()
    trainer.train_step(*batches[1])
    slow.delay = min(max(time.perf_counter() - t0, 0.03), 0.5)

    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(*b)
    t_sync = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = list(trainer.train_stream(iter(batches)))
    t_stream = time.perf_counter() - t0
    assert len(losses) == N and np.isfinite(losses).all()
    assert t_stream < 0.88 * t_sync, (t_stream, t_sync, slow.delay)


def test_kill_one_server_recovery(tmp_path):
    """SIGKILL one shard server mid-training and restart it empty on the
    same port: the trainer reconnects, re-creates the table, reloads the
    snapshot onto that shard, and training continues."""
    build_native()
    V, S = 64, 4
    snap = str(tmp_path / "snap")
    with cluster_of(2, tmp_path) as cluster:
        cluster.create_table(0, V, 8, seed=2)
        rng = np.random.default_rng(1)
        ids = rng.integers(0, V, (256, S)).astype(np.int64)
        ys = torch.from_numpy((ids[:, 0] % 2).astype(np.int64))
        trainer = make_trainer(cluster, rng, tid=0, vocab=V,
                               snapshot_dir=snap, retry_interval=0.2)
        for _ in range(5):
            sel = rng.integers(0, 256, 64)
            trainer.train_step(ids[sel], {"y": ys[sel]})
        cluster.save(snap)
        rows_before = cluster.pull_sparse(0, np.arange(V)).copy()

        victim = cluster._procs[1]
        port = int(cluster.endpoints[1].rsplit(":", 1)[1])
        victim.kill()
        victim.wait(timeout=10)
        procs, _ = start(2, tmp_path, indices=[1], ports=[port])
        cluster._procs[1] = procs[0]

        losses = []
        for _ in range(5):
            sel = rng.integers(0, 256, 64)
            losses.append(trainer.train_step(ids[sel], {"y": ys[sel]}))
        assert np.isfinite(losses).all(), losses
        # shard 1's rows (odd ids) continue the snapshot, not a re-init
        odd = np.arange(1, V, 2)
        drift = np.abs(cluster.pull_sparse(0, np.arange(V))[odd]
                       - rows_before[odd]).max()
        assert drift < 1.0, drift


def test_mid_pull_server_loss_degrades_in_bounded_time(clusters):
    """A server frozen during a pull (SIGSTOP: the connection stays up,
    no answer): with degrade='stale' and op_budget the step finishes in
    bounded wall time on last-known rows, its push is deferred, and after
    the server resumes the deferred pushes drain."""
    port = clusters[0]
    tid, V, D = next(_TIDS), 64, 8
    port.create_table(tid, V, D, seed=3)
    fast = PSClient(port.endpoints, timeout=1.0)
    rng = np.random.default_rng(1)
    # the reference's dense work beside the table (its big=50,
    # tests/test_heter.py:245)
    trainer = make_trainer(fast, rng, D=D, tid=tid, big=50,
                           degrade="stale", op_budget=2.0, vocab=V)
    ids = rng.integers(0, V, (64, 4)).astype(np.int64)
    y = torch.from_numpy((ids[:, 0] % 2).astype(np.int64))
    for _ in range(3):     # healthy warm-up fills the row cache
        trainer.train_step(ids, {"y": y})
    assert trainer.stats["stale_pulls"] == 0

    pid = port._procs[1].pid
    os.kill(pid, signal.SIGSTOP)
    try:
        t0 = time.monotonic()
        loss = trainer.train_step(ids, {"y": y})
        elapsed = time.monotonic() - t0
        assert np.isfinite(loss)
        assert elapsed < 20.0, f"degraded step took {elapsed:.1f}s"
        assert trainer.stats["stale_pulls"] >= 1
        assert trainer.stats["stale_rows"] > 0
        assert trainer.stats["deferred_pushes"] >= 1
        assert trainer._deferred
    finally:
        os.kill(pid, signal.SIGCONT)

    for _ in range(6):     # the resumed server: deferred pushes drain
        trainer.train_step(ids, {"y": y})
        if not trainer._deferred:
            break
    assert not trainer._deferred
    assert trainer.stats["drained_pushes"] >= 1
    fast.close()
