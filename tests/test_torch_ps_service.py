"""The port's parameter-server service (paddle_tpu_torch/distributed/
ps_service.py over csrc/host/ps_table.cpp) — twins of tests/
test_ps_service.py's ten cases, and the wire held against the JAX
package's in both directions.

Table servers are child processes (``ps_service.start_servers``: the
port's ``python -m paddle_tpu_torch.distributed.ps_service``, or the JAX
package's module under ``PADDLE_TPU_LIGHT_IMPORT=1``), started together.
One two-server cluster of each package serves the whole module, each
test on table ids and dense keys of its own; the ssd tests restart their
servers and keep clusters of their own.  The wire twins run one
create / pull / push / delta / dense / save sequence through a port
client on JAX servers and through a JAX client on port servers (and each
package on its own): the servers draw the same rows from the same seed
(``fill_random``'s mt19937_64, one source), so every pull is bit-equal
and every saved table file byte-equal.  The helpers here serve
test_torch_ps_graph.py and test_torch_heter.py too.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.distributed import ps_service as jsvc
from paddle_tpu_torch.distributed import ps_service as svc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULE = "paddle_tpu.distributed.ps_service"


def build_native():
    """Both packages' libraries, built in this process before any server
    starts (servers building at once would race for one output)."""
    from paddle_tpu import _native as jnative
    from paddle_tpu_torch import _native

    _native.ps_table()
    jnative.ps_table()


def start(n, workdir, package="port", **kw):
    """Start ``n`` servers of ``package`` ("port" or "jax")."""
    if package == "jax":
        kw.update(module=JAX_MODULE,
                  env=dict(os.environ, PADDLE_TPU_LIGHT_IMPORT="1"))
    return svc.start_servers(n, str(workdir), **kw)


def stop(client, procs):
    client.shutdown_servers()
    client.close()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


@contextlib.contextmanager
def cluster_of(n, workdir, package="port", client_cls=None, **kw):
    """A client on ``n`` fresh servers; shut down after."""
    procs, eps = start(n, workdir, package, **kw)
    client = (client_cls or svc.PSClient)(eps)
    client._procs = procs
    try:
        yield client
    finally:
        stop(client, client._procs)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{"port": PSClient on 2 port servers, "jax": on 2 JAX servers}."""
    build_native()
    tmp = tmp_path_factory.mktemp("ps_service")
    with cluster_of(2, tmp / "port") as port, \
            cluster_of(2, tmp / "jax", "jax") as jax_:
        yield {"port": port, "jax": jax_}


@pytest.fixture()
def cluster(clusters):
    return clusters["port"]


class TestPSService:
    def test_pull_push_convergence(self, cluster):
        """Rows converge to targets through pull / push adagrad alone."""
        V, D = 40, 8
        cluster.create_table(0, V, D, seed=3)
        rng = np.random.default_rng(0)
        target = rng.standard_normal((V, D)).astype(np.float32)

        def mse():
            rows = cluster.pull_sparse(0, np.arange(V))
            return float(((rows - target) ** 2).mean())

        first = mse()
        for _ in range(300):
            ids = rng.integers(0, V, 64)
            rows = cluster.pull_sparse(0, ids)
            cluster.push_sparse(0, ids, rows - target[ids], lr=0.5)
        last = mse()
        assert last < first * 0.01, (first, last)

    def test_duplicate_ids_merge_server_side(self, cluster):
        V, D = 8, 4
        cluster.create_table(1, V, D, seed=1)
        before = cluster.pull_sparse(1, np.array([3]))
        # 4 duplicate grads of ones: ONE adagrad step with the summed grad
        cluster.push_sparse(1, np.array([3, 3, 3, 3]),
                            np.ones((4, D), np.float32), lr=0.1)
        after = cluster.pull_sparse(1, np.array([3]))
        np.testing.assert_allclose(before - after, np.full((1, D), 0.1),
                                   rtol=1e-4)

    def test_dense_params(self, cluster):
        w = np.arange(6, dtype=np.float32)
        cluster.push_dense("w", w)
        np.testing.assert_array_equal(cluster.pull_dense("w"), w)
        cluster.push_dense("w", np.ones(6, np.float32), grad=True, lr=0.5)
        np.testing.assert_allclose(cluster.pull_dense("w"), w - 0.5)

    def test_save_load_round_trip(self, cluster, tmp_path):
        V, D = 16, 4
        cluster.create_table(2, V, D, seed=7)
        rows = cluster.pull_sparse(2, np.arange(V))
        d = str(tmp_path / "snap")
        cluster.save(d)
        cluster.push_sparse(2, np.arange(V), np.ones((V, D), np.float32))
        assert not np.allclose(cluster.pull_sparse(2, np.arange(V)), rows)
        cluster.load(d)
        np.testing.assert_array_equal(cluster.pull_sparse(2, np.arange(V)),
                                      rows)

    def test_async_communicator_batches(self, cluster):
        V, D = 12, 4
        cluster.create_table(3, V, D, seed=5)
        rng = np.random.default_rng(1)
        target = rng.standard_normal((V, D)).astype(np.float32)
        comm = svc.AsyncCommunicator(cluster, flush_interval=0.005)
        for _ in range(200):
            ids = rng.integers(0, V, 32)
            rows = cluster.pull_sparse(3, ids)
            comm.push_sparse(3, ids, rows - target[ids], lr=0.5)
        comm.stop()  # flushes
        rows = cluster.pull_sparse(3, np.arange(V))
        assert float(((rows - target) ** 2).mean()) < 0.05

    def test_barrier_and_stat(self, cluster):
        assert cluster.barrier("b0", world=1, timeout=10)
        st = cluster.stat()
        assert len(st) == 2 and st[0]["server_idx"] == 0

    def test_geo_async_two_workers_converge(self, cluster):
        """Both workers train on local caches, sync deltas every k steps;
        the server's merged rows converge (additive delta merge)."""
        V, D = 20, 4
        cluster.create_table(7, V, D, seed=11)
        rng = np.random.default_rng(2)
        target = rng.standard_normal((V, D)).astype(np.float32)
        w1 = svc.GeoCommunicator(cluster, tid=7, k_steps=5)
        w2 = svc.GeoCommunicator(cluster, tid=7, k_steps=5)
        for _ in range(400):
            for w in (w1, w2):
                ids = rng.integers(0, V, 16)
                rows = w.pull(ids)
                w.push(ids, rows - target[ids], lr=0.25)
        w1.sync()
        w2.sync()
        rows = cluster.pull_sparse(7, np.arange(V))
        assert float(((rows - target) ** 2).mean()) < 0.05


class TestSSD:
    def test_ssd_table_persists_across_restart(self, tmp_path):
        """The mmap-backed shard keeps its rows through a restart of both
        server processes without an explicit save."""
        build_native()
        ssd = str(tmp_path / "ssd")
        V, D = 24, 4
        with cluster_of(2, tmp_path, ssd_dir=ssd) as c:
            c.create_table(0, V, D, seed=9, storage="ssd")
            target = np.random.default_rng(5).standard_normal(
                (V, D)).astype(np.float32)
            for _ in range(100):
                rows = c.pull_sparse(0, np.arange(V))
                c.push_sparse(0, np.arange(V), rows - target, lr=0.5)
            trained = c.pull_sparse(0, np.arange(V))
            c.save(str(tmp_path / "unused"))  # msyncs the mmap
        with cluster_of(2, tmp_path, ssd_dir=ssd) as c2:
            c2.create_table(0, V, D, seed=123, storage="ssd")  # reopens
            np.testing.assert_array_equal(c2.pull_sparse(0, np.arange(V)),
                                          trained)

    def test_ssd_reopen_shape_mismatch_rejected(self, tmp_path):
        build_native()
        ssd = str(tmp_path / "ssd")
        with cluster_of(1, tmp_path, ssd_dir=ssd) as c:
            c.create_table(0, 16, 4, storage="ssd")
        with cluster_of(1, tmp_path, ssd_dir=ssd) as c2:
            with pytest.raises(RuntimeError, match="mmap"):
                c2.create_table(0, 16, 8, storage="ssd")   # dim changed


def _sequence(client, tid, snap):
    """One create / pull / push / delta / dense / save run; returns the
    pulls and the dense value."""
    V, D = 41, 8
    rng = np.random.default_rng(0)
    client.create_table(tid, V, D, seed=5)
    out = [client.pull_sparse(tid, np.arange(V))]
    for _ in range(4):
        ids = rng.integers(0, V, 30)         # duplicates
        client.push_sparse(tid, ids, rng.standard_normal(
            (30, D)).astype(np.float32), lr=0.3)
    out.append(client.pull_sparse(tid, rng.integers(0, V, 17)))
    client.push_sparse_delta(tid, np.array([1, 2, 40]), np.full(
        (3, D), 0.25, np.float32))
    out.append(client.pull_sparse(tid, np.arange(V)))
    key = f"dense{tid}"
    client.push_dense(key, np.linspace(0, 1, 7, dtype=np.float32))
    client.push_dense(key, np.ones(7, np.float32), grad=True, lr=0.125)
    out.append(client.pull_dense(key))
    client.save(snap)
    return out


@pytest.fixture(scope="module")
def wire_runs(clusters, tmp_path_factory):
    """The sequence under every mix of client and server packages, each
    on a table id of its own: {(client, servers): (pulls, snapshot)}."""
    tmp = tmp_path_factory.mktemp("wire")
    jax_clients = {name: jsvc.PSClient(c.endpoints)
                   for name, c in clusters.items()}
    runs = {}
    for tid, (cl, srv) in enumerate([("port", "jax"), ("jax", "port"),
                                     ("port", "port"), ("jax", "jax")], 20):
        client = clusters[srv] if cl == "port" else jax_clients[srv]
        snap = str(tmp / f"{cl}_on_{srv}")
        runs[(cl, srv)] = (tid, _sequence(client, tid, snap), snap)
    yield runs
    for c in jax_clients.values():
        c.close()


def test_wire_twins_pull_bit_equal(wire_runs):
    """A port client on JAX servers, a JAX client on port servers, each
    package on its own: every pull and the dense value bit-equal."""
    (_, want, _), *others = wire_runs.values()
    for (_, got, _), mix in zip(others, list(wire_runs)[1:]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(mix))


def test_wire_twins_saved_tables_byte_equal(wire_runs):
    """The snapshot files the two packages' servers write for the same
    sequence are byte-equal, shard by shard."""
    blobs = {}
    for mix, (tid, _, snap) in wire_runs.items():
        blobs[mix] = [open(os.path.join(snap, f"table_{tid}.shard{s}"),
                           "rb").read() for s in range(2)]
    first = next(iter(blobs.values()))
    # [rows, dim] u64 header, rows x 8 floats, rows accumulators
    assert [len(b) for b in first] == [16 + 21 * 9 * 4, 16 + 20 * 9 * 4]
    for mix, b in list(blobs.items())[1:]:
        assert b == first, mix


def test_frames_decode_across_packages():
    """One op table; each package's frame decodes in the other (an npz
    body with a JSON meta, no pickle)."""
    assert svc.OPS == jsvc.OPS
    arrays = {"ids": np.arange(5, dtype=np.int64),
              "grads": np.ones((5, 3), np.float32)}
    for pack, unpack in ((svc._pack, jsvc._unpack), (jsvc._pack, svc._unpack)):
        op, meta, got = unpack(pack("push", {"tid": 3, "lr": 0.5}, arrays))
        assert op == "push" and meta == {"tid": 3, "lr": 0.5}
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])


def test_launch_servers_and_workers(tmp_path):
    """``launch --server_num 2 --worker_num 2``: a PS pod of the port's
    table servers and two trainers (reference ParameterServerLauncher)."""
    build_native()
    script = tmp_path / "worker.py"
    script.write_text(
        "import os\n"
        "import numpy as np\n"
        "from paddle_tpu_torch.distributed.ps_service import PSClient\n"
        "from paddle_tpu_torch.distributed.role_maker import "
        "PaddleCloudRoleMaker\n"
        "rm = PaddleCloudRoleMaker(is_collective=False)\n"
        "assert rm.is_worker() and rm.server_num() == 2\n"
        "c = rm.ps_client()\n"
        "c.create_table(0, 20, 4, seed=1)\n"
        "c.barrier('ready', rm.worker_num())\n"
        "ids = np.arange(20)\n"
        "rows = c.pull_sparse(0, ids)\n"
        "c.push_sparse(0, ids, np.ones_like(rows), lr=0.1)\n"
        "after = c.pull_sparse(0, ids)\n"
        "assert not np.allclose(rows, after)\n"
        "print(f'worker {rm.worker_index()} ok')\n")
    log_dir = tmp_path / "logs"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--server_num", "2", "--worker_num", "2",
         "--log_dir", str(log_dir), str(script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    logs = sorted(os.listdir(log_dir))
    assert "server.0.log" in logs and "worker.1.log" in logs
    assert "worker 1 ok" in (log_dir / "worker.1.log").read_text()
