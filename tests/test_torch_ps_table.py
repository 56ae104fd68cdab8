"""The port's device sparse tables (paddle_tpu_torch/distributed/ps.py)
against the JAX package's (paddle_tpu/distributed/ps.py), on the CPU —
twins of tests/test_ps.py's six cases, plus the carried state, the
sharded table over gloo ranks and checkpoints read across packages.

Tolerances: the merge, sgd and adagrad run the same fp32 operations in
the same order, so rows and accumulators are held within 1e-6 relative
(1e-7 absolute); only the 16-element sum of squares may round in another
order.  The initial rows are the port's counter-based draw, held to
JAX's by law (mean within 4 standard errors, std within 3%); every
comparison after a push starts from JAX's state carried across
(``convert.table_state_from_jax``).  The sharded table's ranks are gloo
processes (``distributed.spawn``, ``tools/ps_check.run_tables``), one
spawn a world size, started before JAX computes in this process.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.tools import ps_check

RTOL, ATOL = 1e-6, 1e-7
V, D = 64, 8
VM = 63      # VM + 1 rows divide by 1, 2, 4 and 8 shards alike


def mesh_of(n, name="mp"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def pushes(seed, n=6, batch=24, vocab=V, dim=D):
    """Push batches with duplicates (ids drawn from a third of the rows)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab // 3, batch).astype(np.int64),
             rng.standard_normal((batch, dim)).astype(np.float32))
            for _ in range(n)]


def host(state):
    return (np.asarray(state.rows), np.asarray(state.accum))


def assert_state(got, want, what):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL,
                               err_msg=what + " rows")
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL,
                               err_msg=what + " accum")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PULL = np.array([0, 17, 62, 17, 5])


def _rank_cases(tmp, world, state, jax_dir):
    return [
        # the JAX state carried across, the same pushes as the JAX mesh's
        {"vocab": VM, "dim": D, "optimizer": "adagrad", "lr": 0.5,
         "state": state, "device": "cpu", "pushes": pushes(1, vocab=VM),
         "pull_ids": PULL, "save_dir": str(tmp / f"port{world}")},
        # the port's own init: its shards are the one-card draw
        {"vocab": VM, "dim": D, "seed": 7, "device": "cpu"},
        # a JAX checkpoint (8-device mesh) read back on the ranks
        {"vocab": VM, "dim": D, "device": "cpu", "load_dir": jax_dir},
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn a world size (2 and 4 gloo ranks), on threads of their
    own while JAX computes the same in this process."""
    tmp = tmp_path_factory.mktemp("ps_ranks")
    jt = jps.SparseEmbeddingTable(VM, D, mesh=mesh_of(8), axis="mp",
                                  optimizer="adagrad", lr=0.5, seed=3)
    state = host(jt.state)
    jax_dir = str(tmp / "jax8")
    jt.save(jax_dir)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = {w: pool.submit(spawn.spawn, ps_check.run_tables,
                           (_rank_cases(tmp, w, state, jax_dir),), w, "cpu")
            for w in (2, 4)}
    for ids, g in pushes(1, vocab=VM):
        jt.push(ids, g)
    want = {"state": state, "after": host(jt.state),
            "pulls": np.asarray(jt.pull(PULL))}
    # rank 0's results per world size (every rank gathers the same rows)
    yield tmp, {w: f.result()[0] for w, f in futs.items()}, want, \
        {w: f.result() for w, f in futs.items()}
    pool.shutdown()


def test_merge_duplicate_ids():
    ids = np.asarray([5, 3, 5, 7, 3, 5], np.int64)
    g = np.arange(6, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    out_ids, merged = tps._merge_duplicate_ids(torch.from_numpy(ids),
                                               torch.from_numpy(g), 10)
    j_ids, j_merged = jps._merge_duplicate_ids(jnp.asarray(ids, jnp.int32),
                                               jnp.asarray(g), 10)
    got = {int(m): float(merged[i, 0]) for i, m in enumerate(out_ids)
           if m < 10}
    assert got == {3: 1.0 + 4.0, 5: 0.0 + 2.0 + 5.0, 7: 3.0}
    np.testing.assert_array_equal(out_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(j_merged))


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_push_sequence_matches_jax(opt):
    """Pushes with duplicates on JAX's state carried across: rows and
    accumulator after every push within 1e-6 relative of JAX's."""
    jt = jps.SparseEmbeddingTable(V, D, optimizer=opt, lr=0.1, seed=0)
    tt = tps.SparseEmbeddingTable(V, D, optimizer=opt, lr=0.1, seed=0,
                                  device="cpu")
    tt.set_state(convert.table_state_from_jax(jax.device_get(jt.state)))
    for i, (ids, g) in enumerate(pushes(0)):
        jt.push(ids, g)
        tt.push(ids, g)
        assert_state((tt.state.rows.numpy(), tt.state.accum.numpy()),
                     host(jt.state), f"{opt} push {i}")
    np.testing.assert_array_equal(tt.pull(np.array([2, 5, 2])).numpy(),
                                  np.asarray(jt.pull(np.array([2, 5, 2]))))


def test_pull_push_sgd_matches_dense():
    t = tps.SparseEmbeddingTable(16, 4, optimizer="sgd", lr=0.1, seed=0,
                                 device="cpu")
    dense = t.state.rows.numpy().copy()
    ids = np.asarray([2, 5, 2], np.int64)
    g = np.asarray(np.random.default_rng(0).normal(size=(3, 4)), np.float32)
    np.testing.assert_array_equal(t.pull(ids).numpy(), dense[ids])
    t.push(ids, g)
    want = dense.copy()
    for i, idx in enumerate(ids):
        want[idx] -= 0.1 * g[i]
    np.testing.assert_allclose(t.state.rows.numpy()[:16], want[:16],
                               rtol=1e-5, atol=1e-6)


def test_adagrad_denominator_grows():
    t = tps.SparseEmbeddingTable(8, 4, optimizer="adagrad", lr=1.0, seed=0,
                                 device="cpu")
    ids = np.asarray([1], np.int64)
    g = np.ones((1, 4), np.float32)
    r0 = t.state.rows[1].clone()
    t.push(ids, g)
    step1 = float((t.state.rows[1] - r0).abs().max())
    r1 = t.state.rows[1].clone()
    t.push(ids, g)
    step2 = float((t.state.rows[1] - r1).abs().max())
    assert step2 < step1      # the accumulator damps later updates
    assert float(t.state.accum[2]) == 0.0


def test_init_by_law_and_layout():
    """The port's draw against JAX's by law; V + 1 rows padded to the
    shard count, every row past V zero, the accumulator zero."""
    vocab, dim = 4096, 16
    jt = jps.SparseEmbeddingTable(vocab, dim, initializer_std=0.01, seed=0)
    tt = tps.SparseEmbeddingTable(vocab, dim, initializer_std=0.01, seed=0,
                                  device="cpu")
    assert tt.rows_total == jt._rows_total == vocab + 1
    got, want = tt.state.rows.numpy()[:vocab], np.asarray(jt.state.rows)[
        :vocab]
    se = 0.01 / np.sqrt(got.size)
    assert abs(got.mean()) < 4 * se and abs(want.mean()) < 4 * se
    assert abs(got.std() / want.std() - 1) < 0.03
    assert not tt.state.rows[vocab:].any() and not tt.state.accum.any()


def test_sharded_table_over_ranks_matches_jax_mesh(ranks):
    """2 and 4 gloo ranks against JAX's 8-device mesh table after the same
    pushes: the gathered rows, accumulator and a pull of replicated ids;
    the ranks' own init equal to the one-card draw."""
    _, _, want, all_ranks = ranks
    one_card = tps.SparseEmbeddingTable(VM, D, seed=7, device="cpu")
    for world, per_rank in all_ranks.items():
        for r, (carried, own, _) in enumerate(per_rank):
            assert carried["rows_local"] == (VM + 1) // world
            assert_state((carried["rows"], carried["accum"]), want["after"],
                         f"{world} ranks, rank {r}")
            np.testing.assert_array_equal(carried["pulls"], want["pulls"])
            np.testing.assert_array_equal(own["rows"],
                                          one_card.state.rows.numpy())


@pytest.mark.parametrize("world", [1, 2])
def test_checkpoints_load_across_packages(ranks, tmp_path, world):
    """A JAX save (8-device mesh, 8 chunks) read by the port on 1 and 2
    ranks, and the port's save (1 and 2 ranks) read by JAX, whole and on
    its 8-device mesh — bit for bit (VM + 1 = 64 rows in every layout)."""
    tmp, outs, want, _ = ranks
    if world == 1:
        tt = tps.SparseEmbeddingTable(VM, D, seed=1, device="cpu")
        tt.load(str(tmp / "jax8"))
        np.testing.assert_array_equal(tt.state.rows.numpy(), want["state"][0])
        np.testing.assert_array_equal(tt.state.accum.numpy(),
                                      want["state"][1])
        tt.push(*pushes(1, vocab=VM)[0])
        port_dir = str(tmp_path / "port1")
        tt.save(port_dir)
        saved = (tt.state.rows.numpy(), tt.state.accum.numpy())
    else:
        loaded = outs[2][2]
        np.testing.assert_array_equal(loaded["rows"], want["state"][0])
        port_dir = str(tmp / "port2")
        saved = (outs[2][0]["rows"], outs[2][0]["accum"])
    for mesh in (None, mesh_of(8)):
        jt = jps.SparseEmbeddingTable(VM, D, mesh=mesh, axis="mp", seed=2)
        jt.load(port_dir)
        np.testing.assert_array_equal(np.asarray(jt.state.rows), saved[0])
        np.testing.assert_array_equal(np.asarray(jt.state.accum), saved[1])


def test_the_one_ps_save_load(tmp_path):
    ps = tps.TheOnePS(device="cpu")
    ps.create_table(0, 32, 4, optimizer="sgd", lr=0.1)
    ids = np.asarray([1, 2], np.int64)
    ps.push_sparse(0, ids, np.ones((2, 4), np.float32))
    want = ps.table(0).state.rows.clone()
    ps.save(str(tmp_path))
    ps2 = tps.TheOnePS(device="cpu")
    ps2.create_table(0, 32, 4, optimizer="sgd", lr=0.1, seed=99)
    ps2.load(str(tmp_path))
    assert torch.equal(ps2.table(0).state.rows, want)
    # and the JAX package's TheOnePS reads the same directory
    jps_ = jps.TheOnePS()
    jps_.create_table(0, 32, 4, optimizer="sgd", lr=0.1, seed=5)
    jps_.load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jps_.table(0).state.rows),
                                  want.numpy())


def test_lookup_and_grad_matches_jax():
    """The embedding handshake: torch autograd's d_emb and the pushed rows
    against ``jax.value_and_grad`` on the carried state."""
    jt = jps.SparseEmbeddingTable(32, 4, optimizer="sgd", lr=0.1, seed=0)
    tt = tps.SparseEmbeddingTable(32, 4, optimizer="sgd", lr=0.1, seed=0,
                                  device="cpu")
    tt.set_state(convert.table_state_from_jax(jax.device_get(jt.state)))
    ids = np.asarray([3, 9, 3], np.int64)
    w = np.linspace(0.5, 1.5, 4, dtype=np.float32)[:, None]
    jemb, jpush = jt.lookup_and_grad_fn(jnp.asarray(ids, jnp.int32))
    jloss, jd = jax.value_and_grad(
        lambda e: jnp.sum((e @ jnp.asarray(w)) ** 2))(jemb)
    emb, push = tt.lookup_and_grad_fn(ids)
    loss = torch.sum((emb @ torch.from_numpy(w)) ** 2)
    (d,) = torch.autograd.grad(loss, emb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    before = tt.state.rows.clone()
    jpush(jd)
    push(d)
    assert_state((tt.state.rows.numpy(), tt.state.accum.numpy()),
                 host(jt.state), "lookup push")
    assert not torch.equal(tt.state.rows[3], before[3])
    assert torch.equal(tt.state.rows[4], before[4])


def test_table_state_from_jax_gives_equal_pulls():
    """A JAX mesh table's state (72 rows: V + 1 padded to 8 shards)
    carried to a port table (65 rows) pulls the same rows bit for bit."""
    jt = jps.SparseEmbeddingTable(V, D, mesh=mesh_of(8), axis="mp", seed=4)
    for ids, g in pushes(2, n=2):
        jt.push(ids, g)
    st = convert.table_state_from_jax(jax.device_get(jt.state))
    assert st.rows.shape == (72, D) and st.rows.dtype == torch.float32
    tt = tps.SparseEmbeddingTable(V, D, seed=0, device="cpu").set_state(st)
    ids = np.arange(V)
    np.testing.assert_array_equal(tt.pull(ids).numpy(),
                                  np.asarray(jt.pull(ids)))
    np.testing.assert_array_equal(tt.state.accum.numpy()[:V],
                                  np.asarray(jt.state.accum)[:V])


def test_entry_points_run_on_the_card_unless_asked():
    """Without a card, a device table, ``TheOnePS`` and a ``HeterTrainer``
    asked for no device raise; none moves to the CPU on its own."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.heter import HeterTrainer

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tps.SparseEmbeddingTable(8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tps.TheOnePS().create_table(0, 8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeterTrainer(None, 0, 4, {"w": torch.zeros(4, 2)}, None,
                     optimizer.Adam())
