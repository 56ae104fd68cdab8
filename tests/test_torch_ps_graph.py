"""The port's graph table and neighbour-sampling service (ps.
DistributedGraphTable over ps_service's ``g_*`` ops and csrc/host/
ps_table.cpp's ``pgt_*``) — twins of tests/test_ps_graph.py's eleven
cases, and the samples held against the JAX package's.

Two port servers serve the whole module (test_torch_ps_service.py's
helpers), each test on a graph table of its own; edges shard src % 2, so
both parities cross servers.  The twin builds the same graph from the
same seed on the port's servers through the port's client and on the
JAX package's servers through its client: each server's sampler is one
mt19937_64 seeded ``seed * 1000 + server + 1`` (one source), so the
draws are equal; the node mix's multinomial draws from numpy's global
generator, seeded alike before each call.
"""
import itertools

import numpy as np
import pytest

from paddle_tpu.distributed.ps import DistributedGraphTable as JGraph
from paddle_tpu.distributed.ps_service import PSClient as JClient
from paddle_tpu_torch.distributed.ps import DistributedGraphTable
from test_torch_ps_service import build_native, cluster_of

_TIDS = itertools.count(100)

# node 0 (even shard) -> 4 neighbours; node 1 (odd shard) -> 2; node 3 -> 1;
# node 10 exists only as a dst (degree 0)
EDGES = [(0, 1), (0, 2), (0, 3), (0, 10), (1, 0), (1, 2), (3, 5)]


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    build_native()
    tmp = tmp_path_factory.mktemp("ps_graph")
    with cluster_of(2, tmp / "port") as port, \
            cluster_of(2, tmp / "jax", "jax", client_cls=JClient) as jax_:
        yield port, jax_


@pytest.fixture()
def graph(clients):
    return DistributedGraphTable(clients[0], tid=next(_TIDS), seed=3)


def _build(g, weights=None):
    g.add_edges([e[0] for e in EDGES], [e[1] for e in EDGES], weights)


class TestGraphTable:
    def test_degrees_and_stat(self, graph):
        _build(graph)
        np.testing.assert_array_equal(
            graph.degrees([0, 1, 3, 10, 99]), [4, 2, 1, 0, 0])
        st = graph.stat()
        assert st["num_edges"] == len(EDGES)
        assert st["num_nodes"] == 6          # 0, 1, 2, 3, 5, 10

    def test_sample_subset_and_padding(self, graph):
        _build(graph)
        out = graph.sample_neighbors([0, 1, 3, 10], k=3)
        assert out.shape == (4, 3)
        assert set(out[0]) <= {1, 2, 3, 10} and len(set(out[0])) == 3
        assert sorted(out[1]) == [-1, 0, 2]
        assert sorted(out[2]) == [-1, -1, 5]
        np.testing.assert_array_equal(out[3], [-1, -1, -1])

    def test_uniform_sampling_distribution(self, graph):
        _build(graph)
        counts = {1: 0, 2: 0, 3: 0, 10: 0}
        n_draw = 1500
        for _ in range(n_draw // 50):
            for row in graph.sample_neighbors([0] * 50, k=2):
                assert row[0] != row[1]      # without replacement
                for v in row:
                    counts[int(v)] += 1
        freq = np.array(list(counts.values())) / (n_draw * 2)
        np.testing.assert_allclose(freq, 0.25, atol=0.04)

    def test_weighted_sampling_distribution(self, graph):
        # node 0's edge to 1 weighs 3, the others 1: p(1) = 3/6 at k = 1
        _build(graph, weights=[3.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
        hits, n = 0, 1200
        for _ in range(n // 100):
            hits += int((graph.sample_neighbors([0] * 100, k=1) == 1).sum())
        assert abs(hits / n - 0.5) < 0.06, hits / n

    def test_random_nodes_cover_both_shards(self, graph):
        _build(graph)
        nodes = graph.random_nodes(400)
        assert len(nodes) == 400
        seen = set(int(v) for v in nodes)
        assert seen <= {0, 1, 2, 3, 5, 10}
        assert any(v % 2 == 0 for v in seen) and any(v % 2 for v in seen)
        freq = np.bincount(nodes, minlength=11)[[0, 1, 2, 3, 5, 10]] / 400
        np.testing.assert_allclose(freq, 1 / 6, atol=0.09)

    def test_save_load_roundtrip(self, graph, tmp_path):
        _build(graph)
        d = str(tmp_path / "gsnap")
        graph.client.save(d)
        graph.add_edges([0], [7])
        assert graph.degrees([0])[0] == 5
        graph.client.load(d)
        assert graph.degrees([0])[0] == 4
        assert graph.stat()["num_edges"] == len(EDGES)

    def test_node_features_roundtrip_sharded(self, graph):
        _build(graph)
        feats = (np.arange(24, dtype=np.float32).reshape(6, 4) + 1) / 7.0
        graph.set_node_feat(np.arange(6), feats)
        got, found = graph.get_node_feat([5, 0, 3, 2])
        assert found.all()
        np.testing.assert_array_equal(got, feats[[5, 0, 3, 2]])

    def test_sampled_neighborhood_comes_back_with_features(self, graph):
        _build(graph)
        feats = np.random.default_rng(0).standard_normal(
            (11, 3)).astype(np.float32)
        graph.set_node_feat(np.arange(11), feats)
        nbrs = graph.sample_neighbors(np.array([0, 1, 3, 10]), k=3)
        got, found = graph.get_node_feat(nbrs)
        assert got.shape == (4, 3, 3) and found.shape == (4, 3)
        for i, j in np.ndindex(*nbrs.shape):
            if nbrs[i, j] < 0:
                assert not found[i, j]
                np.testing.assert_array_equal(got[i, j], 0.0)
            else:
                assert found[i, j]
                np.testing.assert_array_equal(got[i, j], feats[nbrs[i, j]])

    def test_feature_dim_mismatch_is_loud(self, graph):
        _build(graph)
        graph.set_node_feat([0, 2], np.ones((2, 4), np.float32))
        with pytest.raises(RuntimeError, match="dim"):
            graph.set_node_feat([4], np.ones((1, 5), np.float32))

    def test_unknown_node_zero_fills(self, graph):
        _build(graph)
        graph.set_node_feat([0], np.full((1, 2), 3.5, np.float32))
        got, found = graph.get_node_feat([0, 999])
        assert found.tolist() == [True, False]
        np.testing.assert_array_equal(got[0], 3.5)
        np.testing.assert_array_equal(got[1], 0.0)

    def test_features_survive_save_load(self, graph, tmp_path):
        _build(graph)
        feats = np.random.default_rng(1).standard_normal(
            (6, 5)).astype(np.float32)
        graph.set_node_feat(np.arange(6), feats)
        d = str(tmp_path / "gsnap_feat")
        graph.client.save(d)
        graph.set_node_feat(np.arange(6), np.zeros((6, 5), np.float32))
        graph.client.load(d)
        got, found = graph.get_node_feat(np.arange(6))
        assert found.all()
        np.testing.assert_array_equal(got, feats)


def _draws(g):
    """The same calls in the same order: uniform and weighted neighbour
    samples, degrees, features of a sampled neighbourhood, node mixes."""
    _build(g, weights=[3.0, 1.0, 2.0, 1.0, 1.0, 1.0, 1.0])
    g.add_edges([4, 4, 6], [0, 1, 2])
    out = [g.sample_neighbors([0, 1, 3, 10, 4, 6] * 4, k=k) for k in (1, 2, 3)]
    out.append(g.degrees(np.arange(12)))
    g.set_node_feat(np.arange(8), np.arange(16, dtype=np.float32).reshape(
        8, 2))
    out += list(g.get_node_feat(out[1]))
    for _ in range(3):
        np.random.seed(0)
        out.append(g.random_nodes(50))
    return out


def test_samples_equal_the_jax_packages(clients):
    """The port's client on the port's servers and the JAX package's on
    its own, one graph from one seed: every draw equal."""
    port, jax_ = clients
    tid = next(_TIDS)
    got = _draws(DistributedGraphTable(port, tid=tid, seed=5))
    want = _draws(JGraph(jax_, tid=tid, seed=5))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"draw {i}")
