"""Tree speculation's offline functions in the port (paddle_tpu_torch/
text/generate.py ``tree_depths``, ``tree_ancestor_mask``,
``ngram_propose_tree``, ``tree_verify_chunk_batched``,
``tree_commit_rows``; text/kv_pool.py ``paged_tree_verify_chunk_batched``
and ``paged_tree_commit``) against the JAX package on the same numpy
inputs, on the CPU:

* depths and ancestor masks of random topological trees, and the
  reference suite's hand-checked tree: equal;
* ``ngram_propose_tree``: equal to the reference's, the ``None`` cases
  included;
* the tree verify at per-slot positions over a randomly filled cache,
  random trees padded with self-only rows, contiguous and paged (shuffled
  block tables), fp32 and int8 KV, learned and rope positions, MHA and
  GQA: logits within 1e-5 of JAX's, the written rows within 1e-6 (the
  projections sum in another order; int8: values within one quantization
  step, scales within 1e-6 relative); rows it does not write keep their
  bits;
* a chain tree is bit-equal to the port's ``verify_chunk_batched`` in
  fp32 (the claim of the reference's docstring), both layouts; the
  single-offset ``tree_verify_chunk`` against JAX's;
* the row permute on both layouts: equal to the reference's.

Models are the reference suite's random one (vocab 32, 2 layers) in fp32
in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import kv_pool as JKV
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import kv_pool


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(seed, **over):
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _parent(rng, n):
    """A random topological parent list of n nodes (node 0 the root)."""
    return [-1] + [int(rng.integers(0, j)) for j in range(1, n)]


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def test_depths_and_ancestor_mask_oracle():
    """The reference suite's hand-checked tree: node 4 under 3, node 5
    under 1."""
    parent = [-1, 0, 1, 0, 3, 1]
    assert list(G.tree_depths(parent)) == [0, 1, 2, 1, 2, 2]
    want = np.zeros((6, 6), bool)
    for j, path in enumerate([[0], [0, 1], [0, 1, 2], [0, 3], [0, 3, 4],
                              [0, 1, 5]]):
        want[j, path] = True
    np.testing.assert_array_equal(G.tree_ancestor_mask(parent), want)


@pytest.mark.parametrize("seed", range(3))
def test_depths_and_ancestor_mask_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 4, 7, 12):
        parent = _parent(rng, n)
        d = G.tree_depths(parent)
        assert d.dtype == np.int32
        np.testing.assert_array_equal(d, JG.tree_depths(parent))
        np.testing.assert_array_equal(G.tree_ancestor_mask(parent),
                                      JG.tree_ancestor_mask(parent))


@pytest.mark.parametrize("seq,nodes,kw", [
    ([7, 3, 9, 7, 3, 5, 7, 3], 6, {}),             # trunk + a root branch
    ([5, 9, 5, 9, 5, 9], 5, {}),                   # one continuation
    ([1, 2, 1, 3, 1, 4, 1, 2], 7, dict(branch=3)),  # three continuations
    ([1, 2, 1, 3, 1, 4, 1, 2], 3, dict(branch=3)),  # a budget too tight
    ([4, 4, 4, 4], 6, dict(max_order=1)),
    ([1, 2, 3, 4, 5], 4, {}),                      # no earlier match
    ([7], 4, {}),                                  # too short
    ([5, 9, 5, 9], 1, {}),                         # no token-bearing slot
    ([1, 2] + [9] * 300 + [1, 2], 4, dict(window=64)),
    ([1, 2] + [9] * 300 + [1, 2], 4, dict(window=512))],
    ids=["branch", "chain", "three", "tight", "order1", "miss", "short",
         "one_node", "window64", "window512"])
def test_ngram_propose_tree_matches_jax(seq, nodes, kw):
    got = G.ngram_propose_tree(seq, nodes, **kw)
    want = JG.ngram_propose_tree(seq, nodes, **kw)
    assert got == (None if want is None else (list(want[0]),
                                               list(want[1])))
    if got is not None:
        tokens, parent = got
        assert tokens[0] is None and parent[0] == -1
        assert len(tokens) <= nodes
        assert all(parent[j] < j for j in range(1, len(parent)))


# ---------------------------------------------------------------------------
# the tree verify against JAX
# ---------------------------------------------------------------------------


def _trees(rng, B, N, vocab, feed):
    """Random trees of 2..N nodes a slot, padded to N with self-only rows
    at depth 0 (the server's idle rows): (tokens, amask, depth)."""
    tokens = np.repeat(feed[:, None], N, axis=1)
    amask = np.zeros((B, N, N), bool)
    amask[:, np.arange(N), np.arange(N)] = True
    depth = np.zeros((B, N), np.int32)
    for b in range(B):
        n = int(rng.integers(2, N + 1))
        parent = _parent(rng, n)
        tokens[b, 1:n] = rng.integers(0, vocab, n - 1)
        amask[b, :n, :n] = G.tree_ancestor_mask(parent)
        depth[b, :n] = G.tree_depths(parent)
    return tokens, amask, depth


def _fill(rng, cfg, B, T, int8):
    shape = (cfg.num_layers, B, T, cfg.kv_heads, cfg.head_dim)
    if not int8:
        return {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    out = {n: rng.integers(-127, 128, shape).astype(np.int8)
           for n in ("k", "v")}
    for n in ("k_s", "v_s"):
        out[n] = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    return out


def _paged(fill, B, T, bs, perm, n_blocks, extra):
    """The pooled twin of a contiguous fill: slot b's logical block j in
    physical block perm[b * nmax + j]; ``extra`` more blocks at the end
    (the port's sink)."""
    nmax = T // bs
    pool = {}
    for n, v in fill.items():
        p = np.zeros((v.shape[0], n_blocks + extra, bs) + v.shape[3:],
                     v.dtype)
        for b in range(B):
            for j in range(nmax):
                p[:, perm[b * nmax + j]] = v[:, b, j * bs:(j + 1) * bs]
        pool[n] = p
    return pool


def _unpage(pool, B, T, bs, perm):
    nmax = T // bs
    return {n: np.stack([np.concatenate(
        [v[:, perm[b * nmax + j]] for j in range(nmax)], axis=1)
        for b in range(B)], 1) for n, v in pool.items()}


@pytest.mark.parametrize("layout,kv,over", [
    ("contiguous", "fp32", {}),
    ("contiguous", "int8", dict(pos_embed="rope", num_kv_heads=2)),
    ("paged", "fp32", dict(pos_embed="rope", num_kv_heads=2)),
    ("paged", "int8", {})],
    ids=["contiguous-fp32-learned", "contiguous-int8-rope-gqa",
         "paged-fp32-rope-gqa", "paged-int8-learned"])
def test_tree_verify_matches_jax(layout, kv, over, monkeypatch):
    """Three slots at positions 3, 11 and 6, N = 5 nodes, random trees:
    the port's batched tree verify against JAX's on the same cache —
    logits within 1e-5, the written rows within 1e-6 (int8: one
    quantization step, scales 1e-6 relative), every other row untouched.
    Paged: block size 8 with shuffled tables, so slot 1's rows 11..15
    cross into a second block."""
    int8 = kv == "int8"
    if int8:
        monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    jcfg, jp, cfg, params = _pair(2, **over)
    jp = jax.tree.map(jnp.asarray, jp)
    B, T, N, bs = 3, 24, 5, 8
    pos = np.array([3, 11, 6], np.int32)
    rng = np.random.default_rng(int8 + 2 * (layout == "paged"))
    fill = _fill(rng, cfg, B, T, int8)
    tokens, amask, depth = _trees(rng, B, N, cfg.vocab_size,
                                  rng.integers(0, cfg.vocab_size, B))
    args = (jnp.asarray(tokens, jnp.int32), jnp.asarray(amask),
            jnp.asarray(depth), jnp.asarray(pos))
    targs = (torch.from_numpy(tokens), torch.from_numpy(amask),
             torch.from_numpy(depth), torch.from_numpy(pos))
    if layout == "contiguous":
        jl, jc = JG.tree_verify_chunk_batched(
            jp, {n: jnp.asarray(v) for n, v in fill.items()}, *args, jcfg)
        cache = {n: torch.from_numpy(v.copy()) for n, v in fill.items()}
        logits, cache = G.tree_verify_chunk_batched(params, cache, *targs,
                                                    cfg)
        got = {n: v.numpy() for n, v in cache.items()}
        want = {n: np.asarray(v) for n, v in jc.items()}
    else:
        nb = B * T // bs
        perm = np.random.default_rng(1).permutation(nb)
        tables = perm.reshape(B, T // bs).astype(np.int32)
        jcache = {n: jnp.asarray(v) for n, v in
                  _paged(fill, B, T, bs, perm, nb, 0).items()}
        jcache["tables"] = jnp.asarray(tables)
        jl, jc = JKV.paged_tree_verify_chunk_batched(jp, jcache, *args,
                                                     jcfg)
        cache = {n: torch.from_numpy(v) for n, v in
                 _paged(fill, B, T, bs, perm, nb, 1).items()}
        cache["tables"] = torch.from_numpy(tables)
        logits, cache = kv_pool.paged_tree_verify_chunk_batched(
            params, cache, *targs, cfg)
        names = [n for n in fill]
        got = _unpage({n: cache[n].numpy() for n in names}, B, T, bs, perm)
        want = _unpage({n: np.asarray(jc[n]) for n in names}, B, T, bs,
                       perm)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for n, v in fill.items():
        if v.dtype == np.int8:
            # a row may quantize one step apart
            assert np.abs(got[n].astype(np.int32)
                          - want[n].astype(np.int32)).max() <= 1, n
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
        for b in range(B):
            outside = np.ones(T, bool)
            outside[pos[b]:pos[b] + N] = False
            assert np.array_equal(got[n][:, b, outside], v[:, b, outside])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chain_tree_is_the_linear_verify(layout):
    """A chain tree (every node's parent its predecessor) is the linear
    chunk: its logits and rows are ``verify_chunk_batched``'s bit for bit
    in fp32, at per-slot positions."""
    _, _, cfg, params = _pair(3)
    B, T, N = 2, 24, 4
    pos = torch.tensor([2, 9], dtype=torch.int32)
    rng = np.random.default_rng(5)
    fill = _fill(rng, cfg, B, T, False)
    tokens = torch.from_numpy(rng.integers(0, 32, (B, N)))
    parent = [-1] + list(range(N - 1))
    amask = torch.from_numpy(G.tree_ancestor_mask(parent)).expand(B, N, N)
    depth = torch.from_numpy(G.tree_depths(parent)).expand(B, N)
    out = []
    for tree in (False, True):
        if layout == "contiguous":
            cache = {n: torch.from_numpy(v.copy()) for n, v in fill.items()}
            fn = (lambda c: G.tree_verify_chunk_batched(
                params, c, tokens, amask, depth, pos, cfg)) if tree else \
                (lambda c: G.verify_chunk_batched(params, c, tokens, pos,
                                                  cfg))
        else:
            perm = np.random.default_rng(2).permutation(B * T // 8)
            cache = {n: torch.from_numpy(v) for n, v in
                     _paged(fill, B, T, 8, perm, B * T // 8, 1).items()}
            cache["tables"] = torch.from_numpy(
                perm.reshape(B, T // 8).astype(np.int32))
            fn = (lambda c: kv_pool.paged_tree_verify_chunk_batched(
                params, c, tokens, amask, depth, pos, cfg)) if tree else \
                (lambda c: kv_pool.paged_verify_chunk_batched(
                    params, c, tokens, pos, cfg))
        logits, cache = fn(cache)
        out.append((logits, cache))
    assert torch.equal(out[0][0], out[1][0])
    for n in fill:
        assert torch.equal(out[0][1][n], out[1][1][n])


def test_single_offset_tree_verify_matches_jax():
    """``tree_verify_chunk`` — one offset, one topology for the batch —
    against JAX's on the reference suite's sequence: logits within 1e-5,
    rows within 1e-6."""
    jcfg, jp, cfg, params = _pair(1, pos_embed="rope")
    jp = jax.tree.map(jnp.asarray, jp)
    parent = [-1, 0, 1, 0, 3]
    amask = G.tree_ancestor_mask(parent)[None]
    depth = G.tree_depths(parent)[None]
    tokens = np.array([[5, 3, 9, 1, 7]])
    fill = _fill(np.random.default_rng(4), cfg, 1, 16, False)
    jl, jc = JG.tree_verify_chunk(
        jp, {n: jnp.asarray(v) for n, v in fill.items()},
        jnp.asarray(tokens, jnp.int32), jnp.asarray(amask),
        jnp.asarray(depth), jnp.asarray(2), jcfg)
    cache = {n: torch.from_numpy(v.copy()) for n, v in fill.items()}
    logits, cache = G.tree_verify_chunk(
        params, cache, torch.from_numpy(tokens), torch.from_numpy(amask),
        torch.from_numpy(depth), 2, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for n in fill:
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the row permute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_commit_matches_jax(layout, monkeypatch):
    """Accepted paths off the trunk (slot 0: nodes 3, 4; slot 1: node 2
    then the trunk's identity; slot 2: identity) move their rows to
    [pos + 1, pos + N): the port's permute equals the reference's on an
    int8 cache (values and scale planes), both layouts; paged through
    shuffled tables with rows crossing a block."""
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    _, _, cfg, _ = _pair(4)
    B, T, N, bs = 3, 24, 5, 8
    pos = np.array([4, 10, 0], np.int32)
    src = np.array([[3, 4, 3, 4], [2, 2, 3, 4], [1, 2, 3, 4]], np.int32)
    fill = _fill(np.random.default_rng(7), cfg, B, T, True)
    if layout == "contiguous":
        want = JG.tree_commit_rows({n: jnp.asarray(v)
                                    for n, v in fill.items()},
                                   jnp.asarray(src), jnp.asarray(pos))
        cache = G.tree_commit_rows({n: torch.from_numpy(v.copy())
                                    for n, v in fill.items()},
                                   torch.from_numpy(src),
                                   torch.from_numpy(pos))
        got = {n: v.numpy() for n, v in cache.items()}
        want = {n: np.asarray(v) for n, v in want.items()}
    else:
        nb = B * T // bs
        perm = np.random.default_rng(3).permutation(nb)
        tables = perm.reshape(B, T // bs).astype(np.int32)
        jcache = {n: jnp.asarray(v) for n, v in
                  _paged(fill, B, T, bs, perm, nb, 0).items()}
        jcache["tables"] = jnp.asarray(tables)
        jc = JKV.paged_tree_commit(jcache, jnp.asarray(src),
                                   jnp.asarray(pos))
        cache = {n: torch.from_numpy(v) for n, v in
                 _paged(fill, B, T, bs, perm, nb, 1).items()}
        cache["tables"] = torch.from_numpy(tables)
        cache = kv_pool.paged_tree_commit(cache, torch.from_numpy(src),
                                          torch.from_numpy(pos))
        got = _unpage({n: cache[n].numpy() for n in fill}, B, T, bs, perm)
        want = _unpage({n: np.asarray(jc[n]) for n in fill}, B, T, bs,
                       perm)
    for n, v in fill.items():
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        # slot 0's rows 5, 6 now hold its old rows 7, 8
        np.testing.assert_array_equal(got[n][:, 0, 5:7], v[:, 0, 7:9])
    assert not np.array_equal(got["k"], fill["k"])
