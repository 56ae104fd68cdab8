"""DGC and LocalSGD (paddle_tpu_torch/distributed/fleet/comm_opt.py)
against the JAX package's (paddle_tpu/distributed/fleet/comm_opt.py).

* the reference's three cases (tests/test_comm_opt.py:18-70) in the port:
  the density and error feedback on one process, the axis forms on 4
  gloo CPU ranks (``distributed.spawn``) where JAX runs ``shard_map`` on
  its 4-device CPU mesh;
* ``dgc_compress`` three rounds against JAX's on the same dict tree of
  grads (a stacked [L, ...] leaf, a matrix, a leaf with ties at the
  threshold): sends, u and v bit-equal in fp32, density ≤ 1 - sparsity
  but for ties, which both keep;
* the axis form (means of the sends over dp) on 4 ranks against JAX's
  within 1e-6 relative (the order of the sum differs), u and v
  bit-equal;
* ``LocalSGD(k_steps=4)`` over 8 steps on 4 ranks against JAX's
  ``maybe_average`` under ``shard_map``, and the all-reduces counted: one
  a leaf on each of the 2 sync steps, none on the 6 others.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.distributed.fleet import comm_opt as jco
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.fleet import comm_opt as tco

from test_torch_hybrid import ranks_in_background

WORLD = 4
SPARSITY, MOMENTUM = 0.9, 0.9
ROUNDS = 3
AXIS_RTOL = 1e-6
K_STEPS, SGD_STEPS = 4, 8


def mesh_of(n, name="dp"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def grads_tree(rng, lead=()):
    """A dict tree of fp32 grads: GPT-like stacked and plain leaves and a
    leaf whose 15 largest |g| tie (k = 10 of its 100)."""
    tie = rng.standard_normal(lead + (100,)).astype(np.float32) * 0.1
    tie[..., :15] = 3.0
    return {"blocks": {"fc_w": rng.standard_normal(
                lead + (3, 16, 64)).astype(np.float32)},
            "wte": rng.standard_normal(lead + (100, 8)).astype(np.float32),
            "tie": tie}


def tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.fixture(scope="module")
def ranks():
    """The port's axis cases on 4 gloo ranks, started before JAX runs."""
    rng = np.random.default_rng(1)
    g = grads_tree(rng, (WORLD,))
    params = {"w": rng.standard_normal((WORLD, 3, 5)).astype(np.float32),
              "b": rng.standard_normal((WORLD, 7)).astype(np.float32)}
    deltas = [tmap(lambda p: (0.1 * rng.standard_normal(p.shape))
                   .astype(np.float32), params) for _ in range(SGD_STEPS)]
    cases = [{"kind": "dgc", "mesh": {"dp": WORLD}, "device": "cpu",
              "grads": g, "sparsity": SPARSITY, "momentum": MOMENTUM,
              "rounds": 2},
             {"kind": "dgc", "mesh": {"dp": WORLD}, "device": "cpu",
              "grads": {"w": np.stack([np.full(8, float(i), np.float32)
                                       for i in range(WORLD)])},
              "sparsity": 0.0, "momentum": 0.0, "rounds": 1},
             {"kind": "localsgd", "mesh": {"dp": WORLD}, "device": "cpu",
              "params": params, "deltas": deltas, "k_steps": K_STEPS,
              "steps": SGD_STEPS}]
    fut = ranks_in_background(cases, WORLD)
    return g, params, deltas, fut


def test_dgc_sparsity_and_error_feedback():
    """tests/test_comm_opt.py:18 in the port."""
    params = {"w": torch.zeros(100)}
    st = tco.dgc_init(params)
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=100),
                              dtype=torch.float32)}
    send, st = tco.dgc_compress(g, st, sparsity=0.9, momentum=0.0)
    assert int((send["w"] != 0).sum()) <= 10 + 1
    np.testing.assert_allclose((send["w"] + st.v["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)
    total_sent = send["w"].clone()
    for _ in range(5):
        send, st = tco.dgc_compress(g, st, sparsity=0.9, momentum=0.0)
        total_sent += send["w"]
    np.testing.assert_allclose((total_sent + st.v["w"]).numpy(),
                               6 * g["w"].numpy(), atol=1e-4)


def test_dgc_rounds_bit_equal_to_jax():
    g = grads_tree(np.random.default_rng(0))
    jg = tmap(jnp.asarray, g)
    tg = tmap(torch.as_tensor, g)
    js, ts = jco.dgc_init(jg), tco.dgc_init(tg)
    for r in range(ROUNDS):
        jsend, js = jco.dgc_compress(jg, js, sparsity=SPARSITY,
                                     momentum=MOMENTUM)
        tsend, ts = tco.dgc_compress(tg, ts, sparsity=SPARSITY,
                                     momentum=MOMENTUM)
        for what, a, b in (("send", jsend, tsend), ("u", js.u, ts.u),
                           ("v", js.v, ts.v)):
            for path, x in leaves(a):
                assert bits_equal(x, get(b, path).numpy()), (r, what, path)
        for path, s in leaves(tsend):
            n = s.numel()
            k = max(1, int(n * (1.0 - SPARSITY)))
            kept = int((s != 0).sum())
            if path == ("tie",):
                assert kept == 15 > k      # every tie at the threshold
            else:
                assert kept <= k, (path, kept, k)


def test_dgc_state_from_jax_resumes_bit_equal():
    """A JAX DGCState carried into the port (``convert.
    dgc_state_from_jax``) gives the next round bit for bit."""
    g = grads_tree(np.random.default_rng(2))
    jg = tmap(jnp.asarray, g)
    js = jco.dgc_init(jg)
    _, js = jco.dgc_compress(jg, js, sparsity=SPARSITY, momentum=MOMENTUM)
    ts = convert.dgc_state_from_jax(jax.device_get(js))
    jsend, js = jco.dgc_compress(jg, js, sparsity=SPARSITY,
                                 momentum=MOMENTUM)
    tsend, ts = tco.dgc_compress(tmap(torch.as_tensor, g), ts,
                                 sparsity=SPARSITY, momentum=MOMENTUM)
    for path, x in leaves(jsend):
        assert bits_equal(x, get(tsend, path).numpy()), path
    for path, x in leaves(js.v):
        assert bits_equal(x, get(ts.v, path).numpy()), path


def _jax_axis_dgc(g, sparsity, momentum, rounds):
    mesh = mesh_of(WORLD)
    spec = tmap(lambda _: P("dp"), g)

    def f(gi):
        gi = tmap(lambda x: x[0], gi)
        st = jco.dgc_init(gi)
        out = []
        for _ in range(rounds):
            send, st = jco.dgc_compress(gi, st, sparsity=sparsity,
                                        momentum=momentum, axis="dp")
            out.append({"send": send, "u": st.u, "v": st.v})
        return jax.tree_util.tree_map(lambda x: x[None], out)

    out_spec = [{"send": spec, "u": spec, "v": spec}] * rounds
    return jax.device_get(shard_map(
        f, mesh=mesh, in_specs=(spec,), out_specs=out_spec,
        check_vma=False)(tmap(jnp.asarray, g)))


def test_dgc_allreduce_over_axis(ranks):
    """tests/test_comm_opt.py:39 in the port: the sends' mean over dp."""
    got = ranks[3].result()[1]
    np.testing.assert_allclose(got[0]["send"]["w"], np.full(8, 1.5),
                               atol=1e-6)


def test_dgc_axis_form_matches_jax(ranks):
    g = ranks[0]
    ref = _jax_axis_dgc(g, SPARSITY, MOMENTUM, 2)
    got = ranks[3].result()[0]
    for r in range(2):
        for what in ("send", "u", "v"):
            for path, x in leaves(ref[r][what]):
                want = np.asarray(x)[0]        # rank 0's block
                have = get(got[r][what], path)
                if what == "send":
                    err = np.abs(have - want).max()
                    assert err <= AXIS_RTOL * np.abs(want).max(), (r, path)
                else:
                    assert bits_equal(want, have), (r, what, path)
        n_leaves = len(list(leaves(g)))
        assert got[r]["comm"]["all_reduce"]["calls"] == n_leaves


def test_localsgd_periodic_sync_matches_jax(ranks):
    """tests/test_comm_opt.py:53 in the port, over 8 steps at k = 4: the
    params after every step equal JAX's ``maybe_average`` under
    shard_map, and only the sync steps all-reduce (one call a leaf)."""
    _, params, deltas, fut = ranks
    got = fut.result()[2]
    mesh = mesh_of(WORLD)
    sync = jco.LocalSGD(k_steps=K_STEPS, axis="dp")
    spec = tmap(lambda _: P("dp"), params)
    p = tmap(jnp.asarray, params)
    n_leaves = len(params)
    for step in range(1, SGD_STEPS + 1):
        p = {k: p[k] + deltas[step - 1][k] for k in p}
        p = shard_map(lambda pi, s=step: tmap(
            lambda x: x[None], sync.maybe_average(
                tmap(lambda x: x[0], pi), s)),
            mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False)(p)
        for k in params:
            np.testing.assert_allclose(got[step - 1]["params"][k],
                                       np.asarray(p[k])[0], rtol=1e-6,
                                       atol=1e-7)
        want_calls = n_leaves if step % K_STEPS == 0 else 0
        assert got[step - 1]["all_reduce"] == want_calls, step
    assert sum(s["all_reduce"] for s in got) == \
        n_leaves * SGD_STEPS // K_STEPS
