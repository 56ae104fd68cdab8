"""The port's Megatron primitives (paddle_tpu_torch/distributed/
megatron.py) and its tensor-parallel step without a pipeline, against
the JAX package's, on the CPU (the harness of ``test_torch_hybrid.py``:
gloo CPU ranks spawned from the JAX-free ``tools/hybrid_check.py``, JAX
on its 8-device mesh in this process).

* ``TestMegatronPrimitives``' four cases (tests/test_gpt_hybrid.py:
  36-107) at mp 2 and 4: the vocab-parallel embedding and the
  row-parallel linear against JAX's under ``shard_map`` (and the dense
  math), the vocab-parallel CE on both routes — kernels #6 / #7 (their
  plain twins on the CPU) through ``_VocabParallelCE`` and the
  reference's max / sum / pick — and its gradient against ``jax.grad``
  of JAX's sharded loss;
* 5-step AdamW trajectories at dp2 x mp2 (with and without a
  ``ClipGradByGlobalNorm`` that clips) and at dp4 x mp2 under ZeRO 1,
  against JAX's GSPMD steps: losses within rtol 2e-5 at every step,
  params by the share past lr/10;
* ``test_zero_shards_opt_state`` (:206): under ZeRO 1 at dp4 x mp2 the
  optimizer state the update sees has JAX's shard shapes, the moments
  of ``fc_w`` split over dp.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu import nn as jnn
from paddle_tpu.compat import shard_map
from paddle_tpu.distributed import megatron as jmt
from paddle_tpu.optimizer import AdamW as JAdamW

from test_torch_hybrid import (
    JCFG, LR, assert_trajectory, jax_start, jax_steps, leaves, mesh_of,
    ranks_in_background, tokens, train_case)

V, D = 64, 16
CLIP = 0.05


def _inputs():
    rng = np.random.default_rng(0)
    return {"wte": rng.standard_normal((V, D)).astype(np.float32),
            "tokens": rng.integers(0, V, (4, 9)),
            "x": rng.standard_normal((4, 32)).astype(np.float32),
            "w": rng.standard_normal((32, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            "logits": (5 * rng.standard_normal((4, 7, V))).astype(
                np.float32),
            "targets": rng.integers(0, V, (4, 7))}


def _jax_primitives(inp, n):
    mesh = mesh_of((n,), ("mp",))
    emb = jax.jit(shard_map(lambda w, t: jmt.vocab_parallel_embedding(w, t, "mp",
                                                              V // n),
                    mesh=mesh, in_specs=(P("mp", None), P()), out_specs=P(),
                    check_vma=False))
    row = jax.jit(shard_map(lambda xl, wl, bb: jmt.row_parallel_linear(
        xl, wl, bb, axis="mp"), mesh=mesh,
        in_specs=(P(None, "mp"), P("mp", None), P()), out_specs=P(),
        check_vma=False))
    tgt = jnp.asarray(inp["targets"])
    ce = shard_map(lambda lg, t: jmt.vocab_parallel_softmax_ce(
        lg, t, "mp", V // n), mesh=mesh, in_specs=(P(None, None, "mp"), P()),
        out_specs=P(), check_vma=False)
    logits = jnp.asarray(inp["logits"])
    return {"embedding": np.asarray(emb(jnp.asarray(inp["wte"]),
                                        jnp.asarray(inp["tokens"]))),
            "row_parallel": np.asarray(row(inp["x"], inp["w"], inp["b"])),
            "ce": np.asarray(jax.jit(ce)(logits, tgt)),
            "ce_grad": np.asarray(jax.jit(jax.grad(
                lambda lg: jnp.mean(ce(lg, tgt))))(logits))}


MESH_CASES = {
    "dp2_mp2": ({"dp": 2, "mp": 2}, {}, None),
    "dp2_mp2_clip": ({"dp": 2, "mp": 2}, {}, CLIP),
    "dp4_mp2_zero1": ({"dp": 4, "mp": 2}, {"zero": 1}, None),
}


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    toks = tokens(JCFG)
    starts = {}
    for name, (shape, kw, clip) in MESH_CASES.items():
        opt = JAdamW(learning_rate=LR, grad_clip=(
            jnn.ClipGradByGlobalNorm(clip) if clip else None))
        starts[name] = jax_start(JCFG, tuple(shape.values()), tuple(shape),
                                 opt=opt, zero=kw.get("zero", False))
    cases = {name: train_case(JCFG, shape, starts[name][2], toks, kw=kw,
                              clip=clip, record_update=True)
             for name, (shape, kw, clip) in MESH_CASES.items()}
    port = [ranks_in_background([cases["dp2_mp2"], cases["dp2_mp2_clip"],
                                 {"kind": "megatron", "mesh": {"mp": 4},
                                  "device": "cpu", **inp}], 4),
            ranks_in_background([{"kind": "megatron", "mesh": {"mp": 2},
                                  "device": "cpu", **inp}], 2),
            ranks_in_background([cases["dp4_mp2_zero1"]], 8)]
    ref = {name: jax_steps(step_fn, state, toks)
           for name, (step_fn, state, _) in starts.items()}
    prims = {n: _jax_primitives(inp, n) for n in (2, 4)}
    out4, out2, out8 = (f.result() for f in port)
    got = {"dp2_mp2": out4[0], "dp2_mp2_clip": out4[1],
           "dp4_mp2_zero1": out8[0]}
    return {"inp": inp, "ref": ref, "got": got, "prims": prims,
            "port_prims": {2: out2[0], 4: out4[2]},
            "zero_state": starts["dp4_mp2_zero1"][1].opt_state}


@pytest.mark.parametrize("mp", [2, 4])
def test_vocab_parallel_embedding(runs, mp):
    got = runs["port_prims"][mp]["embedding"]
    np.testing.assert_allclose(got, runs["prims"][mp]["embedding"],
                               rtol=1e-6)
    inp = runs["inp"]
    np.testing.assert_allclose(got, inp["wte"][inp["tokens"]], rtol=1e-6)


@pytest.mark.parametrize("mp", [2, 4])
def test_row_parallel_linear(runs, mp):
    got = runs["port_prims"][mp]["row_parallel"]
    np.testing.assert_allclose(got, runs["prims"][mp]["row_parallel"],
                               rtol=2e-5, atol=1e-5)
    inp = runs["inp"]
    np.testing.assert_allclose(got, inp["x"] @ inp["w"] + inp["b"],
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["ce_kernel", "ce_plain"])
@pytest.mark.parametrize("mp", [2, 4])
def test_vocab_parallel_softmax_ce(runs, mp, route):
    got = runs["port_prims"][mp][route]
    np.testing.assert_allclose(got, runs["prims"][mp]["ce"], rtol=1e-5,
                               atol=1e-5)
    inp = runs["inp"]
    lg = inp["logits"].astype(np.float64)
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) \
        + lg.max(-1)
    pick = np.take_along_axis(lg, inp["targets"][..., None], -1)[..., 0]
    np.testing.assert_allclose(got, lse - pick, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["ce_kernel", "ce_plain"])
@pytest.mark.parametrize("mp", [2, 4])
def test_vocab_parallel_ce_grad_matches(runs, mp, route):
    np.testing.assert_allclose(runs["port_prims"][mp][route + "_grad"],
                               runs["prims"][mp]["ce_grad"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_trajectory_matches_jax(runs, name):
    losses, final = runs["ref"][name]
    got = runs["got"][name]
    assert got["losses"][-1] < got["losses"][0]
    assert_trajectory(got, losses, final, name)


def test_clip_clips(runs):
    """CLIP is below the tree's gradient norm, so the clipped run leaves
    the unclipped one after its first update (in both packages)."""
    a, b = runs["got"]["dp2_mp2"]["losses"], runs["got"]["dp2_mp2_clip"][
        "losses"]
    assert a[0] == pytest.approx(b[0], rel=1e-6)
    assert abs(a[-1] - b[-1]) > 1e-3, (a, b)
    ja, jb = runs["ref"]["dp2_mp2"][0], runs["ref"]["dp2_mp2_clip"][0]
    assert abs(ja[-1] - jb[-1]) > 1e-3, (ja, jb)


def test_zero_shards_opt_state(runs):
    """ZeRO 1 at dp4 x mp2: the state the update sees is JAX's shards —
    fc_w's moments split over dp on top of the Megatron layout."""
    seen = runs["got"]["dp4_mp2_zero1"]["update"]["state"]
    jstate = runs["zero_state"]
    for path, st in leaves(jstate):
        if not isinstance(st, (tuple, list)):
            continue
        want = [tuple(a.addressable_shards[0].data.shape) for a in st]
        assert seen[".".join(path)] == want, (path, seen[".".join(path)],
                                               want)
    m, _ = jstate["blocks"]["fc_w"]
    flat = [a for p in m.sharding.spec if p is not None
            for a in (p if isinstance(p, tuple) else (p,))]
    assert "dp" in flat


@pytest.mark.parametrize("mp", [2, 4])
def test_broadcast_from_the_first_rank(runs, mp):
    """``collective.broadcast_`` over mp: every rank ends with the axis'
    first rank's tensor (rank 0's zeros), gathered back on rank 0."""
    np.testing.assert_array_equal(runs["port_prims"][mp]["broadcast"],
                                  np.zeros(3 * mp, np.float32))
