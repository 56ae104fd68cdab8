"""The port's hybrid-parallel train step (paddle_tpu_torch/text/
gpt_hybrid.py's mesh path) against the JAX package's, on the CPU.

The port's ranks are gloo processes on the CPU (``distributed.spawn``:
the spawn start method, a file rendezvous, one intra-op thread a rank),
whose bodies live in the JAX-free ``paddle_tpu_torch/tools/
hybrid_check.py``; one spawn runs every case of a world size.  JAX runs
the same configuration on its 8-virtual-device mesh in this process,
from the same numpy parameters (its ``init_fn(0)``, fetched) and tokens.

* the pipeline's loss and gradients at dp2 x pp2 x mp2 (both schedules)
  against ``make_pipeline_gpt_loss`` under ``shard_map`` and its
  ``jax.grad`` (the reference's ``test_pipeline_mp_*_matches_dense``),
  and GQA's loss there (``test_gqa_hybrid_loss_matches_dense``, fp32);
* the 1F1B schedule's analogue of the reference's
  ``test_1f1b_memory_flat_in_microbatches`` (an XLA compile artefact
  there): the bytes its autograd graphs hold at once
  (``saved_tensors_hooks``) stay flat from M = 4 to 16 while
  F-then-B's grow;
* a mesh whose axes are all 1 gives the one-card step bit for bit;
* every refusal of the JAX ``build_gpt_train_step``, with its exception
  type.

The helpers here serve ``test_torch_hybrid_train.py``,
``test_torch_megatron.py`` and ``test_torch_zero.py`` too: trajectories
are compared by loss at every step within rtol 2e-5, and by final
params through the share of elements past lr/10 (Adam amplifies
last-bit gradient differences, ROADMAP C).
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import gpt_hybrid as jhybrid
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.topology import Mesh as TMesh
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import gpt, gpt_hybrid
from paddle_tpu_torch.tools import hybrid_check as hc

JCFG = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                      num_heads=4, max_seq_len=64, dtype=jnp.float32)
LR = 1e-3
STEPS = 5
LOSS_RTOL = 2e-5
# final params after 5 Adam steps: elements past lr/10, as a share, and
# the largest gap (a step per step taken at most)
PARAM_TOL = LR / 10
PARAM_FAR = 1e-3


def mesh_of(shape, names):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def tokens(cfg, B=8, T=33, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, T)).astype(np.int32)


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


def fetch(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)),
                                  tree)


def jax_start(jcfg, shape, names, **kw):
    """JAX's hybrid step on its mesh and its ``init_fn(0)`` state:
    (step_fn, state, the fetched initial params)."""
    mesh = mesh_of(shape, names)
    init_fn, step_fn, _ = jhybrid.build_gpt_train_step(
        jcfg, mesh, kw.pop("opt", None) or JAdamW(learning_rate=LR),
        donate=False, **kw)
    state = jax_init(init_fn, mesh)
    return step_fn, state, fetch(state.params)


def jax_init(init_fn, mesh):
    """``init_fn(0)`` with ``step`` placed as the step returns it, so the
    jitted step compiles once instead of again at its second call."""
    state = init_fn(0)
    return state._replace(step=jax.device_put(
        state.step, NamedSharding(mesh, P())))


def jax_steps(step_fn, state, toks, steps=STEPS):
    """(losses, the fetched final params) of ``steps`` JAX steps."""
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, jnp.asarray(toks),
                              jax.random.PRNGKey(1), LR)
        losses.append(float(loss))
    return losses, fetch(state.params)


def train_case(jcfg, mesh, params, toks, steps=STEPS, **extra):
    case = {"kind": "train", "cfg": convert.config_from_jax(jcfg),
            "mesh": mesh, "params": params, "batches": [toks] * steps,
            "lr": LR, "device": "cpu"}
    case.update(extra)
    return case


def run_ranks(cases, world):
    """Every case on ``world`` gloo CPU ranks; rank 0's results."""
    return spawn.spawn(hc.run_cases, (cases,), nprocs=world,
                       device="cpu")[0]


def ranks_in_background(cases, world):
    """:func:`run_ranks` on a thread of its own (the ranks are processes:
    JAX's compiles in this one overlap them); ``.result()`` waits."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, cases, world)
    pool.shutdown(wait=False)
    return fut


def dense_params(jcfg):
    """JAX's ``init_params`` from PRNGKey(0) — what its hybrid
    ``init_fn(0)`` places on any mesh — fetched."""
    return fetch(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))


def assert_trajectory(got, want_losses, want_params, what, steps=STEPS):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL,
                               atol=0, err_msg=what)
    diffs = np.concatenate([
        np.abs(get(got["params"], p) - np.asarray(w, np.float32)).ravel()
        for p, w in leaves(want_params)])
    far = float((diffs > PARAM_TOL).mean())
    assert far <= PARAM_FAR and diffs.max() <= steps * LR, \
        (what, far, float(diffs.max()))


# ---------------------------------------------------------------------------
# the pipeline's loss and gradients at dp2 x pp2 x mp2 (world 8)
# ---------------------------------------------------------------------------

def _gqa_jcfg():
    return jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, num_kv_heads=2,
                          dtype=jnp.float32)


GRID = {"dp": 2, "pp": 2, "mp": 2}


@pytest.fixture(scope="module")
def world8():
    """The port's loss and whole gradients on the grid, for both
    schedules and for GQA, beside JAX's pipeline loss and ``jax.grad``."""
    toks = tokens(JCFG)
    dense = dense_params(JCFG)
    gqa = _gqa_jcfg()
    gqa_params, gqa_toks = dense_params(gqa), tokens(gqa)
    cases = [{"kind": "grads", "cfg": convert.config_from_jax(JCFG),
              "mesh": GRID, "params": dense, "tokens": toks,
              "device": "cpu", "kw": {"n_micro": 2, "schedule": sched}}
             for sched in ("1f1b", "fthenb")]
    cases.append({"kind": "grads", "cfg": convert.config_from_jax(gqa),
                  "mesh": GRID, "params": gqa_params, "tokens": gqa_toks,
                  "device": "cpu", "kw": {"n_micro": 2}})
    port = ranks_in_background(cases, 8)
    key = jax.random.PRNGKey(0)
    f = _jax_pipeline_loss(JCFG)
    jt = jnp.asarray(toks)
    want = {"loss": float(jax.jit(f)(dense, jt, key)),
            "dense": float(jgpt.loss_fn(dense, jt, JCFG)),
            "grads": fetch(jax.jit(jax.grad(f))(dense, jt, key))}
    fg, gt = _jax_pipeline_loss(gqa), jnp.asarray(gqa_toks)
    want["gqa"] = float(jax.jit(fg)(gqa_params, gt, key))
    want["gqa_dense"] = float(jgpt.loss_fn(gqa_params, gt, gqa))
    out = port.result()
    return {"want": want, "1f1b": out[0], "fthenb": out[1], "gqa": out[2]}


def _jax_pipeline_loss(jcfg):
    mesh = mesh_of((2, 2, 2), ("dp", "pp", "mp"))
    loss_raw = jhybrid.make_pipeline_gpt_loss(jcfg, mesh, n_micro=2)
    specs = jgpt.param_shardings(jcfg, mp="mp", pp="pp")
    return shard_map(loss_raw, mesh=mesh, in_specs=(specs, P("dp"), P()),
                     out_specs=P(), check_vma=False)


@pytest.mark.parametrize("sched", ["1f1b", "fthenb"])
def test_pipeline_mp_loss_matches_jax(world8, sched):
    got = world8[sched]["loss"]
    np.testing.assert_allclose(got, world8["want"]["loss"], rtol=2e-5)
    np.testing.assert_allclose(got, world8["want"]["dense"], rtol=2e-5)


@pytest.mark.parametrize("sched", ["1f1b", "fthenb"])
def test_pipeline_mp_grads_match_jax(world8, sched):
    got = world8[sched]["grads"]
    for path, w in leaves(world8["want"]["grads"]):
        np.testing.assert_allclose(get(got, path), w, rtol=5e-4, atol=1e-6,
                                   err_msg=str(path))


def test_gqa_hybrid_loss_matches_jax(world8):
    got = world8["gqa"]["loss"]
    np.testing.assert_allclose(got, world8["want"]["gqa"], rtol=2e-5)
    np.testing.assert_allclose(got, world8["want"]["gqa_dense"], rtol=2e-5)


# ---------------------------------------------------------------------------
# 1F1B's memory: flat in the micro-batches (world 4)
# ---------------------------------------------------------------------------

def test_1f1b_saved_bytes_flat_in_microbatches():
    """pp2 at T = 128: the bytes stage 0's autograd graphs hold at once
    stay flat from M = 4 to 16 under 1F1B (at most min(M, 2S - 1) = 3
    graphs in flight) and grow about M-fold under F-then-B (every graph
    lives until the backwards start)."""
    cfg = gpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                        num_heads=4, max_seq_len=128, dtype=torch.float32)
    params = {k: v for k, v in gpt.init_master_params(cfg, 0, "cpu").items()}
    cases = []
    for sched in ("fthenb", "1f1b"):
        for M in (4, 16):
            toks = np.zeros((2 * M, 129), np.int64)
            cases.append({"kind": "train", "cfg": cfg, "mesh": {"pp": 2},
                          "params": params, "batches": [toks], "steps": 1,
                          "device": "cpu", "saved": True, "gather": False,
                          "kw": {"n_micro": M, "schedule": sched}})
    out = run_ranks(cases, 2)
    peak = {(c["kw"]["schedule"], c["kw"]["n_micro"]): o["saved_peak"]
            for c, o in zip(cases, out)}
    assert peak["fthenb", 16] > 2 * peak["fthenb", 4], peak
    assert peak["1f1b", 16] < 1.5 * peak["1f1b", 4], peak
    assert peak["1f1b", 16] < peak["fthenb", 16] / 2, peak


# ---------------------------------------------------------------------------
# no mesh, a mesh of ones, refusals (in this process: nothing collective)
# ---------------------------------------------------------------------------

def _small():
    return gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=4, max_seq_len=32, dtype=torch.float32)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_of_ones_is_the_one_card_step_bit_for_bit(accum):
    cfg = _small()
    toks = np.random.default_rng(0).integers(0, 64, (4, 17))
    runs = []
    for mesh in (None, TMesh({"dp": 1, "pp": 1, "mp": 1},
                             device=torch.device("cpu"))):
        opt = AdamW(learning_rate=LR)
        init_fn, step_fn, meta = gpt_hybrid.build_gpt_train_step(
            cfg, opt, accum=accum, device="cpu", mesh=mesh)
        state = init_fn(0)
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, toks, None, LR)
            losses.append(loss)
        runs.append((losses, dict(leaves(state.params)), meta))
    (l0, p0, m0), (l1, p1, m1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert m0 == m1


def _fake_mesh(**shape):
    return TMesh(shape, rank=0, device=torch.device("cpu"))


REFUSALS = [
    ("layers", dict(num_layers=3), dict(pp=2), {}, ValueError),
    ("heads", dict(num_heads=3, hidden_size=48), dict(mp=2), {},
     ValueError),
    ("vocab", dict(vocab_size=63), dict(mp=2), {}, ValueError),
    ("kv_heads", dict(num_kv_heads=1), dict(dp=2, pp=2, mp=2), {},
     ValueError),
    ("rope", dict(pos_embed="rope"), dict(pp=2), {}, NotImplementedError),
    ("rmsnorm", dict(norm="rmsnorm"), dict(pp=2), {}, NotImplementedError),
    ("swiglu", dict(activation="swiglu"), dict(pp=2), {},
     NotImplementedError),
    ("zero2_pp", {}, dict(pp=2, dp=4), dict(zero=2, n_micro=2),
     NotImplementedError),
    ("accum_pp", {}, dict(pp=2), dict(accum=2, n_micro=2), ValueError),
    ("schedule", {}, dict(pp=2), dict(schedule="zigzag"), ValueError),
    ("sp", dict(pos_embed="rope"), dict(dp=2, sp=2), {},
     NotImplementedError),
    ("rmsnorm_sp", dict(norm="rmsnorm"), dict(sp=2), {},
     NotImplementedError),
    ("swiglu_sp", dict(activation="swiglu"), dict(sp=2), {},
     NotImplementedError),
    ("kv_heads_sp", dict(num_kv_heads=1), dict(sp=2, mp=2), {},
     ValueError),
    ("zero2_sp", {}, dict(dp=2, sp=2), dict(zero=2), NotImplementedError),
    ("accum_sp", {}, dict(sp=2), dict(accum=2), ValueError),
]


@pytest.mark.parametrize("what,over,shape,kw,exc", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_raise_the_jax_types(what, over, shape, kw, exc):
    cfg = dataclasses.replace(_small(), **over)
    with pytest.raises(exc):
        gpt_hybrid.build_gpt_train_step(cfg, AdamW(learning_rate=LR),
                                        mesh=_fake_mesh(**shape), **kw)


def test_jax_refuses_alike():
    """The JAX ``build_gpt_train_step`` raises the same types on the same
    meshes."""
    for what, over, shape, kw, exc in REFUSALS:
        if what == "kv_heads":
            continue   # JAX refuses it on the pipeline path: next test
        jcfg = dataclasses.replace(JCFG, **{k: v for k, v in over.items()})
        names = tuple(shape)
        mesh = mesh_of(tuple(shape[n] for n in names), names)
        with pytest.raises(exc):
            jhybrid.build_gpt_train_step(jcfg, mesh,
                                         JAdamW(learning_rate=LR), **kw)


def test_experts_must_divide_ep():
    """``num_experts % ep`` is a ValueError in both packages, and MoE
    under mp or pp is no longer refused."""
    from paddle_tpu.text.moe import MoEConfig as JMoEConfig
    from paddle_tpu_torch.text.moe import MoEConfig

    cfg = dataclasses.replace(_small(), moe=MoEConfig(num_experts=4))
    with pytest.raises(ValueError, match="ep"):
        gpt_hybrid.build_gpt_train_step(cfg, AdamW(learning_rate=LR),
                                        mesh=_fake_mesh(ep=3))
    jcfg = dataclasses.replace(JCFG, moe=JMoEConfig(num_experts=4))
    with pytest.raises(ValueError, match="ep"):
        jhybrid.build_gpt_train_step(jcfg, mesh_of((3,), ("ep",)),
                                     JAdamW(learning_rate=LR))
    for shape in (dict(mp=2), dict(pp=2, ep=2)):
        gpt_hybrid.build_gpt_train_step(cfg, AdamW(learning_rate=LR),
                                        mesh=_fake_mesh(**shape))


@pytest.mark.parametrize("width,zigzag", [(32, False), (31, True)],
                         ids=["seq_divides_sp", "zigzag_even_chunk"])
def test_sequence_refusals_raise_the_jax_types(width, zigzag):
    """At the step, as in JAX's traced loss, on tokens [2, width]: the
    sequence (width - 1 = 31) must divide by sp, and under zigzag each
    rank's chunk (30 / 2 = 15) must be even — ValueError."""
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(
        _small(), AdamW(learning_rate=LR), mesh=_fake_mesh(sp=2),
        sp_zigzag=zigzag)
    with pytest.raises(ValueError, match="sp|zigzag"):
        step_fn(init_fn(0), np.zeros((2, width), np.int64), None, LR)
    jinit, jstep, _ = jhybrid.build_gpt_train_step(
        JCFG, mesh_of((2,), ("sp",)), JAdamW(learning_rate=LR),
        sp_zigzag=zigzag, donate=False)
    with pytest.raises(ValueError, match="sp|zigzag"):
        jstep(jinit(0), jnp.zeros((2, width), jnp.int32),
              jax.random.PRNGKey(0), LR)


def test_gqa_kv_heads_must_divide_mp():
    cfg = dataclasses.replace(convert.config_from_jax(_gqa_jcfg()),
                              num_kv_heads=1)
    with pytest.raises(ValueError, match="kv"):
        gpt_hybrid.build_gpt_train_step(
            cfg, AdamW(learning_rate=LR),
            mesh=_fake_mesh(dp=2, pp=2, mp=2), n_micro=2)
    jcfg = dataclasses.replace(_gqa_jcfg(), num_kv_heads=1)
    with pytest.raises(ValueError, match="kv"):
        jhybrid.build_gpt_train_step(
            jcfg, mesh_of((2, 2, 2), ("dp", "pp", "mp")),
            JAdamW(learning_rate=LR), n_micro=2)


@pytest.mark.parametrize("name", ["Lamb", "Lars", "Adafactor"])
@pytest.mark.parametrize("shape", [dict(mp=2), dict(pp=2), dict(dp=2)],
                         ids=["mp", "pp", "zero1"])
def test_per_leaf_norm_optimizers_refused_when_leaves_split(name, shape):
    """Their trust ratios, factored moments and RMS clips need whole
    leaves: refused where the layout splits one (ROADMAP A2/C)."""
    from paddle_tpu_torch import optimizer as optim

    kw = dict(zero=1) if "dp" in shape else {}
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        gpt_hybrid.build_gpt_train_step(
            _small(), getattr(optim, name)(learning_rate=LR),
            mesh=_fake_mesh(**shape), **kw)


def test_per_leaf_clip_refused_when_leaves_split():
    from paddle_tpu_torch.nn import ClipGradByNorm

    with pytest.raises(NotImplementedError, match="ClipGradByGlobalNorm"):
        gpt_hybrid.build_gpt_train_step(
            _small(), AdamW(learning_rate=LR, grad_clip=ClipGradByNorm(1.0)),
            mesh=_fake_mesh(mp=2))


def test_topology_matches_jax():
    """``CommunicateTopology`` and ``HybridCommunicateGroup``'s degrees,
    coordinates and pipeline neighbours equal the JAX package's, rank
    for rank; the port's ``Mesh`` lays ranks out row-major as
    ``mesh_of`` does and finds each rank's slices."""
    from paddle_tpu.distributed import topology as jtopo
    from paddle_tpu_torch.distributed import topology as ttopo

    names, dims = ("data", "pipe", "sharding", "model"), (2, 2, 1, 2)
    jt = jtopo.CommunicateTopology(names, dims)
    tt = ttopo.CommunicateTopology(names, dims)
    for ax in names:
        assert tt.get_comm_list(ax) == jt.get_comm_list(ax)
        for i in range(tt.get_dim(ax)):
            assert tt.get_axis_list(ax, i) == jt.get_axis_list(ax, i)
    shape = {"dp": 2, "pp": 2, "mp": 2}
    jmesh = mesh_of((2, 2, 2), ("dp", "pp", "mp"))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        assert tt.get_coord(rank) == jt.get_coord(rank)
        m = TMesh(shape, rank=rank)
        assert ids[m.coord("dp"), m.coord("pp"), m.coord("mp")] == rank
        assert m.ranks("mp") == [r for r in range(8)
                                 if r // 2 == rank // 2]
        assert m.ranks(("dp", "mp")) == [
            r for r in range(8) if (r // 2) % 2 == (rank // 2) % 2]
        jh = jtopo.HybridCommunicateGroup(jt, rank)
        th = ttopo.HybridCommunicateGroup(TMesh(
            {"dp": 2, "pp": 2, "sharding": 1, "mp": 2}, rank=rank))
        for getter in ("get_data_parallel_world_size",
                       "get_model_parallel_world_size",
                       "get_pipe_parallel_world_size",
                       "get_sharding_parallel_world_size",
                       "get_data_parallel_rank", "get_model_parallel_rank",
                       "get_stage_id", "get_sharding_parallel_rank",
                       "get_p2p_next_rank", "get_p2p_prev_rank"):
            assert getattr(th, getter)() == getattr(jh, getter)(), getter
