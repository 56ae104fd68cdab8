"""The port's tensor-parallel server (``DecodeServer(mesh=)``,
paddle_tpu_torch/text/tp_serving.py) against the JAX package's on its
8-device CPU mesh: the tensor-parallel cases of tests/test_fleet.py and
tests/test_engine.py, and the port's dispatch ways on a mesh.

The port's ranks are four CPU processes over gloo, started once for the
module (one intra-op thread each) and carved into meshes of 1, 2 and 4;
JAX weights carried over by ``paddle_tpu_torch/convert.py``.  Required:
greedy streams exactly equal to JAX's TP server's and to both packages'
single-device servers, on the trained ``markov_gpt`` and the small
models of tests/test_engine.py (a dispatch way of the port's own: to its
single-device server's); the cache's blocks shaped as JAX's
``shard_shape`` (the port's pool one block longer: its sink); the paged
``build_sharded_decode`` step within JAX's stated ``rtol=2e-2,
atol=1e-2`` of JAX's and of the port's unsharded paged step; every
refusal JAX's exception type and message; every step of a TP server
keyed by its mesh.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import adapters as JA
from paddle_tpu.text import engine as jengine
from paddle_tpu.text import fleet as jfleet
from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import kv_pool as jkv
from paddle_tpu.text import lora as jlora
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import serving_mesh
from paddle_tpu_torch.text import adapters as A
from paddle_tpu_torch.text import engine, fleet, gpt, kv_pool, serving
from paddle_tpu_torch.text import generate as G

from test_torch_tp_serving import (_both_params, _jmesh, _np, _pool_shard,
                                   _shard)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pool():
    p = serving_mesh.RankPool(4, device="cpu", timeout_s=120.0)
    yield p
    p.close()


@pytest.fixture(scope="module")
def meshes(pool):
    return {n: pool.mesh({"mp": n}) for n in (1, 2, 4)}


# ---------------------------------------------------------------------------
# the server's mesh path and the fleet (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def _serve(srv, prompts, max_new=5, mode="tick"):
    rids = [srv.submit(list(p), max_new_tokens=max_new) for p in prompts]
    ticks = 0
    while srv.pending():
        srv.tick_block(3) if mode == "block" else srv.tick()
        ticks += 1
        assert ticks < 300
    out = [[int(t) for t in srv.result(r)] for r in rids]
    return out


@pytest.fixture(scope="module")
def markov(markov_gpt):
    jcfg, jp = markov_gpt
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_tp_decode_server_token_parity(markov, meshes, layout):
    """DecodeServer(mesh=) over 2 ranks: greedy tokens equal the JAX TP
    server's and both single-device servers'; the cache's Hkv axis is
    split (pool and slab alike) as JAX splits it, tables whole."""
    jcfg, jp, cfg, p = markov
    kw = {} if layout == "contiguous" else {"layout": "paged",
                                            "block_size": 8}
    prompts = [[3, 7, 2], [1, 5]]
    jref = _serve(jserving.DecodeServer(jp, jcfg, max_batch=2, max_len=16,
                                        **kw), prompts)
    jsrv = jserving.DecodeServer(jp, jcfg, max_batch=2, max_len=16,
                                 mesh=_jmesh(2), **kw)
    jgot = _serve(jsrv, prompts)
    ref = _serve(serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                                      device="cpu", **kw), prompts)
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                               mesh=meshes[2], **kw)
    got = _serve(srv, prompts)
    k = srv.cache["k"]
    assert (k.shard_shape() if layout == "contiguous" else _pool_shard(k)) \
        == _shard(jsrv.cache["k"])
    assert k.shard_shape()[3] == cfg.kv_heads // 2
    if layout == "paged":
        t = srv.cache["tables"]
        assert t.shard_shape() == tuple(t.shape) == _shard(
            jsrv.cache["tables"])
    srv.close()
    jsrv.close()
    assert got == jgot == ref == jref


@pytest.mark.parametrize("mode,extra", [
    ("tick", {"prefill_budget": 2}), ("tick", {"async_dispatch": True}),
    ("block", {}), ("tick", {"prefill": False})])
def test_tp_server_dispatch_modes_match(markov, meshes, mode, extra):
    """Budgeted admission, async dispatch, tick_block and token-by-token
    prompts on the mesh (mp 2 and 4) serve the single-device server's
    streams (ways the JAX cases run on one device only)."""
    _, _, cfg, p = markov
    prompts = [[3, 7, 2, 9, 4], [1, 5], [6, 6, 2]]
    kw = dict(max_batch=2, max_len=16, **extra)
    ref = _serve(serving.DecodeServer(p, cfg, device="cpu", **kw), prompts,
                 mode=mode)
    for n in (2, 4):
        srv = serving.DecodeServer(p, cfg, mesh=meshes[n], **kw)
        assert _serve(srv, prompts, mode=mode) == ref
        srv.close()


def test_tp_server_rejects_device_and_bad_axis(markov, pool, meshes):
    jcfg, jp, cfg, p = markov
    errs = []
    for srv_cls, params, c, mesh2, dev, dp_mesh in (
            (jserving.DecodeServer, jp, jcfg, _jmesh(2), jax.devices()[0],
             _jmesh(2, ("dp",))),
            (serving.DecodeServer, p, cfg, meshes[2], "cpu",
             pool.mesh({"dp": 2}))):
        with pytest.raises(ValueError, match="mutually exclusive") as e1:
            srv_cls(params, c, max_batch=1, max_len=16, mesh=mesh2,
                    device=dev)
        with pytest.raises(ValueError, match="no 'mp' axis") as e2:
            srv_cls(params, c, max_batch=1, max_len=16, mesh=dp_mesh)
        errs.append((str(e1.value), str(e2.value)))
    assert errs[0] == errs[1]


def test_tp_fleet_replicas_compose(markov, meshes):
    """A Router over one TP replica and one pinned single-device replica
    matches the single server bit for bit, in both packages."""
    jcfg, jp, cfg, p = markov
    prompts = [[3, 7, 2], [1, 5], [9, 4]]
    ref = _serve(serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                                      device="cpu"), prompts)

    def drive(router):
        rids = [router.submit(q, max_new_tokens=5) for q in prompts]
        deadline = time.time() + 120
        while router.pending() and time.time() < deadline:
            router.tick()
        assert not router.pending()
        out = [[int(t) for t in router.result(r)] for r in rids]
        router.close()
        return out

    jgot = drive(jfleet.Router(
        [jserving.DecodeServer(jp, jcfg, max_batch=2, max_len=16,
                               mesh=_jmesh(2)),
         jserving.DecodeServer(jp, jcfg, max_batch=2, max_len=16,
                               device=jax.devices()[2])]))
    got = drive(fleet.Router(
        [serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                              mesh=meshes[2]),
         serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                              device="cpu")]))
    assert got == jgot == ref


def test_build_sharded_decode_paged_pool(markov, meshes):
    """layout='paged': the pool's Hkv axis splits like the slab's, tables
    whole; with the fresh (unmapped) tables each package's sharded step
    matches its unsharded paged step, and with the slots' blocks mapped
    the port's sharded step matches JAX's (JAX's stated tolerance).  An
    unmapped table is where the packages part by design: the port's rows
    go to its sink block and its attention reads zeros there."""
    jcfg, jp, cfg, p = markov
    jsp, jmake, jdecode = JG.build_sharded_decode(
        jp, jcfg, _jmesh(2), layout="paged", block_size=8)
    sp, make, decode = G.build_sharded_decode(p, cfg, meshes[2],
                                              layout="paged", block_size=8)
    jc, c = jmake(2, 16), make(2, 16)
    assert _pool_shard(c["k"]) == _shard(jc["k"])
    assert c["k"].shard_shape()[3] == cfg.kv_heads // 2
    assert c["tables"].shard_shape() == tuple(c["tables"].shape)
    jref = jax.jit(lambda a, b, t, q: jkv.paged_decode_step_batched(
        a, b, t, q, jcfg))
    jr = JG.init_cache(jcfg, 2, 16, layout="paged", block_size=8)
    rc = G.init_cache(cfg, 2, 16, "cpu", layout="paged", block_size=8)
    tol = dict(rtol=2e-2, atol=1e-2)
    for pos, tok in enumerate(([3, 7], [1, 2])):
        pos_b = torch.full((2,), pos, dtype=torch.int32)
        jl, jc = jdecode(jsp, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos))
        jw, jr = jref(jp, jr, jnp.asarray(tok, jnp.int32),
                      jnp.full((2,), pos, jnp.int32))
        got, c = decode(sp, c, torch.tensor(tok), pos)
        want, rc = kv_pool.paged_decode_step_batched(
            p, rc, torch.tensor(tok), pos_b, cfg)
        np.testing.assert_allclose(np.asarray(jl), np.asarray(jw), **tol)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the slots' blocks mapped in both packages: the same arithmetic
    tables = np.array([[0, 1], [2, 3]], np.int32)
    jc = jmake(2, 16)
    jc["tables"] = jax.device_put(jnp.asarray(tables),
                                  jc["tables"].sharding)
    c = make(2, 16)
    c["tables"].copy_(torch.from_numpy(tables))
    for pos, tok in enumerate(([3, 7], [1, 2], [5, 5])):
        jl, jc = jdecode(jsp, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos))
        got, c = decode(sp, c, torch.tensor(tok), pos)
        np.testing.assert_allclose(_np(got), np.asarray(jl), **tol)


def test_sharded_make_cache_flag_flip_fails_loudly(markov, meshes,
                                                   monkeypatch):
    """A PADDLE_TPU_KV_LAYOUT / _KV_BLOCK flip between build and
    make_cache raises, in JAX's words, in both packages."""
    jcfg, jp, cfg, p = markov
    msgs = []
    for build, params, c, mesh in ((JG.build_sharded_decode, jp, jcfg,
                                    _jmesh(1)),
                                   (G.build_sharded_decode, p, cfg,
                                    meshes[1])):
        monkeypatch.delenv("PADDLE_TPU_KV_LAYOUT", raising=False)
        monkeypatch.delenv("PADDLE_TPU_KV_BLOCK", raising=False)
        _, make, _ = build(params, c, mesh)
        monkeypatch.setenv("PADDLE_TPU_KV_LAYOUT", "paged")
        with pytest.raises(ValueError, match="KV_LAYOUT changed") as e1:
            make(1, 16)
        monkeypatch.setenv("PADDLE_TPU_KV_BLOCK", "8")
        _, make, _ = build(params, c, mesh)
        monkeypatch.setenv("PADDLE_TPU_KV_BLOCK", "16")
        with pytest.raises(ValueError, match="KV_BLOCK changed") as e2:
            make(1, 16)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# speculation and adapter pools under TP (tests/test_engine.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """tests/test_engine.py's target and draft models, both packages."""
    def cfg(**kw):
        base = dict(vocab_size=16, hidden_size=32, num_layers=1,
                    num_heads=2, max_seq_len=64)
        base.update(kw)
        return jgpt.GPTConfig(**base)

    out = []
    for jcfg, key in ((cfg(), 0), (cfg(hidden_size=16), 1)):
        jp, c, p = _both_params(jcfg, key)
        out.append((jcfg, jp, c, p))
    return out


_PROMPTS = ([2, 3, 4], [2] * 12)


def _norm_keys(keys, tcfg_key, dcfg_key):
    """Step keys with the shard fragment dropped and the config key named
    by role (t: target, d: draft) — comparable across the packages."""
    return {(k[0], "t" if k[1] == tcfg_key else
             "d" if k[1] == dcfg_key else k[1]) + tuple(k[2:-1])
            for k in keys}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_tp_greedy_parity(small, meshes, layout):
    """Speculative decoding on a mesh= server — the draft twin on its own
    shard context, spec_verify@K and the draft's steps sharded — greedy
    tokens equal the single-device spec server's and (contiguous, JAX's
    case) JAX's, one device and TP; every step built is keyed by the mesh,
    its keys otherwise the single-device server's, and they part from
    JAX's TP keys exactly as the single-device servers' keys part."""
    (jcfg, jp, cfg, p), (jdcfg, jdp, dcfg, dp) = small
    kw = dict(max_batch=2, max_len=40, spec_k=2)
    if layout == "paged":
        kw.update(layout="paged", block_size=8, num_blocks=32)
    engine.ENGINE._steps.clear()
    one = serving.DecodeServer(p, cfg, device="cpu", draft_cfg=dcfg,
                               draft_params=dp, **kw)
    want = _serve(one, _PROMPTS)
    one_keys = set(engine.ENGINE._steps.keys())
    one.close()
    before = set(engine.ENGINE._steps.keys())
    srv = serving.DecodeServer(p, cfg, mesh=meshes[2], draft_cfg=dcfg,
                               draft_params=dp, **kw)
    got = _serve(srv, _PROMPTS)
    new = set(engine.ENGINE._steps.keys()) - before
    assert new and all(k[-1][0] == srv._shard.key for k in new)
    assert {k[:-1] for k in new} == {k[:-1] for k in one_keys}
    srv.close()
    if layout == "paged":
        return          # the JAX case runs the contiguous layout
    jkeys = []
    for where in ({}, {"mesh": _jmesh(2)}):
        jengine.ENGINE._steps.clear()
        jsrv = jserving.DecodeServer(jp, jcfg, draft_cfg=jdcfg,
                                     draft_params=jdp, **where, **kw)
        assert _serve(jsrv, _PROMPTS) == want
        jkeys.append(set(jengine.ENGINE._steps.keys()))
        jsrv.close()
    assert jkeys[1] and all(k[-1] == jsrv._shard.key for k in jkeys[1])
    # the port's keys part from JAX's where its single-device server's do
    # (its draft proposes through a block step), and nowhere else
    ck, dk = engine.cfg_key(cfg), engine.cfg_key(dcfg)
    jck, jdk = jengine.cfg_key(jcfg), jengine.cfg_key(jdcfg)
    assert (_norm_keys(new, ck, dk) ^ _norm_keys(jkeys[1], jck, jdk)) == \
        (_norm_keys(one_keys, ck, dk)
         ^ _norm_keys(jkeys[0], jck, jdk))


def _rand_adapter(jp, jcfg, seed, rank=4, scale=0.5):
    """tests/test_engine.py's adapter: ``lora_init``'s ``a`` and a numpy
    ``b`` (the same arrays for both packages)."""
    ad = jax.device_get(jlora.split_lora(jlora.lora_init(
        jp, jcfg, rank=rank, key=jax.random.PRNGKey(seed)))[1])
    rng = np.random.default_rng(seed)
    return {n: ((scale * rng.standard_normal(v.shape)).astype(np.float32)
                if n.endswith("_lora_b") else np.asarray(v, np.float32))
            for n, v in ad.items()}


def test_adapter_pool_tp_parity(small, meshes):
    """A stacked AdapterPool under mesh= (the stacks cut per
    stacked_pool_specs; an adapter registered after the build reaches the
    ranks): base and adapter requests equal the single-device pool
    server's, as JAX's TP server's equal its own; the JAX case's base and
    adapter requests equal JAX's, and the adapter changes tokens."""
    (jcfg, jp, cfg, p), _ = small
    tilt, late = _rand_adapter(jp, jcfg, 7), _rand_adapter(jp, jcfg, 8)

    def run(pkg, mesh):
        if pkg == "jax":
            pool = JA.AdapterPool(jp, jcfg, rank=4, max_adapters=2)
            where = {} if mesh is None else {"mesh": mesh}
            srv = jserving.DecodeServer(jp, jcfg, max_batch=2, max_len=40,
                                        adapter_pool=pool, **where)
        else:
            pool = A.AdapterPool(p, cfg, rank=4, max_adapters=2)
            where = {"device": "cpu"} if mesh is None else {"mesh": mesh}
            srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=40,
                                       adapter_pool=pool, **where)
        pool.register("tilt", tilt)
        r0 = srv.submit([2, 3, 4], max_new_tokens=5)
        r1 = srv.submit([2, 3, 4], max_new_tokens=5, adapter="tilt")
        while srv.pending():
            srv.tick()
        out = [srv.result(r0), srv.result(r1)]
        pool.register("late", late)
        r2 = srv.submit([5, 6], max_new_tokens=5, adapter="late")
        while srv.pending():
            srv.tick()
        out.append(srv.result(r2))
        srv.close()
        return [[int(t) for t in s] for s in out]

    single = run("torch", None)
    assert single[0] != single[1], "adapter did not change tokens"
    assert run("torch", meshes[2]) == single
    jsingle = run("jax", None)
    assert run("jax", _jmesh(2)) == jsingle
    # the JAX case's requests agree across the packages (the adapter
    # registered after the build is the port's own check)
    assert single[:2] == jsingle[:2]


def test_stacked_pool_specs_replicate_stack_axis(small):
    (jcfg, jp, cfg, p), _ = small
    jspecs = JA.stacked_pool_specs(JA.AdapterPool(jp, jcfg, rank=4,
                                                  max_adapters=2), mp="mp")
    pool = A.AdapterPool(p, cfg, rank=4, max_adapters=2)
    specs = A.stacked_pool_specs(pool, mp="mp")
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    base = gpt.param_shardings(cfg, mp="mp")["blocks"]
    for t in pool.targets:
        dims = tuple(base[t])
        assert specs[t + "_lora_a"] == (None, *dims[:-1], None)
        assert specs[t + "_lora_b"] == (None, *dims[:-2], None, dims[-1])
    assert base["qkv_w"][-1] == "mp" and base["proj_w"][-2] == "mp"


def test_servers_on_one_pool_from_threads(markov, meshes):
    """Three servers on three meshes of one pool, each ticked from its own
    thread under a short switch interval (the pool's lock orders their
    frames): every stream is the single-device server's."""
    import sys
    import threading

    _, _, cfg, p = markov
    prompts = [[3, 7, 2], [1, 5], [9, 4]]
    ref = _serve(serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                                      device="cpu"), prompts)
    servers = [serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                                    mesh=meshes[n]) for n in (1, 2, 4)]
    got = [None] * len(servers)

    def run(i):
        got[i] = _serve(servers[i], prompts)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(servers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        for srv in servers:
            srv.close()
    assert got == [ref] * len(servers)
