"""The port's tensor-parallel decode (``generate.build_sharded_decode``,
paddle_tpu_torch/text/tp_serving.py, the regex sharding rules) against
the JAX package's on its 8-device CPU mesh; the server's mesh path is in
tests/test_torch_tp_serving_server.py and the MoE cases (ep x mp) in
tests/test_torch_tp_serving_moe.py.

The port's ranks are four CPU processes over gloo, started once for the
module (``distributed.serving_mesh.RankPool``, one intra-op thread each)
and carved into meshes of 1, 2 and 4; each case feeds the same numpy
inputs — JAX weights carried over by ``paddle_tpu_torch/convert.py`` —
to the JAX function on a ``jax.sharding.Mesh`` and to the port's on a
``ServingMesh``, and requires:

* sharded logits within JAX's own tolerance of JAX's sharded logits
  (``rtol=2e-2, atol=5e-3``, tests/test_generate.py; the kernel case's
  ``3e-2``, as JAX states it; the int8 cache's ``3e-2`` too, as its case
  says);
* each rank's cache and weight blocks shaped as JAX's ``shard_shape``
  (where ``mp`` does not divide the kv heads the whole cache replicates,
  and the port keeps ``kv_w`` whole too: every rank projects all Hkv
  heads);
* every refusal JAX's exception type and message;
* a rank that dies fails the server within the pool's deadline.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.distributed import sharding_rules as jsr
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import serving as jserving
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import serving_mesh, sharding_rules
from paddle_tpu_torch.distributed.topology import Mesh as TMesh
from paddle_tpu_torch.text import serving
from paddle_tpu_torch.text import generate as G

TOL = dict(rtol=2e-2, atol=5e-3)         # tests/test_generate.py:211-212


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


def _jmesh(n, names=("mp",)):
    return Mesh(np.array(jax.devices()[:n]), names)


def _both_params(jcfg, key, quantize=None):
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(key)))
    if quantize:
        jp = jax.device_get(getattr(jwoq, quantize)(jp))
    return jp, convert.config_from_jax(jcfg), convert.params_from_jax(jp)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# the regex sharding rules (tests/test_sharding_rules.py)
# ---------------------------------------------------------------------------


def _rule_tree():
    rng = np.random.default_rng(0)
    return {"embed": {"w": rng.standard_normal((64, 32)).astype(np.float32)},
            "blocks": [{"attn_qkv": rng.standard_normal((32, 96))
                        .astype(np.float32),
                        "ffn_out": rng.standard_normal((128, 32))
                        .astype(np.float32),
                        "ln_g": np.ones((32,), np.float32),
                        "scale": np.zeros((), np.float32)}]}


JRULES = [(r"embed/w", P("mp", None)), (r"attn_qkv", P(None, "mp")),
          (r"ffn_out", P("mp", None)), (r"ln_g", P())]
RULES = [(pat, tuple(spec)) for pat, spec in JRULES]


def test_sharding_rules_match_and_scalars():
    jt = jax.tree_util.tree_map(jnp.asarray, _rule_tree())
    jspecs = jsr.match_sharding_rules(JRULES, jt)
    specs = sharding_rules.match_sharding_rules(RULES, _rule_tree())
    assert specs["embed"]["w"] == tuple(jspecs["embed"]["w"]) == ("mp", None)
    b, jb = specs["blocks"][0], jspecs["blocks"][0]
    for name in ("attn_qkv", "ln_g", "scale"):
        assert b[name] == tuple(jb[name])
    assert b["scale"] == ()


def test_sharding_rules_strict_raises_on_unmatched():
    tree = dict(_rule_tree(), rogue=np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="rogue") as jexc:
        jsr.match_sharding_rules(
            JRULES, jax.tree_util.tree_map(jnp.asarray, tree))
    with pytest.raises(ValueError, match="rogue") as exc:
        sharding_rules.match_sharding_rules(RULES, tree)
    assert str(exc.value) == str(jexc.value)
    assert sharding_rules.match_sharding_rules(
        RULES, tree, strict=False)["rogue"] == ()


def test_collective_tally_held_per_thread():
    """``collective.held`` (what a graph capture counts its collectives
    into) takes this thread's counts and replays' ``add_stats`` off
    ``STATS``; another thread's counts reach ``STATS`` meanwhile."""
    import threading

    from paddle_tpu_torch.distributed import collective as C

    C.reset_stats()
    with C.held() as tally:
        C._count("all_reduce", 64)
        C.add_stats({"all_gather": {"calls": 2, "bytes": 32}})
        t = threading.Thread(target=C._count, args=("all_reduce", 8))
        t.start()
        t.join()
    assert tally == {"all_reduce": {"calls": 1, "bytes": 64},
                     "all_gather": {"calls": 2, "bytes": 32}}
    assert C.stats() == {"all_reduce": {"calls": 1, "bytes": 8}}
    C.add_stats(tally)
    assert C.stats() == {"all_reduce": {"calls": 2, "bytes": 72},
                         "all_gather": {"calls": 2, "bytes": 32}}
    C.reset_stats()


def test_sharding_rules_apply_cuts_each_rank_block():
    """The JAX call's device 0 shard on a (dp 2, mp 4) mesh == the port's
    rank 0 block, values and shapes; the other ranks' blocks == the JAX
    shards of the devices at the same coordinates."""
    tree = _rule_tree()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    placed, _ = jsr.apply_sharding_rules(
        JRULES, jt, Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("dp", "mp")))
    for r in range(8):
        mine, specs = sharding_rules.apply_sharding_rules(
            RULES, tree, TMesh({"dp": 2, "mp": 4}, rank=r))
        for path in ("embed/w", "blocks/0/attn_qkv", "blocks/0/ffn_out"):
            j = placed
            m = mine
            for k in path.split("/"):
                j = j[int(k)] if k.isdigit() else j[k]
                m = m[int(k)] if k.isdigit() else m[k]
            shard = next(s for s in j.addressable_shards
                         if s.device == jax.devices()[r])
            np.testing.assert_array_equal(m.numpy(), np.asarray(shard.data))
    w = placed["embed"]["w"]
    assert w.addressable_shards[0].data.shape == (16, 32)


# ---------------------------------------------------------------------------
# build_sharded_decode (tests/test_generate.py::TestShardedDecode)
# ---------------------------------------------------------------------------


def _decode_parity(jcfg, key, n, mesh, quantize=None):
    """Two steps of JAX's and the port's sharded decode, and the port's
    unsharded decode_step, from the same tokens: the port's sharded
    logits within TOL of JAX's sharded and of its own single-device
    ones.  Returns (JAX params, JAX cache, port params, port cache)."""
    jp, cfg, p = _both_params(jcfg, key, quantize)
    jsp, jmake, jdecode = JG.build_sharded_decode(jp, jcfg, _jmesh(n))
    sp, make, decode = G.build_sharded_decode(p, cfg, mesh)
    jc, c = jmake(2, 12), make(2, 12)
    rc = G.init_cache(cfg, 2, 12, "cpu")
    for pos, tok in enumerate(([3, 7], [1, 2])):
        jl, jc = jdecode(jsp, jc, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos))
        got, c = decode(sp, c, torch.tensor(tok), pos)
        want, rc = G.decode_step(p, rc, torch.tensor(tok), pos, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(jl), **TOL)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    return jsp, jc, sp, c


def _shard(a):
    return tuple(a.sharding.shard_shape(a.shape))


def _pool_shard(h):
    """A port pool leaf's block shape as JAX's: the port's pool holds one
    more block, the write sink (kv_pool.init_paged_cache)."""
    s = h.shard_shape()
    return (s[0], s[1] - 1) + s[2:]


def test_sharded_decode_dense_parity_and_cache_sharding(meshes):
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=32)
    jsp, jc, sp, c = _decode_parity(jcfg, 0, 4, meshes[4])
    assert c["k"].shard_shape() == _shard(jc["k"])
    assert c["k"].shard_shape()[3] == jcfg.num_heads // 4
    fc = sp["blocks"]["fc_w"]
    assert fc.shard_shape() == _shard(jsp["blocks"]["fc_w"])
    assert fc.shard_shape()[2] == fc.shape[2] // 4


def test_sharded_decode_gqa_cache_shards_over_kv_heads(meshes):
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=32)
    _, jc, _, c = _decode_parity(jcfg, 1, 2, meshes[2])
    assert c["k"].shard_shape() == _shard(jc["k"])
    assert c["k"].shard_shape()[3] == jcfg.kv_heads // 2


def test_sharded_decode_gqa_indivisible_heads_replicate_cache(meshes):
    """mp 4 does not divide Hkv 2: the cache replicates (JAX's shard
    shape), every rank keeps all kv heads, and the numerics hold."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=32)
    _, jc, sp, c = _decode_parity(jcfg, 2, 4, meshes[4])
    assert c["k"].shard_shape() == _shard(jc["k"]) == tuple(c["k"].shape)
    kv = sp["blocks"]["kv_w"]
    assert kv.shard_shape() == tuple(kv.shape)
    assert sp["blocks"]["q_w"].shard_shape()[2] == 32 // 4


@pytest.mark.parametrize("quant,hidden", [("quantize_gpt_int8", 32),
                                          ("quantize_gpt_int4", 128)])
def test_sharded_decode_weight_only_params_shard_too(meshes, quant, hidden):
    """int8 and int4 trees: the weights split as their float twins' (the
    scales cut with them on each rank), and the logits hold."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=hidden, num_layers=2,
                          num_heads=4, max_seq_len=32)
    jsp, _, sp, _ = _decode_parity(jcfg, 3 if hidden == 32 else 4, 2,
                                   meshes[2], quantize=quant)
    qw = sp["blocks"]["fc_w"]
    assert qw.dtype == torch.int8
    assert qw.shard_shape() == _shard(jsp["blocks"]["fc_w"])
    assert qw.shard_shape()[2] == qw.shape[2] // 2
    # a row-split int4 weight: the packed rows of each rank's row block
    pw = sp["blocks"]["proj_w"]
    assert pw.shard_shape() == _shard(jsp["blocks"]["proj_w"])


def test_sharded_decode_updates_the_cache_in_place(meshes):
    """JAX donates the cache (tests/test_decode_hot_path.py); the port's
    step writes the ranks' cache in place and hands the same cache
    back."""
    jcfg = jgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=32)
    jp, cfg, p = _both_params(jcfg, 5)
    jsp, jmake, jdecode = JG.build_sharded_decode(jp, jcfg, _jmesh(2))
    jc = jmake(1, 8)
    _, jc2 = jdecode(jsp, jc, jnp.zeros((1,), jnp.int32), jnp.asarray(0))
    assert jc["k"].is_deleted() and not jc2["k"].is_deleted()
    sp, make, decode = G.build_sharded_decode(p, cfg, meshes[2])
    c = make(1, 8)
    assert not c["k"].fetch().any()
    _, c2 = decode(sp, c, torch.zeros(1, dtype=torch.int64), 0)
    assert c2 is c
    k = c["k"].fetch()
    assert k[:, 0, 0].abs().sum() > 0 and not k[:, 0, 1:].any()
    np.testing.assert_allclose(_np(k), np.asarray(jc2["k"], np.float32),
                               **TOL)


# ---------------------------------------------------------------------------
# the decode kernel route under the mesh (tests/test_decode_attention.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_interpret():
    """JAX's decode and flash kernels in interpret mode for one test
    (tests/test_decode_attention.py's ``interpret`` fixture)."""
    from paddle_tpu.ops import flash_attention as jfa

    old = jda._INTERPRET, jfa._INTERPRET
    jda._INTERPRET = jfa._INTERPRET = True
    JG._GEN_CACHE.clear()
    jserving._STEP_CACHE.clear()
    yield
    jda._INTERPRET, jfa._INTERPRET = old
    JG._GEN_CACHE.clear()
    jserving._STEP_CACHE.clear()


def _kcfg():
    return jgpt.GPTConfig(vocab_size=64, hidden_size=256, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=64)


def test_sharded_decode_kernel_route_parity(jax_interpret, meshes,
                                            monkeypatch):
    """JAX's sharded step with its decode kernel engaged (interpret) and
    the port's sharded step (the kernel's plain twin on CPU ranks) agree
    within JAX's stated 3e-2 and pick the same tokens as JAX's unsharded
    einsum decode."""
    jcfg = _kcfg()
    jp, cfg, p = _both_params(jcfg, 0)
    toks = [5, 9, 3]
    monkeypatch.setenv("PADDLE_TPU_FLASH_DECODE", "0")
    jr = JG.init_cache(jcfg, 1, 16)
    want = None
    for pos, t in enumerate(toks):
        want, jr = JG.decode_step(jp, jr, jnp.asarray([t], jnp.int32), pos,
                                  jcfg)
    monkeypatch.setenv("PADDLE_TPU_FLASH_DECODE", "1")
    calls = {"n": 0}
    orig = jda._decode_call

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    jsp, jmake, jdecode = JG.build_sharded_decode(jp, jcfg, _jmesh(2))
    jc = jmake(1, 16)
    jda._decode_call = counted
    try:
        for pos, t in enumerate(toks):
            jgot, jc = jdecode(jsp, jc, jnp.asarray([t], jnp.int32),
                               jnp.asarray(pos))
    finally:
        jda._decode_call = orig
    assert calls["n"] >= 1
    sp, make, decode = G.build_sharded_decode(p, cfg, meshes[2])
    c = make(1, 16)
    for pos, t in enumerate(toks):
        got, c = decode(sp, c, torch.tensor([t]), pos)
    np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=3e-2,
                               rtol=3e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-2,
                               rtol=3e-2)
    assert (_np(got).argmax(-1) == np.asarray(want).argmax(-1)).all()


def test_sharded_decode_int8_cache_specs(meshes, monkeypatch):
    """PADDLE_TPU_KV_DTYPE=int8: the scale planes split with the values,
    in both packages, and the logits agree."""
    jcfg = _kcfg()
    jp, cfg, p = _both_params(jcfg, 0)
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    JG._GEN_CACHE.clear()
    jsp, jmake, jdecode = JG.build_sharded_decode(jp, jcfg, _jmesh(2))
    sp, make, decode = G.build_sharded_decode(p, cfg, meshes[2])
    jc, c = jmake(1, 8), make(1, 8)
    assert set(c) == set(jc) == {"k", "v", "k_s", "v_s"}
    for name in ("k", "k_s"):
        assert c[name].shard_shape() == _shard(jc[name])
        assert c[name].shard_shape()[3] == 1
    jl, _ = jdecode(jsp, jc, jnp.zeros((1,), jnp.int32), jnp.asarray(0))
    got, _ = decode(sp, c, torch.zeros(1, dtype=torch.int64), 0)
    assert got.shape == (1, cfg.vocab_size)
    # int8 rows quantized from bf16 rows the packages round alike but for
    # the last bits may part by one quantization step: the kernel case's
    # 3e-2 (JAX states none for int8 logits)
    np.testing.assert_allclose(_np(got), np.asarray(jl), atol=3e-2,
                               rtol=3e-2)


def test_sharded_decode_kv_flag_flip_fails_loudly(meshes, monkeypatch):
    jcfg = _kcfg()
    jp, cfg, p = _both_params(jcfg, 0)
    msgs = []
    for build, params, c, mesh in ((JG.build_sharded_decode, jp, jcfg,
                                    _jmesh(2)),
                                   (G.build_sharded_decode, p, cfg,
                                    meshes[2])):
        monkeypatch.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
        _, make, _ = build(params, c, mesh)
        monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
        with pytest.raises(ValueError,
                           match="PADDLE_TPU_KV_DTYPE changed") as e:
            make(1, 8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# a failed rank fails the server loudly, in bounded time
# ---------------------------------------------------------------------------


def test_dead_rank_fails_the_server_within_the_deadline():
    """A rank killed mid-serve: the next tick raises ``RankFailure``
    within the pool's deadline, the pool refuses later calls, and
    ``close()`` (server and pool) returns."""
    _, cfg, p = _both_params(jgpt.GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        max_seq_len=32, dtype=jnp.float32), 0)
    pool = serving_mesh.RankPool(2, device="cpu", timeout_s=20.0)
    try:
        srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=16,
                                   mesh=pool.mesh({"mp": 2}))
        srv.submit([3, 7, 2], max_new_tokens=8)
        srv.tick()
        os.kill(pool.procs[1].pid, signal.SIGKILL)
        pool.procs[1].join(10)
        t0 = time.monotonic()
        with pytest.raises(serving_mesh.RankFailure):
            while srv.pending():
                srv.tick()
        assert time.monotonic() - t0 < 20.0
        with pytest.raises(serving_mesh.RankFailure, match="broken"):
            pool.call([0], "paddle_tpu_torch.text.tp_serving:rank_sync")
        srv.close()
    finally:
        pool.close()
    assert not any(pr.is_alive() for pr in pool.procs)
