"""The port's expert-parallel serving (``DecodeServer(mesh=, ep_axis=)``,
``moe_serving``'s regex partition rules) against the JAX package's on
its 8-device CPU mesh: the cases of tests/test_moe_serving.py that place
an MoE model on a mesh.

The port's ranks are four CPU processes over gloo (one pool for the
module, one intra-op thread a rank): an (ep 2, mp 2) mesh and an mp 2
one.  Weights are numpy-drawn (std 0.3, fp32: JAX's random init
collapses an MoE model onto attractor tokens) and carried to both
packages.  Required: the spec trees equal JAX's leaf for leaf; the TP
server's greedy streams exactly equal to JAX's TP server's, JAX's
capacity-free ``dense_reference_greedy`` and the port's single-device
server's, with the drop and load counters equal to the single-device
server's; each rank's expert blocks shaped as JAX's ``shard_shape``;
every refusal JAX's exception type and message.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import moe_serving as jms
from paddle_tpu.text import serving as jserving
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import serving_mesh
from paddle_tpu_torch.text import moe_serving, serving

from test_torch_moe import both, jax_cfg

PROMPTS = [[5, 3, 9, 1], [2, 8, 8], [7, 1, 4, 4, 2, 6]]
MAX_NEW = 6


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
    return {"ep_mp": pool.mesh({"ep": 2, "mp": 2}),
            "mp": pool.mesh({"mp": 2})}


def _jmesh(shape, names):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


@pytest.fixture(scope="module")
def model():
    return both(jax_cfg(), seed=11)


@pytest.fixture(scope="module")
def reference(model):
    jcfg, jp, _, _ = model
    return [jms.dense_reference_greedy(jp, jcfg, p, MAX_NEW, 32)
            for p in PROMPTS]


def _serve(srv):
    rids = [srv.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    ticks = 0
    while srv.pending():
        srv.tick()
        ticks += 1
        assert ticks < 200
    return [[int(t) for t in srv.result(r)] for r in rids]


def _tuples(tree):
    return {k: (_tuples(v) if isinstance(v, dict) else tuple(v))
            for k, v in tree.items()}


def _dense_cfg(**over):
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64)
    kw.update(over)
    return jgpt.GPTConfig(**kw)


def test_dense_leaves_match_legacy_resolver():
    """The rule table equals ``_decode_param_specs`` on every dense
    architecture variant, in both packages, and the two packages' trees
    are equal."""
    from paddle_tpu_torch.text import generate as G

    for over in ({}, dict(num_kv_heads=2), dict(activation="swiglu"),
                 dict(pos_embed="rope", norm="rmsnorm")):
        jcfg = _dense_cfg(**over)
        jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
        cfg, p = convert.config_from_jax(jcfg), convert.params_from_jax(jp)
        want = G._decode_param_specs(p, cfg, "mp")
        got = moe_serving.moe_decode_param_specs(p, cfg, mp="mp")
        assert got == want, over
        assert got == _tuples(jms.moe_decode_param_specs(jp, jcfg, mp="mp"))


def test_moe_leaves_shard_over_ep_and_mp(model):
    jcfg, jp, cfg, p = model
    m = moe_serving.moe_decode_param_specs(p, cfg, mp="mp",
                                           ep="ep")["blocks"]["moe"]
    jm = jms.moe_decode_param_specs(jp, jcfg, mp="mp",
                                    ep="ep")["blocks"]["moe"]
    assert m == _tuples(jm)
    assert m["router_w"] == (None, None, None)
    assert m["w_in"] == (None, "ep", None, "mp")
    assert m["b_in"] == (None, "ep", "mp")
    assert m["w_out"] == (None, "ep", "mp", None)
    assert m["b_out"] == (None, "ep", None)
    m2 = moe_serving.moe_decode_param_specs(p, cfg, mp="mp")["blocks"]["moe"]
    assert m2["w_in"] == (None, None, None, "mp")


def test_unmatched_leaf_raises_and_scalars_replicate():
    rules, jrules = [(r"^a$", ("mp",))], [(r"^a$", P("mp"))]
    tree = {"a": np.zeros((2,), np.float32),
            "mystery": np.zeros((2,), np.float32)}
    with pytest.raises(ValueError, match="no partition rule matches") as je:
        jms.match_partition_rules(
            jrules, jax.tree_util.tree_map(jnp.asarray, tree))
    with pytest.raises(ValueError, match="no partition rule matches") as e:
        moe_serving.match_partition_rules(rules, tree)
    assert str(e.value) == str(je.value)
    got = moe_serving.match_partition_rules(
        rules, {"a": np.zeros((2,), np.float32),
                "step": np.zeros((), np.float32)})
    assert got == {"a": ("mp",), "step": ()}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ep_mp_mesh_shards_experts_and_matches_reference(model, reference,
                                                         meshes, layout):
    """DecodeServer(mesh=(ep 2, mp 2)): each rank holds E/2 experts and
    F/2 of their FFN columns, the router whole, the cache's Hkv axis
    split over mp — and the greedy tokens equal the dense-eval reference,
    JAX's TP server's and the single-device server's, with its drop and
    load counters."""
    jcfg, jp, cfg, p = model
    kw = dict(max_batch=2, max_len=32)
    if layout == "paged":
        kw.update(layout="paged", block_size=8)
    one = serving.DecodeServer(p, cfg, device="cpu", **kw)
    ref = _serve(one)
    ref_stats = one._moe_snapshot()
    one.close()
    jsrv = jserving.DecodeServer(jp, jcfg, mesh=_jmesh((2, 2), ("ep", "mp")),
                                 mp_axis="mp", ep_axis="ep", **kw)
    jgot = _serve(jsrv)
    jm = jsrv.params["blocks"]["moe"]
    jk = jsrv.cache["k"]
    srv = serving.DecodeServer(p, cfg, mesh=meshes["ep_mp"], mp_axis="mp",
                               ep_axis="ep", **kw)
    m = srv.params["blocks"]["moe"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    D, F = cfg.hidden_size, cfg.hidden_size * cfg.ffn_ratio
    for name in ("w_in", "w_out", "b_in", "b_out", "router_w"):
        assert m[name].shard_shape() == tuple(
            jm[name].sharding.shard_shape(jm[name].shape))
    assert m["w_in"].shard_shape() == (L, E // 2, D, F // 2)
    assert m["w_out"].shard_shape() == (L, E // 2, F // 2, D)
    assert m["router_w"].shard_shape() == tuple(m["router_w"].shape)
    k = srv.cache["k"]
    assert k.shard_shape()[3] == cfg.kv_heads // 2
    assert k.shard_shape()[3] == jk.sharding.shard_shape(jk.shape)[3]
    got = _serve(srv)
    stats = srv._moe_snapshot()
    srv.close()
    jsrv.close()
    assert got == jgot == ref == reference
    assert stats == ref_stats


def test_pure_tp_replicates_experts(model, reference, meshes):
    """ep_axis=None on an MoE model: every rank holds all experts and
    F/2 of their columns; the streams are the reference's."""
    jcfg, jp, cfg, p = model
    srv = serving.DecodeServer(p, cfg, max_batch=2, max_len=32,
                               mesh=meshes["mp"])
    m = srv.params["blocks"]["moe"]
    assert m["w_in"].shard_shape()[1] == cfg.moe.num_experts
    assert m["w_in"].shard_shape()[3] == m["w_in"].shape[3] // 2
    assert _serve(srv) == reference
    srv.close()


def test_expert_parallel_placement_is_validated(model, meshes):
    jcfg, jp, cfg, p = model
    dense_j = _dense_cfg()
    djp = jax.device_get(jgpt.init_params(dense_j, jax.random.PRNGKey(0)))
    dcfg, dp = convert.config_from_jax(dense_j), convert.params_from_jax(djp)
    three_j = jax_cfg(E=3)
    tjp = jax.device_get(jgpt.init_params(three_j, jax.random.PRNGKey(0)))
    tcfg, tp = convert.config_from_jax(three_j), convert.params_from_jax(tjp)
    msgs = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            mk, args = jserving.DecodeServer, {}
            mesh, mp_only = _jmesh((2, 2), ("ep", "mp")), _jmesh((2,),
                                                                 ("mp",))
            a, b, c = (jp, jcfg), (djp, dense_j), (tjp, three_j)
        else:
            mk, args = serving.DecodeServer, {}
            mesh, mp_only = meshes["ep_mp"], meshes["mp"]
            a, b, c = (p, cfg), (dp, dcfg), (tp, tcfg)
        got = []
        with pytest.raises(ValueError, match="ep_axis requires mesh") as e:
            mk(*a, max_batch=1, max_len=16, ep_axis="ep")
        got.append(str(e.value))
        with pytest.raises(ValueError, match="cfg.moe is None") as e:
            mk(*b, max_batch=1, max_len=16, mesh=mesh, ep_axis="ep")
        got.append(str(e.value))
        with pytest.raises(ValueError, match="no 'ep' axis") as e:
            mk(*a, max_batch=1, max_len=16, mesh=mp_only, ep_axis="ep")
        got.append(str(e.value))
        with pytest.raises(ValueError, match="not divisible") as e:
            mk(*c, max_batch=1, max_len=16, mesh=mesh, ep_axis="ep")
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
