"""The port's weight-only quantization (paddle_tpu_torch/text/woq.py) and
its W4A16 matmul (ops/woq_matmul.py) against the JAX package's.

* ``quantize_gpt_int8`` / ``quantize_gpt_int4`` (including the per-channel
  int8 fallback of an input dim that does not divide into groups) and
  ``pack_int4_halves`` are bit-identical to the JAX package's on the same
  fp32 weights — also through ``convert.params_from_jax`` of a JAX
  quantized tree;
* ``_plain_w4`` against ``_xla_w4`` and the interpret-mode Pallas kernel;
* ``w`` (bit for bit), ``mm``, ``mm_stacked``, ``embed``, ``logits`` and
  whole-model forward logits on int8 and int4 trees, MHA and GQA, with
  ``PADDLE_TPU_W4_KERNEL`` off and on (fp32: 1e-5 on a matmul, 1e-4 on
  the logits — summation order; bf16 W4 outputs 1e-2·(1 + |ref|));
* greedy tokens of ``DecodeServer`` on the int8 and int4 (gs 32)
  ``markov_gpt`` equal to JAX ``generate`` on the same quantized tree.

The CUDA kernel runs only on a card: tests/test_torch_kernels_cuda.py
holds it against ``_plain_w4``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import woq_matmul as jwm
from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu.text import woq as jwoq
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import woq_matmul as wm
from paddle_tpu_torch.text import gpt, serving, woq

from test_torch_gpt import _jcfg

ARCHS = [("learned", "layernorm", "gelu", None),
         ("rope", "rmsnorm", "swiglu", 2)]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(jwm, "_INTERPRET", True)


@functools.lru_cache(maxsize=None)
def _float_tree(arch, hidden_size=64):
    """(JAX config, its float parameter tree as numpy arrays) — read only."""
    jcfg = _jcfg(*arch, hidden_size=hidden_size)
    return jcfg, jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))


def _quantize(mod, tree, bits, gs):
    return mod.quantize_gpt_int8(tree) if bits == 8 \
        else mod.quantize_gpt_int4(tree, group_size=gs)


def _leaves(tree):
    for n, v in tree.items():
        if n == "blocks":
            yield from ((f"blocks.{k}", t) for k, t in v.items())
        else:
            yield n, v


def _assert_same(got: dict, ref: dict):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for name, t in ref.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("bits,gs,hidden", [(8, None, 64), (4, 32, 64),
                                            (4, 64, 64), (4, 32, 48)])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_trees_are_bit_identical_to_jax(arch, bits, gs, hidden):
    """The JAX quantized tree carried over by ``params_from_jax`` equals
    the port's quantization of the carried-over float tree, leaf for leaf
    and bit for bit.  Hidden 48 at gs 32: the input dims 48 do not divide
    into groups and fall back to per-channel int8; out_w (192) packs."""
    jcfg, jp = _float_tree(arch, hidden_size=hidden)
    got = _quantize(woq, convert.params_from_jax(jp), bits, gs)
    _assert_same(got, convert.params_from_jax(
        jax.device_get(_quantize(jwoq, jp, bits, gs))))
    assert woq.is_quantized(got)
    s, q = got["blocks"]["out_w_s"], got["blocks"]["out_w"]
    assert s.dim() == (q.dim() + 1 if bits == 4 else q.dim())
    if hidden == 48:
        assert got["blocks"]["fc_w_s"].dim() == got["blocks"]["fc_w"].dim()


def test_pack_int4_halves_is_bit_identical_to_jax():
    q = np.random.default_rng(0).integers(-7, 8, (3, 10, 5))
    q[0, 0, :2] = [-7, 7]
    got = woq.pack_int4_halves(torch.from_numpy(q))
    ref = jwoq.pack_int4_halves(q)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(wm.unpack_int4(got).numpy(), q)


def test_moe_and_lora_trees_raise():
    """MoE trees quantize since the MoE slice (the expert stacks as
    JAX's; tests/test_torch_moe.py holds them bit-equal): here a tree with
    a ``blocks["moe"]`` subtree does not raise, and its router stays
    float.  LoRA leaves no longer raise either since the LoRA slice:
    ``woq.w`` adds ``a @ b`` after dequantization, on a float and on an
    int8 weight (tests/test_torch_lora.py holds it against JAX)."""
    _, jp = _float_tree(ARCHS[0])
    tree = convert.params_from_jax(jp)
    blocks = dict(tree["blocks"])
    E, D, F = 2, blocks["fc_w"].shape[1], blocks["fc_w"].shape[2]
    L = blocks["fc_w"].shape[0]
    blocks["moe"] = {"router_w": torch.zeros(L, D, E),
                     "w_in": torch.ones(L, E, D, F),
                     "b_in": torch.zeros(L, E, F),
                     "w_out": torch.ones(L, E, F, D),
                     "b_out": torch.zeros(L, E, D)}
    moe = {**tree, "blocks": blocks}
    for quant in (woq.quantize_gpt_int8, woq.quantize_gpt_int4):
        got = quant(moe)["blocks"]["moe"]
        assert got["w_in"].dtype == torch.int8 and "w_in_s" in got
        assert got["router_w"].dtype == torch.float32
    for t in (tree, woq.quantize_gpt_int8(tree)):
        p = gpt.layer(t, 0)
        base = woq.w(p, "proj_w", torch.float32)
        a = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
        b = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
        p["proj_w_lora_a"], p["proj_w_lora_b"] = a, b
        assert torch.equal(woq.w(p, "proj_w", torch.float32), base + a @ b)
        assert not woq._w4_qualifies(p, "proj_w", 2)


def _w4_case(N, K, M, gs, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, K)).astype(np.float32)
    q = rng.integers(-7, 8, (K, M))
    q[:2, :2] = [[-7, 7], [7, -7]]              # nibble extremes, both halves
    q[K // 2:K // 2 + 2, :2] = [[-7, 7], [7, -7]]
    scale = rng.uniform(0.01, 0.1, (K // gs, 1, M)).astype(np.float32)
    packed = jwoq.pack_int4_halves(q)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return ((jnp.asarray(x, jdt), jnp.asarray(packed), jnp.asarray(scale)),
            (tx, torch.from_numpy(packed), torch.from_numpy(scale)))


@pytest.mark.parametrize("N,K,M,gs,dtype", [
    (3, 128, 256, 32, "float32"),     # Pallas pads N 3 -> 8
    (16, 512, 256, 64, "float32"),    # several Pallas k blocks
    (8, 256, 128, 64, "bfloat16"),
])
def test_plain_w4_matches_xla_and_pallas_interpret(interpret, N, K, M, gs,
                                                   dtype):
    jargs, targs = _w4_case(N, K, M, gs, dtype)
    got = wm._plain_w4(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (N, M)
    for ref in (jwm._xla_w4(*jargs), jwm.w4_matmul(*jargs)):
        ref = np.asarray(ref, np.float32)
        tol = 1e-4 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                                   rtol=tol)


def test_w4_matmul_contract_on_the_cpu():
    """Leading dims flatten; a shape mismatch raises ``ValueError``; N
    above ``_N_CAP`` (prefill-sized) and CPU tensors take the plain twin,
    counting no launch."""
    _, (x, packed, scale) = _w4_case(300, 128, 64, 32, "float32")
    before = wm.w4_matmul.launches
    out = wm.w4_matmul(x.reshape(3, 100, 128), packed, scale)
    assert out.shape == (3, 100, 64)
    torch.testing.assert_close(out.reshape(300, 64),
                               wm._plain_w4(x, packed, scale), atol=0, rtol=0)
    assert wm.w4_matmul.launches == before
    with pytest.raises(ValueError, match="shape mismatch"):
        wm.w4_matmul(x[:, :126], packed, scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        wm.w4_matmul(x, packed, scale[:3])
    assert wm.splits_for(8, 2048, 2048, 132, "fma") > 1      # fills the card
    assert wm.splits_for(256, 2048, 2048, 132, "fma") == 1
    assert wm.splits_for(8, 2048, 2048, 132, "tc") > 1
    assert wm.splits_for(256, 2048, 2048, 132, "tc") == 1
    assert wm.w4_matmul.tc_launches >= 0      # the tensor-core body's count


@pytest.mark.parametrize("dtype,K,gs,want", [
    (torch.bfloat16, 192, 32, "tc"),
    (torch.bfloat16, 192, 48, "tc"),
    (torch.bfloat16, 2048, 64, "tc"),         # gpt_1p3b, group 64
    (torch.bfloat16, 160, 40, "fma"),         # gs not a multiple of 16
    (torch.bfloat16, 48, 16, "fma"),          # K/2 not a multiple of 16
    (torch.float32, 2048, 64, "fma"),         # fp32 x is never rounded
])
def test_w4_route(dtype, K, gs, want):
    assert wm.route(dtype, 8, K, 2048, gs) == want
    assert wm.route(dtype, 256, K, 130, gs) == want   # N, M do not matter


def test_w4_route_refuses_an_unknown_dtype():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wm.route(torch.float16, 8, 2048, 2048, 64)


@pytest.mark.parametrize("K,M", [(2048, 2048), (2048, 8192), (8192, 2048)])
def test_w4_tc_splits_fill_the_card_at_a_tick(K, M):
    """At N = 8 the tensor-core route's 64-column tiles times the K splits
    give every one of 132 SMs a CTA; at N = 256 the partials would outgrow
    half the weight, so one split; a split walks whole 64-row stages and
    none is empty."""
    sms = 132
    s8 = wm.splits_for(8, K, M, sms, "tc")
    assert -(-M // 64) * s8 >= sms
    assert wm.splits_for(256, K, M, sms, "tc") <= max(1, K // (16 * 256))
    assert wm.splits_for(256, 2048, 2048, sms, "tc") == 1
    for N in (1, 8, 16, 64, 100, 128, 256):
        s = wm.splits_for(N, K, M, sms, "tc")
        per = -(-(K // 2) // s)
        chunk = -(-per // 64) * 64
        assert chunk % 64 == 0 and (s - 1) * chunk < K // 2 <= s * chunk


@pytest.mark.parametrize("w4", ["0", "1"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_accessors_match_jax(arch, bits, w4, interpret, monkeypatch):
    """Per-layer ``w`` bit for bit; ``mm`` / ``mm_stacked`` on every block
    weight, ``embed`` and ``logits`` against the JAX accessors.  With the
    W4 flag, every packed weight's matmul goes through ``w4_matmul`` (one
    call per stack slice)."""
    monkeypatch.setenv("PADDLE_TPU_W4_KERNEL", w4)
    jcfg, jp = _float_tree(arch)
    jq = _quantize(jwoq, jp, bits, 32)
    tq = _quantize(woq, convert.params_from_jax(jp), bits, 32)
    calls = []
    monkeypatch.setattr(woq, "w4_matmul",
                        lambda *a: calls.append(1) or wm.w4_matmul(*a))
    jl = {k: v[1] for k, v in jq["blocks"].items()}
    tl = gpt.layer(tq, 1)
    h = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    want = 0
    for name in woq._BLOCK_WEIGHTS:
        if name not in tl:
            continue
        np.testing.assert_array_equal(
            woq.w(tl, name, torch.float32).numpy(),
            np.asarray(jwoq.w(jl, name, jnp.float32)))
        stacked = tl[name].dim() == 3
        hn = h if name != "out_w" else np.tile(h, 4)        # [.., F]
        got = (woq.mm_stacked if stacked else woq.mm)(
            torch.from_numpy(hn), tl, name, torch.float32)
        ref = (jwoq.mm_stacked if stacked else jwoq.mm)(
            jnp.asarray(hn), jl, name, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=name)
        if bits == 4 and w4 == "1":
            want += tl[name].shape[0] if stacked else 1
    assert len(calls) == want
    tok = np.array([[3, 0, 63]])
    np.testing.assert_array_equal(
        woq.embed(tq, torch.from_numpy(tok), torch.float32).numpy(),
        np.asarray(jwoq.embed(jq, jnp.asarray(tok), jnp.float32)))
    np.testing.assert_allclose(
        woq.logits(torch.from_numpy(h), tq, torch.float32).numpy(),
        np.asarray(jwoq.logits(jnp.asarray(h), jq, jnp.float32)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_of_quantized_models_match_jax(arch, bits,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_W4_KERNEL", "1")
    jcfg, jp = _float_tree(arch)
    jq = _quantize(jwoq, jp, bits, 32)
    tq = convert.params_from_jax(jax.device_get(jq))
    toks = np.random.default_rng(2).integers(0, 64, (2, 9))
    ref = np.asarray(jgpt.forward(jq, jnp.asarray(toks), jcfg))
    out = gpt.forward(tq, torch.from_numpy(toks), convert.config_from_jax(jcfg))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def _rule_run(t0, n):
    out = [t0]
    for _ in range(n - 1):
        out.append((out[-1] * 3 + 1) % 13)
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_markov_served_tokens_equal_jax_generate(markov_gpt, bits,
                                                 monkeypatch):
    """The trained ``markov_gpt`` fixture (bf16), quantized in the JAX
    package (int4 at gs 32) and carried over: the port's server, with the
    W4 flag on, serves exactly JAX ``generate``'s greedy tokens on the
    same quantized tree, and they follow the rule."""
    monkeypatch.setenv("PADDLE_TPU_W4_KERNEL", "1")
    jcfg, jparams = markov_gpt
    jq = _quantize(jwoq, jparams, bits, 32)
    cfg = convert.config_from_jax(jcfg)
    srv = serving.DecodeServer(convert.params_from_jax(jax.device_get(jq)),
                               cfg, max_batch=3, max_len=32, device="cpu")
    prompts = [_rule_run(1, 3), _rule_run(4, 9), _rule_run(7, 5)]
    rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(100):
        if not srv.pending():
            break
        srv.tick()
    for p, rid in zip(prompts, rids):
        got = srv.result(rid)
        solo = np.asarray(JG.generate(jq, jcfg, np.asarray([p]), 8))
        assert got == solo[0, len(p):].tolist()
        assert [p[-1]] + got == _rule_run(p[-1], 9)
