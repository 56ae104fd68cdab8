"""The port's split-KV decode attention (paddle_tpu_torch/ops/
decode_attention.py) held against the JAX package's Pallas kernel
(``_decode_call``, run in interpret mode on the CPU) and its XLA oracle
(``_xla_decode``): the same numpy inputs go through both.

Tolerances: fp32 throughout, so the only differences are summation
order (the Pallas kernel walks 128-row blocks with an online softmax,
the plain twin takes one softmax over the row) — atol 1e-5.  The int8
format must agree bit for bit.  The kernel itself runs only on a card:
tests/test_torch_kernels_cuda.py holds it against this plain twin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import decode_attention as jda
from paddle_tpu_torch.ops import decode_attention as da


@pytest.fixture()
def interpret():
    """Run the JAX decode kernel in Pallas interpret mode for one test."""
    old = jda._INTERPRET
    jda._INTERPRET = True
    yield
    jda._INTERPRET = old


B, HKV, T, HD = 3, 2, 384, 64   # T = 3 Pallas blocks of 128 rows


def _inputs(G, Tq, kv, seed=0):
    """q [B, Tq, HKV*G, HD] and a [B, T, HKV, HD] cache (fp32, or int8
    through each package's own quantize_kv) plus per-row positions:
    row 0's frontier sits inside the first block, row 2's at the end."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, HKV * G, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    pos = np.array([5, 200, T - Tq], np.int32)
    jin = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
           None, None]
    tin = [torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
           torch.from_numpy(pos), None, None]
    if kv == "int8":
        jin[1], jin[4] = jda.quantize_kv(jin[1])
        jin[2], jin[5] = jda.quantize_kv(jin[2])
        tin[1], tin[4] = da.quantize_kv(tin[1])
        tin[2], tin[5] = da.quantize_kv(tin[2])
    return jin, tin


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("Tq", [1, 3])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_pallas_interpret(interpret, G, Tq, kv):
    jin, tin = _inputs(G, Tq, kv)
    assert jda.supported(jin[0].shape, jin[1].shape)
    ref = np.asarray(jda._decode_call(*jin, None))
    out = da.decode_attention(*tin[:4], k_scale=tin[4], v_scale=tin[5])
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("Tq", [1, 3])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_xla_oracle(G, Tq, kv):
    jin, tin = _inputs(G, Tq, kv, seed=1)
    ref = np.asarray(jda._xla_decode(*jin, None))
    out = da._plain_decode(*tin, None)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 16, 3, HD)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the 1e-8 floor
    x[1, 2, 1, :5] = [127.5, -0.5, 0.5, 1.5, 2.5]   # round-half-even ties
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jda.quantize_kv(jx)
    tq, ts = da.quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        da.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jda.dequantize_kv(jq, js, jnp.float32)))


def _good():
    q = torch.zeros(2, 1, 4, 64)
    k = torch.zeros(2, 16, 4, 64)
    return dict(q=q, k=k, v=k.clone(), pos=torch.zeros(2, dtype=torch.int32),
                k_scale=None, v_scale=None)


@pytest.mark.parametrize("bad,match", [
    (dict(q=torch.zeros(2, 1, 4, 48), k=torch.zeros(2, 16, 4, 48),
          v=torch.zeros(2, 16, 4, 48)), "head_dim 48"),
    (dict(q=torch.zeros(2, 1, 4, 64, dtype=torch.float16)),
     "got torch.float16"),
    (dict(pos=torch.zeros(2, dtype=torch.int64)), "pos must be int32"),
    (dict(q=torch.zeros(2, 257, 16, 64)), "Tq \\* G = 1028"),
    (dict(k=torch.zeros(2, 4, 16, 64).transpose(1, 2)), "k must be contig"),
    (dict(k=torch.zeros(2, 16, 4, 64, dtype=torch.int8),
          v=torch.zeros(2, 16, 4, 64, dtype=torch.int8)), "need k_scale"),
    (dict(k=torch.zeros(2, 16, 3, 64), v=torch.zeros(2, 16, 3, 64)),
     "does not match"),
], ids=["head_dim", "q_dtype", "pos_dtype", "rows_per_cta", "strided_k",
        "no_scales", "gqa_ratio"])
def test_kernel_wrapper_refuses(bad, match):
    """What the kernel does not take raises before any launch, each case
    on its own check (the checks run on any device; a CUDA tensor is never
    sent to the plain path)."""
    args = {**_good(), **bad}
    with pytest.raises((TypeError, ValueError), match=match):
        da._check(args["q"], args["k"], args["v"], args["pos"],
                  args["k_scale"], args["v_scale"])


def test_kernel_wrapper_accepts_good_inputs():
    g = _good()
    da._check(g["q"], g["k"], g["v"], g["pos"], None, None)


@pytest.mark.parametrize("G", [1, 4])
def test_wide_query_block_matches_jax_attend_cache(interpret, G):
    """A prefill chunk's query block (Tq = 256, so Tq * G up to 1024 rows
    per kv head): the port's plain paths equal the JAX ``_attend_cache``,
    which reaches the interpret-mode Pallas kernel at that width."""
    from paddle_tpu.text import generate as JG
    from paddle_tpu.text import gpt as jgpt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.text import generate as G_

    Tq, Hkv, hd, T, pos0 = 256, 2, 64, 512, 100
    jcfg = jgpt.GPTConfig(vocab_size=16, hidden_size=Hkv * G * hd,
                          num_layers=1, num_heads=Hkv * G,
                          num_kv_heads=Hkv, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, Tq, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((1, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((1, T, Hkv, hd)).astype(np.float32)
    assert jda.supported(q.shape, k.shape)
    ref = np.asarray(JG._attend_cache(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos0, jnp.int32), jcfg))
    pos = torch.tensor([pos0], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = G_._attend_cache(tq, {"k": tk, "v": tv}, pos,
                           convert.config_from_jax(jcfg))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    plain = da.decode_attention(tq, tk, tv, pos)
    np.testing.assert_allclose(plain.reshape(1, Tq, -1).numpy(), ref,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("Bn,Hkv,Tn,R", [(1, 16, 512, 512), (1, 16, 512, 1024),
                                         (8, 16, 512, 1), (2, 4, 2048, 100)])
def test_split_plan_counts_query_tiles(Bn, Hkv, Tn, R):
    """Wide query blocks already give one CTA per 64-row tile: the plan
    splits the cache walk only as far as the card needs more CTAs."""
    chunk, nsplit = da.split_plan(Bn, Hkv, Tn, R)
    assert chunk % 64 == 0 and chunk * nsplit >= Tn
    assert chunk * (nsplit - 1) < Tn
    cells = Bn * Hkv * -(-R // 64)          # CTAs per split
    # at least half the target (whole 64-row splits round the count)
    assert cells * nsplit >= min(264, cells * -(-Tn // 64)) // 2
    assert nsplit == 1 or cells * (nsplit - 1) < 264


@pytest.mark.parametrize("Bn,Hkv,Tn", [(1, 16, 2048), (8, 16, 512),
                                       (8, 4, 512), (3, 2, 40), (64, 16, 8)])
def test_split_plan_covers_cache(Bn, Hkv, Tn):
    chunk, nsplit = da.split_plan(Bn, Hkv, Tn)
    assert chunk % 64 == 0 and chunk * nsplit >= Tn
    assert chunk * (nsplit - 1) < Tn          # no split starts past T
