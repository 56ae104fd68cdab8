"""The routes of the port's two attention-forward kernels and of the flash
backward, and the plain twins at the shapes those routes take.

``flash_attention.route``, ``flash_attention.route_bwd``,
``decode_attention.route`` and ``decode_attention.paged_route`` name the
body a launch runs (a tensor-core body on ``csrc/attn_tc.cuh``, the
decode tick's body in ``csrc/decode_tick.cuh``, or the older FMA /
split-KV body);
``decode_attention.tc_split_plan`` and ``tick_plan`` cut the tensor-core
and tick routes' cache walks.  All are plain Python, checked here on
the CPU; the kernels themselves run only on a card
(tests/test_torch_kernels_cuda.py checks that ``tc_launches`` counts
exactly what ``route`` names).

The plain twins are held against the JAX package's Pallas kernels in
interpret mode at the shapes the tensor-core routes take and the older
tests do not reach: wide query blocks (R = Tq * G in the hundreds) with
pos > 0, G = 4, int8 caches and head_dim 64; the flash forward over
several 128-row blocks at head_dim 128.  Tolerances: fp32 throughout, so
only summation order differs (the Pallas kernels walk blocks with an
online softmax, the twins take one softmax per row) — atol 1e-5.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from paddle_tpu.ops import decode_attention as jda
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa

_CSRC = Path(da.__file__).resolve().parent.parent / "csrc"


@pytest.fixture()
def interpret():
    """Run the JAX Pallas kernels in interpret mode for one test."""
    old = jda._INTERPRET, jfa._INTERPRET
    jda._INTERPRET = jfa._INTERPRET = True
    yield
    jda._INTERPRET, jfa._INTERPRET = old


# --------------------------------------------------------------- routes


@pytest.mark.parametrize("R,qdt,hd,kvdt,want", [
    (1, "bfloat16", 128, "bfloat16", "tick"),        # the decode tick
    (da.R_TC - 1, "bfloat16", 128, "bfloat16", "tick"),
    (da.R_TC, "bfloat16", 128, "bfloat16", "tc"),
    (512, "bfloat16", 128, "bfloat16", "tc"),        # an admission chunk
    (1024, "bfloat16", 64, "int8", "tc"),
    (256, "bfloat16", 256, "int8", "tc"),
    (512, "bfloat16", 128, "float32", "split"),      # fp32 cache
    (512, "float32", 128, "float32", "split"),       # fp32 q
    (512, "float32", 64, "int8", "split"),
])
def test_decode_route(R, qdt, hd, kvdt, want):
    assert da.route(R, getattr(torch, qdt), hd, getattr(torch, kvdt)) == want


def test_decode_route_reads_r_tc_at_each_call(monkeypatch):
    assert da.route(64, torch.bfloat16, 128) == "tc"
    monkeypatch.setattr(da, "R_TC", 65)
    assert da.route(64, torch.bfloat16, 128) == "tick"
    assert da.route(65, torch.bfloat16, 128) == "tc"


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("kvdt", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("R", [1, 4, 12, 15])
def test_decode_route_ticks_below_r_tc_for_every_dtype(R, kvdt, qdt, hd):
    """Every width under ``R_TC`` takes the tick body, whatever q's and the
    cache's dtypes; from ``R_TC`` on, fp32 goes to the split-KV body."""
    qd, kd = getattr(torch, qdt), getattr(torch, kvdt)
    assert da.route(R, qd, hd, kd) == "tick"
    wide = "tc" if qdt == "bfloat16" and kvdt != "float32" else "split"
    assert da.route(da.R_TC, qd, hd, kd) == wide


def test_decode_route_matches_the_c_entry():
    """The C entry sends R < r_tc to the tick body before it looks at a
    dtype, then bf16 q over a bf16 or int8 cache to the tensor-core body
    and the rest to the split-KV body, as ``route`` says; the tick body's
    row tile is ``tick_rows``'s."""
    src = (_CSRC / "decode_attention.cu").read_text()
    body = src[src.index('extern "C" int decode_attention('):]
    tick, tc = body.index("if (R < r_tc)"), body.index("if (q_dtype != 1")
    assert tick < tc < body.index("chunk_tc::run")
    assert "tick::run" in body[tick:tc]
    assert "split_kv::run" in body[tc:body.index("chunk_tc::run")]
    tick_src = (_CSRC / "decode_tick.cuh").read_text()
    assert "== 1)\n    return launch<QT, KT, HD, 1>" in tick_src
    assert "return launch<QT, KT, HD, 4>" in tick_src
    assert [da.tick_rows(R) for R in (1, 2, 15)] == [1, 4, 4]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("kvdt", ["bfloat16", "int8", "float32"])
def test_paged_route_is_the_contiguous_route(kvdt, qdt, hd):
    """The paged kernel takes the contiguous kernel's body at every width
    and dtype: the tick body below ``R_TC``, then the tensor-core body for
    bf16 q over a bf16 or int8 pool (read in place), else split-KV."""
    qd, kd = getattr(torch, qdt), getattr(torch, kvdt)
    for R in (1, 4, da.R_TC - 1, da.R_TC, 64, 256, 512, 1024):
        assert da.paged_route(R, qd, hd, kd) == da.route(R, qd, hd, kd)


def test_paged_route_matches_the_c_entry():
    """The paged C entry decides as the contiguous one: R < r_tc to the
    tick body (over the block tables) before it looks at a dtype, then
    bf16 q over a bf16 or int8 pool to the tensor-core body, the rest to
    the split-KV body — each instantiated with block-table rows."""
    src = (_CSRC / "paged_decode_attention.cu").read_text()
    body = src[src.index('extern "C" int paged_decode_attention('):]
    tick = body.index("if (Tq * (Hq / Hkv) < r_tc)")
    tc = body.index("if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2))")
    end = body.index("chunk_tc::run(kv_dtype, hd, a, rows)")
    assert tick < tc < end
    assert "tick::run" in body[tick:tc]
    assert "split_kv::run" in body[tc:end]
    assert "split_kv::PagedRows rows{" in body[:tick]


def test_r_tc_is_at_least_16():
    """The sweep's rule: the tick's narrow widths never take the route."""
    assert da.R_TC >= 16


@pytest.mark.parametrize("bad", [
    dict(q_dtype=torch.float16), dict(hd=96), dict(kv_dtype=torch.float16)],
    ids=["q_dtype", "head_dim", "kv_dtype"])
def test_decode_route_refuses(bad):
    args = {**dict(R=64, q_dtype=torch.bfloat16, hd=128,
                   kv_dtype=torch.int8), **bad}
    with pytest.raises(ValueError, match="no route"):
        da.route(**args)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype,want", [("bfloat16", "tc"),
                                        ("float32", "fma")])
def test_flash_route(dtype, want, hd):
    assert fa.route(getattr(torch, dtype), hd) == want


@pytest.mark.parametrize("dtype,hd", [("float16", 128), ("bfloat16", 48)])
def test_flash_route_refuses(dtype, hd):
    with pytest.raises(ValueError, match="no route"):
        fa.route(getattr(torch, dtype), hd)


@pytest.mark.parametrize("dtype,hd,want", [
    ("bfloat16", 64, "tc"), ("bfloat16", 128, "tc"),
    ("bfloat16", 256, "fma"),          # dk/dv accumulators fill a warpgroup
    ("float32", 64, "fma"), ("float32", 128, "fma"), ("float32", 256, "fma")])
def test_flash_bwd_route(dtype, hd, want):
    assert fa.route_bwd(getattr(torch, dtype), hd) == want


@pytest.mark.parametrize("dtype,hd", [("float16", 128), ("bfloat16", 48),
                                      ("float32", 96)])
def test_flash_bwd_route_refuses(dtype, hd):
    with pytest.raises(ValueError, match="no route"):
        fa.route_bwd(getattr(torch, dtype), hd)


def test_flash_bwd_route_matches_the_c_entry():
    """The C entries send bf16 at head_dim 64 and 128 to the tensor-core
    bodies (``tc::launch_*``) and the rest to the FMA body, as
    ``route_bwd`` says."""
    src = (_CSRC / "flash_bwd.cu").read_text()
    for entry in ("flash_bwd_dq", "flash_bwd_dkv"):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("#undef")]
        bf16 = body[body.index("if (dtype == 1)"):]
        fp32 = body[body.index("if (dtype == 0)"):body.index("if (dtype == 1)")]
        launch = entry.removeprefix("flash_bwd_")
        for hd in (64, 128, 256):
            got = "tc" if f"tc::launch_{launch}<{hd}>" in bf16 else "fma"
            assert got == fa.route_bwd(torch.bfloat16, hd), (entry, hd)
        assert "tc::" not in fp32


@pytest.mark.parametrize("name", ["flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv",
                                  "flash_attention_fwd"])
def test_flash_wrappers_carry_tc_launches(name):
    fn = getattr(fa, name)
    assert isinstance(fn.launches, int) and isinstance(fn.tc_launches, int)


def test_tile_sizes_match_the_cuda_body():
    """The wrapper plans with the tile sizes the C++ body uses."""
    src = (_CSRC / "attn_tc.cuh").read_text()
    const = {m[0]: int(m[1]) for m in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kBM"] == da._TC_ROWS
    assert const["kBN"] == da._BT
    assert const["kThreads"] == 128


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 16), Hkv=st.integers(1, 32),
       T=st.integers(1, 8192), R=st.integers(1, 1024))
def test_tc_split_plan(B, Hkv, T, R):
    """Splits cover the cache, a split is a multiple of the key tile, the
    walk is split only below 132 CTAs, never into splits under 512 rows,
    and not past about one CTA an SM."""
    chunk, nsplit = da.tc_split_plan(B, Hkv, T, R)
    cells = B * Hkv * -(-R // 64)
    assert chunk % 64 == 0 and chunk > 0 and nsplit >= 1
    assert chunk * nsplit >= T and chunk * (nsplit - 1) < T
    if nsplit > 1:
        assert cells < 132
        assert chunk >= 512
        assert cells * (nsplit - 1) < 132


@pytest.mark.parametrize("B,Hkv,T,R,want", [
    (1, 16, 512, 512, (512, 1)),      # the paged serve's view: no split
    (1, 16, 512, 16, (512, 1)),
    (1, 16, 2048, 512, (1024, 2)),    # 128 CTAs: two splits of 1024
    (1, 4, 4096, 100, (512, 8)),
    (8, 16, 2048, 128, (2048, 1)),    # 256 CTAs fill the card
])
def test_tc_split_plan_examples(B, Hkv, T, R, want):
    assert da.tc_split_plan(B, Hkv, T, R) == want


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 16), Hkv=st.integers(1, 32),
       T=st.integers(1, 8192), R=st.integers(1, 1024))
def test_tick_plan_covers_each_cache_row_once(B, Hkv, T, R):
    """The tick route's splits are whole 64-row tiles that cover the cache
    once, and the plan never splits past about ``_TICK_CTAS`` CTAs."""
    chunk, nsplit = da.tick_plan(B, Hkv, T, R)
    cells = B * Hkv * -(-R // da.tick_rows(R))
    assert chunk % 64 == 0 and chunk > 0 and nsplit >= 1
    assert chunk * nsplit >= T and chunk * (nsplit - 1) < T
    if nsplit > 1:
        assert cells * (nsplit - 1) < da._TICK_CTAS


def test_tick_plan_fills_the_card_at_the_tick():
    """The main path's mid-serve tick (B = 8 slots, Hkv = 16, T = 512,
    R = 1; ``tools/profile_serving.py``'s prompts plus half the new
    tokens): the splits live at those frontiers — pos is on the card, so
    the plan cannot see it — still give every one of the 132 SMs a CTA,
    and one 64-row split each costs no CTA more than the cache needs."""
    from paddle_tpu_torch.tools import profile_serving as wl
    pos = [n + wl.NEW // 2 for n in wl.LENS]
    chunk, nsplit = da.tick_plan(len(pos), 16, 512, 1)
    assert (chunk, nsplit) == (64, 8)
    live = 16 * sum(-(-(p + 1) // chunk) for p in pos)
    assert live >= 132
    assert 8 * 16 * nsplit <= da._TICK_CTAS


@pytest.mark.parametrize("B,Hkv,T,R,want", [
    (8, 16, 512, 1, (64, 8)),         # the main path's tick
    (8, 16, 2048, 1, (256, 8)),
    (8, 4, 512, 4, (64, 8)),          # G = 4 at a tick: one 4-row tile
    (1, 16, 512, 15, (64, 8)),        # four tiles of 4 rows
    (64, 32, 512, 1, (512, 1)),       # 2048 cells fill the card alone
])
def test_tick_plan_examples(B, Hkv, T, R, want):
    assert da.tick_plan(B, Hkv, T, R) == want


def test_tick_wrapper_counts_its_route():
    fn = da.decode_attention
    assert isinstance(fn.tick_launches, int) and isinstance(
        fn.tc_launches, int)


def test_paged_wrapper_counts_its_routes():
    fn = da.paged_decode_attention
    assert all(isinstance(n, int) for n in (
        fn.launches, fn.tick_launches, fn.tc_launches))


# ------------------------------------- plain twins at the routes' shapes


def _decode_inputs(B, Tq, G, Hkv, T, hd, kv, pos, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    pos = np.array(pos, np.int32)
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
@pytest.mark.parametrize("G,Tq", [(1, 128), (4, 40), (4, 64)])
def test_plain_matches_pallas_at_wide_rows(interpret, G, Tq, kv):
    """R = Tq * G = 128-256 packed rows (the tensor-core route's widths)
    with pos > 0 and a ragged cache (T = 264, not a multiple of the 64-row
    key tile), head_dim 64: the plain twin (the CPU path of
    ``decode_attention``) equals the interpret-mode Pallas kernel."""
    B, Hkv, T, hd = 2, 2, 264, 64
    jin, tin = _decode_inputs(B, Tq, G, Hkv, T, hd, kv, [37, T - Tq], seed=G)
    assert jda.supported(jin[0].shape, jin[1].shape)
    assert da.route(Tq * G, torch.bfloat16, hd,
                    torch.int8 if kv == "int8" else torch.bfloat16) == "tc"
    ref = np.asarray(jda._decode_call(*jin, None))
    out = da.decode_attention(*tin[:4], k_scale=tin[4], v_scale=tin[5])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_plain_matches_xla_oracle_at_wide_rows(kv):
    """The same widths against the JAX package's XLA oracle, at the paged
    serve's geometry (a 512-row view, a 128-row chunk past a 200-row
    prefix, G = 1) and at head_dim 64 with G = 4."""
    for B, Tq, G, Hkv, T, hd, pos in [(1, 128, 1, 2, 512, 128, [200]),
                                      (2, 64, 4, 1, 264, 64, [0, 150])]:
        jin, tin = _decode_inputs(B, Tq, G, Hkv, T, hd, kv, pos, seed=T)
        ref = np.asarray(jda._xla_decode(*jin, None))
        out = da._plain_decode(*tin, None)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_fwd_matches_pallas_over_several_blocks(interpret, D, causal):
    """The flash twin against the interpret-mode Pallas forward over 256
    rows (two 128-row blocks, so the causal frontier crosses a block)."""
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((1, 256, 2, D)).astype(np.float32)
               for _ in range(3))
    ref_out, ref_lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal, None)
    out, lse = fa.flash_attention_fwd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               atol=1e-5, rtol=0)
