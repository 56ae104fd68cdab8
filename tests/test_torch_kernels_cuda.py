"""The port's CUDA kernels against their plain PyTorch twins, on a card:
flash prefill (fp32 on the FMA body, bf16 on the tensor-core body),
decode (up to 1024 query rows per kv head: the tick body below ``R_TC``
packed rows, bit-equal on a second call; the tensor-core route from
``R_TC`` on),
block-table (paged) decode on each of its routes (live slots bit-equal
to the contiguous kernel on a gathered copy), the flash backward (dq and
dk/dv; bf16 at
head_dim 64 and 128 on the tensor-core bodies), the
fused softmax cross-entropy and the fused LayerNorm (forward and
backward; both sum in a fixed order, so a second call gives the same
bits), and the W4A16 dequant-matmul (bf16 x on the tensor-core
body, fp32 x and odd group sizes on the FMA body, each launch's body
checked through ``tc_launches``).

Every test here is marked ``cuda`` and decides in its body whether a
card is present — never at import, in ``skipif`` or in ``parametrize``,
so every pytest-xdist worker collects the same tests.  Without a card
they skip.  The file imports neither JAX nor the JAX package, so it runs
on the card machine as it stands:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: a bf16 output may sit one bf16 ulp (2^-7 relative) from the
plain twin's where fp32 summation order tips a rounding: atol = rtol =
1e-2; fp32 outputs differ only by summation order (1e-4; the backward's
dk/dv sum up to 2048 rows and a GQA group: 1e-3); lse and the CE loss are
fp32 (1e-3); CE dlogits are tiny (softmax ~ 1/V) and rounded once in both:
rtol 1e-2 with atol 1e-6.  LayerNorm's mu and rstd are fp32 (1e-5); dg
and db sum N rows in row-block order (1e-3 + 1e-4 relative).  The W4
kernel's dequantized weight equals ``woq.w``'s bit for bit.
"""
import itertools

import pytest
import torch

from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce as fc
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.ops import woq_matmul as wm
from paddle_tpu_torch.text import gpt, woq

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,H,Hkv,D,dtype,causal", [
    (64, 16, 16, 128, "bfloat16", True),
    (1000, 16, 16, 128, "bfloat16", True),
    (200, 4, 2, 64, "float32", False),
    (37, 8, 8, 64, "float32", True),
    (300, 8, 2, 256, "bfloat16", True),
    (100, 4, 4, 256, "float32", False),
])
def test_flash_fwd_matches_plain(T, H, Hkv, D, dtype, causal):
    gen = _card()
    dt = getattr(torch, dtype)
    q = torch.randn(2, T, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(2, T, Hkv, D, generator=gen, device="cuda").to(dt)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa._plain_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("Hq,Hkv,Tq,kv,qdt,hd", [
    (16, 16, 1, "bfloat16", "bfloat16", 128),
    (16, 4, 4, "int8", "bfloat16", 128),
    (8, 2, 3, "float32", "float32", 128),
    (16, 16, 1, "float32", "bfloat16", 128),
    (8, 2, 1, "bfloat16", "bfloat16", 256),
    (8, 2, 4, "int8", "bfloat16", 256),
    (4, 1, 3, "float32", "float32", 256),
])
def test_decode_matches_plain(Hq, Hkv, Tq, kv, qdt, hd):
    gen = _card()
    T = 520
    q = torch.randn(3, Tq, Hq, hd, generator=gen,
                    device="cuda").to(getattr(torch, qdt))
    k = torch.randn(3, T, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(3, T, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    pos = torch.tensor([0, 257, T - Tq], dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("Tq,G", [(1, 1), (1, 4), (3, 4), (4, 1), (15, 1)])
def test_decode_tick_body_matches_plain(Tq, G, hd, kv):
    """The tick body (R = Tq * G < R_TC) at every frontier kind — the first
    row, a tile edge, mid-cache, the last row — over a ragged 520-row
    cache; fp32 caches with fp32 q.  Its splits merge in a fixed order,
    so a second call gives the same bits."""
    gen = _card()
    B, Hkv, T = 6, 2, 520
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    q = torch.randn(B, Tq, Hkv * G, hd, generator=gen,
                    device="cuda").to(qdt)
    k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    pos = torch.tensor([0, 1, 63, 64, T // 3, T - Tq], dtype=torch.int32,
                       device="cuda")
    assert da.route(Tq * G, qdt, hd, k.dtype) == "tick"
    before = (da.decode_attention.launches, da.decode_attention.tick_launches)
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert (da.decode_attention.launches,
            da.decode_attention.tick_launches) == (before[0] + 1,
                                                   before[1] + 1)
    tol = 1e-2 if qdt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(da.decode_attention(q, k, v, pos, ks, vs), out)


def test_decode_tick_route_refuses_cuda_inputs():
    """No fallback on the tick route: what its body does not take raises
    before any launch."""
    _card()
    before = (da.decode_attention.launches, da.decode_attention.tick_launches)
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    k = torch.zeros(2, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 96"):
        da.decode_attention(k[:, :1], k, k, pos)
    k = torch.zeros(2, 64, 2, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="got torch.float16"):
        da.decode_attention(k[:, :1].half(), k, k, pos)
    with pytest.raises(ValueError, match="pos must be int32"):
        da.decode_attention(k[:, :1], k, k, pos.long())
    with pytest.raises(ValueError, match="need k_scale"):
        da.decode_attention(k[:, :1], k.to(torch.int8), k.to(torch.int8), pos)
    assert (da.decode_attention.launches,
            da.decode_attention.tick_launches) == before


@pytest.mark.parametrize("B,Tq,Hq,Hkv,pos0,kv,hd", [
    (1, 512, 16, 16, 0, "bfloat16", 128),  # R = 512, an admission chunk
    (2, 512, 16, 16, 0, "int8", 128),
    (2, 256, 16, 4, 200, "bfloat16", 128),  # R = 1024, the cap
    (1, 100, 8, 2, 37, "float32", 128),     # ragged last row tile
    (2, 256, 16, 4, 200, "bfloat16", 256),  # 32 row tiles of 32 rows
    (1, 100, 8, 2, 37, "float32", 256),
])
def test_decode_wide_query_rows_match_plain(B, Tq, Hq, Hkv, pos0, kv, hd):
    """Tq * G up to 1024 query rows per kv head (prefill chunks), cut into
    64-row tiles (32-row at hd 256) across CTAs."""
    gen = _card()
    T = 512
    q = torch.randn(B, Tq, Hq, hd, generator=gen, device="cuda")
    q = q.bfloat16() if kv != "float32" else q
    k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    pos = torch.tensor([pos0, T - Tq][:B], dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)



@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal", [
    (1, 64, 64, 16, 16, 128, True),
    (1, 64, 64, 16, 16, 128, False),
    (2, 200, 200, 16, 4, 128, True),      # ragged T, GQA (G = 4)
    (2, 200, 200, 16, 4, 128, False),
    (1, 2048, 2048, 16, 16, 128, True),   # the train path's shape
    (1, 2048, 2048, 16, 4, 128, False),
    (2, 200, 333, 8, 2, 64, False),       # S != T
    (2, 333, 200, 8, 8, 64, True),        # S < T, causal: rows past S
    (1, 300, 300, 8, 2, 256, True),
    (1, 130, 77, 4, 4, 256, False),
])
def test_flash_fwd_tensor_core_body_matches_plain(B, T, S, H, Hkv, D, causal):
    """bf16 forwards run the tensor-core body (``route`` says so and
    ``tc_launches`` counts it): out within 1e-2 * (1 + |plain|), the fp32
    lse within 1e-3."""
    gen = _card()
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").bfloat16()
    assert fa.route(q.dtype, D) == "tc"
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.tc_launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa._plain_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.tc_launches) == (before[0] + 1,
                                                   before[1] + 1)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert (lse - ref_lse).abs().max().item() < 1e-3


def test_flash_fwd_fp32_stays_on_the_fma_body():
    gen = _card()
    q, k, v = (torch.randn(1, 100, 4, 128, generator=gen, device="cuda")
               for _ in range(3))
    assert fa.route(q.dtype, 128) == "fma"
    before = fa.flash_attention_fwd.tc_launches
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    assert fa.flash_attention_fwd.tc_launches == before
    torch.testing.assert_close(out, fa._plain_fwd(q, k, v, True)[0],
                               atol=1e-4, rtol=1e-4)


def test_flash_bwd_from_the_tensor_core_forward():
    """The dq and dk/dv kernels (tensor-core bodies: ``tc_launches`` counts
    each) fed the tensor-core forward's out and lse (train shape, then GQA
    at head_dim 64): grads within the bf16 tolerance of ``_plain_bwd`` on
    the same out and lse, and of ``_plain_bwd`` on the plain forward's."""
    gen = _card()
    for B, T, H, Hkv, D in [(1, 2048, 16, 16, 128), (2, 200, 8, 2, 64)]:
        q, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, T, Hkv, D, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        before = fa.flash_attention_fwd.tc_launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        assert fa.flash_attention_fwd.tc_launches == before + 1
        assert fa.route_bwd(q.dtype, D) == "tc"
        before = (fa.flash_attention_bwd_dq.tc_launches,
                  fa.flash_attention_bwd_dkv.tc_launches)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        assert (fa.flash_attention_bwd_dq.tc_launches,
                fa.flash_attention_bwd_dkv.tc_launches) == (before[0] + 1,
                                                           before[1] + 1)
        ref = fa._plain_bwd(q, k, v, out, lse, do, True)
        p_out, p_lse = fa._plain_fwd(q, k, v, True)
        ref_plain = fa._plain_bwd(q, k, v, p_out, p_lse, do, True)
        torch.cuda.synchronize()
        for g, r, rp in zip(got, ref, ref_plain):
            torch.testing.assert_close(g.float(), r.float(), atol=1e-2,
                                       rtol=1e-2)
            torch.testing.assert_close(g.float(), rp.float(), atol=1e-2,
                                       rtol=1e-2)


@pytest.mark.parametrize("B,Tq,Hq,Hkv,T,pos0,kv,hd", [
    (1, da.R_TC - 1, 16, 16, 512, 0, "bfloat16", 128),  # last split-KV R
    (1, da.R_TC, 16, 16, 512, 0, "bfloat16", 128),      # first tc R
    (1, 512, 16, 16, 512, 0, "bfloat16", 128),          # R = 512
    (1, 512, 16, 16, 512, 0, "int8", 128),
    (2, 256, 16, 4, 520, 200, "bfloat16", 128),         # R = 1024, G = 4
    (2, 256, 16, 4, 520, 200, "int8", 128),
    (2, 96, 8, 8, 333, 37, "bfloat16", 64),             # pos > 0, ragged T
    (2, 40, 8, 2, 333, 150, "int8", 64),                # G = 4, R = 160
    (3, 128, 16, 16, 512, 100, "bfloat16", 128),        # the paged widths
    (1, 256, 16, 16, 512, 0, "bfloat16", 128),
    (2, 100, 8, 2, 520, 300, "bfloat16", 256),
    (1, 64, 4, 1, 333, 10, "int8", 256),                # G = 4, hd 256
])
def test_decode_tensor_core_route_matches_plain(B, Tq, Hq, Hkv, T, pos0, kv,
                                                hd):
    """Wide query blocks take the tensor-core route from ``R_TC`` packed
    rows on (``tc_launches`` counts exactly those), narrower ones the
    split-KV body; both within 1e-2 * (1 + |plain|), bf16 and int8."""
    gen = _card()
    q = torch.randn(B, Tq, Hq, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    pos = torch.tensor([pos0, T - Tq, T // 3][:B], dtype=torch.int32,
                       device="cuda")
    R = Tq * Hq // Hkv
    want_tc = da.route(R, q.dtype, hd, k.dtype) == "tc"
    assert want_tc == (R >= da.R_TC)
    before = (da.decode_attention.launches, da.decode_attention.tc_launches)
    out = da.decode_attention(q, k, v, pos, ks, vs)
    ref = da._plain_decode(q, k, v, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert (da.decode_attention.launches,
            da.decode_attention.tc_launches) == (before[0] + 1,
                                                before[1] + want_tc)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def _paged_inputs(gen, B, Tq, Hq, Hkv, bs, nmax, kv, qdt, pos_list, hd=128):
    """A shuffled pool: live slot b maps its blocks through its write
    frontier to random distinct physical blocks and leaves the rest -1;
    a slot whose position is None is free (table row all -1, pos 0)."""
    N = B * nmax + 3
    q = torch.randn(B, Tq, Hq, hd, generator=gen,
                    device="cuda").to(getattr(torch, qdt))
    k = torch.randn(N, bs, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(N, bs, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    tables = torch.full((B, nmax), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos_list):
        if p is None:
            continue
        used = (p + Tq - 1) // bs + 1
        tables[b, :used] = perm[b * nmax:b * nmax + used]
        pos[b] = p
    return q, k, v, ks, vs, tables, pos


@pytest.mark.parametrize("Hq,Hkv,Tq,kv,qdt,bs,hd", [
    (16, 16, 1, "bfloat16", "bfloat16", 16, 128),   # the paged path's tick
    (16, 4, 4, "int8", "bfloat16", 8, 128),
    (8, 2, 3, "float32", "float32", 24, 128),
    (16, 16, 1, "int8", "bfloat16", 16, 128),
    (8, 2, 4, "bfloat16", "bfloat16", 16, 256),
    (4, 1, 3, "float32", "float32", 8, 256),
])
def test_paged_matches_plain(Hq, Hkv, Tq, kv, qdt, bs, hd):
    """Live slots equal the gather-then-attend twin; a free slot returns
    zeros (the kernel reads no unmapped block, the twin reads block 0)."""
    gen = _card()
    nmax = 512 // bs
    T = nmax * bs
    pos_list = [0, 1, bs - 1, bs, 200, None, T - Tq, 333]
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 8, Tq, Hq, Hkv, bs, nmax, kv, qdt, pos_list, hd)
    before = da.paged_decode_attention.launches
    out = da.paged_decode_attention(q, k, v, tables, pos, ks, vs)
    ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.paged_decode_attention.launches == before + 1
    live = [b for b, p in enumerate(pos_list) if p is not None]
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=tol)
    assert not out[pos_list.index(None)].any()


def test_paged_wide_query_rows_match_plain():
    """A paged prefill-sized query block: Tq * G = 1024 rows."""
    gen = _card()
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 2, 256, 16, 4, 16, 32, "bfloat16", "bfloat16", [0, 200])
    out = da.paged_decode_attention(q, k, v, tables, pos)
    ref = da._plain_paged(q, k, v, tables, pos, None, None, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_rows_past_the_cap_launch_in_pieces(kv):
    """A 512-row admission chunk under GQA 16/4 is 2048 query rows a kv
    head, past the kernels' 1024: each decode wrapper launches it as two
    pieces of 256 rows (the second at pos + 256), which together equal
    the plain twin on the whole block."""
    gen = _card()
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 2, 512, 16, 4, 16, 64, kv, "bfloat16", [0, 300])
    before = da.paged_decode_attention.tc_launches
    out = da.paged_decode_attention(q, k, v, tables, pos, ks, vs)
    ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert da.paged_decode_attention.tc_launches == before + 2
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    # the contiguous kernel on each slot's gathered rows, alike
    kc, vc = (da.gather_paged_view(x, tables) for x in (k, v))
    ksc, vsc = ((da.gather_paged_view(x, tables) for x in (ks, vs))
                if ks is not None else (None, None))
    before = da.decode_attention.tc_launches
    cont = da.decode_attention(q, kc, vc, pos, ksc, vsc)
    torch.cuda.synchronize()
    assert da.decode_attention.tc_launches == before + 2
    torch.testing.assert_close(cont.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def _paged_route_cases():
    """(Tq, G, hd, bs, kv): every Tq of the routes' edges (1, 4, R_TC - 1,
    R_TC, 64, 256) at every pool dtype and head_dim, G and the block size
    rotated through the cases so that each pairs with every head_dim."""
    cases = []
    for i, (Tq, kv, hd) in enumerate(itertools.product(
            (1, 4, da.R_TC - 1, da.R_TC, 64, 256),
            ("bfloat16", "int8", "float32"), (64, 128, 256))):
        cases.append((Tq, (1, 4)[(i // 3 + i // 9) % 2], hd,
                      (8, 16, 64)[(i + i // 3) % 3], kv))
    return cases


@pytest.mark.parametrize("Tq,G,hd,bs,kv", _paged_route_cases())
def test_paged_routes_match_plain_and_the_contiguous_kernel(Tq, G, hd, bs,
                                                            kv):
    """Each route of the paged kernel (``paged_route``: the tick body below
    ``R_TC``; from there the tensor-core body for bf16 q over a bf16 or
    int8 pool, the split-KV body for fp32), counted on its counter: live
    slots within tolerance of the gather-then-attend twin and equal bit
    for bit to the contiguous kernel on ``gather_paged_view``'s copy (the
    same body walks the same rows in the same order under the same plan);
    a free slot exactly zero; a second call the same bits."""
    gen = _card()
    Hkv, nmax = 2, 512 // bs
    T = nmax * bs
    qdt = "float32" if kv == "float32" else "bfloat16"
    pos_list = [None if p is None else min(p, T - Tq)
                for p in (0, 1, bs - 1, bs, 200, None, T, 333)]
    q, k, v, ks, vs, tables, pos = _paged_inputs(
        gen, 8, Tq, Hkv * G, Hkv, bs, nmax, kv, qdt, pos_list, hd)
    body = da.paged_route(Tq * G, q.dtype, hd, k.dtype)
    fn = da.paged_decode_attention
    before = (fn.launches, fn.tick_launches, fn.tc_launches)
    out = fn(q, k, v, tables, pos, ks, vs)
    ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tick_launches, fn.tc_launches) == (
        before[0] + 1, before[1] + (body == "tick"),
        before[2] + (body == "tc"))
    live = [b for b, p in enumerate(pos_list) if p is not None]
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=tol, rtol=tol)
    assert not out[pos_list.index(None)].any()
    kg, vg, ksg, vsg = (None if x is None else da.gather_paged_view(x, tables)
                        for x in (k, v, ks, vs))
    assert da.route(Tq * G, q.dtype, hd, k.dtype) == body
    flat = da.decode_attention(q, kg, vg, pos, ksg, vsg)
    assert torch.equal(out[live], flat[live])
    assert torch.equal(fn(q, k, v, tables, pos, ks, vs), out)


def test_kernels_launch_on_a_second_card():
    """Tensors on cuda:1 while cuda:0 is current: both kernels launch on
    the tensors' card (the shared-memory limit is per device) and agree
    with their plain twins."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    dev = torch.device("cuda:1")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 256, 16, 128, generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), fa._plain_fwd(q, k, v, True)[0]
                               .float(), atol=1e-2, rtol=1e-2)
    q = torch.randn(2, 4, 16, 128, generator=gen, device=dev).bfloat16()
    pos = torch.tensor([3, 200], dtype=torch.int32, device=dev)
    kq, ks = da.quantize_kv(k.float().reshape(2, 128, 16, 128))
    vq, vs = da.quantize_kv(v.float().reshape(2, 128, 16, 128))
    kq, ks, vq, vs = (t.repeat(1, 2, 1, 1) if t.dim() == 4 else
                      t.repeat(1, 2, 1) for t in (kq, ks, vq, vs))
    out = da.decode_attention(q, kq, vq, pos, ks, vs)
    ref = da._plain_decode(q, kq, vq, pos, ks, vs, None)
    assert out.device == dev
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_cuda_tensors_the_kernels_cannot_take_raise():
    """No fallback: a CUDA tensor outside a kernel's contract raises."""
    _card()
    before = fa.flash_attention_fwd.launches
    z = torch.zeros(1, 8, 2, 64, device="cuda")
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention_fwd(q, q, q, causal=True)
    h = z.half()
    with pytest.raises(TypeError, match="got torch.float16/"):
        fa.flash_attention_fwd(h, h, h, causal=True)
    with pytest.raises(TypeError, match="got torch.float32/torch.bfloat16/"):
        fa.flash_attention_fwd(z, z.bfloat16(), z, causal=True)
    strided = torch.zeros(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="k must be contig"):
        fa.flash_attention_fwd(z, strided, z, causal=True)
    k3 = torch.zeros(1, 8, 3, 64, device="cuda")
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention_fwd(z, k3, k3, causal=True)
    assert fa.flash_attention_fwd.launches == before
    q = torch.zeros(1, 1, 2, 64, device="cuda", dtype=torch.float16)
    k = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.float16)
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="got torch.float16"):
        da.decode_attention(q, k, k, pos)
    before = da.paged_decode_attention.launches
    q = torch.zeros(2, 1, 4, 64, device="cuda")
    pool = torch.zeros(6, 12, 4, 64, device="cuda")       # bs 12
    tables = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block size 12"):
        da.paged_decode_attention(q, pool, pool, tables, pos)
    pool = torch.zeros(6, 16, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="tables must be int32"):
        da.paged_decode_attention(q, pool, pool, tables.long(), pos)
    with pytest.raises(ValueError, match="head_dim 96"):
        z = torch.zeros(2, 1, 4, 96, device="cuda")
        da.paged_decode_attention(z, torch.zeros(6, 16, 4, 96,
                                                 device="cuda"),
                                  torch.zeros(6, 16, 4, 96, device="cuda"),
                                  tables, pos)
    assert da.paged_decode_attention.launches == before


@pytest.mark.parametrize("B,T,S,H,Hkv,D,dtype,causal", [
    (1, 2048, 2048, 16, 16, 128, "bfloat16", True),   # the train path's shape
    (2, 200, 200, 8, 2, 64, "bfloat16", True),        # ragged T, GQA (G = 4)
    (1, 300, 300, 4, 1, 128, "float32", False),
    (1, 130, 130, 4, 4, 256, "bfloat16", True),
    (2, 77, 77, 8, 2, 256, "float32", False),
    (1, 64, 64, 2, 2, 64, "float32", True),
    (1, 77, 77, 8, 8, 128, "bfloat16", True),         # T % 64 != 0
    (2, 130, 130, 16, 4, 128, "bfloat16", True),      # ragged T, G = 4
    (2, 200, 200, 16, 4, 128, "bfloat16", False),
    (1, 200, 333, 8, 2, 128, "bfloat16", False),      # S != T
    (2, 333, 200, 8, 2, 64, "bfloat16", False),       # S < T, head_dim 64
    (2, 130, 77, 8, 2, 64, "bfloat16", True),         # causal, rows past S
    (1, 77, 130, 4, 4, 128, "bfloat16", True),        # causal, keys no row sees
    (1, 2048, 2048, 16, 4, 64, "bfloat16", True),
])
def test_flash_bwd_matches_plain(B, T, S, H, Hkv, D, dtype, causal):
    """dq, dk, dv of both backward kernels against ``_plain_bwd``, from the
    forward kernel's out and lse; each kernel launched once, on the body
    ``route_bwd`` names (``tc_launches`` counts the tensor-core one)."""
    gen = _card()
    dt = getattr(torch, dtype)
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    tc = fa.route_bwd(dt, D) == "tc"
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.tc_launches,
              fa.flash_attention_bwd_dkv.tc_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = fa._plain_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.tc_launches,
            fa.flash_attention_bwd_dkv.tc_launches) == (
                before[0] + 1, before[1] + 1, before[2] + tc, before[3] + tc)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-3
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


def test_attention_under_autograd_runs_the_backward_kernels():
    """``attention_array`` on CUDA tensors that require grad goes through
    the autograd Function: the backward launches dq and dk/dv (no plain
    path), and the grads equal autograd through the plain forward."""
    gen = _card()
    q, k, v = (torch.randn(2, 96, 4, 64, generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    from paddle_tpu_torch.ops import attention
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = attention.attention_array(q, k, v, is_causal=True)
    out.sum().backward()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                b + 1 for b in before)
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa._plain_fwd(*ref, True)[0].sum().backward()
    for g, r in zip((q.grad, k.grad, v.grad), ref):
        torch.testing.assert_close(g, r.grad, atol=1e-3, rtol=1e-3)
    with torch.no_grad():                       # serving: forward only
        attention.attention_array(q, k, v, is_causal=True)
    assert fa.flash_attention_bwd_dq.launches == before[1] + 1


@pytest.mark.parametrize("N,V,dtype", [
    (2048, 50304, "bfloat16"),     # the train path's loss head
    (37, 1000, "bfloat16"),
    (37, 999, "bfloat16"),         # rows not 16-byte aligned: scalar walk
    (37, 1000, "float32"),
    (5, 3, "float32"),
])
def test_fused_ce_matches_plain(N, V, dtype):
    gen = _card()
    x = (2 * torch.randn(N, V, generator=gen, device="cuda")).to(
        getattr(torch, dtype))
    y = torch.randint(0, V, (N,), generator=gen, device="cuda")
    y[0] = -1                                   # outside the vocab: no pick
    dl = torch.randn(N, generator=gen, device="cuda")
    before = (fc.ce_fwd.launches, fc.ce_bwd.launches)
    loss, lse = fc.ce_fwd(x, y)
    dx = fc.ce_bwd(x, y, lse, dl)
    ref_loss, ref_lse = fc._plain_ce_fwd(x, y)
    ref_dx = fc._plain_ce_bwd(x, y, ref_lse, dl)
    torch.cuda.synchronize()
    assert (fc.ce_fwd.launches, fc.ce_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    torch.testing.assert_close(loss, ref_loss, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)
    assert dx.dtype == x.dtype
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=1e-6,
                               rtol=1e-2)


def test_fused_softmax_ce_autograd_on_card():
    gen = _card()
    x = torch.randn(3, 40, 500, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    y = torch.randint(0, 500, (3, 40), generator=gen, device="cuda")
    before = (fc.ce_fwd.launches, fc.ce_bwd.launches)
    loss = fc.fused_softmax_ce(x, y)
    loss.mean().backward()
    assert (fc.ce_fwd.launches, fc.ce_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref = x.detach().float().requires_grad_()
    torch.nn.functional.cross_entropy(ref.reshape(-1, 500),
                                      y.reshape(-1)).backward()
    torch.testing.assert_close(x.grad.float(), ref.grad, atol=1e-6,
                               rtol=2e-2)


def test_new_kernel_wrappers_refuse_cuda_inputs():
    """No fallback: CUDA tensors outside the backward and CE kernels'
    contracts raise before any launch (dtype, head_dim, contiguity,
    device)."""
    _card()
    launches = lambda: (fa.flash_attention_bwd_dq.launches,  # noqa: E731
                        fa.flash_attention_bwd_dkv.launches,
                        fc.ce_fwd.launches, fc.ce_bwd.launches)
    before = launches()
    z = torch.zeros(1, 8, 2, 64, device="cuda")
    lse = torch.zeros(2, 8, device="cuda")
    h = z.half()
    with pytest.raises(TypeError, match="got torch.float16/"):
        fa.flash_attention_bwd(h, h, h, h, lse, h)
    w = torch.zeros(1, 8, 2, 96, device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.flash_attention_bwd(w, w, w, w, lse, w)
    strided = torch.zeros(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="do must be contig"):
        fa.flash_attention_bwd(z, z, z, z, lse, strided)
    with pytest.raises(ValueError, match="lse must be float32"):
        fa.flash_attention_bwd(z, z, z, z, lse[:1], z)
    with pytest.raises(ValueError, match="share one device"):
        fa.flash_attention_bwd(z, z.cpu(), z, z, lse, z)
    x = torch.zeros(4, 8, device="cuda")
    y = torch.zeros(4, dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="share one device"):
        fc.ce_fwd(x, y.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.ce_fwd(x.half(), y)
    with pytest.raises(TypeError, match="labels must be int64"):
        fc.ce_fwd(x, y.int())
    with pytest.raises(ValueError, match="must be contiguous"):
        fc.ce_fwd(torch.zeros(8, 4, device="cuda").t(), y)
    with pytest.raises(ValueError, match="dloss must be contiguous float32"):
        fc.ce_bwd(x, y, torch.zeros(4, device="cuda"),
                  torch.zeros(4, device="cuda", dtype=torch.float64))
    assert launches() == before


def test_fused_ln_flag_raises_on_the_card(monkeypatch):
    """``PADDLE_TPU_FUSED_LN=1`` on a card (it raised before kernels
    #4/#5 were ported): every LayerNorm of the forward launches the
    forward kernel, and under autograd the backward kernel, with the
    flag-off forward's logits and grads within summation-order
    tolerance (fp32 model)."""
    gen = _card()
    cfg = gpt.GPTConfig(vocab_size=64, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=16, dtype=torch.float32)
    params = gpt.init_master_params(cfg, seed=0, device="cuda")
    for t in params["blocks"].values():
        t.add_(0.01 * torch.randn(t.shape, generator=gen, device="cuda"))
    toks = torch.randint(0, 64, (2, 9), generator=gen, device="cuda")
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_FUSED_LN", flag)
        leaves = {n: t.detach().clone().requires_grad_()
                  for n, t in params["blocks"].items()}
        p = {**params, "blocks": leaves}
        before = (fn.ln_fwd.launches, fn.ln_bwd.launches)
        loss = gpt.loss_fn(p, toks, cfg)
        loss.backward()
        torch.cuda.synchronize()
        runs[flag] = (loss.item(), {n: t.grad for n, t in leaves.items()},
                      (fn.ln_fwd.launches - before[0],
                       fn.ln_bwd.launches - before[1]))
    n_norms = 2 * cfg.num_layers + 1
    assert runs["1"][2] == (n_norms, n_norms) and runs["0"][2] == (0, 0)
    assert abs(runs["1"][0] - runs["0"][0]) < 1e-5
    for n, g in runs["1"][1].items():
        torch.testing.assert_close(g, runs["0"][1][n], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("N,F,dtype,wdtype", [
    (2048, 2048, "bfloat16", "float32"),    # the train path's shape
    (8, 2048, "bfloat16", "bfloat16"),      # a decode tick's, bf16 params
    (37, 1000, "float32", "float32"),       # ragged rows and columns
    (5, 999, "bfloat16", "float32"),        # the scalar walk
    (3, 5120, "float32", "bfloat16"),       # gpt_13b's width
    (2, 8192, "float32", "float32"),        # the widest row taken
    (1, 2048, "bfloat16", "float32"),       # one row: one CTA
    (7, 2048, "bfloat16", "float32"),       # a ragged row group
    (4096, 2048, "bfloat16", "float32"),    # 32 rows a CTA
    (133, 4096, "bfloat16", "bfloat16"),    # 2-row groups, one CTA short
])
def test_fused_norm_matches_plain(N, F, dtype, wdtype):
    gen = _card()
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
    x = (2 * torch.randn(N, F, generator=gen, device="cuda") + 0.5).to(dt)
    g = (1 + 0.5 * torch.randn(F, generator=gen, device="cuda")).to(wdt)
    b = torch.randn(F, generator=gen, device="cuda").to(wdt)
    dy = torch.randn(N, F, generator=gen, device="cuda").to(dt)
    before = (fn.ln_fwd.launches, fn.ln_bwd.launches)
    y, mu, r = fn.ln_fwd(x, g, b)
    dx, dg, db = fn.ln_bwd(x, g, mu, r, dy)
    ref_y, ref_mu, ref_r = fn._plain_ln_fwd(x, g, b)
    ref_dx, ref_dg, ref_db = fn._plain_ln_bwd(x, g, mu, r, dy)
    torch.cuda.synchronize()
    assert (fn.ln_fwd.launches, fn.ln_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert y.dtype == dx.dtype == dt and dg.dtype == torch.float32
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dx.float(), ref_dx.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(mu, ref_mu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(r, ref_r, atol=1e-5, rtol=1e-5)
    # column sums over N rows, in row-block order: fp32 order only
    torch.testing.assert_close(dg, ref_dg, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, ref_db, atol=1e-3, rtol=1e-4)
    # a fixed order of sums: a second call gives the same bits
    dx2, dg2, db2 = fn.ln_bwd(x, g, mu, r, dy)
    assert torch.equal(dx2, dx) and torch.equal(dg2, dg) \
        and torch.equal(db2, db)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 999, 2048, 5120, 8192])
@pytest.mark.parametrize("N", [1, 7, 2048, 4099])
def test_ln_fwd_matches_plain(N, F, dtype, wdtype):
    """The LayerNorm forward's persistent body: one warp a row up to 1024
    bf16 / 512 fp32 columns, 2-8 warps past that, the scalar walk at
    F = 999 and F = 1, more rows than the grid at N = 4099.  y within the
    plain twin's tolerance, mu and rstd within fp32 rounding, and the same
    bits on a second call."""
    gen = _card()
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
    x = (2 * torch.randn(N, F, generator=gen, device="cuda") + 0.5).to(dt)
    g = (1 + 0.5 * torch.randn(F, generator=gen, device="cuda")).to(wdt)
    b = torch.randn(F, generator=gen, device="cuda").to(wdt)
    before = fn.ln_fwd.launches
    y, mu, r = fn.ln_fwd(x, g, b)
    ref_y, ref_mu, ref_r = fn._plain_ln_fwd(x, g, b)
    torch.cuda.synchronize()
    assert fn.ln_fwd.launches == before + 1
    assert y.dtype == dt and mu.shape == r.shape == (N, 1)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), ref_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mu, ref_mu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(r, ref_r, atol=1e-5, rtol=1e-5)
    again = fn.ln_fwd(x, g, b)
    assert all(torch.equal(a, c) for a, c in zip(again, (y, mu, r)))


@pytest.mark.parametrize("N,K,M,gs,dtype", [
    (8, 2048, 2048, 64, "bfloat16"),        # a tick's qkv / proj slice
    (8, 2048, 8192, 64, "bfloat16"),        # fc
    (8, 8192, 2048, 64, "bfloat16"),        # out
    (1, 2048, 2048, 64, "float32"),
    (256, 2048, 2048, 64, "bfloat16"),      # the cap
    (37, 192, 130, 32, "float32"),          # ragged N and M (byte loads)
    (5, 96, 64, 48, "bfloat16"),            # gs not a power of two
    (16, 2048, 2048, 64, "bfloat16"),       # the n16 product
    (64, 2048, 8192, 64, "bfloat16"),       # an admission bucket, n64
    (100, 8192, 2048, 64, "bfloat16"),      # n64 products looped, ragged
    (128, 2048, 2048, 64, "bfloat16"),
    (24, 192, 130, 32, "bfloat16"),         # ragged M on the tc route
    (3, 160, 72, 16, "bfloat16"),           # K/2 = 80: a part stage, M % 16
    (8, 160, 64, 40, "bfloat16"),           # gs 40: the fma route in bf16
])
def test_w4_matmul_matches_plain(N, K, M, gs, dtype):
    gen = _card()
    dt = getattr(torch, dtype)
    q = torch.randint(-7, 8, (K, M), generator=gen, device="cuda")
    q[:2, :2] = torch.tensor([[-7, 7], [7, -7]])
    q[K // 2:K // 2 + 2, :2] = torch.tensor([[-7, 7], [7, -7]])
    packed = woq.pack_int4_halves(q)
    scale = 0.01 + 0.09 * torch.rand(K // gs, 1, M, generator=gen,
                                     device="cuda")
    x = torch.randn(N, K, generator=gen, device="cuda").to(dt)
    body = wm.route(dt, N, K, M, gs)
    assert body == ("tc" if dt == torch.bfloat16 and gs % 16 == 0 else "fma")
    before = (wm.w4_matmul.launches, wm.w4_matmul.tc_launches)
    out = wm.w4_matmul(x, packed, scale)
    ref = wm._plain_w4(x, packed, scale)
    torch.cuda.synchronize()
    assert (wm.w4_matmul.launches, wm.w4_matmul.tc_launches) == \
        (before[0] + 1, before[1] + (body == "tc"))
    assert out.dtype == dt and out.shape == (N, M)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    # the kernel's weight is woq.w's, bit for bit: a one-hot x reads a row
    for row in (0, K // 2, K - 1):
        e = torch.zeros(1, K, device="cuda", dtype=dt)
        e[0, row] = 1
        w_row = woq.w({"w": packed, "w_s": scale}, "w", dt)[row]
        assert torch.equal(wm.w4_matmul(e, packed, scale)[0], w_row)


def test_norm_and_w4_wrappers_refuse_cuda_inputs():
    """No fallback: CUDA tensors outside the LayerNorm and W4 kernels'
    contracts raise before any launch."""
    _card()
    launches = lambda: (fn.ln_fwd.launches, fn.ln_bwd.launches,  # noqa: E731
                        wm.w4_matmul.launches)
    before = launches()
    x = torch.zeros(4, 64, device="cuda")
    g = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="1 to 8192"):
        fn.ln_fwd(torch.zeros(2, 8200, device="cuda"),
                  torch.ones(8200, device="cuda"),
                  torch.zeros(8200, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn.ln_fwd(x.half(), g, g)
    with pytest.raises(TypeError, match="share one dtype"):
        fn.ln_fwd(x, g, g.bfloat16())
    with pytest.raises(ValueError, match="must be contiguous"):
        fn.ln_fwd(torch.zeros(64, 4, device="cuda").t(), g, g)
    with pytest.raises(ValueError, match="share one device"):
        fn.ln_fwd(x, g.cpu(), g)
    mu = torch.zeros(4, 1, device="cuda")
    with pytest.raises(ValueError, match="dy must be contiguous"):
        fn.ln_bwd(x, g, mu, mu, x.bfloat16())
    with pytest.raises(ValueError, match="rstd must be contiguous"):
        fn.ln_bwd(x, g, mu, mu[:2], x)
    packed = torch.zeros(32, 16, dtype=torch.int8, device="cuda")
    scale = torch.ones(2, 1, 16, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wm.w4_matmul(x.half(), packed, scale)
    with pytest.raises(TypeError, match="scale float32"):
        wm.w4_matmul(x, packed, scale.bfloat16())
    with pytest.raises(ValueError, match="share one device"):
        wm.w4_matmul(x, packed.cpu(), scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        wm.w4_matmul(x[:, :62], packed, scale)
    assert launches() == before


# ---------------------------------------------------------------------------
# the step Engine on the card: captured graphs against the eager steps
# ---------------------------------------------------------------------------

_GRAPH_CASES = ("contiguous", "paged", "int8_kv", "w4")
_GRAPH_LENS = (5, 40, 100, 17, 60, 33)


def _graph_case(case, monkeypatch):
    """A small fp32 model (head_dim 64) on the card for one case: float
    weights, or int4 ones (group 32) with the W4 kernel on; int8 KV for
    ``int8_kv``."""
    gen = _card()
    monkeypatch.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_W4_KERNEL", raising=False)
    if case == "int8_kv":
        monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=3, device="cuda")
    if case == "w4":
        monkeypatch.setenv("PADDLE_TPU_W4_KERNEL", "1")
        params = woq.quantize_gpt_int4(params, group_size=32)
    prompts = [torch.randint(0, 512, (n,), generator=gen,
                             device="cuda").tolist() for n in _GRAPH_LENS]
    return cfg, params, prompts


def _graph_server(cfg, params, case, graphs, **kw):
    """max_batch 4 (six requests queue); the paged case hands out its
    blocks in a shuffled order, so the tables the steps read are not the
    identity."""
    from paddle_tpu_torch.text import serving

    lay = (dict(layout="paged", block_size=16, num_blocks=48)
           if case == "paged" else {})
    srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                               device="cuda", _graphs=graphs, **lay, **kw)
    if case == "paged":
        srv._pool._free = torch.randperm(
            srv._pool.N, generator=torch.Generator().manual_seed(0)).tolist()
    return srv


def _serve_all(srv, prompts, block=None, **kw):
    rids = [srv.submit(p, max_new_tokens=12, **kw) for p in prompts]
    for _ in range(400):
        if not srv.pending():
            break
        srv.tick_block(block) if block else srv.tick()
    assert not srv.pending()
    return [srv.result(r) for r in rids]


@pytest.mark.parametrize("case", _GRAPH_CASES)
def test_graphed_serving_equals_eager(case, monkeypatch):
    """Greedy streams of graphed tick, tick_block(4) and async dispatch
    (tick and block) equal the eager tick's exactly; each server served
    through its own graphs.  Sampled streams: the graphs draw what the
    eager steps draw, mode for mode."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    ref = _serve_all(_graph_server(cfg, params, case, False), prompts)
    for block, async_ in ((None, False), (4, False), (None, True),
                          (4, True)):
        srv = _graph_server(cfg, params, case, True, async_dispatch=async_)
        assert _serve_all(srv, prompts, block) == ref, (block, async_)
        graphs = engine.ENGINE.graphs(srv._bind)
        assert graphs and all(g.replays > 0 for g in graphs), graphs
        srv.close()
    samp = dict(temperature=0.9, top_k=20)
    for block, async_ in ((None, False), (4, False), (4, True)):
        want = _serve_all(_graph_server(cfg, params, case, False,
                                        async_dispatch=async_, seed=4),
                          prompts, block, **samp)
        srv = _graph_server(cfg, params, case, True, async_dispatch=async_,
                            seed=4)
        assert _serve_all(srv, prompts, block, **samp) == want
        srv.close()


@pytest.mark.parametrize("case", _GRAPH_CASES)
def test_graphed_step_logits_match_the_eager_step(case, monkeypatch):
    """From one cache state (each server admitted the same prompts, the
    eager one eagerly), the captured step's logits sit within 1e-3 of the
    eager step's (the smoke's PATH_TOL; cuBLAS may choose another
    algorithm on the capture stream) and its block's tokens equal the
    eager block's."""
    cfg, params, prompts = _graph_case(case, monkeypatch)
    from paddle_tpu_torch.text import engine

    out = {}
    for graphs in (False, True):
        srv = _graph_server(cfg, params, case, graphs)
        for p in prompts[:4]:
            srv.submit(p, max_new_tokens=12)
        srv._ensure_decode_blocks(4)
        tok, pos = srv._feed_arrays()
        tok, pos = srv._host(tok), srv._host(pos)
        (logits,) = engine.ENGINE.get("step", srv._spec())(tok, pos)
        logits = logits.clone()
        (toks,) = engine.ENGINE.get("block", srv._spec(k=4))(tok, pos)
        out[graphs] = (logits, toks.clone())
        srv.close()
    gap = (out[True][0] - out[False][0]).abs().max().item()
    assert gap <= 1e-3, gap
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.parametrize("case", _GRAPH_CASES)
def test_graphed_step_counts_the_eager_step(case, monkeypatch):
    """The device feed's cost record of every step a serve builds is the
    same whether the step was captured (counted in its eager warm run) or
    run eagerly — FLOPs, bytes, argument and output sizes — and a capture
    adds its private pool's growth as ``temp_bytes`` (> 0), which an
    eager step has none of; the feed names the card."""
    import time

    from paddle_tpu_torch import telemetry as tl

    cfg, params, prompts = _graph_case(case, monkeypatch)
    recs = {}
    for graphs in (False, True):
        t0 = time.time()
        srv = _graph_server(cfg, params, case, graphs)
        _serve_all(srv, prompts)
        srv.close()
        recs[graphs] = {n: st for n, st in tl._step_analysis.items()
                        if st["captured_at"] >= t0}
    assert recs[False] and set(recs[False]) == set(recs[True]), recs
    keys = ("flops", "bytes_accessed", "argument_bytes", "output_bytes")
    for name, eager in recs[False].items():
        graph = recs[True][name]
        assert "count_failed" not in eager and "count_failed" not in graph
        # every step counts FLOPs but the paged layout's copy-on-write
        # step (``kv_copy``), which only moves bytes and so has no
        # ``flops`` entry; every step counts its bytes
        if name.startswith("serving.kv_copy@"):
            assert "flops" not in eager and "flops" not in graph, name
            keys_of = keys[1:]
        else:
            keys_of = keys
        assert {k: graph[k] for k in keys_of} == \
            {k: eager[k] for k in keys_of}, name
        assert graph["temp_bytes"] > 0 and "temp_bytes" not in eager, name
    feed = tl.device_feed()
    assert feed["platform"] == "gpu"
    assert feed["device_kind"] == torch.cuda.get_device_name(0)


def test_graph_replays_count_the_eager_step_launches(monkeypatch):
    """A replay runs no Python wrapper, yet the counters read as if it
    had: the capturing tick adds one eager step's launches (its eager
    warm run and capture are put back), N replays N steps', a block of
    3 three steps'."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("w4", monkeypatch)

    def counts():
        return {(w.__name__, a): getattr(w, a)
                for w, a in engine._counter_fields()}

    def delta(fn):
        before = counts()
        fn()
        torch.cuda.synchronize()
        after = counts()
        return {k: after[k] - before[k] for k in after}

    eager = _graph_server(cfg, params, "w4", False)
    for p in prompts[:4]:
        eager.submit(p, max_new_tokens=40)
    one = delta(eager.tick)
    assert one[("decode_attention", "launches")] == cfg.num_layers
    assert one[("decode_attention", "tick_launches")] == cfg.num_layers
    assert one[("w4_matmul", "launches")] == 6 * cfg.num_layers
    srv = _graph_server(cfg, params, "w4", True)
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=40)
    assert delta(srv.tick) == one                 # the capturing tick
    assert delta(lambda: [srv.tick() for _ in range(5)]) == {
        k: 5 * v for k, v in one.items()}
    assert delta(lambda: srv.tick_block(3)) == {k: 3 * v
                                                for k, v in one.items()}
    (g,) = [g for g in engine.ENGINE.graphs(srv._bind) if g.name ==
            "serving.step"]
    assert g.replays == 6
    with pytest.raises(ValueError, match="does not fit"):
        g(torch.zeros(3, dtype=torch.int64), torch.zeros(3,
                                                         dtype=torch.int32))
    srv.close()


def test_two_servers_of_one_config_keep_separate_graphs(monkeypatch):
    """Two graphed servers of one config, ticked in turn: each replays
    its own graphs (bound to its own cache) and serves its eager
    reference's streams."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    halves = (prompts[:3], prompts[3:])
    refs = [_serve_all(_graph_server(cfg, params, "contiguous", False), h)
            for h in halves]
    a, b = (_graph_server(cfg, params, "contiguous", True) for _ in "ab")
    rids = [[s.submit(p, max_new_tokens=12) for p in h]
            for s, h in zip((a, b), halves)]
    while a.pending() or b.pending():
        for s in (a, b):
            if s.pending():
                s.tick()
    assert [[s.result(r) for r in rs] for s, rs in zip((a, b), rids)] \
        == refs
    ga, gb = engine.ENGINE.graphs(a._bind), engine.ENGINE.graphs(b._bind)
    assert ga and gb and not {id(g) for g in ga} & {id(g) for g in gb}
    assert a._bind.key != b._bind.key
    a.close()
    b.close()


def test_close_releases_the_servers_graphs(monkeypatch):
    """close() purges the server's graphs: none is left in the Engine, and
    the card's allocated memory falls by at least the server's cache to
    no more than it was before the server (every graph pool freed too).
    A capture frees cuBLAS's workspaces, so the memory before the server
    is an upper bound, not an equality."""
    import gc

    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    first = _graph_server(cfg, params, "contiguous", True)   # per-process
    _serve_all(first, prompts[:2])                           # state made
    first.close()
    del first
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    srv = _graph_server(cfg, params, "contiguous", True)
    srv.warmup(blocks=(4,), sample=True)
    _serve_all(srv, prompts, 4)
    bind = srv._bind
    # step, sample, block4, sample_block4 and every prefill bucket
    assert len(engine.ENGINE.graphs(bind)) == 4 + len(
        srv._admission_widths())
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in srv.cache.values())
    torch.cuda.synchronize()
    during = torch.cuda.memory_allocated()
    srv.close()
    assert engine.ENGINE.graphs(bind) == []
    del srv, bind
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert during - after >= cache_bytes, (during, after, cache_bytes)
    assert after <= base + (64 << 10), (base, after)


# ---------------------------------------------------------------------------
# admission and generate through the Engine on the card
# ---------------------------------------------------------------------------


def _admission_cases(srv):
    """(kind, spec fields, [(pos0, length, slot), ...]) of each admission
    kind ``srv`` runs, at two feeds — the second another slot, offset and
    length — on slots whose rows (paged: whose mapped blocks) the feeds
    write."""
    slot_of = {len(st["prompt"]): s for s, st in srv._slots.items()}
    if srv._paged:      # mapped rows: [0, 112) and [0, 48)
        return [("paged_prefill", dict(bucket=32),
                 [(64, 30, slot_of[100]), (16, 20, slot_of[40])])]
    return [("prefill", dict(bucket=64),
             [(0, 40, slot_of[40]), (0, 17, slot_of[17])]),
            ("prefill_chunk", dict(width=32),
             [(32, 32, slot_of[100]), (64, 20, slot_of[40])])]


@pytest.mark.parametrize("case", _GRAPH_CASES)
def test_graphed_admission_equals_eager(case, monkeypatch):
    """From one cache state, each admission kind's graph gives its eager
    body's logits and cache bit for bit; so does a replay after the feeds
    changed (another slot, offset and length)."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    srv = _graph_server(cfg, params, case, True)
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=12)
    gen = torch.Generator().manual_seed(5)
    for kind, kw, feeds in _admission_cases(srv):
        spec = srv._spec(**kw)
        width = kw.get("bucket") or kw.get("width")
        eager = engine._Eager(engine._REGISTRY[kind].build(spec), srv._bind,
                              kind)
        graph = engine.ENGINE.get(kind, spec)
        for pos0, length, slot in feeds:
            toks = torch.randint(0, cfg.vocab_size, (length,),
                                 generator=gen).tolist()
            f = (srv._feeds(toks, width, length, slot) if kind == "prefill"
                 else srv._feeds(toks, width, pos0, length, slot))
            snap = {n: t.clone() for n, t in srv.cache.items()}
            want = eager(*f)[0].clone()
            want_cache = {n: t.clone() for n, t in srv.cache.items()}
            for n, t in srv.cache.items():
                t.copy_(snap[n])
            r0 = graph.replays
            got = graph(*f)[0]
            assert graph.replays == r0 + 1
            assert torch.equal(got, want), (kind, pos0, length, slot)
            for n in snap:
                assert torch.equal(_live(srv, n),
                                   _live(srv, n, want_cache)), (kind, n)
    srv.close()


def _live(srv, name, cache=None):
    """A cache leaf as far as it is defined: a paged pool without its
    sink block, whose row several pad rows write in no fixed order."""
    t = (srv.cache if cache is None else cache)[name]
    return t[:, :-1] if srv._paged and name != "tables" else t


@pytest.mark.parametrize("async_", [False, True])
def test_graphed_warmup_after_a_drain_keeps_the_prefix_rows(async_,
                                                            monkeypatch):
    """A paged graphed server: serve a prompt to the end, warm up, admit it
    again — the admission logits of the same walk without the warmup, bit
    for bit."""
    cfg, params, prompts = _graph_case("paged", monkeypatch)

    def readmit(warm):
        srv = _graph_server(cfg, params, "paged", True,
                            async_dispatch=async_)
        _serve_all(srv, prompts[1:2])
        if warm:
            srv.warmup()
        seen = []
        prefill = srv._prefill_slot
        srv._prefill_slot = lambda p, s, *a: seen.append(
            prefill(p, s, *a).clone()) or seen[-1]
        _serve_all(srv, prompts[1:2])
        assert srv.load_stats()["kv_pool"]["prefix_hits"] >= 32
        srv.close()
        return seen[0]

    assert torch.equal(readmit(True), readmit(False))


def test_generate_replays_its_step(monkeypatch):
    """generate on the card: one replay of the captured step a position,
    the tokens of the graphs-off server's streams; a second call of the
    shape replays the same graph."""
    from paddle_tpu_torch.text import engine
    from paddle_tpu_torch.text import generate as G

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    batch = torch.tensor([p[:17] for p in prompts[1:3]])
    ref = _serve_all(_graph_server(cfg, params, "contiguous", False),
                     batch.tolist())
    for _ in range(2):
        before = {id(g): g.replays for g in engine.ENGINE.graphs()}
        out = G.generate(params, cfg, batch, 12, device="cuda")
        (g,) = [g for g in engine.ENGINE.graphs()
                if g.name == "generate.generate"]
        assert g.replays - before.get(id(g), 0) == 17 + 12 - 1
        assert out[:, 17:].tolist() == ref
    engine.ENGINE.purge(cfg)
    assert not [g for g in engine.ENGINE.graphs()
                if g.name == "generate.generate"]


# ---------------------------------------------------------------------------
# the spill tier's restore step and a capture that fails
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["paged", "int8_kv"])
def test_graphed_inject_equals_eager(case, monkeypatch):
    """From one pool state, the ``inject`` graph writes the rows its eager
    body writes, bit for bit (int8 scale planes too), and again after its
    feeds changed (another slot, start and length)."""
    from paddle_tpu_torch.text import engine, kv_pool

    cfg, params, prompts = _graph_case(case, monkeypatch)
    srv = _graph_server(cfg, params, "paged", True)
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=12)
    srv._apply_pool_ops()
    gen = torch.Generator(device="cuda").manual_seed(7)
    names = [n for n in kv_pool.POOL_LEAVES if n in srv.cache]
    bucket = 64
    spec = srv._spec(bucket=bucket)
    eager = engine._Eager(engine._REGISTRY["inject"].build(spec), srv._bind,
                          "inject")
    graph = engine.ENGINE.get("inject", spec)
    slots = sorted(srv._slots)
    for start, length, slot in ((0, 48, slots[0]), (16, 40, slots[1])):
        rows = []
        for n in names:
            t = srv.cache[n]
            shape = (t.shape[0], 1, bucket) + tuple(t.shape[3:])
            r = torch.randn(shape, generator=gen, device="cuda") * 20
            rows.append(r.to(t.dtype))
        feeds = (*rows, *srv._scalars(start, length, slot))
        snap = {n: t.clone() for n, t in srv.cache.items()}
        eager(*feeds)
        want = {n: t.clone() for n, t in srv.cache.items()}
        for n, t in srv.cache.items():
            t.copy_(snap[n])
        r0 = graph.replays
        assert graph(*feeds) == ()
        assert graph.replays == r0 + 1
        for n in names:
            assert torch.equal(_live(srv, n), _live(srv, n, want)), n
            assert not torch.equal(_live(srv, n), _live(srv, n, snap)), n
    srv.close()


def test_spill_restore_keeps_pool_addresses(monkeypatch):
    """A graphed paged server with the spill tier: serve a prompt, spill
    its chain to pinned host memory, serve it again — its chain restored
    through the inject graph (one replay a restored run) into the pool at
    the addresses the graphs read, every restored row the row spilled,
    the tokens of the cold pass."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("paged", monkeypatch)
    monkeypatch.setenv("PADDLE_TPU_KV_SPILL_MB", "64")
    srv = _graph_server(cfg, params, "paged", True)
    ptrs = {n: t.data_ptr() for n, t in srv.cache.items()}
    prompt = prompts[2]                           # 100 tokens: 6 blocks
    cold = _serve_all(srv, [prompt])
    kept = {}
    fetch = srv._spill_fetch

    def spill_fetch(blocks):
        recs = fetch(blocks)
        assert all(v.is_pinned() for rec in recs for v in rec.values())
        kept.update({(b, n): v.clone() for b, rec in zip(blocks, recs)
                     for n, v in rec.items()})
        return recs

    srv._spill_fetch = spill_fetch
    while srv._pool.prefix_entries:
        srv._evict_or_spill(8)
    assert srv._pool.spilled_blocks == 6
    restored = []
    take = srv._pool.take_restores

    def take_restores():
        recs = take()
        restored.extend(recs)
        return recs

    srv._pool.take_restores = take_restores
    assert _serve_all(srv, [prompt]) == cold
    assert {n: t.data_ptr() for n, t in srv.cache.items()} == ptrs
    assert len(restored) == 6
    for _slot, _start, rows, blk in restored:
        for n, v in rows.items():
            assert torch.equal(srv.cache[n][:, blk], v.to("cuda"))
    (g,) = [g for g in engine.ENGINE.graphs(srv._bind)
            if g.name.startswith("serving.inject@")]
    assert g.replays == 1                         # one contiguous run
    srv.close()


def test_a_failed_capture_leaves_no_graph(monkeypatch):
    """A real allocator OOM inside the first admission's capture (the
    body raises ``torch.cuda.OutOfMemoryError`` under capture, after its
    kernels were recorded): the error reaches the caller classified as an
    OOM, the request is back at the queue front with its slot free, no
    stream is left capturing, no half-captured graph stays in the Engine
    and the launch counters are as they were; the next tick captures
    afresh and serves the eager server's tokens."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    want = _serve_all(_graph_server(cfg, params, "contiguous", False),
                      prompts[:1])
    real = engine._REGISTRY["prefill"].build
    failed = []

    def build(spec):
        body = real(spec)

        def flaky(*a):
            out = body(*a)
            if torch.cuda.is_current_stream_capturing() and not failed:
                failed.append(1)
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 1.00 GiB")
            return out
        return flaky

    monkeypatch.setattr(engine._REGISTRY["prefill"], "build", build)
    srv = _graph_server(cfg, params, "contiguous", True)
    counts = engine._counts()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        srv.submit(prompts[0], max_new_tokens=12)
    assert resilience.is_oom(ei.value) and failed
    assert not torch.cuda.is_current_stream_capturing()
    assert engine._counts() == counts
    assert len(srv._free) == 4 and len(srv._queue) == 1
    assert not [g for g in engine.ENGINE.graphs(srv._bind)
                if g.name.startswith("serving.prefill@")]
    while srv.pending():
        srv.tick()
    assert [srv.result(0)] == want
    assert [g for g in engine.ENGINE.graphs(srv._bind)
            if g.name.startswith("serving.prefill@")]
    srv.close()


def test_capture_survives_an_event_wait_on_another_thread(monkeypatch):
    """While ``warmup`` captures a graphed server's steps, another thread
    waits on a finished event over and over, as a fetch the wedge
    watchdog abandoned does when it wakes.  Every capture completes, the
    waits raise nothing, and the warmed server serves the eager
    server's tokens."""
    import threading

    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    want = _serve_all(_graph_server(cfg, params, "contiguous", False),
                      prompts)
    ev = torch.cuda.Event()
    ev.record()
    stop, errors, waits = threading.Event(), [], [0]

    def wait_loop():
        try:
            while not stop.is_set():
                ev.synchronize()
                waits[0] += 1
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    srv = _graph_server(cfg, params, "contiguous", True)
    t = threading.Thread(target=wait_loop, daemon=True)
    t.start()
    try:
        srv.warmup(prompt_lens=_GRAPH_LENS)
    finally:
        stop.set()
        t.join()
    assert not errors and waits[0] > 0, (errors, waits)
    assert engine.ENGINE.graphs(srv._bind)
    assert _serve_all(srv, prompts) == want
    srv.close()


def test_a_real_oom_is_classified_and_survived():
    """Allocating more than the card has free raises
    ``torch.cuda.OutOfMemoryError``, which ``resilience.is_oom`` classifies;
    the CUDA context survives it (a later allocation and kernel work)."""
    from paddle_tpu_torch import resilience

    _card()
    free, _ = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(free + (1 << 30), dtype=torch.uint8, device="cuda")
    assert resilience.is_oom(ei.value)
    torch.cuda.empty_cache()
    x = torch.ones(1024, device="cuda")
    assert float((x * 2).sum()) == 2048.0


def test_ladder_moves_capture_nothing_after_warmup(monkeypatch):
    """Admission control's ladder on the card: ``warmup`` on a small bf16
    model with ``prefill_budget=16`` captures every ladder width
    (``admission.ladder_widths(16)`` = 16, 8); forcing rungs 0-3 while a
    long prompt is served adds no graph to the Engine and no record to
    the recompile watch, and each claim's chunks replay its rung's
    width's graph."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.text import admission, engine, serving

    gen = _card()
    monkeypatch.setenv("PADDLE_TPU_ADMISSION_QUEUE_CAP", "8")
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=256)
    params = gpt.init_params(cfg, seed=3, device="cuda")
    srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                               device="cuda", prefill_budget=16)
    assert srv._adm.budget_rungs == admission.ladder_widths(16) == (16, 8)
    srv.warmup()
    graphs0 = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    assert {"serving.prefill_chunk@16", "serving.prefill_chunk@8"} <= graphs0
    logs0 = len(telemetry.compile_log())

    def replays():
        return {g.name: g.replays for g in engine.ENGINE.graphs(srv._bind)}

    prompt = torch.randint(0, 512, (40,), generator=gen,
                           device="cuda").tolist()
    for rung, width in ((0, 16), (1, 16), (2, 8), (3, 8)):
        srv._adm.rung = rung
        r0 = replays()
        rid = srv.submit(prompt, max_new_tokens=4)
        while srv.pending():
            srv.tick()
        assert srv.status(rid) == "ok"
        r1 = replays()
        moved = {n for n in r1 if n.startswith("serving.prefill_chunk")
                 and r1[n] != r0[n]}
        assert moved == {f"serving.prefill_chunk@{width}"}
        assert r1[moved.pop()] - r0[f"serving.prefill_chunk@{width}"] == \
            -(-40 // width)
    assert {g.name for g in engine.ENGINE.graphs(srv._bind)} == graphs0
    assert len(telemetry.compile_log()) == logs0
    srv.close()


# ---------------------------------------------------------------------------
# speculation and beam search through the Engine on the card
# ---------------------------------------------------------------------------


def _spec_server(cfg, params, case, graphs, **kw):
    """A speculating server (draft == target, K = 4) of ``case``."""
    return _graph_server(cfg, params, case, graphs, spec_k=4, draft_cfg=cfg,
                         draft_params=params, **kw)


@pytest.mark.parametrize("case", ["contiguous", "paged", "int8_kv"])
def test_graphed_spec_verify_equals_eager(case, monkeypatch):
    """From one cache state, ``spec_verify@4``'s graph gives its eager
    body's logits and cache bit for bit, also after its feeds change (the
    next round's positions); every verify launch is on the tick body, one
    a layer.  Served: the graphed tick, tick_block(4) and async streams
    equal the graphs-off speculating server's and the plain server's,
    every round one replay of the verify graph."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    srv = _spec_server(cfg, params, case, True)
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=12)
    srv._ensure_decode_blocks(8)
    spec = srv._spec(k=4)
    eager = engine._Eager(engine._REGISTRY["spec_verify"].build(spec),
                          srv._bind, "spec_verify")
    graph = engine.ENGINE.get("spec_verify", spec)
    wrap = (da.paged_decode_attention if case == "paged"
            else da.decode_attention)
    gen = torch.Generator().manual_seed(5)
    _, pos = srv._feed_arrays()
    for shift in (0, 4):
        toks = torch.randint(0, cfg.vocab_size, (4, 4), generator=gen)
        at = torch.from_numpy(pos + shift)
        snap = {n: t.clone() for n, t in srv.cache.items()}
        want = eager(toks, at)[0].clone()
        want_cache = {n: t.clone() for n, t in srv.cache.items()}
        for n, t in srv.cache.items():
            t.copy_(snap[n])
        n0, t0 = wrap.launches, wrap.tick_launches
        got = graph(toks, at)[0]
        assert torch.equal(got, want), shift
        assert wrap.launches - n0 == wrap.tick_launches - t0 == \
            cfg.num_layers
        for n in snap:
            assert torch.equal(_live(srv, n), _live(srv, n, want_cache)), n
    srv.close()
    ref = _serve_all(_graph_server(cfg, params, case, False), prompts)
    assert _serve_all(_spec_server(cfg, params, case, False), prompts) == ref
    for block, async_ in ((None, False), (4, False), (None, True)):
        srv = _spec_server(cfg, params, case, True, async_dispatch=async_)
        assert _serve_all(srv, prompts, block) == ref, (block, async_)
        (g,) = [g for g in engine.ENGINE.graphs(srv._bind)
                if g.name == "serving.spec_verify@4"]
        assert g.replays == srv._spec_rounds > 0
        srv.close()


def test_two_speculating_servers_keep_separate_graphs(monkeypatch):
    """Two speculating servers whose draft is their target (one parameter
    tree, four caches): four bindings, no graph shared, each server's
    eager streams; close() frees the draft's graphs with the target's."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    halves = (prompts[:3], prompts[3:])
    refs = [_serve_all(_graph_server(cfg, params, "contiguous", False), h)
            for h in halves]
    a, b = (_spec_server(cfg, params, "contiguous", True) for _ in "ab")
    rids = [[s.submit(p, max_new_tokens=12) for p in h]
            for s, h in zip((a, b), halves)]
    while a.pending() or b.pending():
        for s in (a, b):
            if s.pending():
                s.tick()
    assert [[s.result(r) for r in rs] for s, rs in zip((a, b), rids)] \
        == refs
    binds = [a._bind, a._draft_bind, b._bind, b._draft_bind]
    assert len({bd.key for bd in binds}) == 4
    sets = [{id(g) for g in engine.ENGINE.graphs(bd)} for bd in binds]
    assert all(sets) and sum(map(len, sets)) == len(set().union(*sets))
    for s in (a, b):
        s.close()
    assert not any(engine.ENGINE.graphs(bd) for bd in binds)


def test_graphed_beam_equals_eager_and_the_cpu(monkeypatch):
    """beam_search on the card: one replay of the ``beam`` graph a
    position, the CPU's tokens and its scores within 1e-4; from one cache
    state the beam graph's outputs and its reordered cache equal its eager
    body's bit for bit."""
    from paddle_tpu_torch.text import engine
    from paddle_tpu_torch.text import generate as G

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    batch = [p[:5] for p in prompts[:2]]
    W, new = 4, 12
    cpu = {n: (t.cpu() if n != "blocks" else {k: v.cpu()
                                               for k, v in t.items()})
           for n, t in params.items()}
    want_t, want_s = G.beam_search(cpu, cfg, batch, new, num_beams=W,
                                   device="cpu")
    got_t, got_s = G.beam_search(params, cfg, batch, new, num_beams=W,
                                 device="cuda")
    assert got_t.cpu().tolist() == want_t.tolist()
    assert (got_s.cpu() - want_s).abs().max() <= 1e-4
    (g,) = [g for g in engine.ENGINE.graphs()
            if g.name == "generate.beam_search"]
    assert g.replays == new
    bind, spec = g.binding, engine.StepSpec(
        cfg=cfg, extra=(new, W, 0.0, None), shape=(2, 5),
        payload=g.binding)
    assert engine.ENGINE.get("beam", spec) is g
    eager = engine._Eager(engine._REGISTRY["beam"].build(spec), bind, "beam")
    gen = torch.Generator().manual_seed(7)
    feeds = (torch.randint(0, cfg.vocab_size, (2 * W,), generator=gen),
             torch.tensor(9, dtype=torch.int32),
             torch.randn((2, W), generator=gen),
             torch.rand((2, W), generator=gen) > 0.2,
             torch.randint(0, 5, (2, W), generator=gen))
    snap = {n: t.clone() for n, t in bind.cache.items()}
    want = [t.clone() for t in eager(*feeds)]
    want_cache = {n: t.clone() for n, t in bind.cache.items()}
    for n, t in bind.cache.items():
        t.copy_(snap[n])
    got = g(*feeds)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(bind.cache[n], want_cache[n]) for n in snap)
    engine.ENGINE.purge(cfg)


# ---------------------------------------------------------------------------
# tree speculation through the Engine on the card
# ---------------------------------------------------------------------------


def _tree_server(cfg, params, case, graphs, draft=None, **kw):
    """A tree-speculating server (N = 4, branch 2) of ``case``; ``draft``
    defaults to the target itself."""
    return _graph_server(cfg, params, case, graphs, spec_tree=4,
                         draft_cfg=cfg,
                         draft_params=params if draft is None else draft,
                         **kw)


def _biased_draft(params, row=7):
    """A draft whose argmax is one constant token, so acceptance leaves the
    trunk and the rows move."""
    bad = dict(params)
    bad["ln_f_b"] = params["ln_f_b"] + 50.0 * params["wte"][row]
    return bad


def _tree_feeds(gen, B, N, vocab):
    """Tokens, ancestor mask and depths of a random tree a slot."""
    from paddle_tpu_torch.text import generate as G

    tokens = torch.randint(0, vocab, (B, N), generator=gen)
    amask = torch.eye(N, dtype=torch.bool).expand(B, N, N).clone()
    depth = torch.zeros((B, N), dtype=torch.int64)
    for b in range(B):
        parent = [-1] + [int(torch.randint(0, j, (1,), generator=gen))
                         for j in range(1, N)]
        amask[b] = torch.from_numpy(G.tree_ancestor_mask(parent))
        depth[b] = torch.from_numpy(G.tree_depths(parent))
    return tokens, amask, depth


@pytest.mark.parametrize("case", ["contiguous", "paged", "int8_kv"])
def test_graphed_spec_tree_equals_eager(case, monkeypatch):
    """From one cache state, the ``spec_tree_verify@4`` graph gives its
    eager body's logits and cache bit for bit for two different trees at
    two positions (the topology is a feed), launching no decode kernel;
    the ``spec_tree_commit@4`` graph permutes the cache as its eager body
    does, at its first call (the capture undoes its eager run) and after.
    Served with a biased draft (the rows move): the graphed tick,
    tick_block(4) and async streams equal the graphs-off tree server's and
    the plain server's, every round one replay of the tree verify."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    srv = _tree_server(cfg, params, case, True)
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=12)
    srv._ensure_decode_blocks(8)
    spec = srv._spec(k=4)
    gen = torch.Generator().manual_seed(5)
    _, pos = srv._feed_arrays()
    counted = (da.decode_attention, da.paged_decode_attention)
    for kind in ("spec_tree_verify", "spec_tree_commit"):
        eager = engine._Eager(engine._REGISTRY[kind].build(spec), srv._bind,
                              kind)
        graph = engine.ENGINE.get(kind, spec)
        for shift in (0, 4):
            at = torch.from_numpy(pos + shift)
            if kind == "spec_tree_verify":
                feeds = (*_tree_feeds(gen, 4, 4, cfg.vocab_size), at)
            else:
                feeds = (torch.stack([torch.randperm(3, generator=gen) + 1
                                      for _ in range(4)]), at)
            snap = {n: t.clone() for n, t in srv.cache.items()}
            want = [t.clone() for t in eager(*feeds)]
            want_cache = {n: t.clone() for n, t in srv.cache.items()}
            for n, t in srv.cache.items():
                t.copy_(snap[n])
            n0 = [w.launches for w in counted]
            got = graph(*feeds)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), shift
            assert [w.launches for w in counted] == n0
            for n in snap:
                assert torch.equal(_live(srv, n), _live(srv, n, want_cache)), \
                    (kind, shift, n)
                srv.cache[n].copy_(snap[n])
    srv.close()
    ref = _serve_all(_graph_server(cfg, params, case, False), prompts)
    bad = _biased_draft(params)
    assert _serve_all(_tree_server(cfg, params, case, False, bad),
                      prompts) == ref
    for block, async_ in ((None, False), (4, False), (None, True)):
        srv = _tree_server(cfg, params, case, True, bad,
                           async_dispatch=async_)
        assert _serve_all(srv, prompts, block) == ref, (block, async_)
        names = {g.name: g for g in engine.ENGINE.graphs(srv._bind)}
        assert names["serving.spec_tree_verify@4"].replays \
            == srv._spec_rounds > 0
        assert names["serving.spec_tree_commit@4"].replays > 0
        srv.close()


@pytest.mark.parametrize("case", ["contiguous", "paged"])
def test_tree_serve_after_warmup_captures_nothing(case, monkeypatch):
    """warmup() captures the tree verify, the permute and the draft's
    steps; a serve whose paths leave the trunk then captures no graph and
    records no build, and serves the plain streams."""
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    ref = _serve_all(_graph_server(cfg, params, case, False), prompts)
    srv = _tree_server(cfg, params, case, True, _biased_draft(params))
    warmed = srv.warmup(prompt_lens=_GRAPH_LENS)
    assert {"spec_tree_verify@4", "spec_tree_commit@4",
            "draft_step"} <= set(warmed)
    binds = (srv._bind, srv._draft_bind)
    graphs0 = {id(g) for b in binds for g in engine.ENGINE.graphs(b)}
    builds0 = len(tl.compile_log())
    assert _serve_all(srv, prompts) == ref
    assert {id(g) for b in binds for g in engine.ENGINE.graphs(b)} \
        == graphs0
    assert len(tl.compile_log()) == builds0
    assert srv.stats()["spec.tree_nodes_accepted"] > 0
    srv.close()


# ---------------------------------------------------------------------------
# MoE serving on the card: the joint-routing step graphs and counters
# ---------------------------------------------------------------------------


def _moe_case(cf=1.25):
    """A small fp32 MoE model on the card (head_dim 64, 4 top-2 experts;
    C = 3 at 4 slots, so batch-mates contend)."""
    from paddle_tpu_torch.text import moe

    gen = _card()
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=torch.float32,
                        moe=moe.MoEConfig(num_experts=4, top_k=2,
                                          capacity_factor=cf))
    params = gpt.init_params(cfg, seed=3, device="cuda")
    prompts = [torch.randint(0, 512, (n,), generator=gen,
                             device="cuda").tolist() for n in _GRAPH_LENS]
    return cfg, params, prompts


@pytest.mark.parametrize("case", ["contiguous", "paged"])
def test_moe_step_graph_equals_the_eager_step(case, monkeypatch):
    """From one cache state and one accumulator state, the captured
    ``moe_step`` / ``moe_block`` give the eager bodies' logits and tokens
    bit for bit, write the same cache rows and add the same routing
    delta; the served streams, drops and load of graphed tick, block and
    async serves equal the eager ones."""
    from paddle_tpu_torch.text import engine

    monkeypatch.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    cfg, params, prompts = _moe_case()
    out = {}
    for graphs in (False, True):
        srv = _graph_server(cfg, params, case, graphs)
        for p in prompts[:4]:
            srv.submit(p, max_new_tokens=12)
        srv._ensure_decode_blocks(4)
        tok, pos = srv._feed_arrays()
        tok, pos = srv._host(tok), srv._host(pos)
        act = srv._act()
        st0 = {n: t.clone() for n, t in srv._moe_stats.items()}
        (logits,) = engine.ENGINE.get("moe_step", srv._spec())(tok, pos,
                                                               *act)
        logits = logits.clone()
        delta = {n: t - st0[n] for n, t in srv._moe_stats.items()}
        (toks,) = engine.ENGINE.get("moe_block", srv._spec(k=4))(tok, pos,
                                                                 *act)
        torch.cuda.synchronize()
        out[graphs] = (logits, toks.clone(), delta,
                       {n: t.clone() for n, t in srv._moe_stats.items()})
        srv.close()
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    for i in (2, 3):
        assert all(torch.equal(out[True][i][n], out[False][i][n])
                   for n in out[False][i])
    for block, async_ in ((None, False), (4, False), (None, True)):
        got = {}
        for graphs in (False, True):
            srv = _graph_server(cfg, params, case, graphs,
                                async_dispatch=async_)
            streams = _serve_all(srv, prompts, block)
            ls = srv.load_stats()
            got[graphs] = (streams, ls["moe_dropped_tokens"],
                           ls["moe_expert_load"])
            if graphs:
                names = {g.name for g in engine.ENGINE.graphs(srv._bind)}
                assert ("serving.moe_async_step" if async_ else
                        f"serving.moe_block@{block}" if block else
                        "serving.moe_step") in names, names
            srv.close()
        assert got[True] == got[False], (block, async_)


def test_moe_accumulator_advances_across_replays_and_drains_exactly():
    """The zero-router model at cf 0.5: each replay of the captured step
    adds its drops into the bound accumulator (never into a copy), the
    capture's eager warm run adds nothing, and ``load_stats`` drains the
    host-replayed total; ``moe.dropped_tokens`` advances by exactly the
    drops since the last drain."""
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.text import engine, serving

    cfg, params, _ = _moe_case(cf=0.5)
    params["blocks"]["moe"]["router_w"].zero_()
    srv = serving.DecodeServer(params, cfg, max_batch=2, max_len=32,
                               device="cuda")
    srv.warmup(prompt_lens=[2, 3])
    assert srv.load_stats()["moe_dropped_tokens"] == 0
    c0 = tl.counter("moe.dropped_tokens")
    rids = [srv.submit([1, 2], max_new_tokens=6),
            srv.submit([3, 4, 5], max_new_tokens=6)]
    L, want, drained = cfg.num_layers, 0, 0
    stats_ptr = srv._moe_stats["dropped"].data_ptr()
    while srv.pending():
        active = sum(1 for st in srv._slots.values())
        srv.tick()
        want += 2 * L * max(0, active - 1)
        if active == 2 and not drained:
            drained = srv.load_stats()["moe_dropped_tokens"]
            assert drained == want
            assert tl.counter("moe.dropped_tokens") - c0 == want
    assert srv._moe_stats["dropped"].data_ptr() == stats_ptr
    step = next(g for g in engine.ENGINE.graphs(srv._bind)
                if g.name == "serving.moe_step")
    assert step.replays > 0
    ls = srv.load_stats()
    assert ls["moe_dropped_tokens"] == want > drained > 0
    assert tl.counter("moe.dropped_tokens") - c0 == want
    assert all(len(srv.result(r)) == 6 for r in rids)
    srv.close()


def test_moe_top_k_ties_on_the_card_take_the_lowest_experts():
    """A stable descending sort keeps ``jax.lax.top_k``'s order on ties
    on the card too: a zeroed router sends every token to experts 0 and
    1; equal logits elsewhere take the lower index."""
    from paddle_tpu_torch.text import moe

    _card()
    logits = torch.zeros(4096, 8, device="cuda")
    logits[::2, 5] = logits[::2, 6] = 1.0
    _, idx, _ = moe._top_k_gating(logits, 2)
    assert idx[1::2].tolist() == [[0, 1]] * 2048
    assert idx[::2].tolist() == [[5, 6]] * 2048
    x = torch.randn(64, 32, device="cuda")
    disp, _, _ = moe._route({"router_w": torch.zeros(32, 8, device="cuda")},
                            x, moe.MoEConfig(num_experts=8, top_k=2), None,
                            8, 64, torch.float32)
    assert disp[:, 2:].sum() == 0 and disp[:, :2].sum() == 128


def test_normal_draws_on_the_card_are_the_cpus():
    """``rng.normal`` (router noise under a key): the same bits on the
    card as on the CPU, and values within 1e-6 (``erfinv`` may round one
    ulp apart between the devices); a remat recompute or a CUDA graph
    therefore draws the CPU's noise."""
    from paddle_tpu_torch import rng

    _card()
    key = rng.fold_in(rng.seed_key(0), 2)
    shape = (2048, 8)
    assert torch.equal(rng.bits(key, shape, "cuda").cpu(),
                       rng.bits(key, shape, "cpu"))
    card = rng.normal(torch.tensor(key, device="cuda"), shape, "cuda")
    cpu = rng.normal(key, shape, "cpu")
    assert card.dtype == torch.float32
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-6, rtol=0)


def _adapter_pool(cfg, params, n=2, rank=4, seed=0):
    """A pool of ``n`` rank-``rank`` adapters over ``params`` whose b is
    drawn (0.3 x N(0, 1)), so each bites; returns (pool, adapters)."""
    from paddle_tpu_torch.text import adapters, lora

    pool = adapters.AdapterPool(params, cfg, rank=rank, max_adapters=n + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ads = []
    for i in range(n):
        ad = lora.split_lora(lora.lora_init(params, cfg, rank=rank,
                                            key=seed + i))[1]
        ad = {k: (0.3 * torch.randn(v.shape, generator=gen, device="cuda")
                  if k.endswith("_lora_b") else v) for k, v in ad.items()}
        pool.register(f"ad-{i + 1}", ad)
        ads.append(ad)
    return pool, ads


@pytest.mark.parametrize("case", ["contiguous", "paged"])
def test_adapter_step_graph_equals_the_eager_step(case, monkeypatch):
    """From one cache state, the captured ``adapter_step`` with mixed ids
    gives the eager body's logits bit for bit, and its ``adapter_block``
    the eager block's tokens."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case(case, monkeypatch)
    pool, _ = _adapter_pool(cfg, params)
    out = {}
    for graphs in (False, True):
        srv = _graph_server(cfg, params, case, graphs, adapter_pool=pool)
        for i, p in enumerate(prompts[:4]):
            srv.submit(p, max_new_tokens=12,
                       adapter=None if i % 3 == 0 else f"ad-{i % 3}")
        srv._ensure_decode_blocks(4)
        tok, pos = srv._feed_arrays()
        tok, pos = srv._host(tok), srv._host(pos)
        (ids,) = srv._ids()
        (logits,) = engine.ENGINE.get("adapter_step", srv._spec())(
            ids, tok, pos)
        logits = logits.clone()
        (toks,) = engine.ENGINE.get("adapter_block", srv._spec(k=4))(
            ids, tok, pos)
        out[graphs] = (logits, toks.clone())
        srv.close()
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


def test_register_after_warmup_captures_nothing_and_serves_the_row(
        monkeypatch):
    """A register after warmup writes its pool row in place: serving that
    adapter then captures no graph and builds no step, and its streams
    are those of an eager server that had the adapter from the start."""
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.text import engine, lora

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    pool, ads = _adapter_pool(cfg, params, n=1)
    srv = _graph_server(cfg, params, "contiguous", True, adapter_pool=pool)
    srv.warmup(prompt_lens=list(_GRAPH_LENS))
    graphs = {g.name: g for g in engine.ENGINE.graphs(srv._bind)}
    builds = len(tl.compile_log())
    fresh = _adapter_pool(cfg, params, n=1, seed=5)[1][0]
    pool.register("ad-2", fresh)
    got = _serve_all(srv, prompts[:3], adapter="ad-2")
    assert len(tl.compile_log()) == builds
    assert {g.name: g for g in engine.ENGINE.graphs(srv._bind)} == graphs
    assert graphs["serving.adapter_step"].replays > 1
    srv.close()
    ref_pool, _ = _adapter_pool(cfg, params, n=0)
    ref_pool.register("ad-2", fresh)
    eager = _graph_server(cfg, params, "contiguous", False,
                          adapter_pool=ref_pool)
    assert got == _serve_all(eager, prompts[:3], adapter="ad-2")
    eager.close()
    merged = lora.merge_lora(lora.join_lora(params, fresh))
    base = _graph_server(cfg, merged, "contiguous", False)
    solo = _serve_all(base, prompts[:3])
    base.close()
    assert got == solo


def test_masked_step_greedy_pick_is_the_masked_argmax(monkeypatch):
    """The captured ``masked_step`` at temperature 0 returns, per slot,
    the argmax of the step's logits plus the mask, from the same cache
    state as the eager step's logits."""
    from paddle_tpu_torch.text import engine

    cfg, params, prompts = _graph_case("contiguous", monkeypatch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for graphs in (False, True):
        srv = _graph_server(cfg, params, "contiguous", graphs)
        for p in prompts[:4]:
            srv.submit(p, max_new_tokens=12)
        tok, pos = srv._feed_arrays()
        tok, pos = srv._host(tok), srv._host(pos)
        if not graphs:
            (logits,) = engine.ENGINE.get("step", srv._spec())(tok, pos)
            logits = logits.clone()
        else:
            B, V = 4, cfg.vocab_size
            allowed = torch.rand(B, V, generator=gen, device="cuda") < 0.1
            mask = torch.where(allowed, 0.0, -1e30).float().cpu()
            z = torch.zeros(B)
            (nxt,) = engine.ENGINE.get("masked_step", srv._spec())(
                tok, pos, srv._host(srv._key(0)), z, z.long(),
                torch.ones(B), mask)
            nxt = nxt.clone()
            assert engine.ENGINE.graphs(srv._bind)
        srv.close()
        out[graphs] = logits if not graphs else nxt
    want = torch.argmax(out[False] + mask.cuda(), dim=-1)
    assert torch.equal(out[True], want)
    assert bool(allowed[torch.arange(4, device="cuda"), out[True]].all())


# ---------------------------------------------------------------------------
# the serving fleet on the card: a worker on its own stream, rows handed
# across streams, launch counts across threads
# ---------------------------------------------------------------------------


def _fleet_drive(router, prompts, new=12):
    import time

    rids = [router.submit(p, max_new_tokens=new) for p in prompts]
    deadline = time.time() + 120.0
    while router.pending() and time.time() < deadline:
        router.tick()
        if not any(r._slots or r._queue for r in router.replicas
                   if r is not None):
            time.sleep(0.002)
    assert not router.pending()
    return [router.result(r) for r in rids]


@pytest.mark.parametrize("case", ["contiguous", "paged"])
def test_loopback_fleet_equals_one_server(case, monkeypatch):
    """A loopback fleet of 2 graphed replicas and 1 graphed worker (its
    own stream), every prompt handed off, streamed and whole: the single
    graphed server's streams exactly; nothing captured after the warmups
    (the Router's of the replicas' inject steps included)."""
    from paddle_tpu_torch.text import engine, fleet

    cfg, params, prompts = _graph_case("paged" if case == "paged"
                                       else "fp32", monkeypatch)
    engine.ENGINE._steps.clear()     # room: no eviction during the test
    lens = [len(p) for p in prompts]
    one = _graph_server(cfg, params, case, True)
    ref = _serve_all(one, prompts)
    one.close()
    lay = (dict(layout="paged", block_size=16) if case == "paged" else {})
    for rows in ("0", "8"):
        monkeypatch.setenv("PADDLE_TPU_STREAM_CHUNK_ROWS", rows)
        worker = fleet.PrefillWorker(params, cfg, max_len=160, **lay)
        worker.warmup(prompt_lens=lens)
        reps = [_graph_server(cfg, params, case, True) for _ in range(2)]
        for r in reps:
            r.warmup(prompt_lens=lens)
        router = fleet.Router(reps, prefill=[worker], prefill_threshold=1)
        graphs = len(engine.ENGINE.graphs())
        assert _fleet_drive(router, prompts) == ref, rows
        assert len(engine.ENGINE.graphs()) == graphs
        router.close()


def test_rows_cross_streams_after_the_workers_event(monkeypatch):
    """The worker's rows are written on its stream, behind a long spin;
    ``submit_prefilled(..., ready=event)`` makes the replica's stream wait
    on the event before its inject replay: the stream equals a local
    admission's."""
    from paddle_tpu_torch.text import engine, fleet

    cfg, params, prompts = _graph_case("fp32", monkeypatch)
    # room: an evicted graph captured again inside the spin would
    # synchronize the card and complete the event
    engine.ENGINE._steps.clear()
    prompt = max(prompts, key=len)
    one = _graph_server(cfg, params, "fp32", True)
    ref = _serve_all(one, [prompt])
    one.close()
    worker = fleet.PrefillWorker(params, cfg, max_len=160)
    worker.warmup(prompt_lens=[len(prompt)])
    srv = _graph_server(cfg, params, "fp32", True)
    srv.warmup(prompt_lens=[len(prompt)])
    engine.ENGINE.warm_inject(srv, [len(prompt)])
    n = len(prompt)
    C = worker._bucket(n)
    # the worker's admission step, its rows' copies and their event, on
    # its stream behind a long spin (``_prefill`` would wait for them)
    with torch.cuda.stream(worker._stream):
        torch.cuda._sleep(200_000_000)         # ~0.1 s behind the rows
        (logits,) = engine.ENGINE.get("prefill", worker._spec(bucket=C))(
            *worker._feeds(prompt, C, n, 0))
        rows, logits, ev = worker._ship(worker._take_rows(0, n),
                                        logits.float().clone(), False)
    assert ev is not None and not ev.query()
    rid = srv.submit_prefilled(prompt, rows, logits, max_new_tokens=12,
                               ready=ev)
    del rows, logits
    while srv.pending():
        srv.tick()
    assert [srv.result(rid)] == ref
    worker.close()
    srv.close()


def test_launch_counts_exact_while_a_worker_thread_prefills(monkeypatch):
    """A replica ticks on this thread while a worker thread prefills (and
    captures nothing: warmed first): every launch of both lands in the
    wrappers' counters — the decode tick launches are the replica's step
    replays' and the flash launches its and the worker's prefill
    replays'."""
    import threading

    from paddle_tpu_torch.text import engine, fleet

    cfg, params, prompts = _graph_case("fp32", monkeypatch)
    engine.ENGINE._steps.clear()     # room: no eviction during the test
    worker = fleet.PrefillWorker(params, cfg, max_len=160)
    long_p = max(prompts, key=len)
    worker.warmup(prompt_lens=[len(long_p)])
    srv = _graph_server(cfg, params, "fp32", True)
    srv.warmup(prompt_lens=[len(p) for p in prompts])
    for w in (fa.flash_attention_fwd, da.decode_attention):
        for a in ("launches", "tc_launches", "tick_launches"):
            if hasattr(w, a):
                setattr(w, a, 0)
    graphs = (engine.ENGINE.graphs(worker._bind)
              + engine.ENGINE.graphs(srv._bind))
    reps0 = {g: g.replays for g in graphs}
    done = threading.Event()

    def prefill_loop():
        for _ in range(20):
            worker.prefill(long_p)
        done.set()

    t = threading.Thread(target=prefill_loop)
    t.start()
    _serve_all(srv, prompts)
    t.join()
    assert done.is_set()
    torch.cuda.synchronize()
    # the same graphs as before the run: nothing captured or evicted
    assert set(engine.ENGINE.graphs(worker._bind)
               + engine.ENGINE.graphs(srv._bind)) == set(reps0)
    grown = [(g.name, g.replays - n) for g, n in reps0.items()]
    L = cfg.num_layers
    steps = sum(n for name, n in grown if name == "serving.step")
    prefills = sum(n for name, n in grown
                   if name.startswith("serving.prefill@"))
    assert prefills == 20 + len(prompts)
    assert da.decode_attention.launches == L * steps
    assert da.decode_attention.tick_launches == L * steps
    assert fa.flash_attention_fwd.launches == L * prefills
    worker.close()
    srv.close()


# ---------------------------------------------------------------------------
# hybrid-parallel training: ranks on the card against ranks on the CPU
# ---------------------------------------------------------------------------

HYBRID_FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "1"}


def _hybrid_cases(device, meshes):
    """Five AdamW steps of a small fp32 model (head_dim 128) on each of
    ``meshes`` ((mesh, step arguments)), the fused CE and LN flags on."""
    import numpy as np

    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=128, dtype=torch.float32)
    master = gpt.init_master_params(cfg, seed=7, device="cpu")
    params = {k: (v.numpy() if not isinstance(v, dict) else
                  {n: t.numpy() for n, t in v.items()})
              for k, v in master.items()}
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (4, 65)) for _ in range(5)]
    return cfg, [{"kind": "train", "cfg": cfg, "mesh": mesh, "kw": kw,
                  "params": params, "batches": batches, "lr": 1e-3,
                  "flags": HYBRID_FLAGS, "device": device}
                 for mesh, kw in meshes]


def _hybrid_card_vs_cpu(card_device, meshes):
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.tools import hybrid_check as hc

    _build.build_all()          # here, so that the ranks only load
    cfg, card = _hybrid_cases(card_device, meshes)
    _, cpu = _hybrid_cases("cpu", meshes)
    got = spawn.spawn(hc.run_cases, (card,), nprocs=4, device=card_device)
    ref = spawn.spawn(hc.run_cases, (cpu,), nprocs=4, device="cpu")[0]
    for i, (mesh, kw) in enumerate(meshes):
        losses = got[0][i]["losses"]
        assert max(abs(a - b) for a, b in zip(losses, ref[i]["losses"])) \
            <= 1e-4, (mesh, losses, ref[i]["losses"])
        for r in got:
            want = hc.expected_hybrid_launches(
                cfg, mesh, kw.get("n_micro", 1), 1,
                r[i]["coords"].get("pp", 0))
            assert all(step == want for step in r[i]["launches"]), \
                (mesh, r[i]["rank"], r[i]["launches"][0], want)
    return got[0]


def test_hybrid_ranks_share_one_card():
    """dp2 x mp2 and pp2 x mp2 (1F1B) with four ranks on card 0 over gloo,
    collectives staged through pinned host memory: the losses of four CPU
    ranks, every rank's kernels launched exactly."""
    _card()
    out = _hybrid_card_vs_cpu("cuda:0", [({"dp": 2, "mp": 2}, {}),
                                         ({"pp": 2, "mp": 2},
                                          {"n_micro": 2})])
    assert out[0]["meta"]["backend"] == "gloo"
    assert out[0]["meta"]["transport"] == "staged"


def test_hybrid_on_four_cards():
    """The same on NCCL, one rank a card (four_cards: run it alone with
    ``-k four_cards`` on a four-card machine)."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (four_cards)")
    out = _hybrid_card_vs_cpu(None, [({"dp": 2, "mp": 2}, {}),
                                     ({"pp": 2, "mp": 2}, {"n_micro": 2}),
                                     ({"dp": 4}, {"zero": 2})])
    assert out[0]["meta"]["backend"] == "nccl"


# ---------------------------------------------------------------------------
# the sp ring's kernel route and the sp / ep axes of the hybrid step
# ---------------------------------------------------------------------------

def test_ring_kernel_route_matches_plain_twin():
    """Ring attention on four ranks sharing card 0 (gloo, staged): the
    kernel route (#1 on each live block, #2 / #3 in the backward) against
    the plain route, bf16 at head_dim 128, contiguous and zigzag over sp4
    and sp2 (mp2 heads), GQA 8/2 and the non-causal ring: the output
    within atol = rtol = 1e-2, dq, dk, dv within rtol 1e-2 and atol 1e-2
    of the tensor's largest entry (flash takes δ from the bf16 output;
    the plain route differentiates fp32 math), each rank's launches
    exactly ``ring_attention.launches`` and all on the tensor-core
    bodies."""
    _card()
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.tools import hybrid_check as hc

    _build.build_all()
    shapes = [({"sp": 4}, 8, 8, False, True), ({"sp": 4}, 8, 8, True, True),
              ({"sp": 2, "mp": 2}, 8, 2, False, True),
              ({"sp": 2, "mp": 2}, 8, 2, True, True),
              ({"sp": 4}, 4, 4, False, False)]
    cases = [{"kind": "ring", "mesh": mesh, "zigzag": zig, "causal": causal,
              "gen": (2, 512, H, Hkv, 128, 5), "dtype": "bfloat16",
              "routes": ("kernel", "plain")}
             for mesh, H, Hkv, zig, causal in shapes]
    outs = spawn.spawn(hc.run_cases, (cases,), nprocs=4, device="cuda:0")
    for i, (mesh, H, Hkv, zig, causal) in enumerate(shapes):
        R = mesh["sp"]
        layout = "zigzag" if zig else ("causal" if causal else "full")
        for rank, o in enumerate(outs):
            n = ra.launches(layout, R, rank // (4 // R))
            want = {k: n for k in ("flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv")}
            assert o[i]["kernel"]["launches"] == want, (i, rank)
            assert o[i]["kernel"]["tc_launches"] == want, (i, rank)
        k, p = outs[0][i]["kernel"], outs[0][i]["plain"]
        for t in ("out", "dq", "dk", "dv"):
            want = torch.as_tensor(p[t])
            atol = 1e-2 * (1.0 if t == "out" else float(want.abs().max()))
            torch.testing.assert_close(torch.as_tensor(k[t]), want,
                                       atol=atol, rtol=1e-2,
                                       msg=f"{shapes[i]} {t}")


def test_hybrid_sp_ep_ranks_share_one_card():
    """sp2 x mp2 zigzag, pp2 x sp2 (1F1B) and an MoE model at dp2 x ep2
    with four ranks on card 0 over gloo: the losses of four CPU ranks
    within 1e-4 (the CPU's ring takes the plain route, the card's the
    kernels), every rank's kernels launched exactly."""
    _card()
    import dataclasses

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text.moe import MoEConfig
    from paddle_tpu_torch.tools import hybrid_check as hc

    _build.build_all()
    dense, _ = _hybrid_cases("cpu", [])
    moe_cfg = dataclasses.replace(dense, moe=MoEConfig(
        num_experts=4, capacity_factor=1.0))
    runs = [(dense, {"sp": 2, "mp": 2}, {"sp_zigzag": True}),
            (dense, {"pp": 2, "sp": 2}, {"n_micro": 2}),
            (moe_cfg, {"dp": 2, "ep": 2}, {})]

    def cases(device):
        import numpy as np

        out = []
        for cfg, mesh, kw in runs:
            master = gpt.init_master_params(cfg, seed=7, device="cpu")
            params = {k: (v.numpy() if not isinstance(v, dict) else
                          {n: (t.numpy() if not isinstance(t, dict) else
                               {m: u.numpy() for m, u in t.items()})
                           for n, t in v.items()})
                      for k, v in master.items()}
            rng = np.random.default_rng(3)
            out.append({"kind": "train", "cfg": cfg, "mesh": mesh, "kw": kw,
                        "params": params, "lr": 1e-3, "device": device,
                        "flags": HYBRID_FLAGS,
                        "batches": [rng.integers(0, cfg.vocab_size, (4, 65))
                                    for _ in range(5)]})
        return out

    got = spawn.spawn(hc.run_cases, (cases("cuda:0"),), nprocs=4,
                      device="cuda:0")
    ref = spawn.spawn(hc.run_cases, (cases("cpu"),), nprocs=4,
                      device="cpu")[0]
    for i, (cfg, mesh, kw) in enumerate(runs):
        losses = got[0][i]["losses"]
        assert max(abs(a - b) for a, b in zip(losses, ref[i]["losses"])) \
            <= 1e-4, (mesh, losses, ref[i]["losses"])
        for r in got:
            c = r[i]["coords"]
            want = hc.expected_hybrid_launches(
                cfg, mesh, kw.get("n_micro", 1), 1, c.get("pp", 0),
                sp_rank=c.get("sp", 0), zigzag=kw.get("sp_zigzag", False))
            assert all(step == want for step in r[i]["launches"]), \
                (mesh, r[i]["rank"], r[i]["launches"][0], want)


# ---------------------------------------------------------------------------
# tensor-parallel serving: DecodeServer(mesh=) over rank processes
# ---------------------------------------------------------------------------

def _tp_serve(srv, prompts, new=16):
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    ticks = 0
    while srv.pending():
        srv.tick()
        ticks += 1
    return [srv.result(r) for r in rids], ticks


def _tp_case(device, shape, graphs_expected):
    """A small fp32 model (head_dim 128, GQA 4/2) served by a mesh= server
    of ``shape`` on ``device``'s placement and by one card's server:
    the same greedy streams; each rank's launches — #1 on admission, #9
    (contiguous) or #10 (paged) on the tick body once a layer a tick —
    exact; on NCCL one step replay a tick per rank, no capture after
    warmup."""
    import numpy as np

    from paddle_tpu_torch.distributed import serving_mesh
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text import serving

    _build.build_all()
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=256,
                        pos_embed="rope", activation="swiglu",
                        dtype=torch.float32)
    params = gpt.init_params(cfg, seed=11, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (7, 60, 100)]
    size = 1
    for v in shape.values():
        size *= v
    pool = serving_mesh.RankPool(size, device=device, timeout_s=300.0)
    mod = "paddle_tpu_torch.text.tp_serving"
    try:
        mesh = pool.mesh(shape)
        assert (pool.transport == "nccl") == graphs_expected
        for layout in ("contiguous", "paged"):
            lay = (dict(layout="paged", block_size=16, num_blocks=48)
                   if layout == "paged" else {})
            one = serving.DecodeServer(params, cfg, max_batch=4,
                                       max_len=160, device="cuda", **lay)
            ref, _ = _tp_serve(one, prompts)
            one.close()
            srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                                       mesh=mesh, **lay)
            srv.warmup(prompt_lens=[len(p) for p in prompts])
            g0 = pool.call(mesh.members, f"{mod}:rank_graphs", srv._bind.bid)
            pool.call(mesh.members, f"{mod}:rank_reset_counts")
            got, ticks = _tp_serve(srv, prompts)
            counts = srv._bind.counts()
            g1 = pool.call(mesh.members, f"{mod}:rank_graphs", srv._bind.bid)
            srv.close()
            assert got == ref, (layout, got, ref)
            L = cfg.num_layers
            for c in counts:
                assert c == counts[0]
            c = counts[0]
            if layout == "contiguous":
                assert c["flash_attention_fwd.launches"] == L * len(prompts)
                assert c["decode_attention.launches"] == L * ticks
                assert c["decode_attention.tick_launches"] == L * ticks
            else:
                assert c["decode_attention.launches"] == 0
                assert c["paged_decode_attention.tick_launches"] >= L * ticks
            for a, b in zip(g0, g1):
                assert b["captured"] == a["captured"]
                if graphs_expected:
                    assert b["replays"]["serving.step"] \
                        - a["replays"].get("serving.step", 0) == ticks
    finally:
        pool.close()


def test_tp_server_ranks_share_one_card():
    """mp2 with two ranks on card 0 over gloo (staged, eager steps)."""
    _card()
    _tp_case("cuda:0", {"mp": 2}, False)


def test_tp_server_on_four_cards():
    """mp4 on NCCL, one rank a card, every step a captured graph with the
    collectives inside (four_cards: run it alone with ``-k four_cards``
    on a four-card machine)."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (four_cards)")
    _tp_case(None, {"mp": 4}, True)


# -- parameter-server services (no kernel of the port on this path) ---------

def test_ps_device_table_card_matches_cpu():
    """A 4096 x 16 adagrad table under 20 pushes with duplicates: rows and
    accumulator within 1e-6 relative (1e-7 absolute) of the CPU's."""
    _card()
    from paddle_tpu_torch.tools import ps_check

    rows, accum = ps_check.small_table_vs_cpu("cuda")
    assert rows <= 1 and accum <= 1, (rows, accum)


def test_ps_heter_trainer_card_matches_cpu(tmp_path):
    """tests/test_heter.py's V = 64 trainer on the card and on the CPU,
    each on its own same-seed servers: losses within 1e-4 for 20 steps,
    the first step's pushed row grads within 1e-7, and the rows within
    2e-3 (the servers' adagrad and Adam turn last bits of nearly
    cancelled grads into larger steps: ROADMAP C)."""
    _card()
    import numpy as np

    from paddle_tpu_torch import _native
    from paddle_tpu_torch.tools import ps_check

    _native.ps_table()
    out = ps_check.small_heter_vs_cpu("cuda", str(tmp_path))
    cpu, card = out["cpu"], out["card"]
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=0,
                               atol=1e-4)
    assert len(card["first_pushes"]) == len(cpu["first_pushes"]) == 2
    for (s1, i1, g1), (s2, i2, g2) in zip(card["first_pushes"],
                                          cpu["first_pushes"]):
        assert s1 == s2
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(g1, g2, rtol=0, atol=1e-7)
    assert np.abs(card["rows"] - cpu["rows"]).max() <= 2e-3


def test_ps_sharded_table_ranks_share_one_card():
    """Two ranks on card 0 (gloo, staged) hold the table's row shards:
    after the same pushes the gathered rows and a pull equal one card's
    table within 1e-6."""
    _card()
    import numpy as np

    from paddle_tpu_torch.distributed import ps as dps
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.tools import ps_check

    V, D = 1023, 16
    pushes = ps_check.duplicate_pushes(0, 6, 256, V, D)
    pull = np.arange(0, V, 7)
    outs = spawn.spawn(ps_check.run_tables, ([{
        "vocab": V, "dim": D, "pushes": pushes, "pull_ids": pull,
        "device": "cuda:0"}],), 2)
    one = dps.SparseEmbeddingTable(V, D, seed=0)
    for ids, g in pushes:
        one.push(ids, g)
    for (got,) in outs:
        np.testing.assert_allclose(got["rows"], one.state.rows.cpu().numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["pulls"],
                                   one.pull(pull).cpu().numpy(),
                                   rtol=0, atol=1e-6)


def test_prefetcher_on_the_card_orders_copies_and_slots():
    """``io.native_reader.DevicePrefetcher`` on the card: a fast producer
    of 24 host batches (64 MB each, so a copy takes time) and a slow
    consumer (the card spins before each read, on the consumer's
    stream): every batch arrives bit-equal to the host's, so the
    consumer's stream waited for each copy's event and no pinned slot was
    written again under a copy still reading it; the ring holds depth + 1
    buffers a leaf shape, made once."""
    _card()
    import numpy as np

    from paddle_tpu_torch.io import native_reader as nr

    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((4096, 4096)).astype(np.float32),
             "tok": rng.integers(0, 50304, (8, 2049), dtype=np.int32)}
            for _ in range(24)]
    pf = nr.DevicePrefetcher(iter(host), depth=2)
    got = 0
    for want, batch in zip(host, pf):
        torch.cuda._sleep(2_000_000)          # the slow consumer's step
        assert batch["x"].is_cuda and batch["tok"].dtype == torch.int32
        assert torch.equal(batch["x"], torch.from_numpy(want["x"]).cuda())
        assert torch.equal(batch["tok"],
                           torch.from_numpy(want["tok"]).cuda())
        got += 1
    assert got == len(host)
    assert pf.stager.stats["pinned_buffers"] == 2 * 3
    assert pf.stager.stats["copies"] == 2 * len(host)


def test_prefetcher_copy_failure_raises_in_the_consumer():
    """A batch the stager cannot take (already on the card) fails the
    iteration with its error; nothing falls back to the CPU."""
    _card()
    from paddle_tpu_torch.io import native_reader as nr

    pf = nr.DevicePrefetcher(iter([torch.zeros(3, device="cuda")]))
    with pytest.raises(ValueError, match="host batches"):
        list(pf)


def test_dgc_card_matches_cpu_bit_for_bit():
    """``fleet.comm_opt.dgc_compress``, three rounds on a small dict tree
    (a stacked [L, ...] leaf, a matrix, a leaf with ties at the
    threshold): the card's sends, u and v equal the CPU's bit for bit."""
    _card()
    import numpy as np

    from paddle_tpu_torch.distributed.fleet import comm_opt as co

    rng = np.random.default_rng(0)
    tie = 0.1 * rng.standard_normal(1000).astype(np.float32)
    tie[:40] = 2.5                    # the 40 largest |g| tie (k = 10)
    g = {"blocks": {"fc_w": torch.from_numpy(rng.standard_normal(
             (4, 64, 256)).astype(np.float32))},
         "wte": torch.from_numpy(rng.standard_normal(
             (512, 64)).astype(np.float32)),
         "tie": torch.from_numpy(tie)}
    gc = {"blocks": {"fc_w": g["blocks"]["fc_w"].cuda()},
          "wte": g["wte"].cuda(), "tie": g["tie"].cuda()}
    a, b = co.dgc_init(g), co.dgc_init(gc)
    assert b.u["wte"].is_cuda

    def flat(tree):
        return [tree["blocks"]["fc_w"], tree["wte"], tree["tie"]]

    for i in range(3):
        sa, a = co.dgc_compress(g, a, sparsity=0.99, momentum=0.9)
        sb, b = co.dgc_compress(gc, b, sparsity=0.99, momentum=0.9)
        for x, y in zip(flat(sa) + flat(a.u) + flat(a.v),
                        flat(sb) + flat(b.u) + flat(b.v)):
            assert torch.equal(x.view(torch.int32),
                               y.cpu().view(torch.int32))
        if i == 0:                    # every tie kept, past k
            assert int((sb["tie"] != 0).sum()) == 40


def test_util_over_card_ranks():
    """``fleet.util.UtilBase`` over two ranks placed on the cards: NCCL
    where there are two cards (its host values staged on each rank's
    card), gloo staged on card 0 where there is one.  Sum / max / min, a
    gather and the file shards as on the CPU."""
    _card()
    import numpy as np

    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.tools import hybrid_check as hc

    files = [f"f{i}" for i in range(5)]
    values = [np.array([r, -r, 2.5 * r]) for r in range(2)]
    outs = spawn.spawn(hc.run_cases, ([{"kind": "util", "mesh": {"dp": 2},
                                        "values": values,
                                        "files": files}],), nprocs=2)
    stacked = np.stack(values)
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for r, (out,) in enumerate(outs):
        assert out["backend"] == want
        np.testing.assert_array_equal(out["sum"], stacked.sum(0))
        np.testing.assert_array_equal(out["max"], stacked.max(0))
        np.testing.assert_array_equal(out["min"], stacked.min(0))
        assert [int(x) for x in out["gather"]] == [0, 1]
        assert out["shard"] == [files[0:3], files[3:5]][r]
