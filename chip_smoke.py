"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from this checkout (all ``nvcc``
   processes at once) and print the build seconds;
3. hold each kernel against its plain PyTorch twin at the serving paths'
   widths (bf16 outputs within 1e-2 * (1 + |plain|), lse within 1e-3):
   flash prefill; split-KV decode at a tick's Tq and at prefill-chunk
   widths (Tq * G = 512 and 1024 query rows per kv head); block-table
   (paged) decode, whose free slots must come back exactly zero;
4. check the decode paths on the card against the CPU on small fp32
   models (fp32 and int8 KV): contiguous prefill and batched decode, then
   paged prefill chunks and paged decode steps through shuffled block
   tables;
5. time each kernel with CUDA events at its path's shapes (L2 flushed
   between launches), beside its plain twin, its least possible time on
   the card, and a PyTorch call on the same work as a yardstick the port
   never calls (``scaled_dot_product_attention``; for the paged kernel on
   a pre-gathered contiguous copy, the gather timed on its own);
6. the main path, as ``paddle_tpu_torch.tools.profile_serving.
   build_main_path`` defines it: GPT-1.3B (``gpt.gpt_1p3b()``, full width,
   random weights from a seed, bf16) served by ``DecodeServer(max_batch=8,
   max_len=512)`` — 8 greedy requests, prompts of 40..300 tokens (prefill
   buckets 64, 128, 256, 512), 64 new tokens each — with the kernels'
   launch counts read around it and one request checked against a solo
   ``generate``;
7. the paged path, as ``build_paged_path`` defines it: the same model
   behind ``DecodeServer(layout="paged", block_size=16, num_blocks=128)``,
   8 chat requests sharing a 200-token system prompt — served tokens equal
   to a contiguous server's on the same prompts and one request to a solo
   ``generate``; the allocator's prefix hits, copies-on-write and radix
   splits; the kernels' launch counts read around it;
8. one ``{"kernels": [...]}`` JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without a CUDA card.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
# bf16 outputs: |kernel - plain| <= TOL * (1 + |plain|) elementwise — one
# bf16 ulp (2^-7 relative) where fp32 summation order tips a rounding
BF16_TOL = 1e-2
LSE_TOL = 1e-3                   # fp32 lse, summation order only
PATH_TOL = 1e-3                  # fp32 logits, card vs CPU, TF32 off
# greedy streams of a random-weight bf16 model: bf16 logits of magnitude
# 2-8 step by 1/64-1/32, and the top two are often one step apart or equal,
# so two correct kernel routes may break a tie differently.  A stream that
# leaves the reference must do so on a token whose logit, in the
# reference's own context, is within two steps of the best one.
TIE_TOL = 0.0625


def log(msg):
    print(msg, flush=True)


def cold_ms(torch, fn, iters=20):
    """Median device time of ``fn`` over ``iters`` launches, each bracketed
    by CUDA events, with the 50 MB L2 flushed (a 256 MB write) before
    each: the real caller finds its inputs cold, 23 layers of weights
    having streamed through since."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_flash(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_out = worst_lse = 0.0
    # every prefill bucket of the main path, a ragged T, and D = 64
    for T, D in [(64, 128), (128, 128), (256, 128), (512, 128), (1000, 128),
                 (256, 64)]:
        q, k, v = (torch.randn(1, T, 16, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        ref, ref_lse = fa._plain_fwd(q, k, v, True)
        torch.cuda.synchronize()
        e_out = (out.float() - ref.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=BF16_TOL,
                            rtol=BF16_TOL)
        log(f"  flash_fwd bf16 T={T} H=16 D={D} causal: max|out-plain| "
            f"{e_out:.3g} (tol {BF16_TOL}*(1+|plain|)), max|lse-plain| "
            f"{e_lse:.3g} (tol {LSE_TOL})")
        if not (ok and e_lse <= LSE_TOL):
            raise AssertionError(f"flash_fwd disagrees at T={T} D={D}")
        worst_out, worst_lse = max(worst_out, e_out), max(worst_lse, e_lse)
    return worst_out


def check_decode(torch, da):
    gen = torch.Generator(device="cuda").manual_seed(2)
    B = 8
    worst = 0.0
    # the main path's shape (T = 512 cache rows, Hkv = 16, Tq = 1, bf16)
    # first, then T = 2048 over GQA, Tq = 4 and int8
    cases = [(512, 16, 1, "bf16")] + [(2048, h, tq, kv) for h in (16, 4)
                                      for tq in (1, 4)
                                      for kv in ("bf16", "int8")]
    for T, Hkv, Tq, kv in cases:
        q = torch.randn(B, Tq, 16, 128, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, 128, generator=gen, device="cuda")
        v = torch.randn(B, T, Hkv, 128, generator=gen, device="cuda")
        ks = vs = None
        if kv == "int8":
            k, ks = da.quantize_kv(k)
            v, vs = da.quantize_kv(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        # frontiers in the first tile, on a tile edge, mid-cache, at the end
        pos = torch.tensor([0, 1, 63, 64, T // 3, T // 2, 3 * T // 4, T - Tq],
                           dtype=torch.int32, device="cuda")
        out = da.decode_attention(q, k, v, pos, ks, vs)
        ref = da._plain_decode(q, k, v, pos, ks, vs, None)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        log(f"  decode Hq=16 Hkv={Hkv} hd=128 T={T} Tq={Tq} {kv}: "
            f"max|out-plain| {err:.3g} (tol {BF16_TOL}*(1+|plain|))")
        if not torch.allclose(out.float(), ref.float(), atol=BF16_TOL,
                              rtol=BF16_TOL):
            raise AssertionError(f"decode disagrees at T={T} Hkv={Hkv} "
                                 f"Tq={Tq} {kv}")
        worst = max(worst, err)
    return worst


def check_decode_wide(torch, da):
    """Prefill-chunk widths: Tq * G = 512 (G = 1) and 1024 (G = 4) query
    rows per kv head, bf16 and int8, against the plain twin."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    T = 512
    for Tq, Hkv, kv in [(512, 16, "bf16"), (512, 16, "int8"),
                        (256, 4, "bf16"), (256, 4, "int8")]:
        q = torch.randn(2, Tq, 16, 128, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k = torch.randn(2, T, Hkv, 128, generator=gen, device="cuda")
        v = torch.randn(2, T, Hkv, 128, generator=gen, device="cuda")
        ks = vs = None
        if kv == "int8":
            k, ks = da.quantize_kv(k)
            v, vs = da.quantize_kv(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        pos = torch.tensor([0, T - Tq], dtype=torch.int32, device="cuda")
        out = da.decode_attention(q, k, v, pos, ks, vs)
        ref = da._plain_decode(q, k, v, pos, ks, vs, None)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        R = Tq * 16 // Hkv
        log(f"  decode R={R} (Tq={Tq} G={16 // Hkv}) T={T} {kv}: "
            f"max|out-plain| {err:.3g} (tol {BF16_TOL}*(1+|plain|))")
        if not torch.allclose(out.float(), ref.float(), atol=BF16_TOL,
                              rtol=BF16_TOL):
            raise AssertionError(f"decode disagrees at R={R} {kv}")
        worst = max(worst, err)
    return worst


def paged_inputs(torch, da, gen, Tq, Hq, Hkv, bs, nmax, kv, pos_list):
    """q and a pool of B * nmax + 1 shuffled blocks: slot b maps distinct
    random blocks through its frontier pos + Tq - 1 and leaves the rest
    -1; a slot whose position is None is free (all -1, pos 0)."""
    B = len(pos_list)
    N = B * nmax + 1
    q = torch.randn(B, Tq, Hq, 128, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn(N, bs, Hkv, 128, generator=gen, device="cuda")
    v = torch.randn(N, bs, Hkv, 128, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    tables = torch.full((B, nmax), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos_list):
        if p is not None:
            used = (p + Tq - 1) // bs + 1
            tables[b, :used] = perm[b * nmax:b * nmax + used]
            pos[b] = p
    return q, k, v, ks, vs, tables, pos


def check_paged(torch, da):
    """The paged kernel against gather-then-attend on every live slot, at
    the paged path's tick shape first (B = 8, Hq = Hkv = 16, bs = 16,
    nmax = 32, bf16), then GQA, Tq = 4, int8, block size 8; a free slot
    must return exactly zero (the kernel reads no unmapped block)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for Tq, Hkv, kv, bs in [(1, 16, "bf16", 16), (1, 16, "int8", 16),
                            (4, 4, "bf16", 8), (4, 4, "int8", 16),
                            (64, 4, "bf16", 16)]:
        nmax = 512 // bs
        pos_list = [0, 1, bs - 1, bs, 200, None, 512 - Tq, 333]
        q, k, v, ks, vs, tables, pos = paged_inputs(
            torch, da, gen, Tq, 16, Hkv, bs, nmax, kv, pos_list)
        out = da.paged_decode_attention(q, k, v, tables, pos, ks, vs)
        ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
        torch.cuda.synchronize()
        live = [b for b, p in enumerate(pos_list) if p is not None]
        err = (out[live].float() - ref[live].float()).abs().max().item()
        zero = not out[pos_list.index(None)].any().item()
        log(f"  paged Hq=16 Hkv={Hkv} hd=128 bs={bs} nmax={nmax} Tq={Tq} "
            f"{kv}: max|out-plain| {err:.3g} (tol {BF16_TOL}*(1+|plain|)), "
            f"free slot zero: {zero}")
        if not (zero and torch.allclose(out[live].float(), ref[live].float(),
                                        atol=BF16_TOL, rtol=BF16_TOL)):
            raise AssertionError(f"paged decode disagrees at bs={bs} "
                                 f"Hkv={Hkv} Tq={Tq} {kv}")
        worst = max(worst, err)
    return worst


def _small_models(torch, gpt):
    """(name, cfg, kv) of the small fp32 models the card-vs-CPU checks
    run: head_dim 128, MHA with learned positions and GQA with rope."""
    base = dict(vocab_size=512, hidden_size=256, num_layers=2,
                num_heads=2, max_seq_len=256, dtype=torch.float32)
    gqa = dict(num_heads=4, num_kv_heads=2, hidden_size=512,
               pos_embed="rope", activation="swiglu")
    for name, kw, kv in [("mha-learned", {}, ""), ("gqa-rope", gqa, ""),
                         ("mha-learned", {}, "int8"),
                         ("gqa-rope", gqa, "int8")]:
        yield name, gpt.GPTConfig(**{**base, **kw}), kv


def _to_card(params):
    """A copy of a CPU parameter tree on the card."""
    return {n: ({k: t.cuda() for k, t in v.items()} if n == "blocks"
                else v.cuda()) for n, v in params.items()}


def check_path_vs_cpu(torch, gpt, G, serving):
    """Small fp32 models: prefill and batched-decode logits on the card
    (both kernels) against the CPU's plain paths."""
    worst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        cpu = gpt.init_params(cfg, seed=3, device="cpu")
        card = _to_card(cpu)
        caches = {"cpu": G.init_cache(cfg, 3, 160, "cpu"),
                  "cuda": G.init_cache(cfg, 3, 160, "cuda")}
        rng = np.random.default_rng(0)
        lens = [5, 40, 100]
        for slot, n in enumerate(lens):
            toks = np.zeros((1, serving._pow2_bucket(n)), np.int64)
            toks[0, :n] = rng.integers(0, 512, n)
            outs = {}
            for dev, p in (("cpu", cpu), ("cuda", card)):
                outs[dev], _ = G.prefill_slot(
                    p, caches[dev], torch.from_numpy(toks).to(dev), n, slot,
                    cfg)
            worst = max(worst, (outs["cuda"].cpu() - outs["cpu"])
                        .abs().max().item())
        pos = np.array(lens, np.int32)
        for _ in range(5):
            tok = rng.integers(0, 512, 3)
            outs = {}
            for dev, p in (("cpu", cpu), ("cuda", card)):
                outs[dev], _ = serving.decode_step_batched(
                    p, caches[dev], torch.from_numpy(tok).to(dev),
                    torch.from_numpy(pos).to(dev), cfg)
            d = (outs["cuda"].cpu() - outs["cpu"]).abs().max().item()
            assert np.isfinite(d)
            worst = max(worst, d)
            pos = pos + 1
        log(f"  {name} kv={kv or 'fp32'}: max|logits card - cpu| so far "
            f"{worst:.3g} (tol {PATH_TOL})")
        if not worst <= PATH_TOL:
            raise AssertionError(f"card path disagrees with CPU on {name}")
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst


def check_paged_path_vs_cpu(torch, gpt, G, kv_pool, serving):
    """Small fp32 models: paged prefill chunks (several per prompt, the
    contiguous decode kernel at Tq = 64) and paged decode steps (the
    block-table kernel) through shuffled tables with a free slot, on the
    card against the CPU's plain paths."""
    worst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        cpu = gpt.init_params(cfg, seed=5, device="cpu")
        card = _to_card(cpu)
        caches = {dev: G.init_cache(cfg, 4, 160, dev, layout="paged",
                                    block_size=16, num_blocks=24)
                  for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(1)
        lens = [5, 40, 100]                  # slot 3 stays free
        tables = np.full((4, 10), -1, np.int32)
        perm = rng.permutation(24).astype(np.int32)
        for slot, n in enumerate(lens):
            used = (n + 5 + 15) // 16
            tables[slot, :used] = perm[slot * 8:slot * 8 + used]
        for c in caches.values():
            c["tables"].copy_(torch.from_numpy(tables))
        for slot, n in enumerate(lens):
            toks = rng.integers(0, 512, n)
            for pos0 in range(0, n, 64):
                length = min(64, n - pos0)
                pad = np.zeros((1, 64), np.int64)
                pad[0, :length] = toks[pos0:pos0 + length]
                outs = {}
                for dev, p in (("cpu", cpu), ("cuda", card)):
                    outs[dev], _ = kv_pool.paged_prefill_chunk(
                        p, caches[dev], torch.from_numpy(pad).to(dev), pos0,
                        length, slot, cfg)
                worst = max(worst, (outs["cuda"].cpu() - outs["cpu"])
                            .abs().max().item())
        pos = np.array(lens + [0], np.int32)
        for _ in range(5):
            tok = rng.integers(0, 512, 4)
            outs = {}
            for dev, p in (("cpu", cpu), ("cuda", card)):
                outs[dev], _ = serving.decode_step_batched(
                    p, caches[dev], torch.from_numpy(tok).to(dev),
                    torch.from_numpy(pos).to(dev), cfg)
            d = (outs["cuda"][:3].cpu() - outs["cpu"][:3]).abs().max().item()
            assert np.isfinite(d)
            worst = max(worst, d)
            pos = pos + np.array([1, 1, 1, 0], np.int32)
        log(f"  paged {name} kv={kv or 'fp32'}: max|logits card - cpu| so "
            f"far {worst:.3g} (tol {PATH_TOL})")
        if not worst <= PATH_TOL:
            raise AssertionError(f"paged card path disagrees with CPU on "
                                 f"{name}")
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst


def time_flash(torch, fa, F, T):
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, H, D = 1, 16, 128
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
    flops = 4 * B * H * D * T * (T + 1) // 2        # causal pairs only
    b_ms, b_by = bound(nbytes, flops)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return {
        "shape": f"B={B} T={T} H={H} D={D} bf16 causal",
        "ms": cold_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True)),
        "plain_ms": cold_ms(torch, lambda: fa._plain_fwd(q, k, v, True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }


def time_decode(torch, da, F, pos_list, T=512):
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, Hq, Hkv, hd = len(pos_list), 16, 16, 128
    q = torch.randn(B, 1, Hq, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    live = sum(min(T, p + 1) for p in pos_list)      # rows this data needs
    nbytes = live * Hkv * hd * 2 * 2 + 2 * q.numel() * 2 + B * 4
    flops = 4 * live * Hq * hd
    b_ms, b_by = bound(nbytes, flops)
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]      # [B, 1, 1, T]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return {
        "shape": f"B={B} Tq=1 Hq={Hq} Hkv={Hkv} hd={hd} T={T} bf16 "
                 f"pos={pos_list}",
        "ms": cold_ms(torch, lambda: da.decode_attention(q, k, v, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_decode(
            q, k, v, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
    }


def time_decode_chunk(torch, da, F, Tq=512):
    """The decode kernel at an admission chunk's width: one slot, Tq = 512
    query rows from position 0 against a 512-row cache (Hq = Hkv = 16,
    bf16) — causal attention over the chunk."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    Hq = Hkv = 16
    hd, T = 128, 512
    q, k, v = (torch.randn(1, n, h, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for n, h in ((Tq, Hq), (T, Hkv), (T, Hkv)))
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    live = Tq                                        # rows the chunk sees
    nbytes = live * Hkv * hd * 2 * 2 + 2 * q.numel() * 2 + 4
    flops = 4 * Hq * hd * Tq * (Tq + 1) // 2         # causal pairs only
    b_ms, b_by = bound(nbytes, flops)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :Tq], v[:, :Tq]))
    return {
        "shape": f"B=1 Tq={Tq} Hq={Hq} Hkv={Hkv} hd={hd} T={T} bf16 pos=0 "
                 f"(R={Tq * Hq // Hkv})",
        "ms": cold_ms(torch, lambda: da.decode_attention(q, k, v, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_decode(
            q, k, v, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }


def time_paged(torch, da, F, pos_list):
    """The paged kernel at the paged path's mid-serve tick: B = 8,
    Hq = Hkv = 16, hd = 128, bs = 16, nmax = 32, bf16, every slot's
    blocks distinct and shuffled.  Bound: the live K/V rows, the tables,
    q and the output.  Yardstick: SDPA on a pre-gathered contiguous copy
    (``gather_ms`` times the gather of K and V on its own)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bs, nmax, Hq, hd = 16, 32, 16, 128
    q, k, v, _, _, tables, pos = paged_inputs(
        torch, da, gen, 1, Hq, Hq, bs, nmax, "bf16", pos_list)
    B, T = len(pos_list), nmax * bs
    live = sum(p + 1 for p in pos_list)
    nbytes = (live * Hq * hd * 2 * 2 + 2 * q.numel() * 2 + B * 4
              + tables.numel() * 4)
    flops = 4 * live * Hq * hd
    b_ms, b_by = bound(nbytes, flops)
    kg, vg = (da.gather_paged_view(x, tables) for x in (k, v))
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]      # [B, 1, 1, T]
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    return {
        "shape": f"B={B} Tq=1 Hq={Hq} Hkv={Hq} hd={hd} bs={bs} nmax={nmax} "
                 f"bf16 pos={pos_list}",
        "ms": cold_ms(torch, lambda: da.paged_decode_attention(
            q, k, v, tables, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_paged(
            q, k, v, tables, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        "gather_ms": cold_ms(torch, lambda: (da.gather_paged_view(k, tables),
                                             da.gather_paged_view(v, tables))),
    }


def launch_counts(fa, da):
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "decode_attention": da.decode_attention.launches,
            "paged_decode_attention": da.paged_decode_attention.launches}


def zero_counts(fa, da):
    fa.flash_attention_fwd.launches = 0
    da.decode_attention.launches = 0
    da.paged_decode_attention.launches = 0


def serve(torch, srv, prompts, new):
    """Submit every prompt, tick until drained; returns (tokens per
    request, admission seconds, per-tick seconds, wall seconds)."""
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    t_admit = time.perf_counter() - t0
    ticks = []
    while srv.pending():
        t1 = time.perf_counter()
        srv.tick()
        ticks.append(time.perf_counter() - t1)
        if len(ticks) > 10 * new:
            raise AssertionError("server did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [srv.result(r) for r in rids], t_admit, ticks, wall


def check_tokens(torch, gpt, params, cfg, prompt, got, ref, what):
    """``got`` equals the reference stream ``ref`` (both greedy
    continuations of ``prompt``), or first leaves it on a bf16 tie: in a
    teacher-forced forward over prompt + ref, the logit of got's token at
    the divergence is within TIE_TOL of the best.  Returns None when
    equal, else (index, gap) — gap = best logit - got's logit there."""
    if got == ref:
        return None
    i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
    seq = torch.tensor([prompt + ref[:i + 1]], device="cuda")
    row = gpt.forward(params, seq, cfg)[0, len(prompt) - 1 + i].float()
    gap = (row.max() - row[got[i]]).item()
    log(f"  {what}: leaves the reference at token {i} of {len(ref)} on a "
        f"logit {gap:.4g} under the best (tie tolerance {TIE_TOL})")
    if not gap <= TIE_TOL:
        raise AssertionError(f"{what}: differs from the reference at token "
                             f"{i}: {got[:i + 3]} vs {ref[:i + 3]}, logit "
                             f"gap {gap}")
    return i, gap


def check_solo(torch, gpt, G, params, cfg, prompt, served, new):
    solo = G.generate(params, cfg, [prompt], new, device="cuda")
    return check_tokens(torch, gpt, params, cfg, prompt, served,
                        solo[0, len(prompt):].tolist(), "vs solo generate")


def main_path(torch, gpt, G, serving, fa, da, wl):
    cfg, params, srv, prompts = wl.build_main_path("cuda", seed=0)
    n_params = sum(t.numel() for n, t in params.items() if n != "blocks") \
        + sum(t.numel() for t in params["blocks"].values())
    assert n_params == gpt.count_params(cfg)
    assert params["wte"].dtype == torch.bfloat16
    log(f"  gpt_1p3b: {n_params} params, "
        f"{2 * n_params / 1e9:.3f} GB in bf16")
    lens, new = wl.LENS, wl.NEW
    buckets = sorted({serving._pow2_bucket(n, 512) for n in lens})
    assert buckets == [64, 128, 256, 512], buckets

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, da)
    served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
    launches = launch_counts(fa, da)
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(s) for s in served)
    log(f"  served {len(served)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission prefill {t_admit * 1e3:.1f} ms)")
    log(f"  launches in the main path: {launches}")
    if not (launches["flash_attention_fwd"] and launches["decode_attention"]):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    assert launches["flash_attention_fwd"] == cfg.num_layers * len(prompts)
    assert launches["decode_attention"] == cfg.num_layers * len(ticks)
    assert launches["paged_decode_attention"] == 0
    assert all(len(s) == new and all(0 <= t < cfg.vocab_size for t in s)
               for s in served)

    solo_div = check_solo(torch, gpt, G, params, cfg, prompts[0], served[0],
                          new)
    logits, _ = G.decode_step(params, G.init_cache(cfg, 1, 8, "cuda"),
                              torch.tensor([prompts[0][0]], device="cuda"),
                              0, cfg)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    stats = {
        "model": "gpt_1p3b", "params": n_params, "requests": len(served),
        "prompt_lens": lens, "new_tokens": new, "tokens": n_tok,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ticks": len(ticks), "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "peak_mem_gb": peak / 1e9,
        "launches": launches, "solo_generate_equal": solo_div is None,
        "solo_divergence": solo_div,
    }
    log(f"  tokens/s {stats['tokens_per_s']:.1f}, mean tick "
        f"{stats['tick_ms_mean']:.2f} ms, peak memory "
        f"{stats['peak_mem_gb']:.2f} GB")
    return stats, launches


def paged_path(torch, gpt, G, serving, kv_pool, fa, da, wl):
    cfg, params, srv, prompts = wl.build_paged_path("cuda", seed=0)
    new, L = wl.NEW, cfg.num_layers
    lens = [len(p) for p in prompts]
    # the contiguous server's tokens on the same prompts (not counted)
    cont = serving.DecodeServer(params, cfg, max_batch=8, max_len=512,
                                device="cuda")
    cont_tokens = serve(torch, cont, prompts, new)[0]
    cont.close()
    del cont

    chunk_calls = []
    plain_chunk = kv_pool.paged_prefill_chunk

    def counted_chunk(*args, **kw):
        chunk_calls.append(args[3:5])                 # (pos0, length)
        return plain_chunk(*args, **kw)

    kv_pool.paged_prefill_chunk = counted_chunk
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa, da)
        served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
        launches = launch_counts(fa, da)
    finally:
        kv_pool.paged_prefill_chunk = plain_chunk
    peak = torch.cuda.max_memory_allocated()
    load = srv.load_stats()
    pool = load["kv_pool"]
    n_tok = sum(len(s) for s in served)
    log(f"  served {len(served)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission {t_admit * 1e3:.1f} ms in "
        f"{len(chunk_calls)} chunks {chunk_calls})")
    log(f"  launches in the paged path: {launches}")
    log(f"  allocator: {json.dumps(pool)}; prefilled rows "
        f"{load['prefill_rows']} of {sum(lens)} prompt rows")
    if not (launches["paged_decode_attention"]
            and launches["decode_attention"]):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    assert launches["paged_decode_attention"] == L * len(ticks), launches
    assert launches["decode_attention"] == L * len(chunk_calls), launches
    assert launches["flash_attention_fwd"] == 0, launches
    assert all(len(s) == new for s in served)
    cont_div = {r: check_tokens(torch, gpt, params, cfg, prompts[r],
                                served[r], cont_tokens[r],
                                f"request {r} vs the contiguous server")
                for r in range(len(prompts))}
    same = sum(len(a) if d is None else d[0]
               for a, d in zip(served, cont_div.values()))
    log(f"  {same} of {n_tok} tokens served before any stream left the "
        f"contiguous server's; requests equal throughout: "
        f"{[r for r, d in cont_div.items() if d is None]}")
    assert served[1] == served[2]           # the same prompt, twice
    assert pool["prefix_hits"] >= 7 * 192, pool
    assert pool["cow_copies"] >= 1 and pool["radix_splits"] >= 1, pool
    assert load["prefill_rows"] < sum(lens), load
    solo_div = check_solo(torch, gpt, G, params, cfg, prompts[0], served[0],
                          new)
    srv.close()
    stats = {
        "model": "gpt_1p3b", "layout": "paged", "block_size": 16,
        "num_blocks": 128, "requests": len(served), "prompt_lens": lens,
        "new_tokens": new, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "ticks": len(ticks),
        "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "admission_chunks": len(chunk_calls),
        "prefill_rows": load["prefill_rows"], "prompt_rows": sum(lens),
        "peak_mem_gb": peak / 1e9, "launches": launches, "kv_pool": pool,
        "contiguous_tokens_equal": all(d is None for d in cont_div.values()),
        "tokens_before_divergence": same,
        "contiguous_divergences": {r: d for r, d in cont_div.items()
                                   if d is not None},
        "solo_generate_equal": solo_div is None, "solo_divergence": solo_div,
    }
    log(f"  tokens/s {stats['tokens_per_s']:.1f}, mean tick "
        f"{stats['tick_ms_mean']:.2f} ms, peak memory "
        f"{stats['peak_mem_gb']:.2f} GB")
    return stats, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text import generate as G
    from paddle_tpu_torch.text import gpt, kv_pool, serving
    from paddle_tpu_torch.tools import profile_serving as wl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = wl.card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[kernels vs plain twins]")
    err = {"flash_attention_fwd": check_flash(torch, fa),
           "decode_attention": max(check_decode(torch, da),
                                   check_decode_wide(torch, da)),
           "paged_decode_attention": check_paged(torch, da)}

    log("[decode paths on the card vs the CPU]")
    check_path_vs_cpu(torch, gpt, G, serving)
    check_paged_path_vs_cpu(torch, gpt, G, kv_pool, serving)

    log("[kernel timings at the paths' shapes]")
    flash_by_t = {T: time_flash(torch, fa, F, T) for T in (64, 128, 256, 512)}
    for T, row in flash_by_t.items():
        log(f"  flash_attention_fwd {json.dumps(row)}")
    # decode at mid-serve: every slot halfway through its new tokens
    dec = time_decode(torch, da, F, [n + wl.NEW // 2 for n in wl.LENS])
    log(f"  decode_attention {json.dumps(dec)}")
    dec_chunk = time_decode_chunk(torch, da, F)
    log(f"  decode_attention admission chunk {json.dumps(dec_chunk)}")
    paged_lens = [len(p) for p in wl.paged_prompts(50304)]
    paged = time_paged(torch, da, F, [n + wl.NEW // 2 for n in paged_lens])
    log(f"  paged_decode_attention {json.dumps(paged)}")

    log("[main path: DecodeServer, gpt_1p3b, contiguous KV]")
    stats, main_launches = main_path(torch, gpt, G, serving, fa, da, wl)
    log(json.dumps({"main_path": stats}))

    log("[paged path: DecodeServer(layout='paged'), gpt_1p3b]")
    pstats, paged_launches = paged_path(torch, gpt, G, serving, kv_pool, fa,
                                        da, wl)
    log(json.dumps({"paged_path": pstats}))

    def entry(name, src, replaces, row, **extra):
        by_path = {"main": main_launches[name], "paged": paged_launches[name]}
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": err[name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], **extra}

    kernels = [
        entry("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_fwd.cu",
              "paddle_tpu/ops/flash_attention.py:164", flash_by_t[512]),
        entry("decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
              "paddle_tpu/ops/decode_attention.py:282", dec,
              at_admission_chunk=dec_chunk),
        entry("paged_decode_attention",
              "paddle_tpu_torch/csrc/paged_decode_attention.cu",
              "paddle_tpu/ops/decode_attention.py:509", paged,
              gather_ms=paged["gather_ms"]),
    ]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
