"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from this checkout (all ``nvcc``
   processes at once) and print the build seconds;
3. hold each kernel against its plain PyTorch twin at the serving path's
   widths (bf16 outputs within 1e-2 * (1 + |plain|), lse within 1e-3);
4. check the whole decode path on the card against the CPU on small fp32
   models (prefill and batched-decode logits, fp32 and int8 KV);
5. time each kernel with CUDA events at the main path's shapes (L2 flushed
   between launches), beside its plain twin, its least possible time on
   the card, and ``torch.nn.functional.scaled_dot_product_attention`` on
   the same work as a yardstick the port never calls;
6. the main path, as ``paddle_tpu_torch.tools.profile_serving.
   build_main_path`` defines it: GPT-1.3B (``gpt.gpt_1p3b()``, full width,
   random weights from a seed, bf16) served by ``DecodeServer(max_batch=8,
   max_len=512)`` — 8 greedy requests, prompts of 40..300 tokens (prefill
   buckets 64, 128, 256, 512), 64 new tokens each — with both kernels'
   launch counts read around it and one request checked against a solo
   ``generate``;
7. one ``{"kernels": [...]}`` JSON line, then, as the last line,
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


def check_path_vs_cpu(torch, gpt, G, serving):
    """Small fp32 models: prefill and batched-decode logits on the card
    (both kernels) against the CPU's plain paths."""
    worst = 0.0
    cases = [("mha-learned", dict(), ""),
             ("gqa-rope", dict(num_heads=4, num_kv_heads=2, hidden_size=512,
                               pos_embed="rope", activation="swiglu"), ""),
             ("mha-learned", dict(), "int8")]
    for name, kw, kv in cases:
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        base = dict(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256, dtype=torch.float32)
        cfg = gpt.GPTConfig(**{**base, **kw})
        cpu = gpt.init_params(cfg, seed=3, device="cpu")
        card = {n: ({k: t.cuda() for k, t in v.items()} if n == "blocks"
                    else v.cuda()) for n, v in cpu.items()}
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
    fa.flash_attention_fwd.launches = 0
    da.decode_attention.launches = 0
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
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "decode_attention": da.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    served = [srv.result(r) for r in rids]
    n_tok = sum(len(s) for s in served)
    log(f"  served {len(rids)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission prefill {t_admit * 1e3:.1f} ms)")
    log(f"  launches in the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    assert launches["flash_attention_fwd"] == cfg.num_layers * len(prompts)
    assert launches["decode_attention"] == cfg.num_layers * len(ticks)
    assert all(len(s) == new and all(0 <= t < cfg.vocab_size for t in s)
               for s in served)

    solo = G.generate(params, cfg, [prompts[0]], new, device="cuda")
    solo = solo[0, lens[0]:].tolist()
    if solo != served[0]:
        first = next(i for i, (a, b) in enumerate(zip(solo, served[0]))
                     if a != b)
        raise AssertionError(f"served tokens differ from solo generate at "
                             f"{first}: {served[0][:first + 3]} vs "
                             f"{solo[:first + 3]}")
    logits, _ = G.decode_step(params, G.init_cache(cfg, 1, 8, "cuda"),
                              torch.tensor([prompts[0][0]], device="cuda"),
                              0, cfg)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    stats = {
        "model": "gpt_1p3b", "params": n_params, "requests": len(rids),
        "prompt_lens": lens, "new_tokens": new, "tokens": n_tok,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ticks": len(ticks), "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "peak_mem_gb": peak / 1e9,
        "launches": launches, "solo_generate_equal": True,
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
    from paddle_tpu_torch.text import gpt, serving
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
           "decode_attention": check_decode(torch, da)}

    log("[decode path on the card vs the CPU]")
    check_path_vs_cpu(torch, gpt, G, serving)

    log("[kernel timings at the main path's shapes]")
    flash_by_t = {T: time_flash(torch, fa, F, T) for T in (64, 128, 256, 512)}
    for T, row in flash_by_t.items():
        log(f"  flash_attention_fwd {json.dumps(row)}")
    # decode at mid-serve: every slot halfway through its new tokens
    dec = time_decode(torch, da, F, [n + wl.NEW // 2 for n in wl.LENS])
    log(f"  decode_attention {json.dumps(dec)}")

    log("[main path: DecodeServer, gpt_1p3b]")
    stats, launches = main_path(torch, gpt, G, serving, fa, da, wl)
    log(json.dumps({"main_path": stats}))

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err[name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"]}

    kernels = [
        entry("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_fwd.cu",
              "paddle_tpu/ops/flash_attention.py:164", flash_by_t[512]),
        entry("decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
              "paddle_tpu/ops/decode_attention.py:282", dec),
    ]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
