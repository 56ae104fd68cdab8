"""Where the PyTorch/CUDA port's serving time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving [--paged | --w4] [--ticks 8]
        [--trace PATH]

(from the repository root).

Builds one of the port's serving paths — the one definition of each that
``chip_smoke.py`` drives too — and, for each dispatch arm (:data:`ARMS`:
eager ticks, graphed ticks, graphed ``tick_block(8)``, graphed async
ticks; one server each on the same weights), warms it up and traces a
steady decode window with ``torch.profiler``; then one admission, eager
and graphed (:func:`profile_admission`):

* default, :func:`build_main_path`: GPT-1.3B (``gpt_1p3b()``, random bf16
  weights from seed 0) in ``DecodeServer(max_batch=8, max_len=512)``
  (contiguous KV) with 8 requests of 40..300 prompt tokens; traced: the
  steady decode window and one admission prefill of a 300-token prompt
  (bucket 512);
* ``--paged``, :func:`build_paged_path`: the same model behind
  ``DecodeServer(layout="paged", block_size=16, num_blocks=128)`` with 8
  chat requests sharing a 200-token system prompt; traced: the steady
  paged decode window and one paged admission (a new request sharing the
  system prompt: adopt, then one chunk over its 100-token tail);
* ``--w4``, :func:`build_w4_path`: the main path's model and traffic with
  its weights quantized to int4 (``woq.quantize_gpt_int4``, group 64)
  and ``PADDLE_TPU_W4_KERNEL=1``; traced: the steady decode window and one
  admission prefill of a 200-token prompt (bucket 256, where the W4
  kernel runs at N = 256).

For each arm, and for each admission arm, it prints one JSON line: host
wall per decode step (or per admission), device kernel time and the
device's busy share of the wall, kernel launches, and device time by
kernel family (the hand-written attention kernels, matmuls, everything
else); each also the wall of the same work again without the profiler
(``unprofiled_wall_ms``) and the device time's share of it.
``--trace`` also writes the graph arm's decode window's Chrome trace.
Needs a CUDA card; imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..text import gpt, serving, woq

# The main path's traffic: 8 greedy requests whose prompts fall in every
# prefill bucket (64, 128, 256, 512), NEW new tokens each.
LENS = [40, 100, 200, 300, 60, 120, 250, 290]
NEW = 64


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main_prompts(vocab_size: int, seed: int = 0) -> list:
    """The main path's 8 prompts, of lengths ``LENS``, drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, n).tolist() for n in LENS]


def make_server(path: str, params, cfg, device="cuda", **kw):
    """A server of ``path`` ("main", "w4" or "paged") at its geometry on
    ``params``; ``kw`` adds server options (``async_dispatch``, or the
    private ``_graphs=False`` that runs the steps eagerly) or overrides
    the geometry's (``num_blocks``)."""
    geometry = PAGED_GEOMETRY if path == "paged" else dict(max_batch=8,
                                                           max_len=512)
    return serving.DecodeServer(params, cfg, device=device,
                                **{**geometry, **kw})


def build_main_path(device="cuda", seed=0, **server_kw):
    """The port's main path, at full width: GPT-1.3B with random weights
    from ``seed`` (bf16, as the preset computes) behind
    ``DecodeServer(max_batch=8, max_len=512)``, and the prompts of
    :func:`main_prompts`.  Returns (cfg, params, server, prompts); nothing
    is submitted yet."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=seed, device=device)
    srv = make_server("main", params, cfg, device, **server_kw)
    return cfg, params, srv, main_prompts(cfg.vocab_size, seed)


# The W4 path: the main path's model, weight-only int4 at group size 64
# (the JAX package's default), served through the W4 kernel.
W4_GROUP = 64
W4_FLAGS = {"PADDLE_TPU_W4_KERNEL": "1"}


def build_w4_path(device="cuda", seed=0, **server_kw):
    """The W4 path, at full width: sets ``W4_FLAGS`` in the environment
    (read at each matmul), quantizes the main path's GPT-1.3B (bf16 weights
    from ``seed``) with ``woq.quantize_gpt_int4(params, group_size=64)`` —
    packed int4 block weights, int8 embedding — behind
    ``DecodeServer(max_batch=8, max_len=512)`` with contiguous bf16 KV, and
    the prompts of :func:`main_prompts`.  Returns (cfg, params, server,
    prompts); nothing is submitted yet."""
    os.environ.update(W4_FLAGS)
    cfg = gpt.gpt_1p3b()
    params = woq.quantize_gpt_int4(
        gpt.init_params(cfg, seed=seed, device=device), group_size=W4_GROUP)
    srv = make_server("w4", params, cfg, device, **server_kw)
    return cfg, params, srv, main_prompts(cfg.vocab_size, seed)


# The paged path's traffic: a chat deployment whose requests share one
# system prompt.  Every prompt is the PREFIX-token system prompt plus its
# own tail; request 2 repeats request 1's prompt exactly (so its listed
# tail length is not used).  The prefix ends inside block 12 (rows
# 192-207 at block size 16), so each later request diverges from the
# indexed chain mid-block: a radix split, then a copy-on-write of the
# split block at the adopter's first write.
PREFIX = 200
TAILS = [40, 100, 10, 90, 60, 20, 80, 40]
PAGED_GEOMETRY = dict(max_batch=8, max_len=512, layout="paged",
                      block_size=16, num_blocks=128)


def paged_prompts(vocab_size: int, seed: int = 0) -> list:
    """The paged path's 8 prompts, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, PREFIX).tolist()
    prompts = [prefix + rng.integers(0, vocab_size, n).tolist()
               for n in TAILS]
    prompts[2] = list(prompts[1])
    return prompts


# The pressure phase's traffic (``chip_smoke.py``): six waves of 8 chat
# requests on the paged path's geometry, each wave sharing one
# PREFIX-token system prompt — A, B, C, D, E, then A again, with fresh
# tails of 40..100 tokens — served one wave after another.  After a wave
# the prefix index holds about 50 of the pool's 128 blocks, so every later
# wave needs relief, which the evict rung takes from the coldest leaves:
# A's tails first, A's 12-block system chain (the coldest entry, but not
# a leaf until its tails are gone) only during waves D and E.  So the
# returning wave finds A's system prompt spilled to host memory (spill
# tier on) or gone (evict only); with A, B, C, A alone it would still
# find A's chain in the index.
PRESSURE_SYSTEMS = ("A", "B", "C", "D", "E", "A")
PRESSURE_TAIL = (40, 100)
# the spill tier's budget: room for every chain the waves spill (a
# GPT-1.3B block is 3 MiB in bf16)
PRESSURE_SPILL_MB = 2048


def pressure_waves(vocab_size: int, seed: int = 0) -> list:
    """The pressure phase's six waves of 8 prompts, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    systems = {s: rng.integers(0, vocab_size, PREFIX).tolist()
               for s in sorted(set(PRESSURE_SYSTEMS))}
    lo, hi = PRESSURE_TAIL
    return [[systems[s] + rng.integers(
        0, vocab_size, int(rng.integers(lo, hi + 1))).tolist()
        for _ in range(8)] for s in PRESSURE_SYSTEMS]


def serve_waves(srv, waves, new: int, around=None, sync=None) -> list:
    """Serve each wave of ``waves`` to its end before the next (submit its
    prompts, tick until drained).  ``around(i)``, when given, returns a
    context manager entered around wave i's submits (which run its
    admissions); ``sync`` (``torch.cuda.synchronize`` on a card) ends each
    timed region.  Returns one dict a wave: its streams, ticks, wall and
    admission seconds, and the deltas of the server's prefill rows and
    of its allocator's prefix hits, restored and spilled blocks."""
    import contextlib

    sync = sync or (lambda: None)
    out = []
    for i, wave in enumerate(waves):
        ls0 = srv.load_stats()
        sync()
        t0 = time.perf_counter()
        with (around(i) if around else contextlib.nullcontext()):
            rids = [srv.submit(p, max_new_tokens=new) for p in wave]
            sync()
        t_admit = time.perf_counter() - t0
        ticks = 0
        while srv.pending():
            srv.tick()
            ticks += 1
        sync()
        wall = time.perf_counter() - t0
        ls1 = srv.load_stats()
        p0, p1 = ls0["kv_pool"], ls1["kv_pool"]
        out.append({
            "streams": [srv.result(r) for r in rids], "ticks": ticks,
            "wall_s": wall, "admission_s": t_admit,
            "prompt_rows": sum(map(len, wave)),
            "prefill_rows": ls1["prefill_rows"] - ls0["prefill_rows"],
            "prefix_hits": p1["prefix_hits"] - p0["prefix_hits"],
            "restored_blocks": p1["restored_blocks"]
            - p0["restored_blocks"],
            "spilled_blocks": p1["spilled_blocks"] - p0["spilled_blocks"],
            "prefix_entries": p1["prefix_entries"]})
    return out


def build_paged_path(device="cuda", seed=0, **server_kw):
    """The paged path, at full width: GPT-1.3B with random weights from
    ``seed`` (bf16) behind ``DecodeServer(max_batch=8, max_len=512,
    layout="paged", block_size=16, num_blocks=128)`` — a 403 MB pool (plus
    one sink block) where the contiguous slab takes 805 MB — and the
    prompts of :func:`paged_prompts`.  Returns (cfg, params, server,
    prompts); nothing is submitted yet."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=seed, device=device)
    srv = make_server("paged", params, cfg, device, **server_kw)
    return cfg, params, srv, paged_prompts(cfg.vocab_size, seed)


# kernel-name keys, lower case; the decode kernels (split_kv.cuh's,
# decode_tick_kernel, decode_chunk_tc_kernel) carry their row addressing
# (ContiguousRows / PagedRows) in their template arguments, so a PagedRows
# kernel is the paged family's whatever its body; the other tensor-core
# bodies are flash_fwd_tc_kernel and w4_tc_kernel
MATMUL_KEYS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk", "nvjet")
FAMILIES = (("w4_matmul", ("w4_kernel", "w4_tc_kernel",
                           "w4_sum_kernel")),
            ("fused_layer_norm", ("ln_fwd_kernel",)),
            ("paged_decode_attention", ("pagedrows",)),
            ("decode_attention", ("decode_tick_kernel", "contiguousrows",
                                  "decode_chunk_tc_kernel")),
            ("flash_attention_fwd", ("flash_fwd_kernel",
                                     "flash_fwd_tc_kernel")),
            ("matmul", MATMUL_KEYS),
            ("layer_norm", ("layer_norm",)),
            ("cache_write", ("index_put", "scatter")),
            # the contiguous admission chunk's copy of its slot's rows
            ("cache_gather", ("indexselect",)))


def family(name: str, families=FAMILIES) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k in low for k in keys):
            return fam
    return "other"


def summarize(torch, prof, wall, n, families=FAMILIES):
    """Device time per unit of work, by family, from the trace's kernel
    events (one stream: kernels do not overlap, so their sum is the
    device's busy time)."""
    by_fam: dict[str, float] = {}
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us <= 0:
            continue
        launches += evt.count
        fam = family(evt.key, families)
        by_fam[fam] = by_fam.get(fam, 0.0) + us / 1e3
    dev_ms = sum(by_fam.values())
    return {
        "wall_ms": wall * 1e3 / n,
        "device_ms": dev_ms / n if dev_ms else None,
        "device_busy_share": (dev_ms / 1e3) / wall if dev_ms else None,
        "launches": launches / n,
        "device_ms_by_family": {k: v / n for k, v in
                                sorted(by_fam.items(), key=lambda kv: -kv[1])},
    }


# the dispatch arms profiled side by side: eager ticks (the private
# ``_graphs=False``), graphed ticks, graphed tick_block(8), graphed async
# ticks
ARMS = ("eager", "graph", "block8", "async")


def arm_server(path: str, params, cfg, arm: str, device="cuda"):
    """A server of ``path`` for one arm of :data:`ARMS`."""
    return make_server(path, params, cfg, device, _graphs=arm != "eager",
                       async_dispatch=arm == "async")


def _decode_window(torch, srv, prompts, arm, calls, acts):
    """Warm ``srv`` up, serve a short round, submit ``prompts`` again with
    NEW tokens each, run a few dispatch calls, then ``calls`` more under
    the profiler and ``calls`` more without it (every slot decoding
    throughout): (profiler, profiled wall seconds, unprofiled wall
    seconds, decode steps in each window)."""
    from torch.profiler import profile

    k = 8 if arm == "block8" else 1
    step = (lambda: srv.tick_block(k)) if k > 1 else srv.tick
    srv.warmup(prompt_lens=[len(p) for p in prompts],
               blocks=(k,) if k > 1 else ())
    for p in prompts:                       # warm-up serve
        srv.submit(p, max_new_tokens=4)
    while srv.pending():
        step()
    for p in prompts:
        srv.submit(p, max_new_tokens=NEW)
    for _ in range(4 if k == 1 else 1):
        step()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    while srv.pending():
        step()
    return prof, wall, plain, calls * k


def admission_prompts(path: str, prompts: list, vocab_size: int) -> tuple:
    """(two prompts of the same admission work, what) for ``path``'s
    profiled admission: the second is traced, the first timed without the
    profiler.  Paged: the system prompt and a 100-token tail no indexed
    chain holds (adopt 200 rows, then one 128-wide chunk), two such tails;
    else one prompt of the path, twice."""
    if path == "paged":
        rng = np.random.default_rng(1)
        return ([prompts[0][:PREFIX]
                 + rng.integers(0, vocab_size, 100).tolist()
                 for _ in range(2)],
                "paged admission, 300 tokens, 200 adopted, one chunk over "
                "the tail")
    if path == "w4":
        return ([prompts[2]] * 2, "admission prefill, 200 tokens at bucket "
                "256 (the W4 kernel at N = 256)")
    return [prompts[3]] * 2, "admission prefill, 300 tokens at bucket 512"


def profile_admission(torch, path: str, params, cfg, prompts, arm: str,
                      acts):
    """One admission of ``path`` on a server of ``arm`` ("eager" or
    "graph"): warm the server up at the admission's widths, serve
    ``prompts`` once (4 tokens each, filling a paged prefix index), time
    one admission without the profiler, then trace another of the same
    work (:func:`admission_prompts`).  Returns the trace's summary (per
    admission) with ``unprofiled_wall_ms`` and ``what``."""
    from torch.profiler import profile

    (plain, traced), what = admission_prompts(path, prompts,
                                              cfg.vocab_size)
    srv = arm_server(path, params, cfg, arm)
    srv.warmup(prompt_lens=[len(p) for p in prompts] + [len(traced)])
    for p in prompts:
        srv.submit(p, max_new_tokens=4)
    while srv.pending():
        srv.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.submit(plain, max_new_tokens=1)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        srv.submit(traced, max_new_tokens=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    srv.close()
    out = {"what": what, "arm": arm, **summarize(torch, prof, wall, 1),
           "unprofiled_wall_ms": unprofiled * 1e3}
    if out["device_ms"]:
        out["unprofiled_busy_share"] = out["device_ms"] / (unprofiled * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--paged", action="store_true",
                      help="profile the paged path (build_paged_path)")
    kind.add_argument("--w4", action="store_true",
                      help="profile the int4 W4 path (build_w4_path)")
    ap.add_argument("--ticks", type=int, default=8,
                    help="tick calls profiled per arm (tick_block(8) "
                    "arm: 3 calls per 8 ticks)")
    ap.add_argument("--trace", default=None,
                    help="write the graph arm's decode window's Chrome "
                    "trace here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    path = "paged" if args.paged else "w4" if args.w4 else "main"
    build = (build_paged_path if args.paged else
             build_w4_path if args.w4 else build_main_path)
    cfg, params, srv, prompts = build()
    srv.close()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    layout = "paged" if args.paged else "contiguous"
    weights = "int4 weights, W4 kernel" if args.w4 else "bf16 weights"
    for arm in ARMS:
        srv = arm_server(path, params, cfg, arm)
        # tick_block(8) arm: 1 + 2 * 3 calls stay inside NEW tokens
        calls = max(1, (args.ticks * 3) // 8) if arm == "block8" \
            else args.ticks
        prof, wall, plain, steps = _decode_window(torch, srv, prompts, arm,
                                                  calls, acts)
        srv.close()
        out = {"arm": arm,
               "what": f"decode, 8 slots decoding, {layout} KV, {weights}; "
                       f"per decode step",
               "card": card, "calls": calls, "steps": steps,
               "wall_ms_per_call": wall * 1e3 / calls,
               **summarize(torch, prof, wall, steps)}
        # the same window's length without the profiler, whose tracing
        # stretches the host's side; busy share against it
        out["unprofiled_wall_ms"] = plain * 1e3 / steps
        if out["device_ms"]:
            out["unprofiled_busy_share"] = out["device_ms"] / (
                plain * 1e3 / steps)
        print(json.dumps({"decode_tick": out}), flush=True)
        if args.trace and arm == "graph":
            prof.export_chrome_trace(args.trace)
    for arm in ("eager", "graph"):
        out = profile_admission(torch, path, params, cfg, prompts, arm,
                                acts)
        print(json.dumps({"prefill": {**out, "card": card}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
