"""Where the PyTorch/CUDA port's serving time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_serving [--ticks 8] [--trace PATH]

(from the repository root).

Builds the port's main path (:func:`build_main_path`, the one definition
that ``chip_smoke.py`` drives too) — GPT-1.3B (``gpt_1p3b()``, random
bf16 weights from seed 0) in ``paddle_tpu_torch``'s
``DecodeServer(max_batch=8, max_len=512)`` with 8 requests of 40..300
prompt tokens — warms it, then traces with ``torch.profiler``:

* ``--ticks`` steady decode ticks (all 8 slots decoding), and
* one admission prefill of a 300-token prompt (bucket 512).

For each it prints one JSON line: host wall per tick (or per prefill),
device kernel time and the device's busy share of the wall, kernel
launches, and device time by kernel family (the two hand-written
attention kernels, matmuls, everything else).  ``--trace`` also writes
the decode window's Chrome trace.  Needs a CUDA card; imports nothing of
JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from ..text import gpt, serving

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


def build_main_path(device="cuda", seed=0):
    """The port's main path, at full width: GPT-1.3B with random weights
    from ``seed`` (bf16, as the preset computes) behind
    ``DecodeServer(max_batch=8, max_len=512)``, and the prompts of
    lengths ``LENS`` drawn from ``seed``.  Returns (cfg, params, server,
    prompts); nothing is submitted yet."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=seed, device=device)
    srv = serving.DecodeServer(params, cfg, max_batch=8, max_len=512,
                               device=device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    return cfg, params, srv, prompts

FAMILIES = (("decode_attention", ("decode_partial", "decode_combine")),
            ("flash_attention_fwd", ("flash_fwd_kernel",)),
            ("matmul", ("gemm", "gemv", "cutlass", "xmma", "cublas",
                        "splitk", "nvjet")),
            ("layer_norm", ("layer_norm",)),
            ("cache_write", ("index_put", "scatter")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def summarize(torch, prof, wall, n):
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
        fam = family(evt.key)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="write the decode window's Chrome trace here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    _, _, srv, prompts = build_main_path()
    for p in prompts:                       # warm-up serve (first launches)
        srv.submit(p, max_new_tokens=4)
    while srv.pending():
        srv.tick()
    for p in prompts:
        srv.submit(p, max_new_tokens=NEW)
    for _ in range(4):
        srv.tick()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            srv.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"what": "decode tick, 8 slots decoding", "card": card,
           **summarize(torch, prof, wall, args.ticks)}
    print(json.dumps({"decode_tick": out}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    while srv.pending():
        srv.tick()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        srv.submit(prompts[3], max_new_tokens=1)     # 300 tokens, bucket 512
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"what": "admission prefill, 300 tokens at bucket 512",
           "card": card, **summarize(torch, prof, wall, 1)}
    print(json.dumps({"prefill": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
