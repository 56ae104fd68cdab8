"""Where the PyTorch/CUDA port's train-step time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--fused-ln] [--trace PATH]

(from the repository root).

Builds the port's train path — :func:`build_train_path`, the one
definition of it that ``chip_smoke.py`` drives too: GPT-1.3B
(``gpt_1p3b()``, fp32 master weights from seed 0, bf16 compute), batch 8
of 2048 tokens in 8 micro-batches of one sequence, AdamW(lr 2e-4, weight
decay 0.01, bf16 moments), the fused loss head (``PADDLE_TPU_FUSED_CE=1``)
— as the JAX package's ``gpt_1.3b_acc8_b8`` rung in bench.py runs it with
that flag.  ``--fused-ln`` builds the headline rung
``gpt_1.3b_fused_acc8_b8`` instead (bench.py:425-426, 704-706): the same
step with the fused LayerNorm kernels too (``PADDLE_TPU_FUSED_LN=1``).
It warms the step once, then traces one step with ``torch.profiler`` and,
in a window of its own, one optimizer update.

It prints one JSON line: the step's host wall, device kernel time and the
device's busy share of the wall, kernel launches, and device time by
kernel family (matmul, flash fwd, dq, dkv, CE fwd, CE bwd, LN fwd, LN bwd,
elementwise) and the ten elementwise kernels with the most device time; the optimizer
update's device time (its elementwise kernels, which the
step's "elementwise" family includes).  ``--trace`` writes the step's
Chrome trace.  Needs a CUDA card; imports nothing of JAX or the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..optimizer import AdamW
from ..text import gpt, gpt_hybrid
from . import profile_serving

# The train path: the gpt_1.3b_acc8_b8 rung's batch, accumulation and
# optimizer (bench.py), plus the fused loss head; the headline rung
# gpt_1.3b_fused_acc8_b8 is the same with the fused LayerNorm as well.
BATCH, SEQ, ACCUM = 8, 2048, 8
LR, WEIGHT_DECAY = 2e-4, 0.01
FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "0"}
FUSED_FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "1"}


def build_train_path(device="cuda", seed=0, fused_ln=False):
    """The port's train path at full width: sets ``FLAGS`` (with
    ``fused_ln``, ``FUSED_FLAGS``: the headline rung) in the environment,
    where the step reads them at each call, builds
    ``build_gpt_train_step(gpt_1p3b(), AdamW(...), accum=8)`` on
    ``device`` and draws the batch, tokens [8, 2049] from
    ``numpy.default_rng(seed)`` as bench.py draws them.  Returns (cfg,
    optimizer, init_fn, step_fn, tokens); nothing is initialised yet."""
    os.environ.update(FUSED_FLAGS if fused_ln else FLAGS)
    cfg = gpt.gpt_1p3b()
    opt = AdamW(learning_rate=LR, weight_decay=WEIGHT_DECAY,
                state_dtype=torch.bfloat16)
    init_fn, step_fn, meta = gpt_hybrid.build_gpt_train_step(
        cfg, opt, accum=ACCUM, device=device)
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (BATCH, SEQ + 1)),
                             device=meta["device"])
    return cfg, opt, init_fn, step_fn, tokens


# kernel-name keys, lower case, first match wins
FAMILIES = (("flash_bwd_dq", ("flash_bwd_dq_kernel", "tc::dq_kernel")),
            ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "tc::dkv_kernel")),
            ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
            ("ce_fwd", ("ce_fwd_kernel",)),
            ("ce_bwd", ("ce_bwd_kernel",)),
            ("ln_fwd", ("ln_fwd_kernel",)),
            # the backward's row pass and its dg/db column sum, apart (the
            # names before and after the row pass took groups of rows)
            ("ln_bwd_rows", ("ln_bwd_kernel", "ln_bwd_rows_kernel")),
            ("ln_bwd_cols", ("ln_bwd_sum_kernel", "ln_bwd_cols_kernel")),
            ("matmul", profile_serving.MATMUL_KEYS),
            ("elementwise", ("",)))


def top_elementwise(torch, prof, n=10):
    """The ``n`` kernels of the "elementwise" family with the most device
    time: (name cut to 90 characters, ms, launches)."""
    rows = [(evt.key[:90], evt.self_device_time_total / 1e3, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.self_device_time_total > 0
            and profile_serving.family(evt.key, FAMILIES) == "elementwise"]
    return sorted(rows, key=lambda r: -r[1])[:n]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused-ln", action="store_true",
                    help="the headline rung: fused LayerNorm kernels too")
    ap.add_argument("--trace", default=None,
                    help="write the step's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = profile_serving.card_line()
    print(card, flush=True)
    cfg, opt, init_fn, step_fn, tokens = build_train_path(
        fused_ln=args.fused_ln)
    state = init_fn(0)
    state, loss = step_fn(state, tokens, None, LR)       # warm-up step
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, None, LR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step = profile_serving.summarize(torch, prof, wall, 1, FAMILIES)
    step["top_elementwise"] = top_elementwise(torch, prof)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    grads = {n: ({k: torch.zeros_like(t, dtype=torch.bfloat16)
                  for k, t in v.items()} if n == "blocks"
                 else torch.zeros_like(v, dtype=torch.bfloat16))
             for n, v in state.params.items()}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        opt.apply_gradients(grads, state.params, state.opt_state, lr=LR,
                            step=state.step + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    update = profile_serving.summarize(torch, prof, wall, 1, FAMILIES)
    tok_s = BATCH * SEQ / step["wall_ms"] * 1e3
    print(json.dumps({"train_step": {
        "what": f"one train step, gpt_1p3b, B={BATCH} T={SEQ} "
                f"accum={ACCUM}, AdamW bf16 state, fused CE"
                + (" and LN" if args.fused_ln else ""),
        "card": card, "loss": loss.item(), **step,
        "tokens_per_s_profiled": tok_s,
        "optimizer_update": update}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
