"""A/B of the train step's wall time across checkouts, on one card.

    python3 paddle_tpu_torch/tools/ab_train.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the top directory of a checkout.  Each is run in a process of
its own, in the order given, with that checkout's ``paddle_tpu_torch`` on
the path.  A process builds the ``gpt_1.3b_acc8_b8`` rung, then the
headline ``gpt_1.3b_fused_acc8_b8`` (that checkout's
``profile_train.build_train_path``, which ``chip_smoke.py`` drives too),
and runs 1 + ``STEPS`` steps of each.  Each step is timed on
the host clock and ends when the loss is read and the card synchronised,
as in ``chip_smoke.train_path``.  No profiler runs.  Prints the card line,
then one JSON line per rung and run: the step ms, their median over the
steps after the first, MFU at that median (H100 SXM dense bf16 peak), the
losses and the peak memory.  Needs a CUDA card; imports nothing of JAX or
the JAX package.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve()
BF16_FLOPS_PER_S = 989e12        # as chip_smoke.py
STEPS = 6                        # timed, after one warm-up step


def _child(root: str) -> None:
    import torch

    sys.path.insert(0, root)    # the checkout under test's paddle_tpu_torch
    from paddle_tpu_torch.text import gpt
    from paddle_tpu_torch.tools import profile_train as tr

    assert Path(tr.__file__).resolve().is_relative_to(Path(root).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    for fused_ln in (False, True):
        cfg, _, init_fn, step_fn, tokens = tr.build_train_path(
            "cuda", seed=0, fused_ln=fused_ln)
        state = init_fn(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for _ in range(1 + STEPS):
            t0 = time.perf_counter()
            state, loss = step_fn(state, tokens, None, tr.LR)
            losses.append(loss.item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        n_tok = tr.BATCH * tr.SEQ
        steady = statistics.median(step_s[1:])
        print(json.dumps({
            "root": root,
            "rung": "gpt_1.3b_fused_acc8_b8" if fused_ln
            else "gpt_1.3b_acc8_b8 + fused CE",
            "step_ms": [1e3 * t for t in step_s],
            "steady_step_ms": 1e3 * steady,
            "mfu": gpt.flops_per_token(cfg, tr.SEQ) * n_tok / steady
            / BF16_FLOPS_PER_S,
            "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}),
            flush=True)
        del state, step_fn, init_fn
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--child":
        _child(args[1])
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_HERE.parents[2]))
    from paddle_tpu_torch.tools import profile_serving as wl
    print(wl.card_line(), flush=True)
    for root in args:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        subprocess.run([sys.executable, str(_HERE), "--child",
                        os.path.abspath(root)],
                       env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
