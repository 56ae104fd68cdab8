"""Where the PyTorch/CUDA port's train-step time goes on the card.

    python3 -m paddle_tpu_torch.tools.profile_train [--rung NAME]
        [--fused-ln] [--trace PATH]

(from the repository root).

Builds one of the port's train rungs — :func:`build_train_path`, the one
definition of them that ``chip_smoke.py`` drives too.  Each is a rung of
the JAX package's bench (``_gpt_rungs``, bench.py:415-470; built as at
bench.py:700-718), fp32 master weights from seed 0, bf16 compute, batches
of 2048-token sequences in micro-batches of one sequence (``RUNGS``):

* ``gpt_1.3b_acc8_b8`` (the default): GPT-1.3B, batch 8 in 8
  micro-batches, AdamW(lr 2e-4, weight decay 0.01, bf16 moments), with the
  fused loss head (``PADDLE_TPU_FUSED_CE=1``) that bench.py leaves off;
* ``gpt_1.3b_fused_acc8_b8`` (``--fused-ln``, the headline rung): the
  same with the fused LayerNorm kernels too (``PADDLE_TPU_FUSED_LN=1``);
* ``gpt_760m_fused_acc16_b16``: GPT-760M (hidden 1536, 24 layers, 12
  heads of 128), batch 16 in 16 micro-batches, AdamW, fused LN and CE;
* ``gpt_760m_fused_dots_acc16_b16``: the same under remat with the
  "dots" policy — first in the bench's preference (bench.py:2331);
* ``gpt_1.3b_fused_remat_af_acc8_b8``: GPT-1.3B, batch 8 in 8, full
  remat, ``Adafactor(learning_rate=2e-4)``, fused LN and CE;
* ``gpt_1.3b_moe8_l8_fused_acc8_b8``: GPT-1.3B's widths with 8 top-2
  experts a layer (``MOE``: capacity factor 1.25, router noise 0.01, aux
  loss weight 0.01), depth cut to 8 layers (2.39 B parameters: the fp32
  masters, bf16 moments and gradient carry and the update's new trees
  fit one 80 GB card there, not at 12), batch 8 in 8, AdamW, fused LN and
  CE;
* ``gpt_1.3b_moe8_l8_fused_remat_acc8_b8``: the same under full remat.

Every rung's step takes the one key ``KEY`` (``rng.seed_key(0)``): the
MoE rungs draw their router noise under it; a dense rung without dropout
draws nothing.

It warms the step once, then traces one step with ``torch.profiler`` and,
in a window of its own, one optimizer update on bf16 gradients.

It prints one JSON line: the step's host wall, device kernel time and the
device's busy share of the wall, kernel launches, and device time by
kernel family (matmul, flash fwd, dq, dkv, CE fwd, CE bwd, LN fwd, LN bwd,
elementwise) and the ten elementwise kernels with the most device time;
the optimizer update's device time (its elementwise kernels, which the
step's "elementwise" family includes) and the bytes of the optimizer's
state.  ``--trace`` writes the step's Chrome trace.  Needs a CUDA card;
imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .. import rng
from ..optimizer import Adafactor, AdamW
from ..text import gpt, gpt_hybrid
from ..text.moe import MoEConfig
from . import profile_serving

SEQ = 2048
LR, WEIGHT_DECAY = 2e-4, 0.01
FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "0"}
FUSED_FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "1"}
# the bench's model configurations (bench.py:415-428)
C13 = dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
           max_seq_len=2048)
C760 = dict(vocab_size=50304, hidden_size=1536, num_layers=24, num_heads=12,
            max_seq_len=2048)
# the MoE rungs' experts: the geometry and capacity factor of the MoE
# serving model (chip_smoke.MOE_E / MOE_K / MOE_CF), router noise on
MOE = MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                router_noise=0.01, aux_loss_weight=0.01)
# the key every rung's step takes
KEY = rng.seed_key(0)


@dataclasses.dataclass(frozen=True)
class Rung:
    """One train rung: the model config's fields, batch, accumulation,
    optimizer ("adamw": AdamW(LR, WEIGHT_DECAY, bf16 moments);
    "adafactor": Adafactor(LR)) and the kernel flags."""
    cfg: dict
    batch: int
    accum: int
    optimizer: str
    flags: dict

    def describe(self) -> str:
        if self.optimizer == "adafactor":
            return f"Adafactor(lr={LR})"
        return f"AdamW(lr={LR}, weight_decay={WEIGHT_DECAY}, bf16 state)"


RUNGS = {
    "gpt_1.3b_acc8_b8": Rung(dict(C13, remat=False), 8, 8, "adamw", FLAGS),
    "gpt_1.3b_fused_acc8_b8": Rung(dict(C13, remat=False), 8, 8, "adamw",
                                   FUSED_FLAGS),
    "gpt_760m_fused_acc16_b16": Rung(dict(C760, remat=False), 16, 16,
                                     "adamw", FUSED_FLAGS),
    "gpt_760m_fused_dots_acc16_b16": Rung(
        dict(C760, remat=True, remat_policy="dots"), 16, 16, "adamw",
        FUSED_FLAGS),
    "gpt_1.3b_fused_remat_af_acc8_b8": Rung(dict(C13, remat=True), 8, 8,
                                            "adafactor", FUSED_FLAGS),
    "gpt_1.3b_moe8_l8_fused_acc8_b8": Rung(
        dict(C13, num_layers=8, remat=False, moe=MOE), 8, 8, "adamw",
        FUSED_FLAGS),
    "gpt_1.3b_moe8_l8_fused_remat_acc8_b8": Rung(
        dict(C13, num_layers=8, remat=True, moe=MOE), 8, 8, "adamw",
        FUSED_FLAGS),
}
# gpt_1.3b_acc8_b8's batch and accumulation, which older callers read here
BATCH, ACCUM = 8, 8


def build_train_path(device="cuda", seed=0, fused_ln=False, rung=None):
    """A train rung at full width: ``rung`` names one of ``RUNGS`` (None:
    ``gpt_1.3b_fused_acc8_b8`` with ``fused_ln``, else
    ``gpt_1.3b_acc8_b8``).  Sets the rung's flags in the environment,
    where the step reads them at each call, builds
    ``build_gpt_train_step(cfg, optimizer, accum)`` on ``device`` and
    draws the batch, tokens [batch, 2049], from
    ``numpy.default_rng(seed)`` as bench.py draws them.  Returns (cfg,
    optimizer, init_fn, step_fn, tokens); nothing is initialised yet."""
    if rung is None:
        rung = "gpt_1.3b_fused_acc8_b8" if fused_ln else "gpt_1.3b_acc8_b8"
    r = RUNGS[rung]
    os.environ.update(r.flags)
    cfg = gpt.GPTConfig(**r.cfg)
    if r.optimizer == "adafactor":
        opt = Adafactor(learning_rate=LR)
    else:
        opt = AdamW(learning_rate=LR, weight_decay=WEIGHT_DECAY,
                    state_dtype=torch.bfloat16)
    init_fn, step_fn, meta = gpt_hybrid.build_gpt_train_step(
        cfg, opt, accum=r.accum, device=device)
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (r.batch, SEQ + 1)),
                             device=meta["device"])
    return cfg, opt, init_fn, step_fn, tokens


def bf16_zeros(tree):
    """bf16 zeros shaped as every leaf of a (nested) parameter tree: the
    gradients an accumulating step hands the optimizer."""
    if isinstance(tree, dict):
        return {n: bf16_zeros(v) for n, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.bfloat16)


def state_bytes(tree) -> int:
    """Bytes of every tensor in a (params or optimizer-state) tree."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(state_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


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
    ap.add_argument("--rung", default=None, choices=sorted(RUNGS),
                    help="the rung to profile (default gpt_1.3b_acc8_b8)")
    ap.add_argument("--fused-ln", action="store_true",
                    help="the headline rung gpt_1.3b_fused_acc8_b8")
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
    rung = args.rung or ("gpt_1.3b_fused_acc8_b8" if args.fused_ln
                         else "gpt_1.3b_acc8_b8")
    r = RUNGS[rung]
    cfg, opt, init_fn, step_fn, tokens = build_train_path(rung=rung)
    state = init_fn(0)
    state, loss = step_fn(state, tokens, KEY, LR)        # warm-up step
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, KEY, LR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step = profile_serving.summarize(torch, prof, wall, 1, FAMILIES)
    step["top_elementwise"] = top_elementwise(torch, prof)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    grads = bf16_zeros(state.params)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        opt.apply_gradients(grads, state.params, state.opt_state, lr=LR,
                            step=state.step + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    update = profile_serving.summarize(torch, prof, wall, 1, FAMILIES)
    update["state_bytes"] = state_bytes(state.opt_state)
    tok_s = r.batch * SEQ / step["wall_ms"] * 1e3
    print(json.dumps({"train_step": {
        "rung": rung,
        "what": f"one train step, hidden {cfg.hidden_size}, "
                f"{cfg.num_layers} layers, B={r.batch} T={SEQ} "
                f"accum={r.accum}, remat={cfg.remat} "
                f"policy={cfg.remat_policy}, {r.describe()}, flags "
                f"{r.flags}",
        "card": card, "loss": loss.item(), **step,
        "tokens_per_s_profiled": tok_s,
        "optimizer_update": update}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
