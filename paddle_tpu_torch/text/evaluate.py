"""Perplexity / language-model evaluation.

Counterpart of ``paddle_tpu/text/evaluate.py``: token-level negative
log-likelihood and perplexity over [B, T + 1] token batches, on float,
weight-only int8/int4 (``text/woq.py``) and LoRA-adapted trees alike —
every weight resolves through the accessors the forward uses:

    ppl_f = perplexity(params, cfg, tokens)
    ppl_q = perplexity(woq.quantize_gpt_int8(params), cfg, tokens)

``nll`` scores through the teacher-forced ``gpt.forward_with_aux`` (on the
card: the flash kernel); ``cached_nll`` feeds token t at position t
through ``generate.decode_step`` over a fresh cache, one position at a
time (on the card: the decode kernel's tick body), so it sees what a
lossy cache setting (``PADDLE_TPU_KV_DTYPE=int8``) does to decode.  The
tokens go to the device of the parameters.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import generate, gpt

__all__ = ["nll", "perplexity", "cached_nll", "cached_perplexity"]


def _batches(params, tokens):
    """Each [B, T + 1] batch of ``tokens`` (one array or a list of them)
    as an int64 tensor on the parameters' device; a bad shape raises."""
    dev = params["wte"].device
    for b in tokens if isinstance(tokens, (list, tuple)) else [tokens]:
        b = torch.as_tensor(np.asarray(b), dtype=torch.int64)
        if b.dim() != 2 or b.shape[1] < 2:
            raise ValueError(f"eval batch must be [B, T+1] with T >= 1, "
                             f"got {tuple(b.shape)}")
        yield b.to(dev)


def _token_nll(logits, tgt):
    """Per-token NLL [B, T] of ``tgt`` under ``logits`` [B, T, V] (fp32
    log-softmax)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, tgt[..., None])[..., 0]


@torch.no_grad()
def nll(params, cfg: gpt.GPTConfig, tokens) -> float:
    """Mean per-token negative log-likelihood of [B, T+1] token batches
    (a list/tuple of batches is accumulated): positions predict their
    successors through the teacher-forced forward."""
    total, count = 0.0, 0
    for b in _batches(params, tokens):
        logits, _aux = gpt.forward_with_aux(params, b[:, :-1], cfg)
        tok = _token_nll(logits, b[:, 1:])
        total += float(tok.sum())
        count += tok.numel()
    return total / max(count, 1)


def perplexity(params, cfg: gpt.GPTConfig, tokens) -> float:
    """exp(mean NLL) — the standard LM quality number."""
    return math.exp(nll(params, cfg, tokens))


@torch.no_grad()
def cached_nll(params, cfg: gpt.GPTConfig, tokens) -> float:
    """Mean per-token NLL scored through the KV-cache decode path: token
    t is fed at position t of a fresh cache (``generate.decode_step``)
    and its logits score token t + 1.  With the default cache dtype this
    matches :func:`nll` to numerical tolerance; its purpose is measuring
    what a lossy cache (``PADDLE_TPU_KV_DTYPE=int8``, read at the cache's
    build) costs."""
    total, count = 0.0, 0
    for b in _batches(params, tokens):
        B, T1 = b.shape
        cache = generate.init_cache(cfg, B, T1 - 1, b.device)
        sums = []              # one device sum a position, read once
        for t in range(T1 - 1):
            logits, cache = generate.decode_step(params, cache, b[:, t], t,
                                                 cfg)
            sums.append(_token_nll(logits[:, None], b[:, t + 1:t + 2]).sum())
        total += float(torch.stack(sums).sum())
        count += B * (T1 - 1)
    return total / max(count, 1)


def cached_perplexity(params, cfg: gpt.GPTConfig, tokens) -> float:
    """exp(mean cached_nll) — perplexity through the decode path."""
    return math.exp(cached_nll(params, cfg, tokens))
