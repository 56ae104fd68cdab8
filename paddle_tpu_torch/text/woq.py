"""Weight access for the GPT path — float weights only.

Counterpart of ``paddle_tpu/text/woq.py`` minus its int8/int4 and LoRA
branches (those come with the W4 slice).  Every weight use in gpt,
generate and serving resolves through these accessors, so the quantized
forms can later slot in at one place.
"""
from __future__ import annotations


def w(p, name: str, dt):
    """Weight ``name`` in the compute dtype (a no-op cast when the
    parameters are already stored in it)."""
    return p[name].to(dt)


def mm(h, p, name: str, dt):
    """``h @ w(p, name, dt)``."""
    return h @ w(p, name, dt)


def mm_stacked(h, p, name: str, dt):
    """``einsum('...d,kde->k...e', h, w)`` — the stacked qkv/kv
    projection form [k, ...] of a [k, in, out] weight, as one batched
    matmul whose output is contiguous (each [k] slice is a contiguous
    tensor the attention kernels can take as it is)."""
    wt = w(p, name, dt)
    out = h.reshape(1, -1, h.shape[-1]) @ wt
    return out.reshape(wt.shape[0], *h.shape[:-1], wt.shape[-1])


def embed(params, token, dt):
    """wte[token] in the compute dtype."""
    return params["wte"][token].to(dt)


def logits(x, params, dt):
    """Tied-head logits x @ wte.T."""
    return x @ params["wte"].to(dt).T
