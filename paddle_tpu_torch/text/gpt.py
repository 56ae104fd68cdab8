"""GPT decoder-only transformer — the flagship model family, in PyTorch.

Counterpart of ``paddle_tpu/text/gpt.py`` for the dense, float-weight,
inference-time model.  The parameters keep the JAX tree's names and its
stacked layout: every block weight carries a leading [L, ...] axis
(``blocks["qkv_w"]`` is [L, 3, D, D]), so a JAX checkpoint maps over
name for name (``convert.params_from_jax``).  Where the JAX forward scans
the stack, this one loops over ``l`` and slices it.

Functions take ``params`` as a mapping — a plain dict from
:func:`init_params` / ``convert.params_from_jax``, or a :class:`GPT`
module, which answers ``params["wte"]`` the same way.  Dropout, remat
and MoE are out of this slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import woq
from .. import resolve_device
from ..ops.attention import attention_array


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    # grouped-query attention: num_kv_heads < num_heads shares each K/V
    # head across a group of query heads (None = MHA)
    num_kv_heads: int | None = None
    pos_embed: str = "learned"     # "learned" | "rope"
    norm: str = "layernorm"        # "layernorm" | "rmsnorm" (gain-only)
    activation: str = "gelu"       # "gelu" | "swiglu" (gated FFN)

    def __post_init__(self):
        if (self.num_kv_heads is not None
                and self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"num_kv_heads {self.num_kv_heads} must divide num_heads "
                f"{self.num_heads}")
        if self.pos_embed not in ("learned", "rope"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.pos_embed == "rope" and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads if self.num_kv_heads is not None \
            else self.num_heads

    @property
    def ffn_size(self):
        return self.ffn_ratio * self.hidden_size


def gpt_1p3b():
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_seq_len=2048)


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """Stacked-block parameter tree with the JAX package's names, shapes
    and init scales (normal std 0.02; the two residual projections
    0.02 / sqrt(2L)), drawn in float32 from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` and stored in the compute dtype
    ``cfg.dtype`` (inference only: no float32 master copy).  The numbers
    differ from JAX's for the same seed — carry JAX weights over with
    ``convert.params_from_jax`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D, Fd, L, V, T = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                      cfg.vocab_size, cfg.max_seq_len)
    dtype = cfg.dtype
    s = 0.02

    def nrm(shape, std=s):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=dtype)

    blocks = {
        "ln1_g": const((L, D), 1.0),
        "ln2_g": const((L, D), 1.0),
        "proj_w": nrm((L, D, D), std=s / math.sqrt(2 * L)),
        "proj_b": const((L, D), 0.0),
    }
    if cfg.norm == "layernorm":
        blocks["ln1_b"] = const((L, D), 0.0)
        blocks["ln2_b"] = const((L, D), 0.0)
    if cfg.num_kv_heads is not None:
        Dkv = cfg.kv_heads * cfg.head_dim
        blocks["q_w"] = nrm((L, D, D))
        blocks["q_b"] = const((L, D), 0.0)
        blocks["kv_w"] = nrm((L, 2, D, Dkv))
        blocks["kv_b"] = const((L, 2, Dkv), 0.0)
    else:
        blocks["qkv_w"] = nrm((L, 3, D, D))
        blocks["qkv_b"] = const((L, 3, D), 0.0)
    blocks.update({
        "fc_w": nrm((L, D, Fd)),
        "fc_b": const((L, Fd), 0.0),
        "out_w": nrm((L, Fd, D), std=s / math.sqrt(2 * L)),
        "out_b": const((L, D), 0.0),
    })
    if cfg.activation == "swiglu":
        blocks["gate_w"] = nrm((L, D, Fd))
        blocks["gate_b"] = const((L, Fd), 0.0)
    params = {"wte": nrm((V, D)), "ln_f_g": const((D,), 1.0),
              "blocks": blocks}
    if cfg.pos_embed == "learned":
        params["wpe"] = nrm((T, D))
    if cfg.norm == "layernorm":
        params["ln_f_b"] = const((D,), 0.0)
    return params


class GPT(nn.Module):
    """The parameter tree as an ``nn.Module``: top-level leaves are
    parameters of the same names (``wte``, ``wpe``, ``ln_f_g``, ...) and
    ``blocks`` is a ``ParameterDict`` of the stacked [L, ...] weights.
    ``module["wte"]`` reads like the dict, so every function here takes
    either.  Inference only in this slice: the parameters do not require
    grad."""

    def __init__(self, cfg: GPTConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            if name == "blocks":
                continue
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.blocks = nn.ParameterDict({
            name: nn.Parameter(t, requires_grad=False)
            for name, t in params["blocks"].items()})

    def __getitem__(self, name):
        if name == "blocks" or name in self._parameters:
            return getattr(self, name)
        raise KeyError(name)

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def layer(params, l: int) -> dict:
    """Block ``l``'s weights: every stacked leaf sliced at [l] (views)."""
    return {name: t[l] for name, t in params["blocks"].items()}


def _layer_norm(x, g, b, eps=1e-5):
    """LayerNorm over the last axis (population variance), in x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), g.to(x.dtype), b.to(x.dtype), eps)


def _rms_norm(x, g, eps=1e-5):
    """Gain-only RMS normalization: x * rsqrt(mean(x^2) + eps) * g."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * g.to(x.dtype)


def _norm(x, p, prefix: str, cfg: GPTConfig):
    """Block-norm dispatch: statistics in fp32, output in the compute
    dtype (the JAX package's _norm)."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        return _rms_norm(xf, p[prefix + "_g"]).to(cfg.dtype)
    return _layer_norm(xf, p[prefix + "_g"], p[prefix + "_b"]).to(cfg.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotary position embedding on [..., T, H, hd] (hd even), rotate-half
    convention, angles in fp32.  ``positions`` is [T] (shared by the
    batch) or [B, T] (one row of positions per batch row — the serving
    decode step, where every slot sits at its own position)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * freqs                                              # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                       # [..., T, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gqa_qkv(h, p, cfg: GPTConfig):
    """Grouped-query projections: q [B, T, H, hd], k/v [B, T, Hkv, hd].
    k/v keep their Hkv heads (the cache-row layout); attention reads kv
    head h // (H / Hkv) for query head h, so nothing repeats them."""
    B, T, _ = h.shape
    H, Hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.dtype
    q = (woq.mm(h, p, "q_w", dt) + p["q_b"].to(dt)).reshape(B, T, H, hd)
    kv = woq.mm_stacked(h, p, "kv_w", dt) + p["kv_b"].to(dt)[:, None, None]
    return q, kv[0].reshape(B, T, Hkv, hd), kv[1].reshape(B, T, Hkv, hd)


def _project_qkv(h, p, cfg: GPTConfig):
    """qkv projection for both attention families: q [B,T,H,hd], k/v
    [B,T,Hkv,hd] (Hkv = H without GQA) — the single source the train
    block and every decode-path block project through."""
    if cfg.num_kv_heads is not None:
        return _gqa_qkv(h, p, cfg)
    B, T, _ = h.shape
    dt = cfg.dtype
    H, hd = cfg.num_heads, cfg.head_dim
    qkv = woq.mm_stacked(h, p, "qkv_w", dt) + p["qkv_b"].to(dt)[:, None, None]
    return (qkv[0].reshape(B, T, H, hd), qkv[1].reshape(B, T, H, hd),
            qkv[2].reshape(B, T, H, hd))


def _ffn_body(h, p, cfg: GPTConfig):
    """The FFN matmuls on a normalized input — tanh-gelu MLP (jax.nn.gelu's
    default) or SwiGLU (down(silu(gate) * up))."""
    dt = cfg.dtype
    if cfg.activation == "swiglu":
        gate = F.silu(woq.mm(h, p, "gate_w", dt) + p["gate_b"].to(dt))
        up = woq.mm(h, p, "fc_w", dt) + p["fc_b"].to(dt)
        h = gate * up
    else:
        h = F.gelu(woq.mm(h, p, "fc_w", dt) + p["fc_b"].to(dt),
                   approximate="tanh")
    return woq.mm(h, p, "out_w", dt) + p["out_b"].to(dt)


def _ffn_dense(x, p, cfg: GPTConfig):
    """Residual dense FFN half of a block: x + MLP(norm(x))."""
    return x + _ffn_body(_norm(x, p, "ln2", cfg), p, cfg)


def _block(x, p, cfg: GPTConfig):
    """One transformer block on [B, T, D] activations (compute dtype)."""
    B, T, D = x.shape
    dt = cfg.dtype
    h = _norm(x, p, "ln1", cfg)
    q, k, v = _project_qkv(h, p, cfg)
    if cfg.pos_embed == "rope":
        pos = torch.arange(T, device=x.device)
        q, k = apply_rope(q, pos), apply_rope(k, pos)
    attn = attention_array(q, k, v, is_causal=True).reshape(B, T, D)
    x = x + woq.mm(attn, p, "proj_w", dt) + p["proj_b"].to(dt)
    return _ffn_dense(x, p, cfg)


def forward(params, tokens, cfg: GPTConfig):
    """tokens [B, T] int -> logits [B, T, V] (compute dtype)."""
    B, T = tokens.shape
    dt = cfg.dtype
    x = woq.embed(params, tokens, dt)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][:T].to(dt)[None]
    for l in range(cfg.num_layers):
        x = _block(x, layer(params, l), cfg)
    x = _norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, dt)


def count_params(cfg: GPTConfig) -> int:
    D, Fd, L, V, T = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                      cfg.vocab_size, cfg.max_seq_len)
    Dkv = cfg.kv_heads * cfg.head_dim
    qkv = (D * D + D + 2 * D * Dkv + 2 * Dkv
           if cfg.num_kv_heads is not None else 3 * D * D + 3 * D)
    norms = 4 * D if cfg.norm == "layernorm" else 2 * D
    ffn = D * Fd + Fd + Fd * D + D
    if cfg.activation == "swiglu":
        ffn += D * Fd + Fd
    per_block = norms + qkv + D * D + D + ffn
    final_norm = 2 * D if cfg.norm == "layernorm" else D
    pos = T * D if cfg.pos_embed == "learned" else 0
    return V * D + pos + final_norm + L * per_block
