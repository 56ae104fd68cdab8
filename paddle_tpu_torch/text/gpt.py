"""GPT decoder-only transformer — the flagship model family, in PyTorch.

Counterpart of ``paddle_tpu/text/gpt.py`` for the dense model: the
forward that serving runs (on float weights, or weight-only int8 / int4
ones — every weight resolves through ``text/woq.py``), and the loss that
training differentiates (``loss_fn``).  The parameters keep the JAX tree's names and its
stacked layout: every block weight carries a leading [L, ...] axis
(``blocks["qkv_w"]`` is [L, 3, D, D]), so a JAX checkpoint maps over
name for name (``convert.params_from_jax``).  Where the JAX forward scans
the stack, this one loops over ``l`` and slices it.

Functions take ``params`` as a mapping — a plain dict from
:func:`init_params` / ``convert.params_from_jax``, or a :class:`GPT`
module, which answers ``params["wte"]`` the same way.  An MoE config
(``GPTConfig.moe``, ``text/moe.py``) replaces each block's FFN by
routed experts: the stacked ``blocks["moe"]`` subtree (``router_w``
[L, D, E], ``w_in`` [L, E, D, F], ``b_in``, ``w_out`` [L, E, F, D],
``b_out``) takes the place of ``fc_*`` / ``out_*``.

Remat (``cfg.remat``) wraps each block in ``torch.utils.checkpoint``
under the config's policy (``ops/remat_policies.py``); dropout draws its
masks from the counter-based ``rng.py``, so a recompute rebuilds them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import moe as _moe
from . import tp_context as _tp_context
from . import woq
from .. import flags, resolve_device, rng
from ..ops import remat_policies
from ..ops.attention import attention_array
from ..ops.fused_ce import fused_softmax_ce
from ..ops.fused_norm import fused_layer_norm


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_ratio: int = 4
    dropout: float = 0.0
    remat: bool = False
    # the checkpoint policy when remat=True (ops/remat_policies.py): None
    # = save nothing (full recompute); "dots" = keep matmul outputs;
    # "dots_no_batch" = keep only non-batch matmuls; "everything" = keep
    # all (no checkpoint).  None defers to PADDLE_TPU_REMAT_POLICY.
    remat_policy: str | None = None
    # carried for the JAX config's sake and read by no math: attention
    # routes by shape there too (paddle_tpu/ops/attention.py), and on the
    # card the port's one attention path is the flash kernels
    use_flash: bool = True
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    # grouped-query attention: num_kv_heads < num_heads shares each K/V
    # head across a group of query heads (None = MHA)
    num_kv_heads: int | None = None
    pos_embed: str = "learned"     # "learned" | "rope"
    norm: str = "layernorm"        # "layernorm" | "rmsnorm" (gain-only)
    activation: str = "gelu"       # "gelu" | "swiglu" (gated FFN)
    # a MoEConfig: every block's FFN becomes routed experts (text/moe.py)
    moe: _moe.MoEConfig | None = None
    # the sp ring's plain route walks each kv chunk in sub-chunks of this
    # many rows, capping the live score block (ops/ring_attention.py);
    # None = whole chunks.  The kernel route never forms the block.
    sp_sub_block: int | None = None

    def __post_init__(self):
        remat_policies.canonical(self.remat_policy)
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
        if self.moe is not None and self.activation != "gelu":
            raise ValueError(
                "MoE experts use the gelu FFN; activation='swiglu' with "
                "moe is not implemented")

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
    ``cfg.dtype`` — the serving form; training keeps float32 masters
    (:func:`init_master_params`).  The numbers differ from JAX's for the
    same seed — carry JAX weights over with ``convert.params_from_jax``
    instead.  An MoE config's expert leaves are drawn a layer at a time
    (``moe.init_moe_params``), its ``router_w`` kept in float32."""
    return _draw_params(cfg, seed, device, cfg.dtype)


def init_master_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """The same draw as :func:`init_params` kept in float32: the master
    weights a train step updates ("params stay fp32", as in the JAX
    package), cast to ``cfg.dtype`` at each use.  Rounding them to
    ``cfg.dtype`` gives :func:`init_params`' tree for the same seed."""
    return _draw_params(cfg, seed, device, torch.float32)


def _draw_params(cfg: GPTConfig, seed, device, dtype) -> dict:
    dev = resolve_device(device)
    # the meta device (param_shapes) draws nothing and takes no generator
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    D, Fd, L, V, T = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                      cfg.vocab_size, cfg.max_seq_len)
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
    if cfg.moe is not None:
        blocks["moe"] = _moe.init_moe_params(cfg.moe, D, Fd, L, gen, dev,
                                             dtype)
    else:
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


def param_shapes(cfg: GPTConfig) -> dict:
    """The parameter tree's shapes (``torch.Size`` leaves), drawn on the
    meta device: no memory, no numbers."""
    return _per_layer(_draw_params(cfg, 0, "meta", torch.float32),
                      lambda t: t.shape)


class GPT(nn.Module):
    """The parameter tree as an ``nn.Module``: top-level leaves are
    parameters of the same names (``wte``, ``wpe``, ``ln_f_g``, ...) and
    ``blocks`` is a ``ParameterDict`` of the stacked [L, ...] weights
    (an MoE model's ``blocks["moe"]`` a nested one).
    ``module["wte"]`` reads like the dict, so every function here takes
    either.  The parameters require grad only with ``trainable=True``
    (then :func:`loss_fn` on the module backpropagates into them); the
    default is the serving form."""

    def __init__(self, cfg: GPTConfig, params: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            if name == "blocks":
                continue
            self.register_parameter(name, nn.Parameter(
                t, requires_grad=trainable))
        def pdict(tree):
            return nn.ParameterDict({
                name: (nn.Parameter(t, requires_grad=trainable)
                       if isinstance(t, torch.Tensor) else pdict(t))
                for name, t in tree.items()})

        self.blocks = pdict(params["blocks"])

    def __getitem__(self, name):
        if name == "blocks" or name in self._parameters:
            return getattr(self, name)
        raise KeyError(name)

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


def _per_layer(tree, pick):
    """``pick`` applied to every stacked leaf of a blocks tree (the MoE
    subtree nested)."""
    return {name: (_per_layer(t, pick)
                   if isinstance(t, (dict, nn.ParameterDict)) else pick(t))
            for name, t in tree.items()}


def layer(params, l: int) -> dict:
    """Block ``l``'s weights: every stacked leaf sliced at [l] (views)."""
    return _per_layer(params["blocks"], lambda t: t[l])


def _layer_norm(x, g, b, eps=1e-5):
    """LayerNorm over the last axis (population variance), in x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), g.to(x.dtype), b.to(x.dtype), eps)


def _rms_norm(x, g, eps=1e-5):
    """Gain-only RMS normalization: x * rsqrt(mean(x^2) + eps) * g."""
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * g.to(x.dtype)


def _norm(x, p, prefix: str, cfg: GPTConfig):
    """Block-norm dispatch: statistics in fp32, output in the compute
    dtype (the JAX package's _norm / _ln) — the single entry every train
    and decode block normalises through.  ``PADDLE_TPU_FUSED_LN=1`` (read
    at each call) takes ``fused_layer_norm`` on x as it is, in the compute
    dtype (the kernels on the card, their plain twins on the CPU);
    otherwise the fp32 ``F.layer_norm`` expression.  RMSNorm never takes
    the fused kernels (other math)."""
    if cfg.norm == "rmsnorm":
        return _rms_norm(x.float(), p[prefix + "_g"]).to(cfg.dtype)
    if flags.fused_ln():
        return fused_layer_norm(x, p[prefix + "_g"],
                                p[prefix + "_b"]).to(cfg.dtype)
    return _layer_norm(x.float(), p[prefix + "_g"],
                       p[prefix + "_b"]).to(cfg.dtype)


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


def _heads(cfg: GPTConfig, tp):
    """(query heads, kv heads) of the weights at hand: the config's, or a
    tensor-parallel rank's local ones (``tp``, or a serving rank's
    ``tp_context``)."""
    if tp is None:
        tp = _tp_context.current()
    if tp is None:
        return cfg.num_heads, cfg.kv_heads
    return tp.heads, tp.kv_heads


def _gqa_qkv(h, p, cfg: GPTConfig, tp=None):
    """Grouped-query projections: q [B, T, H, hd], k/v [B, T, Hkv, hd].
    k/v keep their Hkv heads (the cache-row layout); attention reads kv
    head h // (H / Hkv) for query head h, so nothing repeats them."""
    B, T, _ = h.shape
    (H, Hkv), hd = _heads(cfg, tp), cfg.head_dim
    dt = cfg.dtype
    q = (woq.mm(h, p, "q_w", dt) + p["q_b"].to(dt)).reshape(B, T, H, hd)
    kv = woq.mm_stacked(h, p, "kv_w", dt) + p["kv_b"].to(dt)[:, None, None]
    return q, kv[0].reshape(B, T, Hkv, hd), kv[1].reshape(B, T, Hkv, hd)


def _project_qkv(h, p, cfg: GPTConfig, tp=None):
    """qkv projection for both attention families: q [B,T,H,hd], k/v
    [B,T,Hkv,hd] (Hkv = H without GQA) — the single source the train
    block and every decode-path block project through.  ``tp``: the
    local heads of a tensor-parallel rank's column shards (``_block``)."""
    if cfg.num_kv_heads is not None:
        return _gqa_qkv(h, p, cfg, tp)
    B, T, _ = h.shape
    dt = cfg.dtype
    H, hd = _heads(cfg, tp)[0], cfg.head_dim
    qkv = woq.mm_stacked(h, p, "qkv_w", dt) + p["qkv_b"].to(dt)[:, None, None]
    return (qkv[0].reshape(B, T, H, hd), qkv[1].reshape(B, T, H, hd),
            qkv[2].reshape(B, T, H, hd))


def _ffn_body(h, p, cfg: GPTConfig, tp=None):
    """The FFN matmuls on a normalized input — tanh-gelu MLP (jax.nn.gelu's
    default) or SwiGLU (down(silu(gate) * up)).  Under ``tp`` the weights
    are a rank's column (fc, gate) and row (out) shards, and the down
    product is all-reduced before its bias."""
    dt = cfg.dtype
    if cfg.activation == "swiglu":
        gate = F.silu(woq.mm(h, p, "gate_w", dt) + p["gate_b"].to(dt))
        up = woq.mm(h, p, "fc_w", dt) + p["fc_b"].to(dt)
        h = gate * up
    else:
        h = F.gelu(woq.mm(h, p, "fc_w", dt) + p["fc_b"].to(dt),
                   approximate="tanh")
    y = woq.mm(h, p, "out_w", dt)
    if tp is None:
        tp = _tp_context.current()
    if tp is not None:
        y = tp.exit(y)
    return y + p["out_b"].to(dt)


def _ffn_dense(x, p, cfg: GPTConfig):
    """Residual dense FFN half of a block: x + MLP(norm(x))."""
    return x + _ffn_body(_norm(x, p, "ln2", cfg), p, cfg)


# _ffn_tail's default capacity rule (``None`` is a meaningful override
# there: the capacity-factor bound)
_LEGACY = object()


def _ffn_tail(x, p, cfg: GPTConfig, valid=None, capacity=_LEGACY,
              stats=None):
    """Inference FFN half: dense MLP or MoE (no aux loss), as the
    reference's ``_ffn_tail``.  MoE capacity counts the CALL's tokens:
    left at ``_LEGACY`` it is the dropless bound (the call's token
    count) when ``valid`` masks pads (admission: a padded prompt routes
    as its unpadded prefix), else the capacity-factor bound; an explicit
    value (``None``: the capacity-factor bound) overrides that — the
    joint-routing decode step passes ``valid=act, capacity=None``.
    ``stats``: the MoE routing accumulator, added to in place (dense
    models ignore ``valid``, ``capacity`` and ``stats``)."""
    if cfg.moe is None:
        return _ffn_dense(x, p, cfg)
    if capacity is _LEGACY:
        capacity = x[..., 0].numel() if valid is not None else None
    h = _norm(x, p, "ln2", cfg)
    return x + _moe.moe_tail(p["moe"], h, cfg.moe, valid=valid,
                             capacity=capacity, stats=stats)


def _dropout(x, rate, key):
    """Inverted dropout, as the JAX package's ``_dropout``: each element
    kept with probability ``1 - rate`` and scaled by ``1 / keep``.  The
    mask is a pure function of ``key`` and the element index
    (``rng.bernoulli``), so a remat recompute draws it again exactly."""
    keep = 1.0 - rate
    mask = rng.bernoulli(key, keep, x.shape, x.device)
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _block(x, p, cfg: GPTConfig, dropout_key=None, tp=None, sp=None,
           ep=None):
    """One transformer block on [B, T, D] activations (compute dtype) ->
    (x, aux): aux the block's MoE load-balancing loss, None for a dense
    model.  With ``cfg.dropout > 0`` and a ``dropout_key``, dropout on
    the attention projection's output (key ``fold_in(dropout_key, 0)``)
    and on the FFN's (``fold_in(dropout_key, 1)``), as in the JAX
    block.  An MoE block routes under ``fold_in(dropout_key, 2)`` when
    it has a key (router noise, ``cfg.moe.router_noise``), with or
    without dropout.

    ``tp`` (``distributed.megatron.TensorParallel``): the weights are a
    tensor-parallel rank's shards (``param_shardings``) — its heads'
    qkv and FFN columns, the matching rows of proj and out — and the
    block runs Megatron's pattern: f before the qkv and FFN-in products,
    g (one all-reduce) after proj and out, each before its bias.  Norms,
    biases after g and dropout act on the whole, replicated D.

    ``sp`` (``ops.ring_attention.SequenceParallel``): x holds this rank's
    rows of the sequence and attention is the ring over them.  ``ep``
    (``moe.ExpertParallel``): an MoE block's FFN is
    ``moe.moe_ffn_manual`` on the rank's experts (and FFN columns under
    ``mp``)."""
    B, T, D = x.shape
    dt = cfg.dtype
    drop = cfg.dropout > 0.0 and dropout_key is not None
    h = _norm(x, p, "ln1", cfg)
    if tp is not None:
        h = tp.enter(h)
    q, k, v = _project_qkv(h, p, cfg, tp)
    if cfg.pos_embed == "rope":
        pos = torch.arange(T, device=x.device)
        q, k = apply_rope(q, pos), apply_rope(k, pos)
    if sp is not None:
        attn = sp.attend(q, k, v).reshape(B, T, -1)
    else:
        attn = attention_array(q, k, v, is_causal=True).reshape(B, T, -1)
    a = woq.mm(attn, p, "proj_w", dt)
    if tp is not None:
        a = tp.exit(a)
    if drop:
        x = x + _dropout(a + p["proj_b"].to(dt), cfg.dropout,
                         rng.fold_in(dropout_key, 0))
    else:
        x = x + a + p["proj_b"].to(dt)
    h = _norm(x, p, "ln2", cfg)
    aux = None
    if cfg.moe is not None:
        mkey = (rng.fold_in(dropout_key, 2) if dropout_key is not None
                else None)
        if ep is not None:
            h, aux = ep.ffn(p["moe"], h, cfg.moe, key=mkey)
        else:
            h, aux = _moe.moe_ffn(p["moe"], h, cfg.moe, key=mkey)
    else:
        if tp is not None:
            h = tp.enter(h)
        h = _ffn_body(h, p, cfg, tp)
    if drop:
        h = _dropout(h, cfg.dropout, rng.fold_in(dropout_key, 1))
    return x + h, aux


def _remat_wrap(cfg: GPTConfig):
    """The block as ``forward_with_aux`` calls it: ``_block`` itself, or
    under the checkpoint of ``cfg.remat_policy`` (unset: the
    ``PADDLE_TPU_REMAT_POLICY`` flag, read at each call)."""
    if not cfg.remat:
        return _block
    name = cfg.remat_policy
    if name is None:
        name = flags.remat_policy()
    return remat_policies.resolve(name)(_block)


def forward_with_aux(params, tokens, cfg: GPTConfig, key=None):
    """tokens [B, T] int -> (logits [B, T, V] in the compute dtype, aux
    loss).  aux is the MoE load-balancing term summed over the layers
    (float32; 0 for a dense model).  ``key`` (an int or an int64 tensor,
    ``rng.py``) turns dropout on when ``cfg.dropout > 0`` and router
    noise on an MoE config: layer ``l`` draws under ``rng.fold_in(key,
    l)`` (the JAX package splits its key over the layers); None is eval
    mode.

    The stacked block weights are unbound once into per-layer views, so
    under autograd each [L, ...] leaf gets its gradient by one stack of
    the layers' slices.  Under ``cfg.remat`` only the blocks are
    checkpointed; the embedding, the final norm and the head are not."""
    B, T = tokens.shape
    dt = cfg.dtype
    x = woq.embed(params, tokens, dt)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][:T].to(dt)[None]
    blk = _remat_wrap(cfg)
    need_keys = key is not None and (cfg.dropout > 0.0
                                     or cfg.moe is not None)
    per_layer = _per_layer(params["blocks"], lambda t: t.unbind(0))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_layers):
        x, a = blk(x, _per_layer(per_layer, lambda ts: ts[l]), cfg,
                   rng.fold_in(key, l) if need_keys else None)
        if a is not None:
            aux = aux + a
    x = _norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, dt), aux


def forward(params, tokens, cfg: GPTConfig):
    """tokens [B, T] int -> logits [B, T, V] (compute dtype)."""
    return forward_with_aux(params, tokens, cfg)[0]


def loss_fn(params, tokens, cfg: GPTConfig, key=None):
    """Next-token LM loss of tokens [B, T + 1]: the mean fp32 softmax-CE
    of the logits over tokens[:, :-1] against tokens[:, 1:], plus the aux
    loss.  ``PADDLE_TPU_FUSED_CE=1`` (read at each call) takes the fused
    loss head (``ops/fused_ce.py``: the hand-written kernels on the card,
    their plain twins on the CPU); otherwise the fp32 ``log_softmax``
    expression, as in the JAX package.  ``key``: the dropout and
    router-noise key of :func:`forward_with_aux` (None: neither)."""
    logits, aux = forward_with_aux(params, tokens[:, :-1], cfg, key=key)
    tgt = tokens[:, 1:]
    if flags.fused_ce():
        return torch.mean(fused_softmax_ce(logits, tgt)) + aux
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    return -torch.mean(ll) + aux


def param_shardings(cfg: GPTConfig, dp="dp", mp="mp", pp=None,
                    ep="ep") -> dict:
    """Megatron's layout of the parameter tree, as the JAX package's
    ``param_shardings`` (gpt.py:189-238): one spec a leaf, a tuple with
    an entry a dim (None: whole; an axis name: split over it).  The
    stacked blocks split their leading [L] over ``pp``; qkv / q / kv /
    fc / gate are column-split over ``mp``, proj / out row-split; ``wte``
    splits its vocab over ``mp`` and is held whole along ``pp`` (it is
    tied to the head); an MoE tree's experts split over ``ep`` and their
    FFN dim over ``mp`` (``moe.moe_param_shardings``).  ``dp`` is
    accepted for the reference's signature and places nothing."""
    l = pp
    blocks = {"ln1_g": (l, None), "ln2_g": (l, None),
              "qkv_w": (l, None, None, mp), "qkv_b": (l, None, mp),
              "proj_w": (l, mp, None), "proj_b": (l, None)}
    if cfg.moe is None:
        blocks.update({"fc_w": (l, None, mp), "fc_b": (l, mp),
                       "out_w": (l, mp, None), "out_b": (l, None)})
    else:
        blocks["moe"] = {k: (l, *v) for k, v in
                         _moe.moe_param_shardings(ep=ep, mp=mp).items()}
    if cfg.norm == "layernorm":
        blocks["ln1_b"] = (l, None)
        blocks["ln2_b"] = (l, None)
    if cfg.num_kv_heads is not None:
        del blocks["qkv_w"], blocks["qkv_b"]
        blocks.update({"q_w": (l, None, mp), "q_b": (l, mp),
                       "kv_w": (l, None, None, mp), "kv_b": (l, None, mp)})
    if cfg.activation == "swiglu":
        blocks["gate_w"] = (l, None, mp)
        blocks["gate_b"] = (l, mp)
    out = {"wte": (mp, None), "ln_f_g": (None,), "blocks": blocks}
    if cfg.pos_embed == "learned":
        out["wpe"] = (None, None)
    if cfg.norm == "layernorm":
        out["ln_f_b"] = (None,)
    return out


def _spec_map(fn, tree, specs):
    return {k: (_spec_map(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in tree.items()}


def shard_leaf(t, spec, mesh):
    """This rank's block of the whole tensor ``t`` under ``spec``: along
    each split dim, chunk ``mesh.index(axes)`` of ``mesh.size(axes)``
    (a copy; no communication)."""
    for dim, entry in enumerate(spec or ()):
        n = mesh.size(entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {entry} ({n} ranks)")
        c = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(entry) * c, c)
    return t.clone()


def shard_params(tree, specs, mesh, rank=None):
    """Each leaf of a whole tree (tensors, or numpy arrays as
    ``convert.params_from_jax`` reads them) cut to this rank's block of
    its spec, on the mesh's device.  ``rank`` must be the mesh's own
    (kept for the reference's signature)."""
    if rank is not None and rank != mesh.rank:
        raise ValueError(f"rank {rank} is not the mesh's ({mesh.rank})")
    dev = mesh.device
    return _spec_map(
        lambda t, s: shard_leaf(torch.as_tensor(t).to(dev), s, mesh),
        tree, specs)


def gather_leaf(t, spec, mesh):
    """The whole tensor from every rank's block of it (all-gathers over
    each split dim's axes, minor axis first): collective."""
    from ..distributed import collective

    for dim, entry in enumerate(spec or ()):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in reversed(axes):
            if a is not None and mesh.size(a) > 1:
                t = collective.all_gather(t, mesh, a, dim=dim)
    return t


def gather_params(tree, specs, mesh):
    """The whole tree back from each rank's blocks (:func:`gather_leaf`
    on every leaf, in one order on every rank)."""
    return _spec_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def count_params(cfg: GPTConfig) -> int:
    """The parameter count as the JAX package reckons it: one dense FFN a
    block whatever ``cfg.moe`` says (the reference counts neither the
    experts nor the router; kept for parity — an MoE tree's own size is
    the sum of its leaves)."""
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


def flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Training FLOPs per token, as the JAX package counts them (one
    dense FFN a block on an MoE config too, as there): 6 x the
    matmul weights (qkv, attention projection and FFN per block, plus the
    tied head V·D once) plus the attention term 12·L·D·T (full,
    non-causal accounting — the conservative standard for MFU)."""
    D, Fd, L, V = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, \
        cfg.vocab_size
    Dkv = cfg.kv_heads * cfg.head_dim
    qkv_w = (D * D + 2 * D * Dkv if cfg.num_kv_heads is not None
             else 3 * D * D)
    ffn_w = (3 if cfg.activation == "swiglu" else 2) * D * Fd
    n_matmul = L * (qkv_w + D * D + ffn_w) + V * D
    attn = 12 * L * D * seq_len
    return 6 * n_matmul + attn
