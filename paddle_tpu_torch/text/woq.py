"""Weight-only int8 / int4 quantization for GPT decode (W8A16, W4A16), and
the weight accessors every GPT path resolves its weights through.

Counterpart of ``paddle_tpu/text/woq.py``.  ``quantize_gpt_int8`` stores
the block matmul weights and the tied embedding as int8 with
per-output-channel fp32 scales (``<name>_s``); ``quantize_gpt_int4``
stores the block weights as nibble-packed int4 — two signed 4-bit values
per int8 byte, half-split along the input dim — with group-wise scales
along the input dim, and the embedding as int8.  Both compute in fp32 in
the JAX package's operation order (``w / scale * 127``, round half to
even, clip; the stored scale is ``scale / 127`` or ``/ 7``), so on the
same fp32 weights they give the JAX package's int8 values and scales bit
for bit.  LayerNorm parameters, biases and wpe stay float.

``w`` dequantizes in the activation dtype (``q.to(dt) * s.to(dt)``) and is
the identity cast on float weights, so one decode code serves float, int8
and int4 trees.  Under ``PADDLE_TPU_W4_KERNEL=1`` a packed int4 weight's
matmul in ``mm`` / ``mm_stacked`` runs the W4 kernel
(``ops/woq_matmul.py``) on the packed bytes instead.  An MoE tree's
expert stacks (``blocks["moe"]`` ``w_in`` [L, E, D, F], ``w_out``
[L, E, F, D]) quantize the same way, per output channel or in groups
along the input dim, and the experts' batched matmuls read them through
``w`` (the W4 kernel takes 2-D weights only); the router stays float (a
routing flip is a far larger error than its bytes are worth).

LoRA (``text/lora.py``): an adapter pair ``<name>_lora_a`` [..., in, r] /
``<name>_lora_b`` [..., r, out] beside a weight makes ``w`` add the delta
``a @ b`` after dequantization, as the JAX accessor does — LoRA over a
float base, QLoRA over an int8/int4 one; such a weight never takes the
W4 kernel.  A served adapter pool (``text/adapters.py``) instead puts
each slot's pair beside the weight as ``<name>_lora_sa`` / ``_lora_sb``
(one row a slot, gathered from the pool's stacks by the ``lora_ids``
leaf): ``mm`` / ``mm_stacked`` then add the per-slot rank-r term
``(h @ A[ids]) @ B[ids]`` to the base product, which keeps its route.
"""
from __future__ import annotations

import torch

from .. import flags
from . import tp_context as _tp
from ..ops.woq_matmul import unpack_int4, w4_matmul

# block-level matmul weights and the OUTPUT-channel axis to scale over
# (axis indices are for the PER-LAYER slice, i.e. without the leading L)
_BLOCK_WEIGHTS = {
    "qkv_w": 2,   # [3, D, D]   -> out axis 2
    "q_w": 1,     # [D, D]
    "kv_w": 2,    # [2, D, Dkv]
    "proj_w": 1,  # [D, D]
    "fc_w": 1,    # [D, F]
    "gate_w": 1,  # [D, F]  (swiglu third matmul)
    "out_w": 1,   # [F, D]
}
# the MoE expert stacks, per layer [E, in, out] -> out axis 2
_MOE_WEIGHTS = {"w_in": 2, "w_out": 2}


def _quantize_blocks(params, quant) -> dict:
    """The blocks tree with every block matmul weight and, on an MoE
    tree, every expert stack replaced by ``quant(w, axis)``'s
    (values, scales) under ``<name>`` / ``<name>_s``."""
    blocks = dict(params["blocks"])
    for name, axis in _BLOCK_WEIGHTS.items():
        if blocks.get(name) is not None:
            blocks[name], blocks[name + "_s"] = quant(blocks[name], axis)
    if blocks.get("moe") is not None:
        experts = dict(blocks["moe"])
        for name, axis in _MOE_WEIGHTS.items():
            experts[name], experts[name + "_s"] = quant(experts[name], axis)
        blocks["moe"] = experts
    return blocks


def _quant(w, axis: int):
    """Symmetric per-channel int8 of a STACKED weight [L, ..., in, out];
    ``axis`` is the output axis of the per-layer slice, so the input axis
    of the stacked weight is ``axis`` too and only it is reduced."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=axis, keepdim=True), 1e-8)
    q = torch.clamp(torch.round(w / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale / 127.0


def _quantize_wte_int8(out: dict, params) -> None:
    """wte [V, D]: PER-ROW int8 scales [V, 1] serve both the embedding
    lookup and the tied logits (scaled per output vocab column)."""
    q, s = _quant(params["wte"], 1)
    out["wte"], out["wte_s"] = q, s


def quantize_gpt_int8(params: dict) -> dict:
    """A decode-ready copy of ``params``: block matmul weights (an MoE
    tree's expert stacks too) and the tied embedding become int8 with
    per-output-channel scales ``<name>_s``, on the tree's device."""
    out = dict(params)
    out["blocks"] = _quantize_blocks(params, _quant)
    _quantize_wte_int8(out, params)
    return out


def pack_int4_halves(q):
    """THE int4 byte layout: signed values in [-7, 7] with the input dim at
    axis -2 pack two per byte HALF-SPLIT — rows [0, in/2) in the low
    nibble, rows [in/2, in) in the high — as 4-bit two's complement
    assembled in uint8, reinterpreted int8."""
    q = q.to(torch.int32)
    P = q.shape[-2] // 2
    lo, hi = q[..., :P, :], q[..., P:, :]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def quantize_gpt_int4(params: dict, group_size: int = 64) -> dict:
    """4-bit weight-only decode params: block matmul weights become
    nibble-packed int4 ([..., in, out] -> [..., in/2, out] int8) with
    group-wise scales [..., in/group_size, 1, out] along the input dim; a
    weight whose input dim does not divide into even groups takes
    per-channel int8 instead.  The embedding stays int8 (per row); an
    MoE tree's expert stacks take the same rule."""
    def q4(w_, axis):
        w_ = w_.float()
        in_dim = w_.shape[axis]
        if in_dim % group_size or in_dim % 2:
            return _quant(w_, axis)
        G = in_dim // group_size
        shp = w_.shape
        grouped = w_.reshape(*shp[:axis], G, group_size, *shp[axis + 1:])
        scale = torch.clamp_min(
            grouped.abs().amax(dim=axis + 1, keepdim=True), 1e-8)
        q = torch.clamp(torch.round(grouped / scale * 7.0), -7, 7)
        return pack_int4_halves(q.reshape(shp)), scale / 7.0

    out = dict(params)
    out["blocks"] = _quantize_blocks(params, q4)
    _quantize_wte_int8(out, params)
    return out


def _packed(arr, s) -> bool:
    """Grouped scales (one more axis than the weight) mark packed int4."""
    return arr.dtype == torch.int8 and s is not None \
        and s.dim() == arr.dim() + 1


def logical_shape(p, name: str) -> tuple:
    """Weight ``name``'s [..., in, out] shape: a packed int4 weight's
    input dim unpacked (two rows a byte)."""
    arr = p[name]
    shp = tuple(arr.shape)
    if _packed(arr, p.get(name + "_s")):
        shp = shp[:-2] + (2 * shp[-2], shp[-1])
    return shp


def w(p, name: str, dt):
    """Weight ``name`` in the compute dtype: a cast of a float weight; an
    int8 weight times its scale; a packed int4 weight unpacked to
    [..., in, out] in original row order and times its group scale — each
    dequantized in ``dt`` — plus, beside a LoRA pair ``<name>_lora_a`` /
    ``<name>_lora_b``, the delta ``a @ b`` in ``dt``."""
    arr = p[name]
    if arr.dtype != torch.int8:
        out = arr.to(dt)
    else:
        s = p[name + "_s"]
        if not _packed(arr, s):
            out = arr.to(dt) * s.to(dt)
        else:
            q = unpack_int4(arr)
            shp = q.shape
            G = s.shape[-3]
            grouped = q.reshape(*shp[:-2], G, shp[-2] // G, shp[-1])
            out = (grouped.to(dt) * s.to(dt)).reshape(shp)
    a = p.get(name + "_lora_a")
    if a is not None:
        # the low-rank delta after dequantization, in dt (LoRA / QLoRA)
        out = out + a.to(dt) @ p[name + "_lora_b"].to(dt)
    return out


def _slot_delta(h, p, name: str, dt):
    """The served adapters' per-slot rank-r term of ``h @ w`` for a 2-D
    weight, or None: h [B, ..., in] (row b is slot b), the slot pairs
    gathered as A [B, in, r], B [B, r, out] -> [B, ..., out]."""
    sa = p.get(name + "_lora_sa")
    if sa is None:
        return None
    ids = p["lora_ids"]
    a = sa.index_select(0, ids).to(dt)
    b = p[name + "_lora_sb"].index_select(0, ids).to(dt)
    hf = h.to(dt).reshape(h.shape[0], -1, h.shape[-1])
    return torch.bmm(torch.bmm(hf, a), b).reshape(*h.shape[:-1],
                                                  b.shape[-1])


def _slot_delta_stacked(h, p, name: str, dt):
    """:func:`_slot_delta` for a stacked [k, in, out] weight: A [B, k, in,
    r], B [B, k, r, out] -> [k, B, ..., out] (``mm_stacked``'s form)."""
    sa = p.get(name + "_lora_sa")
    if sa is None:
        return None
    ids = p["lora_ids"]
    a = sa.index_select(0, ids).to(dt)
    b = p[name + "_lora_sb"].index_select(0, ids).to(dt)
    hf = h.to(dt).reshape(h.shape[0], -1, h.shape[-1])
    t = torch.einsum("bnd,bkdr->kbnr", hf, a)
    d = torch.einsum("kbnr,bkrf->kbnf", t, b)
    return d.reshape(d.shape[0], *h.shape[:-1], d.shape[-1])


def _w4_qualifies(p, name: str, ndim: int) -> bool:
    """THE routing predicate of the W4 kernel (mm: ndim 2, mm_stacked:
    ndim 3): the flag is set and the weight is packed int4 of that rank."""
    arr = p[name]
    return (flags.w4_kernel() and arr.dim() == ndim
            and _packed(arr, p.get(name + "_s"))
            and name + "_lora_a" not in p)


def mm(h, p, name: str, dt):
    """``h @ w(p, name, dt)``; a packed int4 2-D weight under
    ``PADDLE_TPU_W4_KERNEL=1`` runs ``w4_matmul`` on the packed bytes.
    Served adapters add their per-slot term (:func:`_slot_delta`)."""
    if _w4_qualifies(p, name, 2):
        out = w4_matmul(h.to(dt), p[name], p[name + "_s"])
    else:
        out = h @ w(p, name, dt)
    d = _slot_delta(h, p, name, dt)
    return out if d is None else out + d


def mm_stacked(h, p, name: str, dt):
    """``einsum('...d,kde->k...e', h, w)`` — the stacked qkv/kv projection
    form [k, ...] of a [k, in, out] weight, as one batched matmul whose
    output is contiguous (each [k] slice is a contiguous tensor the
    attention kernels can take as it is).  A packed int4 weight under
    ``PADDLE_TPU_W4_KERNEL=1`` runs one ``w4_matmul`` per stack slice,
    stacked.  Served adapters add their per-slot term."""
    if _w4_qualifies(p, name, 3):
        hq = h.to(dt)
        arr, s = p[name], p[name + "_s"]
        out = torch.stack([w4_matmul(hq, arr[i], s[i])
                           for i in range(arr.shape[0])])
    else:
        wt = w(p, name, dt)
        out = (h.reshape(1, -1, h.shape[-1]) @ wt).reshape(
            wt.shape[0], *h.shape[:-1], wt.shape[-1])
    d = _slot_delta_stacked(h, p, name, dt)
    return out if d is None else out + d


def embed(params, token, dt):
    """wte[token] in the compute dtype, times its row scale if int8.  On a
    tensor-parallel rank whose ``wte`` (and ``wte_s``) hold a vocab shard
    (``tp_context``): the rank looks up the tokens it owns, zeros the
    rest, and one all-reduce over ``mp`` assembles the rows (one nonzero
    term a row: exact in any dtype)."""
    ctx = _tp.current()
    if ctx is None or not ctx.vocab_split:
        e = params["wte"][token].to(dt)
        if params["wte"].dtype == torch.int8:
            e = e * params["wte_s"][token].to(dt)
        return e
    vps = ctx.vocab_per_shard
    local = token - ctx.r_mp * vps
    ok = (local >= 0) & (local < vps)
    local = local.clamp(0, vps - 1)
    e = params["wte"][local].to(dt)
    if params["wte"].dtype == torch.int8:
        e = e * params["wte_s"][local].to(dt)
    e = torch.where(ok[..., None], e, torch.zeros((), dtype=dt,
                                                  device=e.device))
    return ctx.exit(e)


def logits(x, params, dt):
    """Tied-head logits x @ wte.T; int8 per-row wte scales apply on the
    [..., V] output (they factor out of the contraction).  On a
    tensor-parallel rank with a vocab shard the [..., V/mp] block is
    all-gathered to the whole vocabulary (``tp_context``)."""
    y = x @ params["wte"].to(dt).T
    if params["wte"].dtype == torch.int8:
        y = y * params["wte_s"].reshape(-1).to(dt)
    ctx = _tp.current()
    return y if ctx is None else ctx.gather_vocab(y)


def is_quantized(params) -> bool:
    return any(k.endswith("_s") for k in params["blocks"])
