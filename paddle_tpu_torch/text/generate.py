"""Autoregressive GPT generation over a KV cache.

Counterpart of ``paddle_tpu/text/generate.py`` for the serving slices:
the cache format (with the int8 ``k_s``/``v_s`` scale planes; the paged
layout lives in ``text/kv_pool.py``), the single-position decode step,
whole-prompt and chunked prefill (and the chunk math the paged prefill
shares), the K-token verify step, the logit filter, ``generate``,
``beam_search`` and linear ``speculative_generate`` (a draft model
proposes, the target verifies; the model-free n-gram proposer lives here
too), and tree speculation's verify over a token tree, its row permute
and the n-gram trie proposer.  Where the JAX module scans
over layers and returns a new cache, this one loops over layers and
**writes cache rows in place**
(``index_put_`` / ``index_copy_`` into the [L, B, T, ...] leaves): a
decode step writes each layer's fresh row before that layer attends the
cache, which is what the JAX step computes by splicing the row into its
copy.  The returned cache is the same dict that was passed in.  The
admission functions take their offset, length and slot as device
tensors (or ints), so a captured graph serves any prompt and slot;
``generate`` runs through the step Engine (``text/engine.py``).

On a CUDA cache every cached-attention site (decode steps, verify
chunks and prefill chunks) runs the split-KV decode kernel
(``ops/decode_attention``) and whole-prompt prefill runs the flash
kernel; on the CPU they keep the reference's plain math.  The tree
verify is the exception: its mask is not causal, and the reference has
no kernel there either, so it runs the reference's einsum on both
devices.  The JAX
package gates its batched verify on its kernel flag and otherwise vmaps
a per-slot einsum; the port has one attention path on the card, the
kernel, and the einsum is only the CPU's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gpt, woq
from . import tp_context as _tp
from .. import flags as _flags
from .. import resolve_device
from .. import telemetry as _telemetry
from ..ops import decode_attention as da
from ..ops.attention import attention_array

__all__ = ["init_cache", "decode_step", "prefill_slot", "prefill_slot_chunk",
           "verify_chunk", "verify_chunk_batched", "generate", "beam_search",
           "ngram_propose", "speculative_generate", "tree_depths",
           "tree_ancestor_mask", "tree_verify_chunk",
           "tree_verify_chunk_batched", "tree_commit_rows",
           "ngram_propose_tree"]


def _kv_store_dtype(cfg: gpt.GPTConfig):
    """The cache STORAGE dtype (flags.kv_cache_dtype): '' = the model's
    compute dtype."""
    return {"fp32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}.get(_flags.kv_cache_dtype(), cfg.dtype)


def _round_cache_len(n: int) -> int:
    """Round a cache length up to an 8-multiple up to 512 and a
    128-multiple beyond — the JAX package's tileable lengths, kept so a
    slot's cache holds the same number of rows in both packages (the
    rows past the write position stay masked)."""
    n = max(int(n), 1)
    if n <= 512:
        return -(-n // 8) * 8
    return -(-n // 128) * 128


def init_cache(cfg: gpt.GPTConfig, batch: int, max_len: int, device=None,
               layout=None, block_size=None, num_blocks=None):
    """Per-layer K/V cache [L, B, T, Hkv, hd] with T = ``max_len`` rounded
    by :func:`_round_cache_len`, on ``device`` (default the card).
    ``PADDLE_TPU_KV_DTYPE`` selects the storage dtype; int8 caches carry
    per-(position, head) fp32 scale planes ``k_s``/``v_s`` [L, B, T, Hkv].
    A layer's slice ``cache[name][l]`` is contiguous, which is the form
    the decode kernel takes.

    ``layout="paged"`` returns the pooled format instead
    (``kv_pool.init_paged_cache``: a block pool read through an int32
    ``tables`` leaf [batch, nmax])."""
    if layout == "paged":
        from . import kv_pool

        return kv_pool.init_paged_cache(cfg, batch, max_len,
                                        block_size=block_size,
                                        num_blocks=num_blocks, device=device)
    if layout not in ("contiguous", None, ""):
        raise ValueError(
            f"layout {layout!r}: expected 'contiguous' or 'paged'")
    dev = resolve_device(device)
    L, H, hd = cfg.num_layers, cfg.kv_heads, cfg.head_dim
    dt = _kv_store_dtype(cfg)
    shape = (L, batch, _round_cache_len(max_len), H, hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if dt == torch.int8:
        cache["k_s"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
        cache["v_s"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
    return cache


def _layer_cache(cache: dict, l: int) -> dict:
    """Layer ``l``'s cache leaves [B, T, ...] (views: writes land in the
    cache)."""
    return {name: arr[l] for name, arr in cache.items()}


def _positions(pos, B: int, device) -> torch.Tensor:
    """A scalar or per-slot position as an int32 [B] tensor on
    ``device`` (``generate`` passes one position for the batch; the
    server passes one per slot)."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.expand(B).contiguous() if p.dim() == 0 else p


def _store_rows(k_rows, v_rows, cfg: gpt.GPTConfig) -> dict:
    """Compute-dtype K/V rows [..., Hkv, hd] -> cache-storage leaves:
    int8 quantizes per-(row, head) and adds the scale leaves."""
    dt = _kv_store_dtype(cfg)
    if dt == torch.int8:
        qk, sk = da.quantize_kv(k_rows)
        qv, sv = da.quantize_kv(v_rows)
        return {"k": qk, "v": qv, "k_s": sk, "v_s": sv}
    return {"k": k_rows.to(dt), "v": v_rows.to(dt)}


def _attend_cost(q, full, pos, cfg: gpt.GPTConfig):
    """The device feed's count of :func:`_attend_cache`: the decode
    kernel's, whichever body runs."""
    return da.decode_attention_cost(q, full["k"], full["v"], pos,
                                    full.get("k_s"))


@_telemetry.counted(_attend_cost)
def _attend_cache(q, full, pos, cfg: gpt.GPTConfig):
    """Cached attention for a Tq-row query block against one layer's
    cache ``full`` (leaves k/v [B, T, Hkv, hd] + scales, rows through the
    current positions written): row i of batch b attends rows
    t <= pos[b] + i.  ``pos`` is an int32 [B] tensor.  Returns
    [B, Tq, H*hd] in the compute dtype.

    CUDA: the split-KV decode kernel (GQA-aware, int8 dequantized in
    registers).  CPU: the reference's grouped einsum, in the compute
    dtype as the JAX package computes it."""
    B, Tq, H, hd = q.shape
    full = _tp.kv_view_leaves(full, 2)
    k_all = full["k"]
    if k_all.is_cuda:
        out = da.decode_attention(q.contiguous(), k_all, full["v"], pos,
                                  k_scale=full.get("k_s"),
                                  v_scale=full.get("v_s"))
        return out.to(cfg.dtype).reshape(B, Tq, H * hd)
    t = torch.arange(k_all.shape[1], device=q.device)
    i = torch.arange(Tq, device=q.device)
    mask = t <= pos.reshape(B, 1, 1, 1, 1) + i[:, None]     # [B,1,1,Tq,T]
    return _attend_masked(q, full, mask, cfg)


def _attend_masked(q, full, mask, cfg: gpt.GPTConfig):
    """The reference's plain cached attention: q [B, Tq, H, hd] against
    one layer's cache ``full`` (leaves k/v [B, T, Hkv, hd] + int8 scales)
    under a visibility ``mask`` broadcasting to [B, Hkv, G, Tq, T] (True =
    attend) — the grouped einsum in the compute dtype, the scores masked
    with -1e30 in fp32, softmax, cast back.  Returns [B, Tq, H*hd]."""
    B, Tq, H, hd = q.shape
    dt = cfg.dtype
    full = _tp.kv_view_leaves(full, 2)
    k_all, v_all = full["k"], full["v"]
    ks, vs = full.get("k_s"), full.get("v_s")
    if ks is not None:
        k_all = da.dequantize_kv(k_all, ks, dt)
        v_all = da.dequantize_kv(v_all, vs, dt)
    k_all = k_all.to(dt)
    v_all = v_all.to(dt)
    Hkv = k_all.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Tq, Hkv, g, hd)
    scores = torch.einsum("bikgd,btkd->bkgit", qg, k_all) \
        / torch.tensor(hd, dtype=torch.float32).sqrt().to(dt)
    scores = torch.where(mask, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bkgit,btkd->bikgd", w, v_all).reshape(B, Tq, -1)


def _embed_step(params, token, pos, cfg: gpt.GPTConfig):
    """Embed one decode step's tokens [B] at positions ``pos`` (int32
    [B]) -> [B, 1, D]."""
    x = woq.embed(params, token, cfg.dtype)[:, None]
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][pos].to(cfg.dtype)[:, None]
    return x


def _block_pre_attn(x, p, pos, cfg: gpt.GPTConfig):
    """Pre-attention half of one decode block on [B, 1, D]: ln1 -> qkv
    projection (Hkv heads kept, never repeated) -> rope at each slot's
    position -> storage-dtype rows [B, Hkv, hd].  Returns (q3, rows)."""
    B = x.shape[0]
    hd = cfg.head_dim
    h = gpt._norm(x, p, "ln1", cfg)
    q3, k3, v3 = gpt._project_qkv(h, p, cfg)
    if cfg.pos_embed == "rope":
        # the cache holds already-rotated keys (rope's relative-offset
        # property keeps them valid forever)
        q3 = gpt.apply_rope(q3, pos[:, None])
        k3 = gpt.apply_rope(k3, pos[:, None])
    return q3, _store_rows(k3.reshape(B, -1, hd), v3.reshape(B, -1, hd), cfg)


def _block_post_attn(x, attn, p, cfg: gpt.GPTConfig, valid=None,
                     capacity=gpt._LEGACY, stats=None):
    """Post-attention half: output projection + residual + FFN tail
    (``gpt._ffn_tail``: dense, or MoE routed under ``valid``,
    ``capacity`` and ``stats`` — the joint-routing decode step passes
    the occupancy mask, the capacity-factor bound and its accumulator;
    a prefill its pad mask)."""
    dt = cfg.dtype
    a = _tp.reduce_mp(woq.mm(attn, p, "proj_w", dt)) + p["proj_b"].to(dt)
    return gpt._ffn_tail(x + a, p, cfg, valid=valid, capacity=capacity,
                         stats=stats)


def _write_rows(csl: dict, rows: dict, pos) -> None:
    """Write one decode step's rows (leaves [B, Hkv(, hd)]) into a layer's
    cache leaves [B, T, ...] at each slot's position — IN PLACE."""
    B = pos.shape[0]
    b = torch.arange(B, device=pos.device)
    for name, val in rows.items():
        arr = csl[name]
        arr.index_put_((b, pos.long()), val.to(arr.dtype))


def _cached_block(x, p, csl, pos, cfg: gpt.GPTConfig, **ffn):
    """One block on a single position [B, 1, D] against one layer's cache
    ``csl``: the fresh rows are written in place at ``pos`` first (in
    storage form, so this step attends exactly what later steps read
    back, int8 included), then the layer attends its cache.  ``ffn``:
    :func:`_block_post_attn`'s routing arguments."""
    q3, rows = _block_pre_attn(x, p, pos, cfg)
    _write_rows(csl, rows, pos)
    attn = _attend_cache(q3, csl, pos, cfg)            # [B, 1, D]
    return _block_post_attn(x, attn, p, cfg, **ffn)


@torch.no_grad()
def decode_step(params, cache, token, pos, cfg: gpt.GPTConfig, **ffn):
    """token [B] int at position ``pos`` — one int for the whole batch or
    an int [B] per slot — -> (logits [B, V] float32, cache).  The cache
    rows at ``pos`` are written in place.  ``ffn`` (MoE: ``valid``,
    ``capacity``, ``stats``) goes to every layer's FFN tail: the B
    tokens of the step route as one call (``moe_serving``'s joint
    step)."""
    B = token.shape[0]
    pos = _positions(pos, B, token.device)
    x = _embed_step(params, token, pos, cfg)
    for l in range(cfg.num_layers):
        x = _cached_block(x, gpt.layer(params, l), _layer_cache(cache, l),
                          pos, cfg, **ffn)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype)[:, 0].float(), cache


# ---------------------------------------------------------------------------
# tensor-parallel (sharded) decode — a model split over the ranks of a mesh
# ---------------------------------------------------------------------------


def _decode_param_specs(params, cfg: gpt.GPTConfig, mp: str) -> dict:
    """The spec tree of ``params`` — float, weight-only int8 / int4
    (``woq``) or LoRA-adapted — as the JAX package places it: each weight
    takes its float twin's Megatron spec (``gpt.param_shardings``), the
    ``*_s`` scales and ``*_lora_a`` / ``*_lora_b`` pairs replicate
    (``()``).  A rank cuts scales and pairs along their weight's split
    dims all the same (``tp_serving.local_specs``): JAX reshards them at
    the product, a rank multiplies its own block."""
    base = gpt.param_shardings(cfg, mp=mp)
    blocks = {}
    for name in params["blocks"]:
        if name.endswith(("_s", "_lora_a", "_lora_b")):
            blocks[name] = ()
        else:
            blocks[name] = base["blocks"][name]
    out = {k: (base[k] if k in base else ()) for k in params
           if k != "blocks"}
    out["blocks"] = blocks
    return out


def sharded_cache_specs(cfg: gpt.GPTConfig, cache: dict, mesh,
                        mp: str = "mp") -> dict:
    """The spec of each cache leaf under tensor parallel — one rule for
    both layouts: the Hkv axis (axis 3 of the slab ``[L, B, T, Hkv, hd]``
    and of the pool ``[L, N, bs, Hkv, hd]``, the int8 scale planes too)
    splits over ``mp`` when ``mp`` divides the kv heads; otherwise the
    whole cache replicates; the paged ``tables`` leaf always replicates
    (the host allocator's state)."""
    n = mesh.shape[mp]

    def spec(name, arr):
        if name == "tables" or cfg.kv_heads % n:
            return ()
        return (None,) * 3 + (mp,) + (None,) * (arr.dim() - 4)

    return {name: spec(name, arr) for name, arr in cache.items()}


class ShardedCache(dict):
    """A sharded cache's leaves (``tp_serving.ShardedTensor`` handles) by
    name, with the ``binding`` that holds them on the ranks."""

    binding = None


def build_sharded_decode(params, cfg: gpt.GPTConfig, mesh, mp: str = "mp",
                         layout: str | None = None,
                         block_size: int | None = None):
    """Megatron-sharded single-token decode over ``mesh``
    (``distributed.serving_mesh.ServingMesh``), as the JAX package's:
    returns ``(sharded_params, make_cache, decode_fn)``:

        sharded_params   the params cut over the ranks (a tree of
                         ``tp_serving.ShardedTensor`` handles)
        make_cache(B, T, num_blocks=None)   a cache split over the ranks
        decode_fn(p, cache, token [B], pos) -> (logits [B, V], cache)

    Each rank holds its block of every weight (``_decode_param_specs``;
    weight-only int8 / int4 trees shard the same way) and of the cache
    (``sharded_cache_specs``); the step (the Engine's ``sharded_decode``
    kind) runs on every rank and the logits come back whole.  The cache
    is updated in place on the ranks and returned as it was given (the
    JAX step donates it).  ``layout`` (default ``PADDLE_TPU_KV_LAYOUT``)
    picks slab or pool; ``pos`` is one position for the batch (the pool
    broadcasts it per slot).  A flag flip after the build —
    ``PADDLE_TPU_KV_LAYOUT``, ``_KV_BLOCK``, ``_KV_DTYPE`` — makes
    ``make_cache`` raise.  MoE is refused (``DecodeServer(mesh=,
    ep_axis=)`` serves it)."""
    from . import engine, tp_serving

    if cfg.moe is not None:
        raise NotImplementedError("sharded decode supports dense models")
    lay = _flags.kv_layout() if layout is None else layout
    if lay not in ("contiguous", "paged"):
        raise ValueError(f"layout {lay!r}: expected 'contiguous' or "
                         f"'paged'")
    bs = None
    if lay == "paged":
        bs = _flags.kv_block_size() if block_size is None \
            else int(block_size)
    template = init_cache(cfg, 1, 1, "meta", layout=lay, block_size=bs)
    shard = engine._ShardCtx(mesh, cfg, params, template, mp)
    sp = tp_serving.ShardedParams(params, cfg, mesh, shard.params, mp)

    def make_cache(batch: int, max_len: int, num_blocks: int | None = None):
        # the flag-derived layout and block size were pinned at build (an
        # explicit argument is the caller's own): a flip since then fails
        # loudly instead of serving two layouts at once
        if layout is None and _flags.kv_layout() != lay:
            raise ValueError(
                f"PADDLE_TPU_KV_LAYOUT changed since "
                f"build_sharded_decode (built {lay!r}, flag now "
                f"{_flags.kv_layout()!r}); rebuild the sharded decoder")
        if lay == "paged" and block_size is None \
                and _flags.kv_block_size() != bs:
            raise ValueError(
                f"PADDLE_TPU_KV_BLOCK changed since "
                f"build_sharded_decode (built {bs}, flag now "
                f"{_flags.kv_block_size()}); rebuild the sharded "
                f"decoder")
        fresh = init_cache(cfg, batch, max_len, "meta", layout=lay,
                           block_size=bs, num_blocks=num_blocks)
        if set(fresh) != set(shard.cache):
            raise ValueError(
                "PADDLE_TPU_KV_DTYPE changed since build_sharded_decode "
                f"(built {sorted(shard.cache)}, now {sorted(fresh)}); "
                "rebuild the sharded decoder")
        nb = fresh["k"].shape[1] - 1 if lay == "paged" else None
        bind = tp_serving.ShardedBinding(shard, sp, fresh, lay, batch,
                                         max_len, bs, nb)
        out = ShardedCache(bind.cache)
        out.binding = bind
        return out

    def decode_fn(p, cache, token, pos):
        if p is not sp.tree:
            raise ValueError("decode_fn takes the sharded_params of its "
                             "own build_sharded_decode")
        fn = engine.ENGINE.get("sharded_decode", engine.StepSpec(
            cfg=cfg, extra=(lay, bs), payload=cache.binding))
        (logits,) = fn(torch.as_tensor(token).long(),
                       torch.as_tensor(pos).long().reshape(()))
        return logits, cache

    return sp.tree, make_cache, decode_fn


# ---------------------------------------------------------------------------
# whole-prompt prefill
# ---------------------------------------------------------------------------


def _prefill_block(x, p, cfg: gpt.GPTConfig, valid=None):
    """One block over a padded prompt [B, P, D] with within-prompt causal
    attention (the cache is empty at prefill), returning (x, rows) —
    storage-dtype row leaves [B, P, Hkv(, hd)] for the caller to merge.
    Attention reads the STORAGE view of the fresh rows, so under int8 the
    admission path sees exactly what later decode steps read back.
    ``valid`` [B, P]: the pad mask an MoE router takes (pads claim no
    expert capacity)."""
    B, P, D = x.shape
    dt = cfg.dtype
    h = gpt._norm(x, p, "ln1", cfg)
    q, k_rows, v_rows = gpt._project_qkv(h, p, cfg)
    if cfg.pos_embed == "rope":
        pos_arr = torch.arange(P, device=x.device)
        q = gpt.apply_rope(q, pos_arr)
        k_rows = gpt.apply_rope(k_rows, pos_arr)
    rows = _store_rows(k_rows, v_rows, cfg)
    if "k_s" in rows:
        k_att = da.dequantize_kv(rows["k"], rows["k_s"], dt)
        v_att = da.dequantize_kv(rows["v"], rows["v_s"], dt)
    else:
        k_att, v_att = rows["k"].to(dt), rows["v"].to(dt)
    k_att, v_att = _tp.kv_view(k_att, 2), _tp.kv_view(v_att, 2)
    attn = attention_array(q, k_att, v_att, is_causal=True).reshape(B, P, -1)
    a = _tp.reduce_mp(woq.mm(attn, p, "proj_w", dt)) + p["proj_b"].to(dt)
    return gpt._ffn_tail(x + a, p, cfg, valid=valid), rows


def _index(v, device) -> torch.Tensor:
    """A position, length or slot as an int64 0-d tensor on ``device``:
    a Python int, or a 0-d or [1] int tensor already there — what a
    captured admission step is fed, read by no host code (a Python int
    is for eager callers only: it is copied to the device)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(device=device, dtype=torch.int64)
    return torch.tensor(int(v), dtype=torch.int64, device=device)


def _pad_mask(length, P: int, cfg: gpt.GPTConfig):
    """The valid rows [1, P] of a P-row prompt chunk holding ``length``
    tokens (a 0-d device tensor) for an MoE router; None for a dense
    model, whose FFN reads no mask."""
    if cfg.moe is None:
        return None
    return (torch.arange(P, device=length.device) < length)[None]


def _slot_rows(slot, pos0, length, P: int, T: int):
    """(dst, src) int64 [P] of a masked merge of a P-row chunk into one
    slot's rows [pos0, pos0 + length) of a layer cache [B, T, ...] seen as
    [B * T, ...]: chunk row i < length goes to row slot * T + pos0 + i;
    a pad row i >= length repeats row length - 1 (the same destination and
    the same value), so pads write nothing of their own.  PRECONDITION
    pos0 + P <= T: no row lands past the cache's end."""
    i = torch.arange(P, device=length.device)
    src = torch.minimum(i, length - 1)
    return slot * T + pos0 + src, src


def _merge_slot_rows(csl: dict, rows: dict, dst, src) -> None:
    """Write a chunk's rows (leaves [1, P, ...]) into one layer's cache
    leaves [B, T, ...] at the :func:`_slot_rows` indices — IN PLACE.  The
    reference's masked merge: pad rows leave the old tenant's rows bit for
    bit (they stay hidden by the causal mask until overwritten), and the
    slot and offset are device indices.  Shared by prefill_slot (pos0 ==
    0) and the chunk path."""
    for name, val in rows.items():
        arr = csl[name]
        flat = arr.view((-1,) + arr.shape[2:])
        flat.index_copy_(0, dst, val[0].index_select(0, src).to(arr.dtype))


@torch.no_grad()
def inject_slot_rows(cache: dict, rows: dict, start, length, slot) -> dict:
    """The contiguous injector — the JAX package's ``_merge_slot_rows``
    masked write as the fleet handoff runs it: rows computed elsewhere (a
    prefill worker's), leaves ``[L, 1, P, Hkv(, hd)]`` by cache leaf name
    holding the slot's logical rows [0, P), written into ``slot``'s rows
    [start, length) across every layer, in place.  ``start``, ``length``
    and ``slot`` are ints or 0-d / [1] int tensors (a captured step's
    feeds).  Rows outside [start, length) write nothing of their own: each
    repeats the index and value of the nearest row inside (the
    :func:`_slot_rows` rule), so the old tenant's rows stay bit for bit.
    PRECONDITION start < length <= P <= the cache's rows.  One
    ``index_copy_`` a leaf.  Returns the cache it was given."""
    dev = cache["k"].device
    start, length, slot = (_index(v, dev) for v in (start, length, slot))
    P, T = rows["k"].shape[2], cache["k"].shape[2]
    src = torch.minimum(torch.maximum(torch.arange(P, device=dev), start),
                        length - 1)
    dst = slot * T + src
    for name, val in rows.items():
        arr = cache[name]
        flat = arr.view((arr.shape[0], -1) + arr.shape[3:])
        flat.index_copy_(1, dst, val[:, 0].index_select(1, src).to(arr.dtype))
    return cache


@torch.no_grad()
def prefill_slot(params, cache, tokens, length, slot, cfg: gpt.GPTConfig):
    """Process one request's whole (padded) prompt in a single pass.

    tokens [1, P] int padded to P; ``length`` = valid prompt tokens;
    ``slot`` = batch row of the serving cache — each a Python int or a
    0-d int tensor on the cache's device (a captured step's feeds).
    Writes that slot's cache rows [0, length) in place and returns (logits
    at position length-1 [V] float32, cache).  An MoE model routes the
    bucket under its pad mask at the dropless capacity (the bucket's
    rows), so the prompt routes as if fed token by token."""
    dev = tokens.device
    length, slot = _index(length, dev), _index(slot, dev)
    dst, src = _slot_rows(slot, 0, length, tokens.shape[1],
                          cache["k"].shape[2])
    valid = _pad_mask(length, tokens.shape[1], cfg)
    x = _embed_chunk(params, tokens, cfg)
    for l in range(cfg.num_layers):
        x, rows = _prefill_block(x, gpt.layer(params, l), cfg, valid)
        _merge_slot_rows(_layer_cache(cache, l), rows, dst, src)
    return _last_logits(x, length, params, cfg), cache


# ---------------------------------------------------------------------------
# chunked prefill: a prompt chunk at an offset, attending the rows before it
# ---------------------------------------------------------------------------


def _chunk_pre_attn(x, p, pos0, cfg: gpt.GPTConfig, offsets=None):
    """Pre-attention half of one block on a C-token chunk [B, C, D] at
    positions [pos0, pos0 + C) (``pos0`` an int or a 0-d tensor), or at
    ``pos0 + offsets`` (a tree chunk's node depths [B, C]): ln1 -> qkv
    projection (Hkv heads kept) -> rope over the chunk's positions ->
    storage-dtype rows.  Returns (q [B, C, H, hd], rows)."""
    C = x.shape[1]
    q, k_new, v_new = gpt._project_qkv(gpt._norm(x, p, "ln1", cfg), p, cfg)
    if cfg.pos_embed == "rope":
        chunk_pos = pos0 + (torch.arange(C, device=x.device)
                            if offsets is None else offsets)
        q = gpt.apply_rope(q, chunk_pos)
        k_new = gpt.apply_rope(k_new, chunk_pos)
    return q, _store_rows(k_new, v_new, cfg)


def _embed_chunk(params, tokens, cfg: gpt.GPTConfig, pos0=None):
    """Embed a chunk's tokens [1, C] at positions [pos0, pos0 + C): from 0
    when ``pos0`` is None, else from a 0-d int64 tensor (a gather of the
    position table, no host read)."""
    x = woq.embed(params, tokens, cfg.dtype)
    if cfg.pos_embed == "learned":
        C = tokens.shape[1]
        wpe = (params["wpe"][:C] if pos0 is None else params["wpe"]
               .index_select(0, pos0 + torch.arange(C, device=x.device)))
        x = x + wpe.to(cfg.dtype)[None]
    return x


def _last_logits(x, length, params, cfg: gpt.GPTConfig):
    """Logits [V] float32 at the chunk's last valid row, ``length`` a 0-d
    int64 tensor (the final norm is per row, so only that row is
    normalized)."""
    last = x.index_select(1, (length - 1).reshape(1))
    last = gpt._norm(last, params, "ln_f", cfg)
    return woq.logits(last, params, cfg.dtype)[0, 0].float()


@torch.no_grad()
def prefill_slot_chunk(params, cache, tokens, pos0, length, slot,
                       cfg: gpt.GPTConfig):
    """One fixed-size chunk of a prompt at positions [pos0, pos0 + C) for
    one slot of a contiguous cache — the multi-chunk admission step: a
    long prompt feeds as a sequence of these, each attending the slot's
    already-filled rows [0, pos0).  ``pos0``, ``length`` and ``slot`` are
    Python ints or 0-d int tensors on the cache's device.

    tokens [1, C] int (pad tail beyond ``length``).  PRECONDITION
    pos0 + C <= the cache rows and the wpe table (the server's walk
    overlaps its last window instead of overrunning).  Per layer, the
    chunk's first ``length`` rows merge into the slot's rows in place
    (:func:`_merge_slot_rows`: pads write nothing), then row i attends the
    slot's rows t <= pos0 + i (``_attend_cache``: on the card the decode
    kernel at Tq = C) on a copy of the slot's rows [1, T, ...] — the slot
    is a device index, and the kernel takes a contiguous cache.  A valid
    row sees only rows <= pos0 + i, so what sits past the prompt cannot
    reach it; the pads' own outputs are discarded (an MoE router masks
    them, at the dropless capacity, as :func:`prefill_slot` does).
    Returns (logits at the chunk's last valid position [V] float32,
    cache)."""
    dev = tokens.device
    pos0, length, slot = (_index(v, dev) for v in (pos0, length, slot))
    dst, src = _slot_rows(slot, pos0, length, tokens.shape[1],
                          cache["k"].shape[2])
    valid = _pad_mask(length, tokens.shape[1], cfg)
    pos = pos0.to(torch.int32).reshape(1)
    rows_of = slot.reshape(1)
    x = _embed_chunk(params, tokens, cfg, pos0)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        csl = _layer_cache(cache, l)
        q, rows = _chunk_pre_attn(x, p, pos0, cfg)
        _merge_slot_rows(csl, rows, dst, src)
        view = {name: arr.index_select(0, rows_of)
                for name, arr in csl.items()}
        attn = _attend_cache(q, view, pos, cfg)            # [1, C, D]
        x = _block_post_attn(x, attn, p, cfg, valid=valid)
    return _last_logits(x, length, params, cfg), cache


# ---------------------------------------------------------------------------
# verify: K tokens per slot in one pass (speculative decoding)
# ---------------------------------------------------------------------------


def _embed_verify(params, tokens, pos, cfg: gpt.GPTConfig, offsets=None):
    """Embed a verify chunk's tokens [B, K] at each slot's positions
    [pos_b, pos_b + K) (``pos`` int32 [B]), or at ``pos_b + offsets``
    (a tree chunk's node depths [B, K]) -> [B, K, D]."""
    x = woq.embed(params, tokens, cfg.dtype)
    if cfg.pos_embed == "learned":
        K = tokens.shape[1]
        at = pos.long()[:, None] + (torch.arange(K, device=x.device)
                                    if offsets is None else offsets.long())
        x = x + params["wpe"][at].to(cfg.dtype)
    return x


def _write_rows_batched(csl: dict, rows: dict, dst) -> None:
    """Per-slot offset write: chunk row leaves [B, K, Hkv(, hd)] land in
    one layer's cache leaves [B, T, ...] (seen as [B * T, ...]) at the
    flat rows ``dst`` [B, K] = b * T + pos_b + j — one ``index_copy_`` a
    leaf, fed device indices, as :func:`_merge_slot_rows`.  PRECONDITION
    pos_b + K <= T: a row past a slot's end would land in the next slot
    (the JAX package's ``dynamic_update_slice`` clamps instead; the
    server's ``_spec_ready`` gate keeps every round inside)."""
    idx = dst.reshape(-1)
    for name, val in rows.items():
        arr = csl[name]
        flat = arr.view((-1,) + arr.shape[2:])
        flat.index_copy_(0, idx, val.reshape((-1,) + val.shape[2:])
                         .to(arr.dtype))


@torch.no_grad()
def verify_chunk_batched(params, cache, tokens, pos, cfg: gpt.GPTConfig):
    """Score K tokens per slot in one pass: tokens [B, K] int fed at
    per-slot positions [pos_b, pos_b + K) (``pos`` an int [B] tensor, or
    one int for the batch) -> (logits [B, K, V] float32, cache).  Row j
    of slot b attends the slot's rows t <= pos_b + j, so row 0 is the
    decode step's logits for the same feed token.

    Per layer the K fresh rows are written into each slot's rows first
    (in storage form — the splice-before-attend rule of the JAX
    package's ``_chunk_attend_block``), then the layer attends its cache:
    on the card one launch of the decode kernel over [B, K] query rows
    (R = K * G, the tick body below ``R_TC``).  All K rows are written
    unconditionally: rows past a rejection sit at or past the slot's
    position pointer, where the causal mask hides them until a later
    round overwrites them.  PRECONDITION pos_b + K <= the cache rows and
    the position table (:func:`_write_rows_batched`)."""
    B, K = tokens.shape
    T = cache["k"].shape[2]
    dev = tokens.device
    pos = _positions(pos, B, dev)
    dst = (torch.arange(B, device=dev) * T + pos.long())[:, None] \
        + torch.arange(K, device=dev)
    x = _embed_verify(params, tokens, pos, cfg)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        csl = _layer_cache(cache, l)
        q, rows = _chunk_pre_attn(x, p, pos.long()[:, None], cfg)
        _write_rows_batched(csl, rows, dst)
        attn = _attend_cache(q, csl, pos, cfg)             # [B, K, D]
        x = _block_post_attn(x, attn, p, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype).float(), cache


def verify_chunk(params, cache, tokens, pos0, cfg: gpt.GPTConfig):
    """Score tokens [B, K] fed at positions [pos0, pos0 + K) of every row
    (one ``pos0`` for the batch) against the cache's rows [0, pos0) plus
    the chunk causally; writes the chunk's rows at [pos0, pos0 + K).
    Returns (logits [B, K, V] float32, cache).  The offline speculative
    path's verify: :func:`verify_chunk_batched` at one shared offset."""
    return verify_chunk_batched(params, cache, tokens, pos0, cfg)


# ---------------------------------------------------------------------------
# tree speculation: one verify pass over a branching token tree
# ---------------------------------------------------------------------------


def tree_depths(parent):
    """Per-node depths [N] int32 of a parent-index tree (``parent[0] ==
    -1`` is the root, the feed node; parents precede children, as every
    proposer lays its tree out).  Host work."""
    n = len(parent)
    d = np.zeros(n, np.int32)
    for j in range(1, n):
        d[j] = d[parent[j]] + 1
    return d


def tree_ancestor_mask(parent):
    """Ancestor-or-self mask [N, N] bool of a parent-index tree: ``m[j,
    t]`` is True iff node t lies on node j's root path (j included) — the
    within-chunk half of the tree-attention mask, built on the host and
    fed to the verify as data, so a new topology never keys a new step."""
    n = len(parent)
    m = np.zeros((n, n), bool)
    for j in range(n):
        m[j, j] = True
        if parent[j] >= 0:
            m[j] |= m[parent[j]]
    return m


def _tree_visibility(amask, pos, T: int):
    """The tree-attention mask [B, N, T] bool of chunks stored at rows
    [pos_b, pos_b + N): node j of slot b sees the committed rows t <
    pos_b and, inside the chunk, its own root path ``amask[b, j, t -
    pos_b]`` — nothing of a sibling branch.  Rows past the chunk stay
    hidden."""
    B, N, _ = amask.shape
    rel = torch.arange(T, device=amask.device)[None, :] \
        - pos.long()[:, None]                                   # [B, T]
    inside = (rel >= 0) & (rel < N)
    within = torch.gather(amask, 2, rel.clamp(0, N - 1)[:, None, :]
                          .expand(B, N, T))
    return (rel < 0)[:, None, :] | (within & inside[:, None, :])


def _tree_forward(params, tokens, depth, pos, tmask, write, read,
                  cfg: gpt.GPTConfig):
    """THE tree verify body of both layouts: tokens [B, N] (node 0 the
    feed token) embedded and roped at their logical positions ``pos_b +
    depth[b, j]`` (siblings share one); per layer the N fresh rows of
    every slot go to the cache first (``write(l, rows)``: rows [pos_b,
    pos_b + N) in storage form), then every node attends the layer's
    rows ``read(l)`` ([B, T, ...] a leaf) under ``tmask`` [B, N, T] —
    the reference's einsum, on the card too: the decode kernels' masks
    are causal.  Returns logits [B, N, V] float32."""
    offsets = depth.long()
    x = _embed_verify(params, tokens, pos, cfg, offsets)
    mask = tmask[:, None, None]                           # [B,1,1,N,T]
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        q, rows = _chunk_pre_attn(x, p, pos.long()[:, None], cfg, offsets)
        write(l, rows)
        attn = _attend_masked(q, read(l), mask, cfg)         # [B, N, D]
        x = _block_post_attn(x, attn, p, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype).float()


@torch.no_grad()
def tree_verify_chunk_batched(params, cache, tokens, amask, depth, pos,
                              cfg: gpt.GPTConfig):
    """Score each slot's N-node token tree in one pass: tokens [B, N] int
    (node 0 the feed token, the rest in topological order), ``amask``
    [B, N, N] bool (ancestor-or-self) and ``depth`` [B, N] int — the
    topology, as data — and per-slot positions ``pos`` [B] (or one int)
    -> (logits [B, N, V] float32, cache).  Node j of slot b is stored at
    row pos_b + j, embedded and roped at pos_b + depth[b, j], and attends
    the rows before pos_b plus its own root path, so row j scores the
    continuation of that path and row 0 the plain step's.  All N rows are
    written unconditionally; those off the accepted path stay at or past
    the slot's pointer (a short tree pads with self-only mask rows).
    PRECONDITION pos_b + N <= the cache rows and the position table
    (:func:`_write_rows_batched`)."""
    B, N = tokens.shape
    T = cache["k"].shape[2]
    dev = tokens.device
    pos = _positions(pos, B, dev)
    dst = (torch.arange(B, device=dev) * T + pos.long())[:, None] \
        + torch.arange(N, device=dev)
    logits = _tree_forward(
        params, tokens, depth, pos, _tree_visibility(amask, pos, T),
        lambda l, rows: _write_rows_batched(_layer_cache(cache, l), rows,
                                            dst),
        lambda l: _layer_cache(cache, l), cfg)
    return logits, cache


def tree_verify_chunk(params, cache, tokens, amask, depth, pos0,
                      cfg: gpt.GPTConfig):
    """Score tokens [B, N] as a tree at one offset ``pos0`` for the whole
    batch: :func:`tree_verify_chunk_batched` with ``depth`` [1, N] and
    ``amask`` [1, N, N] shared by every row."""
    B, N = tokens.shape
    return tree_verify_chunk_batched(params, cache, tokens,
                                     amask.expand(B, N, N),
                                     depth.expand(B, N), pos0, cfg)


@torch.no_grad()
def tree_commit_rows(cache, src, pos):
    """The post-acceptance row permute of a tree round on the slab: per
    slot b, the rows at ``pos_b + src[b, i]`` move to ``pos_b + 1 + i``
    for i < M (src int [B, M], pos int [B] the round's positions).  Every
    row is gathered into a temporary before any is written, so the
    permute is alias-safe; identity entries rewrite themselves, and rows
    past the accepted path are stale either way.  In place, every layer
    at once; returns the cache.  PRECONDITION pos_b + M + 1 <= the cache
    rows."""
    B, M = src.shape
    T = cache["k"].shape[2]
    dev = src.device
    base = (torch.arange(B, device=dev) * T + pos.long())[:, None]
    src_i = (base + src.long()).reshape(-1)
    dst_i = (base + 1 + torch.arange(M, device=dev)).reshape(-1)
    for arr in cache.values():
        flat = arr.view((arr.shape[0], -1) + arr.shape[3:])
        flat.index_copy_(1, dst_i, flat.index_select(1, src_i))
    return cache


# ---------------------------------------------------------------------------
# sampling + generate
# ---------------------------------------------------------------------------


def _filter_logits(logits, temperature, top_k, top_p):
    """THE temperature -> top-k -> nucleus filter over [..., V] logits
    (the JAX package's formula).  temperature/top_k/top_p are scalars or
    tensors broadcasting over the leading dims; top_k == 0 and top_p == 1
    disable their stages; temperature == 0 leaves logits unscaled."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    dev = logits.device

    def bc(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev) \
            .broadcast_to(lead)[..., None]

    t = bc(temperature, torch.float32)
    tk = bc(top_k, torch.int64)
    tp = bc(top_p, torch.float32)
    x = torch.where(t > 0, logits / torch.clamp_min(t, 1e-6), logits)
    srt = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, torch.clamp(tk - 1, 0, V - 1))
    x = torch.where((tk > 0) & (x < kth), -1e30, x)
    srt2 = torch.sort(x, dim=-1, descending=True).values
    e = torch.exp(srt2 - srt2[..., :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    keep = torch.cumsum(probs, dim=-1) - probs < tp   # mass BEFORE the token
    kth_idx = keep.sum(dim=-1, keepdim=True) - 1
    cutoff = torch.gather(srt2, -1, kth_idx)
    return torch.where((tp < 1.0) & (x < cutoff), -1e30, x)


@torch.no_grad()
def generate(params, cfg: gpt.GPTConfig, prompt, max_new_tokens=32,
             temperature=0.0, top_k=0, top_p=1.0, generator=None,
             device=None):
    """prompt [B, P] int -> [B, P + max_new_tokens] int64 tokens on
    ``device`` (default the card; ``params`` must live there).  Greedy at
    temperature 0; otherwise temperature -> top-k -> nucleus sampling,
    drawn from ``generator`` (a ``torch.Generator`` on ``device``).  The
    prompt is fed token by token, as the JAX package's generate does.

    Runs through the step Engine's ``generate`` kind (``text/engine.py``)
    over a cache of the Engine's (``Engine.generate_binding``, one per
    config, batch and length; it holds ``params`` too, until
    ``Engine.purge(cfg)`` frees both): on the
    card one captured decode step, replayed once a position with the
    token and the position as device feeds.  The step ends at the logits,
    so the draw — the argmax, or the caller's generator, whose state no
    graph holds — runs outside the graph, on both paths alike."""
    from . import engine

    dev = resolve_device(device)
    if params["wte"].device != dev:
        raise ValueError(f"params live on {params['wte'].device}, "
                         f"generate was asked to run on {dev}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds cfg.max_seq_len {cfg.max_seq_len}")
    top_k = min(int(top_k), cfg.vocab_size)
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    bind = engine.ENGINE.generate_binding(params, cfg, B, total, dev)
    step = engine.ENGINE.get("generate", engine.StepSpec(
        cfg=cfg, extra=(int(max_new_tokens), top_k, float(top_p)),
        shape=(B, P), payload=bind))
    tokens = torch.zeros((B, total), dtype=torch.int64, device=dev)
    tokens[:, :P] = prompt
    positions = torch.arange(total, dtype=torch.int32, device=dev)
    with bind.lock:
        for pos in range(total - 1):
            (logits,) = step(tokens[:, pos], positions[pos])
            if pos + 1 < P:
                continue        # prompt positions keep their given token
            if temperature > 0.0:
                x = _filter_logits(logits, temperature, top_k, top_p)
                nxt = torch.multinomial(torch.softmax(x, dim=-1), 1,
                                        generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            tokens[:, pos + 1] = nxt
    return tokens


# ---------------------------------------------------------------------------
# beam search: width-W max-probability decoding
# ---------------------------------------------------------------------------

_NEG = -1e30


def _beam_step(params, cache, tok, pos, scores, alive, lengths,
               cfg: gpt.GPTConfig, eos_id):
    """One beam position over a [B * W] cache: decode ``tok`` [B * W] at
    ``pos``, expand every beam by the whole vocabulary and keep the W best
    of the W * V candidates per batch row; the cache's rows follow their
    parents.  scores float32 [B, W], alive bool [B, W], lengths int64
    [B, W].  Returns (scores, parent, new_tok, alive, lengths), each
    [B, W].

    Tie rule: ``jax.lax.top_k`` returns the lower index first among equal
    values, and ``torch.topk`` promises no order, so the candidates take a
    STABLE descending sort (equal candidates keep their index order) and
    the first W are kept.  The duplicate beams' -1e30 scores make their
    candidates tie in fp32 at the first expansion, which an exhaustive
    search (W = V ** m) keeps.

    The reorder gathers the cache's batch axis: ``index_select`` into a
    new tensor (inside a captured graph, a buffer of its private pool at
    a fixed address), then ``copy_`` back into the cache, which the
    Engine's graphs read by address."""
    BW = tok.shape[0]
    W = scores.shape[1]
    B, V = BW // W, cfg.vocab_size
    logits, _ = decode_step(params, cache, tok, pos, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
    if eos_id is not None:
        # a finished beam survives unexpanded: exactly one candidate
        # (continue with eos) at zero added score
        only_eos = torch.full((V,), _NEG, dtype=torch.float32,
                              device=logp.device)
        only_eos[eos_id] = 0.0
        logp = torch.where(alive[:, :, None], logp, only_eos)
    cand = (scores[:, :, None] + logp).reshape(B, W * V)
    top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    new_scores, idx = top[:, :W], idx[:, :W]
    parent = idx // V
    new_tok = idx % V
    flat = (torch.arange(B, device=tok.device)[:, None] * W
            + parent).reshape(-1)
    for arr in cache.values():
        arr.copy_(arr.index_select(1, flat))
    alive = torch.gather(alive, 1, parent)
    lengths = torch.gather(lengths, 1, parent)
    if eos_id is not None:
        lengths = torch.where(alive, lengths + 1, lengths)
        alive = alive & (new_tok != eos_id)
    else:
        lengths = lengths + 1
    return new_scores, parent, new_tok, alive, lengths


@torch.no_grad()
def beam_search(params, cfg: gpt.GPTConfig, prompt, max_new_tokens=32,
                num_beams=4, length_penalty: float = 0.0,
                eos_id: int | None = None, device=None):
    """Width-``num_beams`` beam search -> (tokens [B, P + max_new] int64,
    score [B] float32) on ``device`` (default the card; ``params`` must
    live there).

    Every beam shares the prompt, so the prompt feeds at beam-batch width
    and the cache is [B * W] from the start: its positions replay
    ``generate``'s decode step (the Engine's ``generate`` kind, at batch
    B * W), and each generated position replays the Engine's ``beam``
    kind — one captured :func:`_beam_step` on the card: the decode step,
    the W * V candidates, the stable sort and the cache's reorder.  The
    beams' token history is reordered outside the graph.  A finished beam
    (``eos_id``) survives through a single zero-delta eos candidate.
    ``length_penalty`` alpha divides each final score by its generated
    length ** alpha (0 = the plain sum of log-probabilities); with
    ``num_beams`` >= V ** max_new the search is exhaustive."""
    from . import engine

    dev = resolve_device(device)
    if params["wte"].device != dev:
        raise ValueError(f"params live on {params['wte'].device}, "
                         f"beam_search was asked to run on {dev}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt + max_new_tokens = {total} exceeds "
                         f"cfg.max_seq_len {cfg.max_seq_len}")
    W = int(num_beams)
    if W < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    BW = B * W
    bind = engine.ENGINE.generate_binding(params, cfg, BW, total, dev)
    feed = engine.ENGINE.get("generate", engine.StepSpec(
        cfg=cfg, extra=(int(max_new_tokens), 0, 1.0), shape=(BW, P),
        payload=bind))
    step = engine.ENGINE.get("beam", engine.StepSpec(
        cfg=cfg, extra=(int(max_new_tokens), W, float(length_penalty),
                        eos_id), shape=(B, P), payload=bind))
    toks = torch.zeros((B, W, total), dtype=torch.int64, device=dev)
    toks[:, :, :P] = prompt[:, None, :]
    wide = prompt.repeat_interleave(W, dim=0)              # [B * W, P]
    positions = torch.arange(total, dtype=torch.int32, device=dev)
    scores = torch.full((B, W), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0      # beam 0 seeds the search; its duplicates
    #                         start at -1e30, so the first expansion
    #                         yields W distinct continuations
    alive = torch.ones((B, W), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    with bind.lock:
        for pos in range(P - 1):
            feed(wide[:, pos], positions[pos])
        for pos in range(P - 1, total - 1):
            scores, parent, new_tok, alive, lengths = step(
                toks[:, :, pos].reshape(BW), positions[pos], scores,
                alive, lengths)
            toks = torch.gather(toks, 1,
                                parent[:, :, None].expand(B, W, total))
            toks[:, :, pos + 1] = new_tok
        norm = scores / lengths.clamp_min(1).float() ** float(length_penalty)
        best = torch.argmax(norm, dim=1)
        return toks[rows, best], norm[rows, best]


# ---------------------------------------------------------------------------
# speculative decoding: a draft proposes, the target verifies in one pass
# ---------------------------------------------------------------------------


def _filtered_probs(logits, temperature, top_k, top_p):
    """The sampling law of one [V] logit vector as a float64 numpy
    probability vector: :func:`_filter_logits` (the device sampler's
    formula) evaluated on the host in float64, then normalized — the p
    and q vectors of the rejection rule.  Without top-k and top-p the
    formula only scales (by the float32 temperature, as it divides), so
    its two sorts are skipped: the same bits."""
    x = np.asarray(logits, np.float64)
    if int(top_k) > 0 or float(top_p) < 1.0:
        x = _filter_logits(torch.as_tensor(x), float(temperature),
                           int(top_k), float(top_p)).numpy()
    elif temperature > 0:
        x = x / np.float64(np.maximum(np.float32(temperature),
                                      np.float32(1e-6)))
    e = np.exp(x - x.max())
    return e / e.sum()


def ngram_propose(sequence, k, max_order=3, window=256):
    """Model-free draft proposals: match the sequence's trailing n-gram
    (longest order first, down to one token) against its most recent
    earlier occurrence within the last ``window`` tokens and copy the
    continuation — prompt-lookup self-drafting, pure host work.  Returns
    k tokens (a short continuation padded by repeating its last token),
    or None when no order matches."""
    seq = list(sequence)
    n = len(seq)
    if n < 2:
        return None
    lo = max(0, n - int(window))
    for order in range(min(int(max_order), n - 1), 0, -1):
        tail = tuple(seq[n - order:])
        for s in range(n - order - 1, lo - 1, -1):
            if tuple(seq[s:s + order]) == tail:
                out = list(seq[s + order:s + order + k])
                while len(out) < k:
                    out.append(out[-1])
                return out
    return None


def ngram_propose_tree(sequence, nodes, branch=2, max_order=3, window=256):
    """Tree-shaped self-drafting: :func:`ngram_propose`'s search, but up
    to ``branch`` DISTINCT continuations (most recent and longest order
    first) merged into a prefix trie of at most ``nodes`` node slots, so
    the tree branches where the history disagrees about what comes next.
    Slot 0 is the feed token's (the caller's); the first continuation is
    the trunk, nodes 1..D, so a trunk-prefix acceptance moves no row.
    Returns ``(tokens, parent)`` — ``tokens[0]`` None, ``parent[0] ==
    -1``, parents before children — possibly shorter than ``nodes`` (the
    caller pads with self-only rows), or None when no order matches."""
    seq = list(sequence)
    n = len(seq)
    if n < 2:
        return None
    lo = max(0, n - int(window))
    cap = int(nodes) - 1                     # token-bearing node slots
    branch = max(1, int(branch))
    if cap < 1:
        return None
    conts, seen = [], set()
    for order in range(min(int(max_order), n - 1), 0, -1):
        tail = tuple(seq[n - order:])
        for s in range(n - order - 1, lo - 1, -1):
            if tuple(seq[s:s + order]) == tail:
                c = tuple(seq[s + order:s + order + cap])
                if c and c not in seen:
                    seen.add(c)
                    conts.append(list(c))
                    if len(conts) >= branch:
                        break
        if len(conts) >= branch:
            break
    if not conts:
        return None
    # the trunk is not padded, and leaves a slot for each alternate
    trunk = conts[0][:max(1, cap - (len(conts) - 1))]
    tokens, parent = [None], [-1]
    children = {0: {}}
    for i, t in enumerate(trunk):
        tokens.append(int(t))
        parent.append(i)
        children[i][int(t)] = i + 1
        children[i + 1] = {}
    for c in conts[1:]:                      # graft where they diverge
        cur = 0
        for t in c:
            t = int(t)
            nxt = children[cur].get(t)
            if nxt is None:
                if len(tokens) >= int(nodes):
                    break
                tokens.append(t)
                parent.append(cur)
                nxt = len(tokens) - 1
                children[cur][t] = nxt
                children[nxt] = {}
            cur = nxt
    return tokens, parent


def _spec_setup(tparams, tcfg, dparams, dcfg, prompt, max_new_tokens,
                device):
    """Checks and the prompt feed shared by both speculative bodies: both
    models fed the prompt token by token into caches of their own.
    Returns (prompt list, total, target cache, draft cache, the target's
    logits at the last prompt position [V])."""
    dev = resolve_device(device)
    for params, what in ((tparams, "target"), (dparams, "draft")):
        if params["wte"].device != dev:
            raise ValueError(f"{what} params live on {params['wte'].device}"
                             f", speculative_generate was asked to run on "
                             f"{dev}")
    prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
    if not prompt:
        raise ValueError("empty prompt")
    total = len(prompt) + int(max_new_tokens)
    if total > min(tcfg.max_seq_len, dcfg.max_seq_len):
        raise ValueError("prompt + max_new_tokens exceeds a model's window")
    t_cache = init_cache(tcfg, 1, total, dev)
    d_cache = init_cache(dcfg, 1, total, dev)
    t_logits = None
    for pos, t in enumerate(prompt):
        tok = torch.tensor([t], device=dev)
        t_logits, _ = decode_step(tparams, t_cache, tok, pos, tcfg)
        decode_step(dparams, d_cache, tok, pos, dcfg)
    return prompt, total, t_cache, d_cache, t_logits[0]


@torch.no_grad()
def speculative_generate(tparams, tcfg, dparams, dcfg, prompt,
                         max_new_tokens=32, k=4, temperature=0.0, top_k=0,
                         top_p=1.0, key=None, device=None):
    """Speculative decoding of one prompt: the DRAFT model proposes ``k``
    tokens a round (k decode steps), the TARGET scores them in one
    :func:`verify_chunk` pass.  Returns the generated tokens (no prompt)
    as a list.  Both models' params live on ``device`` (default the
    card) and share a vocabulary.

    Greedy (``temperature == 0``): the longest prefix on which the
    target's argmax agrees is accepted, and the target's own token is
    appended at the first disagreement — the output is exactly the
    target's greedy generation whatever the draft.  Sampled: each
    proposal is drawn from the draft's filtered law q and accepted with
    probability min(1, p/q) against the target's filtered law p; the
    first rejection draws from the residual (p - q)+ and ends the round,
    so every token's law is the target's.  The host draws come from one
    numpy generator seeded by ``key`` (an int, default 0) through
    ``rng.seed_key`` — deterministic per key; the JAX package's streams
    are not reproduced.

    Rejected rows in either cache stay behind the position pointer and
    are overwritten by the next round (after a rejection the draft's
    first stale row is exactly the next round's first feed)."""
    prompt, total, t_cache, d_cache, t_logits = _spec_setup(
        tparams, tcfg, dparams, dcfg, prompt, max_new_tokens, device)
    if temperature > 0.0:
        return _speculative_sample(
            tparams, tcfg, dparams, dcfg, prompt, int(max_new_tokens), k,
            float(temperature), min(int(top_k), tcfg.vocab_size),
            float(top_p), key, total, t_cache, d_cache, t_logits)
    dev = t_logits.device
    out = [int(torch.argmax(t_logits))]
    t_pos = len(prompt)         # target rows [0, t_pos) are final
    while len(out) < max_new_tokens:
        kk = min(k, max_new_tokens - len(out), total - 1 - t_pos)
        if kk <= 0:
            break
        draft = []
        cur = out[-1]
        for j in range(kk):
            dl, _ = decode_step(dparams, d_cache,
                                torch.tensor([cur], device=dev), t_pos + j,
                                dcfg)
            cur = int(torch.argmax(dl[0]))
            draft.append(cur)
        # row j scores the token after out[-1], draft[0..j-1]
        chunk = torch.tensor([[out[-1]] + draft[:-1]], device=dev)
        vl, _ = verify_chunk(tparams, t_cache, chunk, t_pos, tcfg)
        tchoice = torch.argmax(vl[0], dim=-1).tolist()
        for j in range(kk):
            out.append(tchoice[j])
            t_pos += 1
            if tchoice[j] != draft[j]:
                break           # the target's token wins; the round ends
    return out[:max_new_tokens]


def _speculative_sample(tparams, tcfg, dparams, dcfg, prompt,
                        max_new_tokens, k, temperature, top_k, top_p, key,
                        total, t_cache, d_cache, t_logits):
    """The rejection-sampling body of :func:`speculative_generate`: host
    control flow over fetched logit vectors, one numpy generator for the
    draft's draws, the acceptance tests and the resamples.  No bonus
    token is drawn on a fully accepted round (at most k tokens a round),
    which keeps the draft cache's stale-row invariant the greedy path's."""
    from .. import rng as _rng

    gen = np.random.default_rng(_rng.seed_key(0 if key is None
                                              else int(key)))
    dev = t_logits.device

    def law(row):
        return _filtered_probs(row.cpu().numpy(), temperature, top_k, top_p)

    def draw(p):
        return int(gen.choice(len(p), p=p))

    out = [draw(law(t_logits))]
    t_pos = len(prompt)
    while len(out) < max_new_tokens:
        kk = min(k, max_new_tokens - len(out), total - 1 - t_pos)
        if kk <= 0:
            break
        draft, qs = [], []
        cur = out[-1]
        for j in range(kk):
            dl, _ = decode_step(dparams, d_cache,
                                torch.tensor([cur], device=dev), t_pos + j,
                                dcfg)
            q = law(dl[0])
            cur = draw(q)
            draft.append(cur)
            qs.append(q)
        chunk = torch.tensor([[out[-1]] + draft[:-1]], device=dev)
        vl, _ = verify_chunk(tparams, t_cache, chunk, t_pos, tcfg)
        ps = [law(vl[0, j]) for j in range(kk)]
        for j in range(kk):
            x = draft[j]
            if gen.uniform() < min(1.0, ps[j][x] / max(qs[j][x], 1e-300)):
                out.append(x)
                t_pos += 1
                continue
            resid = np.maximum(ps[j] - qs[j], 0.0)
            mass = resid.sum()
            # a degenerate residual (q == p to rounding): draw from p
            out.append(draw(resid / mass) if mass > 0 else draw(ps[j]))
            t_pos += 1
            break
    return out[:max_new_tokens]
