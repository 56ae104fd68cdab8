"""Autoregressive GPT generation over a contiguous KV cache.

Counterpart of ``paddle_tpu/text/generate.py`` for the serving slice:
the cache format (with the int8 ``k_s``/``v_s`` scale planes), the
single-position decode step, whole-prompt prefill, the logit filter, and
``generate``.  Where the JAX module scans over layers and returns a new
cache, this one loops over layers and **writes cache rows in place**
(``index_put_`` / slice assignment into the [L, B, T, ...] leaves): a
decode step writes each layer's fresh row before that layer attends the
cache, which is what the JAX step computes by splicing the row into its
copy.  The returned cache is the same dict that was passed in.

On a CUDA cache every cached-attention site runs the split-KV decode
kernel (``ops/decode_attention``) and prefill runs the flash kernel;
on the CPU they keep the reference's plain math.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gpt, woq
from .. import flags as _flags
from .. import resolve_device
from ..ops import decode_attention as da
from ..ops.attention import attention_array

__all__ = ["init_cache", "decode_step", "prefill_slot", "generate"]


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


def init_cache(cfg: gpt.GPTConfig, batch: int, max_len: int, device=None):
    """Per-layer K/V cache [L, B, T, Hkv, hd] with T = ``max_len`` rounded
    by :func:`_round_cache_len`, on ``device`` (default the card).
    ``PADDLE_TPU_KV_DTYPE`` selects the storage dtype; int8 caches carry
    per-(position, head) fp32 scale planes ``k_s``/``v_s`` [L, B, T, Hkv].
    A layer's slice ``cache[name][l]`` is contiguous, which is the form
    the decode kernel takes."""
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
    dt = cfg.dtype
    k_all, v_all = full["k"], full["v"]
    ks, vs = full.get("k_s"), full.get("v_s")
    if k_all.is_cuda:
        out = da.decode_attention(q.contiguous(), k_all, v_all, pos,
                                  k_scale=ks, v_scale=vs)
        return out.to(dt).reshape(B, Tq, H * hd)
    if ks is not None:
        k_all = da.dequantize_kv(k_all, ks, dt)
        v_all = da.dequantize_kv(v_all, vs, dt)
    k_all = k_all.to(dt)
    v_all = v_all.to(dt)
    T, Hkv = k_all.shape[1], k_all.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Tq, Hkv, g, hd)
    scores = torch.einsum("bikgd,btkd->bkgit", qg, k_all) \
        / torch.tensor(hd, dtype=torch.float32).sqrt().to(dt)
    t = torch.arange(T, device=q.device)
    i = torch.arange(Tq, device=q.device)
    mask = t <= pos.reshape(B, 1, 1, 1, 1) + i[:, None]     # [B,1,1,Tq,T]
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


def _block_post_attn(x, attn, p, cfg: gpt.GPTConfig):
    """Post-attention half: output projection + residual + dense FFN."""
    dt = cfg.dtype
    a = woq.mm(attn, p, "proj_w", dt) + p["proj_b"].to(dt)
    return gpt._ffn_dense(x + a, p, cfg)


def _write_rows(csl: dict, rows: dict, pos) -> None:
    """Write one decode step's rows (leaves [B, Hkv(, hd)]) into a layer's
    cache leaves [B, T, ...] at each slot's position — IN PLACE."""
    B = pos.shape[0]
    b = torch.arange(B, device=pos.device)
    for name, val in rows.items():
        arr = csl[name]
        arr.index_put_((b, pos.long()), val.to(arr.dtype))


def _cached_block(x, p, csl, pos, cfg: gpt.GPTConfig):
    """One block on a single position [B, 1, D] against one layer's cache
    ``csl``: the fresh rows are written in place at ``pos`` first (in
    storage form, so this step attends exactly what later steps read
    back, int8 included), then the layer attends its cache."""
    q3, rows = _block_pre_attn(x, p, pos, cfg)
    _write_rows(csl, rows, pos)
    attn = _attend_cache(q3, csl, pos, cfg)            # [B, 1, D]
    return _block_post_attn(x, attn, p, cfg)


@torch.no_grad()
def decode_step(params, cache, token, pos, cfg: gpt.GPTConfig):
    """token [B] int at position ``pos`` — one int for the whole batch or
    an int [B] per slot — -> (logits [B, V] float32, cache).  The cache
    rows at ``pos`` are written in place."""
    B = token.shape[0]
    pos = _positions(pos, B, token.device)
    x = _embed_step(params, token, pos, cfg)
    for l in range(cfg.num_layers):
        x = _cached_block(x, gpt.layer(params, l), _layer_cache(cache, l),
                          pos, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, cfg.dtype)[:, 0].float(), cache


# ---------------------------------------------------------------------------
# whole-prompt prefill
# ---------------------------------------------------------------------------


def _prefill_block(x, p, cfg: gpt.GPTConfig):
    """One block over a padded prompt [B, P, D] with within-prompt causal
    attention (the cache is empty at prefill), returning (x, rows) —
    storage-dtype row leaves [B, P, Hkv(, hd)] for the caller to merge.
    Attention reads the STORAGE view of the fresh rows, so under int8 the
    admission path sees exactly what later decode steps read back."""
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
    attn = attention_array(q, k_att, v_att, is_causal=True).reshape(B, P, D)
    a = woq.mm(attn, p, "proj_w", dt) + p["proj_b"].to(dt)
    return gpt._ffn_dense(x + a, p, cfg), rows


def _merge_slot_rows(csl: dict, rows: dict, slot: int, pos0: int,
                     length: int) -> None:
    """Write the first ``length`` rows of a prompt chunk (leaves
    [1, P, ...]) into one slot's rows [pos0, pos0 + length) of a layer's
    cache — IN PLACE.  Pad rows are not written: the old tenant's rows
    past ``length`` stay hidden by the causal mask until overwritten."""
    for name, val in rows.items():
        arr = csl[name]
        arr[slot, pos0:pos0 + length] = val[0, :length].to(arr.dtype)


@torch.no_grad()
def prefill_slot(params, cache, tokens, length: int, slot: int,
                 cfg: gpt.GPTConfig):
    """Process one request's whole (padded) prompt in a single pass.

    tokens [1, P] int padded to P; ``length`` = valid prompt tokens;
    ``slot`` = batch row of the serving cache.  Writes that slot's cache
    rows [0, length) in place and returns (logits at position length-1
    [V] float32, cache)."""
    dt = cfg.dtype
    P = tokens.shape[1]
    x = woq.embed(params, tokens, dt)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][:P].to(dt)[None]
    for l in range(cfg.num_layers):
        x, rows = _prefill_block(x, gpt.layer(params, l), cfg)
        _merge_slot_rows(_layer_cache(cache, l), rows, slot, 0, length)
    last = gpt._norm(x[:, length - 1:length], params, "ln_f", cfg)
    return woq.logits(last, params, dt)[0, 0].float(), cache


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
    prompt is fed token by token through :func:`decode_step`, as the JAX
    package's generate does."""
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
    cache = init_cache(cfg, B, total, dev)
    tokens = torch.zeros((B, total), dtype=torch.int64, device=dev)
    tokens[:, :P] = prompt
    for pos in range(total - 1):
        logits, cache = decode_step(params, cache, tokens[:, pos], pos, cfg)
        if pos + 1 < P:
            continue            # prompt positions keep their given token
        if temperature > 0.0:
            x = _filter_logits(logits, temperature, top_k, top_p)
            nxt = torch.multinomial(torch.softmax(x, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        tokens[:, pos + 1] = nxt
    return tokens
