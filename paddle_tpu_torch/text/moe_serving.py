"""MoE serving: joint-routing decode steps, device drop counters and the
capacity-free reference.

Counterpart of ``paddle_tpu/text/moe_serving.py``:

* **Joint-routing step bodies** (the Engine's ``moe_*`` kinds,
  ``text/engine.py``).  Attention is the dense step's, per slot; each
  layer's FFN tail runs once over the batch's B slot tokens with
  ``valid=act`` (the occupancy mask, a device feed: free and admitting
  slots claim no expert capacity) and ``capacity=None`` (the
  capacity-factor bound over B, not admission's dropless one).  The
  port's batched step already runs one [B, 1, D] post-attention call a
  layer, so the joint step is ``generate.decode_step`` /
  ``kv_pool.paged_decode_step_batched`` with those arguments.
* **Device-side drop accounting.**  Every step adds its routing delta
  (from the dispatch mask itself) into a ``{"dropped": int32 [],
  "load": int32 [E]}`` accumulator IN PLACE — the server's, bound to its
  graphs like the cache — so ``moe.dropped_tokens`` and
  ``moe.expert_load{expert=e}`` report what the device dropped.
  :func:`drain_drop_stats` publishes them.
* **The dense-eval reference** (:func:`dense_eval_decode_step`,
  :func:`dense_reference_greedy`): every expert computed for every
  token, mixed by the renormalized top-k gates — the capacity-free
  ground truth served tokens are held to.

At a dropless capacity factor (cf >= E / top_k, so C >= B) the joint
step's tokens equal per-slot solo routing, and every dispatch mode on
either layout equals the reference; below it batch-mates contend, and
a block (whose occupancy is frozen at dispatch) may differ from ticks.
* **Regex partition rules** (:func:`match_partition_rules`,
  :func:`moe_decode_rules`, :func:`moe_decode_param_specs`): the
  ``generate._decode_param_specs`` placements generalized to the
  ``blocks/moe/*`` leaves with an explicit ``ep`` axis — first matching
  regex wins, scalars replicate, no match is an error.  A spec is the
  port's tuple (``gpt.param_shardings``).  A tensor-parallel server
  (``DecodeServer(mesh=, ep_axis=)``) cuts its experts by them: each rank
  holds E/ep experts and F/mp of each one's FFN columns
  (``text/tp_serving.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device
from .. import telemetry as _telemetry
from ..distributed import sharding_rules
from . import generate, gpt, kv_pool, moe, woq


# -- regex partition rules -------------------------------------------------


def match_partition_rules(rules, tree, sep: str = "/"):
    """A spec per leaf of ``tree`` (nested dicts) by regex table:
    ``sharding_rules.match_sharding_rules``, strict, with the reference's
    scalar test (a 0-d leaf replicates before the table is consulted)
    and its error naming the leaf no rule covers."""
    return sharding_rules.match_sharding_rules(
        rules, tree, sep=sep, one_element=False,
        unmatched="no partition rule matches param {name!r} — extend "
                  "moe_decode_rules (silent replication would hide a "
                  "sharding bug)")


def moe_decode_rules(cfg: gpt.GPTConfig, mp: str | None = "mp",
                     ep: str | None = None) -> list:
    """The decode-param rule table: dense leaves carry exactly
    ``generate._decode_param_specs``'s placements (Megatron column / row,
    scales and LoRA pairs replicated, the vocab-parallel embedding) and
    the ``blocks/moe/*`` leaves ``moe.moe_param_shardings``'s with the
    caller's axes — ``ep=None`` replicates the expert dim (pure tensor
    parallel over an MoE model).  Scales and LoRA pairs match first, so
    ``w_in_s`` never takes ``w_in``'s spec."""
    l = None       # decode params have no pipeline axis
    return [
        (r"_s$", ()),
        (r"_lora_[ab]$", ()),
        (r"blocks/moe/router_w$", (l, None, None)),
        (r"blocks/moe/w_in$", (l, ep, None, mp)),
        (r"blocks/moe/b_in$", (l, ep, mp)),
        (r"blocks/moe/w_out$", (l, ep, mp, None)),
        (r"blocks/moe/b_out$", (l, ep, None)),
        (r"blocks/ln[12]_[gb]$", (l, None)),
        (r"blocks/qkv_w$", (l, None, None, mp)),
        (r"blocks/qkv_b$", (l, None, mp)),
        (r"blocks/q_w$", (l, None, mp)),
        (r"blocks/q_b$", (l, mp)),
        (r"blocks/kv_w$", (l, None, None, mp)),
        (r"blocks/kv_b$", (l, None, mp)),
        (r"blocks/proj_w$", (l, mp, None)),
        (r"blocks/proj_b$", (l, None)),
        (r"blocks/fc_w$", (l, None, mp)),
        (r"blocks/fc_b$", (l, mp)),
        (r"blocks/gate_w$", (l, None, mp)),
        (r"blocks/gate_b$", (l, mp)),
        (r"blocks/out_w$", (l, mp, None)),
        (r"blocks/out_b$", (l, None)),
        (r"^wte$", (mp, None)),
        (r"^wpe$", (None, None)),
        (r"^ln_f_[gb]$", (None,)),
    ]


def moe_decode_param_specs(params, cfg: gpt.GPTConfig, mp: str = "mp",
                           ep: str | None = None):
    """The spec tree of ``params`` resolved through
    :func:`moe_decode_rules` — on a dense model equal to
    ``generate._decode_param_specs`` leaf for leaf."""
    return match_partition_rules(moe_decode_rules(cfg, mp=mp, ep=ep),
                                 params)


# -- device-side routing stats ---------------------------------------------


def moe_stats_init(num_experts: int, device=None) -> dict:
    """The routing accumulator a server's MoE steps add into: cumulative
    dropped token->expert assignments and per-expert kept load, int32 on
    ``device``."""
    dev = resolve_device(device)
    return {"dropped": torch.zeros((), dtype=torch.int32, device=dev),
            "load": torch.zeros((int(num_experts),), dtype=torch.int32,
                                device=dev)}


def drain_drop_stats(stats, counted: int = 0, tel: bool = True):
    """Read the accumulator on the host and publish the ``moe.*``
    telemetry: ``moe.dropped_tokens`` counts the drops since the last
    drain (``counted``, the caller's high-water mark, so the counter is
    exact and monotone), ``moe.expert_load{expert=e}`` gauges each
    expert's cumulative kept assignments.  Returns ``(dropped_total,
    load_list)`` as host ints."""
    dropped = int(_host(stats["dropped"]).item())
    load = [int(v) for v in _host(stats["load"]).tolist()]
    if tel:
        delta = dropped - int(counted)
        if delta > 0:
            _telemetry.count("moe.dropped_tokens", delta)
        for e, n in enumerate(load):
            _telemetry.set_gauge(f"moe.expert_load{{expert={e}}}", n)
    return dropped, load


def _host(t):
    """A tensor, or a tensor-parallel server's replicated leaf read from
    its first rank (``tp_serving.ShardedTensor.fetch``)."""
    return t.fetch() if hasattr(t, "fetch") else t


def moe_decode_step_batched(params, cache, token, pos, act, stats,
                            cfg: gpt.GPTConfig):
    """``serving.decode_step_batched`` with joint expert routing: token
    [B], pos int32 [B], ``act`` [B] bool (the occupancy mask), ``stats``
    the :func:`moe_stats_init` accumulator (added to in place) ->
    (logits [B, V] float32, cache).  A pooled cache (a ``tables`` leaf)
    takes the block-table step."""
    ffn = dict(valid=act, capacity=None, stats=stats)
    if "tables" in cache:
        return kv_pool.paged_decode_step_batched(params, cache, token, pos,
                                                 cfg, **ffn)
    return generate.decode_step(params, cache, token, pos, cfg, **ffn)


def moe_sample_step_batched(params, cache, tok, pos, key, temp, topk, topp,
                            act, stats, cfg: gpt.GPTConfig):
    """The sampling twin: the joint step plus the shared per-slot sampler
    (``serving._sample_batched``, the dense path's key schedule) ->
    (tokens [B], cache)."""
    from . import serving

    logits, cache = moe_decode_step_batched(params, cache, tok, pos, act,
                                            stats, cfg)
    return serving._sample_batched(logits, key, temp, topk, topp), cache


def moe_decode_block_batched(params, cache, tok, pos, act, stats, k: int,
                             cfg: gpt.GPTConfig):
    """``k`` greedy joint-routing steps on the device, one host fetch
    (``serving.decode_block_batched``'s twin: positions held at the
    cache's last row past a request's end).  ``act`` is the occupancy at
    dispatch: a slot retiring mid-block keeps contending for capacity
    until the fetch.  Returns (tokens [B, k], cache)."""
    from . import serving

    lim = serving._row_limit(cache, cfg)
    pos = torch.clamp(pos, max=lim)
    toks = []
    for _ in range(k):
        logits, cache = moe_decode_step_batched(params, cache, tok, pos,
                                                act, stats, cfg)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        pos = torch.clamp(pos + 1, max=lim)
    return torch.stack(toks, dim=1), cache


# -- the dense-eval reference: every expert, gate-weighted -----------------


def _dense_eval_ffn_tail(x, p, cfg: gpt.GPTConfig):
    """The capacity-free MoE tail: every expert computed for every token
    and mixed by the renormalized top-k gate weights (the others exactly
    0).  At a dropless capacity the routed tail sums the same terms in
    another order."""
    mcfg = cfg.moe
    dt = x.dtype
    h = gpt._norm(x, p, "ln2", cfg)
    xf = h.reshape(-1, h.shape[-1])
    m = p["moe"]
    logits = xf.float() @ m["router_w"].float()
    w, idx, _ = moe._top_k_gating(logits, mcfg.top_k)
    onehot = idx[..., None] == torch.arange(mcfg.num_experts,
                                            device=x.device)
    wfull = (onehot * w[..., None]).sum(dim=1)                   # [N, E]
    # [E, N, F] and [E, N, D]: each expert's weights read in place
    he = F.gelu(torch.matmul(xf, woq.w(m, "w_in", dt))
                + m["b_in"].to(dt)[:, None], approximate="tanh")
    ye = torch.bmm(he, woq.w(m, "w_out", dt)) + m["b_out"].to(dt)[:, None]
    y = torch.einsum("ne,end->nd", wfull.to(dt), ye)
    return x + y.reshape(h.shape)


@torch.no_grad()
def dense_eval_decode_step(params, cache, token, pos, cfg: gpt.GPTConfig):
    """``generate.decode_step`` with the expert FFN densely evaluated:
    token [B] at ``pos`` (one int or an int [B] per slot) on a contiguous
    cache -> (logits [B, V] float32, cache), the rows at ``pos`` written
    in place.  Attention is the decode step's (MoE changes nothing above
    the FFN tail)."""
    if cfg.moe is None:
        raise ValueError("dense_eval_decode_step is the MoE reference — "
                         "use generate.decode_step for dense models")
    dt = cfg.dtype
    B = token.shape[0]
    pos = generate._positions(pos, B, token.device)
    x = generate._embed_step(params, token, pos, cfg)
    for l in range(cfg.num_layers):
        p = gpt.layer(params, l)
        csl = generate._layer_cache(cache, l)
        q3, rows = generate._block_pre_attn(x, p, pos, cfg)
        generate._write_rows(csl, rows, pos)
        attn = generate._attend_cache(q3, csl, pos, cfg)
        a = woq.mm(attn, p, "proj_w", dt) + p["proj_b"].to(dt)
        x = _dense_eval_ffn_tail(x + a, p, cfg)
    x = gpt._norm(x, params, "ln_f", cfg)
    return woq.logits(x, params, dt)[:, 0].float(), cache


@torch.no_grad()
def dense_reference_greedy(params, cfg: gpt.GPTConfig, prompt, max_new: int,
                           max_len: int, eos_id: int | None = None,
                           device=None) -> list:
    """Greedy continuation of ONE prompt under the dense-eval reference:
    a solo contiguous cache on ``device`` (default: the params') fed token
    by token — no batching, no paging, no Engine steps.  Returns the
    generated tokens (stopping at ``eos_id`` as the server does)."""
    dev = params["wte"].device if device is None else resolve_device(device)
    cache = generate.init_cache(cfg, 1, max_len, dev)
    toks = [int(t) for t in prompt]

    def step(t, i):
        return dense_eval_decode_step(
            params, cache, torch.tensor([t], device=dev), i, cfg)[0]

    for i in range(len(toks) - 1):
        step(toks[i], i)
    feed, pos = toks[-1], len(toks) - 1
    out: list = []
    for _ in range(int(max_new)):
        feed = int(torch.argmax(step(feed, pos)[0]))
        out.append(feed)
        pos += 1
        if eos_id is not None and feed == eos_id:
            break
    return out
