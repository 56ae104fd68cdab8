"""Continuous-batching decode server (slot scheduler over the KV cache).

Counterpart of ``paddle_tpu/text/serving.py`` for the serving slices:
one resident KV cache for ``max_batch`` slots; requests join and leave
mid-flight; each tick is ONE batched decode step over every slot with
its own position; a freed slot is reused without clearing (the causal
mask ``t <= pos`` hides stale rows until they are overwritten).

    srv = DecodeServer(params, cfg, max_batch=8, max_len=256, eos_id=2)
    rid = srv.submit([5, 3, 9], max_new_tokens=32)
    while srv.pending():
        srv.tick()              # or srv.tick_block(8)
    tokens = srv.result(rid)

Every step runs through the step Engine (``text/engine.py``): on the card
each decode step is captured once as a CUDA graph bound to this server's
buffers and replayed at every tick; on the CPU it runs its plain
callable.  Dispatch modes, as in the JAX server:

* ``tick()`` — one step, one device->host fetch of the tokens;
* ``tick_block(k)`` — k steps on the device, each argmax (or draw) fed
  back on the device, one fetch of a [B, k] block; slots still feeding
  their prompt fall back to single ticks, and tokens past a request's
  end are discarded;
* ``async_dispatch=True`` — one step (or block) in flight: each tick
  dispatches step N+1, feeding step N's tokens from the device, before it
  fetches step N's.  Host feeds go through pinned memory without
  blocking; each dispatch's tokens are copied out to pinned memory
  before the next replay overwrites the graph's output.

Sampling draws from a counter-based stream keyed (seed, step number)
— the JAX server's ``fold_in(base_key, n)`` schedule — so a slot's draws
are the same under tick, tick_block, async dispatch, eager steps or
graphs, and ``warmup`` (which advances no counter) changes nothing.

Two cache layouts (``layout=``, default ``PADDLE_TPU_KV_LAYOUT``):

* ``"contiguous"`` — one slab, every slot provisioned for ``max_len``
  rows.  Admission prefills the whole prompt in one pass at a
  power-of-two bucket (``generate.prefill_slot``, the flash kernel on the
  card) or, with ``prefill_chunk=N``, in fixed N-token chunks
  (``generate.prefill_slot_chunk``); ticks run the split-KV decode
  kernel.
* ``"paged"`` — a pool of ``block_size``-row blocks shared by all slots
  through block tables (``text/kv_pool.py``): blocks are allocated as a
  slot's position crosses block boundaries (ahead of a block dispatch,
  every row it may write), prompts adopt the longest indexed prefix of
  earlier prompts (refcounted, copied on write), and admission is always
  chunked (``kv_pool.paged_prefill_chunk``) starting past the adopted
  rows; ticks run the block-table decode kernel.  When the pool runs
  dry, admission evicts cold prefix entries and otherwise parks the
  request at the queue front until blocks free.

Admission runs through the Engine as well: one graph per prompt bucket
or chunk width, fed the tokens, the offset, the length and the slot as
device tensors.  ``prefill_budget=N`` (``PADDLE_TPU_PREFILL_BUDGET``)
makes it stall-free, as the JAX server's budgeted admission: a prompt
longer than N claims its slot without a prefill, and each scheduler round
(``tick``, ``tick_block``, async) runs one N-wide chunk of the oldest
admitting slot before its decode step; the admitting slot rides the
decode steps at its prefill frontier (that row is rewritten by its next
chunk) and samples nothing until its last chunk graduates it.  Greedy
tokens are those of monolithic admission; only the schedule changes.

Under pressure and failure, as the JAX server (``PADDLE_TPU_RESILIENCE``,
on by default; ``0`` fails fast):

* **deadlines** — ``submit(ttl_s=)`` (default ``PADDLE_TPU_REQUEST_TTL_S``)
  bounds a request's wait in the queue; past it the request is shed with
  the ``timeout`` status and ``result()`` raises ``DeadlineExceeded``;
* **the OOM ladder** — an allocator OOM in a tick (a real
  ``torch.cuda.OutOfMemoryError``, the paged pool running dry, or an
  injected ``oom`` fault) retries the tick after one rung of relief, in
  order: evict (or, with ``PADDLE_TPU_KV_SPILL_MB``, spill to host
  memory) cold prefix-cache blocks; async -> sync dispatch; halve the
  admitted batch; evict the lowest-priority slot back to the queue with
  its progress carried (an admitting slot with its original prompt) —
  at most ``PADDLE_TPU_EVICT_REQUEUE_MAX`` times a request;
* **the spill tier** (paged) — cold prefix chains demoted to pinned host
  memory come back at their next match through the graphed ``inject``
  step instead of a recompute (``text/kv_pool.py``);
* **the wedge watchdog** — with ``PADDLE_TPU_STEP_BUDGET_S`` > 0 the async
  fetch runs under a wall budget; past it the server is marked
  ``wedged``, the dispatches in flight are cancelled and their steps
  decoded again (:meth:`DecodeServer._recover_wedge`);
* **the NaN guard** — a request whose admission logits (or, with
  ``PADDLE_TPU_NAN_GUARD_SERVING=1`` or a fault installed, greedy tick
  logits) are not finite fails with the ``error`` status; the server
  lives on.

Admission control (``text/admission.py``, ``PADDLE_TPU_ADMISSION``, on by
default; ``0`` builds no controller), as the JAX server's:

* **at the door** — ``submit(tenant=)`` charges the tenant's token bucket
  (``PADDLE_TPU_TENANT_RATE``); a request its bucket cannot cover, or a
  lowest-class request while the ladder sheds, retires ``rejected`` at
  once and ``result()`` raises ``resilience.Overloaded``;
* **bounded class queues** — ``PADDLE_TPU_ADMISSION_QUEUE_CAP`` bounds each
  priority class's queue (<= 0 low, 1 normal, >= 2 high); an over-cap
  class sheds its newest entry;
* **the SLO ladder** — each scheduler round runs the controller's control
  tick: a window (``PADDLE_TPU_SLO_WINDOW_S``) whose p99 TTFT or decode
  gap breaches ``PADDLE_TPU_SLO_TTFT_MS`` / ``PADDLE_TPU_SLO_TPOT_MS``
  climbs one rung — class-0 admit cap halved, the prefill budget down to
  the next of ``admission.ladder_widths`` (captured by ``warmup``, so a
  move never captures a graph mid-serve), then shed — and healthy windows
  step back down.  A configured controller admits the highest class
  first (FIFO within a class); an unconfigured one keeps strict FIFO.

Faults are injected by ``PADDLE_TPU_FAULTS`` (``paddle_tpu_torch/
faults.py``) at the JAX server's sites, and every event is counted in
the telemetry registry (``paddle_tpu_torch/telemetry.py``) under the
JAX server's counter names.  ``metrics_port=`` serves that registry over
HTTP (``/metrics``, ``/snapshot``, ``/healthz``); each request carries a
trace context, and its prefill, decode and retire spans go to the
server's span ring (``load_stats(include_spans=True)``,
:meth:`DecodeServer.drain_spans`).

Linear speculative decoding, as the JAX server's (``spec_k=K``, default
``PADDLE_TPU_SPEC_K``; 0 = off): each round proposes K - 1 tokens per slot
— from a draft model (``draft_cfg``/``draft_params``, whose cache is a
twin of the target's: on the paged layout a second pool walked through
the same block tables) or, without one, from the sequence itself
(``generate.ngram_propose``) — and scores them with ONE target pass, the
graphed ``spec_verify`` step (K rows a slot; on the card one launch of
the decode kernel a block).  Greedy slots keep the longest agreeing
prefix plus the target's own token, so the streams are the plain
server's; sampled slots take the rejection rule, so every token's law is
the target's.  Slots whose rolling acceptance falls below
``PADDLE_TPU_SPEC_MIN_ACCEPT`` fall back to plain rounds and re-earn
speculation after a cooldown; near the window, while a slot feeds its
prompt or admits, and from the admission ladder's spec-off rung on (for
new claims), the server runs plain ticks.

Tree speculation, as the JAX server's (``spec_tree=N``, default
``PADDLE_TPU_SPEC_TREE``; exclusive with ``spec_k``): each round proposes
a token tree of at most N nodes per slot, node 0 the feed token — the
draft's argmax trunk with its top-b alternates
(``PADDLE_TPU_SPEC_BRANCH``) fanned out where the draft was least sure,
or an n-gram trie (``generate.ngram_propose_tree``) — and scores every
node with ONE graphed ``spec_tree_verify`` pass under a tree mask fed as
data.  Acceptance walks the tree from the root on the host (greedy: the
target's argmax path; sampled: per-node multi-candidate rejection, so
the law stays the target's); a path that leaves the trunk moves its rows
into place with one graphed ``spec_tree_commit``.  Fallback, re-earn and
the window's edge are the linear round's, counted in path lengths.

MoE models (``cfg.moe``, ``text/moe_serving.py``), as the JAX server
serves them: each decode step routes the batch's slot tokens jointly —
the ``moe_*`` Engine kinds, fed the occupancy mask (free and admitting
slots claim no expert capacity; prompt-feeding slots do) under the
configured capacity factor — and adds its routing delta into a device
accumulator bound to the server's graphs; ``load_stats()`` drains it
(``moe_dropped_tokens``, ``moe_expert_load``, and the ``moe.*``
telemetry), as does ``close()``.  Admission routes under the pad mask
at the dropless capacity (``moe_prefill``, ``moe_prefill_chunk``,
``moe_paged_prefill``).  A sampled MoE ``tick_block`` runs stepwise; an
async MoE server takes stepwise ``moe_async`` ticks, never a block.
Speculation with an MoE target or draft, ``adapter_pool`` and
``constraint=`` on an MoE server are refused at the door, in the JAX
server's words.

Multi-tenant serving (``text/adapters.py``), as the JAX server's: with
``adapter_pool=`` every step — tick, block, async, verify, each admission
— runs its ``adapter_*`` twin, fed the per-slot adapter ids, and adds
each slot's rank-r LoRA term to the base matmuls (id 0 is the base
model: the same tokens as a pool-less server); ``submit(adapter=)``
names the adapter (or the tenant's default does), and a prompt under an
adapter neither adopts nor indexes prefix-cache rows.
``submit(constraint=)`` decodes under a token-set, regex or JSON-schema
automaton advanced on the host: each tick feeds the [B, V] mask of its
allowed sets to the sampling step (``masked_step`` without a pool,
``adapter_sample`` with one), the admission token is drawn from the
masked row, an exhausted automaton retires its slot, and a constrained
batch runs synchronous steps — async and block dispatch drain to single
ticks (``constraint.sync_fallbacks``), linear speculation to plain ones
(``constraint.spec_fallbacks``), while tree speculation prunes the
banned branches and masks its acceptance.

The fleet's entries (``text/fleet.py``, as the JAX server's): a prefill
worker's rows join a request through :meth:`DecodeServer.submit_prefilled`
(or ``adopt_request`` on a router's dict carrying them) and stream in
chunk by chunk through ``stream_prefilled_begin`` / ``_rows`` / ``_abort``
— a streamed slot rides the decode steps at its injected frontier, as a
budgeted one does — each written into its slot by the graphed ``inject``
step (contiguous: the masked merge; paged: through the block table after
adopting the indexed prefix), and the first token drawn as local
admission draws it; ``drain_queue`` hands queued work back to a router,
``adopt_request`` takes it (the window and the pool checked again), and
``local_snapshot`` gives the router this server's own histograms and
totals.  Rows from a worker on another CUDA stream come with the event
they are final at (``ready``), which the injection waits on.

Tensor and expert parallelism are later slices' work; no entry point of
the port reaches them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import admission as _admission
from . import engine, generate, gpt, kv_pool, moe_serving
from .. import faults as _faults
from .. import flags as _flags
from .. import resilience as _resilience
from .. import resolve_device, rng
from .. import telemetry as _telemetry

__all__ = ["decode_step_batched", "sample_step_batched",
           "decode_block_batched", "sample_block_batched",
           "spec_verify_batched", "spec_tree_verify_batched",
           "spec_tree_commit_batched", "DecodeServer", "validate_request"]


# cold prefix-cache entries evicted per relief round when the pool runs dry
# (LRU-first batches; never the whole index at once)
_EVICT_BATCH = 4
# the totals a server keeps of its own for the fleet's metrics plane
_LOCAL_COUNTERS = ("serving.tokens_generated", "serving.requests_completed")
# admission draws use counters from here up (one per request id), clear of
# the per-step counters of the device steps
_ADMIT_COUNTER = 1 << 40
# the speculative rounds' host draws: one numpy generator per request,
# seeded from here up (the JAX server's fold_in(base, (1 << 21) + rid))
_SPEC_COUNTER = 1 << 41
# an MoE server's twin of each kind it dispatches (the decode kinds take
# the occupancy mask as their last feed)
_MOE_KINDS = {"step": "moe_step", "sample": "moe_sample",
              "block": "moe_block", "async": "moe_async",
              "prefill": "moe_prefill", "prefill_chunk": "moe_prefill_chunk",
              "paged_prefill": "moe_paged_prefill"}
# a pool-attached server's twin of each kind it dispatches (each takes the
# adapter ids as its first feed; ``sample`` also the [B, V] mask last)
_ADAPTER_KINDS = {"step": "adapter_step", "sample": "adapter_sample",
                  "block": "adapter_block", "async": "adapter_async",
                  "spec_verify": "adapter_spec_verify",
                  "prefill": "adapter_prefill",
                  "prefill_chunk": "adapter_prefill_chunk",
                  "paged_prefill": "adapter_paged_prefill"}


def decode_step_batched(params, cache, token, pos, cfg: gpt.GPTConfig):
    """decode_step with PER-SLOT positions: token [B], pos int32 [B].
    The port's decode step takes per-slot positions directly (the JAX
    package vmaps its scalar-position step instead).  A pooled cache (a
    ``tables`` leaf marks the paged layout) routes to the block-table
    twin, ``kv_pool.paged_decode_step_batched``."""
    if "tables" in cache:
        return kv_pool.paged_decode_step_batched(params, cache, token, pos,
                                                 cfg)
    return generate.decode_step(params, cache, token, pos, cfg)


def spec_verify_batched(params, cache, tokens, pos, cfg: gpt.GPTConfig):
    """The speculative round's target pass: tokens [B, K] int fed at
    per-slot positions [pos_b, pos_b + K) (pos int32 [B]) -> (logits
    [B, K, V] float32, cache).  Column 0 is each slot's feed token,
    columns 1..K-1 its proposals; row 0 is the plain decode step's logits.
    Routed by layout: ``generate.verify_chunk_batched`` on the slab,
    ``kv_pool.paged_verify_chunk_batched`` through the block tables.
    Every slot's K rows are written unconditionally (rejected rows stay
    behind its position pointer)."""
    if "tables" in cache:
        return kv_pool.paged_verify_chunk_batched(params, cache, tokens, pos,
                                                  cfg)
    return generate.verify_chunk_batched(params, cache, tokens, pos, cfg)


def spec_tree_verify_batched(params, cache, tokens, amask, depth, pos,
                             cfg: gpt.GPTConfig):
    """The tree round's target pass: tokens [B, N] int (column 0 each
    slot's feed token, the tree's root; columns 1.. its proposed nodes in
    topological order), the topology as data — ancestor-or-self ``amask``
    [B, N, N] bool and ``depth`` [B, N] int — and per-slot positions
    ``pos`` int32 [B] -> (logits [B, N, V] float32, cache).  Row j scores
    the continuation of node j's root path, so row 0 is the plain step's
    logits, and a chain tree scores what ``spec_verify_batched`` does.
    Routed by layout: ``generate.tree_verify_chunk_batched`` on the slab,
    ``kv_pool.paged_tree_verify_chunk_batched`` through the block tables,
    one tree body for both.  All N rows a slot are written; those off the
    accepted path stay behind its position pointer."""
    if "tables" in cache:
        return kv_pool.paged_tree_verify_chunk_batched(
            params, cache, tokens, amask, depth, pos, cfg)
    return generate.tree_verify_chunk_batched(params, cache, tokens, amask,
                                              depth, pos, cfg)


def spec_tree_commit_batched(cache, src, pos):
    """The tree round's row permute: each slot's accepted-path rows
    (``src`` [B, N - 1] node indices, identity where nothing moves) go to
    rows [pos_b + 1, pos_b + N), where their committed positions put
    them.  Routed by layout like the verify; in place, cache only."""
    if "tables" in cache:
        return kv_pool.paged_tree_commit(cache, src, pos)
    return generate.tree_commit_rows(cache, src, pos)


# -- the sampling stream: counter-based, keyed (seed, step) ----------------
# Gumbel noise hashed from (seed key, step counter, element) by the port's
# counter-based helper (``paddle_tpu_torch/rng.py``): no generator state, so
# a replayed graph draws what the eager step draws.


def _sample_batched(logits, key, temp, topk, topp, mask=None):
    """Per-slot sampling over batched logits [B, V]: temperature, top-k,
    nucleus (generate._filter_logits) with PER-SLOT parameters, so one
    step serves a batch mixing greedy and sampled requests; the draw is
    the Gumbel-max of the filtered logits under ``key``'s noise (exactly
    a categorical draw from their softmax).  temp/topp float32 [B], topk
    int [B] (0 = off); slots with temp == 0 take the argmax of the raw
    logits.  ``mask``: the additive constraint mask [B, V] float32 (0
    allowed, ``adapters.NEG_INF`` banned), added before both branches, so
    greedy slots take the masked argmax; an all-zero row is exactly the
    unconstrained math."""
    if mask is not None:
        logits = logits + mask
    scaled = generate._filter_logits(logits, temp, topk, topp)
    noise = rng.gumbel(key, scaled.shape, scaled.device)
    sampled = torch.argmax(scaled.float() + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)


def _step_key(key, j: int):
    """The key of step n + j from the key of step n (on the device)."""
    return torch.stack([key[0], key[1] + j])


def sample_step_batched(params, cache, tok, pos, key, temp, topk, topp,
                        cfg: gpt.GPTConfig, mask=None):
    """One batched decode step that returns sampled TOKENS [B] (greedy
    where temp == 0) instead of logits.  ``mask`` (optional [B, V]
    additive constraint mask, see :func:`_sample_batched`) rides through
    to the sampler."""
    logits, cache = decode_step_batched(params, cache, tok, pos, cfg)
    return _sample_batched(logits, key, temp, topk, topp, mask=mask), cache


def _row_limit(cache, cfg: gpt.GPTConfig) -> int:
    """The last position a step may write: the cache's rows (the slab's,
    or the block tables' reach) and the position table's."""
    rows = (cache["tables"].shape[1] * cache["k"].shape[2]
            if "tables" in cache else cache["k"].shape[2])
    return min(rows, cfg.max_seq_len) - 1


def decode_block_batched(params, cache, tok, pos, k: int,
                         cfg: gpt.GPTConfig):
    """``k`` greedy decode steps on the device, each argmax fed back as
    the next step's token — a Python loop of steps inside one capture,
    where the JAX package scans.  tok/pos [B] are the next token to feed
    and its position per slot.  Returns (tokens [B, k], cache).  A slot
    whose request ends mid-block keeps decoding (the
    caller discards its surplus); its positions are held at the cache's
    last row, whose rows it owns and no mask exposes."""
    lim = _row_limit(cache, cfg)
    pos = torch.clamp(pos, max=lim)
    toks = []
    for _ in range(k):
        logits, cache = decode_step_batched(params, cache, tok, pos, cfg)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        pos = torch.clamp(pos + 1, max=lim)
    return torch.stack(toks, dim=1), cache


def sample_block_batched(params, cache, tok, pos, key, temp, topk, topp,
                         k: int, cfg: gpt.GPTConfig):
    """``k`` sampled decode steps on the device, one host fetch — the
    sampling twin of :func:`decode_block_batched`.  Step j draws with the
    key of step n + j (``key`` is step n's), the schedule of the per-tick
    path, so tick and tick_block draw the same tokens.  Returns (tokens
    [B, k], cache)."""
    lim = _row_limit(cache, cfg)
    pos = torch.clamp(pos, max=lim)
    toks = []
    for j in range(k):
        logits, cache = decode_step_batched(params, cache, tok, pos, cfg)
        tok = _sample_batched(logits, _step_key(key, j), temp, topk, topp)
        toks.append(tok)
        pos = torch.clamp(pos + 1, max=lim)
    return torch.stack(toks, dim=1), cache


def _name(fn):
    """An Engine step's name, for the device feed's per-step walls (None
    for a bare callable standing in for one)."""
    return getattr(fn, "name", None)


def _token_at(st: dict, i: int) -> int:
    """The token a request's sequence holds at position ``i``: its prompt
    inside it, its generated tail after (``base`` — the original prompt
    length — differs from len(prompt) only for an evicted request
    re-admitted with its progress carried)."""
    return st["prompt"][i] if i < len(st["prompt"]) \
        else st["generated"][i - st["base"]]


def _hits_stop(st: dict) -> bool:
    gen = st["generated"]
    return any(len(gen) >= len(seq) and gen[-len(seq):] == seq
               for seq in st["stop"])


def _pow2_bucket(n: int, *bounds) -> int:
    """Smallest power of two >= ``n``, clamped to the given upper bounds —
    THE prompt-bucket rule."""
    b = 1
    while b < n:
        b *= 2
    return min(b, *bounds) if bounds else b


def validate_request(prompt, max_new_tokens, stop, temperature, top_k,
                     top_p, ttl_s, *, window, vocab_size, default_ttl):
    """THE request-validation rules.  Returns the normalized
    ``(prompt, stop, ttl, top_k)``."""
    prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
    if not prompt:
        raise ValueError("empty prompt")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    total = len(prompt) + max_new_tokens
    if total > window:
        raise ValueError(
            f"prompt+max_new_tokens {total} exceeds serving window "
            f"{window}")
    if any(not 0 <= t < vocab_size for t in prompt):
        raise ValueError(f"prompt token out of range [0, {vocab_size})")
    stop = [[int(t) for t in seq] for seq in (stop or [])]
    if any(not seq for seq in stop):
        raise ValueError("empty stop sequence")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    ttl = default_ttl if ttl_s is None else float(ttl_s)
    if ttl is not None and ttl <= 0:
        raise ValueError(f"ttl_s must be > 0, got {ttl}")
    return prompt, stop, ttl, min(int(top_k), vocab_size)


class DecodeServer:
    """Host-side slot scheduler around one batched decode step.

    Greedy by default; per-request ``temperature``/``top_k``/``top_p``
    sample with per-slot parameters from the counter-based stream of
    ``seed`` (module note).  With ``prefill=True`` admission computes the
    prompt before the slot joins the ticks (one bucket-padded
    ``generate.prefill_slot`` pass; fixed ``prefill_chunk``-token chunks;
    or, paged, chunks after the adopted prefix) and ticks only generate;
    with ``prefill=False`` prompts are fed token by token through the
    tick step.  ``layout``/``block_size``/``num_blocks`` pick the cache
    layout (module note; ``num_blocks`` defaults to full provisioning).
    ``async_dispatch=True`` keeps one step or block in flight (module
    note).  ``prefill_budget=N`` (default ``PADDLE_TPU_PREFILL_BUDGET``,
    0 = off; clamped to the serving window) admits prompts longer than N
    in N-token chunks interleaved with the decode steps (module note).
    ``device`` defaults to the card; ``params`` must live there.
    ``spec_k`` (default ``PADDLE_TPU_SPEC_K``; 4 when only ``draft_cfg``
    is given) turns on linear speculation (module note) with the draft
    model ``draft_cfg``/``draft_params`` (same vocabulary, a window
    covering the server's, params on the same device) or, without one,
    n-gram self-drafting; ``spec_tree`` (default ``PADDLE_TPU_SPEC_TREE``,
    exclusive with ``spec_k``) turns on tree speculation instead (module
    note) with the same drafters; both are refused on an MoE target or
    draft.  ``adapter_pool`` (``adapters.AdapterPool`` over these params'
    config, on the server's device) serves LoRA adapters per request
    (module note); it is refused on an MoE model, with ``spec_tree``, for
    another config, and on params that already carry lora leaves, in the
    JAX server's words.  The resilience switches (TTLs, the OOM ladder,
    the spill tier, the wedge watchdog, the NaN guard: module note) and
    admission control's (``PADDLE_TPU_ADMISSION`` and its knobs) are read
    from the environment at construction.  ``mesh`` (a
    ``distributed.serving_mesh.ServingMesh``, exclusive with ``device``)
    splits the model over the mesh's ranks (``text/tp_serving.py``):
    weights and the KV cache's Hkv axis over ``mp_axis``, an MoE model's
    experts over ``ep_axis`` when given (refused without a mesh, on a dense
    config, or where it does not divide the experts), every step run on
    every rank; ``params`` then may live anywhere (they are cut on the host)
    or be a tree already cut over the mesh (``tp_serving.shard_params``),
    and ``cache`` / ``params`` are the ranks' handles.  ``metrics_port`` starts the telemetry endpoint
    (``telemetry.serve_metrics``; 0 takes a free port,
    ``self.metrics_server.port``), closed with the server.  A server is a
    context manager: leaving the ``with`` block closes it.

    ``_graphs=False`` is private: it runs the steps eagerly on the card,
    for the card tests, ``chip_smoke.py`` and ``tools/profile_serving``,
    which hold the graphs against the eager steps."""

    def __init__(self, params, cfg: gpt.GPTConfig, max_batch: int,
                 max_len: int, eos_id: int | None = None,
                 prefill: bool = True, seed: int = 0, device=None,
                 layout: str | None = None, block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 async_dispatch: bool = False,
                 prefill_budget: int | None = None,
                 metrics_port: int | None = None,
                 spec_k: int | None = None, draft_cfg=None,
                 draft_params=None, spec_tree: int | None = None,
                 adapter_pool=None, mesh=None, mp_axis: str = "mp",
                 ep_axis: str | None = None, _graphs: bool = True):
        if ep_axis is not None and mesh is None:
            raise ValueError("ep_axis requires mesh= (expert parallelism "
                             "is a mesh placement)")
        if mesh is not None and device is not None:
            raise ValueError("mesh= and device= are mutually exclusive "
                             "(TP server vs pinned single-chip replica)")
        # a tensor-parallel server (module note) keeps its host feeds and
        # fetched outputs on the CPU; its ranks hold the model
        self._mesh = mesh
        self._shard = self._draft_shard = None
        self._own_params: list = []     # per ShardedParams made here
        self.device = (torch.device("cpu") if mesh is not None
                       else resolve_device(device))
        if mesh is None and params["wte"].device != self.device:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"server was asked to run on {self.device}")
        if max_batch < 1 or max_len < 1:
            raise ValueError("max_batch and max_len must be >= 1")
        self._spec_args(cfg, min(max_len, cfg.max_seq_len), spec_k,
                        draft_cfg, draft_params, spec_tree)
        if adapter_pool is not None:
            self._check_pool(adapter_pool, params, cfg)
        # multi-tenant serving (text/adapters.py): with a pool every step
        # runs its adapter twin, fed the per-slot ids; id 0 gathers the
        # zero row, so base traffic gets the pool-less server's tokens
        self._adapters = adapter_pool
        self._pkey = (adapter_pool.pool_key() if adapter_pool is not None
                      else None)
        self._mask_buf = None            # the [B, V] mask feed, pinned once
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self._prefill = bool(prefill)
        window = min(max_len, cfg.max_seq_len)
        if prefill_chunk is not None:
            if not prefill:
                raise ValueError("prefill_chunk requires prefill=True "
                                 "(chunked admission IS a prefill mode)")
            if not 1 <= int(prefill_chunk) <= window:
                raise ValueError(f"prefill_chunk must be in [1, {window}] "
                                 f"(the serving window), got "
                                 f"{prefill_chunk}")
        self._chunk = int(prefill_chunk) if prefill_chunk is not None \
            else None
        if prefill_budget is not None:
            budget = int(prefill_budget)
            if budget < 0:
                raise ValueError(f"prefill_budget must be >= 0, got "
                                 f"{budget}")
            if budget and not prefill:
                raise ValueError("prefill_budget requires prefill=True "
                                 "(budgeted admission IS a prefill mode)")
        else:
            budget = _flags.prefill_budget() if prefill else 0
        self._budget = min(budget, window)
        lay = layout if layout is not None else _flags.kv_layout()
        if lay not in ("contiguous", "paged"):
            raise ValueError(
                f"layout {lay!r}: expected 'contiguous' or 'paged'")
        self._paged = lay == "paged"
        self.cache = generate.init_cache(
            cfg, max_batch, max_len,
            "meta" if mesh is not None else self.device, layout=lay,
            block_size=block_size, num_blocks=num_blocks)
        if mesh is not None:
            self._shard_target(params, cfg, mesh, mp_axis, ep_axis,
                               adapter_pool, lay, _graphs)
        # the host allocator mirrors the built pool's geometry; with the
        # spill tier on, its host memory is pinned here, once
        self._pool = (kv_pool.PagedAllocator(
            *kv_pool._geometry(self.cache), max_batch)
            if self._paged else None)
        # a draft cache shares the allocator, and spilled target rows
        # alone would leave the draft's rows of those blocks stale on
        # restore: with a draft the evict rung drops instead of spilling
        # (a tensor-parallel server has no spill tier yet: its evict rung
        # drops, as with a draft)
        self._spill_slots = (kv_pool.SpillSlots(
            self.cache, self._pool.spill_limit_bytes,
            pin=self.device.type == "cuda")
            if self._paged and self._pool.spill_limit_bytes
            and self.draft_cfg is None and mesh is None else None)
        self._moe_counted = 0
        if mesh is None:
            # an MoE server's routing accumulator, which its joint steps
            # add into (bound to its graphs like the cache), and the drops
            # already published (the drain's high-water mark)
            self._moe_stats = (moe_serving.moe_stats_init(
                cfg.moe.num_experts, self.device) if cfg.moe is not None
                else None)
            # what every step of this server is bound to (text/engine.py)
            self._bind = engine.Binding(
                params, self.cache, graphs=_graphs, stats=self._moe_stats,
                adapters=(adapter_pool.stacks() if adapter_pool is not None
                          else None))
        # the draft's twin cache, bound to its own steps: on the paged
        # layout a second pool of the target's geometry whose ``tables``
        # leaf IS the target's (one push, one allocator for both)
        self._draft_cache = self._draft_bind = None
        if self.draft_cfg is not None and mesh is not None:
            self._shard_draft(draft_params, mesh, mp_axis, max_batch,
                              max_len, _graphs)
        elif self.draft_cfg is not None:
            if self._paged:
                n_blocks, bs, _ = kv_pool._geometry(self.cache)
                self._draft_cache = kv_pool.init_paged_cache(
                    self.draft_cfg, max_batch, max_len, block_size=bs,
                    num_blocks=n_blocks, device=self.device)
                self._draft_cache["tables"] = self.cache["tables"]
            else:
                self._draft_cache = generate.init_cache(
                    self.draft_cfg, max_batch, max_len, self.device)
            self._draft_bind = engine.Binding(draft_params, self._draft_cache,
                                              graphs=_graphs)
        self._prefill_rows = 0       # prompt rows admission computed
        self._seed_key = rng.seed_key(seed)
        self._step_no = 0            # device steps dispatched so far
        self._async = bool(async_dispatch)
        self._inflight: dict | None = None   # the async step in flight
        self._free = list(range(max_batch))
        self._slots: dict[int, dict] = {}        # slot -> request state
        self._queue: list[dict] = []             # waiting requests
        self._results: dict[int, list] = {}
        self._dropped: set[int] = set()          # rids abandoned by close()
        self._streams: dict[int, dict] = {}      # rid -> open handoff stream
        self._next_rid = 0
        self._tokens = 0                          # tokens generated so far
        # telemetry: the registry (process-wide) and this server's own
        # counter twins (stats()), decided once here
        self._tel = _telemetry.enabled()
        self._counts: dict[str, int] = {}
        # this server's own latency histograms and token/request totals —
        # the fleet metrics plane's merge inputs (:meth:`local_snapshot`):
        # the registry is process-wide, and a loopback fleet's replicas
        # share the process
        self._hist_local: dict = {}
        self._counts_local: dict[str, int] = {}
        # resilience (module note), decided once here
        self._resil = _resilience.enabled()
        self._default_ttl = _flags.request_ttl_s()
        self._step_budget = _flags.step_budget_s()
        self._admit_cap = max_batch      # halved by the OOM ladder
        self._status: dict[int, str] = {}       # rid -> "timeout" | "error"
        self._err_reason: dict[int, str] = {}   # rid -> why "error"
        self._wedged = False             # a wedge was detected, not yet
        self._wedge_event = False        # ... recovered by a clean tick
        self._in_tick = False            # the guard is not re-entered
        self._rss_tick = 0               # the RSS watchdog's 1-in-16
        self._prefill_steps = (None, 1)  # the last admission's (step, calls)
        # the decode-gap probe: when the last round that appended decode
        # tokens ended (None while idle: an empty server is not stalled)
        self._gap_anchor: float | None = None
        # completed trace spans of this server's requests
        self._span_ring = _telemetry.SpanRing()
        # admission control (module note), decided once here: with
        # PADDLE_TPU_ADMISSION=0 no controller, and every consult is an
        # ``is None``; its budget rungs are the widths warmup captures
        self._adm = (_admission.AdmissionController(
            scope="serving",
            budget_rungs=_admission.ladder_widths(self._budget))
            if _flags.admission_enabled() else None)
        self.metrics_server = (_telemetry.serve_metrics(metrics_port)
                               if metrics_port is not None else None)

    def _shard_target(self, params, cfg, mesh, mp, ep, pool, lay,
                      graphs) -> None:
        """A tensor-parallel server's placement (``text/tp_serving.py``):
        the JAX server's refusals (``engine._ShardCtx``), the params cut
        over the ranks, its cache made there — ``self.cache`` and
        ``self.params`` become handles — and the binding every step runs
        on, an MoE server's routing accumulator with it."""
        from . import tp_serving

        self._shard = engine._ShardCtx(mesh, cfg, params, self.cache, mp,
                                       pool=pool, ep=ep)
        self._sparams = self._placed(params, cfg, mesh, self._shard, mp, ep)
        bs = int(self.cache["k"].shape[2]) if lay == "paged" else None
        nb = int(self.cache["k"].shape[1]) - 1 if lay == "paged" else None
        self._bind = tp_serving.ShardedBinding(
            self._shard, self._sparams, self.cache, lay, self.max_batch,
            self.max_len, bs, nb, graphs=graphs, adapters=pool)
        self.cache = self._bind.cache
        self.params = self._sparams.tree
        self._moe_stats = self._bind.stats

    def _placed(self, params, cfg, mesh, shard, mp, ep):
        """The params on the ranks: a handle tree already cut over this mesh
        for this config and these axes (``tp_serving.shard_params``) as it
        is, else cut and sent now — and then released with the server
        (``self._own_params``)."""
        from . import tp_serving

        sp = tp_serving.ShardedParams.of(params)
        if sp is None:
            self._own_params.append(True)
            return tp_serving.ShardedParams(params, cfg, mesh, shard.params,
                                            mp, ep)
        if sp.mesh is not mesh or sp.cfg != cfg or (sp.mp, sp.ep) != (mp,
                                                                      ep):
            raise ValueError(
                "sharded params were cut for another mesh, config or axes "
                f"(mp={sp.mp!r}, ep={sp.ep!r}) than this server's")
        self._own_params.append(False)
        return sp

    def _shard_draft(self, draft_params, mesh, mp, max_batch, max_len,
                     graphs) -> None:
        """The draft twin of a tensor-parallel server: its own shard
        context and params over the same mesh, its cache made on the
        ranks (paged: a pool of the target's geometry reading the
        target's ``tables``)."""
        from . import tp_serving

        lay = "paged" if self._paged else "contiguous"
        bs = nb = None
        if self._paged:
            nb, bs, _ = kv_pool._geometry(self.cache)
        tmpl = generate.init_cache(self.draft_cfg, max_batch, max_len,
                                   "meta", layout=lay, block_size=bs,
                                   num_blocks=nb)
        self._draft_shard = engine._ShardCtx(mesh, self.draft_cfg,
                                             draft_params, tmpl, mp)
        self._draft_sparams = self._placed(draft_params, self.draft_cfg,
                                           mesh, self._draft_shard, mp, None)
        self._draft_bind = tp_serving.ShardedBinding(
            self._draft_shard, self._draft_sparams, tmpl, lay, max_batch,
            max_len, bs, nb, share_tables=self._bind if self._paged else None,
            graphs=graphs)
        self._draft_cache = dict(self._draft_bind.cache)
        if self._paged:
            self._draft_cache["tables"] = self.cache["tables"]
        self._draft_params = self._draft_sparams.tree

    def _check_pool(self, pool, params, cfg) -> None:
        """An adapter pool's checks, in the JAX server's words: a dense
        model, the pool's own config, no tree speculation, and params
        that carry no lora leaves yet."""
        if cfg.moe is not None:
            raise NotImplementedError(
                "adapter_pool with an MoE config is not supported "
                "yet — the adapter step kinds have no joint-routing "
                "twin (the gathered LoRA delta composes with dense "
                "FFNs only)")
        if self._spec_tree_n:
            raise NotImplementedError(
                "spec_tree with an adapter_pool is not supported yet (the "
                "tree verify kind has no adapter-gathered twin); linear "
                "spec_k composes with pools")
        if engine.cfg_key(pool.cfg) != engine.cfg_key(cfg):
            raise ValueError(
                "adapter_pool was built for a different GPTConfig "
                "than this server — pool and server must share the "
                "base model geometry")
        if any(k.endswith(("_lora_a", "_lora_b")) for k in params["blocks"]):
            raise ValueError(
                "params already carry lora leaves — merge or strip "
                "them before attaching an adapter_pool (the pool's "
                "gathered delta would stack on top of them)")
        if self._mesh is None and pool.device != self.device:
            raise ValueError(f"the adapter pool lives on {pool.device}, the "
                             f"server runs on {self.device}")

    def _spec_args(self, cfg, window: int, spec_k, draft_cfg, draft_params,
                   spec_tree) -> None:
        """The speculation arguments' checks, as the JAX server's: K or
        the tree's node budget N (never both), each inside the serving
        window, and a draft that shares the target's vocabulary, covers
        the window and lives on the server's device.  Sets the spec
        state."""
        if spec_tree is not None:
            n = int(spec_tree)
            if n < 0 or n == 1:
                raise ValueError(f"spec_tree must be 0 (off) or >= 2 node "
                                 f"slots (node 0 carries the feed token), "
                                 f"got {n}")
        else:
            n = _flags.spec_tree()
        if spec_k is not None:
            k = int(spec_k)
            if n and k:
                raise ValueError(f"spec_k={k} and spec_tree={n} are mutually "
                                 f"exclusive — a round is either a linear "
                                 f"verify or a tree verify")
        else:
            # a tree budget overrides the environment's K
            k = 0 if n else _flags.spec_k()
            if k == 0 and draft_cfg is not None and not n:
                k = 4               # passing a draft model IS opting in
        if k < 0:
            raise ValueError(f"spec_k must be >= 0, got {k}")
        if k == 0 and draft_cfg is not None and not n:
            raise ValueError("draft_cfg given but spec_k=0 disables "
                             "speculation — drop one or the other")
        if (k or n) and (cfg.moe is not None or (
                draft_cfg is not None and draft_cfg.moe is not None)):
            raise NotImplementedError(
                "speculative serving requires dense models (MoE capacity "
                "routing differs between chunked verify and stepwise "
                "decode — speculative_generate's rule)")
        if n and not 2 <= n < window:
            raise ValueError(f"spec_tree {n} must be in [2, {window}) — the "
                             f"tree chunk must fit the serving window")
        if k and not 1 <= k < window:
            raise ValueError(f"spec_k {k} must be in [1, {window}) — the "
                             f"verify chunk must fit the serving window")
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("draft_cfg requires draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_cfg.vocab_size} != "
                                 f"target vocab {cfg.vocab_size}")
            if draft_cfg.max_seq_len < window:
                raise ValueError(f"draft max_seq_len {draft_cfg.max_seq_len}"
                                 f" < serving window {window}")
            if self._mesh is None and \
                    draft_params["wte"].device != self.device:
                raise ValueError(f"draft params live on "
                                 f"{draft_params['wte'].device}, the server "
                                 f"runs on {self.device}")
        self._spec_k = k
        self._spec_tree_n = n
        self._spec_branch = _flags.spec_branch()
        self._spec_on = k > 0 or n > 0
        self.draft_cfg = draft_cfg if self._spec_on else None
        self._draft_params = draft_params if self._spec_on else None
        self._self_draft = self._spec_on and draft_cfg is None
        self._min_accept = _flags.spec_min_accept()
        # server-wide accounting (load_stats, the accept-rate gauge, the
        # target passes a token): proposals scored, accepted, verify
        # rounds, plain target steps while speculation is on; tree rounds
        # add the accepted path lengths over the slot-rounds that walked
        self._spec_prop = self._spec_acc = 0
        self._spec_rounds = self._spec_plain_steps = 0
        self._tree_path_sum = self._tree_path_cnt = 0

    # -- host <-> device ----------------------------------------------------

    def _spec(self, **kw) -> engine.StepSpec:
        return engine.StepSpec(cfg=self.cfg, paged=self._paged,
                               pkey=self._pkey, payload=self._bind, **kw)

    def _kind(self, kind: str) -> str:
        """The Engine kind this server runs for ``kind``: an MoE server's
        joint-routing or MoE-admission twin, a pool-attached server's
        adapter twin, else ``kind`` itself."""
        if self.cfg.moe is not None:
            return _MOE_KINDS.get(kind, kind)
        if self._adapters is not None:
            return _ADAPTER_KINDS.get(kind, kind)
        return kind

    def _ids(self) -> tuple:
        """The leading feed of a pool-attached server's decode steps: the
        per-slot adapter ids [B] (:meth:`_gather_adapter_ids`); nothing
        without a pool."""
        return ((self._host(self._gather_adapter_ids()),)
                if self._adapters is not None else ())

    def _aid(self, aid: int) -> tuple:
        """The leading feed of a pool-attached server's admission steps:
        the slot's adapter id as an int64 [1]; nothing without a pool."""
        return (self._scalars(aid) if self._adapters is not None else ())

    def _moe_act(self):
        """The joint-routing occupancy mask [max_batch] bool: occupied
        slots route (prompt-feeding ones included: their rows are kept,
        so they claim real capacity), free slots claim nothing, and
        admitting slots are left out — their frontier output is
        discarded and their row rewritten by the next chunk."""
        act = np.zeros((self.max_batch,), bool)
        for slot, st in self._slots.items():
            act[slot] = not st.get("admitting")
        return act

    def _act(self) -> tuple:
        """The trailing feed of a decode step: an MoE server's occupancy
        mask, nothing for a dense one."""
        return (self._host(self._moe_act()),) if self.cfg.moe is not None \
            else ()

    def _moe_snapshot(self):
        """Drain the routing accumulator into telemetry (the drops since
        the last drain, the per-expert load gauges) and return
        (dropped_total, load_list).  Waits for the steps in flight."""
        dropped, load = moe_serving.drain_drop_stats(
            self._moe_stats, counted=self._moe_counted, tel=self._tel)
        self._moe_counted = dropped
        return dropped, load

    def _dspec(self, **kw) -> engine.StepSpec:
        """A step of the draft model, bound to the draft's cache."""
        return engine.StepSpec(cfg=self.draft_cfg, paged=self._paged,
                               payload=self._draft_bind, **kw)

    def _host(self, arr):
        """A host feed as a CPU tensor — pinned on a card, so its copy to
        the device does not block and the caching host allocator keeps
        the buffer until that copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _key(self, n: int):
        """The sampling key of counter ``n``: int64 [2] (stream key, n)."""
        return np.array([self._seed_key, n], np.int64)

    def _fetch_start(self, t):
        """Start copying a step's output ``t`` to the host: into pinned
        memory without blocking on a card (a graph's output is then free
        to be overwritten by the next replay, which the stream orders
        after the copy).  :meth:`_fetch_wait` returns it as numpy."""
        if t.device.type != "cuda":
            return t, None
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return h, ev

    @staticmethod
    def _fetch_wait(fetch):
        h, ev = fetch
        if ev is not None:
            ev.synchronize()
        return h.numpy()

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               stop: list | None = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               ttl_s: float | None = None, priority: int = 0,
               tenant: str | None = None, adapter: str | None = None,
               constraint=None) -> int:
        """Queue one request and admit what fits; returns its id.
        ``stop``: optional list of token SEQUENCES; generation ends
        (sequence included) as soon as the generated tail matches one.
        ``ttl_s`` (default ``PADDLE_TPU_REQUEST_TTL_S``; None = none)
        bounds the request's wait in the queue: still queued past it, it
        is shed with the ``timeout`` status.  ``priority`` (higher = kept
        longer): the OOM ladder evicts the lowest-priority slot first, and
        admission control buckets it into a class (<= 0 low, 1 normal,
        >= 2 high) for queue bounds and shed order.  ``tenant``: the
        request's token bucket under ``PADDLE_TPU_TENANT_RATE`` (None
        shares one); refused at the door, the request retires
        ``rejected`` at once and ``result()`` raises
        ``resilience.Overloaded``.  A queued request gets a trace context
        (``telemetry.mint_trace()``) for its spans: the server is the
        front door here, as the JAX package's fleet router is.
        ``adapter``: serve the request under a named LoRA of the attached
        ``adapter_pool`` (None: the tenant's default adapter,
        ``AdapterPool.set_tenant_default``, else the base model).
        ``constraint``: constrained decoding — a ``text/adapters.py``
        ``Constraint`` spec (TokenSet / Regex / JsonSchema) or an iterable
        of allowed token ids, compiled here (a malformed spec raises in
        the caller's frame) and again at admission into the slot's
        automaton; every step then masks the tokens it bans, greedy and
        sampled alike.  An MoE server refuses constraints."""
        req = self._build_request(prompt, max_new_tokens, stop, temperature,
                                  top_k, top_p, ttl_s, priority, tenant,
                                  adapter, constraint)
        rid = req["rid"]
        self._count("serving.requests_submitted")
        if self._adm is not None:
            self._adm.control_tick()
            ok, _reason = self._adm.admit(tenant, priority,
                                          len(req["prompt"]) + max_new_tokens)
            if not ok:
                self._status[rid] = "rejected"
                self._count("serving.requests_rejected")
                self._tel_gauges()
                return rid
        req["trace"] = _telemetry.mint_trace()
        self._queue.append(req)
        if self._adm is not None:
            self._shed_queue_overflow()
        self._admit()
        self._tel_gauges()
        return rid

    def _build_request(self, prompt, max_new_tokens, stop, temperature,
                       top_k, top_p, ttl_s, priority, tenant=None,
                       adapter=None, constraint=None) -> dict:
        """Validate one request and mint its queue entry (the shared half
        of :meth:`submit`, :meth:`submit_prefilled` and
        :meth:`stream_prefilled_begin`), taking the next request id: the
        JAX server's checks and refusals, in its words."""
        if self.cache is None:
            raise RuntimeError("the server is closed")
        prompt, stop, ttl, top_k = validate_request(
            prompt, max_new_tokens, stop, temperature, top_k, top_p, ttl_s,
            window=min(self.max_len, self.cfg.max_seq_len),
            vocab_size=self.cfg.vocab_size, default_ttl=self._default_ttl)
        aid = 0
        if adapter is not None and self._adapters is None:
            raise ValueError(
                f"adapter={adapter!r} but no adapter_pool attached to "
                f"this server")
        if self._adapters is not None:
            if adapter is None:
                adapter = self._adapters.default_for(tenant)
            aid = self._adapters.resolve(adapter)
        if constraint is not None:
            if self.cfg.moe is not None:
                raise NotImplementedError(
                    "constrained decoding on an MoE server is not "
                    "supported yet (no joint-routing masked step kind)")
            from . import adapters as _ad

            # compiled and discarded: a malformed spec raises here
            _ad.compile_constraint(constraint, self.cfg.vocab_size)
        if self._paged:
            # a request needing more blocks than the whole pool can NEVER
            # be admitted: refuse it here rather than park it forever
            need = -(-(len(prompt) + max_new_tokens) // self._pool.bs)
            if need > self._pool.N:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has "
                    f"{self._pool.N} (raise num_blocks or shrink the "
                    f"request)")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        return {"rid": rid, "prompt": prompt,
                "max_new": int(max_new_tokens), "stop": stop,
                "temperature": float(temperature),
                "top_k": top_k, "top_p": float(top_p),
                "ttl": ttl, "priority": int(priority),
                "tenant": tenant, "adapter": aid,
                "adapter_name": adapter if aid else None,
                "constraint": constraint, "trace": None,
                "t_submit": now, "t_enqueue": now, "t_queued": now}

    def _check_rows(self, rows, what: str) -> dict:
        """A prefill worker's rows ({leaf: [L, 1, P, Hkv(, hd)]}) held to
        this server's cache: the same leaves (the int8 scale planes
        included) in the same storage dtype — a drift is refused, never
        cast (bit parity with local admission is the contract).  Returns
        the rows as tensors."""
        rows = {name: torch.as_tensor(v) for name, v in rows.items()}
        want = {name for name in self.cache if name != "tables"}
        if set(rows) != want:
            raise ValueError(
                f"{what} leaves {sorted(rows)} do not match the cache "
                f"leaves {sorted(want)} (KV dtype mismatch between prefill "
                f"worker and decode server?)")
        for name, v in rows.items():
            have = self.cache[name].dtype
            if v.dtype != have:
                raise ValueError(
                    f"{what} leaf {name!r} is {v.dtype}, this server stores "
                    f"{have} (PADDLE_TPU_KV_DTYPE drift between prefill "
                    f"worker and decode server?)")
        return rows

    def submit_prefilled(self, prompt, rows, logits,
                         max_new_tokens: int = 32, stop: list | None = None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, ttl_s: float | None = None,
                         priority: int = 0, trace=None, ready=None) -> int:
        """Admit a request whose prompt a prefill worker already ran (the
        fleet's prefill/decode handoff, ``text/fleet.py``): ``rows`` are
        the worker's cache rows — leaves ``[L, 1, n, Hkv(, hd)]`` in this
        server's storage dtype, int8 scale planes included — and
        ``logits`` its admission logits [V].  Admission writes the rows
        into a slot through the graphed ``inject`` step (one per
        power-of-two bucket; paged: through the slot's block table, after
        adopting the longest indexed prefix) and draws the first token
        from ``logits`` exactly as local admission draws it (sampling,
        telemetry, NaN guard), so decode goes on as after a local
        admission.  Refused, in the JAX server's words: leaves that do
        not match the cache's, a dtype drift, a row count that is not the
        prompt's.  ``ready``: a CUDA event the rows are final at (a
        worker on another stream of this card); the injection waits on
        it."""
        req = self._build_request(prompt, max_new_tokens, stop, temperature,
                                  top_k, top_p, ttl_s, priority)
        n = len(req["prompt"])
        rows = self._check_rows(rows, "prefilled rows")
        if rows["k"].shape[2] != n:
            raise ValueError(
                f"prefilled rows cover {rows['k'].shape[2]} positions for a "
                f"{n}-token prompt")
        req["prefilled"] = (rows, torch.as_tensor(logits,
                                                  dtype=torch.float32), ready)
        req["trace"] = trace or None
        self._queue.append(req)
        self._count("serving.requests_submitted")
        self._count("serving.prefilled_submissions")
        self._admit()
        self._tel_gauges()
        return req["rid"]

    def adopt_request(self, req: dict) -> int:
        """Enqueue a request dict drained from another server or built by
        the fleet router (its re-route and dispatch path): a fresh local id
        and queue clock (the TTL stays a bound on the queue wait), with
        the progress carry and any prefilled payload kept.  The dict is
        trusted, not validated again — but the window and, paged, the
        whole pool are checked again, as replicas may differ."""
        if self.cache is None:
            raise RuntimeError("the server is closed")
        window = min(self.max_len, self.cfg.max_seq_len)
        total = len(req["prompt"]) + req["max_new"] \
            - len(req.get("carry", ()))
        if total > window:
            raise ValueError(
                f"adopted request needs a {total}-row window; this replica "
                f"serves {window}")
        if self._paged:
            need = -(-total // self._pool.bs)
            if need > self._pool.N:
                raise ValueError(
                    f"adopted request needs {need} KV blocks; this "
                    f"replica's pool has {self._pool.N}")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        r = dict(req, rid=rid, t_enqueue=now, t_queued=now)
        r.setdefault("t_submit", now)
        for k, v in (("trace", None), ("tenant", None), ("adapter", 0),
                     ("adapter_name", None), ("constraint", None)):
            r.setdefault(k, v)
        self._queue.append(r)
        self._count("serving.requests_adopted")
        self._admit()
        self._tel_gauges()
        return rid

    def drain_queue(self, rids=None) -> list:
        """Remove and return queued request dicts (the fleet router's drain:
        a wedged or removed replica's queued work moves to the others
        through :meth:`adopt_request`; its active slots keep decoding
        here).  ``rids`` limits the drain to those ids — the router passes
        the ones it owns, so a request submitted directly to this server
        stays queued for its submitter.  A drained stream request's open
        stream record dies with the drain."""
        if rids is None:
            out, self._queue[:] = list(self._queue), []
        else:
            out = [r for r in self._queue if r["rid"] in rids]
            self._queue[:] = [r for r in self._queue if r["rid"] not in rids]
        for r in out:
            if r.get("stream"):
                self._streams.pop(r["rid"], None)
        if out:
            self._count("serving.queue_drained", len(out))
        self._tel_gauges()
        return out

    def _await_rows(self, ready) -> None:
        """On a card, order what this server's stream does next after
        ``ready`` — the event a prefill worker on another stream recorded
        once its rows and logits were final."""
        if ready is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_event(ready)

    def _inject_rows(self, slot: int, rows: dict, offset: int, lo: int,
                     hi: int, bucket: int) -> None:
        """Write rows [lo, hi) of a worker's rows (``rows`` hold logical
        rows [offset, offset + P)) into ``slot`` through the graphed
        ``inject`` step at ``bucket``: each leaf padded into a zeroed
        [L, 1, bucket, ...] buffer at its absolute rows.  On a card each
        rows tensor is recorded on the current stream, so the allocator
        cannot hand the memory of a worker's rows to its next job before
        this copy ran (:meth:`_await_rows` ordered the copy after the
        worker's writes)."""
        dev = self.device
        cur = (torch.cuda.current_stream(dev) if dev.type == "cuda"
               else None)
        feeds = []
        for name in kv_pool.POOL_LEAVES:
            if name not in self.cache:
                continue
            v = rows[name]
            if cur is not None and v.is_cuda:
                v.record_stream(cur)
            buf = torch.zeros((v.shape[0], 1, bucket) + tuple(v.shape[3:]),
                              dtype=self.cache[name].dtype, device=dev)
            buf[:, :, lo:hi].copy_(v[:, :, lo - offset:hi - offset],
                                   non_blocking=True)
            feeds.append(buf)
        engine.ENGINE.get("inject", self._spec(bucket=bucket))(
            *feeds, *self._scalars(lo, hi, slot))

    def _inject_prefilled(self, req, slot: int):
        """Admission of a handed-off request: paged, adopt the longest
        indexed prefix (the worker's rows of adopted blocks equal what the
        index holds, so those blocks are attended, never rewritten),
        restore what of it was spilled and make the rest writable
        (relieving the pool as local admission does: ``PoolExhausted``
        parks the request); then one ``inject`` step writes the rows.
        Returns the admission logits on this server's device."""
        rows, logits, ready = req["prefilled"]
        prompt = req["prompt"]
        n = len(prompt)
        t0 = time.perf_counter()
        bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
        shared = 0
        if self._paged:
            if self._prefill:
                shared = self._pool.adopt_prefix(slot, prompt)
                self._drain_restores()
            self._ensure_admission_rows(slot, shared, n)
            self._apply_pool_ops()
        self._await_rows(ready)
        self._inject_rows(slot, rows, 0, shared, n, bucket)
        if self._paged and self._prefill:
            # the injected rows are local prefill's: the prompt's full
            # blocks index for later prompts to share
            self._pool.register_prefix(slot, prompt)
        self._count("serving.prefilled_rows", n - shared)
        if self._tel:
            self._span_ring.record(req.get("trace"), "inject", t0,
                                   time.perf_counter(), rid=req["rid"],
                                   rows=n - shared)
        self._prefill_steps = (f"serving.inject@{bucket}", 1)
        return logits.to(self.device)

    # -- streamed fleet handoff: per-chunk row injection --------------------

    def stream_prefilled_begin(self, prompt, max_new_tokens: int = 32,
                               stop: list | None = None,
                               temperature: float = 0.0, top_k: int = 0,
                               top_p: float = 1.0,
                               ttl_s: float | None = None,
                               priority: int = 0, trace=None) -> int:
        """Open a streamed handoff, the chunked twin of
        :meth:`submit_prefilled`: the caller (the fleet router, as a
        worker's chunks land) follows with one :meth:`stream_prefilled_rows`
        a chunk, the last carrying the admission logits.  The slot is
        claimed at admission with no rows present and rides the decode
        steps at its injected frontier, as a budgeted admission rides them
        (the frontier row a step writes is rewritten by the next chunk's
        injection), so the transfer overlaps this server's decode instead
        of stalling it.  Chunks landing while the request is queued wait
        on the host and are injected at its claim.  Tokens are those of
        :meth:`submit_prefilled` with the same rows and logits."""
        req = self._build_request(prompt, max_new_tokens, stop, temperature,
                                  top_k, top_p, ttl_s, priority)
        req["stream"] = True
        req["trace"] = trace or None
        self._streams[req["rid"]] = {"req": req, "pending": [], "expect": 0,
                                     "slot": None, "st": None}
        self._queue.append(req)
        self._count("serving.requests_submitted")
        self._count("serving.stream_begins")
        self._admit()
        self._tel_gauges()
        return req["rid"]

    def _claim_stream(self, slot: int, st) -> None:
        """A streamed handoff's claim: reserve the slot and, paged, adopt
        the longest indexed prefix and make the whole row range writable
        before any chunk lands (:meth:`_inject_prefilled`'s allocation).
        No prefill runs.  Raises ``PoolExhausted`` (the caller parks the
        request) before anything is claimed.  Chunks that arrived while
        the request was queued are injected now."""
        prompt = st["prompt"]
        n = len(prompt)
        shared = 0
        if self._paged:
            if self._prefill:
                shared = self._pool.adopt_prefix(slot, prompt)
                self._drain_restores()
            self._ensure_admission_rows(slot, shared, n)
            self._apply_pool_ops()
        # pos doubles as the injected frontier: rows [0, pos) are valid
        st.update(admitting=True, stream=True, stream_shared=shared,
                  pos=shared)
        self._slots[slot] = st
        sr = self._streams[st["rid"]]
        sr["slot"], sr["st"] = slot, st
        self._count("serving.stream_claims")
        self._stream_drain(st["rid"])

    def stream_prefilled_rows(self, rid: int, start: int, stop: int, rows,
                              logits=None, ready=None) -> None:
        """Fold one streamed chunk — worker rows of prompt positions
        [start, stop), leaves ``[L, 1, stop - start, Hkv(, hd)]`` in this
        server's storage dtype — into the request's slot through the
        ``inject`` step at the prompt's bucket.  ``logits`` [V] ride the
        final chunk (``stop == n``), which graduates the slot in the same
        call.  Chunks landing before the claim wait on the host.  Raises
        on a leaf, dtype or range mismatch (the transport is ordered: a
        gap is a protocol fault); ``KeyError`` when no stream is open for
        ``rid``.  ``ready``: as in :meth:`submit_prefilled`."""
        sr = self._streams.get(rid)
        if sr is None:
            raise KeyError(f"no open handoff stream for rid {rid}")
        if self._status.get(rid) is not None:
            # shed or failed while the chunks were in flight
            self._streams.pop(rid, None)
            return
        start, stop = int(start), int(stop)
        n = len(sr["req"]["prompt"])
        if start != sr["expect"] or stop <= start or stop > n:
            raise ValueError(
                f"stream chunk [{start}, {stop}) for rid {rid}: expected "
                f"start {sr['expect']} in a {n}-token prompt")
        if logits is None and stop == n:
            raise ValueError(f"final stream chunk for rid {rid} carries no "
                             f"admission logits")
        if logits is not None and stop != n:
            raise ValueError(
                f"stream chunk [{start}, {stop}) for rid {rid} carries "
                f"logits before the final row {n}")
        rows = self._check_rows(rows, "stream chunk")
        for name, v in rows.items():
            if v.shape[2] != stop - start:
                raise ValueError(
                    f"stream chunk leaf {name!r} covers {v.shape[2]} "
                    f"positions for range [{start}, {stop})")
        sr["expect"] = stop
        sr["pending"].append(
            (start, stop, rows,
             None if logits is None else torch.as_tensor(
                 logits, dtype=torch.float32), ready))
        if sr["st"] is not None:
            self._stream_drain(rid)

    def _stream_drain(self, rid: int) -> None:
        """Inject every waiting chunk of a claimed stream, in order; the
        chunk carrying the logits graduates the slot (and may retire the
        request: a one-token budget ends on the admission token)."""
        sr = self._streams.get(rid)
        if sr is None or sr["st"] is None:
            return
        while sr["pending"]:
            start, stop, rows, logits, ready = sr["pending"].pop(0)
            self._await_rows(ready)
            self._stream_inject(sr["slot"], sr["st"], start, stop, rows)
            if logits is not None:
                self._graduate_stream(sr["slot"], sr["st"], logits)
                break

    def _stream_inject(self, slot: int, st, start: int, stop: int,
                       rows) -> None:
        """One chunk through the handoff's ``inject`` step: its rows at
        their absolute offsets in the prompt's bucket, rows
        [max(shared, start), stop) written — the step monolithic handoff
        admission runs, with per-chunk range feeds.  Rows under an adopted
        prefix are attended, never rewritten.  The frontier moves to
        ``stop`` (the row a decode step wrote at the old frontier was just
        rewritten)."""
        n = len(st["prompt"])
        lo = max(st.get("stream_shared", 0), start)
        if stop > lo:
            t0 = time.perf_counter()
            bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
            self._inject_rows(slot, rows, start, lo, stop, bucket)
            self._count("serving.prefilled_rows", stop - lo)
            if self._tel:
                self._span_ring.record(st.get("trace"), "inject", t0,
                                       time.perf_counter(), rid=st["rid"],
                                       start=lo, stop=stop)
        st["pos"] = max(st["pos"], stop)

    def _graduate_stream(self, slot: int, st, logits) -> None:
        """The final chunk landed, its logits with it: draw the admission
        token as every admission draws it (:meth:`_take_first_token`, the
        NaN guard too) and let the slot decode (or retire at once);
        paged, the prompt's blocks index for later prompts.  A draft
        model's cache saw none of the rows: its first round catches up
        from position 0."""
        self._streams.pop(st["rid"], None)
        for k in ("admitting", "stream", "stream_shared"):
            st.pop(k, None)
        done = self._take_first_token(st, slot, logits.to(self.device),
                                      span=False)
        if done is None:                        # failed by the NaN guard
            del self._slots[slot]
            return
        if self._paged and self._prefill:
            self._pool.register_prefix(slot, st["prompt"])
        if self._draft_bind is not None:
            st["spec_dpos"] = 0
        if done:
            del self._slots[slot]
            self._results[st["rid"]] = st["generated"]
            self._release(slot)
            self._tel_retire(st, slot)

    def stream_prefilled_abort(self, rid: int, reason: str) -> None:
        """Tear down a half-streamed handoff (a worker's death, a lost
        link, a TTL, the replica's removal): the request retires with the
        ``error`` status and a claimed slot frees with its blocks.
        ``KeyError`` when no stream is open for ``rid``."""
        sr = self._streams.pop(rid)
        if sr["st"] is None:
            self._queue[:] = [r for r in self._queue if r["rid"] != rid]
        else:
            self._slots.pop(sr["slot"], None)
            self._release(sr["slot"])
        if self._status.get(rid) is None:
            self._status[rid] = "error"
            self._err_reason[rid] = reason
        self._count("serving.requests_failed")
        self._count("serving.stream_aborts")

    def _shed_queue_overflow(self) -> None:
        """The bounded per-class queues: while a class is over
        ``PADDLE_TPU_ADMISSION_QUEUE_CAP``, retire the controller's victim
        (the lowest over-cap class's newest entry) as ``rejected``.  Runs
        after every enqueue, so the bound holds between submits."""
        while True:
            i = self._adm.overflow_victim(self._queue)
            if i is None:
                return
            req = self._queue.pop(i)
            self._status[req["rid"]] = "rejected"
            self._adm.count_shed(req["priority"], "queue_full")
            self._count("serving.requests_rejected")

    def _shed_expired(self):
        """Deadline shedding: queued requests past their TTL retire with
        the ``timeout`` status and never take a slot.  The TTL bounds the
        wait of the current queue entry (``t_queued``: an evicted
        request's clock restarts when it is requeued), never the
        request's total age.  Active slots are never shed."""
        if not self._resil or not self._queue:
            return
        now = time.perf_counter()
        kept = []
        for req in self._queue:
            ttl = req.get("ttl")
            if ttl is not None and now - req["t_queued"] > ttl:
                rid = req["rid"]
                self._status[rid] = "timeout"
                self._count("serving.requests_shed")
                self._count("resilience.deadline_sheds")
                self._event("serving.shed", req["t_submit"], now, rid=rid,
                            ttl_s=ttl)
            else:
                kept.append(req)
        self._queue[:] = kept

    def _fail_request(self, st, slot: int, reason: str) -> None:
        """Retire one request with the ``error`` status (the NaN guard):
        the slot frees for the next request, the server lives on."""
        rid = st["rid"]
        self._status[rid] = "error"
        self._err_reason[rid] = reason
        self._release(slot)
        self._count("serving.requests_failed")
        self._count("resilience.nan_requests")
        self._event("serving.request_failed", st["t_submit"],
                    time.perf_counter(), tid=slot, rid=rid, reason=reason)

    def _finished(self, st, t: int) -> bool:
        return (len(st["generated"]) >= st["max_new"]
                or (self.eos_id is not None and t == self.eos_id)
                or _hits_stop(st))

    def _first_token(self, st, logits, lnp) -> int:
        """The admission token from the prefill logits [V] (``lnp``: the
        same row on the host): a draw keyed by the request id
        (independent of admission order and batch-mates, as the JAX
        server's ``fold_in(base, (1 << 20) + rid)``), or the argmax.  A
        constrained slot's row is masked first
        (``adapters.apply_constraint_host``): the argmax of the masked
        host row, or the device draw under the same additive mask."""
        cst = st.get("constraint")
        mask = None
        if cst is not None:
            from . import adapters as _ad

            lnp = _ad.apply_constraint_host(lnp, cst)
            if st["temperature"] > 0.0:
                mask = torch.from_numpy(np.where(
                    cst.allowed_mask(), np.float32(0.0),
                    np.float32(_ad.NEG_INF))[None]).to(self.device)
        if st["temperature"] > 0.0:
            dev = self.device
            key = torch.tensor(self._key(_ADMIT_COUNTER + st["rid"]),
                               device=dev)
            return int(_sample_batched(
                logits[None], key,
                torch.tensor([st["temperature"]], device=dev),
                torch.tensor([st["top_k"]], device=dev),
                torch.tensor([st["top_p"]], device=dev), mask=mask)[0])
        return int(lnp.argmax())

    def _take_first_token(self, st, slot: int, logits, wall=None,
                          span: bool = True) -> bool | None:
        """The end of an admission: fetch the prefill logits [V] (one
        small device-to-host copy — the JAX server's host logits), run
        the NaN guard on them, then append the admission token; the slot
        decodes from position len(prompt) on.  ``wall`` — (step name,
        calls, start) of the admission steps — feeds the device feed one
        step's wall, bounded by this fetch.  Returns None when the guard
        failed the request (its slot is released), else whether that
        token ends the request.  ``span=False``: no ``prefill`` span (a
        streamed handoff's rows were computed elsewhere; its spans are the
        worker's chunks and this server's injects)."""
        lnp = logits.detach().float().cpu().numpy()
        t_fetch = time.perf_counter()
        if _faults.active():
            lnp = _faults.corrupt_nan("logits", lnp)
        if self._resil and not np.isfinite(lnp).all():
            self._fail_request(st, slot, "non-finite prefill logits")
            return None
        t = self._first_token(st, logits, lnp)
        st["generated"].append(t)
        st["pos"] = len(st["prompt"])          # cache rows [0, n) filled
        if self._draft_bind is not None:
            st["spec_dpos"] = st["pos"]        # the draft walked them too
        self._tokens += 1
        self._count("serving.tokens_generated")
        if self._tel:
            now = time.perf_counter()
            st["t_first"] = now
            self._observe("serving.ttft_ms", (now - st["t_submit"]) * 1e3)
            t_admit = st.get("t_admit", now)
            _telemetry.event("serving.prefill", t_admit, now, tid=slot,
                             rid=st["rid"], prompt_len=len(st["prompt"]))
            if span:
                self._span_ring.record(st.get("trace"), "prefill", t_admit,
                                       now, rid=st["rid"],
                                       prompt_len=len(st["prompt"]))
            if wall is not None and wall[0] is not None:
                name, calls, t0 = wall
                _telemetry.note_step_time(name, (t_fetch - t0) / calls)
        fin = self._constraint_push(st, t)
        return self._finished(st, t) or fin

    def _admit(self):
        self._shed_expired()
        # the OOM ladder's cap bounds every class (a memory bound); the
        # admission ladder's cap is shed pressure and bounds class 0 only
        cap = self._admit_cap
        adm_cap = None
        if self._adm is not None:
            adm_cap = min(cap, self._adm.effective_admit_cap(self.max_batch))
            if self._adm.engaged and len(self._queue) > 1:
                # a configured controller spends free slots on the highest
                # class first (a stable sort: FIFO within a class, by the
                # time each request first entered the queue, which an
                # evicted request keeps); an unconfigured one keeps strict
                # FIFO, the order of PADDLE_TPU_ADMISSION=0
                self._queue.sort(key=lambda r: (
                    -_admission.priority_class(r["priority"]),
                    r["t_enqueue"]))
        while self._queue and self._free and len(self._slots) < cap:
            if (adm_cap is not None and len(self._slots) >= adm_cap
                    and _admission.priority_class(
                        self._queue[0]["priority"]) == 0):
                # the queue is class-sorted: a class-0 head means no
                # higher class waits either
                break
            slot = self._free.pop()
            req = self._queue.pop(0)
            t_admit = time.perf_counter()
            carry = req.get("carry", ())
            st = {"rid": req["rid"], "prompt": req["prompt"],
                  "max_new": req["max_new"], "stop": req["stop"],
                  "temperature": req["temperature"], "top_k": req["top_k"],
                  "top_p": req["top_p"],
                  # an OOM-evicted request comes back with its progress
                  # carried: prompt = original + generated so far, and
                  # ``generated`` starts from the carry; ``base`` is the
                  # ORIGINAL prompt length, so the token fed at position
                  # i >= len(prompt) is generated[i - base]
                  "generated": list(carry),
                  "base": len(req["prompt"]) - len(carry),
                  "ttl": req["ttl"], "priority": req["priority"],
                  "tenant": req["tenant"], "trace": req["trace"],
                  "evictions": req.get("evictions", 0), "pos": 0,
                  "t_submit": req["t_submit"],
                  "t_enqueue": req["t_enqueue"], "t_admit": t_admit,
                  # the pool row this slot gathers (0 = base) and the
                  # constraint SPEC, which an evicted request carries
                  "adapter": req.get("adapter", 0),
                  "adapter_name": req.get("adapter_name"),
                  "constraint_spec": req.get("constraint")}
            if req.get("constraint") is not None:
                from . import adapters as _ad

                cst = _ad.compile_constraint(req["constraint"],
                                             self.cfg.vocab_size)
                # a re-admitted evicted request resumes its automaton
                # where it stood: replay the carried tokens
                for t in carry:
                    cst.advance(int(t))
                st["constraint"] = cst
            if self._spec_on and self._adm is not None \
                    and self._adm.spec_forced():
                # the ladder's spec-off rung: this claim decodes plain,
                # through the flag the acceptance fallback sets
                st["spec_off"] = True
                self._count("admission.spec_forced")
            if self._tel:
                self._observe("serving.queue_wait_ms",
                              (t_admit - st["t_submit"]) * 1e3)
            # a handed-off request's rows arrive computed: its admission
            # is one inject step, whatever the prefill mode
            handed = "prefilled" in req or req.get("stream")
            budgeted = (self._budget and not handed
                        and len(req["prompt"]) > self._budget)
            if not (self._prefill or budgeted or handed):
                self._slots[slot] = st         # fed token by token
                continue
            try:
                if req.get("stream"):
                    self._claim_stream(slot, st)
                    continue
                if budgeted:
                    self._claim_admitting(slot, st)
                    continue
                if "prefilled" in req:
                    logits = self._inject_prefilled(req, slot)
                else:
                    logits = self._prefill_slot(req["prompt"], slot,
                                                st["adapter"])
            except kv_pool.PoolExhausted:
                # no free blocks even after evicting the cold prefix
                # cache: the request WAITS for active slots to retire —
                # park it back at the queue front, stop admitting
                self._release(slot)
                self._queue.insert(0, req)
                self._count("kv_pool.admit_blocked")
                break
            except Exception:
                # neither lose the request nor leak the slot
                self._release(slot)
                self._queue.insert(0, req)
                raise
            done = self._take_first_token(
                st, slot, logits, (*self._prefill_steps, t_admit))
            if done is None:
                continue                        # failed by the NaN guard
            if "prefilled" in req and self._draft_bind is not None:
                st["spec_dpos"] = 0   # the draft saw no rows: it catches up
            if done:
                self._results[st["rid"]] = st["generated"]
                self._release(slot)
                self._tel_retire(st, slot)
                continue
            self._slots[slot] = st

    # -- budgeted admission: chunked-prefill co-scheduling ------------------

    def _claim_admitting(self, slot: int, st) -> None:
        """Budgeted admission, part 1: claim the slot and plan the
        prompt's chunk starts at the budget width WITHOUT running a
        prefill — the walks of monolithic admission (contiguous: the fixed
        chunk rule; paged: adopt the longest indexed prefix, restore what
        of it was spilled, then the suffix rule, the slot's rows
        allocated in full here, since the decode steps the slot rides
        write its frontier row).  Raises ``PoolExhausted`` (the caller
        parks the request) before anything is claimed."""
        prompt = st["prompt"]
        n = len(prompt)
        # the width of this claim's chunks: the budget, or under the
        # admission ladder one of its captured widths
        W = self._effective_budget()
        if self._paged:
            # adapter rows never share: adopted rows carry another delta
            shared = (self._pool.adopt_prefix(slot, prompt)
                      if not st.get("adapter") else 0)
            self._drain_restores()
            starts = self._chunk_starts(n, W, shared)
            self._ensure_admission_rows(slot, min(starts), n)
            self._apply_pool_ops()
        else:
            starts = self._chunk_starts(n, W)
        # pos doubles as the prefill frontier: rows [starts[0], pos) are
        # written; decode steps feed prompt[pos] at pos meanwhile, a row
        # the next chunk rewrites.  ``admit_w``: the slot's chunks keep
        # the width their starts were planned at, whatever the ladder
        # does meanwhile
        st.update(admitting=True, admit_starts=starts, admit_i=0,
                  admit_w=W, pos=starts[0])
        self._slots[slot] = st
        self._count("serving.admitting_claims")

    def _advance_admitting(self) -> bool:
        """Budgeted admission, part 2: run ONE budget-width chunk of the
        oldest admitting slot (claim order) through the graphed
        ``prefill_chunk`` or ``paged_prefill`` kind — at most ``budget``
        prefill tokens a scheduler round.  The last chunk graduates the
        slot.  Host state moves only after the step returned, so a failed
        chunk is run again as it was.  Returns True when a chunk ran."""
        # a stream slot is admitting for the ride, but its rows arrive off
        # the tick: it has no chunk plan
        slot = next((s for s, st in self._slots.items()
                     if st.get("admitting") and not st.get("stream")), None)
        if slot is None:
            return False
        st = self._slots[slot]
        W = st["admit_w"]
        s = st["admit_starts"][st["admit_i"]]
        chunk = st["prompt"][s:s + W]
        kind, kw = (("paged_prefill", {"bucket": W}) if self._paged
                    else ("prefill_chunk", {"width": W}))
        t0 = time.perf_counter()
        fn = engine.ENGINE.get(self._kind(kind), self._spec(**kw))
        feeds = self._feeds(chunk, W, s, len(chunk), slot)
        (logits,) = fn(*self._aid(st["adapter"]), *feeds)
        self._draft_walk(kind, [feeds], **kw)
        self._prefill_rows += len(chunk)
        self._count("serving.prefill_chunks_interleaved")
        if self._paged:
            self._count("kv_pool.prefill_rows", len(chunk))
        st["admit_i"] += 1
        st["pos"] = min(s + len(chunk), len(st["prompt"]))
        if st["admit_i"] == len(st["admit_starts"]):
            self._graduate(slot, st, logits, (_name(fn), 1, t0))
        return True

    def _effective_budget(self) -> int:
        """The chunk width a new budgeted claim plans at: the budget, or
        the admission ladder's current width (one ``warmup`` captured)."""
        if self._adm is None:
            return self._budget
        return self._adm.effective_budget(self._budget)

    def _graduate(self, slot: int, st, logits, wall) -> None:
        """The last chunk landed: draw the admission token exactly as
        monolithic admission does (its NaN guard too) and let the slot
        decode (or retire at once); paged, the prompt's blocks index for
        later prompts.  ``wall``: the last chunk's (name, 1, start)."""
        for k in ("admitting", "admit_starts", "admit_i", "admit_w"):
            del st[k]
        done = self._take_first_token(st, slot, logits, wall)
        if done is None:                        # failed by the NaN guard
            del self._slots[slot]
            return
        if self._paged and not st["adapter"]:
            self._pool.register_prefix(slot, st["prompt"])
        if done:
            del self._slots[slot]
            self._results[st["rid"]] = st["generated"]
            self._release(slot)
            self._tel_retire(st, slot)

    def _release(self, slot: int) -> None:
        """Return a slot (and, paged, its blocks) to the free lists."""
        if self._paged:
            self._pool.free_slot(slot)
        self._free.append(slot)

    def _retire(self, done) -> None:
        for slot in done:
            st = self._slots.pop(slot)
            self._results[st["rid"]] = st["generated"]
            self._release(slot)
            self._tel_retire(st, slot)
        self._admit()
        self._tel_gauges()

    def _chunk_starts(self, n: int, C: int, shared: int = 0) -> list:
        """Chunk starts covering prompt rows [shared, n) at width C.  The
        LAST window starts at n - C (overlapping the previous chunk)
        instead of overrunning the window: overlapped rows recompute to
        the same values, and a write past the window would not fit."""
        if n - shared <= C:
            window = min(self.max_len, self.cfg.max_seq_len)
            return [shared if shared + C <= window else max(0, n - C)]
        return list(range(shared, n - C, C)) + [n - C]

    def _admission_widths(self, prompt_lens=None) -> list:
        """(name, kind, width) of the admission steps prompts of
        ``prompt_lens`` take (default: every bucket up to the serving
        window) — what ``warmup`` captures.  Contiguous: the prompt
        bucket, or the one chunk width; paged: the suffix chunk's width,
        which depends on the adopted prefix, so every power of two from the
        block size up to the window; with a budget, prompts longer than it
        take the budget-width chunk instead — and, with admission control,
        each width of the ladder (``admission.ladder_widths``), so a
        ladder move never captures mid-serve (named as the JAX warmup
        names them)."""
        window = min(self.max_len, self.cfg.max_seq_len)
        kind = "paged_prefill" if self._paged else "prefill_chunk"
        if self._chunk is not None:
            widths = [(kind, min(self._chunk, window))]
        elif self._paged:
            widths, w = [], self._pool.bs
            while True:
                widths.append((kind, min(w, window)))
                if w >= window:
                    break
                w *= 2
        else:
            lens = prompt_lens if prompt_lens is not None else [
                1 << i for i in range(window.bit_length() + 1)
                if (1 << i) <= window]
            widths = [("prefill", _pow2_bucket(int(n), self.max_len,
                                               self.cfg.max_seq_len))
                      for n in lens
                      if not self._budget or int(n) <= self._budget]
        out = {(k, w): f"{k}{w}" for k, w in widths}
        rungs = (self._adm.budget_rungs if self._adm is not None else ()) \
            or ((self._budget,) if self._budget else ())
        for w in rungs:
            if (kind, w) not in out:
                out[(kind, w)] = (f"{kind}{w}" if self._paged
                                  else f"{kind}@{w}")
        return [(name, k, w) for (k, w), name in sorted(out.items())]

    def _prefill_slot(self, prompt, slot: int, aid: int = 0):
        """Admission prefill of ``prompt`` into ``slot`` under adapter
        ``aid`` (a pool-attached server's admission steps are the adapter
        twins, id 0 the base); returns the logits [V] at its last position
        (the step's output buffer: read it before the next admission).
        ``_prefill_steps`` names the step it ran and how often: (name,
        calls)."""
        n = len(prompt)
        ad = self._aid(aid)
        if self._paged:
            return self._paged_prefill_slot(prompt, slot, aid)
        if self._chunk is None:
            bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
            fn = engine.ENGINE.get(self._kind("prefill"),
                                   self._spec(bucket=bucket))
            feeds = self._feeds(prompt, bucket, n, slot)
            (logits,) = fn(*ad, *feeds)
            self._draft_walk("prefill", [feeds], bucket=bucket)
            self._prefill_rows += n
            self._prefill_steps = (_name(fn), 1)
            return logits
        C = self._chunk
        fn = engine.ENGINE.get(self._kind("prefill_chunk"),
                               self._spec(width=C))
        calls = [self._feeds(prompt[s:s + C], C, s, len(prompt[s:s + C]),
                             slot) for s in self._chunk_starts(n, C)]
        for feeds in calls:
            (logits,) = fn(*ad, *feeds)
        self._draft_walk("prefill_chunk", calls, width=C)
        self._prefill_rows += sum(len(prompt[s:s + C])
                                  for s in self._chunk_starts(n, C))
        self._prefill_steps = (_name(fn), len(calls))
        return logits

    def _draft_walk(self, kind: str, calls, **kw) -> None:
        """The draft's admission: its cache walks the target's steps — the
        same kind at the same width over the same feeds (``calls``: one
        feed tuple a step), through its own graphs — so the draft holds
        the prompt's rows once the target does (paged: through the shared
        tables, so an adopted prefix's draft rows are there already)."""
        if self._draft_bind is None:
            return
        dfn = engine.ENGINE.get(kind, self._dspec(**kw))
        for feeds in calls:
            dfn(*feeds)

    def _feeds(self, tokens, width: int, *scalars) -> tuple:
        """An admission step's feeds as host tensors (pinned on a card,
        so the copy into a graph's inputs does not block): the tokens
        [1, width] int64, ``tokens`` then 0s, and each scalar (offset,
        length, slot) as an int64 [1]."""
        padded = np.zeros((1, width), np.int64)
        padded[0, :len(tokens)] = tokens
        return (self._host(padded), *self._scalars(*scalars))

    def _scalars(self, *vals) -> tuple:
        """Each value as a host int64 [1] feed."""
        return tuple(self._host(np.array([v], np.int64)) for v in vals)

    def _ensure_admission_rows(self, slot: int, start: int, stop: int):
        """Make a slot's rows [start, stop) writable for its admission,
        relieving the pool through the evict rung (spill-aware:
        :meth:`_evict_or_spill`) in small LRU batches while it is dry —
        never the whole index at once; cold entries hold only index refs,
        so this request's freshly adopted blocks are never victims.
        Raises ``PoolExhausted`` when nothing more can go."""
        while True:
            try:
                self._pool.ensure_rows(slot, start, stop)
                return
            except kv_pool.PoolExhausted:
                if self._evict_or_spill(_EVICT_BATCH) == 0:
                    raise

    def _paged_prefill_slot(self, prompt, slot: int, aid: int = 0):
        """Paged admission: adopt the longest indexed prompt prefix into
        the slot's table (those rows are never recomputed; spilled blocks
        of it are restored, :meth:`_drain_restores`), make the suffix's
        rows writable (allocate / copy-on-write, relieving the pool while
        it is dry), run the suffix through the ``paged_prefill`` step and
        index this prompt's full blocks for later prompts.  A prompt under
        an adapter (``aid`` != 0) neither adopts nor indexes rows: its
        rows carry the adapter's delta.  Raises ``PoolExhausted`` when
        nothing more can be evicted."""
        n = len(prompt)
        alloc = self._pool
        shared = alloc.adopt_prefix(slot, prompt) if not aid else 0
        self._drain_restores()
        window = min(self.max_len, self.cfg.max_seq_len)
        # the chunk width: prefill_chunk, or one power-of-two chunk over
        # the suffix, floored at the block size; the start backs off from
        # ``shared`` only when the chunk would overrun the window
        C = (min(self._chunk, window) if self._chunk else
             min(max(_pow2_bucket(n - shared), alloc.bs), window))
        starts = self._chunk_starts(n, C, shared)
        self._ensure_admission_rows(slot, min(starts), n)
        self._apply_pool_ops()
        fn = engine.ENGINE.get(self._kind("paged_prefill"),
                               self._spec(bucket=C))
        calls = [self._feeds(prompt[s:s + C], C, s, len(prompt[s:s + C]),
                             slot) for s in starts]
        ad = self._aid(aid)
        for feeds in calls:
            (logits,) = fn(*ad, *feeds)
        self._draft_walk("paged_prefill", calls, bucket=C)
        rows = sum(len(prompt[s:s + C]) for s in starts)
        self._prefill_rows += rows
        self._count("kv_pool.prefill_rows", rows)
        if not aid:
            alloc.register_prefix(slot, prompt)
        self._prefill_steps = (_name(fn), len(starts))
        return logits

    def _apply_pool_ops(self):
        """Run the allocator's pending device work: copy-on-write block
        copies through the graphed ``kv_copy`` step, then the table push
        when the host mirror changed — in place (the graphs read the
        ``tables`` leaf by address), from pinned memory, so an async
        server's push does not wait for the step in flight (the stream
        runs it after that step).  The copies pad to a power-of-two count
        by repeating the first pair (the same copy twice: one step a log2
        bucket, never one a count; a constant filler pair could name a
        destination twice with different sources)."""
        pairs = self._pool.take_copies()
        if pairs:
            width = 1
            while width < len(pairs):
                width *= 2
            idx = np.asarray(pairs + [pairs[0]] * (width - len(pairs)),
                             np.int64)
            src, dst = self._host(idx[:, 0]), self._host(idx[:, 1])
            engine.ENGINE.get("kv_copy", self._spec(k=width))(src, dst)
            if self._draft_cache is not None:
                # a copied block holds both pools' rows of its positions
                engine.ENGINE.get("kv_copy", self._dspec(k=width))(src, dst)
        if self._pool.dirty:
            self.cache["tables"].copy_(self._host(self._pool.tables),
                                       non_blocking=True)
            self._pool.dirty = False

    def _evict_or_spill(self, max_entries: int) -> int:
        """The OOM ladder's evict rung, spill-aware: with
        ``PADDLE_TPU_KV_SPILL_MB`` set, cold prefix chains demote to host
        memory (:meth:`_spill_fetch`) instead of dropping, so the next
        admission restores them instead of recomputing — unless a draft
        cache shares the allocator (the restore would bring back the
        target's rows only): then they drop.  Returns the entries
        freed."""
        pool = self._pool
        if self._spill_slots is not None:
            return pool.spill_cold(max_entries, fetch=self._spill_fetch)
        return pool.evict_cold(max_entries)

    def _spill_fetch(self, blocks) -> list:
        """The one batched device-to-host read a spill round pays: per
        pool leaf one gather of the demoted blocks' rows (block-major),
        then each block's rows copied into a slot of the pinned
        :class:`kv_pool.SpillSlots` (fresh pinned memory only past the
        slots, which the allocator's budget check then drops), and one
        wait — the copies run after the step in flight (the stream is
        ordered).  Returns one record {leaf: [L, bs, ...]} a block."""
        idx = torch.as_tensor(blocks, dtype=torch.long).to(self.device)
        names = [n for n in kv_pool.POOL_LEAVES if n in self.cache]
        rows = {n: self.cache[n].transpose(0, 1)[idx] for n in names}
        cuda = self.device.type == "cuda"
        recs = []
        for j in range(len(blocks)):
            rec = self._spill_slots.take()
            if rec is None:
                rec = {n: torch.empty(rows[n].shape[1:], dtype=rows[n].dtype,
                                      pin_memory=cuda) for n in names}
            for n in names:
                rec[n].copy_(rows[n][j], non_blocking=cuda)
            recs.append(rec)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return recs

    def _drain_restores(self):
        """Promote the spilled blocks the last ``adopt_prefix`` matched
        back into the pool: per slot and contiguous run of blocks, the
        host rows go to the card (one copy a block from pinned memory)
        into a zeroed rows buffer at the run's power-of-two bucket, and
        one ``inject`` step (a graph on the card) writes rows [lo, hi)
        through the slot's table — after the table push, so the scatter
        resolves through the restored blocks.  Runs right after adoption,
        before ``ensure_rows`` can park the request, so a restored index
        entry never outlives this call with unwritten rows."""
        if not self._paged:
            return
        recs = self._pool.take_restores()
        if not recs:
            return
        self._apply_pool_ops()
        bs = self._pool.bs
        by_slot: dict = {}
        for slot, start, rows, _b in recs:
            by_slot.setdefault(slot, []).append((start, rows))
        for slot, items in by_slot.items():
            items.sort(key=lambda it: it[0])
            # one adopt walk restores a contiguous run of blocks, but
            # inject writes every row in [start, length): split on gaps
            runs, run = [], [items[0]]
            for it in items[1:]:
                if it[0] == run[-1][0] + bs:
                    run.append(it)
                else:
                    runs.append(run)
                    run = [it]
            runs.append(run)
            for run in runs:
                lo, hi = run[0][0], run[-1][0] + bs
                bucket = _pow2_bucket(hi, self.max_len, self.cfg.max_seq_len)
                feeds = []
                for name in kv_pool.POOL_LEAVES:
                    if name not in self.cache:
                        continue
                    v0 = run[0][1][name]
                    buf = torch.zeros((v0.shape[0], 1, bucket)
                                      + tuple(v0.shape[2:]),
                                      dtype=self.cache[name].dtype,
                                      device=self.device)
                    for s, rows in run:
                        buf[:, 0, s:s + bs].copy_(rows[name],
                                                  non_blocking=True)
                    feeds.append(buf)
                engine.ENGINE.get("inject", self._spec(bucket=bucket))(
                    *feeds, *self._scalars(lo, hi, slot))

    def _ensure_decode_blocks(self, steps: int = 1):
        """Before a dispatch of ``steps`` decode steps: map (or
        copy-on-write) every active slot's blocks under rows
        [pos, pos + steps) — admission reserves no rows up front, the
        memory point of the paged layout; rows past the tables' reach
        clamp (a block's overrun past a request's end writes no mapped
        row).  A ``PoolExhausted`` here surfaces inside the guarded tick,
        whose OOM ladder relieves the pool and ticks again."""
        if not self._paged or not self._slots:
            return
        cap = self._pool.nmax * self._pool.bs
        for slot, st in self._slots.items():
            self._pool.ensure_rows(slot, st["pos"],
                                   min(st["pos"] + steps, cap))
        self._apply_pool_ops()

    def pending(self) -> bool:
        return bool(self._slots or self._queue)

    def _feed_arrays(self):
        """The batched (tok, pos) feed: the token fed at position i is
        sequence[i] — prompt while i is inside it, the generated tail
        after (``base``: the original prompt length, which differs from
        len(prompt) only for an evicted request re-admitted with its
        progress carried).  Free slots feed token 0 at position 0; their
        row 0 is rewritten by the next admission."""
        tok = np.zeros((self.max_batch,), np.int64)
        pos = np.zeros((self.max_batch,), np.int32)
        for slot, st in self._slots.items():
            i = st["pos"]
            tok[slot] = _token_at(st, i)
            pos[slot] = i
        return tok, pos

    def _sampling_arrays(self):
        """Per-slot (temperature, top_k, top_p); free, prompt-feeding and
        admitting slots sample nothing (temp 0)."""
        temp = np.zeros((self.max_batch,), np.float32)
        tk = np.zeros((self.max_batch,), np.int64)
        tp = np.ones((self.max_batch,), np.float32)
        for slot, st in self._slots.items():
            if st["pos"] >= len(st["prompt"]) - 1 \
                    and not st.get("admitting"):
                temp[slot] = st["temperature"]
                tk[slot] = st["top_k"]
                tp[slot] = st["top_p"]
        return temp, tk, tp

    # -- speculative decoding: batched draft-then-verify rounds -------------

    def _spec_limit(self) -> int:
        """The highest position a round may reach: ``pos + K`` must stay
        inside the cache rows (the slab's, or the tables' reach), the
        target's position table and, with a draft, the draft's.  The JAX
        package's slices clamp an out-of-range start; the port's writes
        would raise or, inside a graph, land in another slot's rows — so
        near the window the server runs plain ticks (:meth:`_spec_gate`)."""
        if self._paged:
            rows = self._pool.nmax * self._pool.bs
        else:
            rows = int(self.cache["k"].shape[2])
        lim = min(rows, self.cfg.max_seq_len)
        if self._draft_cache is not None:
            drows = (rows if self._paged
                     else int(self._draft_cache["k"].shape[2]))
            lim = min(lim, drows, self.draft_cfg.max_seq_len)
        return lim

    def _spec_chunk(self) -> int:
        """Cache rows a round writes a slot, the feed row included: the
        tree's node budget in tree mode, K otherwise."""
        return self._spec_tree_n or self._spec_k

    def _spec_gate(self) -> bool:
        """Whether every slot can take a round, without changing any
        state: past its prompt and not admitting (a round consumes
        feedback positions only; a budgeted claim waits for graduation),
        and ``pos + K`` (``pos + N`` in tree mode) inside
        :meth:`_spec_limit`."""
        K, lim = self._spec_chunk(), self._spec_limit()
        return all(not st.get("admitting")
                   and st["pos"] >= len(st["prompt"]) - 1
                   and st["pos"] + K <= lim
                   for st in self._slots.values())

    def _spec_ready(self) -> bool:
        """Whether THIS tick runs as a speculative round: the gate holds
        and at least one slot still speculates.  A fallen-back slot sits
        out a cooldown of eligible rounds (doubling per trip, 16 -> 256),
        then rejoins with a fresh acceptance window.  In linear mode a
        constrained slot makes the whole batch step plainly (counted as
        ``constraint.spec_fallbacks``): a draft's proposals cannot be
        masked without walking the automaton mid-chunk; tree mode prunes
        banned branches instead (:meth:`_prune_branches_constrained`)."""
        if not self._spec_on or not self._slots:
            return False
        if self._constrained_active() and not self._spec_tree_n:
            self._count("constraint.spec_fallbacks")
            return False
        if not self._spec_gate():
            return False
        alive = False
        for st in self._slots.values():
            if st.get("spec_off"):
                st["spec_cool"] = st.get("spec_cool", 1) - 1
                if st["spec_cool"] <= 0:
                    st["spec_off"] = False
                    st["spec_prop"] = st["spec_acc"] = 0
                    alive = True
                    self._count("spec.reearns")
            else:
                alive = True
        return alive

    def _spec_rng(self, st):
        """A request's host generator for the sampled rounds (draft draws,
        acceptance tests, resamples), seeded from the server's key and
        its id through ``rng.fold_in`` — apart from the device steps'
        counters and the admission draws'."""
        if "spec_rng" not in st:
            st["spec_rng"] = np.random.default_rng(
                rng.fold_in(self._seed_key, _SPEC_COUNTER + st["rid"]))
        return st["spec_rng"]

    def _spec_draft_catchup(self):
        """Advance every lagging slot's draft rows to its target position
        (``spec_dpos``: rows the draft holds) with batched draft steps.
        Lag comes from ``prefill=False`` admission (the prompt went to the
        target only) and from rounds that end past the last drafted row.
        The other slots ride along fed their feed token at their own
        position — a row the proposal steps rewrite identically."""
        fn = None
        while True:
            lag = {slot: st for slot, st in self._slots.items()
                   if not st.get("spec_off")
                   and st.get("spec_dpos", 0) < st["pos"]}
            if not lag:
                return
            tok, pos = self._feed_arrays()
            for slot, st in lag.items():
                d = st.get("spec_dpos", 0)
                tok[slot], pos[slot] = _token_at(st, d), d
            fn = fn or engine.ENGINE.get("step", self._dspec())
            fn(self._host(tok), self._host(pos))
            for slot, st in lag.items():
                st["spec_dpos"] = int(pos[slot]) + 1

    def _spec_propose_draft(self, K):
        """K - 1 batched draft steps from each slot's feed position: the
        draft's proposals for positions pos + 1 .. pos + K - 1 and, for a
        sampled slot, the filtered law q of each draw.  A greedy batch runs
        them as ONE replay of the draft's ``block`` step (each argmax fed
        back on the card, one fetch); a batch with a sampled slot steps
        the draft and draws on the host.  Fallen-back slots ride along
        (their draft rows go stale and are caught up if they re-earn).
        Returns {slot: (tokens, qs or None)}."""
        self._spec_draft_catchup()
        eligible = {slot: st for slot, st in self._slots.items()
                    if not st.get("spec_off")}
        if not eligible or K < 2:
            return {}
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        if not any(temp[s] > 0 for s in eligible):
            fn = engine.ENGINE.get("block", self._dspec(k=K - 1))
            (toks,) = fn(self._host(tok), self._host(pos))
            toks = self._fetch_wait(self._fetch_start(toks))
            props = {s: ([int(t) for t in toks[s]], None) for s in eligible}
        else:
            fn = engine.ENGINE.get("step", self._dspec())
            props = {s: ([], [] if temp[s] > 0 else None) for s in eligible}
            for _ in range(K - 1):
                (logits,) = fn(self._host(tok), self._host(pos))
                lnp = self._fetch_wait(self._fetch_start(logits))
                for slot, st in eligible.items():
                    toks, qs = props[slot]
                    if qs is None:
                        d = int(lnp[slot].argmax())
                    else:
                        q = generate._filtered_probs(
                            lnp[slot], float(temp[slot]), int(tk[slot]),
                            float(tp[slot]))
                        d = int(self._spec_rng(st).choice(len(q), p=q))
                        qs.append(q)
                    toks.append(d)
                    tok[slot] = d
                pos = pos + 1
        self._count("spec.draft_steps", K - 1)
        return props

    def _spec_propose_ngram(self, K):
        """Model-free self-drafting: each speculating slot proposes the
        continuation of the most recent earlier occurrence of its
        sequence's suffix (``generate.ngram_propose``, host work only).  A
        miss proposes nothing: the slot takes row 0 of the round, one
        token, as a plain step would."""
        props = {}
        hits = miss = 0
        for slot, st in self._slots.items():
            if st.get("spec_off"):
                continue
            seq = st["prompt"][:st["base"]] + st["generated"]
            d = generate.ngram_propose(seq, K - 1) if K > 1 else None
            if d:
                props[slot] = (d, None)
                hits += 1
            else:
                miss += 1
        if hits:
            self._count("spec.ngram_hits", hits)
        if miss:
            self._count("spec.ngram_misses", miss)
        return props

    def _spec_accept(self, st, rows, choice, prop):
        """Resolve one slot's round -> the tokens (1..K) it appends.
        ``rows``: its verify logits [K, V] on the host (None when the
        round fetched only ``choice``, the rows' argmax [K]).  Greedy:
        the longest prefix on which the target's argmax agrees with the
        proposals, then the target's own token (at the first disagreement,
        or the bonus row after full agreement) — each kept token is what
        stepwise greedy decode gives at that position.  Sampled:
        :meth:`_spec_sampled_tokens`."""
        draft, qs = prop if prop is not None else ([], None)
        kk = len(draft)
        if st["temperature"] > 0.0:
            toks, accepted = self._spec_sampled_tokens(st, rows, draft, qs)
        else:
            toks, accepted = [], 0
            for j in range(kk):
                t = int(choice[j])
                toks.append(t)
                if t != draft[j]:
                    break
                accepted += 1
            else:
                toks.append(int(choice[kk]))
        if kk:
            self._spec_prop += kk
            self._spec_acc += accepted
            st["spec_prop"] = st.get("spec_prop", 0) + kk
            st["spec_acc"] = st.get("spec_acc", 0) + accepted
            self._count("spec.proposed", kk)
            if accepted:
                self._count("spec.accepted", accepted)
        return toks

    def _spec_sampled_tokens(self, st, rows, draft, qs):
        """Rejection sampling on one slot's verify rows: accept proposal x
        at row j with probability min(1, p_j(x) / q_j(x)); the first
        rejection draws from the residual (p_j - q_j)+ — self-drafting's q
        is the point mass at x, so the residual is p_j with x zeroed — and
        full acceptance draws the bonus row.  Every token's law is the
        target's filtered law.  Returns (tokens, accepted)."""
        t, tk, tp = st["temperature"], st["top_k"], st["top_p"]
        gen = self._spec_rng(st)
        toks, accepted = [], 0
        for j, x in enumerate(draft):
            p = generate._filtered_probs(rows[j], t, tk, tp)
            qx = float(qs[j][x]) if qs is not None else 1.0
            if float(gen.uniform()) < min(1.0, float(p[x]) / max(qx, 1e-300)):
                toks.append(int(x))
                accepted += 1
                continue
            if qs is not None:
                resid = np.maximum(p - qs[j], 0.0)
            else:
                resid = p.copy()
                resid[x] = 0.0
            mass = float(resid.sum())
            if mass > 0.0:
                toks.append(int(gen.choice(len(resid), p=resid / mass)))
            else:
                toks.append(int(gen.choice(len(p), p=p)))
            break
        else:
            p = generate._filtered_probs(rows[len(draft)], t, tk, tp)
            toks.append(int(gen.choice(len(p), p=p)))
        return toks, accepted

    def _spec_fallback_check(self, st):
        """Acceptance-driven fallback: past a fair trial (4 windows of K - 1
        proposals; N - 1 in tree mode, whose proposals count the deepest
        root-to-leaf path a round offered) a slot whose rolling accept
        rate is below ``PADDLE_TPU_SPEC_MIN_ACCEPT`` stops speculating (its
        rounds take row 0 only) until its cooldown ends
        (:meth:`_spec_ready`).  The window halves at 16 windows, so the
        rate follows the request's recent regime."""
        if st.get("spec_off") or not st.get("spec_prop"):
            return
        k = max(1, self._spec_chunk() - 1)
        if st["spec_prop"] >= 16 * k:
            st["spec_prop"] //= 2
            st["spec_acc"] //= 2
        if st["spec_prop"] >= 4 * k \
                and st["spec_acc"] / st["spec_prop"] < self._min_accept:
            st["spec_off"] = True
            st["spec_cool"] = cool = min(256, 2 * st.get("spec_cool0", 8))
            st["spec_cool0"] = cool
            self._count("spec.fallbacks")

    def _spec_round(self) -> bool:
        """Speculative routing above the dispatch modes: a ready batch
        runs one round (:meth:`_tick_spec`); anything else (a slot feeding
        its prompt or admitting, the window's edge, every slot fallen
        back) takes the plain path, counted as a plain target step.
        Returns True when a round ran."""
        if not self._slots and not self._async:
            self._admit()
        if self._slots and self._spec_ready():
            self._tick_spec()
            return True
        if self._slots:
            self._spec_plain_steps += 1
        return False

    def _tick_spec(self):
        """One speculative round: propose (n-gram lookup, or K - 1 batched
        draft steps), ONE graphed ``spec_verify`` pass over every slot,
        acceptance on the host, retire.  Rejected rows land at or past
        each slot's new position, where the causal mask hides them until
        the next round overwrites them: no rollback.  Every slot's rows
        [pos, pos + K) are mapped before any state moves (a
        ``PoolExhausted`` there is retried by the OOM ladder on the same
        state); an async server first drains the step in flight — its
        tokens are real work — and runs its rounds synchronously.  A tree
        server runs :meth:`_tick_spec_tree` instead."""
        if self._spec_tree_n:
            self._tick_spec_tree()
            return
        if self._inflight is not None:
            self._drain_inflight()
            if not self._slots or not self._spec_gate():
                return          # the drained tokens were this tick's work
        t0 = time.perf_counter()
        K = self._spec_k
        self._ensure_decode_blocks(K)
        props = (self._spec_propose_ngram(K) if self._self_draft
                 else self._spec_propose_draft(K))
        tok, pos = self._feed_arrays()
        tokens = np.repeat(tok[:, None], K, axis=1)
        for slot, (draft, _) in props.items():
            tokens[slot, 1:1 + len(draft[:K - 1])] = draft[:K - 1]
        # with a pool the verify gathers each slot's own adapter: accepted
        # tokens are the adapted target's, whatever the base draft said
        kind = f"{self._kind('spec_verify')}@{K}"
        self._fault_check(kind)
        fn = engine.ENGINE.get(self._kind("spec_verify"), self._spec(k=K))
        (logits,) = fn(*self._ids(), self._host(tokens), self._host(pos))
        self._step_no += 1              # after the call: see _tick_impl
        self._spec_rounds += 1
        guard = self._resil and (_faults.active()
                                 or _flags.nan_guard_serving())
        failed = set()
        if guard or any(st["temperature"] > 0.0
                        for st in self._slots.values()):
            # the round's one fetch: the logits, for the sampled laws and
            # the NaN guard
            lnp = self._fetch_wait(self._fetch_start(logits))
            if guard:
                if _faults.active():
                    lnp = _faults.corrupt_nan("logits", lnp)
                finite = np.isfinite(lnp).all(axis=(-2, -1))
                failed = {s for s in self._slots if not finite[s]}
            choice = lnp.argmax(axis=-1)
        else:
            # greedy: the rows' argmax is all acceptance reads
            lnp = None
            choice = self._fetch_wait(self._fetch_start(
                torch.argmax(logits, dim=-1)))
        done, appended = [], []
        for slot, st in self._slots.items():
            if slot in failed:
                continue
            toks = self._spec_accept(st, None if lnp is None else lnp[slot],
                                     choice[slot], props.get(slot))
            old = st["pos"]
            kept = 0
            for t in toks:
                st["generated"].append(t)
                st["pos"] += 1
                kept += 1
                fin = self._constraint_push(st, t)
                if self._finished(st, t) or fin:
                    done.append(slot)
                    break
            appended.append((st, kept))
            if self._draft_cache is not None and not st.get("spec_off"):
                # draft rows [old, old + K - 1) were fed this round; those
                # fed accepted tokens hold through the new position
                st["spec_dpos"] = min(st["pos"], old + K - 1)
            self._spec_fallback_check(st)
        for slot in failed:
            self._fail_request(self._slots.pop(slot), slot,
                               "non-finite spec-verify logits")
        self._tel_tokens(appended, t0,
                         steps=max([k for _, k in appended], default=1),
                         step=_name(fn))
        self._retire(done)

    # -- tree speculation: one verify pass over a token tree --------------

    def _spec_tree_propose(self):
        """Each speculating slot's proposal tree: {slot: tree}, a tree a
        dict of ``tokens`` (index 0 the root, the feed token, already fed:
        None), ``parent`` (parent[0] == -1, topological order),
        ``depth``, ``children`` ({node: [kids in proposal order]}) and,
        with a draft model, ``trunk``, ``dsteps`` and ``qs`` (the draft's
        law at each depth for a sampled slot).  Self-drafting merges up to
        ``branch`` distinct n-gram continuations into a trie
        (``generate.ngram_propose_tree``; a miss proposes nothing); a
        draft model lays a trunk and fans siblings out
        (:meth:`_spec_tree_propose_draft`)."""
        N = self._spec_tree_n
        b = max(1, min(self._spec_branch, N - 1))
        if self._self_draft:
            props = {}
            hits = miss = 0
            for slot, st in self._slots.items():
                if st.get("spec_off"):
                    continue
                seq = st["prompt"][:st["base"]] + st["generated"]
                t = generate.ngram_propose_tree(seq, N, branch=b)
                if t is not None:
                    props[slot] = {"tokens": list(t[0]),
                                   "parent": list(t[1])}
                    hits += 1
                else:
                    miss += 1
            if hits:
                self._count("spec.ngram_hits", hits)
            if miss:
                self._count("spec.ngram_misses", miss)
        else:
            props = self._spec_tree_propose_draft(N, b)
        total = 0
        for slot, tp in props.items():
            n = len(tp["tokens"])
            tp["depth"] = generate.tree_depths(tp["parent"])
            tp["live"] = [True] * n
            total += n - 1
            st = self._slots[slot]
            if st.get("constraint") is not None:
                self._prune_branches_constrained(st, tp)
            kids: dict = {}
            for j in range(1, n):
                if tp["live"][j]:
                    kids.setdefault(tp["parent"][j], []).append(j)
            tp["children"] = kids
        if total:
            self._count("spec.tree_nodes_proposed", total)
        return props

    def _spec_tree_propose_draft(self, N: int, b: int):
        """Draft-model trees: D = ceil((N - 1) / b) batched draft steps lay
        a TRUNK (greedy: the draft's argmax chain; sampled: draws from its
        filtered law q, kept for the acceptance test), then the other
        N - 1 - D node slots fan out as sibling leaves at the trunk
        positions where the draft was least sure (the smallest top-1 /
        top-2 margin; sampled: the smallest chosen-token probability).
        Greedy siblings are the draft's top-2..b tokens; sampled ones are
        drawn from q without replacement, the laws the acceptance chain
        (:meth:`_spec_tree_sampled`) replays.  Each step is one replay of
        the draft's ``step``; its top max(b, 2) logits are taken on the
        card and fetched (the whole logits too when a slot samples).
        Fallen-back slots ride along."""
        self._spec_draft_catchup()
        eligible = {slot: st for slot, st in self._slots.items()
                    if not st.get("spec_off")}
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        sampled = any(temp[s] > 0 for s in eligible)
        D = max(1, -(-(N - 1) // b))
        m = max(b, 2)
        rec = {slot: {"trunk": [], "alts": [], "margins": [],
                      "qs": [] if temp[slot] > 0 else None}
               for slot in eligible}
        fn = engine.ENGINE.get("step", self._dspec())
        for _ in range(D):
            (logits,) = fn(self._host(tok), self._host(pos))
            top = torch.topk(logits, m, dim=-1)
            # values and indices in one fetch (ids < 2 ** 24 are exact)
            packed = self._fetch_start(torch.cat(
                [top.values.float(), top.indices.float()], dim=1))
            lnp = (self._fetch_wait(self._fetch_start(logits))
                   if sampled else None)
            packed = self._fetch_wait(packed)
            vals, idx = packed[:, :m], packed[:, m:].astype(np.int64)
            self._count("spec.draft_steps")
            for slot, st in eligible.items():
                r = rec[slot]
                if r["qs"] is None:
                    d = int(idx[slot, 0])
                    alts = [int(x) for x in idx[slot, 1:b]]
                    r["margins"].append(float(vals[slot, 0]
                                              - vals[slot, 1]))
                else:
                    q = generate._filtered_probs(
                        lnp[slot], float(temp[slot]), int(tk[slot]),
                        float(tp[slot]))
                    gen = self._spec_rng(st)
                    d = int(gen.choice(len(q), p=q))
                    r["qs"].append(q)
                    alts = []
                    qq = q.copy()
                    last = d
                    for _a in range(b - 1):
                        qq[last] = 0.0
                        mass = float(qq.sum())
                        if mass <= 0.0:
                            break
                        last = int(gen.choice(len(qq), p=qq / mass))
                        alts.append(last)
                    # a low chosen-token probability: mass elsewhere
                    r["margins"].append(float(q[d]))
                r["trunk"].append(d)
                r["alts"].append(alts)
                tok[slot] = d
            pos = pos + 1
        props = {}
        for slot, r in rec.items():
            toks: list = [None]
            parent = [-1]
            for i, t in enumerate(r["trunk"]):
                toks.append(int(t))
                parent.append(i)        # trunk node i + 1 at depth i + 1
            budget = N - 1 - len(r["trunk"])
            order = np.argsort(np.asarray(r["margins"], np.float64),
                               kind="stable")
            for i in order:
                if budget <= 0:
                    break
                for a in r["alts"][int(i)]:
                    if budget <= 0:
                        break
                    if a == r["trunk"][int(i)]:
                        continue
                    toks.append(int(a))
                    parent.append(int(i))    # a sibling of trunk node i+1
                    budget -= 1
            props[slot] = {"tokens": toks, "parent": parent,
                           "trunk": [int(t) for t in r["trunk"]],
                           "dsteps": len(r["trunk"]), "qs": r["qs"]}
        return props

    def _prune_branches_constrained(self, st, tp):
        """Before the verify pass, walk ``adapters.constraint_lookahead``
        cursors down one slot's proposed tree from the request's current
        automaton state (never moved: acceptance advances the real state
        through :meth:`_constraint_push`) and mark every node whose token
        the grammar bans — and its subtree — dead.  Dead nodes keep their
        rows in the verify (its shapes are fixed) but leave the candidate
        set, so no accepted path emits a banned token and
        ``constraint.spec_fallbacks`` stays put in tree mode."""
        from . import adapters as _ad

        tokens, parent, live = tp["tokens"], tp["parent"], tp["live"]
        cursors = {0: _ad.constraint_lookahead(st["constraint"])}
        pruned = 0
        for j in range(1, len(tokens)):
            pl = cursors.get(parent[j])
            if pl is None or not pl.allows(tokens[j]):
                live[j] = False       # parent dead, or token banned
                pruned += 1
                continue
            cursors[j] = pl.child(tokens[j])
        if pruned:
            self._count("spec.tree_pruned_constrained", pruned)

    def _spec_tree_accept(self, st, rows, choice, tp):
        """Resolve one slot's tree round -> (tokens it appends, the
        accepted node path).  ``rows``: its verify logits [N, V] on the
        host (None when the round fetched only ``choice``, the rows'
        argmax [N]).  Greedy: from the root, each visited node's target
        argmax descends into the child carrying that token; the first
        miss appends the target's own token and a leaf's choice is the
        bonus, so a round emits at least one token, each what stepwise
        greedy decode gives.  Sampled: per-node multi-candidate rejection
        (:meth:`_spec_tree_sampled`).  A constrained slot's rows are masked
        through a lookahead cursor walked along the path (``rows`` are
        then always fetched), so each token is the masked plain step's;
        its automaton itself advances when the tokens are pushed.  The
        fallback window counts in path lengths: proposed = the deepest
        live node's depth, accepted = edges taken."""
        from . import adapters as _ad

        if tp is None:
            tokens, depth, children, qs = [None], [0], {}, None
            live = [True]
        else:
            tokens, depth = tp["tokens"], tp["depth"]
            children, qs, live = tp["children"], tp.get("qs"), tp["live"]
        cst = st.get("constraint")
        look = _ad.constraint_lookahead(cst) if cst is not None else None
        sampled = st["temperature"] > 0.0
        cur = 0
        toks: list = []
        sel: list = []
        while True:
            if look is not None and look.exhausted:
                break                 # the automaton completed mid-path
            kids = children.get(cur, [])
            row = None if rows is None else rows[cur]
            if look is not None:
                row = _ad.apply_constraint_host(row, look)
            if sampled:
                t, child = self._spec_tree_sampled(st, row, kids, tokens,
                                                   depth, qs, look)
            else:
                t = int(choice[cur]) if look is None else int(row.argmax())
                child = next((j for j in kids if tokens[j] == t), None)
            toks.append(t)
            if look is not None:
                look = look.child(t)
            if child is None:
                break
            sel.append(child)
            cur = child
        maxd = max((int(depth[j]) for j in range(len(tokens)) if live[j]),
                   default=0)
        if maxd:
            self._spec_prop += maxd
            self._spec_acc += len(sel)
            st["spec_prop"] = st.get("spec_prop", 0) + maxd
            st["spec_acc"] = st.get("spec_acc", 0) + len(sel)
            self._count("spec.proposed", maxd)
            if sel:
                self._count("spec.accepted", len(sel))
        if sel:
            self._count("spec.tree_nodes_accepted", len(sel))
        self._tree_path_sum += len(sel)
        self._tree_path_cnt += 1
        return toks, sel

    def _spec_tree_sampled(self, st, row, kids, tokens, depth, qs,
                           look=None):
        """SpecInfer's sequential multi-candidate rejection at one node:
        children x_1..x_m in proposal order are tested against the target
        law p — accept x_i with probability min(1, p(x_i) / q_i(x_i)),
        q_1 the draft's law at this depth; each rejection sets p to
        norm((p - q_i)+) and q_{i+1} to q_i with x_i zeroed, the law the
        proposer drew x_{i+1} from.  All rejected: a draw from the final
        residual; no children: a draw from p (the bonus).  Self-drafted
        children are point masses (q_i = 1 at x_i): accept with p(x_i),
        zero x_i out of p.  Every emitted token's law is p.  Under a
        constraint (``look``, the cursor at this node) ``row`` is already
        masked and q is the draft's law restricted to the allowed set,
        renormalized — the law of a proposal that survived pruning.
        Returns (token, accepted child or None)."""
        gen = self._spec_rng(st)
        p = generate._filtered_probs(row, float(st["temperature"]),
                                     int(st["top_k"]), float(st["top_p"]))
        p0 = p
        q = None
        if qs is not None and kids:
            q = np.asarray(qs[int(depth[kids[0]]) - 1], np.float64)
            if look is not None:
                q = q * look.allowed_mask()
                m = float(q.sum())
                q = q / m if m > 0.0 else None
        for x_node in kids:
            x = tokens[x_node]
            if qs is not None:
                if q is None:
                    break               # the proposer's law is spent
                qx = float(q[x])
                if qx <= 0.0:
                    continue            # the proposer cannot have drawn it
                if float(gen.uniform()) < min(1.0, float(p[x]) / qx):
                    return int(x), x_node
                p = np.maximum(p - q, 0.0)
                pm = float(p.sum())
                q = q.copy()
                q[x] = 0.0
                qm = float(q.sum())
                q = q / qm if qm > 0.0 else None
                if pm <= 0.0:
                    p = None
                    break
                p = p / pm
            else:
                if float(gen.uniform()) < float(p[x]):
                    return int(x), x_node
                p = p.copy()
                p[x] = 0.0
                pm = float(p.sum())
                if pm <= 0.0:
                    p = None
                    break
                p = p / pm
        if p is None:
            p = p0          # a numerically empty residual: the target law
        return int(gen.choice(len(p), p=p)), None

    def _tick_spec_tree(self):
        """One TREE speculative round: propose a tree a slot, ONE graphed
        ``spec_tree_verify`` pass over every slot under the tree mask
        (the topology — ancestor mask [B, N, N] and depths [B, N] — is a
        device feed like the tokens, so no topology keys a graph),
        acceptance on the host, one graphed ``spec_tree_commit`` when some
        slot's path left the trunk (a trunk prefix is already where its
        positions put it), retire.  Slots that propose nothing keep
        self-only mask rows and depth 0.  Every slot's rows [pos, pos + N)
        are mapped (and split copy-on-write) before any state moves: the
        commit writes inside them."""
        if self._inflight is not None:
            self._drain_inflight()
            if not self._slots or not self._spec_gate():
                return          # the drained tokens were this tick's work
        t0 = time.perf_counter()
        N = self._spec_tree_n
        B = self.max_batch
        self._ensure_decode_blocks(N)
        props = self._spec_tree_propose()
        tok, pos = self._feed_arrays()
        tokens = np.repeat(tok[:, None], N, axis=1)
        amask = np.zeros((B, N, N), bool)
        amask[:, np.arange(N), np.arange(N)] = True     # idle rows: self
        depth = np.zeros((B, N), np.int64)
        for slot, tp in props.items():
            n = len(tp["tokens"])
            tokens[slot, 1:n] = tp["tokens"][1:]
            amask[slot, :n, :n] = generate.tree_ancestor_mask(tp["parent"])
            depth[slot, :n] = tp["depth"]
        kind = f"spec_tree_verify@{N}"
        self._fault_check(kind)
        fn = engine.ENGINE.get("spec_tree_verify", self._spec(k=N))
        (logits,) = fn(self._host(tokens), self._host(amask),
                       self._host(depth), self._host(pos))
        self._step_no += 1              # after the call: see _tick_impl
        self._spec_rounds += 1
        self._count("spec.tree_rounds")
        guard = self._resil and (_faults.active()
                                 or _flags.nan_guard_serving())
        failed = set()
        if guard or any(st["temperature"] > 0.0
                        or st.get("constraint") is not None
                        for st in self._slots.values()):
            # the sampled laws, the constrained slots' masked rows and the
            # NaN guard read the logits
            lnp = self._fetch_wait(self._fetch_start(logits))
            if guard:
                if _faults.active():
                    lnp = _faults.corrupt_nan("logits", lnp)
                finite = np.isfinite(lnp).all(axis=(-2, -1))
                failed = {s for s in self._slots if not finite[s]}
            choice = lnp.argmax(axis=-1)
        else:
            lnp = None
            choice = self._fetch_wait(self._fetch_start(
                torch.argmax(logits, dim=-1)))
        done, appended = [], []
        src = None
        for slot, st in self._slots.items():
            if slot in failed:
                continue
            tp = props.get(slot)
            toks, sel = self._spec_tree_accept(
                st, None if lnp is None else lnp[slot], choice[slot], tp)
            if any(s != i + 1 for i, s in enumerate(sel)):
                # the path left the trunk: its rows move into place
                if src is None:
                    src = np.tile(np.arange(1, N, dtype=np.int64), (B, 1))
                src[slot, :len(sel)] = sel
            old = st["pos"]
            kept = 0
            for t in toks:
                st["generated"].append(t)
                st["pos"] += 1
                kept += 1
                fin = self._constraint_push(st, t)
                if self._finished(st, t) or fin:
                    done.append(slot)
                    break
            appended.append((st, kept))
            if self._draft_cache is not None and not st.get("spec_off"):
                # draft rows [old, old + D) were fed the feed token and
                # the trunk: they hold through the committed prefix that
                # agrees with the trunk
                trunk = tp["trunk"] if tp else []
                agree = 0
                for a, t in zip(toks, trunk):
                    if a != t:
                        break
                    agree += 1
                dsteps = tp["dsteps"] if tp else 1
                st["spec_dpos"] = min(st["pos"],
                                      old + 1 + min(agree, dsteps - 1))
            self._spec_fallback_check(st)
        if src is not None:
            # with the round's own positions: failed and trunk slots
            # rewrite their rows in place
            engine.ENGINE.get("spec_tree_commit", self._spec(k=N))(
                self._host(src), self._host(pos))
        for slot in failed:
            self._fail_request(self._slots.pop(slot), slot,
                               "non-finite spec-tree-verify logits")
        self._tel_tokens(appended, t0,
                         steps=max([k for _, k in appended], default=1),
                         step=_name(fn))
        self._retire(done)

    # -- sync dispatch ------------------------------------------------------

    def tick(self):
        """One batched decode step over every slot, then retire finished
        requests and admit queued ones (with ``async_dispatch``: dispatch
        the next step before processing the one in flight) — under the
        resilience guard (:meth:`_guarded`).  The admission controller's
        control tick runs first (one SLO evaluation a window at most)."""
        self._control_tick()
        self._rss_guard()
        self._guarded(self._tick_impl)

    def _control_tick(self):
        """The SLO control loop rides every scheduler round; idle — no
        slot, nothing queued — lets an empty window reset the ladder."""
        if self._adm is not None:
            self._adm.control_tick(idle=not self._slots and not self._queue)

    def _tick_impl(self):
        if self._spec_on and self._spec_round():
            return
        if self._async:
            if not self._slots:
                self._admit()
            if not self._constrained_active():
                self._tick_async()
                return
            # a constrained slot cannot pipeline: the next step's mask
            # needs the token the step in flight has not fetched.  Drain
            # it and run this tick synchronously — the same tokens, one
            # tick of overlap lost
            self._drain_inflight()
            self._count("constraint.sync_fallbacks")
        if not self._slots:
            self._admit()
            if not self._slots:
                self._gap_anchor = None        # idle, not stalled
                return
        # budgeted admission: at most one prefill chunk a round, before
        # the decode step
        self._advance_admitting()
        if self._all_admitting():
            return
        t0 = time.perf_counter()
        self._ensure_decode_blocks(1)
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        mask = self._mask_array()
        n = self._step_no
        tok, pos = self._host(tok), self._host(pos)
        logits = None
        if self._adapters is not None and (temp.any() or mask is not None):
            # the one adapter step of sampled or constrained pool traffic:
            # the mask feed is all zero where nothing is constrained
            self._fault_check("adapter_sample_step")
            fn = engine.ENGINE.get("adapter_sample", self._spec())
            (nxt,) = fn(*self._ids(), tok, pos, self._host(self._key(n)),
                        self._host(temp), self._host(tk), self._host(tp),
                        self._mask_feed(mask))
        elif mask is not None:
            # constrained without a pool: the sampled step plus the mask;
            # greedy slots take the masked argmax
            self._fault_check("masked_step")
            fn = engine.ENGINE.get("masked_step", self._spec())
            (nxt,) = fn(tok, pos, self._host(self._key(n)), self._host(temp),
                        self._host(tk), self._host(tp), self._mask_feed(mask))
        elif temp.any():
            self._fault_check("moe_sample_step" if self.cfg.moe is not None
                              else "sample_step")
            fn = engine.ENGINE.get(self._kind("sample"), self._spec())
            (nxt,) = fn(tok, pos, self._host(self._key(n)), self._host(temp),
                        self._host(tk), self._host(tp), *self._act())
        else:
            self._fault_check("adapter_step" if self._adapters is not None
                              else "step")
            fn = engine.ENGINE.get(self._kind("step"), self._spec())
            (logits,) = fn(*self._ids(), tok, pos, *self._act())
            nxt = torch.argmax(logits, dim=-1)
        # the step counter advances only after the step call returned: a
        # failed call leaves the host state as it was, so the guard's
        # retry dispatches the same step
        self._step_no = n + 1
        nan_slots = self._nan_rows(logits)
        nxt = self._fetch_wait(self._fetch_start(nxt))   # the one fetch
        done, failed, appended = [], [], []
        for slot, st in self._slots.items():
            if st.get("admitting"):
                continue        # rode the step at its frontier: discarded
            i = st["pos"]
            st["pos"] = i + 1
            if i < len(st["prompt"]) - 1:
                continue                 # still feeding prompt
            if slot in nan_slots:
                # after the prompt-feed skip: a slot that does not use
                # this tick's logits is not failed by them
                failed.append(slot)
                continue
            t = int(nxt[slot])
            st["generated"].append(t)
            appended.append((st, 1))
            fin = self._constraint_push(st, t)
            if self._finished(st, t) or fin:
                done.append(slot)
        for slot in failed:
            self._fail_request(self._slots.pop(slot), slot,
                               "non-finite tick logits")
        self._tel_tokens(appended, t0, step=_name(fn))
        self._retire(done)

    def _nan_rows(self, logits) -> set:
        """The NaN guard on a greedy tick's logits [B, V]: the slots whose
        row is not finite.  The full-logits fetch is extra traffic, so it
        runs only when a fault is installed or
        ``PADDLE_TPU_NAN_GUARD_SERVING=1`` (sampled ticks fetch tokens,
        not logits, and are not guarded)."""
        if logits is None or not self._resil or not (
                _faults.active() or _flags.nan_guard_serving()):
            return set()
        lnp = logits.detach().float().cpu().numpy()
        if _faults.active():
            lnp = _faults.corrupt_nan("logits", lnp)
        finite = np.isfinite(lnp).all(axis=-1)
        return {s for s in self._slots if not finite[s]}

    def _all_admitting(self) -> bool:
        """No slot decodes this round: every slot is admitting."""
        return all(st.get("admitting") for st in self._slots.values())

    def _stepwise(self) -> bool:
        """Some slot feeds its prompt token by token or is admitting:
        ``tick_block`` falls back to single ticks."""
        return any(st["pos"] < len(st["prompt"]) - 1 or st.get("admitting")
                   for st in self._slots.values())

    def tick_block(self, block: int = 8):
        """``block`` decode steps with ONE host round trip (greedy, or
        sampled from the per-step keys tick uses).  When some slot is
        still feeding its prompt token by token (``prefill=False``),
        falls back to ``block`` single ticks.  Slots finishing mid-block
        overrun on the device; their surplus tokens are discarded here."""
        block = int(block)
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self._control_tick()
        self._rss_guard()
        self._guarded(lambda: self._tick_block_impl(block))

    def _tick_block_impl(self, block: int):
        if self._spec_on:
            if not self._slots and not self._async:
                self._admit()
            if self._slots and self._spec_ready():
                # a round yields up to K tokens a slot: ceil(block / K)
                # rounds cover the block's work, one fetch each
                for _ in range(max(1, -(-block // self._spec_chunk()))):
                    if not self._slots or not self._spec_ready():
                        break
                    self._tick_spec()
                return
            if self._slots and not self._stepwise():
                # the stepwise fallback's ticks count their own
                self._spec_plain_steps += block
        if self._async:
            self._tick_block_async(block)
            return
        if not self._slots:
            self._admit()
            if not self._slots:
                self._gap_anchor = None
                return
        # a slot at pos == len(prompt)-1 is fine for block decode (its
        # feed token is the prompt's last; everything after is feedback);
        # admitting slots take single ticks too: one chunk a tick is the
        # budgeted interleaving; an MoE or adapter block is greedy only;
        # a constrained slot's mask for step j + 1 needs step j's token
        # on the host
        if self._stepwise() or self._constrained_active() or (
                (self.cfg.moe is not None or self._adapters is not None)
                and any(st["temperature"] > 0.0
                        for st in self._slots.values())):
            for _ in range(block):
                self.tick()
                if not self._slots:
                    break
            return
        t0 = time.perf_counter()
        self._ensure_decode_blocks(block)
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        n = self._step_no
        tok, pos = self._host(tok), self._host(pos)
        if temp.any():
            self._fault_check(f"sample_block@{block}")
            fn = engine.ENGINE.get("sample_block", self._spec(k=block))
            (toks,) = fn(tok, pos, self._host(self._key(n)),
                         self._host(temp), self._host(tk), self._host(tp))
        else:
            # an MoE block: k joint-routing steps, occupancy frozen at
            # dispatch (every slot here is past its prompt, so it only
            # shrinks mid-block: the block-overrun tradeoff)
            self._fault_check(f"{self._kind('block')}@{block}")
            fn = engine.ENGINE.get(self._kind("block"), self._spec(k=block))
            (toks,) = fn(*self._ids(), tok, pos, *self._act())
        self._step_no = n + block        # after the call: see tick
        toks = self._fetch_wait(self._fetch_start(toks))
        done, appended = [], []
        for slot, st in self._slots.items():
            kept = 0
            for j in range(block):
                t = int(toks[slot, j])
                st["generated"].append(t)
                st["pos"] += 1
                kept += 1
                fin = self._constraint_push(st, t)
                if self._finished(st, t) or fin:
                    done.append(slot)
                    break
            appended.append((st, kept))
        self._tel_tokens(appended, t0, steps=block, step=_name(fn))
        self._retire(done)

    # -- async dispatch: one step or block in flight ------------------------

    def _dispatch_feed(self, prev, block: int = 1):
        """Host-side feed of an async dispatch.  Returns (host_tok,
        prev_mask, pos, temp, tk, tp, snap): per slot the feed token comes
        from the host (prompt, or a generated token already fetched)
        unless it is the output of the dispatch still in flight — then
        ``prev_mask`` selects that DEVICE token inside the step.  ``snap``
        records (slot, st, fed position) for the deferred bookkeeping;
        each slot's pos advances by ``block`` optimistically (a slot that
        finishes mid-block retires at process time)."""
        B = self.max_batch
        ht = np.zeros((B,), np.int64)
        pm = np.zeros((B,), bool)
        pos = np.zeros((B,), np.int32)
        temp = np.zeros((B,), np.float32)
        tk = np.zeros((B,), np.int64)
        tp = np.ones((B,), np.float32)
        snap = []
        for slot, st in self._slots.items():
            i = st["pos"]
            n_p = len(st["prompt"])
            if st.get("admitting"):
                # rides the step at its prefill frontier: no snap entry,
                # no advance — the admission owns pos, the output is
                # discarded and the row rewritten by the next chunk
                ht[slot] = st["prompt"][i]
                pos[slot] = i
                continue
            if i < n_p:
                ht[slot] = st["prompt"][i]
            elif i - st["base"] < len(st["generated"]):
                ht[slot] = st["generated"][i - st["base"]]
            else:
                # the previous dispatch's output: on the device, unfetched
                assert prev is not None, "in-flight feed without inflight"
                pm[slot] = True
            if i >= n_p - 1:      # the step at i produces a kept token
                temp[slot] = st["temperature"]
                tk[slot] = st["top_k"]
                tp[slot] = st["top_p"]
            pos[slot] = i
            snap.append((slot, st, i))
            st["pos"] = i + block
        return ht, pm, pos, temp, tk, tp, snap

    def _prev_feed(self, prev):
        """The [B] device tokens feeding off the in-flight dispatch (a
        step's tokens, a block's last column)."""
        if prev is None:
            return torch.zeros((self.max_batch,), dtype=torch.int64,
                               device=self.device)
        return prev["feed"]

    def _rollback_dispatch(self, snap, n):
        """Undo one ``_dispatch_feed``'s optimistic advances after the
        dispatch itself failed: restoring pos and the step counter makes
        a retry dispatch the same step."""
        for slot, st, i in snap:
            if self._slots.get(slot) is st:
                st["pos"] = i
        self._step_no = n

    def _dispatch_step_async(self, prev):
        self._ensure_decode_blocks(1)
        ht, pm, pos, temp, tk, tp, snap = self._dispatch_feed(prev)
        n = self._step_no
        self._step_no = n + 1
        feeds = (self._host(ht), self._host(pm), self._prev_feed(prev),
                 self._host(pos))
        try:
            if self._adapters is not None:
                # one adapter step serves greedy and sampled slots (no
                # mask: constrained slots never dispatch async)
                self._fault_check("adapter_async_step")
                fn = engine.ENGINE.get("adapter_async", self._spec())
                (nxt,) = fn(*self._ids(), *feeds, self._host(self._key(n)),
                            self._host(temp), self._host(tk), self._host(tp))
            elif self.cfg.moe is not None:
                # one joint-routing step serves greedy and sampled slots
                self._fault_check("moe_async_step")
                fn = engine.ENGINE.get("moe_async", self._spec())
                (nxt,) = fn(*feeds, self._host(self._key(n)),
                            self._host(temp), self._host(tk), self._host(tp),
                            *self._act())
            elif temp.any():
                self._fault_check("async_step")
                fn = engine.ENGINE.get("async", self._spec())
                (nxt,) = fn(*feeds, self._host(self._key(n)),
                            self._host(temp), self._host(tk), self._host(tp))
            else:
                # greedy: the k = 1 greedy block, which skips the
                # sampler's sorts and noise the ``async`` step computes
                # for every slot
                self._fault_check("async_step")
                fn = engine.ENGINE.get("async_block", self._spec(k=1))
                nxt = fn(*feeds)[0][:, 0]
        except Exception:
            self._rollback_dispatch(snap, n)
            raise
        self._inflight = {"kind": "step", "fetch": self._fetch_start(nxt),
                          "feed": nxt, "snap": snap, "step_no0": n,
                          "name": _name(fn), "t_disp": time.perf_counter()}

    def _dispatch_block_async(self, prev, block: int):
        self._ensure_decode_blocks(block)
        ht, pm, pos, temp, tk, tp, snap = self._dispatch_feed(prev, block)
        n = self._step_no
        self._step_no = n + block
        feeds = (self._host(ht), self._host(pm), self._prev_feed(prev),
                 self._host(pos))
        try:
            if temp.any():
                self._fault_check(f"async_sample_block@{block}")
                fn = engine.ENGINE.get("async_sample_block",
                                       self._spec(k=block))
                (toks,) = fn(*feeds, self._host(self._key(n)),
                             self._host(temp), self._host(tk),
                             self._host(tp))
            else:
                self._fault_check(f"async_block@{block}")
                fn = engine.ENGINE.get("async_block", self._spec(k=block))
                (toks,) = fn(*feeds)
        except Exception:
            self._rollback_dispatch(snap, n)
            raise
        self._inflight = {"kind": "block", "fetch": self._fetch_start(toks),
                          "feed": toks[:, -1], "snap": snap,
                          "block": block, "step_no0": n, "name": _name(fn),
                          "t_disp": time.perf_counter()}

    def _process_inflight(self, prev):
        """Fetch a dispatch's tokens and run its deferred host
        bookkeeping.  Slots whose request retired (or was replaced by a
        new tenant) since the dispatch are skipped — their tokens are the
        overrun the async pipeline trades for overlap.

        The fetch is the async pipeline's one device-to-host wait; with a
        wall budget (``PADDLE_TPU_STEP_BUDGET_S``) or a fault installed it
        runs under ``resilience.call_with_budget`` (and the ``hang`` fault
        hook), and a blown budget recovers the scheduler
        (:meth:`_recover_wedge`) instead of blocking.  A fetch that fails
        otherwise rolls the scheduler back before the error propagates."""
        try:
            if self._resil and (self._step_budget > 0 or _faults.active()):
                def fetch():
                    _faults.hang("tick", "serving.fetch")
                    return self._fetch_wait(prev["fetch"])

                toks = _resilience.call_with_budget(
                    fetch, self._step_budget, name="serving.fetch")
            else:
                toks = self._fetch_wait(prev["fetch"])
        except _resilience.WedgeError as e:
            self._recover_wedge(prev, e)
            return
        except Exception:
            # a successor dispatched this tick assumed these tokens land
            # first: cancel it too, then let the guard classify
            self._cancel_record(self._inflight)
            self._inflight = None
            self._cancel_record(prev)
            raise
        done, appended = [], []
        for slot, st, i in prev["snap"]:
            if self._slots.get(slot) is not st:
                continue    # retired or replaced while this was in flight
            if prev["kind"] == "step":
                if i < len(st["prompt"]) - 1:
                    continue            # still feeding prompt
                t = int(toks[slot])
                st["generated"].append(t)
                appended.append((st, 1))
                # constrained slots never dispatch async; the push covers
                # a slot admitted in the drain that ends the pipeline
                fin = self._constraint_push(st, t)
                if self._finished(st, t) or fin:
                    done.append(slot)
            else:
                kept = 0
                for j in range(prev["block"]):
                    t = int(toks[slot, j])
                    st["generated"].append(t)
                    kept += 1
                    fin = self._constraint_push(st, t)
                    if self._finished(st, t) or fin:
                        done.append(slot)
                        break
                appended.append((st, kept))
        self._tel_tokens(appended, prev["t_disp"],
                         steps=prev.get("block", 1), step=prev["name"])
        self._retire(done)

    def _drain_inflight(self):
        """Fetch and process the pending async dispatch now (the ladder's
        async -> sync rung: its tokens are real work)."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._process_inflight(prev)

    def _tick_async(self):
        """One async tick: dispatch step N+1 first (feeding the in-flight
        step's device tokens), then block on step N for bookkeeping — the
        card is never idle while the host schedules.  The last dispatch
        before a drain is overrun work whose tokens are never kept."""
        prev, self._inflight = self._inflight, None
        if not self._slots:
            self._admit()
            if not self._slots:
                self._gap_anchor = None
                return
        try:
            # one prefill chunk a round, before the dispatch: the stream
            # runs it after the step in flight, so the frontier row that
            # step wrote is rewritten before anything attends it
            self._advance_admitting()
        except Exception:
            self._inflight = prev      # its tokens are still fetchable
            raise
        if self._all_admitting():
            if prev is not None:
                self._process_inflight(prev)
            return
        try:
            self._dispatch_step_async(prev)
        except Exception:
            self._inflight = prev      # its tokens are still fetchable
            raise
        if prev is not None:
            self._process_inflight(prev)

    def _tick_block_async(self, block: int):
        """Async tick_block: one BLOCK in flight (see :meth:`_tick_async`).
        Prompt-feeding slots fall back to single async ticks after the
        in-flight dispatch is processed — the same tokens.  So does an
        MoE server always: a block would freeze the occupancy mask over
        k steps while the async overrun keeps retired slots contending;
        the stepwise ``moe_async`` step reads occupancy every tick.  A
        pool-attached server (no async adapter block) and a constrained
        batch (each mask needs the last token) take stepwise ticks too."""
        prev, self._inflight = self._inflight, None
        if not self._slots:
            self._admit()
            if not self._slots:
                self._gap_anchor = None
                return
        if self._stepwise() or self.cfg.moe is not None \
                or self._adapters is not None or self._constrained_active():
            if prev is not None:
                self._process_inflight(prev)
            for _ in range(block):
                self.tick()
                if not self._slots:
                    break
            return
        try:
            self._dispatch_block_async(prev, block)
        except Exception:
            self._inflight = prev
            raise
        if prev is not None:
            self._process_inflight(prev)

    # -- multi-tenant serving: adapter ids and constraint masks ------------

    def _constrained_active(self) -> bool:
        """Whether some slot decodes under a constraint automaton: the
        gate of every path that cannot take one (async pipelining, device
        blocks, linear speculation) — a masked step needs the previous
        token on the host to build its mask."""
        return any(st.get("constraint") is not None
                   for st in self._slots.values())

    def _gather_adapter_ids(self):
        """Per-slot adapter ids [max_batch] int64 for this dispatch (free
        slots read row 0, the zero delta); counts
        ``adapters.gather_steps``."""
        ids = np.zeros((self.max_batch,), np.int64)
        for slot, st in self._slots.items():
            ids[slot] = st["adapter"]
        self._count("adapters.gather_steps")
        return ids

    def _mask_array(self):
        """The [B, V] additive constraint mask of the next step, built on
        the host from each constrained slot's automaton
        (``adapters.mask_logits``, which counts
        ``constraint.masked_tokens``), or None when no decoding slot is
        constrained.  Admitting and prompt-feeding slots are left out:
        their step output is never kept."""
        cons = {slot: st["constraint"]
                for slot, st in self._slots.items()
                if st.get("constraint") is not None
                and not st.get("admitting")
                and st["pos"] >= len(st["prompt"]) - 1}
        if not cons:
            return None
        from . import adapters as _ad

        return _ad.mask_logits(cons, self.max_batch, self.cfg.vocab_size)

    def _mask_feed(self, mask):
        """The mask as the sampling step's feed: one [B, V] float32 host
        buffer, pinned on a card and made once, overwritten in place each
        tick (zeros where ``mask`` is None) — the graph copies it into its
        static input.  Safe to reuse: every masked tick fetches its tokens
        before the next one writes the buffer."""
        if self._mask_buf is None:
            self._mask_buf = self._host(np.zeros(
                (self.max_batch, self.cfg.vocab_size), np.float32))
        buf = self._mask_buf.numpy()
        if mask is None:
            buf.fill(0.0)
        else:
            np.copyto(buf, mask)
        return self._mask_buf

    def _constraint_push(self, st, t: int) -> bool:
        """Advance the slot's automaton past the token it just emitted;
        True when the constraint is exhausted (it accepted a complete
        output and allows nothing more): the slot retires whatever
        max_new, eos or stop say."""
        cst = st.get("constraint")
        if cst is None:
            return False
        cst.advance(t)
        return cst.exhausted

    # -- resilience: the guarded tick, the OOM ladder, wedge recovery ------

    def _fault_check(self, kind: str):
        """The fault-injection hook (``PADDLE_TPU_FAULTS``), at the JAX
        server's sites and under its names: just before a step's
        ``Engine.get`` and call, with no host state moved yet, so a tick
        retried after an injected fault is the same tick.  A fault is
        never raised inside a capture.  Fires whatever the resilience
        switch says (with it off the fault propagates).  Async sites do
        not take ``wedge`` faults — their fetch has the real hang hook;
        at a sync site a wedge fault raises ``InjectedWedge``."""
        if _faults.active():
            kinds = (("oom", "error") if kind.startswith("async")
                     else ("oom", "error", "wedge"))
            _faults.check("tick", f"serving.{kind.split('@')[0]}",
                          f"serving.{kind}", kinds=kinds)

    def _guarded(self, fn):
        """Run one tick under the resilience guard: an allocator OOM
        engages one rung of the ladder (:meth:`_oom_degrade`) and ticks
        again; anything else, or an OOM with the ladder spent, propagates.
        A clean tick after a wedge recovery clears the wedge verdict."""
        if not self._resil or self._in_tick:
            return fn()
        self._in_tick = True
        self._wedge_event = False
        try:
            while True:
                try:
                    out = fn()
                except Exception as e:  # noqa: BLE001 - classified below
                    # a failed rank (``RankFailure``) ends the mesh: no
                    # rung of the ladder can help it
                    if (_resilience.is_oom(e) and not getattr(e, "fatal",
                                                             False)
                            and self._oom_degrade(e)):
                        continue
                    raise
                if self._wedged and not self._wedge_event:
                    self._wedged = False
                    _telemetry.clear_runtime_wedge()
                    self._count("resilience.wedge_recoveries")
                return out
        finally:
            self._in_tick = False

    def _oom_degrade(self, exc) -> bool:
        """One rung of the OOM ladder; True when one was applied and the
        tick should run again:

        1. evict (or spill) cold prefix-cache blocks — paged, and only for
           the pool running dry or an injected OOM: those blocks are host
           accounting inside a preallocated pool, and free no device
           memory for a real allocator failure;
        2. async -> sync dispatch (the step in flight is processed first:
           its tokens are real work);
        3. halve the admitted batch (``_admit_cap``), evicting the slots
           past it;
        4. evict the lowest-priority slot.

        The JAX server refuses to retry when the failed step consumed the
        cache's donated buffers.  Here nothing is donated: every step
        writes the cache in place, so a step that failed part way may
        already have written some of its rows — at the positions it was
        fed.  The retry feeds the same tokens at the same positions (the
        host state moved only after a call returned), so it rewrites
        those rows with the same values, and the rows past them were
        never exposed to any mask.  Retries are therefore always sound,
        and the tests hold a retried serve's tokens to an unfaulted one's.

        Rungs 2-4 free no device memory for a real allocator failure
        either (the cache and graphs are preallocated): on the card a real
        OOM is classified and survived, while the ladder is driven by
        injected faults."""
        applied = None
        pool_relievable = self._paged and isinstance(
            exc, (kv_pool.PoolExhausted, _faults.InjectedOOM))
        if pool_relievable and self._evict_or_spill(
                max(_EVICT_BATCH, len(self._slots))) > 0:
            applied = "evict_prefix_cache"
        elif self._async:
            try:
                self._drain_inflight()
            except Exception:  # noqa: BLE001 - the drain failing rolled
                # the scheduler back already (_process_inflight): the
                # retry decodes those steps again from consistent state
                pass
            self._async = False
            applied = "sync_dispatch"
        elif self._admit_cap > 1:
            self._admit_cap = max(1, self._admit_cap // 2)
            self._evict_to_cap()
            applied = f"admit_cap={self._admit_cap}"
        elif len(self._slots) > 1:
            self._evict_one()
            applied = "evict"
        if applied is None:
            return False
        self._count("resilience.oom_retries")
        if self._tel:
            now = time.perf_counter()
            _telemetry.set_gauge("resilience.admit_cap", self._admit_cap)
            _telemetry.event("resilience.oom_degrade", now, now,
                             action=applied, error=str(exc)[:200])
        return True

    def _evict_one(self) -> bool:
        """Evict the lowest-priority (ties: youngest) active slot back to
        the FRONT of the queue with its progress carried: re-admitted, its
        prompt is the original prompt plus what it generated, so a greedy
        request still produces its exact full generation.  An admitting
        (half-prefilled) slot has generated nothing: it comes back with
        its original prompt.  Past ``PADDLE_TPU_EVICT_REQUEUE_MAX``
        evictions the request fails with the ``error`` status instead."""
        if not self._slots:
            return False
        slot = min(self._slots, key=lambda s: (self._slots[s]["priority"],
                                               -self._slots[s]["t_submit"]))
        st = self._slots.pop(slot)
        self._release(slot)
        evictions = st["evictions"] + 1
        cap = _flags.requeue_max()
        if cap and evictions > cap:
            rid = st["rid"]
            self._status[rid] = "error"
            self._err_reason[rid] = (
                f"evicted {evictions} times (> "
                f"PADDLE_TPU_EVICT_REQUEUE_MAX={cap}); giving up")
            self._count("serving.requests_failed")
            self._count("resilience.evict_requeue_overflows")
            self._event("serving.request_failed", st["t_submit"],
                        time.perf_counter(), tid=slot, rid=rid,
                        reason="evict_requeue_overflow")
            return True
        # prompt[:base] strips an earlier eviction's carry (generated
        # holds it already)
        self._queue.insert(0, {
            "rid": st["rid"],
            "prompt": st["prompt"][:st["base"]] + st["generated"],
            "max_new": st["max_new"], "stop": st["stop"],
            "temperature": st["temperature"], "top_k": st["top_k"],
            "top_p": st["top_p"], "ttl": st["ttl"],
            "priority": st["priority"], "tenant": st["tenant"],
            "adapter": st["adapter"], "adapter_name": st["adapter_name"],
            "constraint": st["constraint_spec"],
            "trace": st["trace"], "evictions": evictions,
            "carry": list(st["generated"]), "t_submit": st["t_submit"],
            # the class sort keeps the request's place: its first
            # enqueue time; the TTL bounds the wait of this queue entry:
            # a fresh clock
            "t_enqueue": st["t_enqueue"], "t_queued": time.perf_counter()})
        self._count("resilience.oom_evictions")
        return True

    def _evict_to_cap(self):
        while len(self._slots) > self._admit_cap:
            if not self._evict_one():
                break

    def _cancel_record(self, rec):
        """Roll the scheduler back as if the dispatch ``rec`` had never
        been made: every still-active slot's pos returns to its fed
        position and the step counter rewinds, so the next dispatch runs
        the same steps again (greedy: the same tokens and rows; sampled:
        the same counter-keyed draws)."""
        if rec is None:
            return
        for slot, st, i in rec["snap"]:
            if self._slots.get(slot) is st:
                st["pos"] = min(st["pos"], i)
        self._step_no = min(self._step_no, rec["step_no0"])

    def _recover_wedge(self, prev, exc):
        """The watchdog tripped: the async fetch blew its wall budget.
        Mark the server (and the process's telemetry verdict) wedged,
        cancel both dispatches in flight — the unfetched ``prev`` and the
        one dispatched this tick — and roll every affected slot back to
        its earliest dispatched position: the next ticks decode those
        steps again over the same rows, so the requests still finish with
        the tokens of an unfaulted serve.  The watchdog thread waiting on
        the fetch is abandoned; its late result is discarded.

        What this recovers is the injected drill: the "hung" fetch is a
        host thread asleep in the ``hang`` hook while the real replay has
        long finished.  A kernel that really hangs cannot be abandoned on
        CUDA (the stream and every later copy would wait behind it); no
        claim is made about real device hangs."""
        self._wedge_event = True
        self._wedged = True
        _telemetry.set_runtime_wedge(str(exc))
        self._cancel_record(self._inflight)
        self._inflight = None
        self._cancel_record(prev)
        if self._tel:
            now = time.perf_counter()
            _telemetry.event("resilience.wedge", now, now,
                             error=str(exc)[:200])

    def _rss_guard(self):
        """Host-RSS watchdog hook (``PADDLE_TPU_KV_SPILL_RSS_MB``): every
        16th scheduler tick reads ``/proc`` and, over the threshold, runs
        one bounded relief round (``PagedAllocator.rss_watchdog``).  A
        single int compare unless the flag armed the allocator."""
        pool = self._pool
        if pool is None or not pool.rss_limit_bytes:
            return
        self._rss_tick = (self._rss_tick + 1) & 15
        if not self._rss_tick:
            pool.rss_watchdog()

    # -- telemetry (host values only: never an extra device sync) ----------

    def _count(self, name: str, n: int = 1) -> None:
        """Count into the telemetry registry and this server's twin
        (:meth:`stats`); the token and request totals also into the fleet
        plane's twin (:meth:`_count_local`)."""
        if self._tel:
            _telemetry.count(name, n)
            self._counts[name] = self._counts.get(name, 0) + n
            if name in _LOCAL_COUNTERS:
                self._count_local(name, n)

    def _count_local(self, name: str, n: int = 1) -> None:
        """The per-server twin of a token or request total
        (:meth:`local_snapshot`)."""
        self._counts_local[name] = self._counts_local.get(name, 0) + n

    def _observe(self, name: str, v: float, n: int = 1) -> None:
        """Observe into the registry's histogram and this server's own
        (:meth:`local_snapshot`)."""
        _telemetry.observe(name, v, n)
        if self._tel:
            h = self._hist_local.get(name)
            if h is None:
                h = self._hist_local[name] = _telemetry.Histogram(name)
            h.observe(v, n)

    def local_snapshot(self) -> dict:
        """This server's latency histograms as JSON-safe
        ``Histogram.state()`` dicts by name, and its token and request
        totals (``counters``) — the fleet metrics plane's merge inputs,
        apart from the process-wide registry a loopback fleet's replicas
        share."""
        return {"histograms": {name: h.state() for name, h in
                               sorted(self._hist_local.items())},
                "counters": dict(sorted(self._counts_local.items()))}

    def _event(self, name: str, t0: float, t1: float, **args) -> None:
        if self._tel:
            _telemetry.event(name, t0, t1, **args)

    def _tel_gauges(self):
        """Occupancy gauges off the scheduler's host state, and the card
        memory sample (rate-limited; a host query, never a sync)."""
        if not self._tel:
            return
        _telemetry.sample_device_stats()
        act = len(self._slots)
        _telemetry.set_gauge("serving.queue_depth", len(self._queue))
        _telemetry.set_gauge("serving.active_slots", act)
        _telemetry.set_gauge("serving.slot_occupancy", act / self.max_batch)
        _telemetry.set_gauge("serving.admitting_slots",
                             sum(1 for st in self._slots.values()
                                 if st.get("admitting")))
        _telemetry.set_gauge("serving.kv_utilization", self._kv_util())
        if self._adapters is not None:
            # per-adapter active slots, every registered name each sample
            # (a retired adapter's gauge drops to 0)
            active = self._adapters_active()
            for nm in list(self._adapters.names()) + ["base"]:
                _telemetry.set_gauge(f'adapters.active{{adapter="{nm}"}}',
                                     active.get(nm, 0))
        if self._spec_on and self._spec_prop:
            _telemetry.set_gauge("serving.spec_accept_rate",
                                 self._spec_acc / self._spec_prop)
        if self._spec_tree_n and self._tree_path_cnt:
            _telemetry.set_gauge("serving.spec_tree_accept_len",
                                 self._tree_path_sum / self._tree_path_cnt)
        if self._paged and self._pool is not None:
            _telemetry.set_gauge("kv_pool.blocks_in_use",
                                 self._pool.blocks_in_use)
            _telemetry.set_gauge("kv_pool.host_spill_bytes",
                                 self._pool.host_spill_bytes)

    def _adapters_active(self) -> dict:
        """Active slots per adapter name ("base" for id 0)."""
        out: dict = {}
        for st in self._slots.values():
            nm = st.get("adapter_name") or "base"
            out[nm] = out.get(nm, 0) + 1
        return out

    def _tel_retire(self, st, slot: int):
        """End of a request's life: its end-to-end latency and event."""
        if not self._tel:
            return
        now = time.perf_counter()
        self._observe("serving.e2e_ms", (now - st["t_submit"]) * 1e3)
        self._count("serving.requests_completed")
        _telemetry.event("serving.request", st["t_submit"], now, tid=slot,
                         rid=st["rid"], prompt_len=len(st["prompt"]),
                         tokens=len(st["generated"]))
        tr = st.get("trace")
        if tr:
            # its trace: one decode span (first token to retire) and a
            # zero-width retire mark
            n = len(st["generated"])
            self._span_ring.record(tr, "decode", st.get("t_first", now), now,
                                   rid=st["rid"], tokens=n)
            self._span_ring.record(tr, "retire", now, now, rid=st["rid"],
                                   tokens=n)

    def _tel_tokens(self, appended, t0: float, steps: int = 1,
                    step: str | None = None):
        """A round's records from the tokens it just appended
        (``appended``: (state, count) pairs): tick latency, the device
        feed's wall of ``step`` (the Engine's step name; the wall runs to
        the token fetch, so it covers the card's work), the decode gap
        since the last round that appended tokens, first-token time for a
        slot's first kept token (``prefill=False`` — prefill admission
        stamps it itself) and per-token latency."""
        total = sum(n for _, n in appended)
        self._tokens += total
        if not self._tel:
            return
        now = time.perf_counter()
        dt_ms = (now - t0) * 1e3
        self._observe("serving.tick_ms", dt_ms)
        if step is not None:
            _telemetry.note_step_time(step, dt_ms / 1e3)
        if not appended:
            return
        # the decode gap: the wall between two rounds that appended
        # tokens — the stall budgeted admission bounds, and the
        # admission ladder's decode-gap objective
        if self._gap_anchor is not None:
            self._observe("serving.decode_gap_ms",
                          (now - self._gap_anchor) * 1e3)
        self._gap_anchor = now
        per_tok = dt_ms / max(steps, 1)
        for st, n in appended:
            if "t_first" not in st:
                st["t_first"] = now
                self._observe("serving.ttft_ms",
                              (now - st["t_submit"]) * 1e3)
                if n > 1:
                    self._observe("serving.tpot_ms", per_tok, n=n - 1)
            else:
                self._observe("serving.tpot_ms", per_tok, n=n)
        self._count("serving.tokens_generated", total)

    def warmup(self, prompt_lens=None, blocks=(), sample: bool = False,
               constrained: bool = False):
        """Build (on the card: capture) every step this server will serve
        before its first request: ``Engine.warmup`` (text/engine.py) —
        with an adapter pool every site's adapter twin (ids all zero), and
        ``sample`` or ``constrained`` the ``adapter_sample`` step;
        ``constrained=True`` without a pool the ``masked_step``; a paged
        server the ``kv_copy`` widths up to its batch (a fleet replica's
        ``inject`` steps are the Router's to warm).  Requires an idle
        server; leaves the step counter, the kernels' launch counters and
        every request's state as they were.  Returns {step: seconds}."""
        return engine.ENGINE.warmup(self, prompt_lens=prompt_lens,
                                    blocks=blocks, sample=sample,
                                    constrained=constrained)

    # -- results and state --------------------------------------------------

    def result(self, rid: int):
        """Generated tokens (no prompt) once the request finished.  A
        request shed past its deadline raises
        ``resilience.DeadlineExceeded``; one refused by admission control
        raises ``resilience.Overloaded`` (it never queued: back off and
        submit again); one failed by the NaN guard or the requeue bound
        raises ``RuntimeError`` with the reason — in each case it retired
        cleanly and the server serves on."""
        if rid in self._dropped:
            raise RuntimeError(
                f"request {rid} was abandoned unfinished when the server "
                f"was closed")
        disp = self._status.get(rid)
        if disp == "timeout":
            raise _resilience.DeadlineExceeded(
                f"request {rid} was shed: still queued past its ttl")
        if disp == "rejected":
            raise _resilience.Overloaded(
                f"request {rid} was rejected by admission control (rate "
                f"limit, queue bound, or overload shed) — it never queued; "
                f"back off and resubmit")
        if disp == "error":
            raise RuntimeError(
                f"request {rid} failed: "
                f"{self._err_reason.get(rid, 'non-finite logits')} (the "
                f"request was retired cleanly; the server is still "
                f"serving)")
        return self._results[rid]

    def status(self, rid: int) -> str:
        """One of ``ok`` (result ready), ``timeout`` (shed past its
        deadline), ``rejected`` (refused by admission control at the
        door), ``error`` (NaN guard, requeue bound), ``dropped``
        (abandoned by close), ``active`` (decoding, or in the dispatch in
        flight), ``queued``."""
        if rid in self._results:
            return "ok"
        disp = self._status.get(rid)
        if disp is not None:
            return disp
        if rid in self._dropped:
            return "dropped"
        if any(st["rid"] == rid for st in self._slots.values()) or (
                self._inflight is not None
                and any(st["rid"] == rid
                        for _, st, _ in self._inflight["snap"])):
            return "active"
        if any(req["rid"] == rid for req in self._queue):
            return "queued"
        raise KeyError(f"unknown request id {rid}")

    @property
    def wedged(self) -> bool:
        """The wedge watchdog's verdict for this server: an async fetch
        blew its wall budget and no clean tick has completed since."""
        return self._wedged

    def _kv_util(self) -> float:
        """KV utilization: the paged pool's blocks in use over its
        blocks, or the slab's filled rows over its rows."""
        if self._paged:
            return self._pool.blocks_in_use / max(1, self._pool.N)
        rows = (int(self.cache["k"].shape[2]) if self.cache is not None
                else self.max_len)
        return sum(min(st["pos"], rows) for st in self._slots.values()) \
            / (self.max_batch * rows)

    def load_stats(self, include_spans: bool = False) -> dict:
        """Scheduler load read from host state: queue depth, slot use
        (free slots within the OOM ladder's and the admission ladder's
        caps), KV utilization, the admit cap and the wedge verdict, the
        tokens generated and the prompt rows admission computed so far,
        the admission ladder's rung (``admission_rung``, 0 without a
        controller) and whether it is at 0 (``slo_ok``), the server-wide
        speculative acceptance rate (``spec_accept_rate``: accepted over
        scored proposals, None before the first) and, in tree mode, the
        mean accepted path length a slot-round (``spec_tree_accept_len``,
        None before the first round), the slots decoding under a
        constraint (``constrained_slots``) and, with an adapter pool, the
        active slots per adapter name (``adapters_active``, "base" for id
        0).  An MoE server adds its routing
        totals, drained from the device accumulator (:meth:`_moe_snapshot`,
        which waits for the steps in flight and advances the ``moe.*``
        telemetry): ``moe_dropped_tokens`` (cumulative dropped
        token->expert assignments) and ``moe_expert_load`` (each expert's
        kept assignments).  A paged server
        adds its prefix hit rate (adopted rows over adoptable rows), the
        spill tier's resident host bytes and its allocator's ``kv_pool``
        stats.  ``include_spans=True`` also takes the completed trace
        spans (:meth:`drain_spans`: ``spans``, ``span_drops``)."""
        act = len(self._slots)
        eff_cap = self._admit_cap
        if self._adm is not None:
            eff_cap = min(eff_cap,
                          self._adm.effective_admit_cap(self.max_batch))
        stats = {
            "queue_depth": len(self._queue),
            "active_slots": act,
            "free_slots": min(len(self._free), max(0, eff_cap - act)),
            "slot_occupancy": act / self.max_batch,
            "kv_utilization": self._kv_util(),
            "admit_cap": self._admit_cap,
            "wedged": self._wedged,
            "tokens_generated": self._tokens,
            "prefill_rows": self._prefill_rows,
            "admitting_slots": sum(1 for st in self._slots.values()
                                   if st.get("admitting")),
            "prefill_budget": self._budget,
            "admission_rung": 0 if self._adm is None else self._adm.rung,
            "slo_ok": self._adm is None or self._adm.rung == 0,
            "spec_accept_rate": (self._spec_acc / self._spec_prop
                                 if self._spec_prop else None),
            "spec_tree_accept_len": (self._tree_path_sum
                                     / self._tree_path_cnt
                                     if self._tree_path_cnt else None),
            "constrained_slots": sum(1 for st in self._slots.values()
                                     if st.get("constraint") is not None),
        }
        if self._adapters is not None:
            stats["adapters_active"] = self._adapters_active()
        if self._moe_stats is not None:
            stats["moe_dropped_tokens"], stats["moe_expert_load"] = \
                self._moe_snapshot()
        if include_spans:
            stats["spans"], stats["span_drops"] = self.drain_spans()
        if self._paged:
            pool = self._pool
            stats["prefix_hit_rate"] = pool.prefix_hits / max(
                1, pool.prefix_hits + pool.prefix_misses)
            stats["prefix_summary"] = pool.prefix_summary()
            stats["host_spill_bytes"] = pool.host_spill_bytes
            stats["kv_pool"] = pool.stats()
        return stats

    def drain_spans(self):
        """Take this server's completed trace spans (at most
        ``PADDLE_TPU_TRACE_PIGGYBACK`` a take) and the number dropped
        since the last take: (spans, drops)."""
        return self._span_ring.drain(_flags.trace_piggyback_cap())

    def stats(self) -> dict:
        """This server's telemetry counters so far, under the registry's
        (the JAX server's) names — ``serving.*`` and ``resilience.*``:
        requests submitted, completed, shed and failed, tokens generated,
        budgeted claims and chunks, ladder rungs and evictions, wedge
        recoveries, and, paged, the rows admission prefilled and the
        admissions the pool parked.  The registry
        (``paddle_tpu_torch.telemetry``) holds the process-wide sums,
        the allocator's ``kv_pool.*`` counters among them.  A speculating
        server adds ``spec.*`` (proposed, accepted, draft steps, n-gram
        hits and misses, fallbacks, re-earns; tree rounds, nodes proposed
        and accepted) and
        ``admission.spec_forced``; a pool-attached server
        ``adapters.gather_steps``; constrained traffic
        ``constraint.sync_fallbacks`` and ``constraint.spec_fallbacks``
        (``constraint.masked_tokens`` is the registry's).  Empty with
        ``PADDLE_TPU_TELEMETRY=0``."""
        return dict(sorted(self._counts.items()))

    def close(self):
        """Release this server's steps (``Engine.purge``: its graphs and
        their memory pools, the draft's too) and its KV cache (and the
        draft's; paged, every block, the prefix index and the spill
        store).  The step in flight is
        abandoned unfetched (a wedged fetch cannot hang the exit);
        unfinished requests too: ``result()`` raises for them and
        ``status()`` says ``dropped``.  A wedge verdict this server raised
        is cleared and the metrics endpoint's thread joined.  An MoE
        server publishes its final routing totals first.  Idempotent."""
        if self._wedged:
            self._wedged = False
            _telemetry.clear_runtime_wedge()
        if self._moe_stats is not None:
            try:
                self._moe_snapshot()
            except Exception:  # noqa: BLE001 - a failed card must not
                pass           # block the shutdown
            self._moe_stats = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        self._inflight = None
        for bind in (self._bind, self._draft_bind):
            if bind is not None:
                # by binding alone: a routing flag flipped since a capture
                # changed its config key, not what it holds
                engine.ENGINE.purge(binding=bind)
                if self._mesh is not None:
                    # the ranks' steps, graphs and cache (nothing to ask of
                    # a broken mesh: its ranks are being stopped)
                    bind.release()
        if self._mesh is not None:
            for sp, own in zip((getattr(self, "_sparams", None),
                                getattr(self, "_draft_sparams", None)),
                               self._own_params):
                if own:
                    sp.release()
        self._bind = self._draft_bind = None
        self.cache = self._draft_cache = None
        if self._paged:
            self._pool.close()
            self._spill_slots = None
        for st in self._slots.values():
            self._dropped.add(st["rid"])
        for req in self._queue:
            self._dropped.add(req["rid"])
        self._slots.clear()
        self._queue.clear()
        self._free = list(range(self.max_batch))

    def shutdown(self):
        """Alias of :meth:`close` (the serving-fleet idiom)."""
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
