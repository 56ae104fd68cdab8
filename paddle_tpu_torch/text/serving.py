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

Faults are injected by ``PADDLE_TPU_FAULTS`` (``paddle_tpu_torch/
faults.py``) at the JAX server's sites, and every event is counted in
the telemetry registry (``paddle_tpu_torch/telemetry.py``) under the
JAX server's counter names.

Everything else the JAX server does — speculation, adapters and
constraints, tensor parallelism, MoE, admission control and its SLO
ladder, the metrics endpoint and request spans, the fleet — is later
slices' work; no entry point of the port reaches it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import engine, generate, gpt, kv_pool
from .. import faults as _faults
from .. import flags as _flags
from .. import resilience as _resilience
from .. import resolve_device, rng
from .. import telemetry as _telemetry

__all__ = ["decode_step_batched", "sample_step_batched",
           "decode_block_batched", "sample_block_batched", "DecodeServer",
           "validate_request"]


# cold prefix-cache entries evicted per relief round when the pool runs dry
# (LRU-first batches; never the whole index at once)
_EVICT_BATCH = 4
# admission draws use counters from here up (one per request id), clear of
# the per-step counters of the device steps
_ADMIT_COUNTER = 1 << 40


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


# -- the sampling stream: counter-based, keyed (seed, step) ----------------
# Gumbel noise hashed from (seed key, step counter, element) by the port's
# counter-based helper (``paddle_tpu_torch/rng.py``): no generator state, so
# a replayed graph draws what the eager step draws.


def _sample_batched(logits, key, temp, topk, topp):
    """Per-slot sampling over batched logits [B, V]: temperature, top-k,
    nucleus (generate._filter_logits) with PER-SLOT parameters, so one
    step serves a batch mixing greedy and sampled requests; the draw is
    the Gumbel-max of the filtered logits under ``key``'s noise (exactly
    a categorical draw from their softmax).  temp/topp float32 [B], topk
    int [B] (0 = off); slots with temp == 0 take the argmax of the raw
    logits."""
    scaled = generate._filter_logits(logits, temp, topk, topp)
    noise = rng.gumbel(key, scaled.shape, scaled.device)
    sampled = torch.argmax(scaled.float() + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)


def _step_key(key, j: int):
    """The key of step n + j from the key of step n (on the device)."""
    return torch.stack([key[0], key[1] + j])


def sample_step_batched(params, cache, tok, pos, key, temp, topk, topp,
                        cfg: gpt.GPTConfig):
    """One batched decode step that returns sampled TOKENS [B] (greedy
    where temp == 0) instead of logits."""
    logits, cache = decode_step_batched(params, cache, tok, pos, cfg)
    return _sample_batched(logits, key, temp, topk, topp), cache


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
    ``device`` defaults to the card; ``params`` must live there.  The
    resilience switches (TTLs, the OOM ladder, the spill tier, the wedge
    watchdog, the NaN guard: module note) are read from the environment
    at construction.  A server is a context manager: leaving the
    ``with`` block closes it.

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
                 prefill_budget: int | None = None, _graphs: bool = True):
        self.device = resolve_device(device)
        if params["wte"].device != self.device:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"server was asked to run on {self.device}")
        if max_batch < 1 or max_len < 1:
            raise ValueError("max_batch and max_len must be >= 1")
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
            cfg, max_batch, max_len, self.device, layout=lay,
            block_size=block_size, num_blocks=num_blocks)
        # the host allocator mirrors the built pool's geometry; with the
        # spill tier on, its host memory is pinned here, once
        self._pool = (kv_pool.PagedAllocator(
            *kv_pool._geometry(self.cache), max_batch)
            if self._paged else None)
        self._spill_slots = (kv_pool.SpillSlots(
            self.cache, self._pool.spill_limit_bytes,
            pin=self.device.type == "cuda")
            if self._paged and self._pool.spill_limit_bytes else None)
        # what every step of this server is bound to (text/engine.py)
        self._bind = engine.Binding(params, self.cache, graphs=_graphs)
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
        self._next_rid = 0
        self._tokens = 0                          # tokens generated so far
        # telemetry: the registry (process-wide) and this server's own
        # counter twins (stats()), decided once here
        self._tel = _telemetry.enabled()
        self._counts: dict[str, int] = {}
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

    # -- host <-> device ----------------------------------------------------

    def _spec(self, **kw) -> engine.StepSpec:
        return engine.StepSpec(cfg=self.cfg, paged=self._paged,
                               payload=self._bind, **kw)

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
               ttl_s: float | None = None, priority: int = 0) -> int:
        """Queue one request and admit what fits; returns its id.
        ``stop``: optional list of token SEQUENCES; generation ends
        (sequence included) as soon as the generated tail matches one.
        ``ttl_s`` (default ``PADDLE_TPU_REQUEST_TTL_S``; None = none)
        bounds the request's wait in the queue: still queued past it, it
        is shed with the ``timeout`` status.  ``priority`` (higher = kept
        longer): the OOM ladder evicts the lowest-priority slot first."""
        if self.cache is None:
            raise RuntimeError("the server is closed")
        prompt, stop, ttl, top_k = validate_request(
            prompt, max_new_tokens, stop, temperature, top_k, top_p, ttl_s,
            window=min(self.max_len, self.cfg.max_seq_len),
            vocab_size=self.cfg.vocab_size, default_ttl=self._default_ttl)
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
        self._count("serving.requests_submitted")
        self._queue.append({"rid": rid, "prompt": prompt,
                            "max_new": int(max_new_tokens), "stop": stop,
                            "temperature": float(temperature),
                            "top_k": top_k, "top_p": float(top_p),
                            "ttl": ttl, "priority": int(priority),
                            "t_submit": now, "t_enqueue": now})
        self._admit()
        self._tel_gauges()
        return rid

    def _shed_expired(self):
        """Deadline shedding: queued requests past their TTL retire with
        the ``timeout`` status and never take a slot.  The TTL bounds the
        wait of the current queue entry (an evicted request's clock
        restarts when it is requeued), never the request's total age.
        Active slots are never shed."""
        if not self._resil or not self._queue:
            return
        now = time.perf_counter()
        kept = []
        for req in self._queue:
            ttl = req.get("ttl")
            if ttl is not None and now - req["t_enqueue"] > ttl:
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
        server's ``fold_in(base, (1 << 20) + rid)``), or the argmax."""
        if st["temperature"] > 0.0:
            dev = self.device
            key = torch.tensor(self._key(_ADMIT_COUNTER + st["rid"]),
                               device=dev)
            return int(_sample_batched(
                logits[None], key,
                torch.tensor([st["temperature"]], device=dev),
                torch.tensor([st["top_k"]], device=dev),
                torch.tensor([st["top_p"]], device=dev))[0])
        return int(lnp.argmax())

    def _take_first_token(self, st, slot: int, logits) -> bool | None:
        """The end of an admission: fetch the prefill logits [V] (one
        small device-to-host copy — the JAX server's host logits), run
        the NaN guard on them, then append the admission token; the slot
        decodes from position len(prompt) on.  Returns None when the
        guard failed the request (its slot is released), else whether
        that token ends the request."""
        lnp = logits.detach().float().cpu().numpy()
        if _faults.active():
            lnp = _faults.corrupt_nan("logits", lnp)
        if self._resil and not np.isfinite(lnp).all():
            self._fail_request(st, slot, "non-finite prefill logits")
            return None
        t = self._first_token(st, logits, lnp)
        st["generated"].append(t)
        st["pos"] = len(st["prompt"])          # cache rows [0, n) filled
        self._tokens += 1
        self._count("serving.tokens_generated")
        if self._tel:
            now = time.perf_counter()
            st["t_first"] = now
            self._observe("serving.ttft_ms", (now - st["t_submit"]) * 1e3)
        return self._finished(st, t)

    def _admit(self):
        self._shed_expired()
        # the OOM ladder's cap bounds every admission (a memory bound)
        while self._queue and self._free \
                and len(self._slots) < self._admit_cap:
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
                  "evictions": req.get("evictions", 0), "pos": 0,
                  "t_submit": req["t_submit"], "t_admit": t_admit}
            if self._tel:
                self._observe("serving.queue_wait_ms",
                              (t_admit - st["t_submit"]) * 1e3)
            budgeted = self._budget and len(req["prompt"]) > self._budget
            if not (self._prefill or budgeted):
                self._slots[slot] = st         # fed token by token
                continue
            try:
                if budgeted:
                    self._claim_admitting(slot, st)
                    continue
                logits = self._prefill_slot(req["prompt"], slot)
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
            done = self._take_first_token(st, slot, logits)
            if done is None:
                continue                        # failed by the NaN guard
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
        if self._paged:
            shared = self._pool.adopt_prefix(slot, prompt)
            self._drain_restores()
            starts = self._chunk_starts(n, self._budget, shared)
            self._ensure_admission_rows(slot, min(starts), n)
            self._apply_pool_ops()
        else:
            starts = self._chunk_starts(n, self._budget)
        # pos doubles as the prefill frontier: rows [starts[0], pos) are
        # written; decode steps feed prompt[pos] at pos meanwhile, a row
        # the next chunk rewrites
        st.update(admitting=True, admit_starts=starts, admit_i=0,
                  pos=starts[0])
        self._slots[slot] = st
        self._count("serving.admitting_claims")

    def _advance_admitting(self) -> bool:
        """Budgeted admission, part 2: run ONE budget-width chunk of the
        oldest admitting slot (claim order) through the graphed
        ``prefill_chunk`` or ``paged_prefill`` kind — at most ``budget``
        prefill tokens a scheduler round.  The last chunk graduates the
        slot.  Host state moves only after the step returned, so a failed
        chunk is run again as it was.  Returns True when a chunk ran."""
        slot = next((s for s, st in self._slots.items()
                     if st.get("admitting")), None)
        if slot is None:
            return False
        st = self._slots[slot]
        W = self._budget
        s = st["admit_starts"][st["admit_i"]]
        chunk = st["prompt"][s:s + W]
        kind, spec = (("paged_prefill", self._spec(bucket=W)) if self._paged
                      else ("prefill_chunk", self._spec(width=W)))
        (logits,) = engine.ENGINE.get(kind, spec)(
            *self._feeds(chunk, W, s, len(chunk), slot))
        self._prefill_rows += len(chunk)
        self._count("serving.prefill_chunks_interleaved")
        if self._paged:
            self._count("kv_pool.prefill_rows", len(chunk))
        st["admit_i"] += 1
        st["pos"] = min(s + len(chunk), len(st["prompt"]))
        if st["admit_i"] == len(st["admit_starts"]):
            self._graduate(slot, st, logits)
        return True

    def _graduate(self, slot: int, st, logits) -> None:
        """The last chunk landed: draw the admission token exactly as
        monolithic admission does (its NaN guard too) and let the slot
        decode (or retire at once); paged, the prompt's blocks index for
        later prompts."""
        for k in ("admitting", "admit_starts", "admit_i"):
            del st[k]
        done = self._take_first_token(st, slot, logits)
        if done is None:                        # failed by the NaN guard
            del self._slots[slot]
            return
        if self._paged:
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
        take the budget-width chunk instead (named as the JAX warmup names
        it)."""
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
        if self._budget and (kind, self._budget) not in out:
            out[(kind, self._budget)] = (f"{kind}{self._budget}"
                                         if self._paged else
                                         f"{kind}@{self._budget}")
        return [(name, k, w) for (k, w), name in sorted(out.items())]

    def _prefill_slot(self, prompt, slot: int):
        """Admission prefill of ``prompt`` into ``slot``; returns the
        logits [V] at its last position (the step's output buffer: read
        it before the next admission)."""
        n = len(prompt)
        if self._paged:
            return self._paged_prefill_slot(prompt, slot)
        if self._chunk is None:
            bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
            fn = engine.ENGINE.get("prefill", self._spec(bucket=bucket))
            (logits,) = fn(*self._feeds(prompt, bucket, n, slot))
            self._prefill_rows += n
            return logits
        C = self._chunk
        fn = engine.ENGINE.get("prefill_chunk", self._spec(width=C))
        for s in self._chunk_starts(n, C):
            chunk = prompt[s:s + C]
            (logits,) = fn(*self._feeds(chunk, C, s, len(chunk), slot))
            self._prefill_rows += len(chunk)
        return logits

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

    def _paged_prefill_slot(self, prompt, slot: int):
        """Paged admission: adopt the longest indexed prompt prefix into
        the slot's table (those rows are never recomputed; spilled blocks
        of it are restored, :meth:`_drain_restores`), make the suffix's
        rows writable (allocate / copy-on-write, relieving the pool while
        it is dry), run the suffix through the ``paged_prefill`` step and
        index this prompt's full blocks for later prompts.  Raises
        ``PoolExhausted`` when nothing more can be evicted."""
        n = len(prompt)
        alloc = self._pool
        shared = alloc.adopt_prefix(slot, prompt)
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
        fn = engine.ENGINE.get("paged_prefill", self._spec(bucket=C))
        rows = 0
        for s in starts:
            chunk = prompt[s:s + C]
            (logits,) = fn(*self._feeds(chunk, C, s, len(chunk), slot))
            rows += len(chunk)
        self._prefill_rows += rows
        self._count("kv_pool.prefill_rows", rows)
        alloc.register_prefix(slot, prompt)
        return logits

    def _apply_pool_ops(self):
        """Run the allocator's pending device work: copy-on-write block
        copies, then the table push when the host mirror changed — in
        place (the graphs read the ``tables`` leaf by address), from
        pinned memory, so an async server's push does not wait for the
        step in flight (the stream runs it after that step)."""
        pairs = self._pool.take_copies()
        if pairs:
            idx = self._host(np.asarray(pairs, np.int64)).to(
                self.device, non_blocking=True)
            kv_pool.copy_blocks(self.cache, idx[:, 0], idx[:, 1])
        if self._pool.dirty:
            self.cache["tables"].copy_(self._host(self._pool.tables),
                                       non_blocking=True)
            self._pool.dirty = False

    def _evict_or_spill(self, max_entries: int) -> int:
        """The OOM ladder's evict rung, spill-aware: with
        ``PADDLE_TPU_KV_SPILL_MB`` set, cold prefix chains demote to host
        memory (:meth:`_spill_fetch`) instead of dropping, so the next
        admission restores them instead of recomputing.  Returns the
        entries freed."""
        pool = self._pool
        if pool.spill_limit_bytes:
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
            tok[slot] = (st["prompt"][i] if i < len(st["prompt"])
                         else st["generated"][i - st["base"]])
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

    # -- sync dispatch ------------------------------------------------------

    def tick(self):
        """One batched decode step over every slot, then retire finished
        requests and admit queued ones (with ``async_dispatch``: dispatch
        the next step before processing the one in flight) — under the
        resilience guard (:meth:`_guarded`)."""
        self._rss_guard()
        self._guarded(self._tick_impl)

    def _tick_impl(self):
        if self._async:
            self._tick_async()
            return
        if not self._slots:
            self._admit()
            if not self._slots:
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
        n = self._step_no
        tok, pos = self._host(tok), self._host(pos)
        logits = None
        if temp.any():
            self._fault_check("sample_step")
            fn = engine.ENGINE.get("sample", self._spec())
            (nxt,) = fn(tok, pos, self._host(self._key(n)), self._host(temp),
                        self._host(tk), self._host(tp))
        else:
            self._fault_check("step")
            (logits,) = engine.ENGINE.get("step", self._spec())(tok, pos)
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
            if self._finished(st, t):
                done.append(slot)
        for slot in failed:
            self._fail_request(self._slots.pop(slot), slot,
                               "non-finite tick logits")
        self._tel_tokens(appended, t0)
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
        self._rss_guard()
        self._guarded(lambda: self._tick_block_impl(block))

    def _tick_block_impl(self, block: int):
        if self._async:
            self._tick_block_async(block)
            return
        if not self._slots:
            self._admit()
            if not self._slots:
                return
        # a slot at pos == len(prompt)-1 is fine for block decode (its
        # feed token is the prompt's last; everything after is feedback);
        # admitting slots take single ticks too: one chunk a tick is the
        # budgeted interleaving
        if self._stepwise():
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
            self._fault_check(f"block@{block}")
            (toks,) = engine.ENGINE.get("block", self._spec(k=block))(tok,
                                                                      pos)
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
                if self._finished(st, t):
                    done.append(slot)
                    break
            appended.append((st, kept))
        self._tel_tokens(appended, t0, steps=block)
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
            self._fault_check("async_step")
            if temp.any():
                fn = engine.ENGINE.get("async", self._spec())
                (nxt,) = fn(*feeds, self._host(self._key(n)),
                            self._host(temp), self._host(tk), self._host(tp))
            else:
                # greedy: the k = 1 greedy block, which skips the
                # sampler's sorts and noise the ``async`` step computes
                # for every slot
                fn = engine.ENGINE.get("async_block", self._spec(k=1))
                nxt = fn(*feeds)[0][:, 0]
        except Exception:
            self._rollback_dispatch(snap, n)
            raise
        self._inflight = {"kind": "step", "fetch": self._fetch_start(nxt),
                          "feed": nxt, "snap": snap, "step_no0": n,
                          "t_disp": time.perf_counter()}

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
                          "block": block, "step_no0": n,
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
                if self._finished(st, t):
                    done.append(slot)
            else:
                kept = 0
                for j in range(prev["block"]):
                    t = int(toks[slot, j])
                    st["generated"].append(t)
                    kept += 1
                    if self._finished(st, t):
                        done.append(slot)
                        break
                appended.append((st, kept))
        self._tel_tokens(appended, prev["t_disp"],
                         steps=prev.get("block", 1))
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
        in-flight dispatch is processed — the same tokens."""
        prev, self._inflight = self._inflight, None
        if not self._slots:
            self._admit()
            if not self._slots:
                return
        if self._stepwise():
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
                    if _resilience.is_oom(e) and self._oom_degrade(e):
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
            "priority": st["priority"], "evictions": evictions,
            "carry": list(st["generated"]), "t_submit": st["t_submit"],
            # the TTL bounds the wait of this queue entry: a fresh clock
            "t_enqueue": time.perf_counter()})
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
        (:meth:`stats`)."""
        if self._tel:
            _telemetry.count(name, n)
            self._counts[name] = self._counts.get(name, 0) + n

    def _observe(self, name: str, v: float, n: int = 1) -> None:
        _telemetry.observe(name, v, n)

    def _event(self, name: str, t0: float, t1: float, **args) -> None:
        if self._tel:
            _telemetry.event(name, t0, t1, **args)

    def _tel_gauges(self):
        """Occupancy gauges off the scheduler's host state."""
        if not self._tel:
            return
        act = len(self._slots)
        _telemetry.set_gauge("serving.queue_depth", len(self._queue))
        _telemetry.set_gauge("serving.active_slots", act)
        _telemetry.set_gauge("serving.slot_occupancy", act / self.max_batch)
        _telemetry.set_gauge("serving.admitting_slots",
                             sum(1 for st in self._slots.values()
                                 if st.get("admitting")))
        _telemetry.set_gauge("serving.kv_utilization", self._kv_util())
        if self._paged and self._pool is not None:
            _telemetry.set_gauge("kv_pool.blocks_in_use",
                                 self._pool.blocks_in_use)
            _telemetry.set_gauge("kv_pool.host_spill_bytes",
                                 self._pool.host_spill_bytes)

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

    def _tel_tokens(self, appended, t0: float, steps: int = 1):
        """A round's records from the tokens it just appended
        (``appended``: (state, count) pairs): tick latency, first-token
        time for a slot's first kept token (``prefill=False`` — prefill
        admission stamps it itself) and per-token latency."""
        total = sum(n for _, n in appended)
        self._tokens += total
        if not self._tel:
            return
        now = time.perf_counter()
        dt_ms = (now - t0) * 1e3
        self._observe("serving.tick_ms", dt_ms)
        if not appended:
            return
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

    def warmup(self, prompt_lens=None, blocks=(), sample: bool = False):
        """Build (on the card: capture) every step this server will serve
        before its first request: ``Engine.warmup`` (text/engine.py).
        Requires an idle server; leaves the step counter, the kernels'
        launch counters and every request's state as they were.  Returns
        {step: seconds}."""
        return engine.ENGINE.warmup(self, prompt_lens=prompt_lens,
                                    blocks=blocks, sample=sample)

    # -- results and state --------------------------------------------------

    def result(self, rid: int):
        """Generated tokens (no prompt) once the request finished.  A
        request shed past its deadline raises
        ``resilience.DeadlineExceeded``; one failed by the NaN guard or
        the requeue bound raises ``RuntimeError`` with the reason — in
        both cases it retired cleanly and the server serves on."""
        if rid in self._dropped:
            raise RuntimeError(
                f"request {rid} was abandoned unfinished when the server "
                f"was closed")
        disp = self._status.get(rid)
        if disp == "timeout":
            raise _resilience.DeadlineExceeded(
                f"request {rid} was shed: still queued past its ttl")
        if disp == "error":
            raise RuntimeError(
                f"request {rid} failed: "
                f"{self._err_reason.get(rid, 'non-finite logits')} (the "
                f"request was retired cleanly; the server is still "
                f"serving)")
        return self._results[rid]

    def status(self, rid: int) -> str:
        """One of ``ok`` (result ready), ``timeout`` (shed past its
        deadline), ``error`` (NaN guard, requeue bound), ``dropped``
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

    def load_stats(self) -> dict:
        """Scheduler load read from host state: queue depth, slot use
        (free slots within the OOM ladder's admit cap), KV utilization,
        the admit cap and the wedge verdict, the tokens generated and the
        prompt rows admission computed so far.  A paged server adds its
        prefix hit rate (adopted rows over adoptable rows), the spill
        tier's resident host bytes and its allocator's ``kv_pool``
        stats."""
        act = len(self._slots)
        stats = {
            "queue_depth": len(self._queue),
            "active_slots": act,
            "free_slots": min(len(self._free),
                              max(0, self._admit_cap - act)),
            "slot_occupancy": act / self.max_batch,
            "kv_utilization": self._kv_util(),
            "admit_cap": self._admit_cap,
            "wedged": self._wedged,
            "tokens_generated": self._tokens,
            "prefill_rows": self._prefill_rows,
            "admitting_slots": sum(1 for st in self._slots.values()
                                   if st.get("admitting")),
            "prefill_budget": self._budget,
        }
        if self._paged:
            pool = self._pool
            stats["prefix_hit_rate"] = pool.prefix_hits / max(
                1, pool.prefix_hits + pool.prefix_misses)
            stats["host_spill_bytes"] = pool.host_spill_bytes
            stats["kv_pool"] = pool.stats()
        return stats

    def stats(self) -> dict:
        """This server's telemetry counters so far, under the registry's
        (the JAX server's) names — ``serving.*`` and ``resilience.*``:
        requests submitted, completed, shed and failed, tokens generated,
        budgeted claims and chunks, ladder rungs and evictions, wedge
        recoveries, and, paged, the rows admission prefilled and the
        admissions the pool parked.  The registry
        (``paddle_tpu_torch.telemetry``) holds the process-wide sums,
        the allocator's ``kv_pool.*`` counters among them.  Empty with
        ``PADDLE_TPU_TELEMETRY=0``."""
        return dict(sorted(self._counts.items()))

    def close(self):
        """Release this server's steps (``Engine.purge``: its graphs and
        their memory pools) and its KV cache (and, paged, every block, the
        prefix index and the spill store).  The step in flight is
        abandoned unfetched (a wedged fetch cannot hang the exit);
        unfinished requests too: ``result()`` raises for them and
        ``status()`` says ``dropped``.  A wedge verdict this server raised
        is cleared.  Idempotent."""
        if self._wedged:
            self._wedged = False
            _telemetry.clear_runtime_wedge()
        self._inflight = None
        if self._bind is not None:
            # by binding alone: a routing flag flipped since a capture
            # changed its config key, not what it holds
            engine.ENGINE.purge(binding=self._bind)
            self._bind = None
        self.cache = None
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
