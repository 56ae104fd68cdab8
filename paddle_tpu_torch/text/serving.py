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

Everything else the JAX server does — speculation, adapters and
constraints, tensor parallelism, MoE, TTLs, admission control and its
SLO ladder, telemetry, the full OOM ladder (for half-prefilled slots
too), the spill tier, the fleet — is later slices' work; no entry point
of the port reaches it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import engine, generate, gpt, kv_pool
from .. import flags as _flags
from .. import resolve_device, rng

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
                     top_p, *, window, vocab_size):
    """THE request-validation rules.  Returns the normalized
    ``(prompt, stop, top_k)``."""
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
    return prompt, stop, min(int(top_k), vocab_size)


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
        self._admitting_claims = 0       # budgeted claims so far
        self._chunks_interleaved = 0     # budgeted chunks run so far
        lay = layout if layout is not None else _flags.kv_layout()
        if lay not in ("contiguous", "paged"):
            raise ValueError(
                f"layout {lay!r}: expected 'contiguous' or 'paged'")
        self._paged = lay == "paged"
        self.cache = generate.init_cache(
            cfg, max_batch, max_len, self.device, layout=lay,
            block_size=block_size, num_blocks=num_blocks)
        # the host allocator mirrors the built pool's geometry
        self._pool = (kv_pool.PagedAllocator(
            *kv_pool._geometry(self.cache), max_batch)
            if self._paged else None)
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
               top_k: int = 0, top_p: float = 1.0) -> int:
        """Queue one request and admit what fits; returns its id.
        ``stop``: optional list of token SEQUENCES; generation ends
        (sequence included) as soon as the generated tail matches one."""
        if self.cache is None:
            raise RuntimeError("the server is closed")
        prompt, stop, top_k = validate_request(
            prompt, max_new_tokens, stop, temperature, top_k, top_p,
            window=min(self.max_len, self.cfg.max_seq_len),
            vocab_size=self.cfg.vocab_size)
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
        self._queue.append({"rid": rid, "prompt": prompt,
                            "max_new": int(max_new_tokens), "stop": stop,
                            "temperature": float(temperature),
                            "top_k": top_k, "top_p": float(top_p)})
        self._admit()
        return rid

    def _finished(self, st, t: int) -> bool:
        return (len(st["generated"]) >= st["max_new"]
                or (self.eos_id is not None and t == self.eos_id)
                or _hits_stop(st))

    def _first_token(self, logits, st) -> int:
        """The admission token from the prefill logits [V]: a draw keyed
        by the request id (independent of admission order and batch-mates,
        as the JAX server's ``fold_in(base, (1 << 20) + rid)``)."""
        if st["temperature"] > 0.0:
            dev = self.device
            key = torch.tensor(self._key(_ADMIT_COUNTER + st["rid"]),
                               device=dev)
            return int(_sample_batched(
                logits[None], key,
                torch.tensor([st["temperature"]], device=dev),
                torch.tensor([st["top_k"]], device=dev),
                torch.tensor([st["top_p"]], device=dev))[0])
        return int(torch.argmax(logits))

    def _take_first_token(self, st, logits) -> bool:
        """Append the admission token drawn from the prefill logits; the
        slot decodes from position len(prompt) on.  True when that token
        ends the request."""
        t = self._first_token(logits, st)
        st["generated"].append(t)
        st["pos"] = len(st["prompt"])          # cache rows [0, n) filled
        self._tokens += 1
        return self._finished(st, t)

    def _admit(self):
        while self._queue and self._free:
            slot = self._free.pop()
            req = self._queue.pop(0)
            st = dict(req, generated=[], pos=0)
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
                break
            except Exception:
                # neither lose the request nor leak the slot
                self._release(slot)
                self._queue.insert(0, req)
                raise
            if self._take_first_token(st, logits):
                self._results[st["rid"]] = st["generated"]
                self._release(slot)
                continue
            self._slots[slot] = st

    # -- budgeted admission: chunked-prefill co-scheduling ------------------

    def _claim_admitting(self, slot: int, st) -> None:
        """Budgeted admission, part 1: claim the slot and plan the
        prompt's chunk starts at the budget width WITHOUT running a
        prefill — the walks of monolithic admission (contiguous: the fixed
        chunk rule; paged: adopt the longest indexed prefix, then the
        suffix rule, the slot's rows allocated in full here, since the
        decode steps the slot rides write its frontier row).  Raises
        ``PoolExhausted`` (the caller parks the request) before anything
        is claimed."""
        prompt = st["prompt"]
        n = len(prompt)
        if self._paged:
            shared = self._pool.adopt_prefix(slot, prompt)
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
        self._admitting_claims += 1

    def _advance_admitting(self) -> bool:
        """Budgeted admission, part 2: run ONE budget-width chunk of the
        oldest admitting slot (claim order) through the graphed
        ``prefill_chunk`` or ``paged_prefill`` kind — at most ``budget``
        prefill tokens a scheduler round.  The last chunk graduates the
        slot.  Host state moves only after the step returned.  Returns
        True when a chunk ran."""
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
        self._chunks_interleaved += 1
        st["admit_i"] += 1
        st["pos"] = min(s + len(chunk), len(st["prompt"]))
        if st["admit_i"] == len(st["admit_starts"]):
            self._graduate(slot, st, logits)
        return True

    def _graduate(self, slot: int, st, logits) -> None:
        """The last chunk landed: draw the admission token exactly as
        monolithic admission does and let the slot decode (or retire at
        once); paged, the prompt's blocks index for later prompts."""
        for k in ("admitting", "admit_starts", "admit_i"):
            del st[k]
        if self._paged:
            self._pool.register_prefix(slot, st["prompt"])
        if self._take_first_token(st, logits):
            del self._slots[slot]
            self._results[st["rid"]] = st["generated"]
            self._release(slot)

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
        self._admit()

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
        return (self._host(padded),
                *(self._host(np.array([v], np.int64)) for v in scalars))

    def _ensure_admission_rows(self, slot: int, start: int, stop: int):
        """Make a slot's rows [start, stop) writable for its admission,
        evicting cold prefix entries while the pool is dry (their blocks
        hold only index refs, so this request's freshly adopted blocks are
        never victims); raises ``PoolExhausted`` when nothing more can
        go."""
        while True:
            try:
                self._pool.ensure_rows(slot, start, stop)
                return
            except kv_pool.PoolExhausted:
                if self._pool.evict_cold(_EVICT_BATCH) == 0:
                    raise

    def _paged_prefill_slot(self, prompt, slot: int):
        """Paged admission: adopt the longest indexed prompt prefix into
        the slot's table (those rows are never recomputed), make the
        suffix's rows writable (allocate / copy-on-write, evicting cold
        prefix entries while the pool is dry), run the suffix through the
        ``paged_prefill`` step and index this prompt's full blocks for
        later prompts.  Raises ``PoolExhausted`` when nothing more can be
        evicted."""
        n = len(prompt)
        alloc = self._pool
        shared = alloc.adopt_prefix(slot, prompt)
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
        for s in starts:
            chunk = prompt[s:s + C]
            (logits,) = fn(*self._feeds(chunk, C, s, len(chunk), slot))
            self._prefill_rows += len(chunk)
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

    def _ensure_decode_blocks(self, steps: int = 1):
        """Before a dispatch of ``steps`` decode steps: map (or
        copy-on-write) every active slot's blocks under rows
        [pos, pos + steps) — admission reserves no rows up front, the
        memory point of the paged layout; rows past the tables' reach
        clamp (a block's overrun past a request's end writes no mapped
        row).  When the pool is dry, cold prefix entries are evicted and
        the allocation retried once; a second ``PoolExhausted``
        propagates."""
        if not self._paged or not self._slots:
            return
        cap = self._pool.nmax * self._pool.bs

        def ensure():
            for slot, st in self._slots.items():
                self._pool.ensure_rows(slot, st["pos"],
                                       min(st["pos"] + steps, cap))

        try:
            ensure()
        except kv_pool.PoolExhausted:
            if self._pool.evict_cold(max(_EVICT_BATCH,
                                         len(self._slots))) == 0:
                raise
            ensure()
        self._apply_pool_ops()

    def pending(self) -> bool:
        return bool(self._slots or self._queue)

    def _feed_arrays(self):
        """The batched (tok, pos) feed: the token fed at position i is
        sequence[i] — prompt while i is inside it, the generated tail
        after.  Free slots feed token 0 at position 0; their row 0 is
        rewritten by the next admission."""
        tok = np.zeros((self.max_batch,), np.int64)
        pos = np.zeros((self.max_batch,), np.int32)
        for slot, st in self._slots.items():
            i = st["pos"]
            n = len(st["prompt"])
            tok[slot] = (st["prompt"][i] if i < n
                         else st["generated"][i - n])
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
        the next step before processing the one in flight)."""
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
        self._ensure_decode_blocks(1)
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        n = self._step_no
        tok, pos = self._host(tok), self._host(pos)
        if temp.any():
            fn = engine.ENGINE.get("sample", self._spec())
            (nxt,) = fn(tok, pos, self._host(self._key(n)), self._host(temp),
                        self._host(tk), self._host(tp))
        else:
            (logits,) = engine.ENGINE.get("step", self._spec())(tok, pos)
            nxt = torch.argmax(logits, dim=-1)
        # the step counter advances only after the step call returned
        self._step_no = n + 1
        nxt = self._fetch_wait(self._fetch_start(nxt))   # the one fetch
        done = []
        for slot, st in self._slots.items():
            if st.get("admitting"):
                continue        # rode the step at its frontier: discarded
            i = st["pos"]
            st["pos"] = i + 1
            if i < len(st["prompt"]) - 1:
                continue                 # still feeding prompt
            t = int(nxt[slot])
            st["generated"].append(t)
            self._tokens += 1
            if self._finished(st, t):
                done.append(slot)
        self._retire(done)

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
        self._ensure_decode_blocks(block)
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        n = self._step_no
        tok, pos = self._host(tok), self._host(pos)
        if temp.any():
            fn = engine.ENGINE.get("sample_block", self._spec(k=block))
            (toks,) = fn(tok, pos, self._host(self._key(n)),
                         self._host(temp), self._host(tk), self._host(tp))
        else:
            (toks,) = engine.ENGINE.get("block", self._spec(k=block))(tok,
                                                                      pos)
        self._step_no = n + block        # after the call: see tick
        toks = self._fetch_wait(self._fetch_start(toks))
        done = []
        for slot, st in self._slots.items():
            for j in range(block):
                t = int(toks[slot, j])
                st["generated"].append(t)
                st["pos"] += 1
                self._tokens += 1
                if self._finished(st, t):
                    done.append(slot)
                    break
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
            elif i - n_p < len(st["generated"]):
                ht[slot] = st["generated"][i - n_p]
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
                          "feed": nxt, "snap": snap, "step_no0": n}

    def _dispatch_block_async(self, prev, block: int):
        self._ensure_decode_blocks(block)
        ht, pm, pos, temp, tk, tp, snap = self._dispatch_feed(prev, block)
        n = self._step_no
        self._step_no = n + block
        feeds = (self._host(ht), self._host(pm), self._prev_feed(prev),
                 self._host(pos))
        try:
            if temp.any():
                fn = engine.ENGINE.get("async_sample_block",
                                       self._spec(k=block))
                (toks,) = fn(*feeds, self._host(self._key(n)),
                             self._host(temp), self._host(tk),
                             self._host(tp))
            else:
                fn = engine.ENGINE.get("async_block", self._spec(k=block))
                (toks,) = fn(*feeds)
        except Exception:
            self._rollback_dispatch(snap, n)
            raise
        self._inflight = {"kind": "block", "fetch": self._fetch_start(toks),
                          "feed": toks[:, -1], "snap": snap,
                          "block": block, "step_no0": n}

    def _process_inflight(self, prev):
        """Fetch a dispatch's tokens and run its deferred host
        bookkeeping.  Slots whose request retired (or was replaced by a
        new tenant) since the dispatch are skipped — their tokens are the
        overrun the async pipeline trades for overlap."""
        toks = self._fetch_wait(prev["fetch"])
        done = []
        for slot, st, i in prev["snap"]:
            if self._slots.get(slot) is not st:
                continue    # retired or replaced while this was in flight
            if prev["kind"] == "step":
                if i < len(st["prompt"]) - 1:
                    continue            # still feeding prompt
                t = int(toks[slot])
                st["generated"].append(t)
                self._tokens += 1
                if self._finished(st, t):
                    done.append(slot)
            else:
                for j in range(prev["block"]):
                    t = int(toks[slot, j])
                    st["generated"].append(t)
                    self._tokens += 1
                    if self._finished(st, t):
                        done.append(slot)
                        break
        self._retire(done)

    def _drain_inflight(self):
        """Fetch and process the pending async dispatch now."""
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
        """Generated tokens (no prompt) once the request finished."""
        if rid in self._dropped:
            raise RuntimeError(
                f"request {rid} was abandoned unfinished when the server "
                f"was closed")
        return self._results[rid]

    def status(self, rid: int) -> str:
        """One of ``ok`` (result ready), ``dropped`` (abandoned by close),
        ``active`` (decoding), ``queued``."""
        if rid in self._results:
            return "ok"
        if rid in self._dropped:
            return "dropped"
        if any(st["rid"] == rid for st in self._slots.values()):
            return "active"
        if any(req["rid"] == rid for req in self._queue):
            return "queued"
        raise KeyError(f"unknown request id {rid}")

    def load_stats(self) -> dict:
        """Scheduler load read from host state: queue depth, slot use,
        KV utilization, the tokens generated and the prompt rows
        admission computed so far.  KV utilization is the paged pool's
        blocks in use over its blocks, or the slab's filled rows over its
        rows; a paged server adds its allocator's ``kv_pool`` stats."""
        act = len(self._slots)
        if self._paged:
            kv = self._pool.blocks_in_use / self._pool.N
        else:
            rows = (int(self.cache["k"].shape[2]) if self.cache is not None
                    else self.max_len)
            kv = sum(min(st["pos"], rows) for st in self._slots.values()) \
                / (self.max_batch * rows)
        stats = {
            "queue_depth": len(self._queue),
            "active_slots": act,
            "free_slots": len(self._free),
            "slot_occupancy": act / self.max_batch,
            "kv_utilization": kv,
            "tokens_generated": self._tokens,
            "prefill_rows": self._prefill_rows,
            "admitting_slots": sum(1 for st in self._slots.values()
                                   if st.get("admitting")),
            "prefill_budget": self._budget,
        }
        if self._paged:
            stats["kv_pool"] = self._pool.stats()
        return stats

    def stats(self) -> dict:
        """The server's counters under the JAX server's telemetry names
        (which the port does not have yet): budgeted claims and the
        budget-width chunks run so far."""
        return {"serving.admitting_claims": self._admitting_claims,
                "serving.prefill_chunks_interleaved":
                    self._chunks_interleaved}

    def close(self):
        """Release this server's steps (``Engine.purge``: its graphs and
        their memory pools) and its KV cache (and, paged, every block and
        the prefix index).  The step in flight is abandoned unfetched;
        unfinished requests too: ``result()`` raises for them and
        ``status()`` says ``dropped``.  Idempotent."""
        self._inflight = None
        if self._bind is not None:
            # by binding alone: a routing flag flipped since a capture
            # changed its config key, not what it holds
            engine.ENGINE.purge(binding=self._bind)
            self._bind = None
        self.cache = None
        if self._paged:
            self._pool.close()
        for st in self._slots.values():
            self._dropped.add(st["rid"])
        for req in self._queue:
            self._dropped.add(req["rid"])
        self._slots.clear()
        self._queue.clear()
        self._free = list(range(self.max_batch))
