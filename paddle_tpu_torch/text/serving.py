"""Continuous-batching decode server (slot scheduler over the KV cache).

Counterpart of ``paddle_tpu/text/serving.py`` for the serving slices:
one resident KV cache for ``max_batch`` slots; requests join and leave
mid-flight; each tick is ONE batched decode step over every slot with
its own position; a freed slot is reused without clearing (the causal
mask ``t <= pos`` hides stale rows until they are overwritten).

    srv = DecodeServer(params, cfg, max_batch=8, max_len=256, eos_id=2)
    rid = srv.submit([5, 3, 9], max_new_tokens=32)
    while srv.pending():
        srv.tick()
    tokens = srv.result(rid)

Two cache layouts (``layout=``, default ``PADDLE_TPU_KV_LAYOUT``):

* ``"contiguous"`` — one slab, every slot provisioned for ``max_len``
  rows.  Admission prefills the whole prompt in one pass at a
  power-of-two bucket (``generate.prefill_slot``, the flash kernel on the
  card) or, with ``prefill_chunk=N``, in fixed N-token chunks
  (``generate.prefill_slot_chunk``); ticks run the split-KV decode
  kernel.
* ``"paged"`` — a pool of ``block_size``-row blocks shared by all slots
  through block tables (``text/kv_pool.py``): blocks are allocated as a
  slot's position crosses block boundaries, prompts adopt the longest
  indexed prefix of earlier prompts (refcounted, copied on write), and
  admission is always chunked (``kv_pool.paged_prefill_chunk``, the
  contiguous decode kernel on the card) starting past the adopted rows;
  ticks run the block-table decode kernel.  When the pool runs dry,
  admission evicts cold prefix entries and otherwise parks the request
  at the queue front until blocks free.

Everything else the JAX server does — budgeted prefill, async dispatch
and ``tick_block``, speculation, adapters and constraints, tensor
parallelism, MoE, TTLs, admission control, telemetry, the full OOM
ladder, the spill tier, the fleet — is later slices' work.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generate, gpt, kv_pool
from .. import flags as _flags
from .. import resolve_device

__all__ = ["decode_step_batched", "sample_step_batched", "DecodeServer",
           "validate_request"]


# cold prefix-cache entries evicted per relief round when the pool runs dry
# (LRU-first batches; never the whole index at once)
_EVICT_BATCH = 4


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


def _sample_batched(logits, generator, temp, topk, topp):
    """Per-slot sampling over batched logits [B, V]: temperature, top-k,
    nucleus (generate._filter_logits) with PER-SLOT parameters, so one
    step serves a batch mixing greedy and sampled requests.  temp/topp
    float32 [B], topk int [B] (0 = off); slots with temp == 0 take the
    argmax of the raw logits."""
    scaled = generate._filter_logits(logits, temp, topk, topp)
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0.0, sampled, greedy)


def sample_step_batched(params, cache, tok, pos, generator, temp, topk, topp,
                        cfg: gpt.GPTConfig):
    """One batched decode step that returns sampled TOKENS [B] (greedy
    where temp == 0) instead of logits."""
    logits, cache = decode_step_batched(params, cache, tok, pos, cfg)
    return _sample_batched(logits, generator, temp, topk, topp), cache


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
    sample with per-slot parameters, drawn from a ``torch.Generator``
    seeded with ``seed``.  With ``prefill=True`` admission computes the
    prompt before the slot joins the ticks (one bucket-padded
    ``generate.prefill_slot`` pass; fixed ``prefill_chunk``-token chunks;
    or, paged, chunks after the adopted prefix) and ticks only generate;
    with ``prefill=False`` prompts are fed token by token through the
    tick step.  ``layout``/``block_size``/``num_blocks`` pick the cache
    layout (module note; ``num_blocks`` defaults to full provisioning).
    ``device`` defaults to the card; ``params`` must live there."""

    def __init__(self, params, cfg: gpt.GPTConfig, max_batch: int,
                 max_len: int, eos_id: int | None = None,
                 prefill: bool = True, seed: int = 0, device=None,
                 layout: str | None = None, block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None):
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
        self._prefill_rows = 0       # prompt rows admission computed
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._free = list(range(max_batch))
        self._slots: dict[int, dict] = {}        # slot -> request state
        self._queue: list[dict] = []             # waiting requests
        self._results: dict[int, list] = {}
        self._dropped: set[int] = set()          # rids abandoned by close()
        self._next_rid = 0
        self._tokens = 0                          # tokens generated so far

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
        """The admission token from the prefill logits [V]."""
        if st["temperature"] > 0.0:
            dev = self.device
            return int(_sample_batched(
                logits[None], self._gen,
                torch.tensor([st["temperature"]], device=dev),
                torch.tensor([st["top_k"]], device=dev),
                torch.tensor([st["top_p"]], device=dev))[0])
        return int(torch.argmax(logits))

    def _admit(self):
        while self._queue and self._free:
            slot = self._free.pop()
            req = self._queue.pop(0)
            st = dict(req, generated=[], pos=0)
            if self._prefill:
                n = len(req["prompt"])
                try:
                    logits = self._prefill_slot(req["prompt"], slot)
                except kv_pool.PoolExhausted:
                    # no free blocks even after evicting the cold prefix
                    # cache: the request WAITS for active slots to retire
                    # — park it back at the queue front, stop admitting
                    self._release(slot)
                    self._queue.insert(0, req)
                    break
                except Exception:
                    # neither lose the request nor leak the slot
                    self._release(slot)
                    self._queue.insert(0, req)
                    raise
                t = self._first_token(logits, st)
                st["generated"].append(t)
                st["pos"] = n            # cache rows [0, n) are filled
                self._tokens += 1
                if self._finished(st, t):
                    self._results[st["rid"]] = st["generated"]
                    self._release(slot)
                    continue
            self._slots[slot] = st

    def _release(self, slot: int) -> None:
        """Return a slot (and, paged, its blocks) to the free lists."""
        if self._paged:
            self._pool.free_slot(slot)
        self._free.append(slot)

    def _chunk_starts(self, n: int, C: int, shared: int = 0) -> list:
        """Chunk starts covering prompt rows [shared, n) at width C.  The
        LAST window starts at n - C (overlapping the previous chunk)
        instead of overrunning the window: overlapped rows recompute to
        the same values, and a write past the window would not fit."""
        if n - shared <= C:
            window = min(self.max_len, self.cfg.max_seq_len)
            return [shared if shared + C <= window else max(0, n - C)]
        return list(range(shared, n - C, C)) + [n - C]

    def _prefill_slot(self, prompt, slot: int):
        """Admission prefill of ``prompt`` into ``slot``; returns the
        logits [V] at its last position."""
        n = len(prompt)
        if self._paged:
            return self._paged_prefill_slot(prompt, slot)
        if self._chunk is None:
            bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
            logits, self.cache = generate.prefill_slot(
                self.params, self.cache, self._padded(prompt, bucket), n,
                slot, self.cfg)
            self._prefill_rows += n
            return logits
        C = self._chunk
        for s in self._chunk_starts(n, C):
            chunk = prompt[s:s + C]
            logits, self.cache = generate.prefill_slot_chunk(
                self.params, self.cache, self._padded(chunk, C), s,
                len(chunk), slot, self.cfg)
            self._prefill_rows += len(chunk)
        return logits

    def _padded(self, tokens, width: int):
        """[1, width] int64 on the server's device, ``tokens`` then 0s."""
        padded = torch.zeros((1, width), dtype=torch.int64)
        padded[0, :len(tokens)] = torch.tensor(tokens, dtype=torch.int64)
        return padded.to(self.device)

    def _paged_prefill_slot(self, prompt, slot: int):
        """Paged admission: adopt the longest indexed prompt prefix into
        the slot's table (those rows are never recomputed), make the
        suffix's rows writable (allocate / copy-on-write, evicting cold
        prefix entries while the pool is dry), run the suffix through
        ``kv_pool.paged_prefill_chunk`` and index this prompt's full
        blocks for later prompts.  Raises ``PoolExhausted`` when nothing
        more can be evicted."""
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
        while True:
            try:
                alloc.ensure_rows(slot, min(starts), n)
                break
            except kv_pool.PoolExhausted:
                # cold entries hold ref == their index refs, so this
                # request's freshly adopted blocks are never victims
                if alloc.evict_cold(_EVICT_BATCH) == 0:
                    raise
        self._apply_pool_ops()
        for s in starts:
            chunk = prompt[s:s + C]
            logits, self.cache = kv_pool.paged_prefill_chunk(
                self.params, self.cache, self._padded(chunk, C), s,
                len(chunk), slot, self.cfg)
            self._prefill_rows += len(chunk)
        alloc.register_prefix(slot, prompt)
        return logits

    def _apply_pool_ops(self):
        """Run the allocator's pending device work: copy-on-write block
        copies, then the table push when the host mirror changed."""
        pairs = self._pool.take_copies()
        if pairs:
            idx = torch.tensor(pairs, dtype=torch.int64, device=self.device)
            kv_pool.copy_blocks(self.cache, idx[:, 0], idx[:, 1])
        if self._pool.dirty:
            self.cache["tables"].copy_(torch.from_numpy(self._pool.tables))
            self._pool.dirty = False

    def _ensure_decode_blocks(self):
        """Before a tick: map (or copy-on-write) every active slot's block
        under the row it writes — admission reserves no rows up front,
        the memory point of the paged layout.  When the pool is dry, cold
        prefix entries are evicted and the allocation retried once; a
        second ``PoolExhausted`` propagates."""
        cap = self._pool.nmax * self._pool.bs

        def ensure():
            for slot, st in self._slots.items():
                self._pool.ensure_rows(slot, st["pos"],
                                       min(st["pos"] + 1, cap))

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
        """Per-slot (temperature, top_k, top_p); free and prompt-feeding
        slots sample nothing (temp 0)."""
        temp = np.zeros((self.max_batch,), np.float32)
        tk = np.zeros((self.max_batch,), np.int64)
        tp = np.ones((self.max_batch,), np.float32)
        for slot, st in self._slots.items():
            if st["pos"] >= len(st["prompt"]) - 1:
                temp[slot] = st["temperature"]
                tk[slot] = st["top_k"]
                tp[slot] = st["top_p"]
        return temp, tk, tp

    def tick(self):
        """One batched decode step over every slot, then retire finished
        requests and admit queued ones."""
        if not self._slots:
            self._admit()
            if not self._slots:
                return
        dev = self.device
        if self._paged:
            self._ensure_decode_blocks()
        tok, pos = self._feed_arrays()
        temp, tk, tp = self._sampling_arrays()
        tok_t = torch.from_numpy(tok).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        if temp.any():
            nxt, self.cache = sample_step_batched(
                self.params, self.cache, tok_t, pos_t, self._gen,
                torch.from_numpy(temp).to(dev), torch.from_numpy(tk).to(dev),
                torch.from_numpy(tp).to(dev), self.cfg)
        else:
            logits, self.cache = decode_step_batched(
                self.params, self.cache, tok_t, pos_t, self.cfg)
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()          # the tick's one device->host fetch
        done = []
        for slot, st in self._slots.items():
            i = st["pos"]
            st["pos"] = i + 1
            if i < len(st["prompt"]) - 1:
                continue                 # still feeding prompt
            t = int(nxt[slot])
            st["generated"].append(t)
            self._tokens += 1
            if self._finished(st, t):
                done.append(slot)
        for slot in done:
            st = self._slots.pop(slot)
            self._results[st["rid"]] = st["generated"]
            self._release(slot)
        self._admit()

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
        }
        if self._paged:
            stats["kv_pool"] = self._pool.stats()
        return stats

    def close(self):
        """Release the KV cache (and, paged, every block and the prefix
        index).  Unfinished requests are abandoned: ``result()`` raises
        for them and ``status()`` says ``dropped``.  Idempotent."""
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
