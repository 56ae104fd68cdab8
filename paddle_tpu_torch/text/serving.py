"""Continuous-batching decode server (slot scheduler over the KV cache).

Counterpart of ``paddle_tpu/text/serving.py`` for the first slice: one
resident batched KV cache of ``max_batch`` slots; requests join and leave
mid-flight; each tick is ONE batched decode step over every slot with
its own position; a freed slot is reused without clearing (the causal
mask ``t <= pos`` hides stale rows until they are overwritten).

    srv = DecodeServer(params, cfg, max_batch=8, max_len=256, eos_id=2)
    rid = srv.submit([5, 3, 9], max_new_tokens=32)
    while srv.pending():
        srv.tick()
    tokens = srv.result(rid)

Admission prefills the whole prompt in one pass at a power-of-two bucket
(``generate.prefill_slot``, the flash kernel on the card); ticks run the
split-KV decode kernel.  Everything else the JAX server does — paged
layout, chunked/budgeted prefill, async dispatch and ``tick_block``,
speculation, adapters and constraints, tensor parallelism, MoE, TTLs,
admission control, telemetry, fault handling, the fleet — is later
slices' work.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generate, gpt
from .. import resolve_device

__all__ = ["decode_step_batched", "sample_step_batched", "DecodeServer",
           "validate_request"]


def decode_step_batched(params, cache, token, pos, cfg: gpt.GPTConfig):
    """decode_step with PER-SLOT positions: token [B], pos int32 [B].
    The port's decode step takes per-slot positions directly (the JAX
    package vmaps its scalar-position step instead)."""
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
    seeded with ``seed``.  With ``prefill=True`` admission runs the whole
    bucket-padded prompt through ONE ``generate.prefill_slot`` pass and
    ticks only generate; with ``prefill=False`` prompts are fed token by
    token through the tick step.  ``device`` defaults to the card;
    ``params`` must live there."""

    def __init__(self, params, cfg: gpt.GPTConfig, max_batch: int,
                 max_len: int, eos_id: int | None = None,
                 prefill: bool = True, seed: int = 0, device=None):
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
        self.cache = generate.init_cache(cfg, max_batch, max_len, self.device)
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
                bucket = _pow2_bucket(n, self.max_len, self.cfg.max_seq_len)
                padded = torch.zeros((1, bucket), dtype=torch.int64,
                                     device=self.device)
                padded[0, :n] = torch.tensor(req["prompt"],
                                             device=self.device)
                logits, self.cache = generate.prefill_slot(
                    self.params, self.cache, padded, n, slot, self.cfg)
                t = self._first_token(logits, st)
                st["generated"].append(t)
                st["pos"] = n            # cache rows [0, n) are filled
                self._tokens += 1
                if self._finished(st, t):
                    self._results[st["rid"]] = st["generated"]
                    self._free.append(slot)
                    continue
            self._slots[slot] = st

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
            self._free.append(slot)
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
        KV utilization (filled rows over the slab's rows) and the tokens
        generated so far."""
        act = len(self._slots)
        rows = (int(self.cache["k"].shape[2]) if self.cache is not None
                else self.max_len)
        return {
            "queue_depth": len(self._queue),
            "active_slots": act,
            "free_slots": len(self._free),
            "slot_occupancy": act / self.max_batch,
            "kv_utilization": sum(min(st["pos"], rows)
                                  for st in self._slots.values())
            / (self.max_batch * rows),
            "tokens_generated": self._tokens,
        }

    def close(self):
        """Release the KV cache.  Unfinished requests are abandoned:
        ``result()`` raises for them and ``status()`` says ``dropped``.
        Idempotent."""
        self.cache = None
        for st in self._slots.values():
            self._dropped.add(st["rid"])
        for req in self._queue:
            self._dropped.add(req["rid"])
        self._slots.clear()
        self._queue.clear()
        self._free = list(range(self.max_batch))
