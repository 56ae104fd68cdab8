"""Resilience primitives: bounded retry, deadlines, a wedge watchdog and
the OOM classifier.

The port's own copy of ``paddle_tpu/resilience.py``, for the schedulers
that sit above the card (the ``DecodeServer`` ticks):

* :func:`retry` — bounded attempts with capped exponential backoff and
  deterministic jitter (seeded, so a test can hold the exact schedule),
  every engagement counted into the telemetry registry;
* :class:`Deadline` — TTL arithmetic for request shedding;
* :class:`Overloaded` — admission control refused a request at the door
  (``text/admission.py``), distinct from a TTL's
  :class:`DeadlineExceeded`;
* :func:`call_with_budget` — a wall-budget watchdog around a blocking
  call (the async serving fetch): on timeout the caller gets a
  :class:`WedgeError` while the call is abandoned on a daemon thread;
* :func:`is_oom` — one classifier for allocator exhaustion: a real
  ``torch.cuda.OutOfMemoryError``, the paged pool's ``PoolExhausted`` and
  the fault harness's :class:`faults.InjectedOOM`, by one string rule.

``PADDLE_TPU_RESILIENCE=0`` fails fast everywhere: :func:`retry` runs its
function once and every caller skips its degradation ladder.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable

from . import flags as _flags
from . import telemetry as _telemetry

__all__ = [
    "enabled", "DeadlineExceeded", "Overloaded", "WedgeError", "Deadline",
    "backoff_schedule", "retry", "is_oom", "call_with_budget",
]


def enabled() -> bool:
    """Master switch (re-read per call so tests can flip the env)."""
    return _flags.resilience_enabled()


class DeadlineExceeded(TimeoutError):
    """A TTL expired: a queued serving request was shed before admission
    (``DecodeServer.result`` raises this for the ``timeout`` status)."""


class Overloaded(RuntimeError):
    """Admission control shed this request at the door: a tenant's rate
    limit, a bounded per-class queue overflowing, or the SLO ladder's shed
    rung (``DecodeServer.result`` raises this for the ``rejected``
    status).  Distinct from :class:`DeadlineExceeded` on purpose: a
    ``timeout`` waited in the queue and lost; a ``rejected`` request was
    never queued, the signal for a client to back off."""


class WedgeError(RuntimeError):
    """A guarded call exceeded its wall budget (the watchdog's verdict:
    the step is wedged, not slow)."""


class Deadline:
    """Absolute deadline built from a TTL: ``Deadline(0.5)`` expires
    0.5 s from construction.  ``ttl_s=None`` never expires."""

    __slots__ = ("t0", "ttl_s")

    def __init__(self, ttl_s: float | None, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.ttl_s = None if ttl_s is None else float(ttl_s)

    def remaining(self) -> float:
        if self.ttl_s is None:
            return float("inf")
        return self.ttl_s - (time.perf_counter() - self.t0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


def backoff_schedule(attempts: int, base: float = 0.05,
                     factor: float = 2.0, max_delay: float = 2.0,
                     jitter: float = 0.1, seed: int = 0) -> list:
    """The delay (seconds) before each retry of a failed call:
    ``attempts`` attempts give ``attempts - 1`` delays,
    ``min(base * factor**i, max_delay)`` each, plus or minus a uniform
    jitter fraction drawn from ``random.Random(seed)`` — deterministic
    for a seed, the JAX package's schedule exactly."""
    rng = random.Random(seed)
    out = []
    for i in range(max(0, int(attempts) - 1)):
        d = min(base * (factor ** i), max_delay)
        if jitter:
            d *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        out.append(max(0.0, d))
    return out


def is_oom(exc: BaseException) -> bool:
    """True when ``exc`` is allocator exhaustion, by the JAX package's
    single string rule: the type name and message carry
    ``RESOURCE_EXHAUSTED`` or "out of memory".

    The rule covers torch as it stands: ``torch.cuda.OutOfMemoryError``
    (raised by the caching allocator at an eager allocation, inside a
    graph capture or for a pinned host buffer) says "CUDA out of memory"
    in its message and "OutOfMemoryError" in its name; the paged pool's
    ``kv_pool.PoolExhausted`` and the fault harness's ``InjectedOOM``
    carry ``RESOURCE_EXHAUSTED`` by construction.  A string rule keeps
    this module free of torch and of the text package."""
    msg = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in msg
            or "Out of memory" in msg
            or "out of memory" in msg)


def retry(fn: Callable, *, name: str, attempts: int = 3,
          base: float = 0.05, factor: float = 2.0, max_delay: float = 2.0,
          jitter: float = 0.1, seed: int | None = None,
          retry_on: type | tuple = Exception,
          deadline: Deadline | None = None,
          sleep: Callable[[float], None] = time.sleep,
          on_retry: Callable | None = None):
    """Call ``fn`` with bounded retries and capped exponential backoff.

    ``name`` is required: every engaged retry counts
    ``resilience.retries`` and ``resilience.retries.<name>``.
    ``retry_on`` bounds what is retried (anything else propagates at
    once); an expired ``deadline`` stops retrying and raises the last
    error.  With resilience off this is exactly one attempt."""
    if not name:
        raise ValueError("retry() requires a non-empty name= (the "
                         "telemetry counter identity)")
    if not enabled():
        attempts = 1
    attempts = max(1, int(attempts))
    if seed is None:
        # per (site, process): N processes retrying one contended
        # resource must not sleep in lockstep
        import os as _os
        import zlib as _zlib

        seed = _zlib.crc32(f"{name}:{_os.getpid()}".encode())
    delays = backoff_schedule(attempts, base, factor, max_delay, jitter,
                              seed)
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - the retry loop IS the point
            last = e
            if i + 1 >= attempts:
                break
            if deadline is not None and deadline.expired:
                break
            _telemetry.count("resilience.retries")
            _telemetry.count(f"resilience.retries.{name}")
            if on_retry is not None:
                on_retry(i + 1, e)
            sleep(delays[i])
    assert last is not None
    raise last


def call_with_budget(fn: Callable, budget_s: float, *, name: str):
    """Run ``fn()`` under a wall budget: its result, or :class:`WedgeError`
    after ``budget_s`` seconds (``resilience.wedge_detected`` and
    ``resilience.wedge_detected.<name>`` count it).  The call runs on a
    daemon thread, abandoned on timeout — its late result is discarded.
    A budget <= 0 calls ``fn`` inline.  Use only around calls whose
    result the caller can drop and recompute (the async serving fetch:
    the scheduler rolls its slots back and decodes those steps again)."""
    if budget_s is None or budget_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name=f"paddle-tpu-budget-{name}")
    t.start()
    if not done.wait(budget_s):
        _telemetry.count("resilience.wedge_detected")
        _telemetry.count(f"resilience.wedge_detected.{name}")
        raise WedgeError(
            f"{name} exceeded its wall budget of {budget_s:.3f}s "
            f"(the step is wedged; the hung call is abandoned)")
    if "err" in box:
        raise box["err"]
    return box["out"]
