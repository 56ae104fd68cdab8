"""Launch counters of the kernel wrappers, safe across threads.

Each wrapper counts its launches in attributes on itself (``.launches``
and, where it has several bodies, ``.tc_launches`` / ``.tick_launches``),
which callers read and zero around the work they measure.  Every count
goes through :func:`bump`: under one lock, so two threads launching at
once (a fleet's replica ticks and its prefill worker) lose no count; and
a thread inside :func:`held` counts into a tally of its own instead, so
what it runs there — a graph capture's warm run, the capture itself, a
server's warmup — never reaches the attributes, and never takes back
another thread's launches either.
"""
from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_tls = threading.local()


def bump(fn, **deltas) -> None:
    """Add ``deltas`` ({attribute: n}) to the counters on ``fn`` — or,
    inside :func:`held` on this thread, to the innermost tally."""
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        for attr, n in deltas.items():
            if n:
                tally[(fn, attr)] = tally.get((fn, attr), 0) + int(n)
        return
    with _lock:
        for attr, n in deltas.items():
            if n:
                setattr(fn, attr, getattr(fn, attr) + int(n))


def add(tally: dict) -> None:
    """Add a tally ({(wrapper, attribute): n}, as :func:`held` yields)
    as :func:`bump` would: a graph replay's recorded launches."""
    for (fn, attr), n in tally.items():
        bump(fn, **{attr: n})


@contextlib.contextmanager
def held():
    """Count this thread's launches into a fresh tally (the yielded dict)
    until the block ends; the wrappers' attributes do not move."""
    prev = getattr(_tls, "tally", None)
    tally: dict = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = prev
