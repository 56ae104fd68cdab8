"""Deterministic fault injection: the chaos half of the resilience layer.

The port's own copy of ``paddle_tpu/faults.py`` — the same spec grammar,
the same sites and match counting — so one ``PADDLE_TPU_FAULTS`` spec
drives the same drill through the JAX server and the port's.  The one
difference: :func:`corrupt_nan` also takes a torch tensor.

Spec grammar (``PADDLE_TPU_FAULTS``)::

    PADDLE_TPU_FAULTS=oom:serving.block:2,wedge:tick:1,nan:logits:3

comma-separated ``kind:site:nth`` triples —

* ``kind``: ``oom`` (raise :class:`InjectedOOM`, recognized by
  ``resilience.is_oom`` exactly like a real allocator failure),
  ``error`` (raise :class:`InjectedError`), ``wedge`` (simulate a
  hung device step: :func:`hang` sleeps ``PADDLE_TPU_FAULT_WEDGE_S``
  seconds — long enough to trip the
  resilience watchdog's wall budget), ``nan`` (corrupt an array:
  :func:`corrupt_nan` returns it filled with NaN), ``delay``
  (deterministic injected latency: the matching check SLEEPS — an
  optional 4th field gives the seconds, ``delay:tick:0:0.05``, default
  0.05 — so SLO drills inflate TTFT/TPOT p99s on tiny CPU models
  instead of needing wall-clock-sized ones; never an exception), or
  ``overload`` (raise :class:`InjectedOverload` at an admission site —
  drives the admission-control drills).
* ``site``: a label named by the instrumented call site.  A site check
  may pass several aliases (``check("tick", "serving.block")``) —
  a fault matches when its site equals ANY alias, so specs can target
  the generic site ("tick") or the exact executable ("serving.block").
* ``nth``: 1-based — the fault fires on the nth matching check and only
  that one (each fault keeps its own match counter), so a retried tick
  sails through on the retry.  ``nth=0`` fires on EVERY matching check
  (a persistent fault, for fail-fast tests).

No-op when unset: every check is a single module-bool test.  The spec
is parsed once per process (first check) — tests flip it via
:func:`install` / :func:`reset` rather than racing the env.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = [
    "InjectedFault", "InjectedOOM", "InjectedError", "InjectedWedge",
    "InjectedOverload", "install", "reset", "active", "check", "hang",
    "corrupt_nan", "nan_train_steps", "spec_string", "parse_spec",
]

_KINDS = ("oom", "error", "wedge", "nan", "delay", "overload")
_DELAY_DEFAULT_S = 0.05


class InjectedFault(RuntimeError):
    """Base class for every injected failure (so chaos tests can catch
    the whole family, and production code never accidentally does)."""


class InjectedOOM(InjectedFault):
    """Simulated allocator exhaustion.  The message carries the literal
    ``RESOURCE_EXHAUSTED`` marker so ``resilience.is_oom`` classifies it
    by the same rule it applies to a real allocator failure."""

    def __init__(self, site: str):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected OOM at {site!r} "
            f"(PADDLE_TPU_FAULTS)")


class InjectedError(InjectedFault):
    def __init__(self, site: str):
        super().__init__(f"injected error at {site!r} (PADDLE_TPU_FAULTS)")


class InjectedWedge(InjectedFault):
    """Raised only when a ``wedge`` fault fires at a site that calls
    :func:`check` instead of :func:`hang` (a wedge spec on a site with
    no hang hook still fails loudly rather than silently no-opping)."""

    def __init__(self, site: str):
        super().__init__(f"injected wedge at {site!r} (PADDLE_TPU_FAULTS)")


class InjectedOverload(InjectedFault):
    """Simulated admission-layer overload (an ``overload:site:nth``
    fault firing at a site that opted in via ``kinds``): the admission
    controller answers it by shedding exactly as it would a real
    capacity verdict, which is what the overload drills assert."""

    def __init__(self, site: str):
        super().__init__(
            f"injected overload at {site!r} (PADDLE_TPU_FAULTS)")


class _Fault:
    __slots__ = ("kind", "site", "nth", "hits", "fired", "seconds")

    def __init__(self, kind: str, site: str, nth: int,
                 seconds: float | None = None):
        self.kind = kind
        self.site = site
        self.nth = int(nth)
        self.seconds = seconds      # delay faults only
        self.hits = 0      # matching checks seen so far
        self.fired = 0     # times this fault actually fired

    def matches(self, names) -> bool:
        return self.site in names

    def should_fire(self) -> bool:
        self.hits += 1
        if self.nth == 0 or self.hits == self.nth:
            self.fired += 1
            return True
        return False


_lock = threading.Lock()
_state = {"parsed": False, "faults": [], "spec": ""}


def parse_spec(spec: str) -> list:
    """``kind:site:nth`` triples -> [_Fault]; raises ValueError on a
    malformed entry (a typo'd chaos spec must fail the run it was meant
    to harden, not silently test nothing).  ``delay`` entries alone
    accept a 4th field — the injected latency in seconds
    (``delay:tick:0:0.05``; default 0.05)."""
    faults = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        kind = bits[0].strip().lower()
        if kind == "delay" and len(bits) == 4:
            try:
                seconds = float(bits[3])
            except ValueError:
                raise ValueError(
                    f"PADDLE_TPU_FAULTS entry {part!r}: delay seconds "
                    f"must be a number")
            if seconds < 0:
                raise ValueError(
                    f"PADDLE_TPU_FAULTS entry {part!r}: delay seconds "
                    f"must be >= 0")
            bits = bits[:3]
        else:
            seconds = None
        if len(bits) != 3:
            raise ValueError(
                f"PADDLE_TPU_FAULTS entry {part!r}: expected kind:site:nth"
                + (" (delay alone takes kind:site:nth:seconds)"
                   if kind == "delay" else ""))
        site, nth = bits[1].strip(), bits[2]
        if kind not in _KINDS:
            raise ValueError(
                f"PADDLE_TPU_FAULTS kind {kind!r}: expected one of {_KINDS}")
        if not site:
            raise ValueError(f"PADDLE_TPU_FAULTS entry {part!r}: empty site")
        try:
            n = int(nth)
        except ValueError:
            raise ValueError(
                f"PADDLE_TPU_FAULTS entry {part!r}: nth must be an int")
        if n < 0:
            raise ValueError(
                f"PADDLE_TPU_FAULTS entry {part!r}: nth must be >= 0")
        faults.append(_Fault(kind, site, n, seconds))
    return faults


def _ensure_parsed():
    if _state["parsed"]:
        return
    with _lock:
        if _state["parsed"]:
            return
        spec = os.environ.get("PADDLE_TPU_FAULTS", "")
        _state["faults"] = parse_spec(spec)
        _state["spec"] = spec
        _state["parsed"] = True


def install(spec: str) -> None:
    """Programmatic (re)install for tests: replaces the active fault set
    and resets every counter."""
    with _lock:
        _state["faults"] = parse_spec(spec)
        _state["spec"] = spec
        _state["parsed"] = True


def reset() -> None:
    """Drop every fault and re-arm env parsing (tests)."""
    with _lock:
        _state["faults"] = []
        _state["spec"] = ""
        _state["parsed"] = False


def active() -> bool:
    """True when any fault is installed — hot paths gate their check
    calls on this one cheap test."""
    _ensure_parsed()
    return bool(_state["faults"])


def spec_string() -> str:
    """The active spec ('' when none)."""
    _ensure_parsed()
    return _state["spec"]


def _firing(kinds, names):
    _ensure_parsed()
    if not _state["faults"]:
        return None
    with _lock:
        for f in _state["faults"]:
            if f.kind in kinds and f.matches(names) and f.should_fire():
                return f
    return None


def check(*names: str, kinds: tuple = ("oom", "error", "wedge")) -> None:
    """Raise the matching injected failure, if any fault targeting one of
    ``names`` is due.  ``oom``/``error`` raise their exception; a
    ``wedge`` fault at a check-only site raises :class:`InjectedWedge`;
    an ``overload`` fault raises :class:`InjectedOverload` only at sites
    that opt in via ``kinds`` (admission paths).  Sites that ALSO have a
    real hang hook (the serving fetch calls :func:`hang`) pass
    ``kinds=("oom", "error")`` so a wedge spec reaches the hook as an
    actual hang instead of an eager raise.

    ``delay`` faults fire at EVERY check regardless of ``kinds``: they
    sleep their configured seconds and raise nothing — injected latency
    is benign at any site, and requiring opt-in would silently no-op a
    drill spec at most sites (the no-silent-no-op promise)."""
    d = _firing(("delay",), names)
    if d is not None:
        time.sleep(d.seconds if d.seconds is not None else _DELAY_DEFAULT_S)
    f = _firing(kinds, names)
    if f is None:
        return
    site = f.site
    if f.kind == "oom":
        raise InjectedOOM(site)
    if f.kind == "wedge":
        raise InjectedWedge(site)
    if f.kind == "overload":
        raise InjectedOverload(site)
    raise InjectedError(site)


def hang(*names: str) -> None:
    """Wedge-simulation hook: when a ``wedge`` fault targeting ``names``
    is due, SLEEP ``PADDLE_TPU_FAULT_WEDGE_S`` seconds (default 30) —
    long enough to exceed any sane step wall budget, short enough that
    the abandoned watchdog thread drains in tests."""
    f = _firing(("wedge",), names)
    if f is None:
        return
    try:
        dt = float(os.environ.get("PADDLE_TPU_FAULT_WEDGE_S", "30"))
    except ValueError:
        dt = 30.0
    time.sleep(max(0.0, dt))


def corrupt_nan(site: str, arr):
    """NaN-corruption hook: when a ``nan`` fault targeting ``site`` is
    due, return a NaN-filled float32 copy of ``arr`` — a numpy array, or
    a torch tensor (the copy then lies on the tensor's device); otherwise
    return ``arr`` unchanged."""
    f = _firing(("nan",), (site,))
    if f is None:
        return arr
    if type(arr).__module__.startswith("torch"):
        import torch

        return torch.full(tuple(arr.shape), float("nan"),
                          dtype=torch.float32, device=arr.device)
    import numpy as np

    out = np.array(arr, dtype=np.float32, copy=True)
    out.fill(np.nan)
    return out


def nan_train_steps(site: str = "train_step") -> tuple:
    """The 1-based step indices every ``nan:train_step:N`` fault targets
    (0 = every step), sorted — empty when none."""
    _ensure_parsed()
    return tuple(sorted(f.nth for f in _state["faults"]
                        if f.kind == "nan" and f.site == site))
