"""SLO-driven admission control: rate limits, priority classes, and a
degradation ladder.

The port's own copy of ``paddle_tpu/text/admission.py``, host logic only,
with the same semantics, so one observation stream gives the same
verdicts in both packages.  Overload is what fails first in a server, so
the answer is given at the door.  One :class:`AdmissionController` per
``serving.DecodeServer``:

* **Per-tenant token buckets** — ``submit(tenant=...)`` charges the
  tenant's bucket ``len(prompt) + max_new_tokens`` tokens; an empty
  bucket rejects the request (status ``rejected``,
  ``resilience.Overloaded`` from ``result()`` — distinct from the TTL
  ``timeout``: a timeout waited and lost, a reject was refused at the
  door and should back off).  ``PADDLE_TPU_TENANT_RATE`` /
  ``PADDLE_TPU_TENANT_BURST``.

* **Priority classes + bounded queues** — priorities bucket into three
  classes (<=0 low, 1 normal, >=2 high); each class's queued work is
  bounded at ``PADDLE_TPU_ADMISSION_QUEUE_CAP`` (0 = unbounded) and an
  over-cap class sheds its NEWEST entry (the oldest queued request is
  closest to service; shedding it would waste its wait).  Under SLO
  overload the LOWEST class sheds first — see the ladder below.

* **The SLO control loop** — :meth:`control_tick` runs at most once per
  ``PADDLE_TPU_SLO_WINDOW_S``: it snapshots the ``serving.ttft_ms`` and
  ``serving.decode_gap_ms`` telemetry histograms, computes the WINDOWED
  p99 from the bucket-count delta (``telemetry.quantile_from_counts``),
  and compares against ``PADDLE_TPU_SLO_TTFT_MS`` /
  ``PADDLE_TPU_SLO_TPOT_MS``.  Each breached window climbs ONE rung of
  a deterministic degradation ladder; each fully healthy window steps
  back down one rung (symmetric by construction):

  ====  =========================================================
  rung  effect (cumulative)
  ====  =========================================================
  0     normal service
  1     admit cap halved for class 0 (fewer concurrent slots ->
        shorter ticks)
  2     prefill budget drops one captured width (AIMD: the drop is
        multiplicative — the widths are halvings — the climb back is
        one width per healthy window)
  3     prefill budget drops again; speculation forced off for new
        admissions (:meth:`AdmissionController.spec_forced`, read by a
        speculating ``DecodeServer`` at each claim)
  4     shed: new lowest-class submissions reject at the door
  ====  =========================================================

  The budget rungs are chunk widths (:func:`ladder_widths`) that
  ``DecodeServer.warmup`` captures as CUDA graphs next to the base
  width, so a ladder move is a host-side pick among graphs that exist —
  never a capture mid-serve (the recompile watch,
  ``telemetry.record_compile``, shows it).  In-flight admitting slots
  keep the width their chunk starts were planned with; the new width
  applies to new claims.

* **Fleet backpressure** — :meth:`absorb_fleet_rung` adopts a worst
  replica rung instead of running a histogram loop, for a front door
  over replicas; ``DecodeServer.load_stats()`` exports
  ``admission_rung`` for it.  The port has no fleet router yet.

Everything counts into the telemetry registry under ``admission.*``
(sheds per class, tenant throttles, degradations, rung and budget-level
gauges) — exported by ``telemetry.render_prometheus`` and folded into
``GET /healthz`` via ``telemetry.admission_snapshot``.
``PADDLE_TPU_ADMISSION=0`` constructs no controller: greedy FIFO
admission, bit-identical to a server without admission control.
"""
from __future__ import annotations

import time

from .. import faults as _faults
from .. import flags as _flags
from .. import telemetry as _telemetry

__all__ = [
    "AdmissionController", "TokenBucket", "priority_class",
    "ladder_widths", "NUM_CLASSES", "RUNG_SHED", "RUNG_MAX",
]

NUM_CLASSES = 3       # low (<=0), normal (1), high (>=2)
RUNG_SPEC_OFF = 3     # speculation forced off at this rung and above
RUNG_SHED = 4         # lowest-class submissions reject at this rung
RUNG_MAX = 4

# minimum samples a window needs before its p99 can call a breach: one
# slow straggler in an otherwise idle window must not start degrading
_MIN_WINDOW_SAMPLES = 4


def priority_class(priority: int) -> int:
    """Priority -> class index: 0 (low, priority <= 0), 1 (normal,
    priority == 1), 2 (high, priority >= 2).  The class drives queue
    bounds and shed ordering; the raw priority still orders
    routing/eviction within a class."""
    p = int(priority)
    return 0 if p <= 0 else (1 if p == 1 else 2)


def ladder_widths(budget: int) -> tuple:
    """The pre-warmed prefill-budget rungs for base width ``budget``:
    halvings ``(W, W/2, W/4)`` floored at ``min(W, 8)``, deduped,
    descending — 2-3 COMPILED chunk widths (a tiny base budget yields
    fewer rungs; the ladder is then inert on the budget axis).  Every
    rung is an admission-executable shape ``warmup()`` pre-compiles, so
    the controller's AIMD moves between them never retrace."""
    b = int(budget or 0)
    if b <= 0:
        return ()
    floor = min(b, 8)
    out = []
    for w in (b, b // 2, b // 4):
        w = max(floor, w)
        if w not in out:
            out.append(w)
    return tuple(out)


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst``
    capacity, charged in admitted tokens (prompt + max_new).  Host
    arithmetic on the caller's clock — deterministic for tests that
    pass explicit ``now`` values."""

    __slots__ = ("rate", "burst", "level", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)      # a fresh tenant may burst
        self.t_last = float(now)

    def try_take(self, cost: float, now: float) -> bool:
        if now > self.t_last:
            self.level = min(self.burst,
                             self.level + (now - self.t_last) * self.rate)
            self.t_last = now
        if self.level >= cost:
            self.level -= cost
            return True
        return False


class AdmissionController:
    """One admission authority for a serving front door (a
    ``DecodeServer``; ``scope`` names it, for fault-site labels and the
    ``admission.<scope>_rung`` gauge).  All state is host-side and cheap; every
    decision is deterministic given the observation stream.

    Constructor arguments default from the ``PADDLE_TPU_*`` env knobs
    (see :mod:`paddle_tpu_torch.flags`); tests override them
    directly."""

    def __init__(self, *, scope: str = "serving",
                 slo_ttft_ms: float | None = None,
                 slo_tpot_ms: float | None = None,
                 window_s: float | None = None,
                 tenant_rate: float | None = None,
                 tenant_burst: float | None = None,
                 queue_cap: int | None = None,
                 budget_rungs: tuple = (),
                 now: float | None = None):
        self.scope = scope
        self.slo_ttft_ms = (_flags.slo_ttft_ms() if slo_ttft_ms is None
                            else slo_ttft_ms)
        self.slo_tpot_ms = (_flags.slo_tpot_ms() if slo_tpot_ms is None
                            else slo_tpot_ms)
        self.window_s = (_flags.slo_window_s() if window_s is None
                         else max(0.05, float(window_s)))
        self.tenant_rate = (_flags.tenant_rate() if tenant_rate is None
                            else tenant_rate)
        burst = (_flags.tenant_burst() if tenant_burst is None
                 else tenant_burst)
        if burst is None and self.tenant_rate is not None:
            burst = 2.0 * self.tenant_rate
        self.tenant_burst = burst
        self.queue_cap = (_flags.admission_queue_cap() if queue_cap is None
                          else max(0, int(queue_cap)))
        self.budget_rungs = tuple(budget_rungs)
        self.rung = 0
        # adaptive budget (flags.adaptive_budget, default on): the TPOT
        # objective moves this counter independently of the full
        # ladder, so the prefill budget shrinks on a decode-gap breach
        # WITHOUT dragging the admit cap / spec-off / shed levers along
        # — budget_level takes the max of ladder- and adaptive-derived
        # levels, always indexing the same pre-warmed rungs
        self._adaptive = _flags.adaptive_budget()
        self._budget_adapt = 0
        now = time.perf_counter() if now is None else now
        self._t_eval = now + self.window_s
        self._buckets: dict = {}
        # previous cumulative histogram counts (None until first tick:
        # the first window's delta is vs the controller's birth)
        self._prev: dict = {}
        self.admitted_tokens: dict = {}    # tenant -> tokens (fairness)
        self._set_gauges()

    # -- front-door verdicts ------------------------------------------------

    def admit(self, tenant, priority: int, cost: int,
              now: float | None = None):
        """The submit-time verdict: ``(True, None)`` to enqueue, or
        ``(False, reason)`` when the request must retire ``rejected``.
        Checks, in order: the injected-overload drill hook, the shed
        rung (lowest class only), then the tenant's token bucket.
        Queue bounds are enforced AFTER enqueue (the caller's
        ``*_shed_queue_overflow``) so a full queue sheds the lowest
        class, not necessarily the newcomer."""
        now = time.perf_counter() if now is None else now
        try:
            if _faults.active():
                _faults.check("admission.submit", f"{self.scope}.submit",
                              kinds=("overload",))
        except _faults.InjectedOverload:
            return self._shed_at_door(priority, "injected_overload")
        if self.rung >= RUNG_SHED and priority_class(priority) == 0:
            return self._shed_at_door(priority, "degraded")
        if not self._bucket_ok(tenant, cost, now):
            return self._throttle_tenant(tenant, priority)
        key = tenant if tenant is not None else "_default"
        self.admitted_tokens[key] = \
            self.admitted_tokens.get(key, 0) + int(cost)
        return True, None

    def _bucket_ok(self, tenant, cost: int, now: float) -> bool:
        if self.tenant_rate is None:
            return True
        key = tenant if tenant is not None else "_default"
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(
                self.tenant_rate, self.tenant_burst, now)
        return b.try_take(cost, now)

    def _shed_at_door(self, priority: int, reason: str):
        self.count_shed(priority, reason)
        return False, reason

    def _throttle_tenant(self, tenant, priority: int):
        _telemetry.count("admission.tenant_throttles")
        self.count_shed(priority, "rate_limited")
        return False, "rate_limited"

    def count_shed(self, priority: int, reason: str) -> None:
        """One request shed/rejected by admission (either door-reject or
        a queue-overflow victim): the per-class counter is the
        ``sheds per class`` series the drills assert."""
        c = priority_class(priority)
        _telemetry.count("admission.sheds")
        _telemetry.count(f"admission.sheds_class{c}")
        _telemetry.event("admission.shed", time.perf_counter(),
                         time.perf_counter(), priority_class=c,
                         reason=reason)

    def overflow_victim(self, queue) -> int | None:
        """Index of the request to shed when the bounded per-class
        queues overflow, or None when every class fits.  Victim rule:
        among over-cap classes take the LOWEST, and within it the
        NEWEST entry (latest ``t_enqueue``; the oldest queued request
        is closest to service and keeps its wait)."""
        if not self.queue_cap or not queue:
            return None
        per_class: dict = {}
        for i, req in enumerate(queue):
            per_class.setdefault(
                priority_class(req.get("priority", 0)), []).append(i)
        for c in range(NUM_CLASSES):
            idxs = per_class.get(c)
            if idxs and len(idxs) > self.queue_cap:
                return max(idxs, key=lambda i: (
                    queue[i].get("t_enqueue", 0.0), i))
        return None

    # -- the SLO control loop ----------------------------------------------

    def _window_p99(self, name: str) -> tuple:
        cur = _telemetry.hist(name).raw_counts()
        prev = self._prev.get(name)
        self._prev[name] = cur
        # max(0, ...): a telemetry.reset() between windows shrinks the
        # cumulative buckets below the snapshot — clamp instead of
        # feeding negative weights to the quantile
        delta = (cur if prev is None
                 else [max(0, a - b) for a, b in zip(cur, prev)])
        n = sum(delta)
        return n, _telemetry.quantile_from_counts(delta, 0.99)

    def control_tick(self, now: float | None = None,
                     idle: bool = False) -> bool:
        """Run one SLO evaluation if a full window elapsed (else no-op;
        call freely from every scheduler tick).  A window with any SLO
        breach climbs one rung; a healthy window steps back down one
        (symmetric).  ``idle=True`` (the caller vouches: no active
        slots, nothing queued) plus a sample-free window resets the
        ladder to rung 0 outright — the overload is fully drained, so
        one window suffices instead of rung-many, while recovery UNDER
        load stays one rung per healthy window.  Returns True when an
        evaluation ran."""
        now = time.perf_counter() if now is None else now
        if now < self._t_eval:
            return False
        self._t_eval = now + self.window_s
        breach = False
        evidence = False
        samples = 0
        tpot_breach = False
        tpot_evidence = False
        for name, slo in (("serving.ttft_ms", self.slo_ttft_ms),
                          ("serving.decode_gap_ms", self.slo_tpot_ms)):
            if slo is None:
                continue
            n, p99 = self._window_p99(name)
            samples += n
            if n >= _MIN_WINDOW_SAMPLES:
                evidence = True
                if name == "serving.decode_gap_ms":
                    tpot_evidence = True
                if p99 > slo:
                    breach = True
                    if name == "serving.decode_gap_ms":
                        tpot_breach = True
        if breach:
            self._degrade_one_rung()
        elif self.rung > 0:
            if idle and samples == 0:
                self._recover_idle()
            elif evidence:
                # stepwise recovery needs an affirmatively healthy
                # window (enough samples, every objective within SLO);
                # a sample-starved window under load stays inconclusive
                # and HOLDS the rung — recovering on silence would flap
                # the ladder exactly when the shrunken admit cap
                # throttles the sample rate
                self._recover_one_rung()
        if self._adaptive and self.budget_rungs:
            # the budget-only control loop: same evidence rules as the
            # ladder (breach shrinks one rung, an affirmatively healthy
            # TPOT window grows one back, a vouched-idle empty window
            # resets), but touching ONLY the chunk-width lever
            top = len(self.budget_rungs) - 1
            if tpot_breach and self._budget_adapt < top:
                self._budget_adapt += 1
                _telemetry.count("admission.budget_shrinks")
                self._set_gauges()
            elif (not tpot_breach) and self._budget_adapt > 0:
                if idle and samples == 0:
                    self._budget_adapt = 0
                    _telemetry.count("admission.budget_grows")
                    self._set_gauges()
                elif tpot_evidence:
                    self._budget_adapt -= 1
                    _telemetry.count("admission.budget_grows")
                    self._set_gauges()
        return True

    def _degrade_one_rung(self) -> None:
        if self.rung < RUNG_MAX:
            self.rung += 1
        _telemetry.count("admission.degradations")
        self._set_gauges()

    def _recover_one_rung(self) -> None:
        self.rung -= 1
        _telemetry.count("admission.recoveries")
        self._set_gauges()

    def _recover_idle(self) -> None:
        _telemetry.count("admission.recoveries", self.rung)
        self.rung = 0
        self._budget_adapt = 0
        self._set_gauges()

    def absorb_fleet_rung(self, rung: int) -> None:
        """Fleet mirror (the router's verdict source): adopt the worst
        replica rung as this controller's rung — no own histogram loop,
        recovery exactly tracks the replicas'."""
        rung = max(0, min(RUNG_MAX, int(rung)))
        if rung != self.rung:
            self.rung = rung
            self._set_gauges()

    # -- derived effects ----------------------------------------------------

    @property
    def budget_level(self) -> int:
        """Index into :attr:`budget_rungs` the current state selects:
        the max of the ladder-derived level (rung 0-1 -> level 0;
        rung 2 -> 1; rung >= 3 -> 2) and the adaptive TPOT counter
        (flags.adaptive_budget), clamped to the rungs that exist."""
        if not self.budget_rungs:
            return 0
        lvl = 0 if self.rung <= 1 else (1 if self.rung == 2 else 2)
        lvl = max(lvl, self._budget_adapt)
        return min(lvl, len(self.budget_rungs) - 1)

    def effective_budget(self, base: int) -> int:
        """The prefill chunk width new admissions should claim at — one
        of the pre-warmed :attr:`budget_rungs` (``base`` when no rungs
        were configured)."""
        if not self.budget_rungs:
            return base
        return min(base, self.budget_rungs[self.budget_level]) \
            if base else base

    def effective_admit_cap(self, base: int) -> int:
        """Admit-cap component of the ladder: halved from rung 1 up.
        The cap is SHED pressure, so schedulers apply it to class-0
        admissions only — higher classes keep the full (OOM-bounded)
        batch; throttling the traffic the ladder exists to protect
        would make degradation self-defeating."""
        return base if self.rung < 1 else max(1, int(base) // 2)

    @property
    def engaged(self) -> bool:
        """True when any objective or limit is configured (an SLO, a
        tenant rate, a queue bound) — the controller has actual work.
        An UNCONFIGURED controller (the default-on state) must leave
        scheduling byte-identical to ``PADDLE_TPU_ADMISSION=0``, so
        callers gate priority-aware reordering on this."""
        return (self.slo_ttft_ms is not None
                or self.slo_tpot_ms is not None
                or self.tenant_rate is not None
                or self.queue_cap > 0)

    def spec_forced(self) -> bool:
        """True when new admissions must decode plain (rung >= 3): a
        speculating server sets the claimed slot's ``spec_off``, the flag
        the acceptance-driven fallback sets, and counts
        ``admission.spec_forced``."""
        return self.rung >= RUNG_SPEC_OFF

    def rejecting(self) -> bool:
        """True when the ladder's shed rung is active (new lowest-class
        submissions reject at the door)."""
        return self.rung >= RUNG_SHED

    def _set_gauges(self) -> None:
        _telemetry.set_gauge(f"admission.{self.scope}_rung", self.rung)
        _telemetry.set_gauge("admission.rung", self.rung)
        _telemetry.set_gauge("admission.budget_level", self.budget_level)

    def stats(self) -> dict:
        """Controller state for ``load_stats()`` / ``healthz()``."""
        return {
            "rung": self.rung,
            "budget_level": self.budget_level,
            "budget_adapt": self._budget_adapt,
            "spec_forced": self.spec_forced(),
            "shedding": self.rejecting(),
            "queue_cap": self.queue_cap,
            "tenant_rate": self.tenant_rate,
            "admitted_tokens": dict(self.admitted_tokens),
        }
