"""Interleaved pipeline schedule generation (virtual pipeline stages) —
counterpart of ``paddle_tpu/distributed/pp_schedule.py``.

Megatron-LM's interleaved 1F1B assigns each pipeline rank ``v`` model
chunks round-robin — virtual stage ``j`` lives on rank ``j % S`` (chunk
``j // S``) — so the pipeline fill is paid in chunk units instead of
stage units, shrinking the bubble fraction from ``(S-1)/M`` toward
``(S-1)/(v*M)``.

The schedule is data: a ``[ticks, S]`` table of slots, each one of
fwd / bwd / idle with a (chunk, micro-batch) payload, and the receive
tables of what lands on each rank at the start of a tick — produced by
an explicit dependency-driven simulation and re-checked edge by edge by
:func:`validate`.  Plain numpy; the same tables as the JAX package's,
array for array.  Its consumer (``pp_layers``' interleaved train step)
needs the Paddle-compat layers and is not ported.

A slot is (kind, chunk, m): kind 0=fwd, 1=bwd, 2=idle.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

F, B, IDLE = 0, 1, 2


class Schedule(NamedTuple):
    table: np.ndarray       # [ticks, S, 3] int32: (kind, chunk, m)
    recv_f: np.ndarray      # [ticks, S, 3] int32: (valid, chunk, mslot) —
    #   forward activation arriving at tick start (sent by rank-1 last tick)
    recv_b: np.ndarray      # [ticks, S, 3] int32: cotangent arriving
    ticks: int
    buf: int                # ring-buffer depth per chunk (max in-flight)
    n_virtual: int
    n_stages: int
    n_micro: int

    @property
    def idle_frac(self) -> float:
        kinds = self.table[:, :, 0]
        return float((kinds == IDLE).sum()) / kinds.size


def _sim(S: int, v: int, M: int):
    """Greedy dependency-driven simulation of interleaved 1F1B.

    Policy per rank per tick: run a READY backward if one exists (drain
    activations as early as possible — the 1F1B memory property), else the
    next READY forward in Megatron chunk-group order, else idle.  Any
    dependency-correct schedule is numerically valid; greedy-bwd-first
    recovers flat 1F1B exactly at v=1 and the Megatron bubble shape for
    v>1 (asserted by tests, not assumed).
    """
    V = S * v
    # fwd_done[j][m] / bwd_done[j][m] = tick when it completed, or -1
    fwd_done = -np.ones((V, M), np.int64)
    bwd_done = -np.ones((V, M), np.int64)

    # per-rank forward work list in Megatron order: micro-batches grouped
    # per chunk in runs of S (finish a group of S micro-batches on chunk c
    # before touching chunk c+1, cycling)
    def fwd_order():
        # identical for every rank: the rank-dependence of interleaved 1F1B
        # lives in WHEN a rank may start (the warmup offset), not in the
        # order it walks its chunks
        order = []
        groups = (M + S - 1) // S
        for g in range(groups):
            ms = range(g * S, min((g + 1) * S, M))
            for c in range(v):
                for m in ms:
                    order.append((c, m))
        return order

    _order = fwd_order()
    fwd_q = {r: list(_order) for r in range(S)}
    bwd_q = {r: [] for r in range(S)}  # filled as forwards complete
    slots = []

    def fwd_ready(r, c, m, t):
        j = c * S + r
        if j == 0:
            return True
        # producer ran on rank (j-1) % S; +1 tick for the ppermute hop
        d = fwd_done[j - 1, m]
        return d >= 0 and d < t

    def bwd_ready(r, c, m, t):
        j = c * S + r
        if fwd_done[j, m] < 0 or fwd_done[j, m] >= t:
            return False
        if j == V - 1:
            return True
        d = bwd_done[j + 1, m]
        return d >= 0 and d < t

    total = 2 * V * M
    done = 0
    t = 0
    while done < total:
        if t > total + 4 * V * M + 16:  # deadlock guard (impossible if
            raise AssertionError(       # the dependency logic is right)
                f"schedule simulation deadlocked: S={S} v={v} M={M}")
        row = []
        decisions = []
        for r in range(S):
            # pick using state as of tick start (fwd_done/bwd_done updated
            # AFTER the loop so ranks can't see same-tick completions)
            pick = None
            for c, m in bwd_q[r]:
                if bwd_ready(r, c, m, t):
                    pick = (B, c, m)
                    break
            if pick is None:
                for c, m in fwd_q[r]:
                    if fwd_ready(r, c, m, t):
                        pick = (F, c, m)
                        break
            row.append(pick if pick else (IDLE, 0, 0))
            decisions.append(pick)
        for r, pick in enumerate(decisions):
            if pick is None:
                continue
            kind, c, m = pick
            j = c * S + r
            if kind == F:
                fwd_q[r].remove((c, m))
                fwd_done[j, m] = t
                bwd_q[r].append((c, m))
            else:
                bwd_q[r].remove((c, m))
                bwd_done[j, m] = t
            done += 1
        slots.append(row)
        t += 1
    return np.asarray(slots, np.int64), fwd_done, bwd_done


def build(S: int, v: int, M: int) -> Schedule:
    table, fwd_done, bwd_done = _sim(S, v, M)
    ticks = table.shape[0]
    V = S * v

    def x_window(j, m):
        """Ticks during which stage j's INPUT for micro-batch m occupies
        its ring slot: stashed when the upstream activation arrives (one
        tick after the producer's fwd; at fwd time for stage 0, whose
        input comes from the batch), freed after bwd(j, m) consumes it."""
        start = fwd_done[j, m] if j == 0 else fwd_done[j - 1, m] + 1
        return start, bwd_done[j, m]

    def d_window(j, m):
        """Cotangent slot: stashed when bwd(j+1, m)'s dx arrives, consumed
        by bwd(j, m).  Empty for the last stage (head-fed)."""
        if j == V - 1:
            return None
        return bwd_done[j + 1, m] + 1, bwd_done[j, m]

    # ring-buffer depth: max simultaneous occupants per (stage, slot kind)
    buf = 1
    for j in range(V):
        for win in (x_window, d_window):
            spans = [win(j, m) for m in range(M)]
            spans = [s for s in spans if s is not None]
            for t in range(ticks):
                alive = sum(1 for a, b in spans if a <= t <= b)
                buf = max(buf, alive)
    buf = min(buf, M)

    # receive tables: what lands on rank r at the START of tick t is what
    # rank (r-1) % S (fwd) / (r+1) % S (bwd) executed at tick t-1
    recv_f = np.zeros((ticks, S, 3), np.int64)
    recv_b = np.zeros((ticks, S, 3), np.int64)
    for t in range(1, ticks):
        for r in range(S):
            kind, c, m = table[t - 1, (r - 1) % S]
            j = c * S + (r - 1) % S
            if kind == F and j + 1 < V:
                # j+1 = c2*S + r: on the wrap hop (sender rank S-1 → rank
                # 0) the chunk advances; otherwise same chunk
                c2 = (j + 1) // S
                assert (j + 1) % S == r
                recv_f[t, r] = (1, c2, m % buf)
            kind, c, m = table[t - 1, (r + 1) % S]
            j = c * S + (r + 1) % S
            if kind == B and j - 1 >= 0:
                c2 = (j - 1) // S
                assert (j - 1) % S == r
                recv_b[t, r] = (1, c2, m % buf)

    sched = Schedule(table.astype(np.int32), recv_f.astype(np.int32),
                     recv_b.astype(np.int32), ticks, int(buf), v, S, M)
    validate(sched)
    return sched


def validate(s: Schedule):
    """Re-derive every dependency edge from the emitted table (the
    consumer trusts this table blindly — a scheduling bug here would show
    up as silently wrong gradients, so fail loudly instead)."""
    S, v, M = s.n_stages, s.n_virtual, s.n_micro
    V = S * v
    fwd_at = {}
    bwd_at = {}
    for t in range(s.ticks):
        for r in range(S):
            kind, c, m = s.table[t, r]
            j = c * S + r
            if kind == F:
                assert (j, m) not in fwd_at, f"dup fwd {(j, m)}"
                if j > 0:
                    assert fwd_at.get((j - 1, m), 10**9) < t, \
                        f"fwd({j},{m})@{t} before producer"
                fwd_at[(j, m)] = t
            elif kind == B:
                assert (j, m) in fwd_at and fwd_at[(j, m)] < t
                if j < V - 1:
                    assert bwd_at.get((j + 1, m), 10**9) < t, \
                        f"bwd({j},{m})@{t} before consumer grad"
                assert (j, m) not in bwd_at
                bwd_at[(j, m)] = t
    assert len(fwd_at) == V * M and len(bwd_at) == V * M, "lost slots"

    # ring-buffer safety on the CONSUMER's actual windows: the x slot for
    # (j, m) is written when the upstream activation ARRIVES (producer
    # fwd + 1 hop tick; at own-fwd time for stage 0) and read by bwd(j,m);
    # the d slot is written at bwd(j+1,m)+1 and read by bwd(j,m).  No
    # other micro-batch sharing the same ring index may write inside a
    # live window.
    def windows(j):
        out = []
        for m in range(M):
            xs = fwd_at[(j, m)] if j == 0 else fwd_at[(j - 1, m)] + 1
            out.append(("x", m, xs, bwd_at[(j, m)]))
            if j < V - 1:
                out.append(("d", m, bwd_at[(j + 1, m)] + 1,
                            bwd_at[(j, m)]))
        return out

    for j in range(V):
        per_kind: dict = {}
        for kind, m, a, b in windows(j):
            per_kind.setdefault((kind, m % s.buf), []).append((a, b, m))
        for (kind, slot), spans in per_kind.items():
            spans.sort()
            for (a1, b1, m1), (a2, b2, m2) in zip(spans, spans[1:]):
                assert a2 > b1, (f"{kind}-slot clobbered: stage {j} "
                                 f"slot {slot}: m={m1}[{a1},{b1}] vs "
                                 f"m={m2}[{a2},{b2}]")
