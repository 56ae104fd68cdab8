"""The interleaved pipeline schedule generator
(paddle_tpu_torch/distributed/pp_schedule.py) against the JAX package's
(paddle_tpu/distributed/pp_schedule.py): the reference's four
``TestScheduleGenerator`` cases (tests/test_pp_interleaved.py:45-85) in
the port, and every table of ``build(S, v, M)`` — the slots, both
receive tables, ticks, ring depth and idle share — equal to JAX's array
for array over a grid of (S, v, M).
"""
import itertools

import numpy as np
import pytest

from paddle_tpu.distributed import pp_schedule as jps
from paddle_tpu_torch.distributed import pp_schedule


class TestScheduleGenerator:
    @pytest.mark.parametrize("S,v,M", [(2, 1, 4), (2, 2, 4), (4, 2, 8),
                                       (3, 2, 5), (4, 4, 8), (2, 3, 7)])
    def test_builds_and_validates(self, S, v, M):
        s = pp_schedule.build(S, v, M)  # build() runs validate() itself
        assert s.ticks >= 2 * v * M  # cannot beat the per-rank work bound
        assert 1 <= s.buf <= M

    def test_every_slot_executed_exactly_once(self):
        s = pp_schedule.build(3, 2, 5)
        seen = set()
        for t in range(s.ticks):
            for r in range(3):
                kind, c, m = s.table[t, r]
                if kind != pp_schedule.IDLE:
                    key = (int(kind), int(c * 3 + r), int(m))
                    assert key not in seen
                    seen.add(key)
        assert len(seen) == 2 * 6 * 5

    def test_bubble_shrinks_with_virtual_stages(self):
        S, M = 4, 8
        flat_units = 2 * (M + 2 * (S - 1))  # per chunk-pair, v=1 baseline
        for v in (2, 4):
            s = pp_schedule.build(S, v, M)
            assert s.ticks < flat_units * v, (v, s.ticks)
        i2 = pp_schedule.build(S, 2, M).idle_frac
        i4 = pp_schedule.build(S, 4, M).idle_frac
        assert i4 < i2

    def test_recv_tables_point_at_ring_neighbors(self):
        s = pp_schedule.build(2, 2, 4)
        for t in range(1, s.ticks):
            for r in range(2):
                valid, c2, slot = s.recv_f[t, r]
                if valid:
                    kind, c, m = s.table[t - 1, (r - 1) % 2]
                    assert kind == pp_schedule.F
                    assert c2 * 2 + r == c * 2 + (r - 1) % 2 + 1


GRID = list(itertools.product((1, 2, 3, 4), (1, 2, 3), (1, 2, 4, 5, 8)))


def test_tables_equal_jax_over_a_grid():
    for S, v, M in GRID:
        a, b = jps.build(S, v, M), pp_schedule.build(S, v, M)
        for f in ("table", "recv_f", "recv_b"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (S, v, M, f)
        assert (a.ticks, a.buf, a.n_virtual, a.n_stages, a.n_micro) == \
            (b.ticks, b.buf, b.n_virtual, b.n_stages, b.n_micro)
        assert a.idle_frac == b.idle_frac


def test_validate_refuses_a_broken_table():
    s = pp_schedule.build(2, 2, 4)
    t = s.table.copy()
    f = np.argwhere(t[:, :, 0] == pp_schedule.F)[-1]
    t[f[0], f[1]] = (pp_schedule.IDLE, 0, 0)     # a forward lost
    with pytest.raises(AssertionError):
        pp_schedule.validate(s._replace(table=t))
