"""Streaming data-generator protocol — counterpart of
``paddle_tpu/distributed/fleet/data_generator.py`` (the reference's
fleet/data_generator/data_generator.py).

Users subclass ``DataGenerator`` and implement :meth:`generate_sample`;
the runner turns raw log lines (stdin or memory) into the slot text
format — per slot, ``<n> v1 .. vn`` tokens joined by spaces, one sample
per line.  Plain Python, the same lines as the JAX package's.
"""
from __future__ import annotations

import sys
from typing import Iterable

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Base runner.  Subclasses implement :meth:`generate_sample(line)`
    returning a zero-arg generator of ``[(slot_name, [values...]), ...]``
    samples; optionally :meth:`generate_batch(samples)` for cross-sample
    logic (negative sampling, batching tricks)."""

    def __init__(self):
        self.batch_size_ = 32

    def set_batch(self, batch_size: int):
        self.batch_size_ = int(batch_size)

    # -- user hooks ----------------------------------------------------------
    def generate_sample(self, line):
        raise NotImplementedError(
            "implement generate_sample(line) -> iterator of "
            "[(slot, [values]), ...]")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- runners -------------------------------------------------------------
    def run_from_stdin(self):
        """Read raw lines from stdin, write slot-format lines to stdout
        (the hadoop-streaming shape the reference uses for feature logs)."""
        self._run(sys.stdin, sys.stdout)

    def run_from_memory(self, lines: Iterable[str]) -> list[str]:
        out: list[str] = []

        class _Sink:
            def write(self, s):
                if s.strip():
                    out.append(s.rstrip("\n"))

        self._run(lines, _Sink())
        return out

    def _run(self, lines, sink):
        batch = []
        for line in lines:
            it = self.generate_sample(line)
            for sample in it():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) >= self.batch_size_:
                    self._flush(batch, sink)
                    batch = []
        if batch:
            self._flush(batch, sink)

    def _flush(self, batch, sink):
        for processed in self.generate_batch(batch)():
            sink.write(self._gen_str(processed) + "\n")

    def _gen_str(self, sample) -> str:
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    @staticmethod
    def _check_sample(sample):
        if not isinstance(sample, (list, tuple)) or not sample:
            raise ValueError(
                f"a sample must be a non-empty list/tuple of "
                f"(slot, values) pairs, got {type(sample).__name__}")


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: each value rendered via str(); floats keep their
    repr so the DataFeed's float slots parse exactly."""

    def _gen_str(self, sample) -> str:
        self._check_sample(sample)
        parts = []
        for name, values in sample:
            if not isinstance(values, (list, tuple)):
                raise ValueError(f"slot {name!r}: values must be a list")
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)


class MultiSlotStringDataGenerator(DataGenerator):
    """String slots: values are pre-stringified feasigns, emitted as-is
    (faster: no numeric conversion round-trip)."""

    def _gen_str(self, sample) -> str:
        self._check_sample(sample)
        parts = []
        for name, values in sample:
            if not isinstance(values, (list, tuple)):
                raise ValueError(f"slot {name!r}: values must be a list")
            parts.append(str(len(values)))
            parts.extend(values)
        return " ".join(parts)
