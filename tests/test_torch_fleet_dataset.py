"""The port's fleet datasets and data generators
(paddle_tpu_torch/distributed/fleet/dataset.py, data_generator.py)
against the JAX package's.

* the reference's two cases (tests/test_fleet_dataset.py:30-60) in the
  port;
* ``QueueDataset`` (one thread, drop-last on and off, a shuffle window),
  ``InMemoryDataset`` (its epochs, ``local_shuffle`` under a seed) and
  ``slice_batch`` give the JAX package's batches and feeds bit for bit on
  the same files and seed;
* the MultiSlot data generators write the JAX package's lines, from
  memory and from stdin.

The readers share one built file (``test_torch_native_io.
share_native_library``), each package binding it on its own handle.
"""
import io
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet import data_generator as jdg
from paddle_tpu.distributed.fleet import dataset as jds
from paddle_tpu_torch.distributed.fleet import data_generator as tdg
from paddle_tpu_torch.distributed.fleet import dataset as tds

from test_torch_native_io import share_native_library


@pytest.fixture(scope="module", autouse=True)
def _lib():
    with share_native_library():
        yield


def _shards(tmp_path, n_files=2, per=10, seq=8):
    rng = np.random.default_rng(0)
    files, rows = [], []
    for i in range(n_files):
        arr = rng.integers(0, 100, (per, seq), dtype=np.int32)
        p = tmp_path / f"s{i}.bin"
        arr.tofile(p)
        files.append(str(p))
        rows.append(arr)
    return files, np.concatenate(rows)


def test_queue_dataset_streams(tmp_path):
    files, all_rows = _shards(tmp_path)
    ds = tds.QueueDataset()
    ds.set_filelist(files)
    ds.set_record_schema(8)
    ds.set_batch_size(5)
    ds.set_thread(2)
    got = list(ds)
    assert all(b.shape == (5, 8) for b in got)
    assert sum(len(b) for b in got) == 20


def test_inmemory_dataset_shuffle_epochs(tmp_path):
    files, all_rows = _shards(tmp_path)
    ds = tds.InMemoryDataset()
    ds.set_filelist(files)
    ds.set_record_schema(8)
    ds.set_batch_size(4)
    ds.load_into_memory()
    assert ds.get_memory_data_size() == 20
    first = np.concatenate(list(ds))
    ds.local_shuffle(seed=1)
    second = np.concatenate(list(ds))
    assert sorted(map(tuple, first)) == sorted(map(tuple, second))
    assert not np.array_equal(first, second)
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


def _configure(ds, files, batch, threads=1, window=0, seed=0):
    ds.set_filelist(files)
    ds.set_record_schema(8)
    ds.set_batch_size(batch)
    ds.set_thread(threads)
    ds.set_shuffle_window(window)
    ds.set_seed(seed)
    return ds


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("drop,window,seed", [(True, 0, 0), (False, 0, 0),
                                              (True, 6, 5)])
def test_queue_dataset_batches_equal_jax(tmp_path, drop, window, seed):
    files, _ = _shards(tmp_path, n_files=3, per=11)
    a = _configure(jds.QueueDataset(), files, 4, window=window, seed=seed)
    b = _configure(tds.QueueDataset(), files, 4, window=window, seed=seed)
    a.set_drop_last(drop)
    b.set_drop_last(drop)
    _equal_batches(list(a), list(b))


def test_inmemory_dataset_epochs_and_shuffles_equal_jax(tmp_path):
    files, rows = _shards(tmp_path, n_files=3, per=7)
    a = _configure(jds.InMemoryDataset(), files, 3, threads=2, seed=4)
    b = _configure(tds.InMemoryDataset(), files, 3, threads=2, seed=4)
    a.load_into_memory()
    b.load_into_memory()
    assert a.get_memory_data_size() == b.get_memory_data_size() == 21
    # two threads stage records in no fixed order: put both in one
    # order, then the epochs and the seeded shuffles must agree
    order = np.lexsort(b._records.T[::-1])
    a._records = a._records[np.lexsort(a._records.T[::-1])]
    b._records = b._records[order]
    _equal_batches(list(a), list(b))
    for seed in (None, 1, 9):
        a.local_shuffle(seed=seed)
        b.local_shuffle(seed=seed)
        _equal_batches(list(a), list(b))
    a.global_shuffle(seed=2)
    b.global_shuffle(seed=2)
    _equal_batches(list(a), list(b))


def test_slice_batch_feeds_equal_jax(tmp_path):
    files, _ = _shards(tmp_path)
    vars_ = [SimpleNamespace(name="ids", shape=(-1, 3), dtype="int64"),
             SimpleNamespace(name="dense", shape=(-1, 2, 2),
                             dtype=np.float32),
             SimpleNamespace(name="label", shape=(-1,), dtype="int32")]
    port_vars = vars_[:2] + [SimpleNamespace(name="label", shape=(-1,),
                                             dtype=torch.int32)]
    a = _configure(jds.QueueDataset(), files, 5)
    b = _configure(tds.QueueDataset(), files, 5)
    a.set_use_var(vars_)
    b.set_use_var(port_vars)
    for x, y in zip(list(a), list(b)):
        fa, fb = a.slice_batch(x), b.slice_batch(y)
        assert list(fa) == list(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype
            assert np.array_equal(fa[k], fb[k])
    with pytest.raises(ValueError, match="dynamic trailing dim"):
        b.set_use_var([SimpleNamespace(name="x", shape=(-1, -1),
                                       dtype="int32")])
        b.slice_batch(np.zeros((2, 8), np.int32))


def _generators(mod):
    class Words(mod.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def it():
                w = line.split()
                yield [("words", w), ("len", [str(len(w))])]
            return it

    class Nums(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                v = [int(t) for t in line.split()]
                if not v:
                    yield None
                    return
                yield [("ids", v), ("score", [sum(v) / 7.0, 0.25])]
            return it

        def generate_batch(self, samples):
            def it():
                for s in reversed(samples):
                    yield s
            return it

    return Words(), Nums()


def test_data_generators_write_jax_lines(monkeypatch):
    lines = ["a bb ccc", "dd", "1 2 3", "", "4 5", "x y z w"]
    num_lines = ["1 2 3", "", "4 5", "7", "10 20 30 40", "5", "6"]
    (jw, jn), (tw, tn) = _generators(jdg), _generators(tdg)
    for g in (jn, tn):
        g.set_batch(3)
    assert tw.run_from_memory(lines) == jw.run_from_memory(lines)
    assert tn.run_from_memory(num_lines) == jn.run_from_memory(num_lines)
    outs = []
    for g in (jn, tn):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(num_lines)))
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdout", buf)
        g.run_from_stdin()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") == 6
    with pytest.raises(ValueError, match="non-empty"):
        tdg.MultiSlotDataGenerator()._gen_str([])
