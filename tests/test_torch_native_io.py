"""The port's native ingestion (paddle_tpu_torch/io/native_reader.py over
csrc/host/io_runtime.cpp) against the JAX package's
(paddle_tpu/io/native_reader.py over paddle_tpu/_native/io_runtime.cpp).

* the reference's four cases (tests/test_native_io.py:24-76) in the port;
* the same shards read by both packages' ``TokenShardReader`` at one
  thread, without and with a shuffle window and seed: the same batches,
  bit for bit, in the same order; at more threads the same multiset of
  records (the C++ feeders race);
* ``DevicePrefetcher(device="cpu")``: the port's ``"prefetch"`` fault
  retried within bounds and counted, a dead generator's error raised
  (not a short epoch), ``close()`` mid-epoch stopping the thread.

Both packages' readers run one C++ source (the port's copy is the JAX
package's byte for byte, checked here).  The port builds its library
into its own ``_build/<hash>/``; :func:`share_native_library` opens that
file a second time as the JAX package's library for a module's tests, so
that they never run the JAX package's build, which writes one shared
temporary file and would race the JAX package's own tests in other
workers.  The JAX loader binds its own ctypes signatures on its own
handle, and its previous state comes back after the module.
"""
import contextlib
import ctypes
import filecmp
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu._native as jnative
from paddle_tpu.io import native_reader as jnr
from paddle_tpu_torch import _native, faults, telemetry
from paddle_tpu_torch.io import native_reader as tnr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def share_native_library():
    """For the block: the port's built ``io_runtime`` file, opened as a
    new ``CDLL`` handle, installed as the JAX package's library when the
    JAX loader has none yet (it then builds nothing, and sets its own
    signatures on that handle); removed again afterwards."""
    path = _native.io_runtime()._name
    with jnative._LOCK:
        installed = "io_runtime" not in jnative._LIBS
        if installed:
            jnative._LIBS["io_runtime"] = ctypes.CDLL(path)
    try:
        yield
    finally:
        if installed:
            with jnative._LOCK:
                jnative._LIBS.pop("io_runtime", None)


def write_shards(tmp_path, sizes, seq, seed=0, vocab=1000):
    rng = np.random.default_rng(seed)
    files, rows = [], []
    for i, n in enumerate(sizes):
        arr = rng.integers(0, vocab, (n, seq), dtype=np.int32)
        p = tmp_path / f"shard{i}.bin"
        arr.tofile(p)
        files.append(str(p))
        rows.append(arr)
    return files, np.concatenate(rows)


@pytest.fixture(scope="module", autouse=True)
def _lib():
    with share_native_library():
        yield


def test_one_source_for_both_packages():
    assert filecmp.cmp(
        os.path.join(ROOT, "paddle_tpu/_native/io_runtime.cpp"),
        os.path.join(ROOT, "paddle_tpu_torch/csrc/host/io_runtime.cpp"),
        shallow=False)


def test_each_package_binds_its_own_handle():
    """The JAX loader's library (the port's file, or its own build when
    the JAX package's tests loaded one first) is a handle of its own,
    with the JAX package's signatures set on it."""
    jlib, tlib = jnative.io_runtime(), _native.io_runtime()
    assert jlib is not tlib
    assert jlib.ptq_create is not tlib.ptq_create
    assert jlib._sigs_set and tlib._sigs_set


def test_queue_roundtrip():
    q = tnr.BlockingBatchQueue(capacity=4)
    a = np.arange(32, dtype=np.uint8)
    assert q.push(a)
    np.testing.assert_array_equal(q.pop(), a)


def test_queue_blocking_producer_consumer():
    q = tnr.BlockingBatchQueue(capacity=2)
    N = 50
    got = []

    def producer():
        for i in range(N):
            q.push(np.full(16, i % 256, np.uint8))
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    while True:
        b = q.pop()
        if b is None:
            break
        got.append(int(b[0]))
    t.join()
    assert got == [i % 256 for i in range(N)]


def test_token_shard_reader(tmp_path):
    seq, bs = 16, 4
    files, all_rows = write_shards(tmp_path, (8, 12, 16), seq)
    r = tnr.TokenShardReader(files, seq_len=seq, batch_size=bs,
                             num_threads=2)
    batches = list(r)
    assert all(b.shape[1] == seq for b in batches)
    # no record lost: a worker's last batch may be short
    assert sum(b.shape[0] for b in batches) == len(all_rows)
    assert r.records_read == len(all_rows)


def test_device_prefetcher():
    src = [np.ones((2, 2), np.float32) * i for i in range(5)]
    out = list(tnr.DevicePrefetcher(src, depth=2, device="cpu"))
    assert len(out) == 5
    assert float(out[3][0, 0]) == 3.0
    assert out[3].device.type == "cpu"


@pytest.mark.parametrize("window,seed", [(0, 0), (8, 3), (5, 11)])
def test_one_thread_batches_equal_jax(tmp_path, window, seed):
    files, rows = write_shards(tmp_path, (9, 14, 5), 12, seed=seed)
    kw = dict(seq_len=12, batch_size=4, num_threads=1, seed=seed,
              shuffle_window=window)
    a = list(jnr.TokenShardReader(files, **kw))
    b = list(tnr.TokenShardReader(files, **kw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    got = np.concatenate(b)
    if window == 0:
        assert np.array_equal(got, rows)          # file order, record order
    else:
        assert sorted(map(bytes, got)) == sorted(map(bytes, rows))


def test_threads_deliver_the_records_jax_does(tmp_path):
    files, rows = write_shards(tmp_path, (7, 10, 13, 4, 9), 8)
    kw = dict(seq_len=8, batch_size=3, num_threads=3)
    a = np.concatenate(list(jnr.TokenShardReader(files, **kw)))
    b = np.concatenate(list(tnr.TokenShardReader(files, **kw)))
    want = sorted(map(bytes, rows))
    assert sorted(map(bytes, a)) == want == sorted(map(bytes, b))


def _count(name):
    return telemetry.counters().get(name, 0)


def test_prefetch_fault_retried_and_counted():
    """The port's ``"prefetch"`` fault site: the 2nd pull fails once,
    is retried and counted, and no batch is lost."""
    items = [np.full((2,), i, np.int64) for i in range(4)]
    before = _count("resilience.prefetch_retries")
    faults.install("error:prefetch:2")
    try:
        got = list(tnr.DevicePrefetcher(iter(items), depth=2,
                                        device="cpu", retries=2))
    finally:
        faults.reset()
    assert [int(g[0]) for g in got] == [0, 1, 2, 3]
    assert _count("resilience.prefetch_retries") == before + 1


def test_prefetch_persistent_fault_exhausts_retries():
    faults.install("error:io.prefetch:0")
    try:
        pf = tnr.DevicePrefetcher(iter([np.zeros(1)] * 3), device="cpu",
                                  retries=1)
        t0 = time.perf_counter()
        with pytest.raises(faults.InjectedError):
            list(pf)
        assert time.perf_counter() - t0 < 10.0
    finally:
        faults.reset()


def test_dead_generator_error_surfaces():
    """A generator that raised is dead: its retry pull sees
    StopIteration, and the consumer gets the original error — never a
    silently short epoch."""
    def gen():
        yield np.zeros(2)
        raise OSError("shard vanished")

    pf = tnr.DevicePrefetcher(gen(), depth=2, device="cpu", retries=3)
    got = []
    with pytest.raises(OSError, match="shard vanished"):
        for x in pf:
            got.append(x)
    assert len(got) == 1


def test_close_mid_epoch_stops_the_worker():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield np.full((4,), i)
            i += 1

    pf = tnr.DevicePrefetcher(endless(), depth=2, device="cpu")
    it = iter(pf)
    assert int(next(it)[0]) == 0
    pf.close()
    pf._t.join(timeout=5.0)
    assert not pf._t.is_alive()
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n                    # nothing pulled after close


def test_prefetcher_refuses_a_missing_card():
    """The default device is the card: without one it raises, it does
    not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnr.DevicePrefetcher(iter([np.zeros(1)]))
