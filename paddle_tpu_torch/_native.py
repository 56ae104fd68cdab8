"""The port's host (C++) pieces, built with ``g++`` at first use and bound
with ctypes — counterpart of ``paddle_tpu/_native/__init__.py``.

``csrc/host/ps_table.cpp`` is the parameter-server table shard (sparse
rows with merged adagrad and delta pushes, mmap-backed "ssd" storage, the
graph table and its neighbour sampling): the same source as the JAX
package's, so that servers of both packages draw the same rows from the
same seed (``fill_random``'s ``mt19937_64``).  It compiles once into
``paddle_tpu_torch/_build/<hash>/lib<name>.so``, ``<hash>`` covering the
source and the flags (the way ``ops/_build.py`` keys the CUDA sources),
written through a temporary file and an atomic rename so that processes
building at once never load a torn library.  A failed build raises
:class:`NativeUnavailable`; nothing falls back.  Nothing here imports
torch: the table servers are plain CPU processes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host"
_OUT = _PKG / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeUnavailable(RuntimeError):
    pass


def _build(name: str) -> Path:
    src = _SRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(src.read_bytes())
    out = _OUT / h.hexdigest()[:16] / f"lib{name}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=240)
    except FileNotFoundError as e:
        raise NativeUnavailable("g++ not found") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"compile failed:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Compile (once) and dlopen ``csrc/host/<name>.cpp``."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name)))
        return _LIBS[name]


def ps_table() -> ctypes.CDLL:
    """The sparse- and graph-table shard library, its signatures set
    (those of ``paddle_tpu/_native/__init__.py``)."""
    lib = load("ps_table")
    if not getattr(lib, "_sigs_set", False):
        c = ctypes
        u64, ptr, cstr = c.c_uint64, c.c_void_p, c.c_char_p
        i64p = c.POINTER(c.c_int64)
        f32p = c.POINTER(c.c_float)
        lib.pst_create.restype = ptr
        lib.pst_create.argtypes = [u64, u64, u64, c.c_float]
        lib.pst_destroy.argtypes = [ptr]
        lib.pst_rows.restype = u64
        lib.pst_rows.argtypes = [ptr]
        lib.pst_dim.restype = u64
        lib.pst_dim.argtypes = [ptr]
        lib.pst_create_ssd.restype = ptr
        lib.pst_create_ssd.argtypes = [u64, u64, u64, c.c_float, cstr]
        lib.pst_sync.restype = c.c_int
        lib.pst_sync.argtypes = [ptr]
        lib.pst_pull.argtypes = [ptr, i64p, u64, f32p]
        lib.pst_push_adagrad.argtypes = [ptr, i64p, f32p, u64, c.c_float,
                                         c.c_float]
        lib.pst_push_delta.argtypes = [ptr, i64p, f32p, u64]
        lib.pst_save.restype = c.c_int
        lib.pst_save.argtypes = [ptr, cstr]
        lib.pst_load.restype = c.c_int
        lib.pst_load.argtypes = [ptr, cstr]
        lib.pgt_create.restype = ptr
        lib.pgt_create.argtypes = [u64]
        lib.pgt_destroy.argtypes = [ptr]
        lib.pgt_add_edges.argtypes = [ptr, i64p, i64p, f32p, u64]
        lib.pgt_add_nodes.argtypes = [ptr, i64p, u64]
        lib.pgt_num_nodes.restype = u64
        lib.pgt_num_nodes.argtypes = [ptr]
        lib.pgt_num_edges.restype = u64
        lib.pgt_num_edges.argtypes = [ptr]
        lib.pgt_degrees.argtypes = [ptr, i64p, u64, i64p]
        lib.pgt_sample_neighbors.argtypes = [ptr, i64p, u64, u64, i64p]
        lib.pgt_random_sample_nodes.argtypes = [ptr, u64, i64p]
        lib.pgt_set_node_feat.restype = c.c_int
        lib.pgt_set_node_feat.argtypes = [ptr, i64p, f32p, u64, u64]
        lib.pgt_get_node_feat.restype = c.c_int
        lib.pgt_get_node_feat.argtypes = [ptr, i64p, u64, u64, f32p,
                                          c.POINTER(c.c_uint8)]
        lib.pgt_feat_dim.restype = u64
        lib.pgt_feat_dim.argtypes = [ptr]
        lib.pgt_save.restype = c.c_int
        lib.pgt_save.argtypes = [ptr, cstr]
        lib.pgt_load.restype = c.c_int
        lib.pgt_load.argtypes = [ptr, cstr]
        lib._sigs_set = True
    return lib
