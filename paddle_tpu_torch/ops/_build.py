"""Build the port's CUDA sources (``paddle_tpu_torch/csrc/*.cu``) at first
use and load them with ctypes.

Each source becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

All sources compile at once (one ``nvcc`` process each, started
together) into ``paddle_tpu_torch/_build/<hash>/``, where ``<hash>``
covers every source and the flags — an edited source gets a fresh
directory, an unchanged tree reuses the libraries it built before.  No
PyTorch header is included, so a build takes seconds, not minutes.

Nothing here runs at import: the first kernel launch (or ``build_all``)
builds.  A wrapper passes pointers and the stream as ``ctypes.c_void_p``
and every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
SOURCES = ("flash_fwd", "decode_attention")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, PATH): "
            "the port's CUDA kernels are built on the machine with the card")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_SRC / f"{name}.cu").read_bytes())
    return _OUT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing — all in parallel —
    and return {name: library path}.  Raises with nvcc's output when a
    build fails."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    procs = {}
    nvcc = _nvcc() if todo else None
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu (exit {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])   # atomic: no torn library
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
