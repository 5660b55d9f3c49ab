"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into a shared library under the checkout's ``build/`` directory:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/tracklab_torch_kernels/<name>-<hash>.so \
         csrc/<name>.cu

The file name carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Libraries are loaded with ``ctypes``;
tensors are passed as ``data_ptr()`` integers and the current CUDA stream as
an integer handle. Nothing here runs at import time: importing the package
needs neither a GPU nor ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "tracklab_torch_kernels"
SOURCES = ("jv", "jv_rect", "csp", "vit_attention", "oru_replay")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"{name}-{digest}.so"


def library(name: str) -> Path:
    """The shared library built from ``csrc/<name>.cu`` (built first if
    needed), e.g. for ``cuobjdump -sass``."""
    build_all((name,))
    return _lib_path(name)


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, out) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every source that is not built yet, one nvcc each, all
    started together."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        try:
            _finish(n, job)
        except RuntimeError as e:  # finish the other builds, then report
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(_lib_path(name)))
