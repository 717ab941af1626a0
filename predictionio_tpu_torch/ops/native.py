"""Builds the port's CUDA sources (``predictionio_tpu_torch/csrc``) with
``nvcc`` into shared libraries with a plain C interface, which the kernel
wrappers load with ``ctypes`` (``Library``), and counts the wrappers'
launches (``LaunchCounts``).

A library is built at first use, into ``predictionio_tpu_torch/_build``
(listed in ``.gitignore``), under a name that carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
A failed build raises ``KernelError`` with the compiler's output, as does a
launch that returns a CUDA error. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels;
# -Xptxas -v records registers, shared memory and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelError(RuntimeError):
    """A kernel that did not build or did not launch: never a condition a
    caller may work around by another route."""


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's standard location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "port's kernels"
    )


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: named by a hash of its bytes, the
    shared headers' (``csrc/*.cuh``) and the flags."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_sources(sources: Sequence[str]) -> Dict[str, Path]:
    """Build every source in ``sources`` that has no current library,
    starting one nvcc for each, all at once; return source -> library.
    The compiler's output is kept beside each library as ``.log``."""
    out = {s: library_path(s) for s in sources}
    # one build of a source at a time in this process (a background
    # build and a first use may meet); taken in one order, so no deadlock
    locks = [_source_lock(s) for s in sorted(set(sources))]
    for lock in locks:
        lock.acquire()
    try:
        _build_missing(sources, out)
    finally:
        for lock in reversed(locks):
            lock.release()
    return out


_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_SOURCE_LOCKS_GUARD = threading.Lock()


def _source_lock(source: str) -> threading.Lock:
    with _SOURCE_LOCKS_GUARD:
        return _SOURCE_LOCKS.setdefault(source, threading.Lock())


def _build_missing(sources: Sequence[str], out: Dict[str, Path]) -> None:
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        # build under a private name and rename: a concurrent build of
        # the same source never sees a half-written library
        tmp = out[s].with_name(f"{out[s].stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        out[s].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{s} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[s])
    if failed:
        raise KernelError("\n".join(failed))


def build_log(source: str) -> str:
    """The compiler's output from the build of ``csrc/<source>``."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


class Library:
    """One kernel source's library, built (at first use) and loaded once per
    process. ``declare`` sets the ``argtypes``/``restype`` of its launch
    functions; ``error_string`` names its C function that turns the
    ``cudaError_t`` they return into text."""

    def __init__(
        self,
        source: str,
        declare: Callable[[ctypes.CDLL], None],
        error_string: str,
    ):
        self.source = source
        self._declare = declare
        self._error_string = error_string
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def get(self) -> ctypes.CDLL:
        lib = self._lib  # loaded: no lock (the lock guards the first load only)
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_sources([self.source])[self.source]))
                self._declare(lib)
                err = getattr(lib, self._error_string)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error."""
        if err != 0:
            text = getattr(self.get(), self._error_string)(err).decode()
            raise KernelError(
                f"{what} kernel launch failed: {text} (cudaError {err})"
            )


_raw_stream: Optional[Callable[[int], int]] = None


def current_stream(index: int) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on CUDA device
    ``index``, as an int for a kernel's C entry point: torch's raw lookup,
    which builds no ``torch.cuda.Stream`` (the public one where a build of
    torch lacks it)."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


class LaunchCounts:
    """Integer launch counters, safe under concurrent serving threads."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = {name: 0 for name in names}

    def add(self, name: str, launches: int = 1) -> None:
        with self._lock:
            self._counts[name] += launches

    def reset(self) -> None:
        with self._lock:
            for name in self._counts:
                self._counts[name] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)
