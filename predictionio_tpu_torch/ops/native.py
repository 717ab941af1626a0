"""Builds the port's CUDA sources (``predictionio_tpu_torch/csrc``) with
``nvcc`` into shared libraries with a plain C interface, which the kernel
wrappers load with ``ctypes``.

A library is built at first use, into ``predictionio_tpu_torch/_build``
(listed in ``.gitignore``), under a name that carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
A failed build raises with the compiler's output. Nothing here runs when
the module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

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
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "port's kernels"
    )


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: named by a hash of its bytes and
    the flags."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_sources(sources: Sequence[str]) -> Dict[str, Path]:
    """Build every source in ``sources`` that has no current library,
    starting one nvcc for each, all at once; return source -> library.
    The compiler's output is kept beside each library as ``.log``."""
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return out
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
        raise RuntimeError("\n".join(failed))
    return out


def build_log(source: str) -> str:
    """The compiler's output from the build of ``csrc/<source>``."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""
