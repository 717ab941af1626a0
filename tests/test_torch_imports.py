"""The port imports neither JAX nor any module of the JAX package, and it
runs on CUDA unless the CPU is asked for explicitly.

The import check runs in a subprocess: this test process has already
imported jax (tests/conftest.py). Module names are matched exactly, since
``predictionio_tpu_torch`` itself starts with ``predictionio_tpu``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import ServingFactors, recommend_batch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "predictionio_tpu_torch"


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "predictionio_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_load_no_jax_and_no_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "predictionio_tpu_torch.api.engine_server" in loaded
    assert "predictionio_tpu_torch.parallel.mesh" in loaded
    assert [m for m in loaded if _banned(m)] == []


def test_port_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [
                f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                for n in names if _banned(n)
            ]
    assert offenders == []


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uf = np.zeros((3, 4), np.float32)
    itf = np.zeros((5, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingFactors(uf, itf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recommend_batch(uf, itf, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert ServingFactors(uf, itf, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
