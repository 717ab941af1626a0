"""Step-level training checkpoints: the counterpart of
``predictionio_tpu/workflow/checkpoint.py`` (orbax there) for the port.

A training loop saves its state every ``every`` steps and resumes from the
latest step after an interruption, keeping the newest ``max_to_keep``
steps. Each step is one ``step_<n>.npz`` in the directory: a dict of numpy
arrays and numbers, written under a temporary name and moved into place
with ``os.replace``, so a reader finds a whole file or none, and read back
with ``allow_pickle=False``. The format is the port's own: a checkpoint of
the JAX package is not read here, nor the reverse.

Usage in a training loop::

    ckpt = StepCheckpointer(dir, every=5)
    start = 0
    if (state := ckpt.restore_latest()) is not None:
        start, arrays = int(state["step"]), state["arrays"]
    for step in range(start, n_steps):
        ...
        ckpt.maybe_save(step + 1, {"step": step + 1, "arrays": arrays})
    ckpt.close()
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


class StepCheckpointer:
    """Step saves of a dict of arrays into ``directory`` (None disables
    it), at most ``max_to_keep`` of them."""

    def __init__(self, directory: Optional[str], every: int = 1, max_to_keep: int = 2):
        self.directory = None if directory is None else os.path.abspath(directory)
        self.every = max(1, every)
        self.max_to_keep = max(1, max_to_keep)
        if self.directory is not None:
            os.makedirs(self.directory, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    def _steps(self) -> List[int]:
        if self.directory is None:
            return []
        return sorted(
            int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory)) if m
        )

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Dict[str, np.ndarray]]:
        """The latest saved dict (numbers come back as 0-d arrays), or
        None when disabled or empty."""
        step = self.latest_step()
        if step is None:
            return None
        logger.info("restoring checkpoint step %d from %s", step, self.directory)
        with np.load(self._path(step), allow_pickle=False) as f:
            return {name: f[name] for name in f.files}

    def maybe_save(self, step: int, state: Dict[str, object], force: bool = False) -> bool:
        """Save ``state`` as step ``step`` when the step hits the cadence
        (or ``force``), then drop the oldest steps past ``max_to_keep``."""
        if self.directory is None:
            return False
        if not force and step % self.every != 0:
            return False
        tmp = os.path.join(self.directory, f".step_{step}.{os.getpid()}.tmp.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **{name: np.asarray(v) for name, v in state.items()})
        os.replace(tmp, self._path(step))
        for old in self._steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.directory = None
