"""Step-level training checkpoints: the counterpart of
``predictionio_tpu/workflow/checkpoint.py`` (orbax there) for the port.

A training loop saves its state every ``every`` steps and resumes from the
latest step after an interruption, keeping the newest ``max_to_keep``
steps. Each step is one ``step_<n>.npz`` in the directory: a dict of numpy
arrays and numbers, nested dicts of them included, written under a
temporary name and moved into place with ``os.replace``, so a reader finds
a whole file or none, and read back with ``allow_pickle=False``. A nested
dict is stored flat, one entry per leaf under its path (``arrays/user_factors``)
and rebuilt on restore; a flat state keeps one entry per key. A value that
is not a number or a numeric array (an object, a string) raises
``ValueError`` before anything is written, so no pickle reaches the disk.
The format is the port's own: a checkpoint of the JAX package is not read
here, nor the reverse.

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
from typing import Dict, List, Mapping, Optional

import numpy as np

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")

# joins a nested key's path into one entry name; no key may contain it
SEP = "/"

# numpy dtype kinds a checkpoint holds: bool, signed, unsigned, float,
# complex (never object or text, which np.savez would pickle or which
# are not state)
_NUMERIC_KINDS = "biufc"


def flatten_state(state: Mapping[str, object], prefix: str = "") -> Dict[str, np.ndarray]:
    """``state`` as path-keyed numeric arrays: a nested dict's leaves under
    ``outer/inner`` names. Raises ``ValueError`` on a key that is not a
    string or holds ``SEP``, an empty nested dict, or a value that is not
    a number or a numeric array."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        if not isinstance(key, str) or not key or SEP in key:
            raise ValueError(
                f"checkpoint key {prefix}{key!r} must be a non-empty string "
                f"without {SEP!r}"
            )
        name = prefix + key
        if isinstance(value, Mapping):
            if not value:
                raise ValueError(f"checkpoint entry {name!r} is an empty dict")
            flat.update(flatten_state(value, name + SEP))
            continue
        arr = np.asarray(value)
        if arr.dtype.kind not in _NUMERIC_KINDS:
            raise ValueError(
                f"checkpoint entry {name!r} is {type(value).__name__} of dtype "
                f"{arr.dtype}: only numbers and numeric arrays are saved"
            )
        flat[name] = arr
    return flat


def unflatten_state(flat: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """The nested dict ``flatten_state`` flattened."""
    state: Dict[str, object] = {}
    for name, arr in flat.items():
        *outer, leaf = name.split(SEP)
        node = state
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return state


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

    def restore_latest(self) -> Optional[Dict[str, object]]:
        """The latest saved dict, nesting rebuilt (numbers come back as
        0-d arrays), or None when disabled or empty."""
        step = self.latest_step()
        if step is None:
            return None
        logger.info("restoring checkpoint step %d from %s", step, self.directory)
        with np.load(self._path(step), allow_pickle=False) as f:
            return unflatten_state({name: f[name] for name in f.files})

    def maybe_save(self, step: int, state: Dict[str, object], force: bool = False) -> bool:
        """Save ``state`` as step ``step`` when the step hits the cadence
        (or ``force``), then drop the oldest steps past ``max_to_keep``.
        Raises ``ValueError`` (and writes nothing) on a state
        ``flatten_state`` refuses."""
        if self.directory is None:
            return False
        if not force and step % self.every != 0:
            return False
        flat = flatten_state(state)
        tmp = os.path.join(self.directory, f".step_{step}.{os.getpid()}.tmp.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, self._path(step))
        for old in self._steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.directory = None
