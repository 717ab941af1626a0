"""Markov chain model over state-transition tallies: the counterpart of
``predictionio_tpu/e2/markov_chain.py`` (reference
e2/src/main/scala/io/prediction/e2/engine/MarkovChain.scala:25-89).

``MarkovChain.train`` takes a sparse tally of transitions (from, to, count)
on the host, keeps the top-N transitions per source state normalized by the
source's total tally, and ``predict`` propagates a current-state
probability vector one step (current @ P over the kept transitions) on the
device: K16, ``ops/markov.markov_step``.

The kept transitions stay the dense [n_states, top_n] (target, probability)
arrays of the reference. ``predict`` places them once per device, as a
target-major CSR (``ops/markov.place_transitions``), and reuses them; that
device state is never pickled. The model carries the device it predicts on
(None: CUDA). On a 1-D ``data`` mesh of several shards ``predict`` shards
the source states and the state vector (K16s,
``ops/markov.markov_step_shards``), its placement cached per mesh, which
the cache holds by weakref and compares by identity, as the reference's
does. ``markov_model_from_numpy`` builds a model from a trained model's
arrays (a JAX-trained one included).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import markov
from predictionio_tpu_torch.parallel.mesh import Mesh, check_data_axis, collapse_mesh, cut_rows


@dataclasses.dataclass
class MarkovChainModel:
    """Top-N normalized transitions (reference MarkovChainModel :63-89)."""

    n_states: int
    n: int  # top-N kept per state
    targets: np.ndarray  # [n_states, n] int32 (padding: target 0 with 0 prob)
    probs: np.ndarray  # [n_states, n] float32
    device: Optional[torch.device] = None  # where predict runs (None: CUDA)
    # (weakref of the mesh or None, device or None, ops.markov.PlacedTransitions
    # or MeshTransitions) placed once; device state, never pickled
    _placed: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_placed"] = None
        return state

    def transition_map(self) -> Dict[int, List[Tuple[int, float]]]:
        """Per-state kept transitions as {state: [(target, prob)]}, sorted
        by target index (the reference's SparseVector view)."""
        out: Dict[int, List[Tuple[int, float]]] = {}
        for i in range(self.n_states):
            entries = [
                (int(t), float(p))
                for t, p in zip(self.targets[i], self.probs[i])
                if p > 0.0
            ]
            if entries:
                out[i] = sorted(entries)
        return out

    def predict(
        self, current_state: Sequence[float], mesh=None, axis: str = "data"
    ) -> List[float]:
        """Probabilities of the next state (reference predict :68-88): one
        K16 launch on the model's device (None: CUDA), or, on a 1-D
        ``data`` ``mesh`` of several shards, K16s over its shards (a mesh of
        one shard is its device). Raises ``ValueError`` on a state vector
        whose length is not n_states."""
        check_data_axis(axis)
        mesh, device = collapse_mesh(mesh, None)
        cur = np.asarray(current_state, np.float32)
        if cur.shape != (self.n_states,):
            raise ValueError(
                f"the current state has shape {cur.shape}; the chain has "
                f"{self.n_states} states"
            )
        if mesh is not None:
            placed = self._mesh_transitions(mesh)
            curs = cut_rows(mesh, cur, placed.bounds)
            return markov.markov_step_shards(curs, placed).cpu().numpy().tolist()
        dev = resolve_device(device if device is not None else self.device)
        out = markov.markov_step(torch.from_numpy(cur).to(dev), self._device_transitions(dev))
        return out.cpu().numpy().tolist()

    def _cached(self, mesh: Optional[Mesh], dev: Optional[torch.device]):
        """The placement cached for ``mesh`` (compared by identity, through
        a weakref: a dead mesh's entry serves no mesh) or, with no mesh, for
        ``dev`` (a mesh's entry never serves it); else None."""
        if self._placed is None:
            return None
        ref, cached_dev, placed = self._placed
        if mesh is None:
            return placed if ref is None and cached_dev == dev else None
        return placed if ref is not None and ref() is mesh else None

    def _device_transitions(self, dev: torch.device) -> markov.PlacedTransitions:
        """The kept transitions on ``dev``, placed once and reused: repeat
        predicts ship only the [n_states] state vector."""
        placed = self._cached(None, dev)
        if placed is None:
            placed = markov.place_transitions(self.targets, self.probs, self.n_states, dev)
            self._placed = (None, dev, placed)
        return placed

    def _mesh_transitions(self, mesh: Mesh) -> markov.MeshTransitions:
        """The kept transitions on ``mesh``'s shards, placed once per mesh."""
        placed = self._cached(mesh, None)
        if placed is None:
            placed = markov.place_transitions_mesh(
                self.targets, self.probs, self.n_states, mesh.shard_devices())
            self._placed = (weakref.ref(mesh), None, placed)
        return placed


class MarkovChain:
    """Trainer (reference object MarkovChain :25-62)."""

    @staticmethod
    def train(
        entries: Sequence[Tuple[int, int, float]],
        n_states: int,
        top_n: int,
        device: DeviceLike = None,
    ) -> MarkovChainModel:
        """``entries`` is the transition tally as (from, to, count) triples
        (the reference's CoordinateMatrix entries). Host code; the model
        predicts on ``device`` (CUDA unless the CPU is asked for)."""
        dev = resolve_device(device)
        tally: Dict[int, Dict[int, float]] = {}
        for i, j, v in entries:
            if not (0 <= int(i) < n_states and 0 <= int(j) < n_states):
                raise ValueError(
                    f"transition ({i} -> {j}) out of range for {n_states} states"
                )
            row = tally.setdefault(int(i), {})
            row[int(j)] = row.get(int(j), 0.0) + float(v)

        targets = np.zeros((n_states, top_n), np.int32)
        probs = np.zeros((n_states, top_n), np.float32)
        for i, row in tally.items():
            total = sum(row.values())
            top = sorted(row.items(), key=lambda kv: -kv[1])[:top_n]
            top.sort(key=lambda kv: kv[0])  # reference sorts kept by index
            for k, (j, v) in enumerate(top):
                targets[i, k] = j
                probs[i, k] = v / total
        return MarkovChainModel(
            n_states=n_states, n=top_n, targets=targets, probs=probs, device=dev
        )


def markov_model_from_numpy(
    n_states: int, targets: np.ndarray, probs: np.ndarray, device: DeviceLike = None
) -> MarkovChainModel:
    """A model from a trained model's arrays (``targets`` and ``probs``
    [n_states, top_n]), predicting on ``device`` (CUDA unless the CPU is
    asked for)."""
    targets = np.asarray(targets, np.int32)
    probs = np.asarray(probs, np.float32)
    if targets.ndim != 2 or targets.shape != probs.shape or targets.shape[0] != n_states:
        raise ValueError(
            f"targets {targets.shape} and probs {probs.shape} must both be "
            f"[{n_states}, top_n]"
        )
    return MarkovChainModel(
        n_states=n_states, n=targets.shape[1], targets=targets, probs=probs,
        device=resolve_device(device),
    )
