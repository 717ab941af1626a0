"""Columnar event batches: the port's copy of the interface of
``predictionio_tpu/data/storage/columnar.py``.

``ColumnarEvents`` holds dictionary-encoded (entity, target, value) triples;
``ColumnarStream`` is the chunked scan the streaming trainer
(``ops/streaming.py``) folds batch by batch while the next one is still
being read. ``ValueSpec`` declares how an event becomes a training value.
The event store that produces these scans, and ``encode_strings``, come
with it (ROADMAP.md queue 1 item 3); until then a caller builds a stream
from its own batches or from ``ColumnarStream.from_columnar``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ValueSpec:
    """Declarative per-event training value: ``event_overrides`` wins,
    else the numeric ``prop`` property, else ``default``."""

    prop: str = "rating"
    default: float = 1.0
    event_overrides: Tuple[Tuple[str, float], ...] = ()

    @property
    def overrides(self) -> Dict[str, float]:
        return dict(self.event_overrides)

    def value_of(self, event) -> float:
        """Per-event fallback (generic scan path)."""
        ov = self.overrides.get(event.event)
        if ov is not None:
            return float(ov)
        return float(event.properties.get_or_else(self.prop, self.default))


@dataclasses.dataclass
class ColumnarEvents:
    """Dictionary-encoded (entity, target, value) triples.

    ``entity_names[entity_codes[j]]`` is the j-th event's entity id. The
    name arrays are deduplicated and the codes dense (0..len(names)-1).
    """

    entity_names: np.ndarray  # [n_entities] str (object dtype)
    target_names: np.ndarray  # [n_targets] str
    entity_codes: np.ndarray  # [n] int32
    target_codes: np.ndarray  # [n] int32
    values: np.ndarray  # [n] float32

    @property
    def n(self) -> int:
        return len(self.values)

    @staticmethod
    def empty() -> "ColumnarEvents":
        return ColumnarEvents(
            entity_names=np.empty(0, object),
            target_names=np.empty(0, object),
            entity_codes=np.empty(0, np.int32),
            target_codes=np.empty(0, np.int32),
            values=np.empty(0, np.float32),
        )

    @staticmethod
    def concat(parts: Sequence["ColumnarEvents"]) -> "ColumnarEvents":
        """Merge batches, re-encoding codes against a deduplicated name
        dictionary (vectorized; names are catalog-sized, not event-sized)."""
        parts = [p for p in parts if p.n or len(p.entity_names)]
        if not parts:
            return ColumnarEvents.empty()
        if len(parts) == 1:
            return parts[0]

        def merge(names_list, codes_list):
            all_names = np.concatenate(
                [np.asarray(n, object) for n in names_list]
            )
            uniq, inverse = np.unique(all_names, return_inverse=True)
            out_codes = []
            offset = 0
            for names, codes in zip(names_list, codes_list):
                lut = inverse[offset : offset + len(names)].astype(np.int32)
                out_codes.append(lut[codes])
                offset += len(names)
            return uniq, np.concatenate(out_codes)

        e_names, e_codes = merge(
            [p.entity_names for p in parts], [p.entity_codes for p in parts]
        )
        t_names, t_codes = merge(
            [p.target_names for p in parts], [p.target_codes for p in parts]
        )
        return ColumnarEvents(
            entity_names=e_names,
            target_names=t_names,
            entity_codes=e_codes,
            target_codes=t_codes,
            values=np.concatenate([p.values for p in parts]).astype(
                np.float32
            ),
        )


class ColumnarStream:
    """Chunked columnar scan: an iterator of ``(entity_codes,
    target_codes, values)`` batches that all share ONE string-code space,
    plus the id-indexed ``names`` array resolving codes to id strings.

    This is the store→device streaming substrate (the role ALX's
    pre-bucketed input pipeline plays for TPU matrix factorization,
    PAPERS.md — arXiv:2112.02194): the training pipeline folds each batch
    into its pack structures while the backend is still scanning the
    next one, instead of materializing the whole event history first.

    Contract:
    - the code space may GROW while iterating (e.g. sqlite's row-store
      residual tail introduces ids absent from the page dictionary), so
      consumers size code-indexed accumulators from the codes they see
      and read ``names`` only after exhausting the iterator;
    - ``fingerprint`` is the producing store's cheap state fingerprint
      taken BEFORE the scan started (None when the backend can't provide
      one). Reading it pre-scan means a cached artifact can only ever be
      labeled with a fingerprint at least as old as its data — a
      concurrent write during the scan makes the next lookup miss, never
      hit stale;
    - ``cache_key``/``cache_scope`` identify the (app, channel, filters)
      and the producing DAO for the pack-artifact cache (the scope is
      compared by IDENTITY, never by a reusable ``id()``);
    - ``cursor`` (valid once the iterator is exhausted, like ``names``)
      is the backend's opaque delta cursor: the high-water state this
      scan actually covered. Feeding it back through ``delta_factory``
      (set by ``PEventStore.stream_columns``) yields a stream of ONLY
      the rows committed after it — the substrate of delta training
      (``ops/streaming``). ``None`` means the backend has no delta path
      and retrains rescan in full.
    """

    def __init__(
        self,
        batches,
        names_fn,
        fingerprint=None,
        cache_key=None,
        cache_scope=None,
        cursor_fn=None,
    ):
        self._batches = batches
        self._names_fn = names_fn
        self._cursor_fn = cursor_fn
        self.fingerprint = fingerprint
        self.cache_key = cache_key
        self.cache_scope = cache_scope
        # (cursor) -> Optional[ColumnarStream]: a delta scan of the same
        # app/filters from a prior scan's cursor (None: no delta path)
        self.delta_factory = None

    def __iter__(self):
        return iter(self._batches)

    @property
    def names(self) -> np.ndarray:
        """Id-indexed name array; valid once the iterator is exhausted."""
        return self._names_fn()

    @property
    def cursor(self):
        """Delta cursor covering exactly the rows this scan emitted;
        valid once the iterator is exhausted. None: no delta support."""
        return self._cursor_fn() if self._cursor_fn is not None else None

    @staticmethod
    def from_columnar(cols: ColumnarEvents, **kw) -> "ColumnarStream":
        """One-shot stream over a materialized scan (the generic
        fallback): entity codes keep their range, target codes shift past
        them, so the two sides share one code space."""
        e_names = np.asarray(cols.entity_names, object)
        t_names = np.asarray(cols.target_names, object)
        names = np.concatenate([e_names, t_names])
        ne = len(e_names)
        batches = (
            [(cols.entity_codes, cols.target_codes + np.int32(ne), cols.values)]
            if cols.n
            else []
        )
        return ColumnarStream(iter(batches), lambda: names, **kw)
