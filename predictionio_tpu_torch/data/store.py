"""Event columns: the port's copy of ``EventColumns`` from
``predictionio_tpu/data/store.py``, the column form of an event scan
(``PEventStore.find_columns``) that a data source reads.

The port has no event store yet (ROADMAP.md queue 1 item 3): a caller
builds the columns of an app (ids indexed in sorted order, as
``find_columns`` indexes them) and hands them to the workflow context
(``workflow/context.py``), where a data source reads them in place of the
store's scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap


@dataclasses.dataclass
class EventColumns:
    """Column-oriented (entity, target, value) triples with dense
    indexes."""

    entity_index: BiMap  # entityId -> dense int
    target_index: BiMap  # targetEntityId -> dense int
    entity_idx: np.ndarray  # [n] int32
    target_idx: np.ndarray  # [n] int32
    values: np.ndarray  # [n] float32

    @property
    def n(self) -> int:
        return len(self.values)
