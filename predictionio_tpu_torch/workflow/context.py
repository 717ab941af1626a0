"""WorkflowContext: what an evaluation hands its data source (the
counterpart of ``predictionio_tpu/workflow/context.py``).

It carries the device the workflow runs on (CUDA unless the CPU is asked
for) and, in place of the event store the port does not have yet
(ROADMAP.md queue 1 item 3), the event columns of each app, which a data
source reads where the reference's calls ``PEventStore.find_columns``.
"""

from __future__ import annotations

from typing import Mapping, Optional

from predictionio_tpu_torch.data.store import EventColumns
from predictionio_tpu_torch.device import DeviceLike, resolve_device


class WorkflowContext:
    def __init__(
        self,
        device: DeviceLike = None,
        event_columns: Optional[Mapping[str, EventColumns]] = None,
    ):
        self.device = resolve_device(device)
        self._columns = dict(event_columns or {})

    def find_columns(self, app_name: str) -> EventColumns:
        """The event columns of ``app_name``, as the caller supplied them."""
        if app_name not in self._columns:
            raise KeyError(
                f"no event columns for app {app_name!r}: the port has no event "
                "store yet (ROADMAP.md queue 1 item 3), so pass them as "
                "WorkflowContext(event_columns={app_name: EventColumns(...)})"
            )
        return self._columns[app_name]
