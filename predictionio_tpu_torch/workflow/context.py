"""WorkflowContext: what an evaluation hands its data source (the
counterpart of ``predictionio_tpu/workflow/context.py``).

It carries the device the workflow runs on (CUDA unless the CPU is asked
for; a given mesh's first device when no device is given), a ``mesh`` (the
reference's ``WorkflowContext.mesh`` :55: given, or built at first use over
every visible CUDA device, or the one CPU device when the CPU is asked for;
algorithms that train on a mesh train over it when it has several shards,
``controller/engine.training_target``, and a deployment builds its serving
mesh itself, ``tools/cli.serving_target``) and, in place of
the event store the port does not have yet (ROADMAP.md queue 1 item 3), the data a data source would read from it:
the event columns of each app, read where the reference calls
``PEventStore.find_columns``, and the aggregated entity properties of each
(app, entity type), read where it calls ``PEventStore.aggregate_properties``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.store import EventColumns
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.parallel.mesh import Mesh, default_mesh

PropertyMaps = Mapping[str, Mapping[str, Any]]  # entity id -> property -> value


class WorkflowContext:
    def __init__(
        self,
        device: DeviceLike = None,
        event_columns: Optional[Mapping[str, EventColumns]] = None,
        properties: Optional[Mapping[Tuple[str, str], PropertyMaps]] = None,
        mesh: Optional[Mesh] = None,
    ):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self._mesh = mesh
        self._columns = dict(event_columns or {})
        self._properties = dict(properties or {})

    @property
    def mesh(self) -> Mesh:
        """The workflow's mesh: the one given, else a 1-D ``data`` mesh
        over every visible CUDA device, or over ``device`` when it is the
        CPU."""
        if self._mesh is None:
            self._mesh = (
                default_mesh(devices=[self.device]) if self.device.type == "cpu"
                else default_mesh()
            )
        return self._mesh

    def find_columns(self, app_name: str) -> EventColumns:
        """The event columns of ``app_name``, as the caller supplied them."""
        if app_name not in self._columns:
            raise KeyError(
                f"no event columns for app {app_name!r}: the port has no event "
                "store yet (ROADMAP.md queue 1 item 3), so pass them as "
                "WorkflowContext(event_columns={app_name: EventColumns(...)})"
            )
        return self._columns[app_name]

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, Mapping[str, Any]]:
        """The aggregated properties of ``entity_type`` in ``app_name``, as
        the caller supplied them and in the caller's order, less the
        entities missing a ``required`` property (as the reference's
        storage drops them)."""
        if channel_name is not None:
            raise NotImplementedError(
                f"channel {channel_name!r}: channels come with the event store "
                "(ROADMAP.md queue 1 item 3)"
            )
        key = (app_name, entity_type)
        if key not in self._properties:
            raise KeyError(
                f"no properties of {entity_type!r} entities for app {app_name!r}: "
                "the port has no event store yet (ROADMAP.md queue 1 item 3), so "
                "pass them as WorkflowContext(properties={(app_name, entity_type): "
                "{entity_id: {property: value}}})"
            )
        req = list(required or ())
        return {
            eid: props for eid, props in self._properties[key].items()
            if all(r in props for r in req)
        }
