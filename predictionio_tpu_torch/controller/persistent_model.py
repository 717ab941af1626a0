"""PersistentModel: a model that persists itself, the counterpart of
``predictionio_tpu/controller/persistent_model.py`` (reference
controller/PersistentModel.scala:48-95, LocalFileSystemPersistentModel.scala:44-74,
workflow/PersistentModelManifest.scala:18).

A model class opts into managing its own persistence instead of being
kept as it is: ``Engine.make_serializable_models`` calls its ``save`` and
keeps a ``PersistentModelManifest`` in its place, and
``Engine.prepare_deploy`` resolves the manifest back to the class and calls
its ``load`` (reference SparkWorkflowUtils.getPersistentModel,
WorkflowUtils.scala:349-383).

Where the reference hands ``save`` and ``load`` a workflow context, the
port hands the ``torch.device`` the model runs on, as for every other
controller hook. ``LocalFileSystemPersistentModel`` writes the model's
numeric fields as one ``.npz`` under ``fs_basedir()/pmodels`` and reads
them back with ``allow_pickle=False``: the JAX package pickles the whole
object there, the port never writes or reads a pickle.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Any, Dict

import numpy as np
import torch

from predictionio_tpu_torch.controller.params import Params
from predictionio_tpu_torch.utils.fs import fs_basedir


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Kept in place of a model that saved itself: ``module.qualname`` of
    its class (reference workflow/PersistentModelManifest.scala:18)."""

    class_name: str


class PersistentModel:
    """Mixin: implement ``save``; provide a classmethod ``load`` (the
    reference's companion-object PersistentModelLoader)."""

    def save(self, id: str, params: Params, device: torch.device) -> bool:
        """Persist the model under the engine instance ``id``. Return False
        to keep the model as it is instead (reference
        PersistentModel.scala:78-82)."""
        raise NotImplementedError

    @classmethod
    def load(cls, id: str, params: Params, device: torch.device) -> "PersistentModel":
        raise NotImplementedError


def load_persistent_model(
    manifest: PersistentModelManifest, id: str, params: Params, device: torch.device
) -> Any:
    """Resolve the manifest's class and call its loader. The name is
    ``module.qualname``, and a qualname may hold dots (nested classes), so
    the longest importable prefix is the module and the rest is walked by
    ``getattr``."""
    parts = manifest.class_name.split(".")
    module = None
    split_at = 0
    for i in range(len(parts) - 1, 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:i]))
            split_at = i
            break
        except ImportError:
            continue
    if module is None:
        raise ImportError(
            f"cannot resolve persistent model class {manifest.class_name!r}"
        )
    cls: Any = module
    for part in parts[split_at:]:
        cls = getattr(cls, part)
    return cls.load(id, params, device)


def _local_model_path(id: str, cls: type) -> str:
    d = os.path.join(fs_basedir(), "pmodels")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{id}-{cls.__name__}.npz")


# the ``.npz`` entry naming the fields that were None
_NONE_FIELDS = "__none_fields__"


class LocalFileSystemPersistentModel(PersistentModel):
    """Saves a dataclass model's fields to the local filesystem as one
    ``.npz`` (reference LocalFileSystemPersistentModel.scala:44-74). Each
    field must be None, a number, a bool or a numeric array; anything else
    raises ``ValueError`` before a file is written. Fields named with a
    leading underscore are serving state (a device, a cache): they are not
    saved, and a loaded model has their defaults."""

    def save(self, id: str, params: Params, device: torch.device) -> bool:
        if not dataclasses.is_dataclass(self):
            raise TypeError(f"{type(self).__name__} is not a dataclass")
        arrays: Dict[str, np.ndarray] = {}
        none_fields = []
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            value = getattr(self, f.name)
            if value is None:
                none_fields.append(f.name)
                continue
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            a = np.asarray(value)
            if a.dtype.kind not in "biuf":
                raise ValueError(
                    f"{type(self).__name__}.{f.name} is not a number or a "
                    f"numeric array (dtype {a.dtype}): it cannot be saved "
                    "without a pickle"
                )
            arrays[f.name] = a
        arrays[_NONE_FIELDS] = np.asarray(none_fields, dtype=str)
        with open(_local_model_path(id, type(self)), "wb") as fh:
            np.savez(fh, **arrays)
        return True

    @classmethod
    def load(
        cls, id: str, params: Params, device: torch.device
    ) -> "LocalFileSystemPersistentModel":
        values: Dict[str, Any] = {}
        with np.load(_local_model_path(id, cls), allow_pickle=False) as z:
            for name in z.files:
                if name == _NONE_FIELDS:
                    values.update({n: None for n in z[name].tolist()})
                    continue
                a = z[name]
                values[name] = a.item() if a.ndim == 0 else a
        return cls(**values)
