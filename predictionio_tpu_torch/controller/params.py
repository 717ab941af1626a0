"""Params: typed controller parameters constructed from JSON.

The port's copy of ``predictionio_tpu/controller/params.py``.

Capability parity with the reference's Params marker trait
(core/src/main/scala/io/prediction/controller/Params.scala:22-31) and the
JSON->Params extraction machinery (workflow/JsonExtractor.scala:61-110,
WorkflowUtils.extractParams:131-161). The reference reflects on Scala
case-class constructors; here Params subclasses are Python dataclasses and
extraction maps JSON object fields onto dataclass fields with type-aware
coercion (nested dataclasses, Optional, lists, tuples).
"""

from __future__ import annotations

import dataclasses
import types as _types
import typing
from typing import Any, Dict, Mapping, Optional, Type, TypeVar

T = TypeVar("T", bound="Params")


@dataclasses.dataclass(frozen=True)
class Params:
    """Base class for all controller parameters. Subclass as a (frozen or
    not) dataclass; fields define the JSON schema, exactly as the
    reference's case-class constructor args do."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """No parameters (reference EmptyParams, Params.scala:29)."""


class ParamsError(ValueError):
    """Raised when JSON cannot be mapped onto a Params class."""


def _coerce(value: Any, annot: Any) -> Any:
    """Best-effort coercion of a JSON value to the annotated field type."""
    if annot is Any or annot is dataclasses.MISSING or annot is None:
        return value
    origin = typing.get_origin(annot)
    if origin is typing.Union or origin is _types.UnionType:  # Optional / X | Y
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        if value is None:
            return None
        if len(args) == 1:
            return _coerce(value, args[0])
        return value
    if origin in (list, typing.List):
        (item,) = typing.get_args(annot) or (Any,)
        return [_coerce(v, item) for v in value]
    if origin in (tuple, typing.Tuple):
        args = typing.get_args(annot)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(value)
    if origin in (dict, typing.Dict):
        kv = typing.get_args(annot)
        if len(kv) == 2:
            return {k: _coerce(v, kv[1]) for k, v in value.items()}
        return dict(value)
    if isinstance(annot, type):
        if dataclasses.is_dataclass(annot) and isinstance(value, Mapping):
            return params_from_json(value, annot)
        if annot is float and isinstance(value, int):
            return float(value)
        if annot is int and isinstance(value, float) and value.is_integer():
            return int(value)
        if annot is set:
            return set(value)
    return value


def params_from_json(obj: Optional[Mapping[str, Any]], params_cls: Type[T]) -> T:
    """Instantiate a Params dataclass from a JSON object.

    Unknown fields raise (the reference's json4s extraction is strict in
    the same way for missing required fields; unknown-field rejection is a
    deliberate tightening to catch engine.json typos early). Missing fields
    fall back to dataclass defaults; a missing non-defaulted field raises.
    """
    obj = dict(obj or {})
    if not dataclasses.is_dataclass(params_cls):
        raise ParamsError(
            f"{params_cls.__name__} must be a dataclass to be JSON-constructed"
        )
    hints = typing.get_type_hints(params_cls)
    fields = {f.name: f for f in dataclasses.fields(params_cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise ParamsError(
            f"unknown parameter(s) {sorted(unknown)} for {params_cls.__name__}; "
            f"expected a subset of {sorted(fields)}"
        )
    kwargs: Dict[str, Any] = {}
    for name, f in fields.items():
        if name in obj:
            kwargs[name] = _coerce(obj[name], hints.get(name, Any))
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
        ):
            raise ParamsError(
                f"missing required parameter {name!r} for {params_cls.__name__}"
            )
    try:
        return params_cls(**kwargs)
    except TypeError as e:
        raise ParamsError(str(e)) from e


def params_to_json(params: Params) -> Dict[str, Any]:
    """Serialize a Params dataclass to a JSON-compatible dict
    (reference JsonExtractor.paramToJson:83-110). A Params subclass may
    override ``to_json()`` to control its wire form (e.g. the raw-dict
    fallback wrapper must round-trip transparently)."""
    custom = getattr(params, "to_json", None)
    if callable(custom):
        return custom()
    if not dataclasses.is_dataclass(params):
        raise ParamsError(f"{type(params).__name__} is not a dataclass")
    out = dataclasses.asdict(params)

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, set):
            return sorted(clean(x) for x in v)
        return v

    return clean(out)
