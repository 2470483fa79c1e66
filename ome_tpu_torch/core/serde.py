"""Dataclass <-> plain-dict serialization with k8s-style camelCase keys
(port of ome_tpu/core/serde.py).

Kubernetes API types are Go structs with JSON tags; here the same role
is played by Python dataclasses and this serde layer, which converts
snake_case field names to camelCase and back, drops None/empty values on
output (like `omitempty`), and recurses through nested dataclasses,
lists, dicts and enums.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import typing
from typing import Any, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


def camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p[:1].upper() + p[1:] for p in parts[1:])


def _json_name(f: dataclasses.Field) -> str:
    return f.metadata.get("json", camel(f.name))


@functools.lru_cache(maxsize=None)
def _ser_plan(tp: type):
    """(field_name, json_key) per serializable field, computed once
    per class — fields()/metadata lookups per instance add up on
    deepcopy-heavy paths (catalog selection)."""
    return tuple((f.name, _json_name(f))
                 for f in dataclasses.fields(tp)
                 if f.metadata.get("serialize", True))


@functools.lru_cache(maxsize=None)
def _deser_plan(tp: type):
    """(field_name, json_key, resolved_type) per field.
    typing.get_type_hints() re-evaluates every annotation string on
    EVERY call; caching the resolved hints per class is the whole
    win (~25x on deepcopy_resource)."""
    hints = typing.get_type_hints(tp)
    return tuple((f.name, _json_name(f), hints[f.name])
                 for f in dataclasses.fields(tp))


def to_dict(obj: Any, keep_empty: bool = False) -> Any:
    """Serialize a dataclass tree to plain dicts (camelCase keys, omitempty)."""
    if obj is None:
        return None
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for name, key in _ser_plan(type(obj)):
            raw = getattr(obj, name)
            v = to_dict(raw, keep_empty)
            if v is None and not keep_empty:
                continue
            # Go omitempty semantics: a present-but-empty STRUCT is kept
            # (`engine: {}` is a meaningful component declaration on the
            # wire); empty lists/maps/strings are dropped
            if v in ({}, []) and not keep_empty \
                    and not dataclasses.is_dataclass(raw):
                continue
            out[key] = v
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v, keep_empty) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v, keep_empty) for v in obj]
    return obj


def _strip_optional(tp: Any) -> Any:
    if get_origin(tp) is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_dict(cls: Type[T], data: Any) -> T:
    """Deserialize plain dicts (camelCase keys) into dataclass `cls`."""
    return _from_value(cls, data)


def _from_value(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    tp = _strip_optional(tp)
    if isinstance(tp, str):  # forward reference left unresolved
        raise TypeError(f"unresolved forward reference {tp!r}")
    origin = get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp) or (Any,)
        return [_from_value(item_tp, v) for v in data]
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _from_value(val_tp, v) for k, v in data.items()}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if dataclasses.is_dataclass(tp):
        kwargs = {}
        for name, key, ftp in _deser_plan(tp):
            if key in data:
                kwargs[name] = _from_value(ftp, data[key])
        return tp(**kwargs)
    if tp in (Any, object) or origin is not None:
        return data
    return data


def deepcopy_resource(obj: T) -> T:
    """DeepCopy equivalent (zz_generated.deepcopy.go in the reference)."""
    if obj is None:
        return None
    return from_dict(type(obj), to_dict(obj, keep_empty=True))
