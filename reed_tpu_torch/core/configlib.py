"""Recursive dataclass config construction and dotted-path overrides, the
port's own copy of reed_tpu/core/configlib.py.

  --config recipe.json         # full or partial config tree as JSON
  --set optim.lr=3e-4          # dotted-path override, JSON-parsed values
  --set loss.enc_names='["dinov2","qwen2vl"]'

`build` constructs nested frozen dataclasses from plain dicts (lists become
tuples), raising on unknown keys; `merge` and `apply_overrides` rebuild the
frozen tree along a path; `snapshot` writes the resolved config next to the
checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, Optional, Sequence


def _resolve_hints(cls) -> Dict[str, Any]:
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp, value):
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return build(tp, value)
    if isinstance(value, list):
        # frozen configs hold tuples, never lists
        return tuple(value)
    if tp is float and isinstance(value, int):
        return float(value)
    return value


def build(cls, data: Optional[Dict[str, Any]] = None):
    """Construct dataclass `cls` from a plain dict, recursing into nested
    dataclass fields and coercing lists to tuples. Unknown keys are an error
    (catches recipe typos)."""
    data = data or {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    hints = _resolve_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: "
                       f"{sorted(unknown)}; valid: {sorted(names)}")
    return cls(**{f.name: _coerce(hints.get(f.name, Any), data[f.name])
                  for f in dataclasses.fields(cls) if f.name in data})


def merge(cfg, data: Dict[str, Any]):
    """A copy of `cfg` updated with `data` (recursive: dict values for
    nested dataclass fields merge into the existing sub-config)."""
    hints = _resolve_hints(type(cfg))
    names = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(cfg).__name__}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = merge(current, value)
        else:
            updates[key] = _coerce(hints.get(key, Any), value)
    return dataclasses.replace(cfg, **updates)


def parse_value(text: str):
    """JSON first (numbers, bools, lists, null), bare string fallback."""
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply `path.to.field=value` overrides to a frozen dataclass tree."""
    for item in overrides or ():
        if "=" not in item:
            raise ValueError(f"--set expects key=value, got {item!r}")
        path, _, raw = item.partition("=")
        *parents, name = path.strip().split(".")
        nested: Dict[str, Any] = {name: parse_value(raw)}
        for key in reversed(parents):
            nested = {key: nested}
        cfg = merge(cfg, nested)
    return cfg


def load_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def snapshot(cfg, directory: str, name: str = "config.json") -> str:
    """Write the resolved config next to the checkpoints; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(to_json(cfg))
    return path
