"""The proto3 JSON mapping of the port's codec: what the JAX package's
`json_format.MessageToJson(msg, preserving_proto_field_name=True)` and
`json_format.Parse(text, msg)` do, for the message kinds that
`cmd/configtxlator.py`'s types reach.

- Field names as in the schema; `parse` also takes lowerCamelCase.
- Fields at their default are left out (oneof members and message fields
  are written whenever set); fields in field-number order.
- 64-bit integers as JSON strings, 32-bit ones and enums without names as
  numbers, bools as `true`/`false`.
- `bytes` as padded standard base64; `parse` takes the URL-safe alphabet
  too, with or without padding.
- Enums by name (`Field(..., enum={number: name})`), an unnamed value as
  its number; `parse` takes a name or a number.
- Maps as objects (keys as strings), with `indent=2` and `\\uXXXX` escapes
  for non-ASCII, as `json.dumps` writes them.
- `parse` refuses an unknown field, a key given twice, two members of a
  oneof, malformed JSON and values of the wrong type with `ParseError`;
  `null` leaves a field at its default.

Values nested in `bytes` fields stay base64: nothing deeper is decoded.
"""

from __future__ import annotations

import base64
import json

from fabric_tpu_torch.protos.wire import (
    BOOL,
    BYTES,
    ENUM,
    INT32,
    INT64,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    Message,
    _resolve,
)

__all__ = ["ParseError", "message_to_json", "message_to_dict", "parse"]

_RANGES = {INT32: (-(1 << 31), (1 << 31) - 1), UINT32: (0, (1 << 32) - 1),
           INT64: (-(1 << 63), (1 << 63) - 1), UINT64: (0, (1 << 64) - 1),
           ENUM: (-(1 << 31), (1 << 31) - 1)}


class ParseError(ValueError):
    """JSON that does not map onto the message (json_format.ParseError)."""


def _json_name(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


# -- message -> JSON ----------------------------------------------------------


def _scalar_to_json(kind: int, v, enum: dict | None):
    if kind == BYTES:
        return base64.b64encode(v).decode("utf-8")
    if kind in (INT64, UINT64):
        return str(v)
    if kind == ENUM:
        return (enum or {}).get(v, v)
    if kind == BOOL:
        return bool(v)
    return v


def _value_to_json(f, v):
    if f.kind == MESSAGE:
        return message_to_dict(v)
    return _scalar_to_json(f.kind, v, f.enum)


def message_to_dict(msg: Message) -> dict:
    """The JSON object of `msg` (json_format.MessageToDict with
    preserving_proto_field_name)."""
    out: dict = {}
    d = msg.__dict__
    for f in msg._fields:
        if f.name not in d:
            continue
        v = d[f.name]
        if f.key is not None:
            if not v:
                continue
            out[f.name] = {
                ("true" if k else "false") if isinstance(k, bool) else str(k):
                (message_to_dict(val) if f.value == MESSAGE
                 else _scalar_to_json(f.value, val, None))
                for k, val in v.items()}
        elif f.repeated:
            if v:
                out[f.name] = [_value_to_json(f, x) for x in v]
        elif msg.has(f.name):
            out[f.name] = _value_to_json(f, v)
    return out


def message_to_json(msg: Message, indent: int = 2) -> str:
    """json_format.MessageToJson(msg, preserving_proto_field_name=True)."""
    return json.dumps(message_to_dict(msg), indent=indent)


# -- JSON -> message ----------------------------------------------------------


def _no_duplicates(pairs):
    out = {}
    for name, value in pairs:
        if name in out:
            raise ParseError(f"Failed to load JSON: duplicate key {name}.")
        out[name] = value
    return out


def _integer(value, kind: int):
    if isinstance(value, bool):
        raise ParseError(
            f"Bool value {value} is not acceptable for integer field")
    if isinstance(value, float) and not value.is_integer():
        raise ParseError(f"Couldn't parse integer: {value}")
    if isinstance(value, str) and " " in value:
        raise ParseError(f'Couldn\'t parse integer: "{value}"')
    if not isinstance(value, (int, float, str)):
        raise ParseError(f"Couldn't parse integer: {value!r}")
    try:
        v = int(value)
    except ValueError:
        try:
            fv = float(value)
        except ValueError:
            raise ParseError(f"Couldn't parse integer: {value!r}") from None
        if not fv.is_integer():
            raise ParseError(
                f'Couldn\'t parse non-integer string: "{value}"') from None
        v = int(fv)
    lo, hi = _RANGES[kind]
    if not lo <= v <= hi:
        raise ParseError(f"Value out of range: {v}")
    return v


def _scalar_from_json(kind: int, value, enum: dict | None, path: str):
    try:
        if kind in (INT32, INT64, UINT32, UINT64):
            return _integer(value, kind)
        if kind == BOOL:
            if not isinstance(value, bool):
                raise ParseError("Expected true or false without quotes")
            return value
        if kind == STRING:
            if not isinstance(value, str):
                raise ParseError(f"{value!r} has type {type(value).__name__},"
                                 " but expected one of: str")
            return value
        if kind == BYTES:
            if not isinstance(value, str):
                raise ParseError(f"{value!r} is not a base64 string")
            raw = value.encode("utf-8")
            try:
                return base64.urlsafe_b64decode(raw + b"=" * (4 - len(raw) % 4))
            except ValueError as e:
                raise ParseError(f"Invalid base64: {e}") from e
        # ENUM: a name, else a number (open enums keep unknown numbers)
        names = {n: num for num, n in (enum or {}).items()}
        if isinstance(value, str) and value in names:
            return names[value]
        try:
            return _integer(value, ENUM)
        except ParseError:
            raise ParseError(f"Invalid enum value {value}") from None
    except ParseError as e:
        raise ParseError(f"{e} at {path}") from e


def _message_from_json(js, cls, path: str):
    if not isinstance(js, dict):
        raise ParseError(f"{js!r} is not a JSON object at {path}")
    msg = cls()
    by_json = {_json_name(f.name): f for f in cls._fields}
    oneofs: set = set()
    for name, value in js.items():
        f = by_json.get(name) or cls._by_name.get(name)
        if f is None:
            raise ParseError(
                f'Message type "{cls.__name__}" has no field named '
                f'"{name}" at "{path}".\n Available Fields(except extensions):'
                f' "{[_json_name(g.name) for g in cls._fields]}"')
        if f.oneof is not None and value is not None:
            if f.oneof in oneofs:
                raise ParseError(
                    f'Message type "{cls.__name__}" should not have '
                    f'multiple "{f.oneof}" oneof fields at "{path}".')
            oneofs.add(f.oneof)
        if value is None:
            continue  # null: the field stays at its default
        sub = f"{path}.{name}"
        if f.key is not None:
            if not isinstance(value, dict):
                raise ParseError(f"Map field {name} must be in a dict which "
                                 f"is {value} at {path}")
            entries = {}
            for k, val in value.items():
                if f.key == BOOL:
                    if k not in ("true", "false"):
                        raise ParseError(f'Expected "true" or "false", not {k}')
                    key = k == "true"
                else:
                    key = _scalar_from_json(f.key, k, None, sub)
                if f.value == MESSAGE:
                    entries[key] = _message_from_json(val, _resolve(f),
                                                      f"{sub}[{k}]")
                else:
                    entries[key] = _scalar_from_json(f.value, val, None,
                                                     f"{sub}[{k}]")
            msg._set(f, entries)
        elif f.repeated:
            if not isinstance(value, list):
                raise ParseError(f"repeated field {name} must be in [] which "
                                 f"is {value} at {path}")
            items = []
            for i, item in enumerate(value):
                if item is None:
                    raise ParseError("null is not allowed to be used as an "
                                     f"element in a repeated field at "
                                     f"{sub}[{i}]")
                items.append(
                    _message_from_json(item, _resolve(f), f"{sub}[{i}]")
                    if f.kind == MESSAGE
                    else _scalar_from_json(f.kind, item, f.enum, f"{sub}[{i}]"))
            msg._set(f, items)
        elif f.kind == MESSAGE:
            msg._set(f, _message_from_json(value, _resolve(f), sub))
        else:
            msg._set(f, _scalar_from_json(f.kind, value, f.enum, sub))
    return msg


def parse(text, cls):
    """json_format.Parse(text, cls()): the message, or ParseError."""
    if isinstance(text, (bytes, bytearray)):
        text = bytes(text).decode("utf-8")
    try:
        js = json.loads(text, object_pairs_hook=_no_duplicates)
    except ParseError:
        raise
    except Exception as e:
        raise ParseError(f"Failed to load JSON: {e}.") from e
    return _message_from_json(js, cls, cls.__name__)
