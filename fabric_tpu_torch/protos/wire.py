"""A protobuf wire codec without the `protobuf` package.

Messages are declared as classes with a `FIELDS` tuple of `Field`s (see
the sibling schema modules).  `Message.decode(raw)` parses proto3 wire
format and `msg.encode()` writes it, with the acceptance rules of the
`upb` decoder that the JAX package's `_pb2` modules run on, because the
validator's flags depend on which bytes fail to parse:

- a truncated varint, length, fixed-width value or group, a varint of
  more than 10 bytes, a tag of more than 5 bytes, field number 0 or
  above 2^29 - 1, wire types 6 and 7, and an end-group tag with no
  matching start raise `DecodeError`;
- a `string` field that is not valid UTF-8 raises;
- every submessage is parsed as it is met (a bad nested message fails
  the outer decode);
- a known field met with another wire type than its own, and any unknown
  field (groups included), is kept as raw bytes and written back after
  the known fields, in the order met;
- a scalar met twice keeps the last value, a message met twice merges,
  repeated numeric fields accept packed and unpacked runs, 10-byte
  negative varints truncate to the field's width;
- a map entry may lack its key or value (they take their defaults); an
  entry that carries any other field is kept whole, re-encoded, among the
  parent's unknown fields, as upb does.

`encode` writes known fields in field-number order: proto3 scalars only
when they differ from their default (oneof members and fields declared
with presence whenever set), messages when set, repeated numerics
packed, map entries with both key and value.  A message decoded from
bytes in that canonical order encodes back to the same bytes.

Fields absent from an instance read as their defaults: 0, "", b"",
False, an empty tuple (repeated), an empty mapping (maps) or a fresh
empty message, which is not stored.  Build messages with keyword
arguments; a field is present once assigned.
"""

from __future__ import annotations

import types

__all__ = ["DecodeError", "Field", "Message", "INT32", "INT64", "UINT32",
           "UINT64", "BOOL", "ENUM", "STRING", "BYTES", "MESSAGE"]

INT32, INT64, UINT32, UINT64, BOOL, ENUM, STRING, BYTES, MESSAGE = range(9)
_NUMERIC = (INT32, INT64, UINT32, UINT64, BOOL, ENUM)
_DEFAULTS = {INT32: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: False, ENUM: 0,
             STRING: "", BYTES: b""}
_MASK64 = (1 << 64) - 1
_MAX_FIELD = (1 << 29) - 1
_EMPTY_MAP = types.MappingProxyType({})


class DecodeError(ValueError):
    """Bytes that the protobuf decoder rejects."""


class Field:
    """One field of a message schema.

    `kind` is one of INT32 ... MESSAGE; `msg` names the message class of
    a MESSAGE field, in the declaring module or as `module.Class`
    (resolved lazily, so schemas may refer forward); a
    map field has `key` (a scalar kind) and a `value` kind, with `msg`
    for message values.  `oneof` names the field's oneof group;
    `presence` marks a proto3 scalar whose zero value is still written
    once set.  `enum` gives an ENUM field's value names ({number: name}),
    which only the JSON mapping (`protos/jsonpb.py`) reads."""

    __slots__ = ("num", "name", "kind", "repeated", "msg", "oneof",
                 "presence", "key", "value", "enum", "_cls", "_entry")

    def __init__(self, num: int, name: str, kind: int, msg: str | None = None,
                 *, repeated: bool = False, oneof: str | None = None,
                 presence: bool = False, key: int | None = None,
                 value: int | None = None, enum: dict | None = None):
        self.num = num
        self.name = name
        self.kind = kind
        self.msg = msg
        self.repeated = repeated or key is not None
        self.oneof = oneof
        self.presence = presence or oneof is not None
        self.key = key
        self.value = value
        self.enum = enum
        self._cls = None
        self._entry = None

    @property
    def wire(self) -> int:
        return 0 if self.kind in _NUMERIC and self.key is None else 2


# ---------------------------------------------------------------------------
# Primitive readers and writers.
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """Read a varint of at most 10 bytes; bits past 64 are dropped."""
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _tag(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """Read a tag: a varint of at most 5 bytes with a legal field number."""
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated tag")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
        if shift >= 35:
            raise DecodeError("tag longer than 5 bytes")
    num = result >> 3
    if num == 0 or num > _MAX_FIELD:
        raise DecodeError(f"illegal field number {num}")
    return result, pos


def _skip(buf: bytes, pos: int, end: int, tag: int) -> int:
    """Skip the value of an unknown field; returns the position after it."""
    wt = tag & 7
    if wt == 0:
        return _varint(buf, pos, end)[1]
    if wt == 2:
        ln, pos = _varint(buf, pos, end)
        if ln > end - pos:
            raise DecodeError("truncated length-delimited field")
        return pos + ln
    if wt == 1:
        if end - pos < 8:
            raise DecodeError("truncated fixed64")
        return pos + 8
    if wt == 5:
        if end - pos < 4:
            raise DecodeError("truncated fixed32")
        return pos + 4
    if wt == 3:
        num = tag >> 3
        while True:
            inner, pos = _tag(buf, pos, end)
            if inner & 7 == 4:
                if inner >> 3 != num:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, inner)
    raise DecodeError(f"unexpected wire type {wt}")


def _put_varint(out: bytearray, v: int) -> None:
    v &= _MASK64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _scalar(kind: int, v: int):
    if kind == INT32 or kind == ENUM:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    if kind == INT64:
        return v - (1 << 64) if v >= 1 << 63 else v
    if kind == UINT32:
        return v & 0xFFFFFFFF
    if kind == BOOL:
        return v != 0
    return v


def _put_scalar(out: bytearray, kind: int, v) -> None:
    if kind == STRING:
        v = v.encode()
    if kind in (STRING, BYTES):
        _put_varint(out, len(v))
        out += v
    elif kind == BOOL:
        out.append(1 if v else 0)
    elif kind == UINT32:
        _put_varint(out, v & 0xFFFFFFFF)
    else:
        _put_varint(out, v)


def _put_len(out: bytearray, tag: int, body) -> None:
    _put_varint(out, tag)
    _put_varint(out, len(body))
    out += body


# ---------------------------------------------------------------------------
# Messages.
# ---------------------------------------------------------------------------


class Message:
    """Base of every schema class (see the module docstring)."""

    FIELDS: tuple = ()
    _fields: tuple = ()
    _by_num: dict = {}
    _by_name: dict = {}
    _msg_fields: frozenset = frozenset()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fields = tuple(sorted(cls.FIELDS, key=lambda f: f.num))
        cls._fields = fields
        cls._by_num = {f.num: f for f in fields}
        cls._by_name = {f.name: f for f in fields}
        cls._msg_fields = frozenset(
            f.name for f in fields if f.kind == MESSAGE and not f.repeated)
        for f in fields:
            if f.msg is not None and "." not in f.msg:
                f.msg = f"{cls.__module__}.{f.msg}"
            if f.key is not None:
                setattr(cls, f.name, _EMPTY_MAP)
            elif f.repeated:
                setattr(cls, f.name, ())
            elif f.kind != MESSAGE:
                setattr(cls, f.name, _DEFAULTS[f.kind])

    def __init__(self, **kw):
        for name, v in kw.items():
            f = self._by_name.get(name)
            if f is None:
                raise TypeError(f"{type(self).__name__} has no field {name!r}")
            if f.key is not None:
                v = dict(v)
            elif f.repeated:
                v = list(v)
            self._set(f, v)

    def _set(self, f: Field, v) -> None:
        d = self.__dict__
        if f.oneof is not None:
            for other in self._fields:
                if other.oneof == f.oneof and other is not f:
                    d.pop(other.name, None)
        d[f.name] = v

    def __getattr__(self, name):
        # reached only for fields absent from the instance: message
        # fields read as a fresh empty message (not stored)
        if name in type(self)._msg_fields:
            return _resolve(type(self)._by_name[name])()
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    # -- presence ---------------------------------------------------------

    def has(self, name: str) -> bool:
        """Whether the field would be written by `encode` (a message
        field: whether it was set)."""
        f = self._by_name[name]
        if name not in self.__dict__:
            return False
        if f.kind == MESSAGE or f.presence:
            return True
        v = self.__dict__[name]
        return bool(v)

    def which(self, oneof: str) -> str | None:
        """The name of the set member of a oneof group, or None."""
        for f in self._fields:
            if f.oneof == oneof and f.name in self.__dict__:
                return f.name
        return None

    # -- decode -----------------------------------------------------------

    @classmethod
    def decode(cls, raw) -> "Message":
        buf = bytes(raw)
        msg = cls()
        msg._merge(buf, 0, len(buf))
        return msg

    def _merge(self, buf: bytes, pos: int, end: int) -> None:
        d = self.__dict__
        by_num = self._by_num
        while pos < end:
            start = pos
            tag, pos = _tag(buf, pos, end)
            wt = tag & 7
            if wt == 4:
                raise DecodeError("end-group tag outside a group")
            f = by_num.get(tag >> 3)
            if f is not None:
                if wt == f.wire:
                    pos = self._field(f, buf, pos, end)
                    continue
                if wt == 2 and f.repeated and f.kind in _NUMERIC \
                        and f.key is None:
                    pos = self._packed(f, buf, pos, end)
                    continue
            pos = _skip(buf, pos, end, tag)
            d.setdefault("_unknown", []).append(buf[start:pos])

    def _field(self, f: Field, buf: bytes, pos: int, end: int) -> int:
        d = self.__dict__
        if f.kind in _NUMERIC and f.key is None:
            v, pos = _varint(buf, pos, end)
            v = _scalar(f.kind, v)
            if f.repeated:
                d.setdefault(f.name, []).append(v)
            else:
                self._set(f, v)
            return pos
        ln, pos = _varint(buf, pos, end)
        if ln > end - pos:
            raise DecodeError("truncated length-delimited field")
        stop = pos + ln
        if f.key is not None:
            self._map_entry(f, buf, pos, stop)
        elif f.kind == MESSAGE:
            if f.repeated:
                sub = _resolve(f)()
                sub._merge(buf, pos, stop)
                d.setdefault(f.name, []).append(sub)
            else:
                sub = d.get(f.name)
                if sub is None:
                    sub = _resolve(f)()
                sub._merge(buf, pos, stop)
                self._set(f, sub)
        else:
            v = buf[pos:stop]
            if f.kind == STRING:
                try:
                    v = v.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"field {f.name!r}: invalid UTF-8") from e
            if f.repeated:
                d.setdefault(f.name, []).append(v)
            else:
                self._set(f, v)
        return stop

    def _packed(self, f: Field, buf: bytes, pos: int, end: int) -> int:
        ln, pos = _varint(buf, pos, end)
        if ln > end - pos:
            raise DecodeError("truncated packed field")
        stop = pos + ln
        out = self.__dict__.setdefault(f.name, [])
        while pos < stop:
            v, pos = _varint(buf, pos, stop)
            out.append(_scalar(f.kind, v))
        return stop

    def _map_entry(self, f: Field, buf: bytes, pos: int, stop: int) -> None:
        entry = _entry_class(f)()
        entry._merge(buf, pos, stop)
        d = self.__dict__
        if "_unknown" in entry.__dict__:
            tag = bytearray()
            _put_varint(tag, (f.num << 3) | 2)
            body = entry.encode()
            _put_varint(tag, len(body))
            d.setdefault("_unknown", []).append(bytes(tag) + body)
            return
        if "value" in entry.__dict__:
            value = entry.value
        elif f.value == MESSAGE:
            value = _resolve(f)()
        else:
            value = _DEFAULTS[f.value]
        d.setdefault(f.name, {})[entry.key] = value

    # -- encode -----------------------------------------------------------

    def encode(self, deterministic: bool = False) -> bytes:
        """The wire bytes; map entries in insertion order, or, with
        `deterministic`, sorted by key at every depth (protobuf's
        `SerializeToString(deterministic=True)`)."""
        out = bytearray()
        d = self.__dict__
        for f in self._fields:
            if f.name not in d:
                continue
            v = d[f.name]
            tag = (f.num << 3) | f.wire
            if f.key is not None:
                entries = sorted(v.items()) if deterministic else v.items()
                for k, val in entries:
                    body = bytearray()
                    _put_varint(body, (1 << 3) | (0 if f.key in _NUMERIC else 2))
                    _put_scalar(body, f.key, k)
                    if f.value == MESSAGE:
                        _put_len(body, (2 << 3) | 2, val.encode(deterministic))
                    else:
                        _put_varint(body, (2 << 3) | (0 if f.value in _NUMERIC else 2))
                        _put_scalar(body, f.value, val)
                    _put_len(out, (f.num << 3) | 2, body)
            elif f.repeated:
                if not v:
                    continue
                if f.kind in _NUMERIC:
                    body = bytearray()
                    for x in v:
                        _put_scalar(body, f.kind, x)
                    _put_len(out, (f.num << 3) | 2, body)
                elif f.kind == MESSAGE:
                    for x in v:
                        _put_len(out, tag, x.encode(deterministic))
                else:
                    for x in v:
                        _put_varint(out, tag)
                        _put_scalar(out, f.kind, x)
            elif f.kind == MESSAGE:
                _put_len(out, tag, v.encode(deterministic))
            else:
                if not f.presence and v == _DEFAULTS[f.kind]:
                    continue
                _put_varint(out, tag)
                _put_scalar(out, f.kind, v)
        for raw in d.get("_unknown", ()):
            out += raw
        return bytes(out)

    # -- comparison and display -------------------------------------------

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self.encode() == other.encode()

    __hash__ = None

    def __repr__(self):
        parts = [f"{k}={v!r}" for k, v in self.__dict__.items()
                 if not k.startswith("_")]
        return f"{type(self).__name__}({', '.join(parts)})"


def _resolve(f: Field):
    cls = f._cls
    if cls is None:
        import importlib

        module, _, name = f.msg.rpartition(".")
        cls = getattr(importlib.import_module(module), name)
        f._cls = cls
    return cls


def _entry_class(f: Field):
    cls = f._entry
    if cls is None:
        value = Field(2, "value", f.value, f.msg)
        if f.value == MESSAGE:
            value._cls = _resolve(f)
        cls = type(f"{f.name}Entry", (Message,), {
            "FIELDS": (Field(1, "key", f.key), value)})
        f._entry = cls
    return cls
