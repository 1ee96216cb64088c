"""A reader for the subset of YAML that the repository's configuration
files use (`sampleconfig/core.yaml`, `sampleconfig/orderer.yaml`, a
network's `crypto-config.yaml` and `configtx.yaml`, an MSP folder's
`config.yaml`), where the JAX package calls `yaml.safe_load`.

The subset:

- block mappings and block sequences (a sequence may sit at its key's
  indentation), an entry `- key: value` opening a mapping;
- flow mappings and flow sequences on one line, nested (`[{Count: 1}]`,
  `[32, 128]`, `[]`, `{}`);
- comments, on a line of their own or after a value;
- single- and double-quoted scalars on one line (`""`);
- plain scalars, typed as `yaml.safe_load` types them (YAML 1.1):
  true/false/yes/no/on/off in their three spellings give a bool, ~ /
  null / nothing gives None, decimal integers an int, decimal floats a
  float, everything else (`16 MB`, `500ms`, `1h`, `127.0.0.1:7050`) a
  string.

Anything else raises `ValueError` naming its line, rather than being
read some way that could differ from `yaml.safe_load`: anchors, aliases,
tags, block scalars, document markers, directives, complex keys,
multi-line scalars and flow collections, duplicate keys, tabs in an
indentation, and plain scalars that YAML 1.1 would read as a timestamp,
a sexagesimal, octal, hexadecimal or binary number, a number with
underscores, infinity or NaN.
"""

from __future__ import annotations

import re

_BOOLS = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                     "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                     "Off", "OFF"), False),
}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9]*\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9]*(?:[eE][-+][0-9]+)?")
# plain scalars YAML 1.1 would type in ways outside the subset
_OUTSIDE = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"  # bin, oct, hex
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"  # sexagesimal
    r"|[-+]?[0-9][0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?"  # underscores
    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*"  # timestamp
    r"|<<|=")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that may not start a plain scalar in the subset
_INDICATORS = "&*!|>%@`'\"?"


class _Line:
    __slots__ = ("indent", "text", "num")

    def __init__(self, indent: int, text: str, num: int):
        self.indent = indent
        self.text = text
        self.num = num


def _fail(num: int, why: str):
    raise ValueError(f"YAML line {num}: {why} (outside the subset this "
                     "reader takes)")


def scalar(text: str, num: int = 0):
    """A plain scalar typed as `yaml.safe_load` types it."""
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _OUTSIDE.fullmatch(text):
        _fail(num, f"plain scalar {text!r} has a YAML 1.1 type")
    return text


def _strip_comment(raw: str, num: int) -> str:
    """The line without its comment (a '#' at the start or after a blank,
    outside quotes)."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or raw[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        i += 1
    if quote is not None:
        _fail(num, "a quoted scalar spans lines")
    return raw.rstrip()


def _lines(doc: str) -> list[_Line]:
    out = []
    for num, raw in enumerate(doc.splitlines(), 1):
        body = raw.lstrip(" ")
        text = _strip_comment(body, num)
        if not text:
            continue
        if text.startswith("\t"):
            _fail(num, "a tab in the indentation")
        if text.startswith(("---", "...", "%")):
            _fail(num, "a document marker or directive")
        out.append(_Line(len(raw) - len(body), text, num))
    return out


def _quoted(s: str, pos: int, num: int) -> tuple[str, int]:
    """The quoted scalar starting at s[pos]; (value, position after)."""
    q = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = s[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                width = _HEX_ESCAPES.get(e)
                digits = s[i + 2:i + 2 + (width or 0)]
                if width is None or len(digits) != width or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    _fail(num, f"escape \\{e} in a double-quoted scalar")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            out.append(c)
        i += 1
    _fail(num, "a quoted scalar spans lines")


class _Flow:
    """One line's flow collection or scalar."""

    def __init__(self, s: str, num: int):
        self.s = s
        self.num = num
        self.pos = 0

    def _blank(self) -> None:
        while self.pos < len(self.s) and self.s[self.pos] == " ":
            self.pos += 1

    def _peek(self) -> str:
        return self.s[self.pos:self.pos + 1]

    def node(self):
        self._blank()
        c = self._peek()
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            v, self.pos = _quoted(self.s, self.pos, self.num)
            return v
        return self._plain()

    def _plain(self):
        start = self.pos
        s = self.s
        c = s[start:start + 1]
        if c in _INDICATORS or (c == "-" and s[start + 1:start + 2] in (
                "", " ", ",", "]", "}")):
            _fail(self.num, f"a node starting with {c!r}")
        while self.pos < len(s):
            c = s[self.pos]
            if c in ",[]{}?":
                break
            if c == ":" and s[self.pos + 1:self.pos + 2] in ("", " ", ",",
                                                              "]", "}"):
                break
            self.pos += 1
        text = s[start:self.pos].rstrip()
        if self.pos < len(s) and s[self.pos] in "?[{":
            _fail(self.num, f"{s[self.pos]!r} inside a plain scalar")
        return scalar(text, self.num)

    def _seq(self) -> list:
        self.pos += 1
        out = []
        while True:
            self._blank()
            if self._peek() == "]":
                self.pos += 1
                return out
            if not self._peek():
                _fail(self.num, "a flow sequence spans lines")
            out.append(self.node())
            self._blank()
            c = self._peek()
            if c == ":":
                _fail(self.num, "a mapping inside a flow sequence")
            if c == ",":
                self.pos += 1
            elif c != "]":
                _fail(self.num, "a flow sequence spans lines or is "
                      "malformed")

    def _map(self) -> dict:
        self.pos += 1
        out: dict = {}
        while True:
            self._blank()
            if self._peek() == "}":
                self.pos += 1
                return out
            if not self._peek():
                _fail(self.num, "a flow mapping spans lines")
            if self._peek() in "[{":
                _fail(self.num, "a collection as a key")
            key = self.node()
            self._blank()
            if self._peek() != ":":
                _fail(self.num, "a flow mapping entry without ': '")
            self.pos += 1
            self._blank()
            value = None if self._peek() in (",", "}") else self.node()
            _put(out, key, value, self.num)
            self._blank()
            c = self._peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                _fail(self.num, "a flow mapping spans lines or is "
                      "malformed")


def _put(d: dict, key, value, num: int) -> None:
    if isinstance(key, (list, dict)):
        _fail(num, "a collection as a key")
    if key in d:
        _fail(num, f"duplicate key {key!r}")
    d[key] = value


def _inline(text: str, num: int):
    """A value written on its key's (or its dash's) line."""
    if text[0] in "&*!|>%@`?":
        _fail(num, f"a node starting with {text[0]!r}")
    if text[0] not in "[{'\"":
        if ": " in text or text.endswith(":"):
            _fail(num, "a mapping value inside a plain scalar")
        if text.startswith("- ") or text == "-":
            _fail(num, "a sequence entry inside a value")
        return scalar(text, num)
    f = _Flow(text, num)
    value = f.node()
    f._blank()
    if f.pos != len(text):
        _fail(num, f"text after a value: {text[f.pos:]!r}")
    return value


def _split_key(text: str, num: int):
    """(key, rest after ': ') of a block mapping line, or None when the
    line is no mapping entry."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, num)
        rest = text[end:]
        if not (rest.startswith(": ") or rest == ":"):
            if rest.lstrip().startswith(":"):
                _fail(num, "a blank between a key and its ':'")
            return None
        return key, rest[1:].strip()
    if text[0] in "[{":
        return None  # a flow collection: a value, never a key here
    if text[0] == "?":
        _fail(num, "a complex key")
    m = re.search(r": |:$", text)
    if m is None:
        return None
    key_text = text[:m.start()].rstrip()
    if key_text[:1] in _INDICATORS or key_text.startswith("- "):
        _fail(num, f"a key starting with {key_text[:1]!r}")
    return scalar(key_text, num), text[m.end():].strip()


class _Parser:
    def __init__(self, doc: str):
        self.lines = _lines(doc)

    def _at(self, i: int) -> _Line | None:
        return self.lines[i] if i < len(self.lines) else None

    def node(self, i: int):
        line = self.lines[i]
        if line.text == "-" or line.text.startswith("- "):
            return self.seq(i, line.indent)
        if _split_key(line.text, line.num) is not None:
            return self.map(i, line.indent)
        value = _inline(line.text, line.num)
        nxt = self._at(i + 1)
        if nxt is not None and nxt.indent > line.indent:
            _fail(nxt.num, "a multi-line scalar")
        return value, i + 1

    def _nested(self, i: int, indent: int, seq_at_indent: bool):
        """The block node that follows an entry with nothing after its
        ':' or '-': a deeper block, a sequence at the key's indentation
        (`seq_at_indent`), or None."""
        nxt = self._at(i)
        if nxt is not None and nxt.indent > indent:
            return self.node(i)
        if (seq_at_indent and nxt is not None and nxt.indent == indent
                and (nxt.text == "-" or nxt.text.startswith("- "))):
            return self.seq(i, indent)
        return None, i

    def seq(self, i: int, indent: int):
        out = []
        while True:
            line = self._at(i)
            if line is None or line.indent < indent:
                return out, i
            if line.indent > indent:
                _fail(line.num, "bad indentation in a sequence")
            if not (line.text == "-" or line.text.startswith("- ")):
                return out, i
            rest = line.text[1:].lstrip(" ")
            if not rest:
                value, i = self._nested(i + 1, indent, False)
            else:
                col = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(col, rest, line.num)
                value, i = self.node(i)
            out.append(value)

    def map(self, i: int, indent: int):
        out: dict = {}
        while True:
            line = self._at(i)
            if line is None or line.indent < indent:
                return out, i
            if line.indent > indent:
                _fail(line.num, "bad indentation in a mapping")
            split = _split_key(line.text, line.num)
            if split is None:
                if line.text == "-" or line.text.startswith("- "):
                    return out, i  # the caller's sequence goes on
                _fail(line.num, "a line that is no mapping entry")
            key, rest = split
            if rest:
                value = _inline(rest, line.num)
                i += 1
                nxt = self._at(i)
                if nxt is not None and nxt.indent > indent:
                    _fail(nxt.num, "a multi-line scalar or a nested block "
                          "after an inline value")
            else:
                value, i = self._nested(i + 1, indent, True)
            _put(out, key, value, line.num)


def loads(doc: str):
    """The document's value, as `yaml.safe_load` gives it for input in
    the subset; ValueError naming the line for anything outside it."""
    p = _Parser(doc)
    if not p.lines:
        return None
    value, i = p.node(0)
    if i != len(p.lines):
        line = p.lines[i]
        _fail(line.num, "text after the document's top node")
    return value


def load(path: str):
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


__all__ = ["load", "loads", "scalar"]
