"""Text DSL for signature policies (the port's copy of
`fabric_tpu/policies/policydsl.py`): AND / OR / OutOf over 'MSP.role'
principals, e.g. `AND('Org1.member', OutOf(1, 'Org2.peer', 'Org3.admin'))`."""

from __future__ import annotations

import re

from fabric_tpu_torch.protos import common as cb

_ROLES = {
    "member": cb.MSPRole.MEMBER,
    "admin": cb.MSPRole.ADMIN,
    "client": cb.MSPRole.CLIENT,
    "peer": cb.MSPRole.PEER,
    "orderer": cb.MSPRole.ORDERER,
}

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<name>[A-Za-z]\w*)|(?P<num>\d+)|(?P<str>'[^']*'|\"[^\"]*\")"
    r"|(?P<punct>[(),]))")


class DSLError(Exception):
    pass


def _tokenize(src: str):
    pos = 0
    out = []
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip():
                raise DSLError(f"unexpected input at: {src[pos:pos + 20]!r}")
            break
        pos = m.end()
        if m.group("name"):
            out.append(("name", m.group("name")))
        elif m.group("num"):
            out.append(("num", int(m.group("num"))))
        elif m.group("str"):
            out.append(("str", m.group("str")[1:-1]))
        else:
            out.append(("punct", m.group("punct")))
    return out


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else ("eof", None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, kind, value=None):
        tok = self.next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise DSLError(f"expected {value or kind}, got {tok}")
        return tok

    def parse_expr(self):
        kind, value = self.next()
        if kind == "str":
            return ("principal", value)
        if kind != "name":
            raise DSLError(f"expected function or principal, got {value!r}")
        fn = value.lower()
        self.expect("punct", "(")
        args = []
        if self.peek() != ("punct", ")"):
            while True:
                if fn == "outof" and not args:
                    k, v = self.next()
                    if k != "num":
                        raise DSLError("OutOf requires a leading integer")
                    args.append(("n", v))
                else:
                    args.append(self.parse_expr())
                if self.peek() == ("punct", ","):
                    self.next()
                    continue
                break
        self.expect("punct", ")")
        if fn == "and":
            return ("outof", len(args), args)
        if fn == "or":
            return ("outof", 1, args)
        if fn == "outof":
            if not args or args[0][0] != "n":
                raise DSLError("OutOf requires a leading integer")
            return ("outof", args[0][1], args[1:])
        raise DSLError(f"unknown function {fn!r}")


def _principal_from_string(spec: str) -> cb.MSPPrincipal:
    if "." not in spec:
        raise DSLError(f"principal {spec!r} must look like 'MSP.role'")
    mspid, role = spec.rsplit(".", 1)
    role = role.lower()
    if role not in _ROLES:
        raise DSLError(f"unknown role {role!r} (want one of {sorted(_ROLES)})")
    return cb.MSPPrincipal(
        principal_classification=cb.MSPPrincipal.ROLE,
        principal=cb.MSPRole(msp_identifier=mspid, role=_ROLES[role]).encode())


def from_string(src: str) -> cb.SignaturePolicyEnvelope:
    """The DSL as a SignaturePolicyEnvelope with deduped principals."""
    parser = _Parser(_tokenize(src))
    tree = parser.parse_expr()
    if parser.peek()[0] != "eof":
        raise DSLError("trailing input after policy expression")
    identities: list[cb.MSPPrincipal] = []
    index: dict[bytes, int] = {}

    def build(node) -> cb.SignaturePolicy:
        if node[0] == "principal":
            principal = _principal_from_string(node[1])
            key = principal.encode()
            if key not in index:
                index[key] = len(identities)
                identities.append(principal)
            return cb.SignaturePolicy(signed_by=index[key])
        _, n, kids = node
        if n > len(kids):
            raise DSLError(f"OutOf({n}) with only {len(kids)} sub-policies")
        return cb.SignaturePolicy(n_out_of=cb.NOutOf(
            n=n, rules=[build(c) for c in kids]))

    rule = build(tree)
    return cb.SignaturePolicyEnvelope(version=0, rule=rule,
                                      identities=identities)


__all__ = ["from_string", "DSLError"]
