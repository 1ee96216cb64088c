"""X.509 certificates, CRLs and PKCS #8 P-256 keys in pure Python.

Parses what the MSP reads of a certificate: the exact `tbsCertificate`
bytes, serial, signature algorithm and signature, issuer and subject as
their raw DER Names, the validity window (UTCTime or GeneralizedTime),
the subject's OUs, the P-256 point of the SubjectPublicKeyInfo, and the
subject and authority key identifiers.  Only ECDSA with SHA-256 over
P-256 keys is accepted, the one kind Fabric's X.509 MSP issues; any
other certificate fails to load.

PEM follows the decoder `cryptography` uses (the `pem` crate): blocks
are found by plain substring search, a blank line inside the body or a
header line fails the whole input, spaces, tabs and line breaks inside
the base64 are skipped, padding is optional, and blocks of other labels
are passed over.

Certificate signatures are verified without the low-S rule (OpenSSL
does not enforce it, and about half of the signatures a CA makes are
high-S); transaction signatures keep it (`csp.hostref`).
"""

from __future__ import annotations

import base64
import binascii
import contextlib
import datetime
import hashlib

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import (
    P256_N,
    P256PrivateKey,
    P256PublicKey,
    unmarshal_ecdsa_signature,
)

OID_EC_PUBLIC_KEY = "1.2.840.10045.2.1"
OID_P256 = "1.2.840.10045.3.1.7"
OID_ECDSA_SHA256 = "1.2.840.10045.4.3.2"
OID_CN = "2.5.4.3"
OID_O = "2.5.4.10"
OID_OU = "2.5.4.11"
OID_SKI = "2.5.29.14"
OID_KEY_USAGE = "2.5.29.15"
OID_BASIC_CONSTRAINTS = "2.5.29.19"
OID_AKI = "2.5.29.35"
OID_EKU = "2.5.29.37"
OID_CLIENT_AUTH = "1.3.6.1.5.5.7.3.2"


class X509Error(ValueError):
    """Bytes that are not a certificate, CRL or key this module reads."""


# ---------------------------------------------------------------------------
# DER.
# ---------------------------------------------------------------------------


def read_tlv(buf: bytes, pos: int, end: int) -> tuple[int, int, int]:
    """One DER element at `pos`: (tag, content start, content end)."""
    if end - pos < 2:
        raise X509Error("truncated DER element")
    tag = buf[pos]
    if tag & 0x1F == 0x1F:
        raise X509Error("multi-byte DER tags are not used here")
    ln = buf[pos + 1]
    pos += 2
    if ln & 0x80:
        k = ln & 0x7F
        if k == 0 or k > 4 or end - pos < k:
            raise X509Error("bad DER length")
        ln = int.from_bytes(buf[pos:pos + k], "big")
        if ln < 0x80 or buf[pos] == 0:
            raise X509Error("non-minimal DER length")
        pos += k
    if ln > end - pos:
        raise X509Error("truncated DER content")
    return tag, pos, pos + ln


def children(buf: bytes, start: int, end: int) -> list[tuple[int, int, int, int]]:
    """The elements inside a constructed element's content, as
    (tag, element start, content start, content end)."""
    out = []
    pos = start
    while pos < end:
        tag, s, e = read_tlv(buf, pos, end)
        out.append((tag, pos, s, e))
        pos = e
    return out


def _expect(el, tag: int, what: str):
    if el[0] != tag:
        raise X509Error(f"{what}: expected tag {tag:#x}, got {el[0]:#x}")
    return el


def _der_int(buf: bytes, el) -> int:
    _expect(el, 0x02, "INTEGER")
    raw = buf[el[2]:el[3]]
    if not raw:
        raise X509Error("empty INTEGER")
    if len(raw) > 1 and (raw[0] == 0 and raw[1] < 0x80
                         or raw[0] == 0xFF and raw[1] >= 0x80):
        raise X509Error("non-minimal INTEGER")
    return int.from_bytes(raw, "big", signed=True)


def decode_oid(raw: bytes) -> str:
    if not raw or raw[-1] & 0x80:
        raise X509Error("bad OID")
    arcs = []
    v = 0
    for b in raw:
        if v == 0 and b == 0x80:
            raise X509Error("non-minimal OID arc")
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            arcs.append(v)
            v = 0
    first = min(arcs[0] // 40, 2)
    return ".".join(map(str, [first, arcs[0] - 40 * first, *arcs[1:]]))


def _oid(buf: bytes, el) -> str:
    _expect(el, 0x06, "OBJECT IDENTIFIER")
    return decode_oid(buf[el[2]:el[3]])


def _time(buf: bytes, el) -> datetime.datetime:
    raw = buf[el[2]:el[3]].decode("ascii", "strict")
    if el[0] == 0x17:  # UTCTime YYMMDDHHMMSSZ
        if len(raw) != 13 or raw[-1] != "Z" or not raw[:-1].isdigit():
            raise X509Error("bad UTCTime")
        year = int(raw[:2])
        year += 1900 if year >= 50 else 2000
        rest = raw[2:-1]
    elif el[0] == 0x18:  # GeneralizedTime YYYYMMDDHHMMSSZ
        if len(raw) != 15 or raw[-1] != "Z" or not raw[:-1].isdigit():
            raise X509Error("bad GeneralizedTime")
        year = int(raw[:4])
        rest = raw[4:-1]
    else:
        raise X509Error("expected a time")
    return datetime.datetime(year, int(rest[0:2]), int(rest[2:4]),
                             int(rest[4:6]), int(rest[6:8]), int(rest[8:10]),
                             tzinfo=datetime.timezone.utc)


_STRING_TAGS = {0x0C: "utf-8", 0x13: "ascii", 0x16: "ascii", 0x14: "latin-1",
                0x1E: "utf-16-be", 0x1C: "utf-32-be"}


def name_attributes(buf: bytes, start: int, end: int) -> list[tuple[str, str]]:
    """(OID, value) of every attribute of a Name, in order."""
    out = []
    for rdn in children(buf, start, end):
        _expect(rdn, 0x31, "RelativeDistinguishedName")
        for atv in children(buf, rdn[2], rdn[3]):
            _expect(atv, 0x30, "AttributeTypeAndValue")
            parts = children(buf, atv[2], atv[3])
            if len(parts) != 2:
                raise X509Error("bad AttributeTypeAndValue")
            codec = _STRING_TAGS.get(parts[1][0])
            if codec is None:
                raise X509Error("unsupported attribute string type")
            value = buf[parts[1][2]:parts[1][3]].decode(codec, "strict")
            out.append((_oid(buf, parts[0]), value))
    return out


def _bit_string(buf: bytes, el) -> bytes:
    """A BIT STRING's bytes.  Unused bits (0-7, zero in the last byte)
    are allowed and dropped, as `cryptography` reads them."""
    _expect(el, 0x03, "BIT STRING")
    if el[3] == el[2]:
        raise X509Error("empty BIT STRING")
    unused = buf[el[2]]
    if unused > 7 or (unused and (el[3] - el[2] == 1
                                  or buf[el[3] - 1] & ((1 << unused) - 1))):
        raise X509Error("bad BIT STRING padding")
    return buf[el[2] + 1:el[3]]


# ---------------------------------------------------------------------------
# PEM.
# ---------------------------------------------------------------------------


def _find(data: bytes, needle: bytes, pos: int) -> int:
    """Index of `needle` from `pos` by the pem crate's scan: a mismatch
    restarts the match at the next byte without re-testing the byte that
    broke it, so "------BEGIN" holds no "-----BEGIN"."""
    matched = 0
    i = pos
    n = len(needle)
    while i < len(data):
        if data[i] == needle[matched]:
            matched += 1
            if matched == n:
                return i + 1 - n
        else:
            matched = 0
        i += 1
    return -1


_WS = b" \t\n\r\x0b\x0c"


_B64 = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"


def _b64decode(b64: bytes) -> bytes:
    """Canonical base64: padding optional but not partial, and the bits
    the last symbol carries past the data zero."""
    core = b64.rstrip(b"=")
    pad = len(b64) - len(core)
    if b"=" in core or len(core) % 4 == 1 or pad > 2 or \
            (pad and (len(core) + pad) % 4):
        raise X509Error("bad base64 padding in PEM")
    if core and len(core) % 4:
        spare = 0xF if len(core) % 4 == 2 else 0x3
        if core[-1] not in _B64 or _B64.index(core[-1]) & spare:
            raise X509Error("non-canonical last base64 symbol in PEM")
    try:
        return base64.b64decode(core + b"=" * (-len(core) % 4), validate=True)
    except (binascii.Error, ValueError) as exc:
        raise X509Error("bad base64 in PEM") from exc


def pem_blocks(data: bytes) -> list[tuple[str, bytes]]:
    """Every PEM block of `data` as (label, DER)."""
    out = []
    pos = 0
    while True:
        b = _find(data, b"-----BEGIN ", pos)
        if b < 0:
            return out
        ls = b + 11
        le = _find(data, b"-----", ls)
        if le < 0:
            return out
        label = data[ls:le]
        body_start = le + 5
        while body_start < len(data) and data[body_start] in b" \t\n\r":
            body_start += 1
        e = _find(data, b"-----END ", body_start)
        if e < 0:
            return out
        es = e + 9
        ee = _find(data, b"-----", es)
        if ee < 0:
            return out
        if data[es:ee] != label:
            raise X509Error("PEM end label does not match its begin label")
        body = data[body_start:e]
        if b"\n\n" in body or b"\r\n\r\n" in body or b":" in body:
            raise X509Error("PEM headers are not supported")
        der = _b64decode(bytes(c for c in body if c not in _WS))
        try:
            out.append((label.decode("ascii"), der))
        except UnicodeDecodeError as exc:
            raise X509Error("bad PEM label") from exc
        pos = ee + 5


def pem_encode(der: bytes, label: str = "CERTIFICATE") -> bytes:
    """PEM as `cryptography` writes it: 64-column base64 lines."""
    b64 = base64.b64encode(der)
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n".encode() + b"\n".join(lines)
            + f"\n-----END {label}-----\n".encode())


# ---------------------------------------------------------------------------
# Certificates.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _malformed(what: str):
    """Re-raise a parse failure inside a structure (a short element, a
    bad date, non-ASCII in a time) as X509Error."""
    try:
        yield
    except X509Error:
        raise
    except (ValueError, IndexError) as exc:
        raise X509Error(f"malformed {what}: {exc}") from exc


def _algorithm(buf: bytes, el) -> str:
    """The OID of an AlgorithmIdentifier without parameters."""
    _expect(el, 0x30, "AlgorithmIdentifier")
    (oid,) = children(buf, el[2], el[3])
    return _oid(buf, oid)


def _spki_point(buf: bytes, el) -> P256PublicKey:
    _expect(el, 0x30, "SubjectPublicKeyInfo")
    alg, key = children(buf, el[2], el[3])
    _expect(alg, 0x30, "AlgorithmIdentifier")
    parts = children(buf, alg[2], alg[3])
    if len(parts) != 2 or _oid(buf, parts[0]) != OID_EC_PUBLIC_KEY \
            or _oid(buf, parts[1]) != OID_P256:
        raise X509Error("not a P-256 public key")
    try:
        return P256PublicKey.from_raw(_bit_string(buf, key))
    except ValueError as exc:
        raise X509Error(str(exc)) from exc


class Certificate:
    """A parsed certificate; `der` is its encoding, `tbs` the signed part."""

    def __init__(self, der: bytes):
        with _malformed("certificate"):
            self._parse(bytes(der))

    def _parse(self, der: bytes) -> None:
        self.der = der
        tag, s, e = read_tlv(der, 0, len(der))
        if tag != 0x30 or e != len(der):
            raise X509Error("certificate is not one DER SEQUENCE")
        parts = children(der, s, e)
        if len(parts) != 3:
            raise X509Error("certificate needs tbs, algorithm and signature")
        tbs, alg, sig = parts
        _expect(tbs, 0x30, "tbsCertificate")
        self.tbs = der[tbs[1]:tbs[3]]
        self.signature_algorithm = _algorithm(der, alg)
        self.signature = _bit_string(der, sig)
        fields = children(der, tbs[2], tbs[3])
        i = 0
        self.version = 1
        if fields and fields[0][0] == 0xA0:
            (version,) = children(der, fields[0][2], fields[0][3])
            self.version = _der_int(der, version) + 1
            if self.version not in (1, 2, 3):
                raise X509Error(f"invalid X.509 version {self.version}")
            i = 1
        if len(fields) < i + 6:
            raise X509Error("tbsCertificate is missing fields")
        self.serial_number = _der_int(der, fields[i])
        if _algorithm(der, fields[i + 1]) != self.signature_algorithm:
            raise X509Error("inner and outer signature algorithms differ")
        issuer, validity, subject = fields[i + 2], fields[i + 3], fields[i + 4]
        _expect(issuer, 0x30, "issuer")
        _expect(validity, 0x30, "validity")
        _expect(subject, 0x30, "subject")
        self.issuer = der[issuer[1]:issuer[3]]
        self.subject = der[subject[1]:subject[3]]
        name_attributes(der, issuer[2], issuer[3])  # well formed, as read
        self.subject_attributes = name_attributes(der, subject[2], subject[3])
        nb, na = children(der, validity[2], validity[3])
        self.not_valid_before = _time(der, nb)
        self.not_valid_after = _time(der, na)
        self.public_key = _spki_point(der, fields[i + 5])
        self.extensions: dict[str, tuple[bool, bytes]] = {}
        for extra in fields[i + 6:]:
            if extra[0] in (0x81, 0x82):  # issuer / subject unique ids
                continue
            _expect(extra, 0xA3, "extensions")
            (seq,) = children(der, extra[2], extra[3])
            _expect(seq, 0x30, "Extensions")
            for ext in children(der, seq[2], seq[3]):
                _expect(ext, 0x30, "Extension")
                items = children(der, ext[2], ext[3])
                if len(items) not in (2, 3):
                    raise X509Error("bad Extension")
                oid = _oid(der, items[0])
                critical = False
                if len(items) == 3:
                    flag = _expect(items[1], 0x01, "critical")
                    if der[flag[2]:flag[3]] != b"\xff":  # DER TRUE only
                        raise X509Error("bad critical flag")
                    critical = True
                value = _expect(items[-1], 0x04, "extension value")
                if oid in self.extensions:
                    raise X509Error(f"duplicate extension {oid}")
                self.extensions[oid] = (critical, der[value[2]:value[3]])

    @property
    def ous(self) -> list[str]:
        return [v for oid, v in self.subject_attributes if oid == OID_OU]

    @property
    def subject_key_identifier(self) -> bytes | None:
        ext = self.extensions.get(OID_SKI)
        if ext is None:
            return None
        tag, s, e = read_tlv(ext[1], 0, len(ext[1]))
        return ext[1][s:e]

    @property
    def authority_key_identifier(self) -> bytes | None:
        ext = self.extensions.get(OID_AKI)
        if ext is None:
            return None
        raw = ext[1]
        _, s, e = read_tlv(raw, 0, len(raw))
        for tag, _, cs, ce in children(raw, s, e):
            if tag == 0x80:
                return raw[cs:ce]
        return None

    def pem(self) -> bytes:
        return pem_encode(self.der)

    def __eq__(self, other):
        return isinstance(other, Certificate) and other.der == self.der

    def __hash__(self):
        return hash(self.der)


def load_pem_certificates(pem: bytes) -> list[Certificate]:
    """Every CERTIFICATE block of `pem`; raises when there is none or one
    fails to parse (as `x509.load_pem_x509_certificates`)."""
    certs = [Certificate(der) for label, der in pem_blocks(bytes(pem))
             if label in ("CERTIFICATE", "X509 CERTIFICATE")]
    if not certs:
        raise X509Error("no certificate in PEM")
    return certs


def verify_signed(issuer_key: P256PublicKey, tbs: bytes, signature: bytes,
                  algorithm: str) -> bool:
    """ECDSA-SHA256 over `tbs` by `issuer_key`, without the low-S rule."""
    if algorithm != OID_ECDSA_SHA256:
        return False
    try:
        r, s = unmarshal_ecdsa_signature(signature)
    except ValueError:
        return False
    if not (0 < r < P256_N and 0 < s < P256_N):
        return False
    digest = hashlib.sha256(tbs).digest()
    # (r, s) and (r, n - s) verify alike; hostref holds the low one
    return hostref.verify_rs(issuer_key.x, issuer_key.y, digest, r,
                             min(s, P256_N - s))


# ---------------------------------------------------------------------------
# CRLs.
# ---------------------------------------------------------------------------


class CertificateRevocationList:
    """A CRL's revoked serial numbers.  The CRL's own signature is not
    checked, as the MSP of the JAX package does not check it."""

    def __init__(self, der: bytes):
        with _malformed("CRL"):
            self._parse(bytes(der))

    def _parse(self, der: bytes) -> None:
        self.der = der
        tag, s, e = read_tlv(der, 0, len(der))
        if tag != 0x30 or e != len(der):
            raise X509Error("CRL is not one DER SEQUENCE")
        tbs = _expect(children(der, s, e)[0], 0x30, "tbsCertList")
        fields = children(der, tbs[2], tbs[3])
        i = 1 if fields and fields[0][0] == 0x02 else 0
        self.revoked_serials: set[int] = set()
        for el in fields[i + 3:]:
            if el[0] != 0x30:
                continue
            for entry in children(der, el[2], el[3]):
                self.revoked_serials.add(
                    _der_int(der, children(der, entry[2], entry[3])[0]))
            break

    def is_revoked(self, serial: int) -> bool:
        return serial in self.revoked_serials


def load_pem_crl(pem: bytes) -> CertificateRevocationList:
    for label, der in pem_blocks(bytes(pem)):
        if label == "X509 CRL":
            return CertificateRevocationList(der)
    raise X509Error("no X509 CRL in PEM")


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------


def load_pem_private_key(pem: bytes) -> P256PrivateKey:
    """A P-256 key from unencrypted PKCS #8 ("PRIVATE KEY") PEM."""
    with _malformed("private key"):
        return _private_key(bytes(pem))


def _private_key(pem: bytes) -> P256PrivateKey:
    for label, der in pem_blocks(pem):
        if label != "PRIVATE KEY":
            continue
        _, s, e = read_tlv(der, 0, len(der))
        version, alg, key = children(der, s, e)[:3]
        parts = children(der, alg[2], alg[3])
        if _oid(der, parts[0]) != OID_EC_PUBLIC_KEY or \
                _oid(der, parts[1]) != OID_P256:
            raise X509Error("not a P-256 key")
        ec = der[_expect(key, 0x04, "privateKey")[2]:key[3]]
        _, s, e = read_tlv(ec, 0, len(ec))
        octets = _expect(children(ec, s, e)[1], 0x04, "ECPrivateKey")
        d = int.from_bytes(ec[octets[2]:octets[3]], "big")
        x, y = hostref.mul_g(d)
        return P256PrivateKey(d, P256PublicKey(x, y))
    raise X509Error("no private key in PEM")


__all__ = [
    "X509Error", "Certificate", "CertificateRevocationList",
    "load_pem_certificates", "load_pem_crl", "load_pem_private_key",
    "pem_blocks", "pem_encode", "verify_signed", "read_tlv", "children",
    "decode_oid", "name_attributes",
]
