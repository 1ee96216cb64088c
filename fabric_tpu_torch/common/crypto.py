"""In-memory certificate authority (the port's copy of the `CA` of
`fabric_tpu/common/crypto.py`), writing DER itself and signing through
`csp.hostref`.

Its certificates carry what the JAX package's CA writes, in the same
order: a v3 certificate with a 159-bit serial, ECDSA-SHA256, UTF8String
names (CN and O for a CA; CN and one OU per role for a leaf), validity
from five minutes back, and the extensions basic constraints (critical),
key usage (critical) and a SHA-256 subject key identifier, then for a
leaf an authority key identifier, subject alternative names (DNS and IP,
when asked for) and extended key usage.  CRLs are v2
over the serials revoked so far.  Keys and serials come from a
`numpy.random.Generator` when one is given (a seeded world), else from
`secrets`.
"""

from __future__ import annotations

import datetime
import hashlib
import ipaddress
import secrets

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.msp import x509


def _len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _len(len(content)) + content


def seq(*parts: bytes) -> bytes:
    return tlv(0x30, b"".join(parts))


def der_int(v: int) -> bytes:
    return tlv(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big", signed=True))


def der_oid(oid: str) -> bytes:
    arcs = [int(a) for a in oid.split(".")]
    body = bytearray()
    for v in [40 * arcs[0] + arcs[1], *arcs[2:]]:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        body += bytes(reversed(chunk))
    return tlv(0x06, bytes(body))


def der_time(t: datetime.datetime) -> bytes:
    if t.year < 2050:
        return tlv(0x17, t.strftime("%y%m%d%H%M%SZ").encode())
    return tlv(0x18, t.strftime("%Y%m%d%H%M%SZ").encode())


def der_name(attrs: list[tuple[str, str]]) -> bytes:
    return seq(*(tlv(0x31, seq(der_oid(oid), tlv(0x0C, v.encode())))
                 for oid, v in attrs))


def _bits(*names: int) -> bytes:
    """A DER named-bit BIT STRING with the given bit positions set."""
    top = max(names)
    n_bytes = top // 8 + 1
    v = 0
    for b in names:
        v |= 1 << (8 * n_bytes - 1 - b)
    return tlv(0x03, bytes([8 * n_bytes - 1 - top]) + v.to_bytes(n_bytes, "big"))


def _ext(oid: str, value: bytes, critical: bool = False) -> bytes:
    crit = tlv(0x01, b"\xff") if critical else b""
    return seq(der_oid(oid), crit, tlv(0x04, value))


_ALG = seq(der_oid(x509.OID_ECDSA_SHA256))
_VALIDITY = datetime.timedelta(days=3650)
_SPKI_ALG = seq(der_oid(x509.OID_EC_PUBLIC_KEY), der_oid(x509.OID_P256))


def _general_name(name: str) -> bytes:
    """An iPAddress [7] for an address literal, else a dNSName [2]."""
    try:
        return tlv(0x87, ipaddress.ip_address(name).packed)
    except ValueError:
        return tlv(0x82, name.encode("ascii"))


def _ski(pub) -> bytes:
    return hashlib.sha256(pub.raw()).digest()


def _serial(rng) -> int:
    raw = rng.bytes(20) if rng is not None else secrets.token_bytes(20)
    return (int.from_bytes(raw, "big") >> 1) or 1


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)


def key_pem(key) -> bytes:
    """Unencrypted PKCS #8 PEM of a P-256 private key, as
    `CertKeyPair.key_pem` writes it."""
    pub = key.public_key()
    ec_key = seq(der_int(1), tlv(0x04, key.d.to_bytes(32, "big")),
                 tlv(0xA1, tlv(0x03, b"\x00" + pub.raw())))
    return x509.pem_encode(seq(der_int(0), _SPKI_ALG, tlv(0x04, ec_key)),
                           "PRIVATE KEY")


def public_key_pem(pub) -> bytes:
    """SubjectPublicKeyInfo PEM of a P-256 public key."""
    return x509.pem_encode(seq(_SPKI_ALG, tlv(0x03, b"\x00" + pub.raw())),
                           "PUBLIC KEY")


class CertKeyPair:
    def __init__(self, cert: x509.Certificate, key):
        self.cert = cert
        self.key = key

    @property
    def cert_pem(self) -> bytes:
        return self.cert.pem()

    @property
    def key_pem(self) -> bytes:
        return key_pem(self.key)


class CA:
    """An issuing CA; `new_intermediate()` chains, `issue()` makes leaf
    certificates with OUs (what NodeOUs classification reads)."""

    def __init__(self, common_name: str = "ca.example.com",
                 org: str = "example.com", parent: "CA | None" = None,
                 rng=None):
        self._rng = rng if rng is not None else (parent._rng if parent else None)
        self.key = hostref.key_gen(self._rng)
        self.org = org
        self.parent = parent
        self.name = der_name([(x509.OID_CN, common_name), (x509.OID_O, org)])
        issuer = self.name if parent is None else parent.cert.subject
        signer = self if parent is None else parent
        now = _now()
        pub = self.key.public_key()
        exts = [
            _ext(x509.OID_BASIC_CONSTRAINTS, seq(tlv(0x01, b"\xff")), True),
            _ext(x509.OID_KEY_USAGE, _bits(0, 5, 6), True),
            _ext(x509.OID_SKI, tlv(0x04, _ski(pub))),
        ]
        self.cert = signer._sign_cert(issuer, self.name, pub,
                                      now - datetime.timedelta(minutes=5),
                                      now + _VALIDITY, exts)
        self._revoked: list[int] = []

    @property
    def cert_pem(self) -> bytes:
        return self.cert.pem()

    def _sign(self, tbs: bytes) -> bytes:
        return hostref.sign(self.key, hashlib.sha256(tbs).digest(), self._rng)

    def _sign_cert(self, issuer: bytes, subject: bytes, pub, not_before,
                   not_after, exts: list[bytes]) -> x509.Certificate:
        tbs = seq(
            tlv(0xA0, der_int(2)),
            der_int(_serial(self._rng)),
            _ALG,
            issuer,
            seq(der_time(not_before), der_time(not_after)),
            subject,
            seq(_SPKI_ALG, tlv(0x03, b"\x00" + pub.raw())),
            tlv(0xA3, seq(*exts)),
        )
        sig = self._sign(tbs)
        return x509.Certificate(seq(tbs, _ALG, tlv(0x03, b"\x00" + sig)))

    def new_intermediate(self, common_name: str = "ica.example.com") -> "CA":
        return CA(common_name, self.org, parent=self)

    def issue(self, common_name: str, ous: list[str] | None = None,
              sans: list[str] | None = None, client: bool = True,
              server: bool = False) -> CertKeyPair:
        """A leaf certificate and its new key: client-auth EKU by
        default, server-auth with ``server``, DNS/IP names in a subject
        alternative name extension with ``sans``."""
        key = hostref.key_gen(self._rng)
        cert = self.issue_for_public_key(common_name, key.public_key(),
                                         ous=ous, sans=sans, client=client,
                                         server=server)
        return CertKeyPair(cert, key)

    def issue_for_public_key(self, common_name: str, pub,
                             ous: list[str] | None = None,
                             sans: list[str] | None = None,
                             client: bool = True,
                             server: bool = False) -> x509.Certificate:
        """Certify a key held elsewhere (a custody daemon's): only its
        public half reaches the CA."""
        now = _now()
        subject = der_name([(x509.OID_CN, common_name)]
                           + [(x509.OID_OU, ou) for ou in ous or []])
        exts = [
            _ext(x509.OID_BASIC_CONSTRAINTS, seq(), True),
            _ext(x509.OID_KEY_USAGE, _bits(0), True),
            _ext(x509.OID_SKI, tlv(0x04, _ski(pub))),
            _ext(x509.OID_AKI, seq(tlv(
                0x80, self.cert.subject_key_identifier))),
        ]
        if sans:
            exts.append(_ext(x509.OID_SAN, seq(*map(_general_name, sans))))
        eku = ([x509.OID_CLIENT_AUTH] if client else []) + (
            [x509.OID_SERVER_AUTH] if server else [])
        if eku:
            exts.append(_ext(x509.OID_EKU, seq(*map(der_oid, eku))))
        return self._sign_cert(self.cert.subject, subject, pub,
                               now - datetime.timedelta(minutes=5),
                               now + _VALIDITY, exts)

    def revoke(self, cert: x509.Certificate) -> None:
        self._revoked.append(cert.serial_number)

    def gen_crl(self) -> bytes:
        """PEM CRL over every certificate revoked so far."""
        now = _now()
        entries = b"".join(seq(der_int(s), der_time(now))
                           for s in self._revoked)
        tbs = seq(der_int(1), _ALG, self.cert.subject,
                  der_time(now - datetime.timedelta(minutes=5)),
                  der_time(now + datetime.timedelta(days=365)),
                  *([tlv(0x30, entries)] if entries else []))
        sig = self._sign(tbs)
        return x509.pem_encode(seq(tbs, _ALG, tlv(0x03, b"\x00" + sig)),
                               "X509 CRL")


def cert_expiration(pem: bytes) -> datetime.datetime:
    """Earliest not-after among the certificates of a PEM bundle
    (reference common/crypto/expiration.go warns ahead of expiry)."""
    return min(c.not_valid_after for c in x509.load_pem_certificates(pem))


def expiration_warning(
    pem: bytes, label: str, now: datetime.datetime | None = None,
    warn_within: datetime.timedelta = datetime.timedelta(days=7),
) -> str | None:
    """Warning text when `pem`'s earliest certificate expires within
    `warn_within` (or has expired); None otherwise, and for a PEM that
    does not parse.  Reference common/crypto/expiration.go
    TrackExpiration, wired at node start."""
    try:
        exp = cert_expiration(pem)
    except (ValueError, IndexError):
        return None
    return _expiry_text(exp, label, now, warn_within)


def _expiry_text(exp, label, now=None,
                 warn_within=datetime.timedelta(days=7)):
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if exp <= now:
        return f"{label} certificate EXPIRED at {exp.isoformat()}"
    if exp - now <= warn_within:
        days = -((now - exp) // datetime.timedelta(days=1))  # ceil
        return (
            f"{label} certificate expires within "
            f"{days} day(s), at {exp.isoformat()}"
        )
    return None


def track_expiration(entries, warn) -> None:
    """Run expiration_warning over [(label, pem)] pairs, calling
    `warn(text)` for each finding: the node-start expiration sweep."""
    for label, pem in entries:
        if not pem:
            continue
        text = expiration_warning(pem, label)
        if text:
            warn(text)


def warn_node_cert_expirations(signer, tls, signer_label: str, warn) -> None:
    """The peer's and orderer's start-time sweep: week-ahead warnings for
    the node's signing identity and its TLS certificate."""
    if signer is not None:
        text = _expiry_text(signer.expires_at(), signer_label)
        if text:
            warn(text)
    if tls is not None:
        track_expiration([("server TLS", tls.cert_pem)], warn)


__all__ = ["CA", "CertKeyPair", "key_pem", "public_key_pem",
           "cert_expiration", "expiration_warning", "track_expiration",
           "warn_node_cert_expirations"]
