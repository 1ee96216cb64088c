"""Pure-Python P-384 ECDSA with SHA-256: the idemix revocation authority's
signature.

The JAX package's revocation signs and verifies the CRI through
`cryptography` (ECDSA over SECP384R1 with SHA-256), which the machine with
the card does not have.  This module gives the port the same verdicts:

- the digest is SHA-256 of the data; at 256 bits it is shorter than the
  384-bit order, so `e` is the whole digest, untruncated;
- `verify` takes high-S signatures, as `cryptography` does (no low-S rule
  on this curve);
- signatures are strict DER, short-form lengths: a trailing byte, a
  non-minimal or negative INTEGER, and r or s of 0 or >= n are refused;
- `sign` draws its nonce by RFC 6979 (HMAC-SHA256), so it needs no
  randomness and gives the signature `cryptography` gives with
  `deterministic_signing=True`.

Keys come from an explicit generator when one is given (`random.Random`
or `numpy.random.Generator`), else from `secrets`.  A public key is the
point `(x, y)`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import hmac
import secrets
import typing

from fabric_tpu_torch.csp.api import (
    marshal_ecdsa_signature,
    unmarshal_ecdsa_signature,
)

P384_P = 2**384 - 2**128 - 2**96 + 2**32 - 1
P384_N = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372ddf"
    "581a0db248b0a77aecec196accc52973", 16)
P384_B = int(
    "b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
    "c656398d8a2ed19d2a85c8edd3ec2aef", 16)
P384_GX = int(
    "aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
    "5502f25dbf55296c3a545e3872760ab7", 16)
P384_GY = int(
    "3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
    "0a60b1ce1d7e819d7a431d7c90ea0e5f", 16)
_BYTES = 48


def on_curve(x: int, y: int) -> bool:
    """(x, y) is an affine point of P-384 (y^2 = x^3 - 3x + b)."""
    if not (0 <= x < P384_P and 0 <= y < P384_P):
        return False
    return (y * y - (x * x * x - 3 * x + P384_B)) % P384_P == 0


# ---------------------------------------------------------------------------
# Jacobian arithmetic (a = -3), as hostref's P-256.
# ---------------------------------------------------------------------------

_INF = (1, 1, 0)


def _jdbl(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return _INF
    p = P384_P
    delta = z * z % p
    gamma = y * y % p
    beta = x * gamma % p
    alpha = 3 * (x - delta) * (x + delta) % p
    x3 = (alpha * alpha - 8 * beta) % p
    z3 = ((y + z) ** 2 - gamma - delta) % p
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % p
    return (x3, y3, z3)


def _jadd(p1, p2):
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    p = P384_P
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 * z2z2 % p
    s2 = y2 * z1 * z1z1 % p
    h = (u2 - u1) % p
    r = (s2 - s1) % p
    if h == 0:
        return _jdbl(p1) if r == 0 else _INF
    hh = h * h % p
    hhh = h * hh % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    return (x3, y3, z1 * z2 * h % p)


def _to_affine(pt):
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, P384_P)
    zi2 = zi * zi % P384_P
    return (x * zi2 % P384_P, y * zi2 * zi % P384_P)


def _table(pt) -> list:
    """[0 * pt, 1 * pt, ..., 15 * pt] in Jacobian form."""
    tab = [_INF, (pt[0], pt[1], 1)]
    for _ in range(14):
        tab.append(_jadd(tab[-1], tab[1]))
    return tab


@functools.lru_cache(maxsize=1)
def _g_table() -> list:
    return _table((P384_GX, P384_GY))


def _mul2(k1: int, t1: list, k2: int, t2: list):
    """k1 * P1 + k2 * P2 (Jacobian) from their 4-bit tables, MSB first,
    sharing the doublings."""
    acc = _INF
    for w in range(95, -1, -1):
        for _ in range(4):
            acc = _jdbl(acc)
        acc = _jadd(acc, t1[(k1 >> (4 * w)) & 0xF])
        acc = _jadd(acc, t2[(k2 >> (4 * w)) & 0xF])
    return acc


def mul_g(k: int):
    """k * G, affine (None for infinity)."""
    return _to_affine(_mul2(k % P384_N, _g_table(), 0, [_INF]))


# ---------------------------------------------------------------------------
# Keys, signing, verification.
# ---------------------------------------------------------------------------


class P384PublicKey(typing.NamedTuple):
    x: int
    y: int

    def verify(self, signature: bytes, data: bytes) -> bool:
        return verify(self, signature, data)


@dataclasses.dataclass(frozen=True)
class P384PrivateKey:
    d: int
    x: int
    y: int

    def public_key(self) -> P384PublicKey:
        return P384PublicKey(self.x, self.y)

    def sign(self, data: bytes) -> bytes:
        return sign(self, data)


def _scalar(rng) -> int:
    """A uniform scalar in [1, n-1]."""
    if rng is not None and hasattr(rng, "randrange"):
        return rng.randrange(1, P384_N)
    while True:
        raw = rng.bytes(_BYTES) if rng is not None else \
            secrets.token_bytes(_BYTES)
        k = int.from_bytes(raw, "big")
        if 0 < k < P384_N:
            return k


def key_gen(rng=None) -> P384PrivateKey:
    d = _scalar(rng)
    x, y = mul_g(d)
    return P384PrivateKey(d, x, y)


def _rfc6979_nonces(d: int, digest: bytes):
    """RFC 6979 section 3.2 with HMAC-SHA256 over the 384-bit order: the
    nonce candidates in turn.  The 256-bit digest is shorter than qlen,
    so bits2int is the plain integer."""
    x = d.to_bytes(_BYTES, "big")
    h = (int.from_bytes(digest, "big") % P384_N).to_bytes(_BYTES, "big")
    k = b"\x00" * 32
    v = b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        t = b""
        while len(t) < _BYTES:
            v = hmac.new(k, v, hashlib.sha256).digest()
            t += v
        nonce = int.from_bytes(t[:_BYTES], "big")
        if 0 < nonce < P384_N:
            yield nonce
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(key: P384PrivateKey, data: bytes) -> bytes:
    """DER ECDSA signature over SHA-256(data), nonce by RFC 6979.  S is
    left as computed (no low-S normalisation), as OpenSSL leaves it."""
    digest = hashlib.sha256(data).digest()
    e = int.from_bytes(digest, "big")
    for k in _rfc6979_nonces(key.d, digest):
        r = mul_g(k)[0] % P384_N
        s = pow(k, -1, P384_N) * (e + r * key.d) % P384_N
        if r and s:
            return marshal_ecdsa_signature(r, s)


def verify(key, signature: bytes, data: bytes) -> bool:
    """`cryptography`'s verdict for ECDSA(SHA-256) over P-384: `key` is the
    point (x, y) (a P384PublicKey, a tuple, or a private key)."""
    if isinstance(key, P384PrivateKey):
        key = key.public_key()
    x, y = key
    if not on_curve(x, y):
        return False
    try:
        r, s = unmarshal_ecdsa_signature(signature)
    except ValueError:
        return False
    if not (0 < r < P384_N and 0 < s < P384_N):
        return False
    e = int.from_bytes(hashlib.sha256(data).digest(), "big")
    w = pow(s, -1, P384_N)
    rp = _to_affine(_mul2(e * w % P384_N, _g_table(),
                          r * w % P384_N, _table((x, y))))
    return rp is not None and rp[0] % P384_N == r


__all__ = [
    "P384_P", "P384_N", "P384_B", "P384_GX", "P384_GY",
    "P384PublicKey", "P384PrivateKey", "on_curve", "mul_g", "key_gen",
    "sign", "verify",
]
