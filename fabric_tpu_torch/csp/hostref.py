"""Pure-Python P-256: key generation, signing and verification.

The port's host path.  The machine with the card has no OpenSSL binding,
so this module signs the inputs of `chip_smoke.py`, verifies batches
below `CUDACSP`'s `min_device_batch`, and is the oracle every kernel
result is held against.  Verdicts follow the `sw` provider of the JAX
package: strict DER, 0 < r, s < n, low-S, and a 32-byte digest.
`HostCSP` wraps it as a provider over a keystore: the key custody
daemon's, and the key half (generate, import, look up, sign) that
`CUDACSP` hands to it.

Keys and nonces come from an explicit `numpy.random.Generator` when one
is given (reproducible test inputs), else from `secrets`.
"""

from __future__ import annotations

import functools
import hashlib
import secrets

import numpy as np

from fabric_tpu_torch.csp.api import (
    CSP,
    P256_GX,
    P256_GY,
    P256_N,
    P256_P,
    P256PrivateKey,
    P256PublicKey,
    Key,
    is_low_s,
    marshal_ecdsa_signature,
    on_curve,
    to_low_s,
    unmarshal_ecdsa_signature,
)

# ---------------------------------------------------------------------------
# Affine arithmetic (copy of fabric_tpu.csp.tpu.ec.affine_add/affine_mul).
# None is the point at infinity.
# ---------------------------------------------------------------------------


def affine_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P256_P == 0:
            return None
        lam = (3 * x1 * x1 - 3) * pow(2 * y1, -1, P256_P) % P256_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P256_P) % P256_P
    x3 = (lam * lam - x1 - x2) % P256_P
    y3 = (lam * (x1 - x3) - y1) % P256_P
    return (x3, y3)


def affine_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = affine_add(acc, p)
        p = affine_add(p, p)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Jacobian arithmetic for the scalar multiplications of sign and verify
# (one inversion per multiplication instead of one per step).
# ---------------------------------------------------------------------------

_INF = (1, 1, 0)


def _jdbl(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return _INF
    p = P256_P
    delta = z * z % p
    gamma = y * y % p
    beta = x * gamma % p
    alpha = 3 * (x - delta) * (x + delta) % p
    x3 = (alpha * alpha - 8 * beta) % p
    z3 = ((y + z) ** 2 - gamma - delta) % p
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % p
    return (x3, y3, z3)


def _jadd_affine(pt, a):
    """Jacobian + affine (a is None for infinity)."""
    if a is None:
        return pt
    x1, y1, z1 = pt
    if z1 == 0:
        return (a[0], a[1], 1)
    p = P256_P
    z1z1 = z1 * z1 % p
    u2 = a[0] * z1z1 % p
    s2 = a[1] * z1 * z1z1 % p
    h = (u2 - x1) % p
    r = (s2 - y1) % p
    if h == 0:
        return _jdbl(pt) if r == 0 else _INF
    hh = h * h % p
    hhh = h * hh % p
    v = x1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - y1 * hhh) % p
    return (x3, y3, z1 * h % p)


def _jadd(p1, p2):
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    p = P256_P
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
    zi = pow(z, -1, P256_P)
    zi2 = zi * zi % P256_P
    return (x * zi2 % P256_P, y * zi2 * zi % P256_P)


@functools.lru_cache(maxsize=1)
def _g_comb():
    """comb[w][d] = d * 16^w * G (affine), for the fixed-base products."""
    comb = []
    base = (P256_GX, P256_GY)
    for _ in range(64):
        row = [None]
        for _d in range(1, 16):
            row.append(affine_add(row[-1], base))
        comb.append(row)
        base = affine_add(row[15], base)
    return comb


def _mul_g(k: int):
    """k * G as a Jacobian point (64 mixed adds, no doublings)."""
    comb = _g_comb()
    acc = _INF
    for w in range(64):
        acc = _jadd_affine(acc, comb[w][(k >> (4 * w)) & 0xF])
    return acc


def _mul(k: int, pt):
    """k * pt (affine pt) as a Jacobian point, 4-bit windows MSB first."""
    tab = [_INF, (pt[0], pt[1], 1)]
    for _ in range(14):
        tab.append(_jadd_affine(tab[-1], pt))
    acc = _INF
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = _jdbl(acc)
        acc = _jadd(acc, tab[(k >> (4 * w)) & 0xF])
    return acc


def mul_g(k: int):
    """k * G, affine (None for infinity)."""
    return _to_affine(_mul_g(k % P256_N))


# ---------------------------------------------------------------------------
# Keys, signatures, verification.
# ---------------------------------------------------------------------------


def _scalar(rng: np.random.Generator | None) -> int:
    """A uniform scalar in [1, n-1]."""
    while True:
        raw = rng.bytes(32) if rng is not None else secrets.token_bytes(32)
        k = int.from_bytes(raw, "big")
        if 0 < k < P256_N:
            return k


def key_gen(rng: np.random.Generator | None = None) -> P256PrivateKey:
    d = _scalar(rng)
    x, y = mul_g(d)
    return P256PrivateKey(d, P256PublicKey(x, y))


def sign(key: P256PrivateKey, digest: bytes,
         rng: np.random.Generator | None = None) -> bytes:
    """DER ECDSA signature over a 32-byte digest, low-S (as the
    reference always emits)."""
    if len(digest) != 32:
        raise ValueError("digest must be 32 bytes")
    e = int.from_bytes(digest, "big") % P256_N
    while True:
        k = _scalar(rng)
        r = mul_g(k)[0] % P256_N
        if r == 0:
            continue
        s = pow(k, -1, P256_N) * (e + r * key.d) % P256_N
        if s:
            return marshal_ecdsa_signature(r, to_low_s(s))


def verify_rs(x: int, y: int, digest: bytes, r: int, s: int) -> bool:
    """Verify an already-decoded signature against the point (x, y)."""
    if len(digest) != 32 or not on_curve(x, y):
        return False
    if not (0 < r < P256_N and 0 < s < P256_N) or not is_low_s(s):
        return False
    e = int.from_bytes(digest, "big") % P256_N
    w = pow(s, -1, P256_N)
    rp = _to_affine(_jadd(_mul_g(e * w % P256_N), _mul(r * w % P256_N, (x, y))))
    return rp is not None and rp[0] % P256_N == r


def verify(key, signature: bytes, digest: bytes) -> bool:
    """Verdict of the `sw` provider for one (key, signature, digest);
    `key` is any object with `x`/`y` (a private key's point is used)."""
    if getattr(key, "is_private", False):
        key = key.public_key()
    try:
        r, s = unmarshal_ecdsa_signature(signature)
    except ValueError:
        return False
    return verify_rs(key.x, key.y, digest, r, s)


def verify_batch(items) -> list[bool]:
    return [verify(it.key, it.signature, it.digest) for it in items]


class HostCSP(CSP):
    """The pure-Python provider over a pluggable keystore: what the JAX
    package's host provider (`SWCSP`) is to it.  Keys are generated and
    signed here and kept in the keystore (`csp.keystore`, in memory by
    default); public keys import as the 65-byte uncompressed point,
    private keys as the 32-byte scalar."""

    def __init__(self, keystore=None) -> None:
        if keystore is None:
            from fabric_tpu_torch.csp.keystore import InMemoryKeyStore

            keystore = InMemoryKeyStore()
        self.keystore = keystore

    def key_gen(self) -> P256PrivateKey:
        key = key_gen()
        self.keystore.store_key(key)
        return key

    def key_import(self, raw: bytes, private: bool = False) -> Key:
        if private:
            if len(raw) != 32:
                raise ValueError("expected a 32-byte private scalar")
            d = int.from_bytes(raw, "big")
            x, y = mul_g(d)
            key: Key = P256PrivateKey(d, P256PublicKey(x, y))
        else:
            key = P256PublicKey.from_raw(raw)
        self.keystore.store_key(key)
        return key

    def get_key(self, ski: bytes) -> Key:
        return self.keystore.get_key(ski)

    def hash(self, msg: bytes) -> bytes:
        return hashlib.sha256(msg).digest()

    def sign(self, key: Key, digest: bytes) -> bytes:
        return sign(key, digest)

    def verify(self, key: Key, signature: bytes, digest: bytes) -> bool:
        return verify(key, signature, digest)

    def hash_batch(self, msgs) -> list[bytes]:
        return [hashlib.sha256(m).digest() for m in msgs]

    def verify_batch(self, items) -> list[bool]:
        return verify_batch(items)


__all__ = [
    "HostCSP",
    "affine_add",
    "affine_mul",
    "mul_g",
    "key_gen",
    "sign",
    "verify",
    "verify_rs",
    "verify_batch",
]
