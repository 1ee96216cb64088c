"""CSP interface of the port: P-256 parameters, keys, DER signatures,
the batch item and the provider protocol.

A copy of `fabric_tpu/csp/api.py` without the `cryptography` package
(the port imports nothing of the JAX package).  Keys are plain points:
`P256PublicKey` carries only the coordinates, and the provider accepts
any key object of that shape (`x`, `y`, `x_bytes`, `y_bytes`, `ski()`,
`public_key()`), so the JAX package's keys work here unchanged.
"""

from __future__ import annotations

import abc
import hashlib
import typing
from typing import Sequence

# ---------------------------------------------------------------------------
# P-256 domain parameters (NIST FIPS 186-4).
# ---------------------------------------------------------------------------

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_A = P256_P - 3
P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
P256_GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
P256_HALF_N = P256_N // 2


class Key(abc.ABC):
    """A cryptographic key held by a CSP (reference bccsp/bccsp.go:15-40)."""

    @abc.abstractmethod
    def ski(self) -> bytes:
        """Subject key identifier of this key."""

    @abc.abstractmethod
    def raw(self) -> bytes:
        """Serialized form: the uncompressed point for public keys, the
        32-byte big-endian scalar for private keys."""

    @property
    def is_private(self) -> bool:
        return False

    def public_key(self) -> "Key":
        raise NotImplementedError


def _point_ski(x: int, y: int) -> bytes:
    # SKI = SHA-256 over the uncompressed marshaled point
    # (bccsp/sw/keys.go ecdsaPublicKey.SKI / elliptic.Marshal).
    raw = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return hashlib.sha256(raw).digest()


def on_curve(x: int, y: int) -> bool:
    """True when (x, y) is an affine point of P-256."""
    if not (0 <= x < P256_P and 0 <= y < P256_P):
        return False
    return (y * y - (x * x * x + P256_A * x + P256_B)) % P256_P == 0


class P256PublicKey(Key):
    """A P-256 public key as a bare affine point."""

    def __init__(self, x: int, y: int):
        self.x = x
        self.y = y
        # fixed-width coordinates, computed once: the batch marshaller
        # reads them for every lane
        self.x_bytes = x.to_bytes(32, "big")
        self.y_bytes = y.to_bytes(32, "big")
        self._ski = _point_ski(x, y)

    def ski(self) -> bytes:
        return self._ski

    def public_key(self) -> "P256PublicKey":
        return self

    def raw(self) -> bytes:
        return b"\x04" + self.x_bytes + self.y_bytes

    @classmethod
    def from_raw(cls, raw: bytes) -> "P256PublicKey":
        """Parse an uncompressed point; refuses points off the curve (the
        reference parses keys through crypto/x509, which checks)."""
        if len(raw) != 65 or raw[0] != 0x04:
            raise ValueError("expected a 65-byte uncompressed P-256 point")
        x = int.from_bytes(raw[1:33], "big")
        y = int.from_bytes(raw[33:], "big")
        if not on_curve(x, y):
            raise ValueError("point is not on P-256")
        return cls(x, y)


class P256PrivateKey(Key):
    """A P-256 private scalar with its public point."""

    def __init__(self, d: int, pub: P256PublicKey):
        if not 0 < d < P256_N:
            raise ValueError("private scalar out of range")
        self.d = d
        self._pub = pub

    def ski(self) -> bytes:
        return self._pub.ski()

    def raw(self) -> bytes:
        return self.d.to_bytes(32, "big")

    @property
    def is_private(self) -> bool:
        return True

    def public_key(self) -> P256PublicKey:
        return self._pub


# ---------------------------------------------------------------------------
# Signature encoding: DER <-> (r, s), low-S normalization.
# Reference: bccsp/utils/ecdsa.go:39 MarshalECDSASignature, :84 IsLowS,
# :94 ToLowS.  Fabric rejects high-S signatures on verify and always emits
# low-S on sign (signature malleability defense).
# ---------------------------------------------------------------------------


def _der_int(v: int) -> bytes:
    """Minimal DER INTEGER content for a positive integer."""
    raw = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return bytes([0x02, len(raw)]) + raw


def _der_read_int(sig: bytes, off: int) -> tuple[int, int]:
    """Strict-DER INTEGER at `off`; returns (value, next offset)."""
    if off + 2 > len(sig) or sig[off] != 0x02:
        raise ValueError("invalid DER signature: expected INTEGER")
    ln = sig[off + 1]
    off += 2
    if ln == 0 or ln > 0x7F or off + ln > len(sig):
        raise ValueError("invalid DER signature: bad integer length")
    raw = sig[off:off + ln]
    if raw[0] & 0x80:
        raise ValueError("invalid DER signature: negative integer")
    if ln > 1 and raw[0] == 0 and not raw[1] & 0x80:
        raise ValueError("invalid DER signature: non-minimal integer")
    return int.from_bytes(raw, "big"), off + ln


def marshal_ecdsa_signature(r: int, s: int) -> bytes:
    """DER ECDSA-Sig-Value encoding (a P-256 r/s pair fits short-form
    lengths)."""
    body = _der_int(r) + _der_int(s)
    if len(body) > 0x7F:
        raise ValueError("r/s too large for short-form DER encoding")
    return bytes([0x30, len(body)]) + body


def unmarshal_ecdsa_signature(sig: bytes) -> tuple[int, int]:
    """DER-decode a signature. Raises ValueError on malformed input or
    non-positive r/s (reference bccsp/utils/ecdsa.go:47-62).  Strict:
    trailing bytes, non-minimal integers, and negatives are rejected."""
    if len(sig) < 2 or sig[0] != 0x30:
        raise ValueError("invalid DER signature: expected SEQUENCE")
    if sig[1] > 0x7F or 2 + sig[1] != len(sig):
        raise ValueError("invalid DER signature: bad sequence length")
    r, off = _der_read_int(sig, 2)
    s, off = _der_read_int(sig, off)
    if off != len(sig):
        raise ValueError("invalid DER signature: trailing bytes")
    if r <= 0 or s <= 0:
        raise ValueError("invalid signature: r and s must be positive")
    return r, s


def is_low_s(s: int) -> bool:
    return s <= P256_HALF_N


def to_low_s(s: int) -> int:
    return P256_N - s if s > P256_HALF_N else s


# ---------------------------------------------------------------------------
# Batch verify item.
# ---------------------------------------------------------------------------


class VerifyBatchItem(typing.NamedTuple):
    """One (public key, digest, signature) triple for batched
    verification.  A NamedTuple: the validator creates one per creator
    and endorsement lane, thousands per block."""

    key: P256PublicKey
    digest: bytes  # 32-byte SHA-256 digest of the signed message
    signature: bytes  # DER-encoded (r, s)


class CSP(abc.ABC):
    """Provider protocol (reference bccsp/bccsp.go:90-134), plus batch ops."""

    @abc.abstractmethod
    def key_gen(self) -> P256PrivateKey: ...

    @abc.abstractmethod
    def key_import(self, raw: bytes, private: bool = False) -> Key: ...

    @abc.abstractmethod
    def get_key(self, ski: bytes) -> Key: ...

    @abc.abstractmethod
    def hash(self, msg: bytes) -> bytes: ...

    @abc.abstractmethod
    def sign(self, key: Key, digest: bytes) -> bytes: ...

    @abc.abstractmethod
    def verify(self, key: Key, signature: bytes, digest: bytes) -> bool: ...

    # -- batch extension (the device seam) ---------------------------------

    @abc.abstractmethod
    def hash_batch(self, msgs: Sequence[bytes]) -> list[bytes]: ...

    @abc.abstractmethod
    def verify_batch(self, items: Sequence[VerifyBatchItem]) -> list[bool]: ...

    def verify_batch_async(self, items: Sequence[VerifyBatchItem]):
        """Dispatch a batch verify and return a zero-arg collector.

        Device providers override this to return BEFORE the device
        finishes, so callers can overlap host work for the next batch
        with the device's current one.  The default computes eagerly."""
        result = self.verify_batch(items)
        return lambda: result


__all__ = [
    "CSP",
    "Key",
    "P256PublicKey",
    "P256PrivateKey",
    "VerifyBatchItem",
    "on_curve",
    "marshal_ecdsa_signature",
    "unmarshal_ecdsa_signature",
    "is_low_s",
    "to_low_s",
    "P256_P",
    "P256_A",
    "P256_B",
    "P256_N",
    "P256_GX",
    "P256_GY",
    "P256_HALF_N",
]
