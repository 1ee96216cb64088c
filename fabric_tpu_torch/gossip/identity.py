"""Identity mapper: pki-id -> serialized identity with expiration (the
port's copy of `fabric_tpu/gossip/identity.py`; reference
gossip/identity/identity.go).

Identities expire at their X.509 certificate's notAfter, read by the
port's own `msp/x509.py`, when the identity is an msp.SerializedIdentity
carrying a PEM certificate; opaque identities take a default TTL.
Expired identities are purged on access and by `sweep()`, and purge
listeners let the comm layer and the certstore drop theirs.
"""

from __future__ import annotations

import threading
import time

from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.protos.msp import SerializedIdentity


def identity_expiration(identity: bytes) -> float | None:
    """The identity's expiration in seconds since the epoch, or None when
    it carries no parseable certificate (the caller's default TTL)."""
    try:
        sid = SerializedIdentity.decode(identity)
        cert = x509.load_pem_certificates(sid.id_bytes)[0]
        return cert.not_valid_after.timestamp()
    except Exception:
        return None


class IdentityMapper:
    def __init__(self, mcs, self_identity: bytes,
                 default_ttl_s: float = 3600.0, clock=time.time,
                 on_purge=None):
        self._mcs = mcs
        self._default_ttl = default_ttl_s
        self._clock = clock
        self._purge_listeners: list = [on_purge] if on_purge else []
        self._lock = threading.Lock()
        # pki -> (identity bytes, expiration in epoch seconds)
        self._store: dict[bytes, tuple[bytes, float]] = {}
        self.self_pki = self.put(self_identity)

    def put(self, identity: bytes) -> bytes:
        """Store or refresh an identity; its pki-id.  Raises ValueError
        when the identity has expired."""
        pki = self._mcs.get_pki_id(identity)
        exp = identity_expiration(identity)
        if exp is None:
            exp = self._clock() + self._default_ttl
        if exp <= self._clock():
            raise ValueError("identity is expired")
        with self._lock:
            self._store[pki] = (identity, exp)
        return pki

    def get(self, pki: bytes) -> bytes | None:
        with self._lock:
            entry = self._store.get(pki)
            if entry is None:
                return None
            identity, exp = entry
            if exp > self._clock():
                return identity
            del self._store[pki]
        self._notify_purge(pki)
        return None

    def add_purge_listener(self, fn) -> None:
        self._purge_listeners.append(fn)

    def _notify_purge(self, pki: bytes) -> None:
        for fn in self._purge_listeners:
            fn(pki)

    def known(self) -> list[tuple[bytes, bytes]]:
        """[(pki, identity)] of the unexpired entries."""
        self.sweep()
        with self._lock:
            return [(pki, ident) for pki, (ident, _) in self._store.items()]

    def sweep(self) -> list[bytes]:
        """Purge the expired identities; their pki-ids."""
        now = self._clock()
        with self._lock:
            dead = [p for p, (_, exp) in self._store.items() if exp <= now]
            for p in dead:
                del self._store[p]
        for p in dead:
            self._notify_purge(p)
        return dead


__all__ = ["IdentityMapper", "identity_expiration"]
