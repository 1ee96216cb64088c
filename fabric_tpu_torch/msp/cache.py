"""Caching MSP wrapper (the port's copy of `fabric_tpu/msp/cache.py`):
memoizes deserialization, validation (for 60 s: it reads the clock) and
principal checks of an MSP or MSPManager, whose configuration is fixed for
a bundle's lifetime."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

_DESERIALIZE_CACHE = 100
_VALIDATE_CACHE = 100
_PRINCIPAL_CACHE = 100
_VALIDATE_TTL_S = 60.0


class _LRU:
    def __init__(self, cap: int):
        self._cap = cap
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None, False
            self._d.move_to_end(key)
            return self._d[key], True

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)


class CachedMSP:
    """Memoizing facade over an MSP or MSPManager."""

    def __init__(self, inner):
        self._inner = inner
        self._deserialize = _LRU(_DESERIALIZE_CACHE)
        self._validate = _LRU(_VALIDATE_CACHE)
        self._principal = _LRU(_PRINCIPAL_CACHE)

    def deserialize_identity(self, serialized: bytes):
        ident, hit = self._deserialize.get(serialized)
        if hit:
            return ident
        ident = self._inner.deserialize_identity(serialized)
        self._deserialize.put(bytes(serialized), ident)
        return ident

    def validate(self, identity) -> None:
        key = identity.serialize()
        res, hit = self._validate.get(key)
        if hit:
            stamp, outcome = res
            if time.monotonic() - stamp < _VALIDATE_TTL_S:
                if isinstance(outcome, Exception):
                    raise outcome
                return
        try:
            self._inner.validate(identity)
        except Exception as exc:
            self._validate.put(key, (time.monotonic(), exc))
            raise
        self._validate.put(key, (time.monotonic(), None))

    def satisfies_principal(self, identity, principal) -> None:
        key = (identity.serialize(), principal.encode())
        res, hit = self._principal.get(key)
        if hit:
            if isinstance(res, Exception):
                raise res
            return
        try:
            self._inner.satisfies_principal(identity, principal)
        except Exception as exc:
            self._principal.put(key, exc)
            raise
        self._principal.put(key, None)


__all__ = ["CachedMSP"]
