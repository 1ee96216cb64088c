"""BCCSP keystores: in-memory, SKI-keyed PEM file store, dummy.

Reference: bccsp/sw/inmemoryks.go, bccsp/sw/fileks.go:29
(fileBasedKeyStore — one PEM per key in a flat directory, file name
keyed by the hex SKI with a `_sk` / `_pk` suffix), bccsp/sw/dummyks.go.
The file store is what lets a node restart reuse its generated keys
instead of re-deriving state from MSP directories; the directory is
created 0700 and private-key files 0600, as the reference enforces.

The port's copy of the JAX package's `fabric_tpu/csp/keystore.py`.  The
files are what the JAX package writes, read and written here by the
port's own DER code (`common.crypto`, `msp.x509`): ``_sk.pem`` is an
unencrypted PKCS #8 private key, ``_pk.pem`` a SubjectPublicKeyInfo, so
each package opens the other's key directory.
"""

from __future__ import annotations

import os
import threading

from fabric_tpu_torch.csp.api import Key


class InMemoryKeyStore:
    """Ephemeral SKI -> Key map (reference inmemoryks.go)."""

    read_only = False

    def __init__(self) -> None:
        self._keys: dict[bytes, Key] = {}
        self._lock = threading.Lock()

    def store_key(self, key: Key) -> None:
        with self._lock:
            self._keys[key.ski()] = key

    def get_key(self, ski: bytes) -> Key:
        with self._lock:
            key = self._keys.get(ski)
        if key is None:
            raise KeyError(f"no key for SKI {ski.hex()}")
        return key


class DummyKeyStore:
    """Stores nothing, returns nothing (reference dummyks.go) — for
    providers whose keys live elsewhere (e.g. imported per call)."""

    read_only = True

    def store_key(self, key: Key) -> None:
        pass

    def get_key(self, ski: bytes) -> Key:
        raise KeyError(f"dummy keystore holds no keys (SKI {ski.hex()})")


class FileKeyStore:
    """SKI-keyed PEM file keystore (reference fileks.go:29).

    Layout: `<dir>/<ski-hex>_sk.pem` (PKCS8 private) and
    `<dir>/<ski-hex>_pk.pem` (SubjectPublicKeyInfo).  Lookups hit an
    in-memory cache first and fall back to disk, so a restarted node
    finds every key a previous process generated.  `read_only=True`
    refuses stores (the reference supports this for pre-provisioned
    HSM-style directories)."""

    def __init__(self, path: str, read_only: bool = False) -> None:
        self.path = path
        self.read_only = read_only
        os.makedirs(path, exist_ok=True)
        os.chmod(path, 0o700)
        self._cache: dict[bytes, Key] = {}
        self._lock = threading.Lock()

    def _file(self, ski: bytes, private: bool) -> str:
        return os.path.join(
            self.path, f"{ski.hex()}_{'sk' if private else 'pk'}.pem"
        )

    def store_key(self, key: Key) -> None:
        if self.read_only:
            raise PermissionError("read-only keystore")
        from fabric_tpu_torch.common import crypto

        private = key.is_private
        path = self._file(key.ski(), private)
        pem = crypto.key_pem(key) if private else crypto.public_key_pem(key)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, pem)
        finally:
            os.close(fd)
        with self._lock:
            self._cache[key.ski()] = key

    def get_key(self, ski: bytes) -> Key:
        with self._lock:
            key = self._cache.get(ski)
        if key is not None:
            return key
        from fabric_tpu_torch.msp import x509

        sk = self._file(ski, True)
        pk = self._file(ski, False)
        if os.path.exists(sk):
            with open(sk, "rb") as f:
                key = x509.load_pem_private_key(f.read())
        elif os.path.exists(pk):
            with open(pk, "rb") as f:
                key = x509.load_pem_public_key(f.read())
        else:
            raise KeyError(f"no key for SKI {ski.hex()}")
        if key.ski() != ski:
            raise KeyError(
                f"keystore file for {ski.hex()} holds a different key"
            )
        with self._lock:
            self._cache[ski] = key
        return key


__all__ = ["InMemoryKeyStore", "FileKeyStore", "DummyKeyStore"]
