"""Process-isolated key custody: the HSM role.

The port's copy of the JAX package's `fabric_tpu/csp/custody.py`, on the
same RPC methods and wire bodies, so a client of either package talks to
a daemon of the other.  Reference: bccsp/pkcs11 (impl.go:189,
pkcs11.go:321,354): ECDSA keygen and signing happen inside an HSM, the
private keys never enter the peer process, and everything else (hash,
verify) runs on a local provider.  Here the custody boundary is an OS
process:

  KeyCustodyServer  — owns the only copy of the private keys
                      (FileKeyStore under a 0700 dir), serves
                      keygen/sign/get over the framed RPC transport
                      (optionally mutual-TLS), gated by a shared token
                      (the PKCS#11 PIN analogue, checked in constant
                      time).  It signs with `hostref.HostCSP`.
  CustodyCSP        — peer-side provider: key_gen/sign/get_key go to
                      the daemon; hash/verify/verify_batch go to a
                      local provider: `CUDACSP` on the card by
                      default, whose verify_batch runs the P-256
                      kernels (it raises where there is no card); the
                      CPU tests pass `CUDACSP(device="cpu")` or
                      `hostref.HostCSP()`.
  CustodyKeyHandle  — what the peer holds: SKI + PUBLIC key only.
                      There is deliberately no API that returns private
                      material across the boundary.
"""

from __future__ import annotations

import hmac
import os
import threading

from fabric_tpu_torch.csp.api import CSP, Key, P256PublicKey, VerifyBatchItem
from fabric_tpu_torch.csp.hostref import HostCSP


class CustodyError(Exception):
    pass


# Structured sentinel the daemon prefixes to its unknown-SKI answer.
# The peer's local-keystore fallback keys off THIS machine token, not
# the human prose after it — a rewording of the daemon's message (or a
# transport error that happens to mention keys) can no longer be
# confused with "the daemon does not hold this SKI".
ERR_UNKNOWN_SKI = "CUSTODY_ERR_UNKNOWN_SKI"


class CustodyKeyHandle(Key):
    """The peer-visible face of a custody-held private key: SKI plus
    the public half.  sign() must go through the owning CustodyCSP —
    the handle itself holds no secret material at all.

    CONTRACT DIVERGENCE, on purpose: `Key.raw()` documents "private
    keys: PKCS8 DER", which this handle cannot produce — the key is
    non-extractable, exactly like an HSM-resident key — so raw()
    RAISES rather than quietly serializing the public half under a
    private label.  It is likewise not storable in the local keystores
    (there is nothing local to store); use `public_key()` for the
    certifiable public material."""

    def __init__(self, ski: bytes, public: P256PublicKey):
        self._ski = ski
        self._public = public

    def ski(self) -> bytes:
        return self._ski

    def raw(self) -> bytes:
        raise CustodyError(
            "custody-held private keys are not extractable; "
            "use public_key().raw() for the public half"
        )

    @property
    def is_private(self) -> bool:
        return True  # signs (via the daemon); never exportable

    def public_key(self) -> P256PublicKey:
        return self._public


class KeyCustodyServer:
    """The daemon: sole owner of the private keys.  RPC surface:

      custody.KeyGen   token                      -> ski(32) || pub(65)
      custody.Sign     token || ski(32) || digest -> DER signature
      custody.GetKey   token || ski(32)           -> pub(65)

    Wrong token, unknown SKI, or malformed bodies answer an ERR frame;
    no method returns private key bytes (the keystore directory is the
    custody boundary, exactly like an HSM's token storage)."""

    def __init__(self, keystore_dir: str, token: bytes,
                 host: str = "127.0.0.1", port: int = 0, tls=None):
        from fabric_tpu_torch.comm import RPCServer
        from fabric_tpu_torch.csp.keystore import FileKeyStore

        if not token:
            raise ValueError("custody token must not be empty")
        self._token = token
        self._host = HostCSP(keystore=FileKeyStore(keystore_dir))
        self._lock = threading.Lock()
        self.rpc = RPCServer(host, port, tls=tls)
        self.rpc.register("custody.KeyGen", self._key_gen)
        self.rpc.register("custody.Sign", self._sign)
        self.rpc.register("custody.GetKey", self._get_key)

    @property
    def addr(self):
        return self.rpc.addr

    def start(self) -> None:
        self.rpc.start()

    def stop(self) -> None:
        self.rpc.stop()

    def _auth(self, body: bytes) -> bytes:
        n = len(self._token)
        if len(body) < n or not hmac.compare_digest(body[:n], self._token):
            raise CustodyError("custody: bad token")
        return body[n:]

    def _key_gen(self, body: bytes, stream) -> bytes:
        self._auth(body)
        with self._lock:
            key = self._host.key_gen()
        pub = key.public_key()
        return key.ski() + pub.raw()

    def _sign(self, body: bytes, stream) -> bytes:
        rest = self._auth(body)
        if len(rest) != 64:
            raise CustodyError("custody: want ski(32) || digest(32)")
        ski, digest = rest[:32], rest[32:]
        with self._lock:
            try:
                key = self._host.get_key(ski)
            except KeyError:
                raise CustodyError(
                    f"{ERR_UNKNOWN_SKI}: daemon holds no key for "
                    f"SKI {ski.hex()}"
                ) from None
        if not key.is_private:
            raise CustodyError("custody: no private key for ski")
        return self._host.sign(key, digest)

    def _get_key(self, body: bytes, stream) -> bytes:
        rest = self._auth(body)
        if len(rest) != 32:
            raise CustodyError("custody: want ski(32)")
        with self._lock:
            try:
                key = self._host.get_key(rest)
            except KeyError:
                raise CustodyError(
                    f"{ERR_UNKNOWN_SKI}: daemon holds no key for "
                    f"SKI {rest.hex()}"
                ) from None
        return key.public_key().raw() if key.is_private else key.raw()


class CustodyCSP(CSP):
    """Peer-side provider over a KeyCustodyServer.  The reference
    pkcs11 split: private-key operations remote, everything else on the
    local provider (`verify_csp`: `CUDACSP()` on the card by default,
    which raises where there is none, so custody-signed lanes verify on
    the card unless the caller names another provider)."""

    def __init__(self, endpoint: tuple[str, int], token: bytes,
                 verify_csp: CSP | None = None, tls=None,
                 timeout: float = 10.0):
        from fabric_tpu_torch.comm import RPCClient

        self._token = token
        if verify_csp is None:
            from fabric_tpu_torch.csp.cuda.provider import CUDACSP

            verify_csp = CUDACSP()
        self._local = verify_csp
        # one client for the provider's lifetime: RPCClient opens a
        # connection per call anyway, but constructing it per sign
        # would rebuild the TLS context (cert/CA parse) on the hot path
        self._client = RPCClient(*endpoint, timeout=timeout, tls=tls)
        # key cache: ski -> CustodyKeyHandle or locally-imported Key
        # (the session-pool analogue — one daemon round-trip per key,
        # not per use)
        self._handles: dict[bytes, Key] = {}
        self._lock = threading.Lock()

    def _call(self, method: str, body: bytes) -> bytes:
        return self._client.call(method, self._token + body)

    @staticmethod
    def _parse_pub(raw: bytes) -> P256PublicKey:
        try:
            return P256PublicKey.from_raw(raw)
        except ValueError:
            raise CustodyError("custody: malformed public point") from None

    # -- key management: remote -------------------------------------------

    def key_gen(self) -> CustodyKeyHandle:
        out = self._call("custody.KeyGen", b"")
        if len(out) != 32 + 65:
            raise CustodyError("custody: malformed keygen reply")
        handle = CustodyKeyHandle(out[:32], self._parse_pub(out[32:]))
        with self._lock:
            self._handles[handle.ski()] = handle
        return handle

    def key_import(self, raw: bytes, private: bool = False) -> Key:
        if private:
            # importing private material would move a secret THROUGH
            # the peer process — the custody boundary forbids it, like
            # an HSM with non-extractable/non-importable keys
            raise CustodyError(
                "custody provider cannot import private keys"
            )
        return self._local.key_import(raw, private=False)

    def get_key(self, ski: bytes) -> Key:
        with self._lock:
            h = self._handles.get(ski)
        if h is not None:
            return h
        # custody FIRST: a custody-held SKI must come back as a
        # SIGNABLE handle even when its public half was also imported
        # locally (e.g. an MSP deriving the SKI from a certificate) —
        # the local keystore serves only SKIs the daemon doesn't hold.
        # Only the daemon's STRUCTURED unknown-SKI answer (the
        # ERR_UNKNOWN_SKI sentinel it prefixes) falls through;
        # transport failures and malformed replies PROPAGATE (a daemon
        # outage must not silently demote a signable key to a public
        # one, and no rewording of the daemon's prose can masquerade
        # as unknown-SKI).
        from fabric_tpu_torch.comm.rpc import RPCError

        try:
            pub = self._parse_pub(self._call("custody.GetKey", ski))
            key: Key = CustodyKeyHandle(ski, pub)
        except RPCError as exc:
            if not str(exc).startswith(ERR_UNKNOWN_SKI):
                raise
            key = self._local.get_key(ski)  # KeyError if absent
        with self._lock:
            # positive AND local-fallback results cache: a locally
            # imported key must not pay a daemon round trip per lookup
            self._handles[ski] = key
        return key

    def sign(self, key: Key, digest: bytes) -> bytes:
        if isinstance(key, CustodyKeyHandle):
            return self._call("custody.Sign", key.ski() + digest)
        raise CustodyError(
            "custody provider signs only with custody-held keys"
        )

    # -- hash / verify: local (the pkcs11 split) -----------------------------

    def hash(self, msg: bytes) -> bytes:
        return self._local.hash(msg)

    def hash_batch(self, msgs) -> list[bytes]:
        return self._local.hash_batch(msgs)

    def verify(self, key: Key, signature: bytes, digest: bytes) -> bool:
        if isinstance(key, CustodyKeyHandle):
            key = key.public_key()
        return self._local.verify(key, signature, digest)

    def verify_batch(self, items) -> list[bool]:
        return self._local.verify_batch(self._publicized(items))

    def verify_batch_async(self, items):
        return self._local.verify_batch_async(self._publicized(items))

    @staticmethod
    def _publicized(items):
        return [
            VerifyBatchItem(it.key.public_key(), it.digest, it.signature)
            if isinstance(it.key, CustodyKeyHandle)
            else it
            for it in items
        ]


def load_token(path: str) -> bytes:
    """Read the shared custody token (the PIN file analogue); trailing
    newlines are tolerated so `echo secret > file` provisioning works."""
    with open(path, "rb") as f:
        token = f.read().strip()
    if not token:
        raise CustodyError(f"custody token file {path!r} is empty")
    return token


__all__ = [
    "KeyCustodyServer",
    "CustodyCSP",
    "CustodyKeyHandle",
    "CustodyError",
    "ERR_UNKNOWN_SKI",
    "load_token",
]
