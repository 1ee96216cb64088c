"""X.509 identities (the port's copy of `fabric_tpu/msp/identity.py`).

`verification_item` defers a signature check to the block's batched
verify instead of verifying one at a time."""

from __future__ import annotations

from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.protos.msp import SerializedIdentity


class Identity:
    """A deserialized, not necessarily valid identity of an MSP."""

    def __init__(self, mspid: str, cert: x509.Certificate):
        self.mspid = mspid
        self.cert = cert
        self.public_key = cert.public_key
        # IdentityIdentifier: (mspid, hash of the raw certificate)
        self.id = (mspid, sha256(cert.der).hex())
        self.ous = cert.ous
        self._serialized = None

    def serialize(self) -> bytes:
        """SerializedIdentity with the certificate re-encoded as PEM, byte
        for byte what the JAX package writes (policies and caches key on
        these bytes)."""
        if self._serialized is None:
            self._serialized = SerializedIdentity(
                mspid=self.mspid, id_bytes=self.cert.pem()).encode()
        return self._serialized

    def expires_at(self):
        return self.cert.not_valid_after

    def verification_item(self, msg: bytes, sig: bytes) -> VerifyBatchItem:
        return VerifyBatchItem(self.public_key, sha256(msg), sig)


class SigningIdentity(Identity):
    """An identity with its private key; signs low-S through `hostref`."""

    def __init__(self, mspid: str, cert: x509.Certificate, private_key,
                 rng=None):
        super().__init__(mspid, cert)
        self._key = private_key
        self._rng = rng

    def sign(self, msg: bytes) -> bytes:
        return hostref.sign(self._key, sha256(msg), self._rng)

    @classmethod
    def from_pem(cls, mspid: str, cert_pem: bytes, key_pem: bytes, rng=None):
        """From a certificate PEM and an unencrypted PKCS #8 key PEM, as
        `CertKeyPair.cert_pem` / `key_pem` write them."""
        cert = x509.load_pem_certificates(cert_pem)[0]
        return cls(mspid, cert, x509.load_pem_private_key(key_pem), rng)


__all__ = ["Identity", "SigningIdentity"]
