"""Credential revocation information (reference idemix/revocation.go; the
port's copy of `fabric_tpu/idemix/revocation.py`).

The only algorithm, as in the reference snapshot, is ALG_NO_REVOCATION:
the CRI is an epoch counter and an epoch key, signed by the revocation
authority with ECDSA over P-384 and SHA-256.  Verifiers check the CRI's
signature; proofs of non-revocation are vacuous under NO_REVOCATION.  The
JAX package signs through `cryptography`; the port through its own
P-384 (`csp/hostref384.py`), whose verdicts and DER match it, so each
package verifies the other's CRI.
"""

from __future__ import annotations

import dataclasses
import json

from fabric_tpu_torch.csp import hostref384
from fabric_tpu_torch.idemix import bn254 as bn

ALG_NO_REVOCATION = 0


def generate_long_term_revocation_key(rng=None) -> hostref384.P384PrivateKey:
    """The revocation authority's P-384 key (reference revocation.go
    GenerateLongTermRevocationKey)."""
    return hostref384.key_gen(rng)


@dataclasses.dataclass
class CredentialRevocationInformation:
    epoch: int
    revocation_alg: int
    epoch_pk: bytes  # serialized G2 point (epoch key)
    epoch_pk_sig: bytes  # RA signature over (epoch, alg, epoch_pk)

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "epoch": self.epoch,
                "alg": self.revocation_alg,
                "epoch_pk": self.epoch_pk.hex(),
                "sig": self.epoch_pk_sig.hex(),
            }
        ).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "CredentialRevocationInformation":
        d = json.loads(raw)
        return cls(
            epoch=d["epoch"],
            revocation_alg=d["alg"],
            epoch_pk=bytes.fromhex(d["epoch_pk"]),
            epoch_pk_sig=bytes.fromhex(d["sig"]),
        )


def _cri_digest_material(epoch: int, alg: int, epoch_pk: bytes) -> bytes:
    return b"idemix-cri" + epoch.to_bytes(8, "big") + bytes([alg]) + epoch_pk


def create_cri(
    ra_key: hostref384.P384PrivateKey,
    epoch: int,
    alg: int = ALG_NO_REVOCATION,
    rng=None,
) -> CredentialRevocationInformation:
    """Reference revocation.go CreateCRI."""
    if alg != ALG_NO_REVOCATION:
        raise NotImplementedError("only ALG_NO_REVOCATION is supported")
    epoch_sk = bn.rand_zr(rng)
    epoch_pk = bn.g2_to_bytes(bn.g2_mul(bn.G2_GEN, epoch_sk))
    sig = hostref384.sign(ra_key, _cri_digest_material(epoch, alg, epoch_pk))
    return CredentialRevocationInformation(
        epoch=epoch, revocation_alg=alg, epoch_pk=epoch_pk, epoch_pk_sig=sig
    )


def verify_epoch_pk(ra_pub, cri: CredentialRevocationInformation) -> bool:
    """Reference revocation.go VerifyEpochPK; `ra_pub` is the authority's
    point (x, y)."""
    try:
        if not hostref384.verify(
            ra_pub, cri.epoch_pk_sig,
            _cri_digest_material(cri.epoch, cri.revocation_alg, cri.epoch_pk),
        ):
            return False
        bn.g2_from_bytes(cri.epoch_pk)
        return True
    except ValueError:
        return False


__all__ = [
    "ALG_NO_REVOCATION",
    "CredentialRevocationInformation",
    "generate_long_term_revocation_key",
    "create_cri",
    "verify_epoch_pk",
]
