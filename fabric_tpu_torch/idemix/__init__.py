"""Idemix anonymous credentials on BN254: the port's copy of
`fabric_tpu/idemix/` (pure Python over the port's C++ library).

- bn254:      field towers Fp/Fp2/Fp6/Fp12, G1/G2, optimal-ate pairing
- schnorr:    multi-base Schnorr proofs over G1
- issuer:     issuer key generation with proof of well-formedness
- credential: credential request, issuance and verification
- signature:  presentation proofs with selective disclosure and
              pseudonyms, single and batched verification; its
              `verify_batch_device` runs the Schnorr commitments on the card
              (`fabric_tpu_torch/csp/cuda/bn254_batch.py`)
- nymsignature: pseudonym-only signatures
- weakbb:     weak Boneh-Boyen signatures
- revocation: the epoch CRI, signed with the port's P-384
              (`fabric_tpu_torch/csp/hostref384.py`)

The names below are the JAX package's exports, loaded at first use: the
card's modules (`csp/cuda`) import `idemix.bn254`, and `signature` imports
them back.
"""

import importlib

_EXPORTS = {
    "GROUP_ORDER": "bn254", "G1": "bn254", "G2": "bn254", "g1_gen": "bn254",
    "g2_gen": "bn254", "pairing": "bn254", "rand_zr": "bn254",
    "IssuerKey": "issuer", "IssuerPublicKey": "issuer",
    "Credential": "credential", "CredRequest": "credential",
    "new_credential": "credential", "new_cred_request": "credential",
    "Signature": "signature", "new_signature": "signature",
    "NymSignature": "nymsignature", "new_nym_signature": "nymsignature",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
