"""Idemix anonymous credentials on BN254: the port's copy of
`fabric_tpu/idemix/` (pure Python, no C++ backend).

- bn254:      field towers Fp/Fp2/Fp6/Fp12, G1/G2, optimal-ate pairing
- schnorr:    multi-base Schnorr proofs over G1
- issuer:     issuer key generation with proof of well-formedness
- credential: credential request, issuance and verification
- signature:  presentation proofs with selective disclosure and
              pseudonyms, single and batched verification; its
              `verify_batch_device` runs the Schnorr commitments on the card
              (`fabric_tpu_torch/csp/cuda/bn254_batch.py`)
"""
