"""The host-side CSP hash seam (the port's copy of
`fabric_tpu/common/hashing.py`): tx ids, proposal hashes, block hashes and
identity ids.  The CSP factory (`csp.factory`) installs the process's
provider here with `set_hash_backend`; until then hashlib gives the same
digests.  `sha256` is one call of the backend's `hash` (`CUDACSP.hash` is
hashlib: no span, no lock, no device work), `sha256_many` one call of its
`hash_batch` (B4 on the card for a batch wide enough).

Standard library only: the dependency points csp -> common.hashing, never
the reverse."""

from __future__ import annotations

import hashlib

_HASH_BACKEND = None


def set_hash_backend(csp) -> None:
    """Install the process CSP as the seam's backend (None: hashlib).

    The seam feeds consensus-critical digests, so a backend whose output
    is not byte-identical SHA-256 would fork this peer from the others:
    it is probed once here and refused.  The probes are tiny, so a
    batched provider answers them on the host."""
    if csp is not None:
        probe = b"fabric-tpu hash seam probe"
        want = hashlib.sha256(probe).digest()
        if csp.hash(probe) != want or list(
            csp.hash_batch([probe, b""])
        ) != [want, hashlib.sha256(b"").digest()]:
            raise ValueError(
                f"refusing hash backend {type(csp).__name__}: its "
                "hash/hash_batch is not byte-identical SHA-256 — "
                "installing it would change tx ids and block hashes "
                "on this peer only"
            )
    global _HASH_BACKEND
    _HASH_BACKEND = csp


def sha256(data: bytes) -> bytes:
    """SHA-256 through the seam: the installed provider's `hash`, else
    hashlib (identical digests)."""
    backend = _HASH_BACKEND
    if backend is not None:
        return backend.hash(data)
    return hashlib.sha256(data).digest()


def sha256_many(blobs) -> list[bytes]:
    """Batch SHA-256 through the seam (the provider's `hash_batch`: one
    call); hashlib without a provider."""
    blobs = list(blobs)
    backend = _HASH_BACKEND
    if backend is not None:
        return list(backend.hash_batch(blobs))
    return [hashlib.sha256(b).digest() for b in blobs]


__all__ = ["set_hash_backend", "sha256", "sha256_many"]
