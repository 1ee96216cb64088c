"""Host SHA-256 for the port's control plane (the port's copy of
`fabric_tpu/common/hashing.py`): tx ids, proposal hashes, block hashes and
identity ids.  The JAX package can route this seam through a CSP; the
port's callers that batch hash through `CUDACSP.hash_batch` directly, so
here it is hashlib."""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


__all__ = ["sha256"]
