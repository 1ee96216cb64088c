"""Carry state across from the JAX package: its constants and its packed
verify inputs, in the port's layout.

The port never imports the JAX package; these functions take its plain
numpy outputs, so that a test can feed both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.csp.cuda import p256_kernel
from fabric_tpu_torch.csp.cuda.limbs import int_to_words, limbs_to_int


def _limbs_to_words(limbs) -> np.ndarray:
    """16-bit limb vector (any width, value < 2^256) -> (8,) words."""
    return int_to_words(limbs_to_int(np.asarray(limbs).reshape(-1)))


def consts_from_jax(c: dict) -> dict:
    """`pallas_ec._consts()` -> the dict of `p256_kernel.consts()`.

    The word constants come from the 16-bit limb ones (`p_limbs`,
    `n_limbs` (17, 1); `gx`, `gy` (16, 17, 1); `ginf` (16, 1)); the
    Solinas matrix is the (16, 34) float `solmat` without its two
    columns for product limbs 32 and 33, which must be zero."""
    solmat = np.asarray(c["solmat"])
    if np.any(solmat[:, 32:]):
        raise ValueError("solmat has weights beyond product limb 31")
    return dict(
        p=_limbs_to_words(c["p_limbs"]),
        n=_limbs_to_words(c["n_limbs"]),
        gx=np.stack([_limbs_to_words(row) for row in c["gx"]]),
        gy=np.stack([_limbs_to_words(row) for row in c["gy"]]),
        ginf=np.asarray(c["ginf"]).reshape(-1).astype(bool),
        solmat=solmat[:, :32].astype(np.int64),
    )


def packed_from_jax(packed: dict, device) -> dict:
    """A packed numpy dict of `pallas_ec.prepare_packed`, `dedup_keys` or
    `native.marshal_batch` -> the port's kernel tensors on `device`."""
    return p256_kernel.upload(packed, torch.device(device))


__all__ = ["consts_from_jax", "packed_from_jax"]
