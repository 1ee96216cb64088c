"""Carry state across from the JAX package: its constants, its packed
verify inputs, its idemix issuer keys and signatures, and its BN254
tables, in the port's layout.

The port never imports the JAX package; these functions take its plain
numpy outputs, dicts or bytes, so that a test can feed both packages the
same state.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.csp.cuda import fp254, p256_kernel
from fabric_tpu_torch.csp.cuda.limbs import int_to_words, limbs_to_int
from fabric_tpu_torch.idemix.issuer import IssuerPublicKey
from fabric_tpu_torch.idemix.signature import Signature

# The JAX package's BN254 Montgomery radix: 17 16-bit limbs
_JAX_R = 1 << 272


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
    `native.marshal_batch` -> the port's kernel tensors on `device`; a
    key table gets its quarter tables (`p256_kernel.key_quarter_tables`),
    which the JAX package does not build."""
    if "ktabx" in packed and "qtab" not in packed:
        packed = {**packed, **p256_kernel.key_quarter_tables(
            packed["ktabx"], packed["ktaby"])}
    return p256_kernel.upload(packed, torch.device(device))


def ipk_from_jax(d: dict) -> IssuerPublicKey:
    """`IssuerPublicKey.to_dict()` of the JAX package -> the port's key
    (decoded, and checked as the port decodes any key)."""
    return IssuerPublicKey.from_dict(d)


def signature_from_jax(raw: bytes) -> Signature:
    """`Signature.to_bytes()` of the JAX package -> the port's signature."""
    return Signature.from_bytes(raw)


def _jax_mont_to_port(limbs) -> int:
    """A JAX-package Montgomery residue (16-bit limbs, R = 2^272) -> the
    port's (R = 2^256): x 2^272 -> x 2^256 mod p."""
    v = limbs_to_int(np.asarray(limbs).reshape(-1))
    return v * pow(_JAX_R, -1, fp254.P) % fp254.P * fp254.R % fp254.P


def bn254_shared_from_jax(sx, sy, sz, sinf) -> dict:
    """`pallas_bn254._shared_limbs(...)` ((16 S, 17) limb arrays x, y, z
    and (16 S, 1) inf) -> the port's `bn254_kernel.shared_table` dict,
    which is window 0 of the port's comb (`bn254_batch.shared_comb`).
    The port's tables are affine: z must be the JAX Montgomery 1 on every
    finite entry."""
    inf = np.asarray(sinf).reshape(-1).astype(np.uint32)
    one_jax = _JAX_R % fp254.P
    xs, ys = [], []
    for x, y, z, i in zip(sx, sy, sz, inf):
        if not i and limbs_to_int(np.asarray(z)) != one_jax:
            raise ValueError("a finite shared entry has z != 1")
        xs.append(0 if i else _jax_mont_to_port(x))
        ys.append(0 if i else _jax_mont_to_port(y))
    xy = np.concatenate(
        [fp254.words_from_ints(xs).T, fp254.words_from_ints(ys).T], axis=1
    )
    return {"xy": np.ascontiguousarray(xy), "inf": inf}


def bn254_consts_from_jax(c: dict) -> dict:
    """`pallas_bn254._consts()` -> the dict of `bn254_kernel.consts()`:
    p, -p^-1 mod 2^256 (whose low word is the kernel's CIOS constant),
    the Montgomery 1 and 2^256 mod p, as (8,) words.  The JAX package's
    relaxed subtraction constant `sub_c` belongs to its limb form and has
    no counterpart."""
    p = limbs_to_int(np.asarray(c["m"]).reshape(-1))
    mp = limbs_to_int(np.asarray(c["mp"]).reshape(-1))  # mod 2^272
    one = limbs_to_int(np.asarray(c["one"]).reshape(-1))  # 2^272 mod p
    r256 = limbs_to_int(np.asarray(c["r256"]).reshape(-1))
    return dict(
        p=int_to_words(p),
        p_inv=int_to_words(mp % fp254.R),
        one=int_to_words(one * pow(1 << 16, -1, p) % p),
        r256=int_to_words(r256),
    )


__all__ = [
    "consts_from_jax",
    "packed_from_jax",
    "ipk_from_jax",
    "signature_from_jax",
    "bn254_shared_from_jax",
    "bn254_consts_from_jax",
]
