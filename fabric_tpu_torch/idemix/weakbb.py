"""Weak Boneh-Boyen signatures (reference idemix/weakbb.go; the port's copy
of `fabric_tpu/idemix/weakbb.py`).

For the revocation machinery: sig = g1^{1/(x+m)}, verified by
e(sig, W * g2^m) == e(g1, g2) through the C++ library's pairing check.
"Weak" because the message must be chosen independently of the key, as
a revocation handle is.
"""

from __future__ import annotations

from fabric_tpu_torch.idemix import bn254 as bn


def wbb_key_gen(rng=None) -> tuple[int, tuple]:
    sk = bn.rand_zr(rng)
    return sk, bn.g2_mul(bn.G2_GEN, sk)


def wbb_sign(sk: int, m: int) -> tuple:
    exp = pow((sk + m) % bn.R, -1, bn.R)
    return bn.g1_mul(bn.G1_GEN, exp)


def wbb_verify(pk: tuple, sig: tuple, m: int) -> bool:
    if sig is None or not bn.g1_is_on_curve(sig):
        return False
    lhs_g2 = bn.g2_add(pk, bn.g2_mul(bn.G2_GEN, m))
    return bn.pairing_check(
        [(sig, lhs_g2), (bn.g1_neg(bn.G1_GEN), bn.G2_GEN)]
    )


__all__ = ["wbb_key_gen", "wbb_sign", "wbb_verify"]
