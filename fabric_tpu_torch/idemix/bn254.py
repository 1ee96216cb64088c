"""BN254 pairing arithmetic, pure Python (the port's copy of
`fabric_tpu/idemix/bn254.py`).

The same primitive set as the JAX package's module — G1/G2 group ops,
scalar multiplication, and the optimal-ate pairing e: G1 x G2 -> GT — on
the standard BN254 curve (aka alt_bn128), from the curve equations.  As
in the JAX package, G1 multiplications, MSMs and pairing checks go to the
C++ host library (`fabric_tpu_torch.native`: bn254.cc, pairing.cc); the
pure-Python ladders and towers stay, under the JAX package's names
(`_g1_mul_py`, `_g1_msm_py`, `multi_pairing`), as their parity oracles.
Unlike the JAX package there is no fallback to them: where the library
cannot build, those functions raise.

    Fp:   y^2 = x^3 + 3,              p = 36u^4 + 36u^3 + 24u^2 + 6u + 1
    Fp2:  y^2 = x^3 + 3/(9+i)         (D-type sextic twist)
    u = 4965661367192848881

Tower: Fp2 = Fp[i]/(i^2+1), Fp6 = Fp2[v]/(v^3-xi) with xi = 9+i,
Fp12 = Fp6[w]/(w^2-v).  The Miller loop runs in affine coordinates over
Fp12 (clarity over speed: this is the host parity oracle; the batched
Schnorr commitments on the card live in fabric_tpu_torch/csp/cuda/).

Elements of Fp2/Fp6/Fp12 are nested tuples of ints; points are affine
(x, y) tuples with None for the identity.
"""

from __future__ import annotations

import hashlib
import secrets

from fabric_tpu_torch import native

# --- BN254 parameters -------------------------------------------------------

U = 4965661367192848881  # BN parameter
P = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
R = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1  # group order
GROUP_ORDER = R
ATE_LOOP = 6 * U + 2

B = 3  # curve coefficient: y^2 = x^3 + 3

# G1 generator.
G1_GEN = (1, 2)

# G2 generator on the twist (canonical alt_bn128 generator), coords in Fp2
# as (c0, c1) meaning c0 + c1*i.
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# --- Fp ---------------------------------------------------------------------


def _inv(a: int) -> int:
    return pow(a, -1, P)


# --- Fp2 = Fp[i]/(i^2 + 1) --------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (9, 1)  # nonresidue for the Fp6 tower and the twist divisor


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i) = a0b0 - a1b1 + (a0b1 + a1b0) i
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sq(a):
    # (a0 + a1 i)^2 = (a0+a1)(a0-a1) + 2 a0 a1 i
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_inv(a):
    # 1/(a0 + a1 i) = (a0 - a1 i)/(a0^2 + a1^2)
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, -a[1] * d % P)


def fp2_conj(a):
    return (a[0], -a[1] % P)


def fp2_pow(a, e: int):
    out = FP2_ONE
    base = a
    while e:
        if e & 1:
            out = fp2_mul(out, base)
        base = fp2_sq(base)
        e >>= 1
    return out


# --- Fp6 = Fp2[v]/(v^3 - xi) ------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_xi(a):
    # a * (9 + i)
    return ((9 * a[0] - a[1]) % P, (9 * a[1] + a[0]) % P)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(
        t0,
        _mul_xi(
            fp2_sub(
                fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2)
            )
        ),
    )
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
        _mul_xi(t2),
    )
    c2 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)),
        t1,
    )
    return (c0, c1, c2)


def fp6_sq(a):
    return fp6_mul(a, a)


def fp6_mul_fp2(a, k):
    return (fp2_mul(a[0], k), fp2_mul(a[1], k), fp2_mul(a[2], k))


def fp6_mul_v(a):
    # a * v: (a0 + a1 v + a2 v^2) v = a2 xi + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sq(a0), _mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(_mul_xi(fp2_sq(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sq(a1), fp2_mul(a0, a2))
    t = fp2_inv(
        fp2_add(
            fp2_mul(a0, c0),
            _mul_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
        )
    )
    return (fp2_mul(c0, t), fp2_mul(c1, t), fp2_mul(c2, t))


# --- Fp12 = Fp6[w]/(w^2 - v) ------------------------------------------------

FP12_ONE = (FP6_ONE, FP6_ZERO)
FP12_ZERO = (FP6_ZERO, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_v(t1))
    c1 = fp6_sub(
        fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1)
    )
    return (c0, c1)


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_inv(a):
    a0, a1 = a
    t = fp6_inv(fp6_sub(fp6_sq(a0), fp6_mul_v(fp6_sq(a1))))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_pow(a, e: int):
    if e < 0:
        a = fp12_inv(a)
        e = -e
    out = FP12_ONE
    base = a
    while e:
        if e & 1:
            out = fp12_mul(out, base)
        base = fp12_sq(base)
        e >>= 1
    return out


# Frobenius on Fp12: x -> x^p, computed componentwise via conjugation in Fp2
# and multiplication by precomputed constants gamma_i = xi^{i(p-1)/6}.
_GAMMA = [fp2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def fp12_frobenius(a):
    (a0, a1, a2), (b0, b1, b2) = a
    c0 = (
        fp2_conj(a0),
        fp2_mul(fp2_conj(a1), _GAMMA[2]),
        fp2_mul(fp2_conj(a2), _GAMMA[4]),
    )
    c1 = (
        fp2_mul(fp2_conj(b0), _GAMMA[1]),
        fp2_mul(fp2_conj(b1), _GAMMA[3]),
        fp2_mul(fp2_conj(b2), _GAMMA[5]),
    )
    return (c0, c1)


def fp12_frobenius_n(a, n: int):
    for _ in range(n):
        a = fp12_frobenius(a)
    return a


# --- G1 (affine over Fp) ----------------------------------------------------


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(p1):
    if p1 is None:
        return None
    return (p1[0], -p1[1] % P)


def _g1_mul_py(p1, k: int):
    """Pure-Python affine double-and-add: the parity oracle of the native
    backend."""
    if p1 is None:
        return None
    k %= R
    out = None
    add = p1
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


def _g1_msm_py(terms):
    """Pure-Python MSM, one affine ladder per term: the parity oracle of
    `g1_msm`."""
    out = None
    for pt, k in terms:
        if pt is None:
            continue
        out = g1_add(out, _g1_mul_py(pt, k))
    return out


def g1_mul(p1, k: int):
    if p1 is None:
        return None
    return native.bn254_mul_many([p1], [k])[0]


def g1_mul_many(points, scalars):
    """Independent scalars[i]*points[i] with one shared field inversion."""
    return native.bn254_mul_many(points, scalars)


def g1_msm(terms):
    """sum of scalar*point over G1: [(point|None, scalar)] -> point|None.

    The verification hot path on the host (Schnorr commitment
    recomputation, RLC accumulation in batched verify), served by the
    native Montgomery implementation (native/bn254.cc)."""
    return native.bn254_msm([t[0] for t in terms], [t[1] for t in terms])


# --- G2 (affine over Fp2, on the twist) -------------------------------------

_TWIST_B = fp2_mul((B, 0), fp2_inv(XI))  # b' = 3/(9+i)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fp2_sq(y)
    rhs = fp2_add(fp2_mul(fp2_sq(x), x), _TWIST_B)
    return lhs == rhs


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        lam = fp2_mul(
            fp2_scalar(fp2_sq(x1), 3), fp2_inv(fp2_scalar(y1, 2))
        )
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sq(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p1):
    if p1 is None:
        return None
    return (p1[0], fp2_neg(p1[1]))


def g2_mul(p1, k: int):
    k %= R
    out = None
    add = p1
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


# --- Pairing ----------------------------------------------------------------
#
# Optimal ate: e(P, Q) = f_{6u+2, Q'}(P) * l_{T,pi(Q')}(P) * l_{T',-pi^2(Q')}(P)
# raised to (p^12-1)/r, with Q' the image of Q in Fp12 via the twist
# embedding psi(x, y) = (x w^2, y w^3) where w^6 = xi.


def _embed_g2(pt):
    """Map a twist point into Fp12 affine coordinates."""
    x, y = pt
    # x * w^2 = x * v  -> Fp6 coeff vector (0, x, 0), Fp12 c0 part.
    ex = ((FP2_ZERO, x, FP2_ZERO), FP6_ZERO)
    # y * w^3 = y * v * w -> Fp12 c1 part with Fp6 coeff (0, y, 0).
    ey = (FP6_ZERO, (FP2_ZERO, y, FP2_ZERO))
    return (ex, ey)


def _fp12_from_fp(a: int):
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _e12_add(p1, p2):
    """Affine addition over the Fp12 curve y^2 = x^3 + 3 (no twist)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp12_add(y1, y2) == FP12_ZERO:
            return None
        lam = fp12_mul(
            fp12_mul(fp12_sq(x1), _fp12_from_fp(3)),
            fp12_inv(fp12_mul(y1, _fp12_from_fp(2))),
        )
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sq(lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(t, q, p_xy):
    """Evaluate the line through t and q (tangent if t == q) at P in Fp.

    Returns (line_value, t + q).
    """
    xp, yp = p_xy
    xp12 = _fp12_from_fp(xp)
    yp12 = _fp12_from_fp(yp)
    if t is None or q is None:
        nonzero = t if t is not None else q
        if nonzero is None:
            return FP12_ONE, None
        return fp12_sub(xp12, nonzero[0]), nonzero
    x1, y1 = t
    if x1 == q[0] and y1 != q[1]:
        # Vertical line x - x1 = 0.
        return fp12_sub(xp12, x1), None
    if t == q:
        lam = fp12_mul(
            fp12_mul(fp12_sq(x1), _fp12_from_fp(3)),
            fp12_inv(fp12_mul(y1, _fp12_from_fp(2))),
        )
    else:
        lam = fp12_mul(
            fp12_sub(q[1], y1), fp12_inv(fp12_sub(q[0], x1))
        )
    # l(P) = yP - y1 - lam (xP - x1)
    val = fp12_sub(
        fp12_sub(yp12, y1), fp12_mul(lam, fp12_sub(xp12, x1))
    )
    return val, _e12_add(t, q)


def miller_loop(p_xy, q_twist):
    """f_{6u+2, Q}(P) with the two frobenius correction lines (unreduced)."""
    if p_xy is None or q_twist is None:
        return FP12_ONE
    q12 = _embed_g2(q_twist)
    qx, qy = q12
    t = q12
    f = FP12_ONE
    bits = bin(ATE_LOOP)[3:]  # skip leading 1
    for bit in bits:
        line, t = _line(t, t, p_xy)
        f = fp12_mul(fp12_sq(f), line)
        if bit == "1":
            line, t = _line(t, q12, p_xy)
            f = fp12_mul(f, line)
    # Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q).
    q1 = (fp12_frobenius(qx), fp12_frobenius(qy))
    q2 = (fp12_frobenius_n(qx, 2), fp12_frobenius_n(qy, 2))
    q2 = (q2[0], fp12_sub(FP12_ZERO, q2[1]))
    line, t = _line(t, q1, p_xy)
    f = fp12_mul(f, line)
    line, t = _line(t, q2, p_xy)
    f = fp12_mul(f, line)
    return f


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    # Easy part: f^((p^6-1)(p^2+1)).
    f = fp12_mul(fp12_conj(f), fp12_inv(f))  # f^(p^6 - 1)
    f = fp12_mul(fp12_frobenius_n(f, 2), f)  # ^(p^2 + 1)
    # Hard part: ^((p^4 - p^2 + 1)/r) by plain square-and-multiply (host
    # oracle favors obviousness).
    return fp12_pow(f, _HARD_EXP)


def pairing(p_g1, q_g2):
    """Reduced optimal-ate pairing e(P, Q) in GT (an Fp12 element)."""
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i): shares one final exponentiation across the
    product — the algebraic identity behind batched idemix verification
    (reference calls FP256BN.Ate twice per signature,
    idemix/signature.go:290-291; a batch shares the expensive tail)."""
    f = FP12_ONE
    for p_g1, q_g2 in pairs:
        f = fp12_mul(f, miller_loop(p_g1, q_g2))
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """prod_i e(P_i, Q_i) == 1 — the only form idemix consumes
    (credential ver, signature checks): the native Miller loops with one
    shared final exponentiation (native/pairing.cc); `multi_pairing` is
    its oracle."""
    return native.bn254_pairing_check(pairs)


# --- Group element serialization & hashing ----------------------------------


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(raw: bytes):
    if len(raw) != 64:
        raise ValueError("bad G1 encoding length")
    if raw == b"\x00" * 64:
        return None
    pt = (int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big"))
    # Canonical coordinates only: a coordinate >= P would give a second
    # byte-encoding of the same point and break Fiat-Shamir hash bindings.
    if pt[0] >= P or pt[1] >= P:
        raise ValueError("G1 coordinate out of range")
    if not g1_is_on_curve(pt):
        raise ValueError("G1 point not on curve")
    # BN254 G1 has cofactor 1: on-curve implies the order-r subgroup.
    return pt


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(c.to_bytes(32, "big") for c in (x0, x1, y0, y1))


def g2_from_bytes(raw: bytes):
    if len(raw) != 128:
        raise ValueError("bad G2 encoding length")
    if raw == b"\x00" * 128:
        return None
    c = [int.from_bytes(raw[i : i + 32], "big") for i in range(0, 128, 32)]
    if any(x >= P for x in c):
        raise ValueError("G2 coordinate out of range")
    pt = ((c[0], c[1]), (c[2], c[3]))
    if not g2_is_on_curve(pt):
        raise ValueError("G2 point not on curve")
    # The twist has a large cofactor: reject points outside the order-r
    # subgroup (small-subgroup / invalid-W attacks on issuer keys).
    if g2_mul(pt, R) is not None:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


def gt_to_bytes(f) -> bytes:
    out = []
    for c6 in f:
        for c2 in c6:
            for c in c2:
                out.append(c.to_bytes(32, "big"))
    return b"".join(out)


def g1_gen():
    return G1_GEN


def g2_gen():
    return G2_GEN


def rand_zr(rng=None) -> int:
    """Uniform scalar in [1, r) (reference idemix/util.go RandModOrder)."""
    if rng is not None:
        return rng.randrange(1, R)
    return secrets.randbelow(R - 1) + 1


def hash_to_zr(*chunks: bytes) -> int:
    """Fiat-Shamir hash to a scalar (reference idemix/util.go HashModOrder)."""
    # fabriclint: allow[csp-seam] BN254 hash-to-field is idemix's own
    # crypto domain (dedicated card kernels), outside the P-256 seam
    h = hashlib.sha256()
    for c in chunks:
        h.update(len(c).to_bytes(8, "big"))
        h.update(c)
    return int.from_bytes(h.digest(), "big") % R


class G1:
    """Namespace handle for G1 ops (functional style preferred internally)."""

    add = staticmethod(g1_add)
    mul = staticmethod(g1_mul)
    neg = staticmethod(g1_neg)
    gen = staticmethod(g1_gen)
    to_bytes = staticmethod(g1_to_bytes)
    from_bytes = staticmethod(g1_from_bytes)


class G2:
    add = staticmethod(g2_add)
    mul = staticmethod(g2_mul)
    neg = staticmethod(g2_neg)
    gen = staticmethod(g2_gen)
    to_bytes = staticmethod(g2_to_bytes)
    from_bytes = staticmethod(g2_from_bytes)
