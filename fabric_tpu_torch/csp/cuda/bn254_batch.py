"""Batched idemix Schnorr recomputation on the card (BN254 G1).

Counterpart of `fabric_tpu/csp/tpu/bn254_batch.py`.  Per signature the
verifier re-derives three commitments (`signature._relations` +
`schnorr.recompute_commitments`, with the targets flattened into the
MSMs: y1^(-c) = a_bar^(-c) b_prime^c, y2^(-c) = G1^c prod h_attrs[i]^(c m_i)):

  T1 = a_bar^{-c} . b_prime^{c} . a_prime^{z_neg_e} . h_rand^{z_r2}
  T2 = G1^{c} . h_sk^{z_sk} . h_rand^{z_s'} . prod_i h_attrs[i]^{s_i}
         . b_prime^{z_neg_r3}         s_i = c m_i (disclosed) | z_mi (hidden)
  T3 = nym^{-c} . h_sk^{z_sk} . h_rand^{z_r_nym}

One call of the hand-written kernel (`bn254_kernel.commitments`)
computes every signature's three MSMs, the shared bases through a
fixed-base comb built once per issuer key (`shared_comb`); the Jacobian
results are normalised on the host with one batched inversion.  There is
no other engine and no fallback: a device error propagates.  The TPU's bucket
padding is gone (a CUDA kernel masks its own ragged edge); batches above
`MAX_LANES` go in chunks.
"""

from __future__ import annotations

import functools

import torch

from fabric_tpu_torch.csp.cuda import bn254_kernel
from fabric_tpu_torch.csp.cuda.limbs import batch_inverse
from fabric_tpu_torch.idemix import bn254 as bn

TABLE = bn254_kernel.TABLE
# Largest single launch.  The JAX package's largest bucket, not yet
# re-swept on the card.
MAX_LANES = 1024

# per-lane bases, fixed order: the kernel's lane tables follow it
LANE_BASES = ("a_prime", "a_bar", "b_prime", "nym")


def _jac_dbl(p):
    """Jacobian doubling over Python ints (a = 0); None is infinity."""
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    a, b = x * x % bn.P, y * y % bn.P
    c = b * b % bn.P
    d = 2 * ((x + b) ** 2 - a - c) % bn.P
    e = 3 * a % bn.P
    x3 = (e * e - 2 * d) % bn.P
    return (x3, (e * (d - x3) - 8 * c) % bn.P, 2 * y * z % bn.P)


def _jac_add(p, q):
    """Jacobian addition over Python ints, with the doubling and the
    opposite-point cases; None is infinity."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1, z1), (x2, y2, z2) = p, q
    z1z1, z2z2 = z1 * z1 % bn.P, z2 * z2 % bn.P
    u1, u2 = x1 * z2z2 % bn.P, x2 * z1z1 % bn.P
    s1, s2 = y1 * z2 * z2z2 % bn.P, y2 * z1 * z1z1 % bn.P
    h, r = (u2 - u1) % bn.P, (s2 - s1) % bn.P
    if h == 0:
        return _jac_dbl(p) if r == 0 else None
    hh = h * h % bn.P
    hhh = h * hh % bn.P
    v = u1 * hh % bn.P
    x3 = (r * r - hhh - 2 * v) % bn.P
    return (x3, (r * (v - x3) - s1 * hhh) % bn.P, z1 * z2 * h % bn.P)


def comb_multiples(points: tuple) -> tuple:
    """The fixed-base comb of affine points (None = infinity): per point,
    per window k < 64, the 16 multiples d 16^k P (d < 16) as affine int
    points or None.  Built in Jacobian coordinates (16^k P by 4 doublings
    a window, d 16^k P by a chain of adds) and made affine with one
    batched inversion."""
    jac = []
    for pt in points:
        base = None if pt is None else (pt[0], pt[1], 1)
        for _ in range(bn254_kernel.NWINDOWS):
            row = [None, base]
            for _ in range(2, TABLE):
                row.append(_jac_add(row[-1], base))
            jac.append(row)
            for _ in range(4):
                base = _jac_dbl(base)
    finite = [q for row in jac for q in row if q is not None]
    invs = iter(batch_inverse([q[2] for q in finite], bn.P))
    rows = []
    for row in jac:
        out = []
        for q in row:
            if q is None:
                out.append(None)
                continue
            zi = next(invs)
            zi2 = zi * zi % bn.P
            out.append((q[0] * zi2 % bn.P, q[1] * zi2 * zi % bn.P))
        rows.append(tuple(out))
    return tuple(rows)


@functools.lru_cache(maxsize=8)
def shared_comb(ipk_key: tuple) -> dict:
    """The kernel's comb of the shared bases, once per issuer key:
    `bn254_kernel.shared_table` of `comb_multiples`, (1024 S, 16) words
    and (1024 S,) flags on the host (uploaded with each batch).  ipk_key
    is the hashable ((x, y), ...) tuple of (G1, h_sk, h_rand,
    *h_attrs)."""
    return bn254_kernel.shared_table(comb_multiples(ipk_key))


def shared_points(ipk) -> tuple:
    """The shared bases of an issuer key: (G1, h_sk, h_rand, *h_attrs)."""
    return (bn.G1_GEN, ipk.h_sk, ipk.h_rand, *ipk.h_attrs)


def term_layout(n_attrs: int) -> tuple[tuple, tuple]:
    """(table, accumulator) per term.  Shared tables occupy indices
    0..n_shared-1, the 4 lane bases (LANE_BASES order) follow.
      T1: h_rand^z_r2, a_bar^{-c}, b_prime^{c}, a_prime^{z_neg_e}
      T2: G1^c, h_sk^z_sk, h_rand^z_s', h_attrs[i]^{s_i}, b'^{z_neg_r3}
      T3: h_sk^z_sk, h_rand^z_r_nym, nym^{-c}"""
    n_shared = 3 + n_attrs
    term_table = (
        2, n_shared + 1, n_shared + 2, n_shared + 0,
        0, 1, 2, *range(3, 3 + n_attrs), n_shared + 2,
        1, 2, n_shared + 3,
    )
    term_acc = (0, 0, 0, 0, 1, 1, 1, *([1] * n_attrs), 1, 2, 2, 2)
    return term_table, term_acc


def prepare_sigs(sigs, n_attrs: int):
    """Host prep: per signature the 4 lane base points, the n_terms
    scalars (in term_layout order), and validity.  A malformed signature
    gets ok=False: the kernel runs it with zero scalars and infinity
    bases and the caller marks it failed."""
    pts_l: list = []
    scalars_l: list = []
    ok = [True] * len(sigs)
    for j, sig in enumerate(sigs):
        try:
            pts = tuple(getattr(sig, name) for name in LANE_BASES)
            if any(p is None or not bn.g1_is_on_curve(p) for p in pts):
                raise ValueError("bad point")
            if len(sig.disclosure) != n_attrs:
                raise ValueError("bad disclosure length")
            c = sig.challenge % bn.R
            z = sig.responses
            hidden = [i for i, d in enumerate(sig.disclosure) if not d]
            need = {"neg_e", "r2", "sk", "sprime", "neg_r3", "r_nym",
                    *{f"m_{i}" for i in hidden}}
            if not need <= set(z):
                raise ValueError("missing responses")
            s_attr = []
            for i in range(n_attrs):
                if sig.disclosure[i]:
                    if i not in sig.disclosed_attrs:
                        raise ValueError("missing disclosed attr")
                    s_attr.append((c * sig.disclosed_attrs[i]) % bn.R)
                else:
                    s_attr.append(z[f"m_{i}"] % bn.R)
            scalars = [
                # T1
                z["r2"] % bn.R,         # h_rand
                (-c) % bn.R,            # a_bar
                c,                      # b_prime
                z["neg_e"] % bn.R,      # a_prime
                # T2
                c,                      # G1
                z["sk"] % bn.R,         # h_sk
                z["sprime"] % bn.R,     # h_rand
                *s_attr,                # h_attrs
                z["neg_r3"] % bn.R,     # b_prime
                # T3
                z["sk"] % bn.R,         # h_sk
                z["r_nym"] % bn.R,      # h_rand
                (-c) % bn.R,            # nym
            ]
            pts_l.append(pts)
            scalars_l.append(scalars)
        except (ValueError, IndexError, KeyError, TypeError,
                OverflowError, AttributeError):
            ok[j] = False
            pts_l.append((None,) * 4)
            scalars_l.append(None)
    return pts_l, scalars_l, ok


def to_affine(jac: list, ok) -> list:
    """Per-lane Jacobian triples (plain ints) -> per-lane affine (T1, T2,
    T3), None for an infinity or z == 0 point, and None for a lane that
    is not ok; one modular inversion for the batch."""
    zs, metas = [], []
    results: list = [None] * len(jac)
    for j, tri in enumerate(jac):
        if not ok[j]:
            continue
        metas.append((j, tri))
        for (_, _, zv, inf) in tri:
            zs.append(1 if (inf or zv == 0) else zv)
    if metas:
        invs = batch_inverse(zs, bn.P)
        k = 0
        for j, tri in metas:
            pts = []
            for (x, y, zv, inf) in tri:
                if inf or zv == 0:
                    pts.append(None)
                else:
                    zi = invs[k]
                    zi2 = zi * zi % bn.P
                    pts.append((x * zi2 % bn.P, y * zi2 * zi % bn.P))
                k += 1
            results[j] = tuple(pts)
    return results


def schnorr_commitments_batch(sigs, ipk, device="cuda",
                              max_lanes: int = MAX_LANES) -> list:
    """Per signature the affine (T1, T2, T3) as int tuples (None =
    infinity), or None for a malformed signature (the caller marks it
    failed).  Runs the kernel on `device`; a CPU device runs its plain
    version."""
    n = len(sigs)
    if n == 0:
        return []
    if n > max_lanes:
        out: list = []
        for off in range(0, n, max_lanes):
            out.extend(schnorr_commitments_batch(
                sigs[off:off + max_lanes], ipk, device, max_lanes))
        return out
    n_attrs = len(ipk.h_attrs)
    term_table, term_acc = term_layout(n_attrs)
    pts_l, scalars_l, ok = prepare_sigs(sigs, n_attrs)
    packed = bn254_kernel.pack(pts_l, scalars_l, ok, term_table, term_acc)
    t = bn254_kernel.upload(
        packed, shared_comb(shared_points(ipk)), torch.device(device)
    )
    jac = bn254_kernel.unpack(bn254_kernel.commitments(t))
    return to_affine(jac, ok)


__all__ = [
    "LANE_BASES",
    "MAX_LANES",
    "comb_multiples",
    "shared_comb",
    "shared_points",
    "term_layout",
    "prepare_sigs",
    "to_affine",
    "schnorr_commitments_batch",
]
