"""Plain PyTorch Jacobian point operations on P-256.

The formulas, and their flag and exception handling, are those of
`pallas_ec._dbl`/`_add_full`/`_add_mixed` (`pallas_ec.py:434-507`): the
doubling case when h == 0 and r == 0, infinity when h == 0 and r != 0
(P + (-P)), and operands at infinity selected through.  A point is a
tuple (x, y, z, inf) of (B, 16) limb tensors of `limbs.FpP256` and a
(B,) bool flag; the coordinates of a point whose flag is set never
reach a result whose flag is clear.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import P256_GX, P256_GY
from fabric_tpu_torch.csp.cuda.limbs import int_to_words

WINDOW_BITS = 4
NWINDOWS = 64  # 256 / 4
TABLE = 1 << WINDOW_BITS


@functools.lru_cache(maxsize=None)
def g_table() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine multiples 0..15 of the base point as (16, 8) uint32 words
    of x and y, and the (16,) infinity flags; entry 0 is infinity with
    zero coordinates (`fabric_tpu.csp.tpu.ec.g_table`, in words)."""
    xs, ys, inf = [], [], []
    for i in range(TABLE):
        pt = hostref.affine_mul(i, (P256_GX, P256_GY))
        xs.append(int_to_words(0 if pt is None else pt[0]))
        ys.append(int_to_words(0 if pt is None else pt[1]))
        inf.append(pt is None)
    return np.stack(xs), np.stack(ys), np.asarray(inf)


def _sel(c, a, b):
    """Per-lane select of limb tensors: c (B,) bool picks a else b."""
    return torch.where(c[:, None], a, b)


def pt_sel(c, p1, p2):
    return (
        _sel(c, p1[0], p2[0]),
        _sel(c, p1[1], p2[1]),
        _sel(c, p1[2], p2[2]),
        torch.where(c, p1[3], p2[3]),
    )


def dbl(fp, p):
    x, y, z, inf = p
    delta = fp.sqr(z)
    gamma = fp.sqr(y)
    beta = fp.mul(x, gamma)
    alpha = fp.mul_const(fp.mul(fp.sub(x, delta), fp.add(x, delta)), 3)
    x3 = fp.sub(fp.sqr(alpha), fp.mul_const(beta, 8))
    z3 = fp.sub(fp.sub(fp.sqr(fp.add(y, z)), gamma), delta)
    y3 = fp.sub(
        fp.mul(alpha, fp.sub(fp.mul_const(beta, 4), x3)),
        fp.mul_const(fp.sqr(gamma), 8),
    )
    return (x3, y3, z3, inf)


def _finish(fp, p1, out, h_zero, r_zero):
    """The exceptional cases shared by both adds: P + P doubles, and
    P + (-P) is infinity.  The doubling runs only when some lane needs
    it; the select keeps every other lane's sum."""
    same = h_zero & r_zero
    if bool(same.any()):
        out = pt_sel(same, dbl(fp, p1), out)
    return (out[0], out[1], out[2], out[3] | (h_zero & ~r_zero))


def add_full(fp, p1, p2):
    x1, y1, z1, inf1 = p1
    x2, y2, z2, inf2 = p2
    z1z1 = fp.sqr(z1)
    z2z2 = fp.sqr(z2)
    u1 = fp.mul(x1, z2z2)
    u2 = fp.mul(x2, z1z1)
    s1 = fp.mul(fp.mul(y1, z2), z2z2)
    s2 = fp.mul(fp.mul(y2, z1), z1z1)
    h = fp.sub(u2, u1)
    rr = fp.sub(s2, s1)
    h_zero = fp.is_zero(h)
    r_zero = fp.is_zero(rr)
    i = fp.sqr(fp.add(h, h))
    j = fp.mul(h, i)
    rr2 = fp.add(rr, rr)
    v = fp.mul(u1, i)
    x3 = fp.sub(fp.sub(fp.sqr(rr2), j), fp.add(v, v))
    t = fp.mul(s1, j)
    y3 = fp.sub(fp.mul(rr2, fp.sub(v, x3)), fp.add(t, t))
    z3 = fp.mul(fp.sub(fp.sub(fp.sqr(fp.add(z1, z2)), z1z1), z2z2), h)
    out = _finish(fp, p1, (x3, y3, z3, torch.zeros_like(inf1)), h_zero, r_zero)
    out = pt_sel(inf2, p1, out)
    return pt_sel(inf1, p2, out)


def add_mixed(fp, p1, a2, one):
    """p1 (Jacobian) + a2 = (ax, ay, ainf) (affine); `one` is the field
    element 1 broadcast to the lanes."""
    x1, y1, z1, inf1 = p1
    ax, ay, ainf = a2
    z1z1 = fp.sqr(z1)
    u2 = fp.mul(ax, z1z1)
    s2 = fp.mul(fp.mul(ay, z1), z1z1)
    h = fp.sub(u2, x1)
    rr = fp.sub(s2, y1)
    h_zero = fp.is_zero(h)
    r_zero = fp.is_zero(rr)
    hh = fp.sqr(h)
    i = fp.mul_const(hh, 4)
    j = fp.mul(h, i)
    rr2 = fp.add(rr, rr)
    v = fp.mul(x1, i)
    x3 = fp.sub(fp.sub(fp.sqr(rr2), j), fp.add(v, v))
    t = fp.mul(y1, j)
    y3 = fp.sub(fp.mul(rr2, fp.sub(v, x3)), fp.add(t, t))
    z3 = fp.sub(fp.sub(fp.sqr(fp.add(z1, h)), z1z1), hh)
    out = _finish(fp, p1, (x3, y3, z3, torch.zeros_like(inf1)), h_zero, r_zero)
    out = pt_sel(ainf, p1, out)
    return pt_sel(inf1, (ax, ay, one, ainf), out)


__all__ = [
    "NWINDOWS",
    "TABLE",
    "g_table",
    "dbl",
    "add_full",
    "add_mixed",
    "pt_sel",
]
