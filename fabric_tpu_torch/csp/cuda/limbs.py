"""Host int<->limb/word helpers and the plain PyTorch P-256 field.

The helpers are copies of `fabric_tpu/csp/tpu/limbs.py:55-98` (16-bit
limbs) plus their 32-bit word counterparts, which the CUDA kernel and
the packed tensors use.

`FpP256` is the plain version of the field arithmetic inside the
kernel: it serves the CPU path of `p256_kernel.verify_packed` and is
what the kernel is held against on the card.  It computes on int64
tensors of 16 signed, relaxed 16-bit limbs, lanes first, shape
(B, 16): every limb of an operand lies in [-8, 2^16 + 8] and the value
is only congruent to the field element, so products stay exact in
int64 and the carries are a few vector passes, not a serial ripple.
The product reduces through the Solinas terms of P-256 (FIPS 186-4
D.2.3; `_S_TERMS` of `pallas_ec.py:68-79`), applied at limb level as a
signed matrix over the 32 product columns.  Only `canon` and `is_zero`
resolve a value exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fabric_tpu_torch.csp.api import P256_P

LIMB_BITS = 16
MASK = 0xFFFF
NLIMBS = 16  # 256 bits of 16-bit limbs
WORD_MASK = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Host <-> limb / word conversions (numpy, Python ints).
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, width: int = NLIMBS + 1) -> np.ndarray:
    """Python int -> canonical uint32 vector of `width` 16-bit limbs."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros((width,), dtype=np.uint32)
    for i in range(width):
        out[i] = x & MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("does not fit in %d limbs" % width)
    return out


def ints_to_limbs(xs, width: int = NLIMBS + 1) -> np.ndarray:
    """Batch of Python ints -> (len(xs), width) uint32 16-bit limbs."""
    return np.stack([int_to_limbs(x, width) for x in xs]) if len(xs) else (
        np.zeros((0, width), np.uint32)
    )


def limbs_to_int(a) -> int:
    """Limb vector (relaxed or signed limbs allowed) -> Python int."""
    a = np.asarray(a).astype(object)
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) + int(a[..., i])
    return x


def limbs_to_ints(a) -> list:
    a = np.asarray(a)
    if a.ndim == 1:
        return [limbs_to_int(a)]
    return [limbs_to_int(row) for row in a]


def int_to_words(x: int) -> np.ndarray:
    """Python int in [0, 2^256) -> (8,) uint32 words, least significant
    first."""
    if not 0 <= x < 1 << 256:
        raise ValueError("value does not fit in 256 bits")
    return np.frombuffer(x.to_bytes(32, "little"), np.uint32).copy()


def words_to_int(w) -> int:
    """(8,) words (any integer dtype, read as unsigned 32-bit) -> int."""
    w = np.asarray(w).astype(np.int64) & WORD_MASK
    return sum(int(v) << (32 * i) for i, v in enumerate(w))


# ---------------------------------------------------------------------------
# Plain PyTorch field arithmetic mod p.
# ---------------------------------------------------------------------------

# Solinas terms for P-256 (FIPS 186-4 D.2.3): each term is 8 32-bit words,
# most significant first, indexing the 512-bit product's words c0..c15
# (c0 least significant); None is a zero word.  Copied from
# fabric_tpu/csp/tpu/pallas_ec.py:68-79.
S_TERMS = [
    ([7, 6, 5, 4, 3, 2, 1, 0], 1),                     # s1 (low half)
    ([15, 14, 13, 12, 11, None, None, None], 2),       # s2
    ([None, 15, 14, 13, 12, None, None, None], 2),     # s3
    ([15, 14, None, None, None, 10, 9, 8], 1),         # s4
    ([8, 13, 15, 14, 13, 11, 10, 9], 1),               # s5
    ([10, 8, None, None, None, 13, 12, 11], -1),       # s6
    ([11, 9, None, None, 15, 14, 13, 12], -1),         # s7
    ([12, None, 10, 9, 8, 15, 14, 13], -1),            # s8
    ([13, None, 11, 10, 9, None, 15, 14], -1),         # s9
]


@functools.lru_cache(maxsize=None)
def solinas_matrix() -> np.ndarray:
    """(16, 32) int64: output limb k of the reduction sums product limb i
    with weight m[k, i].  Linear in the product's limbs, so it holds for
    any (relaxed, signed) column values."""
    m = np.zeros((NLIMBS, 2 * NLIMBS), np.int64)
    for words, w in S_TERMS:
        for pos, word in enumerate(reversed(words)):
            if word is not None:
                m[2 * pos, 2 * word] += w
                m[2 * pos + 1, 2 * word + 1] += w
    return m


# 2^256 mod p = 2^224 - 2^192 - 2^96 + 1, as signed 16-bit limbs: a carry
# out of limb 15 folds back through it.
_R256 = np.zeros(NLIMBS, np.int64)
_R256[[0, 6, 12, 14]] = [1, -1, -1, 1]
_CHUNK_MASK = (1 << 48) - 1


class FpP256:
    """Field ops mod p on (B, 16) int64 relaxed limbs (see the module
    docstring); method names follow `pallas_ec.FpP256`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.solmat = torch.as_tensor(solinas_matrix(), device=self.device)
        self.r256 = torch.as_tensor(_R256, device=self.device)
        self.p_limbs = torch.as_tensor(
            int_to_limbs(P256_P, NLIMBS).astype(np.int64), device=self.device
        )
        # 48-bit chunks (3 limbs each) for the exact carry of is_zero
        self._chunk_w = torch.as_tensor(
            [1, 1 << 16, 1 << 32], dtype=torch.int64, device=self.device
        )
        self._p_chunks = torch.as_tensor(
            [(P256_P >> (48 * k)) & _CHUNK_MASK for k in range(6)],
            dtype=torch.int64, device=self.device,
        )

    # -- conversions ------------------------------------------------------

    def from_ints(self, xs) -> torch.Tensor:
        return torch.as_tensor(
            ints_to_limbs(xs, NLIMBS).astype(np.int64), device=self.device
        )

    @staticmethod
    def to_ints(a: torch.Tensor) -> list[int]:
        return limbs_to_ints(a.cpu().numpy())

    @staticmethod
    def from_words(words: torch.Tensor) -> torch.Tensor:
        """(8, B) words (int32 bit patterns) -> (B, 16) limbs."""
        w = words.to(torch.int64) & WORD_MASK
        lo, hi = w & MASK, w >> LIMB_BITS
        return torch.stack([lo, hi], dim=1).reshape(NLIMBS, -1).T.contiguous()

    # -- carries ----------------------------------------------------------

    def _carry(self, v: torch.Tensor, passes: int) -> torch.Tensor:
        """Vector carry passes: each moves every limb's bits above 16 one
        limb up and folds the carry out of limb 15 through 2^256 mod p.
        From limbs of magnitude M, a pass leaves [-2M/2^16, 2^16 +
        2M/2^16]; callers pick `passes` to land inside [-8, 2^16 + 8]."""
        for _ in range(passes):
            c = v >> LIMB_BITS  # floor: v == (c << 16) + (v & MASK)
            v = v & MASK
            v = torch.cat([v[:, :1], v[:, 1:] + c[:, :-1]], dim=1)
            v = v + c[:, -1:] * self.r256
        return v

    def _ripple(self, v: torch.Tensor):
        """Exact serial carry: limbs in [0, 2^16) and the signed carry out
        of limb 15."""
        v = v.clone()
        c = torch.zeros_like(v[:, 0])
        for k in range(NLIMBS):
            t = v[:, k] + c
            v[:, k] = t & MASK
            c = t >> LIMB_BITS
        return v, c

    # -- field ops --------------------------------------------------------

    def add(self, a, b):
        return self._carry(a + b, 2)

    def sub(self, a, b):
        return self._carry(a - b, 2)

    def mul_const(self, a, k: int):
        assert 0 < k <= 8
        return self._carry(a * k, 2)

    def mul(self, a, b):
        # schoolbook: row i of the (16, 16) limb products shifts to
        # columns i..i+15 -- padding rows to 32 and re-reading the flat
        # buffer with a row stride of 31 lines every product up under its
        # column (16 * 32 = 31 * 16 + 16)
        n = a.shape[0]
        prod = a[:, :, None] * b[:, None, :]  # (B, 16, 16), |.| < 2^33
        prod = torch.nn.functional.pad(prod, (0, NLIMBS))  # (B, 16, 32)
        cols = prod.reshape(n, -1)[:, : NLIMBS * 31].reshape(n, NLIMBS, 31)
        cols = torch.nn.functional.pad(cols.sum(dim=1), (0, 1))  # (B, 32)
        red = (cols[:, None, :] * self.solmat).sum(dim=2)  # (B, 16), < 2^42
        return self._carry(red, 3)

    def sqr(self, a):
        return self.mul(a, a)

    def canon(self, a):
        """Exact representative in [0, p) as canonical 16-bit limbs."""
        v = a
        for _ in range(3):
            # value L + t*2^256 == L + t*(2^256 mod p): |t| <= 2 first,
            # then t in {-1, 0, 1}, then 0 (the folded value is in
            # [0, 2^256))
            v, t = self._ripple(v)
            v = v + t[:, None] * self.r256
        v, _ = self._ripple(v)
        # one conditional subtraction: 2^256 < 2p
        d, borrow = self._ripple(v - self.p_limbs)
        return torch.where((borrow < 0)[:, None], v, d)

    def is_zero(self, a):
        """a == 0 (mod p), for an output of the field ops.  Its limbs lie
        in [-8, 2^16 + 8], so its value V lies in (-p, 2p) and V == 0
        mod p only for V in {0, p}: one exact carry over 48-bit chunks
        (V = L + t*2^256, L in [0, 2^256)) decides it."""
        chunks = torch.nn.functional.pad(a, (0, 2)).reshape(-1, 6, 3)
        v = (chunks * self._chunk_w).sum(dim=2)  # (B, 6), |.| < 2^50
        c = torch.zeros_like(v[:, 0])
        for k in range(5):
            s = v[:, k] + c
            v[:, k] = s & _CHUNK_MASK
            c = s >> 48
        top = v[:, 5] + c  # bits 240 and up
        v[:, 5] = top & MASK
        t = top >> LIMB_BITS
        return (t == 0) & (
            (v == 0).all(dim=1) | (v == self._p_chunks).all(dim=1)
        )

    def eq(self, a, b):
        return self.is_zero(self.sub(a, b))


__all__ = [
    "FpP256",
    "S_TERMS",
    "solinas_matrix",
    "int_to_limbs",
    "ints_to_limbs",
    "limbs_to_int",
    "limbs_to_ints",
    "int_to_words",
    "words_to_int",
]
