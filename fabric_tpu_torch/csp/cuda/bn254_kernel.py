"""Batched idemix Schnorr commitments on BN254 G1: host packing, the plain
PyTorch version, and the wrapper that launches the CUDA kernel.

Counterpart of `fabric_tpu/csp/tpu/pallas_bn254.py`.  Per lane it
computes T1, T2, T3 as three multi-scalar multiplications over 4 per-lane
bases (a', a_bar, b', nym) and the issuer key's shared bases (G1, h_sk,
h_rand, h_attrs), with a term layout of [table, accumulator] pairs (see
`bn254_batch.term_layout`): each term's scalar multiple s_t B_t as a
partial (a fixed-base comb for a shared base, a variable-base ladder for
a lane base), then each accumulator's partials added in term order.  The
packed layout is the JAX package's, with field elements in Montgomery
form at R = 2^256 (the kernel's) instead of R = 2^272, and the shared
bases as combs instead of 16-entry tables:

  lanes    (64, B)  base b's x words at rows 16 b .. 16 b + 7, y at
                    16 b + 8 .. 16 b + 15, 32-bit words, least significant
                    first, lanes on the last axis
  laneinf  (4, B)   1 where base b is infinity (bad and padding lanes)
  digits   (8 T, B) term t's 64 MSB-first 4-bit digits, 8 per word
  termmeta (T, 2)   [table, accumulator]; tables 0 .. S - 1 shared,
                    S .. S + 3 the lane bases
  comb_xy  (1024 S, 16) affine x then y words of d 16^k B_s at row
                    1024 s + 16 k + d (`shared_table` of
                    `bn254_batch.comb_multiples`)
  comb_inf (1024 S,)    1 where a comb entry is infinity

On the device every word array is int32 (the bits are the same).  The
per-term partials are (25 T, B) int32: rows 25 t + 8 c .. + 7 the
canonical Montgomery words of coordinate c (x, y, z) of term t's partial
(zeros at infinity), row 25 t + 24 its infinity flag.  The output is
(75, B) int32: rows 8 (3 k + a) .. + 7 hold the canonical words of
coordinate k of accumulator a, rows 72..74 the infinity flags.

`commitments` launches `bn254_commitments` from `csrc/bn254_commit.cu`
(replacing `pallas_bn254._make_kernel`) for CUDA tensors and runs
`commitments_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fabric_tpu_torch.csp.cuda import bn254_ec as ec
from fabric_tpu_torch.csp.cuda import fp254
from fabric_tpu_torch.csp.cuda.fp254 import FpBN254
from fabric_tpu_torch.csp.cuda.limbs import int_to_words

NWINDOWS = 64
TABLE = ec.TABLE
N_LANE_BASES = 4  # a', a_bar, b', nym
N_ACCS = 3  # T1, T2, T3
OUT_ROWS = 9 * 8 + N_ACCS
INF_ROW = 9 * 8
PART_ROWS = 3 * 8 + 1  # x, y, z words and the flag of one term's partial
COMB_ENTRIES = NWINDOWS * TABLE  # comb rows of one shared base

# Launches by the wrapper: `launches_bn254` counts `commitments` calls
# that launched, `kernel_launches_bn254` the CUDA kernels they launched
# (the term phase and the reduction).  Plain-version calls on CPU tensors
# do not count.
launches_bn254 = 0
kernel_launches_bn254 = 0


@functools.lru_cache(maxsize=None)
def consts() -> dict:
    """The field constants of the kernel as (8,) words: p, -p^-1 mod
    2^256 (its low word is the CIOS constant), the Montgomery 1 and
    2^256 mod p (equal at R = 2^256).  `convert.bn254_consts_from_jax`
    builds the same dict from `pallas_bn254._consts`."""
    return dict(
        p=int_to_words(fp254.P),
        p_inv=int_to_words(fp254.P_INV),
        one=int_to_words(fp254.ONE),
        r256=int_to_words(fp254.R % fp254.P),
    )


# ---------------------------------------------------------------------------
# Host packing (numpy).
# ---------------------------------------------------------------------------


def digits_from_ints(vals) -> np.ndarray:
    """Scalars < 2^256 -> (8, B) uint32: 64 MSB-first 4-bit window
    digits, 8 per word (digit k in bits 4 (k % 8) of word k // 8) -- a
    copy of `pallas_bn254._digits_from_ints`."""
    n = len(vals)
    buf = bytearray(32 * n)
    for i, v in enumerate(vals):
        buf[32 * i:32 * i + 32] = v.to_bytes(32, "little")
    u8 = np.frombuffer(bytes(buf), np.uint8).reshape(n, 32)
    nibbles = np.empty((n, 64), np.uint32)
    nibbles[:, 0::2] = u8 & 0xF
    nibbles[:, 1::2] = u8 >> 4
    d = nibbles[:, ::-1]  # digit k = nibble 63 - k (MSB first)
    shifts = (np.uint32(4) * np.arange(8, dtype=np.uint32))[None, None]
    return np.ascontiguousarray(
        (d.reshape(n, 8, 8) << shifts).sum(axis=2, dtype=np.uint32).T
    )


def shared_table(rows) -> dict:
    """Rows of 16 affine int points (None for infinity) -> {"xy": (16 N,
    16) uint32 Montgomery words of x then y, "inf": (16 N,) uint32}, row
    by row.  The rows of `bn254_batch.comb_multiples` (per shared base,
    its 64 windows) give the kernel's comb; its window 0, the multiples
    0..15 of each base, is the JAX package's 16-entry shared table."""
    xs, ys, infs = [], [], []
    for row in rows:
        for q in row:
            xs.append(0 if q is None else fp254.to_mont(q[0]))
            ys.append(0 if q is None else fp254.to_mont(q[1]))
            infs.append(q is None)
    xy = np.concatenate(
        [fp254.words_from_ints(xs).T, fp254.words_from_ints(ys).T], axis=1
    )
    return {"xy": np.ascontiguousarray(xy),
            "inf": np.asarray(infs, np.uint32)}


def pack(lane_pts, scalars, ok, term_table, term_acc,
         lanes: int | None = None) -> dict:
    """The per-lane arrays of a prepared batch (`pallas_bn254.commitments`'
    packing).  lane_pts: per signature 4 affine int points (a', a_bar, b',
    nym); scalars: per signature the n_terms scalars; ok: per-signature
    validity.  Bad lanes, and padding lanes up to `lanes`, carry infinity
    bases and zero scalars, so every digit selects table entry 0."""
    n = len(lane_pts)
    padded = n if lanes is None else lanes
    if padded < n:
        raise ValueError("lanes is smaller than the batch")
    n_terms = len(term_table)
    if len(term_acc) != n_terms:
        raise ValueError("term_table and term_acc differ in length")
    coords: list[list[int]] = [[] for _ in range(2 * N_LANE_BASES)]
    laneinf = np.ones((N_LANE_BASES, padded), np.uint32)
    digit_ints: list[list[int]] = [[] for _ in range(n_terms)]
    for j in range(padded):
        good = j < n and ok[j]
        pts = lane_pts[j] if good else (None,) * N_LANE_BASES
        sc = scalars[j] if good else [0] * n_terms
        for b in range(N_LANE_BASES):
            p = pts[b]
            if p is None:
                coords[2 * b].append(0)
                coords[2 * b + 1].append(0)
            else:
                coords[2 * b].append(fp254.to_mont(p[0]))
                coords[2 * b + 1].append(fp254.to_mont(p[1]))
                laneinf[b, j] = 0
        for t in range(n_terms):
            digit_ints[t].append(sc[t])
    return {
        "lanes": np.concatenate(
            [fp254.words_from_ints(c) for c in coords], axis=0
        ),
        "laneinf": laneinf,
        "digits": np.concatenate(
            [digits_from_ints(d) for d in digit_ints], axis=0
        ),
        "termmeta": np.stack(
            [np.asarray(term_table, np.int32),
             np.asarray(term_acc, np.int32)], axis=1
        ),
    }


def upload(packed: dict, comb: dict, device) -> dict:
    """A packed numpy dict and the shared bases' comb
    (`bn254_batch.shared_comb`) -> the kernel's int32 tensors on `device`
    (through pinned memory with non_blocking copies for a CUDA device).
    Term metadata out of range raises here."""
    n_shared = comb["inf"].shape[0] // COMB_ENTRIES
    meta = np.asarray(packed["termmeta"])
    if meta.size and (
        meta[:, 0].min() < 0 or meta[:, 0].max() >= n_shared + N_LANE_BASES
        or meta[:, 1].min() < 0 or meta[:, 1].max() >= N_ACCS
    ):
        raise ValueError(f"term metadata out of range: {meta.tolist()}")
    dev = torch.device(device)
    host = {
        "lanes": packed["lanes"],
        "laneinf": packed["laneinf"],
        "digits": packed["digits"],
        "termmeta": meta,
        "comb_xy": comb["xy"],
        "comb_inf": comb["inf"],
    }
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(
            np.ascontiguousarray(v).astype(np.uint32).view(np.int32)
        )
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


def unpack(out, n: int | None = None) -> list:
    """(75, B) output -> per lane [(x, y, z, inf)] * 3 Jacobian ints in
    plain (non-Montgomery) form, as `pallas_bn254.commitments` returns."""
    o = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
    n = o.shape[1] if n is None else n
    words = [fp254.words_to_ints(o[8 * r:8 * r + 8, :n]) for r in range(9)]
    res = []
    for j in range(n):
        res.append([
            (fp254.from_mont(words[a][j]), fp254.from_mont(words[3 + a][j]),
             fp254.from_mont(words[6 + a][j]), bool(o[INF_ROW + a, j]))
            for a in range(N_ACCS)
        ])
    return res


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _digits(words: torch.Tensor, n_terms: int) -> torch.Tensor:
    """(8 T, B) packed digit words -> (T, 64, B) int64 digits, MSB first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, device=words.device)
    d = (w.reshape(n_terms, 8, 1, -1) >> shifts[None, None, :, None]) & 0xF
    return d.reshape(n_terms, NWINDOWS, -1)


def _check_meta(meta: list, n_shared: int) -> None:
    for i, (tab, a) in enumerate(meta):
        if not (0 <= tab < n_shared + N_LANE_BASES and 0 <= a < N_ACCS):
            raise ValueError(f"term {i} out of range: {(tab, a)}")


def _canonical_rows(fp: FpBN254, pt) -> torch.Tensor:
    """Points (x, y, z (..., B, 16), inf (..., B)) -> (..., 25, B) int32:
    canonical words of x, y, z (zeros at infinity), then the flag."""
    x, y, z, inf = pt
    coords = torch.stack([x, y, z], dim=-3)  # (..., 3, B, 16)
    coords = torch.where(inf[..., None, :, None], 0, fp.canon(coords))
    words = fp.to_words(coords)  # (8, ..., 3, B)
    words = words.movedim(0, -2).flatten(-3, -2)  # (..., 24, B)
    return torch.cat([words, inf[..., None, :].to(torch.int32)], dim=-2)


def term_partials_plain(t: dict) -> torch.Tensor:
    """Each term's partial s_t B_t for every lane, in plain PyTorch on the
    device of the tensors: (25 T, B) int32, word for word the kernel's
    scratch (`term_lane` of `csrc/bn254_commit.cuh`).

    Shared-base terms: 64 MSB-first windows, each a mixed add of comb
    entry d 16^(63 - w) B, starting at infinity, no doublings.  Lane-base
    terms: the base's 16-entry Jacobian table by a 14-step mixed-add
    chain, then 64 MSB-first windows of 4 doublings and a full add of
    entry d.  The terms of each kind are stacked on a leading axis and
    take each step at once."""
    dev = t["lanes"].device
    fp = FpBN254(dev)
    n = t["lanes"].shape[-1]
    n_shared = t["comb_inf"].shape[0] // COMB_ENTRIES
    meta = t["termmeta"].cpu().tolist()
    _check_meta(meta, n_shared)
    n_terms = len(meta)
    digits = _digits(t["digits"], n_terms)  # (T, 64, B)
    lanes = torch.arange(n, device=dev)
    part = torch.empty((n_terms, PART_ROWS, n), dtype=torch.int32,
                       device=dev)

    def at_inf(k: int):
        zero = torch.zeros((k, n, fp254.NLIMBS), dtype=torch.int64,
                           device=dev)
        return (zero, zero, zero,
                torch.ones((k, n), dtype=torch.bool, device=dev))

    comb_terms = [i for i, (tab, _) in enumerate(meta) if tab < n_shared]
    if comb_terms:
        cw = t["comb_xy"].reshape(n_shared, NWINDOWS, TABLE, 2, 8)
        # (S, 64, 16, 16): base, window, digit, limb
        cx = fp.from_words(cw[:, :, :, 0].permute(3, 0, 1, 2))
        cy = fp.from_words(cw[:, :, :, 1].permute(3, 0, 1, 2))
        cinf = t["comb_inf"].reshape(n_shared, NWINDOWS, TABLE) != 0
        base = torch.tensor([meta[i][0] for i in comb_terms],
                            device=dev)[:, None]
        d = digits[comb_terms]  # (k, 64, B)
        acc = at_inf(len(comb_terms))
        for w in range(NWINDOWS):
            e = (base, NWINDOWS - 1 - w, d[:, w])
            acc = ec.add_mixed(fp, acc, (cx[e], cy[e], cinf[e]))
        part[comb_terms] = _canonical_rows(fp, acc)

    ladder_terms = [i for i in range(n_terms) if i not in comb_terms]
    if ladder_terms:
        lw = t["lanes"].reshape(N_LANE_BASES, 2, 8, n)
        px = fp.from_words(lw[:, 0].transpose(0, 1))  # (4, B, 16)
        py = fp.from_words(lw[:, 1].transpose(0, 1))
        ltab = ec.lane_window_table(fp, px, py, t["laneinf"] != 0)
        b = torch.tensor([meta[i][0] - n_shared for i in ladder_terms],
                         device=dev)[:, None]
        d = digits[ladder_terms]
        acc = at_inf(len(ladder_terms))
        for w in range(NWINDOWS):
            for _ in range(4):
                acc = ec.dbl(fp, acc)
            acc = ec.add_full(fp, acc,
                              tuple(c[b, lanes, d[:, w]] for c in ltab))
        part[ladder_terms] = _canonical_rows(fp, acc)
    return part.reshape(n_terms * PART_ROWS, n)


def reduce_plain(part: torch.Tensor, termmeta: torch.Tensor) -> torch.Tensor:
    """Each accumulator's sum of its terms' partials (`part` as
    `term_partials_plain` returns it), added in term order by the full
    add from infinity: (75, B) int32, word for word the kernel's
    (`reduce_lane`).  The accumulators are stacked on a leading axis;
    round r adds the r-th term of each at once."""
    dev = part.device
    fp = FpBN254(dev)
    n = part.shape[-1]
    meta = termmeta.cpu().tolist()
    rows = part.reshape(len(meta), PART_ROWS, n)
    coords = [fp.from_words(rows[:, 8 * c:8 * c + 8].transpose(0, 1))
              for c in range(3)]  # (T, B, 16) each
    pinf = rows[:, 24] != 0
    order: list[list[int]] = [[] for _ in range(N_ACCS)]
    for i, (_, a) in enumerate(meta):
        if not 0 <= a < N_ACCS:
            raise ValueError(f"term {i} out of range: {tuple(meta[i])}")
        order[a].append(i)
    zero = torch.zeros((n, fp254.NLIMBS), dtype=torch.int64, device=dev)
    at_inf = torch.ones(n, dtype=torch.bool, device=dev)
    acc = (torch.zeros((N_ACCS, n, fp254.NLIMBS), dtype=torch.int64,
                       device=dev),) * 3 + (
        torch.ones((N_ACCS, n), dtype=torch.bool, device=dev),)
    for r in range(max(len(o) for o in order)):
        qs = [(coords[0][o[r]], coords[1][o[r]], coords[2][o[r]], pinf[o[r]])
              if r < len(o) else (zero, zero, zero, at_inf) for o in order]
        acc = ec.add_full(fp, acc, tuple(torch.stack([q[k] for q in qs])
                                         for k in range(4)))
    rows = _canonical_rows(fp, acc)  # (3 accs, 25, B)
    out = torch.empty((OUT_ROWS, n), dtype=torch.int32, device=dev)
    # (accumulator a, coordinate k, word) -> row 8 (3 k + a) + word
    out[:INF_ROW] = rows[:, :24].reshape(N_ACCS, 3, 8, n).transpose(
        0, 1).reshape(INF_ROW, n)
    out[INF_ROW:] = rows[:, 24]
    return out


def commitments_plain(t: dict) -> torch.Tensor:
    """The kernel in plain PyTorch, on the device of the tensors: (75, B)
    int32, word for word the kernel's -- the term partials, then their
    sums.  Every value agrees with the kernel's mod p, so every branch
    and every canonical word does too."""
    return reduce_plain(term_partials_plain(t), t["termmeta"])


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


def _check(t: dict, device: torch.device) -> tuple[int, int, int]:
    """Validate what the kernel reads; returns (n_terms, n_shared, B)."""
    n = t["lanes"].shape[-1]
    n_terms = t["termmeta"].shape[0]
    n_shared = t["comb_inf"].shape[0] // COMB_ENTRIES
    shapes = {
        "lanes": (16 * N_LANE_BASES, n),
        "laneinf": (N_LANE_BASES, n),
        "digits": (8 * n_terms, n),
        "termmeta": (n_terms, 2),
        "comb_xy": (COMB_ENTRIES * n_shared, 16),
        "comb_inf": (COMB_ENTRIES * n_shared,),
    }
    for k, shape in shapes.items():
        v = t[k]
        if v.device != device or v.dtype != torch.int32:
            raise ValueError(f"{k}: expected int32 on {device}, got "
                             f"{v.dtype} on {v.device}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{k}: expected contiguous {shape}, got "
                             f"{tuple(v.shape)}")
    return n_terms, n_shared, n


def launcher(t: dict) -> tuple:
    """The kernel's launch on the CUDA tensors `t`, prepared: (a call with
    no arguments that launches its two phases once on the current stream,
    with the term partials in a scratch tensor, and returns the CUDA error
    code; the (75, B) int32 output it writes; the CUDA kernels a call
    launches).  The tensors are checked here; the call counts nothing
    (the wrapper counts its launches) and a timing calls it bare.  With
    B = 0 the call is None."""
    from fabric_tpu_torch.csp.cuda import build

    dev = t["lanes"].device
    lib = build.load("bn254_commit")
    n_terms, n_shared, n = _check(t, dev)
    out = torch.empty((OUT_ROWS, n), dtype=torch.int32, device=dev)
    if n == 0:
        return None, out, 0
    part = torch.empty((PART_ROWS * n_terms, n), dtype=torch.int32,
                       device=dev)
    ptr = ctypes.c_void_p
    args = [
        ptr(t["lanes"].data_ptr()), ptr(t["laneinf"].data_ptr()),
        ptr(t["digits"].data_ptr()), ptr(t["termmeta"].data_ptr()),
        ctypes.c_int(n_terms),
        ptr(t["comb_xy"].data_ptr()), ptr(t["comb_inf"].data_ptr()),
        ctypes.c_int(n_shared), ptr(part.data_ptr()),
        ptr(out.data_ptr()), ctypes.c_int(n),
        ptr(torch.cuda.current_stream(dev).cuda_stream),
    ]
    return (build.Launch(lib.bn254_commitments, args,
                         (*t.values(), part, out)),
            out, 2 if n_terms else 1)


def commitments(t: dict) -> torch.Tensor:
    """(75, B) int32 commitments for the tensors `t` (see `upload`).

    CUDA tensors launch the hand-written kernel's two phases on the
    current stream, with the term partials in a scratch tensor, and
    return without synchronising; CPU tensors run `commitments_plain`.  A
    launch error raises."""
    global launches_bn254, kernel_launches_bn254
    dev = t["lanes"].device
    if dev.type == "cpu":
        return commitments_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    launch, out, kernels = launcher(t)
    if launch is None:
        return out
    rc = launch()
    launches_bn254 += 1
    kernel_launches_bn254 += kernels
    if rc != 0:
        from fabric_tpu_torch.csp.cuda import build

        raise RuntimeError(
            f"bn254 commitments kernel launch failed: CUDA error {rc} "
            f"({build.load('bn254_commit').bn254_error_string(rc).decode()})"
        )
    return out


__all__ = [
    "NWINDOWS",
    "OUT_ROWS",
    "consts",
    "digits_from_ints",
    "shared_table",
    "pack",
    "upload",
    "unpack",
    "term_partials_plain",
    "reduce_plain",
    "commitments_plain",
    "launcher",
    "commitments",
]
