"""Batched ECDSA-P256 verification: host packing, the plain PyTorch
version, and the wrapper that launches the CUDA kernel.

Counterpart of `fabric_tpu/csp/tpu/pallas_ec.py`.  The packed layout is
the JAX package's, so the two can be fed the same state: per-lane 256-bit
values as (8, B) 32-bit words (least significant word first, lanes on
the last axis), window digits packed 8 per word (digit k in bits
4*(k%8) of word k//8, MSB-first windows), and either per-lane keys
`qx`/`qy` or a shared (8, KEYTAB) key table `ktabx`/`ktaby` with a
per-lane index `kidx`.  On the device every word array is int32 (CPU
torch has few uint32 kernels; the bits are the same) and the two
per-lane flags travel as one (2, B) int32 `flags` = [cand1_ok; valid].

The key-table layout also carries, per key of the table, its quarter
tables `qtab` (KEYTAB, 4, 16, 2, 8): the affine multiples d 2^(64 j) Q
for the quarters j = 0..3 and d = 0..15, entry 0 at infinity, built on
the host by `key_quarter_tables` once per key; and `keybad` (KEYTAB,),
1 for a key that is not on P-256 (a padding entry's zero point among
them), which gets no tables and whose lanes the kernel rejects.
The plain version reads `ktabx`/`ktaby` only.

`verify_packed` launches `p256_verify_keytab` (replacing
`pallas_ec._kernel_dedup`) or `p256_verify_lanekeys` (replacing
`pallas_ec._kernel`) from `csrc/p256_verify.cu` for CUDA tensors, both
with G's quarter tables (`g_quarter_table`), and runs
`verify_packed_plain` only for CPU tensors.  The per-lane-key kernel
builds each lane's table of its key on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fabric_tpu_torch import native
from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import (
    P256_GX,
    P256_GY,
    P256_N,
    P256_P,
    on_curve,
    unmarshal_ecdsa_signature,
)
from fabric_tpu_torch.csp.cuda import ec
from fabric_tpu_torch.csp.cuda.limbs import (
    FpP256,
    batch_inverse,
    int_to_words,
    solinas_matrix,
    words_to_int,
)

KEYTAB = 256  # key-table entries of the key-table kernel
QUARTERS = 4  # 64-bit quarters of a scalar, one table each
# per base: quarter, entry, coordinate (x, y), word
QTAB_SHAPE = (QUARTERS, ec.TABLE, 2, 8)

# the packed arrays of uint32 words, int32 on the device
U32_KEYS = ("qx", "qy", "ktabx", "ktaby", "qtab", "keybad", "kidx", "d1",
            "d2", "cand0")
# the arrays of the key table, shared by every lane (not sliced by lane)
TABLE_KEYS = ("ktabx", "ktaby", "qtab", "keybad")

# Kernel launches by the wrapper, one per launch of each entry point
# (plain-version calls on CPU tensors do not count).
launches_keytab = 0
launches_lanekeys = 0


@functools.lru_cache(maxsize=None)
def consts() -> dict:
    """The constants of the verify, as numpy: p and n as (8,) words, the
    fixed base-point window table as (16, 8) words of x and y with its
    infinity flags, and the limb-level Solinas matrix of the plain field.
    `convert.consts_from_jax` builds the same dict from `pallas_ec._consts`."""
    gx, gy, ginf = ec.g_table()
    return dict(
        p=int_to_words(P256_P),
        n=int_to_words(P256_N),
        gx=gx,
        gy=gy,
        ginf=ginf,
        solmat=solinas_matrix(),
    )


def _quarter_multiples(x: int, y: int) -> list:
    """The Jacobian multiples d 2^(64 j) (x, y) for j = 0..3 and d =
    1..15, quarter-major: 192 doublings and 56 additions."""
    out = []
    base = (x, y, 1)
    for j in range(QUARTERS):
        if j:
            for _ in range(64):
                base = hostref._jdbl(base)
        acc = base
        out.append(acc)
        for _ in range(ec.TABLE - 2):
            acc = hostref._jadd(acc, base)
            out.append(acc)
    return out


def key_quarter_tables(ktabx, ktaby) -> dict:
    """The quarter tables of the keys of (8, K) word tables: {"qtab":
    (K, 4, 16, 2, 8) uint32 affine words, "keybad": (K,) uint32}.

    Coordinates are read mod p, as the kernel's loads reduce them.  A key
    that is not on P-256 (the zero point included) gets keybad = 1 and
    zero tables.  One batched inversion serves every key of the call."""
    kx = np.asarray(ktabx, np.uint32)
    ky = np.asarray(ktaby, np.uint32)
    k = kx.shape[1]
    qtab = np.zeros((k, *QTAB_SHAPE), np.uint32)
    keybad = np.ones(k, np.uint32)
    good, pts = [], []
    for i in range(k):
        x = words_to_int(kx[:, i]) % P256_P
        y = words_to_int(ky[:, i]) % P256_P
        if on_curve(x, y):
            keybad[i] = 0
            good.append(i)
            pts.extend(_quarter_multiples(x, y))
    if not good:
        return {"qtab": qtab, "keybad": keybad}
    invs = batch_inverse([pt[2] for pt in pts], P256_P)
    coords = []
    for (x, y, _), zi in zip(pts, invs):
        zi2 = zi * zi % P256_P
        coords.append((x * zi2 % P256_P).to_bytes(32, "little"))
        coords.append((y * zi2 * zi % P256_P).to_bytes(32, "little"))
    words = np.frombuffer(b"".join(coords), np.uint32).reshape(
        len(good), QUARTERS, ec.TABLE - 1, 2, 8)
    qtab[good, :, 1:] = words
    return {"qtab": qtab, "keybad": keybad}


@functools.lru_cache(maxsize=None)
def g_quarter_table() -> np.ndarray:
    """(4, 16, 2, 8) uint32, read-only: G's quarter tables, d 2^(64 j)
    G."""
    gx = int_to_words(P256_GX)[:, None]
    gy = int_to_words(P256_GY)[:, None]
    tab = key_quarter_tables(gx, gy)["qtab"][0]
    tab.flags.writeable = False
    return tab


@functools.lru_cache(maxsize=None)
def _gqtab(device: str) -> torch.Tensor:
    """G's quarter tables as int32 words on `device`."""
    g = g_quarter_table().view(np.int32).copy()
    return torch.as_tensor(g, device=device).contiguous()


# ---------------------------------------------------------------------------
# Host packing: the C++ packer of the main path, and its plain version
# (numpy; copies of pallas_ec.prepare_packed / dedup_keys).
# ---------------------------------------------------------------------------


def pack_items(items) -> dict:
    """VerifyBatchItems -> the packed numpy dict, through the port's C++
    packer (`native.marshal_batch`: DER parse, prechecks, one batch
    inversion, digits), as `TPUCSP._marshal_native` packs.  Its plain
    version is `prepare_packed(lane_tuples(items))`, array for array: a
    lane whose digest is not 32 bytes goes in with a zero digest and no
    signature, so the packer marks it invalid and packs it as it packs
    every invalid lane.  Raises where the library cannot build."""
    xs, ys, digs, sigs = [], [], [], []
    offs = np.zeros(len(items) + 1, np.int32)
    for i, it in enumerate(items):
        key = it.key
        if getattr(key, "is_private", False):
            key = key.public_key()
        xs.append(key.x_bytes)
        ys.append(key.y_bytes)
        sig = it.signature
        if len(it.digest) == 32:
            digs.append(it.digest)
        else:
            digs.append(bytes(32))
            sig = b""
        sigs.append(sig)
        offs[i + 1] = offs[i] + len(sig)
    return native.marshal_batch(b"".join(xs), b"".join(ys), b"".join(digs),
                                b"".join(sigs), offs)


def lane_tuples(items) -> list[tuple]:
    """VerifyBatchItems -> the (x, y, digest, r, s) tuples of
    `prepare_packed`.  A private key stands for its point; a signature
    that is not strict DER gets r = s = -1, which marks the lane
    invalid."""
    out = []
    for it in items:
        key = it.key
        if getattr(key, "is_private", False):
            key = key.public_key()
        try:
            r, s = unmarshal_ecdsa_signature(it.signature)
        except ValueError:
            r, s = -1, -1
        out.append((key.x, key.y, it.digest, r, s))
    return out


def prepare_packed(items) -> dict:
    """(x, y, digest32, r, s) tuples -> the packed numpy dict.

    Lanes failing the prechecks (0 < r < n, 0 < s <= n/2, 32-byte
    digest) get valid=False and are substituted with (G, u1 = u2 =
    cand0 = 1), as `pallas_ec.prepare_packed` does.  One modular
    inversion serves the batch (Montgomery's trick over the s values)."""
    n = len(items)
    half_n = P256_N >> 1
    valid = np.zeros(n, bool)
    c1_ok = np.zeros(n, bool)
    svals = []
    for i, it in enumerate(items):
        r, s = it[3], it[4]
        if (
            isinstance(r, int)
            and isinstance(s, int)
            and 0 < r < P256_N
            and 0 < s <= half_n
            and len(it[2]) == 32
        ):
            valid[i] = True
            svals.append(s)
        else:
            svals.append(1)

    prefix = [1] * (n + 1)
    for i in range(n):
        prefix[i + 1] = prefix[i] * svals[i] % P256_N
    inv = pow(prefix[n], -1, P256_N)

    xb = bytearray(32 * n)
    yb = bytearray(32 * n)
    u1b = bytearray(32 * n)
    u2b = bytearray(32 * n)
    c0b = bytearray(32 * n)
    for i in range(n - 1, -1, -1):
        it = items[i]
        w = inv * prefix[i] % P256_N
        inv = inv * svals[i] % P256_N
        o = 32 * i
        if not valid[i]:
            x, y, u1, u2, c0 = P256_GX, P256_GY, 1, 1, 1
        else:
            x, y = it[0], it[1]
            r = it[3]
            e = int.from_bytes(it[2], "big") % P256_N
            u1 = e * w % P256_N
            u2 = r * w % P256_N
            c0 = r
            if r + P256_N < P256_P:
                c1_ok[i] = True
        xb[o:o + 32] = x.to_bytes(32, "little")
        yb[o:o + 32] = y.to_bytes(32, "little")
        u1b[o:o + 32] = u1.to_bytes(32, "little")
        u2b[o:o + 32] = u2.to_bytes(32, "little")
        c0b[o:o + 32] = c0.to_bytes(32, "little")

    def words(buf):  # (B, 32) LE bytes -> (8, B) u32 words
        return np.ascontiguousarray(
            np.frombuffer(bytes(buf), np.uint32).reshape(n, 8).T
        )

    def digits_packed(buf):  # LE bytes -> (8, B) u32, MSB-first nibbles
        u8 = np.frombuffer(bytes(buf), np.uint8).reshape(n, 32)
        nibbles = np.empty((n, 64), np.uint32)
        nibbles[:, 0::2] = u8 & 0xF
        nibbles[:, 1::2] = u8 >> 4
        d = nibbles[:, ::-1]  # digit k = nibble 63-k
        shifts = (np.uint32(4) * np.arange(8, dtype=np.uint32))[None, None]
        return np.ascontiguousarray(
            (d.reshape(n, 8, 8) << shifts).sum(axis=2, dtype=np.uint32).T
        )

    return {
        "qx": words(xb),
        "qy": words(yb),
        "d1": digits_packed(u1b),
        "d2": digits_packed(u2b),
        "cand0": words(c0b),
        "cand1_ok": c1_ok,
        "valid": valid,
    }


def dedup_keys(packed: dict) -> dict:
    """The key-table layout of a packed dict, with the table's quarter
    tables, when the batch uses at most KEYTAB distinct public keys;
    otherwise the dict unchanged."""
    qx, qy = packed["qx"], packed["qy"]
    cols = np.concatenate([qx, qy]).T  # (B, 16) words per key
    uniq, idx = np.unique(cols, axis=0, return_inverse=True)
    if uniq.shape[0] > KEYTAB:
        return packed
    ktab = np.zeros((KEYTAB, 16), np.uint32)
    ktab[: uniq.shape[0]] = uniq
    out = {k: v for k, v in packed.items() if k not in ("qx", "qy")}
    out["ktabx"] = np.ascontiguousarray(ktab[:, :8].T)
    out["ktaby"] = np.ascontiguousarray(ktab[:, 8:].T)
    out["kidx"] = idx.reshape(-1).astype(np.uint32)
    out.update(key_quarter_tables(out["ktabx"], out["ktaby"]))
    return out


def upload(packed: dict, device, shared: dict | None = None) -> dict:
    """A packed numpy dict -> the kernel's tensors on `device`.

    For a CUDA device each array goes through pinned host memory and a
    non_blocking copy on the current stream.  `shared` holds tensors
    already on the device (the provider's resident key table); they
    replace the dict's own arrays of the same names."""
    dev = torch.device(device)
    host = {}
    for k in U32_KEYS:
        if k in packed and not (shared and k in shared):
            host[k] = np.ascontiguousarray(packed[k], np.uint32).view(np.int32)
    host["flags"] = np.stack(
        [np.asarray(packed["cand1_ok"]), np.asarray(packed["valid"])]
    ).astype(np.int32)
    out = dict(shared or {})
    for k, v in host.items():
        t = torch.from_numpy(v)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _digits(words: torch.Tensor) -> torch.Tensor:
    """(8, B) packed digit words -> (B, 64) window digits, MSB first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, device=words.device)
    d = (w[:, None, :] >> shifts[None, :, None]) & 0xF  # (8, 8, B)
    return d.reshape(64, -1).T


def _lane_keys(fp: FpP256, t: dict):
    """Per-lane Q limbs; a table index outside KEYTAB selects the zero
    point, as the one-hot gather of `pallas_ec._kernel_dedup` does."""
    if "kidx" not in t:
        return fp.from_words(t["qx"]), fp.from_words(t["qy"])
    idx = t["kidx"].to(torch.int64) & 0xFFFFFFFF
    inside = idx < KEYTAB
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    tx, ty = fp.from_words(t["ktabx"]), fp.from_words(t["ktaby"])
    return tx[idx] * inside[:, None], ty[idx] * inside[:, None]


def verify_packed_plain(t: dict) -> torch.Tensor:
    """The verify of `pallas_ec._kernel_body` (`pallas_ec.py:588-696`)
    in plain PyTorch, on the device of the tensors: (B,) bool.

    A 16-entry Jacobian window table of Q (14 mixed adds), a 64-window
    MSB-first joint Shamir ladder u1*G + u2*Q (4 doublings, a mixed add
    from the fixed G table, a full add from the Q table), then the check
    x(R) == cand * Z^2 (mod p) without inversion, for cand0 = r and, when
    the host flagged r + n < p, cand1 = r + n.  Lanes whose R is at
    infinity or has Z == 0, or that the host marked invalid, are
    rejected."""
    dev = t["d1"].device
    fp = FpP256(dev)
    qx, qy = _lane_keys(fp, t)
    b = qx.shape[0]
    zero = torch.zeros_like(qx)
    one = fp.from_ints([1]).expand(b, -1)
    fin = torch.zeros(b, dtype=torch.bool, device=dev)
    at_inf = torch.ones(b, dtype=torch.bool, device=dev)

    tab = [(zero, zero, zero, at_inf), (qx, qy, one, fin)]
    for _ in range(2, ec.TABLE):
        tab.append(ec.add_mixed(fp, tab[-1], (qx, qy, fin), one))
    tabs = [torch.stack([p[k] for p in tab]) for k in range(4)]

    c = consts()
    gx = fp.from_words(torch.as_tensor(c["gx"].T.astype(np.int64), device=dev))
    gy = fp.from_words(torch.as_tensor(c["gy"].T.astype(np.int64), device=dev))
    d1, d2 = _digits(t["d1"]), _digits(t["d2"])
    lanes = torch.arange(b, device=dev)

    r = (zero, zero, zero, at_inf)
    for w in range(ec.NWINDOWS):
        for _ in range(4):
            r = ec.dbl(fp, r)
        k1 = d1[:, w]
        r = ec.add_mixed(fp, r, (gx[k1], gy[k1], k1 == 0), one)
        k2 = d2[:, w]
        r = ec.add_full(fp, r, tuple(tb[k2, lanes] for tb in tabs))
    x, _, z, inf = r

    z2 = fp.sqr(z)
    cand0 = fp.from_words(t["cand0"])
    m0 = fp.eq(x, fp.mul(cand0, z2))
    n_limbs = fp.from_words(
        torch.as_tensor(c["n"].astype(np.int64)[:, None], device=dev)
    )
    m1 = fp.eq(x, fp.mul(fp.add(cand0, n_limbs.expand(b, -1)), z2))
    cand1_ok = t["flags"][0] != 0
    valid = t["flags"][1] != 0
    return (m0 | (m1 & cand1_ok)) & ~inf & ~fp.is_zero(z) & valid


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


def _check(t: dict, keytab: bool, device: torch.device) -> int:
    """Validate what the kernel reads, G's quarter tables `gqtab` among
    it; returns the lane count."""
    b = t["d1"].shape[-1]
    shapes = {"d1": (8, b), "d2": (8, b), "cand0": (8, b), "flags": (2, b),
              "gqtab": QTAB_SHAPE}
    if keytab:
        shapes.update(qtab=(KEYTAB, *QTAB_SHAPE), keybad=(KEYTAB,),
                      kidx=(b,))
    else:
        shapes.update(qx=(8, b), qy=(8, b))
    for k, shape in shapes.items():
        v = t[k]
        if v.device != device or v.dtype != torch.int32:
            raise ValueError(f"{k}: expected int32 on {device}, got "
                             f"{v.dtype} on {v.device}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{k}: expected contiguous {shape}, got "
                             f"{tuple(v.shape)}")
    return b


def launcher(t: dict) -> tuple:
    """The kernel's launch on the packed CUDA tensors `t`, prepared:
    (a call with no arguments that launches it once on the current stream
    and returns the CUDA error code, the (B,) bool output it writes).
    The tensors are checked here; the call counts nothing (the wrapper
    counts its launches) and a timing calls it bare.  With B = 0 the call
    is None."""
    from fabric_tpu_torch.csp.cuda import build

    dev = t["d1"].device
    lib = build.load()
    keytab = "kidx" in t
    gq = _gqtab(str(dev))
    b = _check({**t, "gqtab": gq}, keytab, dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return None, out
    ptr = ctypes.c_void_p
    common = [
        ptr(t["d1"].data_ptr()),
        ptr(t["d2"].data_ptr()),
        ptr(t["cand0"].data_ptr()),
        ptr(t["flags"].data_ptr()),
    ]
    tail = [
        ptr(out.data_ptr()),
        ctypes.c_int(b),
        ptr(torch.cuda.current_stream(dev).cuda_stream),
    ]
    if keytab:
        fn = lib.p256_verify_keytab
        args = [ptr(t["qtab"].data_ptr()), ptr(t["keybad"].data_ptr()),
                ptr(t["kidx"].data_ptr()), *common, ptr(gq.data_ptr()),
                *tail]
    else:
        fn = lib.p256_verify_lanekeys
        args = [ptr(t["qx"].data_ptr()), ptr(t["qy"].data_ptr()), *common,
                ptr(gq.data_ptr()), *tail]
    return build.Launch(fn, args, (*t.values(), gq, out)), out


def verify_packed(t: dict) -> torch.Tensor:
    """(B,) bool verdicts for the packed tensors `t` (see `upload`).

    CUDA tensors launch the hand-written kernel on the current stream
    and return without synchronising; CPU tensors run
    `verify_packed_plain`.  A launch error raises."""
    global launches_keytab, launches_lanekeys
    dev = t["d1"].device
    if dev.type == "cpu":
        return verify_packed_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    launch, out = launcher(t)
    if launch is None:
        return out
    rc = launch()
    if "kidx" in t:
        launches_keytab += 1
    else:
        launches_lanekeys += 1
    if rc != 0:
        from fabric_tpu_torch.csp.cuda import build

        raise RuntimeError(
            f"p256 verify kernel launch failed: CUDA error {rc} "
            f"({build.load().p256_error_string(rc).decode()})"
        )
    return out


__all__ = [
    "KEYTAB",
    "QUARTERS",
    "QTAB_SHAPE",
    "TABLE_KEYS",
    "consts",
    "key_quarter_tables",
    "g_quarter_table",
    "pack_items",
    "lane_tuples",
    "prepare_packed",
    "dedup_keys",
    "upload",
    "verify_packed_plain",
    "launcher",
    "verify_packed",
]
