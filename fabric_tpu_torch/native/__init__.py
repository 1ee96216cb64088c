"""The port's C++ host library, loaded with ctypes.

The port's own copy of the JAX package's `fabric_tpu/native`: the batch
signature packer (`marshal.cc`) that feeds the P-256 kernels, BN254 G1
multiplication, MSM (`bn254.cc`) and the pairing check (`pairing.cc`,
both on `fp254.h`) for the idemix host path, the validator's block
walk (`collect.cc`: envelope checks, offsets and SHA-256 digests), and the
host ECDSA batch verifier of the CSP's degraded mode (`ecverify.cc`).
They include the C++ standard library and, for the `dlopen` of the
host's libcrypto, `<dlfcn.h>`: `collect.cc` takes its SHA-256 when
present, else a scalar loop (`sha256_impl` says which); `ecverify.cc`
verifies through it and answers nothing without it
(`ecdsa_verify_host` returns None, and the caller takes `hostref`).

The library is built at first use with the host C++ compiler (`g++ -O2
-std=c++17 -shared -fPIC`) into the git-ignored `build/` beside this file,
under a key that hashes the sources, the flags and the compiler's path and
version: an unchanged tree loads the library it built before.  A build
goes to a temporary file renamed into place under a file lock, so
processes that start at once (test workers) build it once.  There is no
fallback: where the library cannot build or load, every entry point
raises `NativeBuildError` with the compiler's or the loader's log (the
JAX package falls back to Python there).  A build failure is never taken for a device failure:
the CSP's degraded mode lets it through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
SOURCES = ("marshal.cc", "bn254.cc", "pairing.cc", "collect.cc",
           "ecverify.cc")
HEADERS = ("fp254.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ldl",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_BN254_R = 0x30644e72e131a029b85045b68181585d2833e84879b9709143e1f593f0000001


class NativeBuildError(RuntimeError):
    """The C++ host library could not be built or loaded (no g++, a
    compile error, a library that will not load or lacks a symbol).  Never a device failure: no breaker counts it and no host
    path answers in its place."""


def _build_key(cxx: str, version: str) -> str:
    # fabriclint: allow[csp-seam] build-cache key over the C++ sources and
    # flags — build metadata, not consensus bytes
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(cxx.encode())
    h.update(version.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Build the library unless this tree's build exists; returns its
    path.  Raises NativeBuildError without g++ or when the compile fails
    (with the compiler's output, also kept beside the library)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH: the port's C++ host "
                               "library cannot be built on this host")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    out = BUILD_DIR / f"libfabricnative-{_build_key(cxx, version)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it meanwhile
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
               *(str(SRC_DIR / s) for s in SOURCES), *LIBS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        out.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"g++ failed:\n$ {' '.join(cmd)}\n"
                                   f"{proc.stdout}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError) as e:
                raise NativeBuildError(f"{path} does not load: {e}") from e
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the library's entry points;
    raises AttributeError where one is missing."""
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    fn = lib.fabric_marshal_batch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_char_p] * 4
        + [np.ctypeslib.ndpointer(np.int32, flags="C")]
        + [u32p] * 5 + [u8p] * 2)
    msm = lib.bn254_g1_msm
    msm.restype = ctypes.c_int
    msm.argtypes = [ctypes.c_int] + [ctypes.c_char_p] * 3 + [u8p] * 2
    mm = lib.bn254_g1_mul_many
    mm.restype = ctypes.c_int
    mm.argtypes = [ctypes.c_int] + [ctypes.c_char_p] * 3 + [u8p] * 3
    pc = lib.bn254_pairing_check
    pc.restype = ctypes.c_int
    pc.argtypes = [ctypes.c_int] + [ctypes.c_char_p] * 6
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    cb = lib.fabric_collect_block
    cb.restype = ctypes.c_int
    cb.argtypes = (
        [ctypes.c_int, ctypes.c_char_p, i64p, ctypes.c_char_p,
         ctypes.c_int]
        + [i32p, i32p]                    # status, type
        + [i64p, i32p] * 2 + [u8p]        # creator, sig, payload_digest
        + [i64p, i32p] * 4                # txid, prp, rwset, ccid
        + [i32p, i32p, ctypes.c_int]      # endo_start/count, max
        + [i64p, i32p] * 2 + [u8p]        # endorser, esig, edigest
    )
    lib.fabric_collect_sha256_impl.restype = ctypes.c_int
    lib.fabric_collect_sha256_impl.argtypes = []
    ev = lib.fabric_ecdsa_verify_host
    ev.restype = ctypes.c_int
    ev.argtypes = [ctypes.c_int] + [ctypes.c_char_p] * 3 + [i32p] * 2 \
        + [u8p]
    return lib


def marshal_batch(xs: bytes, ys: bytes, digests: bytes, sigs: bytes,
                  sig_off: np.ndarray) -> dict:
    """One pass: DER parse + prechecks + batch inversion + packing.
    Inputs: concatenated 32-byte big-endian x/y/digest buffers and
    concatenated DER signatures with (n+1,) int32 offsets.  Returns the
    packed dict of `p256_kernel.prepare_packed`'s layout."""
    sig_off = np.ascontiguousarray(sig_off, np.int32)
    n = len(sig_off) - 1
    if n < 0 or min(len(xs), len(ys), len(digests)) < 32 * n:
        raise ValueError("marshal_batch: buffers shorter than 32 bytes a lane")
    if n and (sig_off[0] < 0 or (np.diff(sig_off) < 0).any()
              or sig_off[-1] > len(sigs)):
        raise ValueError("marshal_batch: sig_off is not offsets into sigs")
    lib = load()
    qx = np.empty((8, n), np.uint32)
    qy = np.empty((8, n), np.uint32)
    d1 = np.empty((8, n), np.uint32)
    d2 = np.empty((8, n), np.uint32)
    c0 = np.empty((8, n), np.uint32)
    c1ok = np.empty(n, np.uint8)
    valid = np.empty(n, np.uint8)
    lib.fabric_marshal_batch(n, xs, ys, digests, sigs, sig_off,
                             qx, qy, d1, d2, c0, c1ok, valid)
    return {
        "qx": qx,
        "qy": qy,
        "d1": d1,
        "d2": d2,
        "cand0": c0,
        "cand1_ok": c1ok.astype(bool),
        "valid": valid.astype(bool),
    }


def ecdsa_verify_host(items) -> list[bool] | None:
    """Batched host ECDSA-P256 verification through the host's libcrypto
    (`ecverify.cc`, `EVP_PKEY_verify` with one context per distinct key):
    the degraded mode's host verifier.  Verdicts are `hostref.verify`'s
    (strict DER, low-S, a digest of 32 bytes).  Returns None where no
    libcrypto loads (the caller takes `hostref`); raises NativeBuildError
    where the library cannot build.  The call releases the GIL."""
    lib = load()
    n = len(items)
    if n == 0:
        return []
    qxy = bytearray(64 * n)
    digs = bytearray(32 * n)
    sig_off = np.empty(n, np.int32)
    sig_len = np.empty(n, np.int32)
    sigs = bytearray()
    for i, it in enumerate(items):
        key = it.key
        pub = key.public_key() if getattr(key, "is_private", False) else key
        try:
            qxy[64 * i:64 * i + 32] = pub.x_bytes
            qxy[64 * i + 32:64 * i + 64] = pub.y_bytes
        except (AttributeError, ValueError):
            pass  # a zero key verifies no signature
        if len(it.digest) == 32:
            digs[32 * i:32 * i + 32] = it.digest
        sig_off[i] = len(sigs)
        sig_len[i] = len(it.signature)
        sigs += it.signature
    out = np.zeros(n, np.uint8)
    if lib.fabric_ecdsa_verify_host(n, bytes(qxy), bytes(digs), bytes(sigs),
                                    sig_off, sig_len, out) != 0:
        return None  # no libcrypto on this host
    mask = out.astype(bool)
    for i, it in enumerate(items):
        if len(it.digest) != 32:
            mask[i] = False  # hostref rejects it; the zero row would too
    return mask.tolist()


def ecdsa_impl() -> str:
    """Which verifier `ecdsa_verify_host` runs: "libcrypto", or "none"
    where no libcrypto loads (it then returns None)."""
    none = np.zeros(0, np.int32)
    rc = load().fabric_ecdsa_verify_host(0, b"", b"", b"", none, none,
                                          np.zeros(0, np.uint8))
    return "libcrypto" if rc == 0 else "none"


def _g1_buffers(points, scalars):
    """Big-endian x, y and scalar buffers; None (infinity) as (0, 0)."""
    n = len(points)
    xs, ys, ss = bytearray(32 * n), bytearray(32 * n), bytearray(32 * n)
    for i, (pt, k) in enumerate(zip(points, scalars)):
        if pt is None:
            continue
        xs[32 * i:32 * i + 32] = pt[0].to_bytes(32, "big")
        ys[32 * i:32 * i + 32] = pt[1].to_bytes(32, "big")
        ss[32 * i:32 * i + 32] = (k % _BN254_R).to_bytes(32, "big")
    return bytes(xs), bytes(ys), bytes(ss)


def bn254_msm(points, scalars) -> tuple[int, int] | None:
    """sum_i scalars[i] * points[i] over BN254 G1 (affine int coords;
    None encodes a point at infinity, on input and output)."""
    lib = load()
    ox = np.zeros(32, np.uint8)
    oy = np.zeros(32, np.uint8)
    if lib.bn254_g1_msm(len(points), *_g1_buffers(points, scalars), ox, oy):
        return None
    return (int.from_bytes(ox.tobytes(), "big"),
            int.from_bytes(oy.tobytes(), "big"))


def bn254_mul_many(points, scalars) -> list[tuple[int, int] | None]:
    """Independent scalars[i] * points[i]; one shared field inversion."""
    lib = load()
    n = len(points)
    ox = np.zeros(32 * n, np.uint8)
    oy = np.zeros(32 * n, np.uint8)
    inf = np.zeros(n, np.uint8)
    lib.bn254_g1_mul_many(n, *_g1_buffers(points, scalars), ox, oy, inf)
    b_ox, b_oy = ox.tobytes(), oy.tobytes()
    return [
        None if inf[i] else (
            int.from_bytes(b_ox[32 * i:32 * i + 32], "big"),
            int.from_bytes(b_oy[32 * i:32 * i + 32], "big"))
        for i in range(n)
    ]


def bn254_pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1?  pairs: [(g1_point|None, g2_point|None)]
    with g1 = (x, y) ints and g2 = ((xa, xb), (ya, yb)) Fp2 ints."""
    lib = load()
    n = len(pairs)
    bufs = [bytearray(32 * n) for _ in range(6)]
    for i, (pg1, qg2) in enumerate(pairs):
        if pg1 is None or qg2 is None:
            continue  # identity factor
        o = 32 * i
        for buf, v in zip(bufs, (pg1[0], pg1[1], qg2[0][0], qg2[0][1],
                                 qg2[1][0], qg2[1][1])):
            buf[o:o + 32] = v.to_bytes(32, "big")
    return bool(lib.bn254_pairing_check(n, *(bytes(b) for b in bufs)))


_COLLECT_PER_TX = (
    ("status", np.int32), ("type", np.int32),
    ("creator_off", np.int64), ("creator_len", np.int32),
    ("sig_off", np.int64), ("sig_len", np.int32),
    ("txid_off", np.int64), ("txid_len", np.int32),
    ("prp_off", np.int64), ("prp_len", np.int32),
    ("rwset_off", np.int64), ("rwset_len", np.int32),
    ("ccid_off", np.int64), ("ccid_len", np.int32),
    ("endo_start", np.int32), ("endo_count", np.int32),
)


def collect_block(env_bytes: bytes, env_off: np.ndarray,
                  channel_id: bytes) -> dict:
    """One C++ pass over a block's envelopes (`collect.cc`): the syntactic
    checks, and per transaction the offsets (into `env_bytes`) and SHA-256
    digests the validator needs.  `env_off` holds n + 1 offsets of the
    concatenated envelopes.  `status` is 0 for a well-formed endorser
    transaction, 1 for a config transaction, negative otherwise (the
    caller re-derives those lanes in Python)."""
    env_off = np.ascontiguousarray(env_off, np.int64)
    n = len(env_off) - 1
    if n < 0 or env_off[0] != 0 or (np.diff(env_off) < 0).any() \
            or env_off[-1] != len(env_bytes):
        raise ValueError("collect_block: env_off is not offsets of env_bytes")
    lib = load()
    out = {name: np.zeros(n, dt) for name, dt in _COLLECT_PER_TX}
    out["payload_digest"] = np.zeros(32 * n, np.uint8)
    max_endos = max(64, 8 * n)  # >= 8 endorsements a transaction, else retry
    while True:
        endos = {
            "e_endorser_off": np.zeros(max_endos, np.int64),
            "e_endorser_len": np.zeros(max_endos, np.int32),
            "e_sig_off": np.zeros(max_endos, np.int64),
            "e_sig_len": np.zeros(max_endos, np.int32),
            "e_digest": np.zeros(32 * max_endos, np.uint8),
        }
        rc = lib.fabric_collect_block(
            n, env_bytes, env_off, channel_id, len(channel_id),
            out["status"], out["type"],
            out["creator_off"], out["creator_len"],
            out["sig_off"], out["sig_len"], out["payload_digest"],
            out["txid_off"], out["txid_len"],
            out["prp_off"], out["prp_len"],
            out["rwset_off"], out["rwset_len"],
            out["ccid_off"], out["ccid_len"],
            out["endo_start"], out["endo_count"], max_endos,
            endos["e_endorser_off"], endos["e_endorser_len"],
            endos["e_sig_off"], endos["e_sig_len"], endos["e_digest"],
        )
        if rc >= 0:
            out.update(endos)
            out["n_endos"] = rc
            return out
        max_endos *= 4


def sha256_impl() -> str:
    """Which SHA-256 `collect_block` runs: "libcrypto" (the host's,
    dlopened) or "scalar" (the loop in collect.cc)."""
    return "libcrypto" if load().fabric_collect_sha256_impl() else "scalar"


__all__ = ["NativeBuildError", "build", "load", "marshal_batch",
           "ecdsa_verify_host", "ecdsa_impl", "bn254_msm", "bn254_mul_many",
           "bn254_pairing_check", "collect_block", "sha256_impl"]
