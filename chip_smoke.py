#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name, and its name and power limit from nvidia-smi.
2. Builds the kernels from `fabric_tpu_torch/csp/cuda/csrc` and prints the
   build time and the compiler's register/spill summary.
3. Holds both entry points of the P-256 verify kernel against their plain
   PyTorch versions and the pure-Python reference (`hostref`) on 256 lanes
   of edge cases.
4. Verifies 8 block-shaped batches (1000 transactions x (1 creator + 3
   endorsers), 4 keys of a 5-org world) through `CUDACSP.verify_batch_async`
   up to 6 deep, then one 4000-lane batch over 300 keys (the per-lane-key
   kernel), with launch counts set to 0 just before and read just after.
5. Times each kernel at the main path's shapes against its plain version
   and prints one JSON line of kernels.
6. Prints `{"ok": true, "device": {...}}` as its last line.

Exits non-zero, before printing any result, on a host without CUDA; any
failed phase raises.  Inputs are made from a seed with numpy.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fabric_tpu_torch.csp import hostref
from fabric_tpu_torch.csp.api import (
    P256_B,
    P256_N,
    P256_P,
    VerifyBatchItem,
    marshal_ecdsa_signature,
    unmarshal_ecdsa_signature,
)
from fabric_tpu_torch.csp.cuda import build
from fabric_tpu_torch.csp.cuda import p256_kernel as pk
from fabric_tpu_torch.csp.cuda.provider import CUDACSP

SEED = 0
N_ORGS = 5
N_TXS = 1000  # transactions per block
ENDORSERS = 3  # endorsements per transaction (3-of-5)
N_BLOCKS = 8
DEPTH = 6  # batches in flight before the oldest is collected
EDGE_LANES = 256
MANY_KEYS = 300  # distinct keys of the batch that overflows the key table
TIMING_REPS = 5
PLAIN_REPS = 3

SOURCE = "fabric_tpu_torch/csp/cuda/csrc/p256_verify.cu"
REPLACES = {
    "p256_verify_keytab": "fabric_tpu/csp/tpu/pallas_ec.py:562",
    "p256_verify_lanekeys": "fabric_tpu/csp/tpu/pallas_ec.py:547",
}

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, used for the kernel's
# 32x32->64-bit multiply-adds (2 operations each, as an FMA counts 2
# FLOPs).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 67e12

# Field multiplications per signature: the Q table's 14 mixed adds (11
# each), 4 doublings of 8 per window, and the final check's 3; mixed adds
# (11) and full adds (16) only for nonzero digits.  64 32x32 products each.
FIELD_MULS_TABLE = 14 * 11
FIELD_MULS_DBL = 64 * 4 * 8
FIELD_MULS_FINAL = 3
WORD_PRODUCTS = 64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------


def cand1_lane():
    """A signature valid only through cand1 = r + n: R = Q with x(R) >= n,
    digest = n (e = 0) and s = r, so u1 G + u2 Q = Q."""
    x = P256_N
    while True:
        x += 1
        t = (pow(x, 3, P256_P) - 3 * x + P256_B) % P256_P
        y = pow(t, (P256_P + 1) // 4, P256_P)
        if y * y % P256_P == t:
            break
    r = x - P256_N
    return (x, y, P256_N.to_bytes(32, "big"), r, r)


def edge_lanes(rng, n: int):
    """n lanes of (x, y, digest, r, s) and their kernel layouts, with one
    lane of each edge case; returns (lanes, out_of_table lane index)."""
    keys = [hostref.key_gen(rng) for _ in range(4)]
    lanes = []
    for i in range(n):
        key = keys[i % len(keys)]
        digest = hashlib.sha256(b"edge-%d" % i).digest()
        r, s = unmarshal_ecdsa_signature(hostref.sign(key, digest, rng))
        pub = key.public_key()
        lanes.append([pub.x, pub.y, digest, r, s])
    lanes[1][2] = hashlib.sha256(b"tampered").digest()
    lanes[2][4] = P256_N - lanes[2][4]  # high-S
    lanes[3][3] = 0  # r = 0
    lanes[4][3] = P256_N  # r = n
    lanes[5][3] = P256_N + 5  # r > n
    lanes[6][3:5] = [-1, -1]  # malformed DER, as the provider marks it
    lanes[7][2] = lanes[7][2][:31]  # short digest
    lanes[8] = list(cand1_lane())
    lanes[9][3] += 1  # wrong r, valid range
    return [tuple(v) for v in lanes], 10


def block_world(rng):
    """The keys of a 5-org world: org i's peer, and org 0's client."""
    peers = [hostref.key_gen(rng) for _ in range(N_ORGS)]
    client = hostref.key_gen(rng)
    return client, peers


def block_items(rng, client, signers, n_txs: int):
    """One block's lanes in the validator's order: per transaction the
    creator's signature, then one per endorser."""
    items = []
    for i in range(n_txs):
        creator_digest = hashlib.sha256(b"tx-%d" % i).digest()
        items.append(VerifyBatchItem(
            client.public_key(), creator_digest,
            hostref.sign(client, creator_digest, rng),
        ))
        for j, peer in enumerate(signers):
            digest = hashlib.sha256(b"tx-%d-endorsement-%d" % (i, j)).digest()
            items.append(VerifyBatchItem(
                peer.public_key(), digest, hostref.sign(peer, digest, rng),
            ))
    return items


def plant_bad(items):
    """A copy of a block with bad lanes; returns (items, bad indexes)."""
    out = list(items)
    bad = {}
    k, d, s = out[5]
    bad[5] = VerifyBatchItem(k, hashlib.sha256(b"forged").digest(), s)
    k, d, s = out[42]
    r, sv = unmarshal_ecdsa_signature(s)
    bad[42] = VerifyBatchItem(k, d, marshal_ecdsa_signature(r, P256_N - sv))
    mid = len(out) // 4 + 1
    k, d, s = out[mid]
    bad[mid] = VerifyBatchItem(k, d, s[:-2])
    k, d, s = out[len(out) - 1]
    r, sv = unmarshal_ecdsa_signature(s)
    bad[len(out) - 1] = VerifyBatchItem(
        k, d, marshal_ecdsa_signature(r ^ 1, sv)
    )
    for i, it in bad.items():
        out[i] = it
    return out, sorted(bad)


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() between CUDA events (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(packed: dict, keytab: bool) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for verifying `packed`: each
    input read once and the mask written once over the HBM rate, against
    the multiply-adds its valid lanes need over the 32-bit peak."""
    valid = np.asarray(packed["valid"], bool)
    lanes = valid.shape[0]

    def nonzero_digits(words):
        w = np.asarray(words, np.uint32)[:, valid]
        return sum(int(((w >> (4 * k)) & 0xF).astype(bool).sum())
                   for k in range(8))

    muls = (
        int(valid.sum()) * (FIELD_MULS_TABLE + FIELD_MULS_DBL
                            + FIELD_MULS_FINAL)
        + 11 * nonzero_digits(packed["d1"])
        + 16 * nonzero_digits(packed["d2"])
    )
    ops = muls * WORD_PRODUCTS * 2
    per_lane = 3 * 32 + 8 + 1  # d1, d2, cand0, flags, the verdict
    per_lane += 4 if keytab else 64  # key index, or the key
    nbytes = lanes * per_lane + 2 * 16 * 32  # + the G table
    if keytab:
        nbytes += 2 * 8 * pk.KEYTAB * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S_32BIT * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all()
    lib = build.load()
    check(lib is not None, "kernel library did not load")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds() or 0.0:.1f} s)")
    for line in build.build_log().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"ptxas: {line.strip()}")


def compare(name: str, packed_np: dict, device, errs: dict) -> list[bool]:
    """Kernel vs plain version on the same device tensors; returns the
    mask and records, under `name`, the largest |kernel - plain|, the
    lanes that differ and the lanes compared."""
    t = pk.upload(packed_np, device)
    got = pk.verify_packed(t)
    want = pk.verify_packed_plain(t)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (packed_np["d1"].shape[1],), f"{name}: shape")
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    mismatches = int((got != want).sum())
    seen = errs.setdefault(name, {"max_abs_err": 0, "mismatches": 0,
                                  "lanes": 0})
    seen["max_abs_err"] = max(seen["max_abs_err"], err)
    seen["mismatches"] += mismatches
    seen["lanes"] += got.shape[0]
    check(err == 0, f"{name}: kernel and plain version disagree on "
          f"{mismatches} lanes")
    return got.cpu().tolist()


def phase_edges(rng, device, errs: dict, n: int = EDGE_LANES) -> None:
    lanes, out_of_table = edge_lanes(rng, n)
    expect = [hostref.verify_rs(*lane) for lane in lanes]
    expect[out_of_table] = hostref.verify_rs(0, 0, *lanes[out_of_table][2:])
    per_lane = pk.prepare_packed(lanes)
    per_lane["qx"][:, out_of_table] = 0  # the zero point, as a key
    per_lane["qy"][:, out_of_table] = 0
    table = pk.dedup_keys(pk.prepare_packed(lanes))
    check("kidx" in table, "edge lanes did not fit the key table")
    table["kidx"][out_of_table] = pk.KEYTAB + 44  # outside the table
    got_k = compare("p256_verify_keytab", table, device, errs)
    got_l = compare("p256_verify_lanekeys", per_lane, device, errs)
    check(got_k == expect, f"keytab kernel vs hostref: "
          f"{[i for i, (a, b) in enumerate(zip(got_k, expect)) if a != b]}")
    check(got_l == expect, f"lanekeys kernel vs hostref: "
          f"{[i for i, (a, b) in enumerate(zip(got_l, expect)) if a != b]}")
    # lanes 1-7, 9 and the one outside the table fail; the cand1 lane 8
    # passes
    check(sum(expect) == n - 9, f"edge cases: {n - sum(expect)} rejected")
    print(f"edges: {n} lanes, both entry points == plain == hostref "
          f"({n - sum(expect)} rejected)")


def phase_main(rng, device, n_txs: int = N_TXS, n_blocks: int = N_BLOCKS,
               many_keys: int = MANY_KEYS):
    """The main path, counted; returns what the kernel timings need."""
    client, peers = block_world(rng)
    t0 = time.perf_counter()
    block = block_items(rng, client, peers[:ENDORSERS], n_txs)
    bad_block, bad = plant_bad(block)
    many = [hostref.key_gen(rng) for _ in range(many_keys)]
    spread = []
    for i in range(n_txs * (1 + ENDORSERS)):
        key = many[i % many_keys]
        digest = hashlib.sha256(b"spread-%d" % i).digest()
        spread.append(VerifyBatchItem(
            key.public_key(), digest, hostref.sign(key, digest, rng)))
    print(f"signing: {time.perf_counter() - t0:.1f} s for "
          f"{len(block) + len(spread)} lanes")
    sample = list(range(0, len(block), len(block) // 32))
    for i in sample:
        it = block[i]
        check(hostref.verify(it.key, it.signature, it.digest),
              f"lane {i} of the block does not verify")
    for i in bad:
        it = bad_block[i]
        check(not hostref.verify(it.key, it.signature, it.digest),
              f"planted lane {i} verifies")
    batches = [bad_block if b == n_blocks // 2 else block
               for b in range(n_blocks)]

    csp = CUDACSP(device=device, min_device_batch=1)
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, masks = [], []
    for items in batches:
        pending.append(csp.verify_batch_async(items))
        if len(pending) >= DEPTH:
            masks.append(pending.pop(0)())
    masks.extend(col() for col in pending)
    block_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    spread_mask = csp.verify_batch(spread)
    spread_s = time.perf_counter() - t1
    csp.close()
    launches = {
        "p256_verify_keytab": pk.launches_keytab,
        "p256_verify_lanekeys": pk.launches_lanekeys,
    }
    for b, mask in enumerate(masks):
        want_bad = bad if b == n_blocks // 2 else []
        got_bad = [i for i, ok in enumerate(mask) if not ok]
        check(got_bad == want_bad, f"block {b}: rejected {got_bad[:8]}, "
              f"expected {want_bad}")
    check(all(spread_mask), "300-key batch: "
          f"{spread_mask.count(False)} lanes rejected")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")
    lanes = n_blocks * len(block)
    t1 = time.perf_counter()
    pk.prepare_packed(pk.lane_tuples(block))
    pack_s = time.perf_counter() - t1
    dispatch_s = csp.dispatch_seconds * len(block) / csp.dispatched_lanes
    print(f"main path: {n_blocks} blocks x {len(block)} lanes in "
          f"{block_s * 1e3:.1f} ms = {lanes / block_s:.0f} lanes/s "
          f"({n_blocks * n_txs / block_s:.0f} tx/s); host dispatch "
          f"{dispatch_s * 1e3:.1f} ms per block (packing one block alone: "
          f"{pack_s * 1e3:.1f} ms); 300-key batch {len(spread)} lanes in "
          f"{spread_s * 1e3:.1f} ms; launches {launches}")
    # the kernels' inputs as the provider forms them: a flush coalesces
    # two blocks (coalesce_lanes 6144), the 300-key batch stays alone
    flush = pk.dedup_keys(pk.prepare_packed(pk.lane_tuples(block + block)))
    wide = pk.dedup_keys(pk.prepare_packed(pk.lane_tuples(spread)))
    check("kidx" in flush and "kidx" not in wide, "unexpected key layouts")
    walls = {"p256_verify_keytab": block_s, "p256_verify_lanekeys": spread_s}
    return launches, walls, {"p256_verify_keytab": flush,
                             "p256_verify_lanekeys": wide}


def phase_kernels(device, launches: dict, shapes: dict, errs: dict,
                  reps: int = TIMING_REPS, plain_reps: int = PLAIN_REPS):
    rows = []
    for name, packed in shapes.items():
        compare(name, packed, device, errs)
        t = pk.upload(packed, device)
        ms = cuda_ms(lambda: pk.verify_packed(t), reps)
        plain_ms = cuda_ms(lambda: pk.verify_packed_plain(t), plain_reps)
        bound_ms, bound_by = bound(packed, name.endswith("keytab"))
        lanes = packed["d1"].shape[1]
        half = pk.upload(
            {k: (v if k in ("ktabx", "ktaby") else v[..., : lanes // 2])
             for k, v in packed.items()}, device)
        half_ms = cuda_ms(lambda: pk.verify_packed(half), reps)
        print(f"{name}: {lanes // 2} lanes, kernel {half_ms:.3f} ms")
        seen = errs[name]
        print(f"{name}: {lanes} lanes, kernel {ms:.3f} ms "
              f"({lanes / ms * 1e3:.0f} sigs/s), plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); {launches[name]} "
              f"launches on the main path; {seen['mismatches']} mismatches "
              f"in {seen['lanes']} lanes against the plain version")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": seen["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call verifies ECDSA
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")
    phase_build()
    rng = np.random.default_rng(SEED)
    errs: dict = {}
    phase_edges(rng, device, errs)
    launches, walls, shapes = phase_main(rng, device)
    rows = phase_kernels(device, launches, shapes, errs)
    for row in rows:
        # device share of the main path's wall, from the launches and the
        # kernel's time at the same shape
        busy = row["launches"] * row["ms"]
        wall = walls[row["name"]] * 1e3
        print(f"{row['name']}: device busy ~{busy:.1f} ms of the "
              f"{wall:.1f} ms wall ({busy / wall:.1%}; launches x kernel ms)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
