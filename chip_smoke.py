#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name, and its name and power limit from nvidia-smi.
2. Builds the kernels from `fabric_tpu_torch/csp/cuda/csrc`, one nvcc
   each, all at once, and prints the build time and the compiler's
   register/spill/stack summary; builds the port's C++ host library
   (`fabric_tpu_torch/native`, g++) and prints the compiler's version.
3. Counts the SASS of each verify kernel (cuobjdump on the build) and,
   through a probe of the P-256 field (`csrc/p256_field_probe.cu`), the
   SASS and the time on a dependent chain of one field multiplication,
   squaring, reduction, addition and subtraction, each checked against
   Python ints.  Holds both P-256 kernels (B1, the key table's; B2, a key
   per lane) against their plain PyTorch versions and the pure-Python
   reference (`hostref`) on 256 lanes of edge cases, among them lanes
   crafted for their split ladders: Q = G with u1 = u2 (the reduction
   doubles), Q = -G with equal digits (the partials cancel), a zero key,
   three off-curve keys and a key index outside the table.
4. Verifies 8 block-shaped batches (1000 transactions x (1 creator + 3
   endorsers), 4 keys of a 5-org world) through `CUDACSP.verify_batch_async`
   up to 6 deep, then one 4000-lane batch over 300 keys (the per-lane-key
   kernel), with launch counts set to 0 just before and read just after
   (the first flush enters the block's keys into the key table and builds
   their quarter tables inside the timed run).  Each flush is packed by
   the C++ packer; each distinct batch is packed again by it and by the
   numpy `prepare_packed`, timed, and the two held equal array for array.
5. Times each P-256 kernel at the main path's shapes against its plain
   version, the key-table kernel with its tables already on the card as
   the provider holds them, each beside its previous design's recorded
   time; prints the quarter tables' host build per key, each kernel's
   own multiplication count and longest chain beside the bound's, with
   the time of one multiplication on that chain, and sweeps each over
   1000 to 16000 lanes.  Then times flushes whose keys
   churn past the key table (every flush an overflow reset, to keys seen
   before and to keys never seen) against the same flushes over keys the
   table holds.
6. Block validation: mints the 5-org channel of
   `scripts/bench_pipeline.py` with the port's CA and configtx builder
   from the seed, builds 8 distinct 1000-transaction blocks as its
   `_make_blocks` does (Org1's client signs the proposal and the
   envelope, Org1-3's peers endorse a write of `benchcc` key k{b}-{i}),
   numbered 1-8 and chained onto the genesis block, with planted
   transactions in block 3 (a bad creator signature, one bad endorsement
   of four, one of three, two of three, a repeated txid, a truncated
   payload), MVCC conflicts in block 4 (reads at committed and stale
   versions, a read after an in-block write, a range read that misses a
   committed key) and a txid of block 4 repeated in block 6, and
   validates them through the port's `TxValidator.validate_pipeline(
   depth=6)` into `CUDACSP` with an empty ledger, the launch counts set
   to 0 just before and read just after.  Every flag must be the planted
   one (VALID elsewhere) and the verify mask hostref's (checked in 8
   worker processes); prints validated tx/s, ms a block, the collect /
   verify_wait / policy split, B1's launches and busy share, and which
   SHA-256 `collect.cc` runs.
   The commit path: the same blocks through the port's
   `Committer.store_stream(depth=6)` into an on-disk `KVLedger` from
   `LedgerProvider(<temporary directory>).create(genesis)`, after an
   untimed 64-transaction block in a ledger of its own, the launch counts
   set to 0 just before and read just after.  Every flag must be the
   planted one (the MVCC conflicts too), the height 9, each VALID
   transaction's key at its value and version and each invalid one's
   absent, every block readable by number and hash with its final
   TRANSACTIONS_FILTER, the history of a key written twice both writes,
   a reopen equal, and the mask hostref's; prints committed tx/s, ms a
   block, the validator's and the commit stages' split per block, the
   group flushes, when each block was validated and when durable, B1's
   launches and busy share, the sqlite version and settings, the
   ledger directory's file system, and the MVCC width (the default) with
   the blocks whose prepare fanned out.  A snapshot requested before the
   run is generated as block 6 commits (its export timed).
   Snapshots: that snapshot is verified through `CUDACSP.hash_batch`, a
   copy with one byte flipped is refused, a new ledger is created from it
   and blocks 7-8 are streamed into it through the Committer with
   `CUDACSP`, counted; flags, state, the txid index, the blocks and the
   history from block 7 on must equal the original ledger's, and a txid
   of block 2 repeated in block 8 is DUPLICATE_TXID in both.  Prints the
   export's bytes, files and ms, the hash route and B4's launches (0 at
   this shape), the import's ms and the stream's tx/s.
   SmallBank (`bench.py:264-445` at its size, with real signatures: 1000
   accounts seeded in block 1, 6 blocks of 400 payments, a quarter of
   the endpoints from 10 hot accounts, each block simulated by the port's
   `TxSimulator` one block behind): `Committer.store_stream(depth=6)`
   into an on-disk ledger with `CUDACSP`, twice (counted from the first),
   each pass followed by one at MVCC width 0, then block by block at
   width 0; the flags must be equal in every pass and to the build
   ledger's, the mask hostref's, and every balance the replay of the
   committed payments.  Prints committed and conflicted counts,
   committed tx/s, the commit stages, the workpool's counters, B1's
   launches and the MVCC width's A/B.
   The sharded store (`phase_commit_sharded`): the commit cell again, into
   a fresh root at FABRIC_TPU_STORE_SHARDS=4 (the namespace-sharded store
   with its two-phase group flush), counted; the flags, every KV pair and
   the snapshot of block 6, file for file, must equal the single-file
   run's, B1 launch as often, and the root reopen sharded at height 9
   with the knob unset.  Prints committed tx/s and ms a block beside the
   single file's, and the flush's kv stages (kv_txn, prepare, commit,
   apply, a shard's) beside the single file's kv_txn.
   The joining peer (`phase_fetch`): the snapshot of block 6 served by a
   port `RPCServer` (``admin.SnapshotFetch``) under mutual TLS with
   certificates of the port's CA, fetched over loopback by a port
   `RPCClient` (bytes, ms and MB/s printed) byte for byte; a new ledger
   joins from it and streams blocks 7-8 through `store_stream` with
   `CUDACSP`, B1 counted, its flags the original's and its KV pairs the
   bootstrapped ledger's; a netsplit plan severing the joiner from the
   donor makes the fetch raise NetsplitDenied, and after the heal it
   fetches again; a `raise` at ``snapshot.fetch.chunk`` (the third
   chunk) surfaces as RPCError and the partial directory is refused at
   import.
   The seams armed (`phase_traced_commit`): the commit cell twice more,
   into fresh roots, under `tracing.scope()` and then also under
   `profile.scope()`; flags, KV pairs, block files and the snapshot must
   equal the untraced pass's.  Prints both passes' committed tx/s
   beside the untraced one's, `critical_path_ms` per stage a block, the
   spans recorded and dropped, the top `self_cpu_ms` spans, the collect
   stage's top collapsed stacks and the lock roles' waits.  Every other
   phase must leave the tracing, profiling and netsplit seams' lookup
   counts where they were (`host_check`).
   Key custody (`phase_custody`): a `KeyCustodyServer` thread generates
   and holds 4 keys; a `CustodyCSP` whose local provider is `CUDACSP`
   signs 4000 digests through it (signs/s printed), then verifies them
   as one block-shaped `verify_batch` with 16 digests flipped (B1,
   counted) and 1200 lanes over 300 custody keys with 4 signatures
   flipped (B2, counted); each mask must be the planted one, the
   kernel's plain version's on the same packed lanes, and hostref's.
7. SHA-256 (B4): drives `CUDACSP.hash_batch` at its callers' shapes (a
   block's 1000 per-transaction calls of three endorsement messages, a
   snapshot export's call over its five files), where hashlib answers and
   B4 must launch no time; then a batch wide enough for the card route
   (4000 messages of 1,000-4,500 bytes, a shape no caller sends today)
   with the launch count set to 0 just before and read just after.
   Holds the kernel against hashlib on that batch, on the edge lengths
   0-120 bytes, 1 MiB and 1 MiB + 1, and on the snapshot's files, and
   against sha256_plain on the card on every message of at most 4,500
   bytes; times the kernel, the whole hash_batch call and hashlib on the
   wide batch, the kernel and hashlib on the snapshot's files, and both
   routes of hash_batch against its routing rule on batches either side
   of the rule's boundary; times one thread's chain of compressions (a
   lone 4,500-byte message against a lone empty one) for B4's
   serial-chain floor, beside the compression loop's SASS and the clock.
8. Idemix at the idemix MSP's own credential (4 attributes, OU and Role
   disclosed, one issuer key): times the build of the shared bases' comb
   (once per issuer key); holds the BN254 Schnorr-commitment kernel
   against its plain version, word for word, and against the host
   recomputation on 256 lanes of edge cases and a custom term layout
   whose partials meet in the reduction's doubling and infinity
   branches; verifies a 1024-signature batch through
   `IdemixCSP.verify_batch` on the card with the launch counts (calls and
   kernel launches) set to 0 just before and read just after, and a
   16-signature batch with a forged pairing, whose MSMs and pairing
   checks the C++ library and the pure-Python functions must agree on;
   splits the batch's wall time
   by stage; times both paths at 1 to 256 signatures and prints the
   measured crossover (the smallest size from which the card wins at
   every size swept);
   times the kernel at 1024 lanes, prints its own count of field
   multiplications beside the bound's, and sweeps it over 32 to 4096
   lanes.
   The idemix MSP (`phase_idemix_msp`): an issuer, 4 signer configs and
   an `IdemixMSP` built from its own config bytes; 256 identities (fresh
   nyms of the signers' credentials) deserialized, 8 of them planted (an
   OU lie, a role lie, a wrong disclosure, a proof not bound to its nym,
   a nym off the curve, a cut proof, a tampered challenge, another MSP's
   id), each verdict and error checked; the 256 identity proofs (message
   b"", 8 tampered) through one `IdemixCSP.verify_batch`, which takes the
   card by its crossover, with B3's launch count set to 0 just before and
   read just after, its mask the MSP's verdicts; 256 nym signatures
   signed and verified, one flipped and refused; a CRI created and
   verified on the port's P-384 (`csp/hostref384.py`), a flipped
   signature byte and a flipped epoch_pk byte refused.  Prints
   identities/s, proofs/s, nym signs and verifies a second, the CRI's
   and P-384's sign and verify ms.
9. The degraded mode (`phase_degraded`): a 4000-lane block through
   `CUDACSP` under faultline plans.  On a card the host answers nothing
   in the device's place, so each fault must reach the caller, counted:
   a collect fault raises out of both collectors of its flush (the
   breaker counts 1); 3 dispatch faults, each raised, open the breaker,
   and a held call is refused with no flush and no launch of B1; the
   next held call probes through B1 and closes it, its mask hostref's; a
   hash fault raises, and B4's digests after equal hashlib's; the B3
   path raising (its entry swapped for one that raises) raises out of
   IdemixCSP, counted; a collect stalled by a 1 s `delay` is sat out
   (no race on a card); host_fraction is refused on a card.  Prints
   libcrypto's and hostref's lanes/s on this host, each step's times,
   the breaker's trace and its /metrics lines.  Every other phase prints
   the degraded-mode counters of the providers it used and fails the run
   if any is not 0.
10. Prints one JSON line of kernels (B1-B4; B1's with its launches on
   the validator, commit, sharded-commit, SmallBank, bootstrapped-ledger,
   joining-peer and custody paths, B2's on the last two, B3's with its launches on the idemix MSP's
   batch, B4's with its launches at the snapshot's shape), then
   `{"ok": true, "device": {...}}` as its last line.

    python3 chip_smoke.py --commit-ab PARENT_TREE [TURNS]

runs `phase_commit` (the headline: committed tx/s) of another tree of
this repository, unpacked by `git archive`, and of this one in turns
(parent, this, this, parent, ...), each in a process of its own, and
prints each turn's committed tx/s, each tree's median and quartiles, the
pairs this tree won, and the unarmed seams' calls and ns a block.

    python3 chip_smoke.py --shards-ab [TURNS]

runs `phase_commit` at FABRIC_TPU_STORE_SHARDS 1 and 4 in turns (1, 4,
4, 1, ...; 4 turns by default), one process, each into a fresh root, and
prints each turn's committed tx/s and kv stages.

    python3 chip_smoke.py --multi-card

needs two cards or more: it puts 8 flushes of a 4000-lane block through
`CUDACSP(device=[every card])`, enqueued together as pipelined callers
enqueue, and checks that each flush took the next card, that B1 ran once
a flush and that every mask is the planted one; then it times the same 8
flushes on one card and on every card, in turns, and prints lanes/s.

Exits non-zero, before printing any result, on a host without CUDA; any
failed phase raises.  Inputs are made from a seed (numpy for P-256 and
the validator's world, `random.Random` for idemix, as its API takes).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fabric_tpu_torch import native
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.common import configtx_builder as ctx
from fabric_tpu_torch.common import profile, tracing, workpool
from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
from fabric_tpu_torch.common.crypto import CA
from fabric_tpu_torch.common.metrics import CSPMetrics, PrometheusProvider
from fabric_tpu_torch.csp import hostref, hostref384
from fabric_tpu_torch.csp.api import (
    P256_B,
    P256_GX,
    P256_GY,
    P256_N,
    P256_P,
    P256PrivateKey,
    P256PublicKey,
    VerifyBatchItem,
    marshal_ecdsa_signature,
    on_curve,
    to_low_s,
    unmarshal_ecdsa_signature,
)
from fabric_tpu_torch.csp.cuda import bn254_batch as bb
from fabric_tpu_torch.csp.cuda import bn254_kernel as bk
from fabric_tpu_torch.csp.cuda import build
from fabric_tpu_torch.csp.cuda import p256_kernel as pk
from fabric_tpu_torch.csp.cuda import provider as cuda_provider
from fabric_tpu_torch.csp.cuda import sha256 as sha
from fabric_tpu_torch.csp.cuda.limbs import int_to_words, words_to_int
from fabric_tpu_torch.csp.cuda.provider import CUDACSP, hash_on_card
from fabric_tpu_torch.csp.idemix_provider import IdemixCSP, IdemixVerifyItem
from fabric_tpu_torch.devtools import faultline, netsplit
from fabric_tpu_torch.idemix import bn254 as bn
from fabric_tpu_torch.idemix import schnorr
from fabric_tpu_torch.idemix import signature as isig
from fabric_tpu_torch.idemix.credential import (
    Credential,
    attribute_to_scalar,
    new_cred_request,
    new_credential,
)
from fabric_tpu_torch.idemix.issuer import IssuerKey
from fabric_tpu_torch.msp import idemixmsp
from fabric_tpu_torch.msp.config import msp_config_from_ca
from fabric_tpu_torch.msp.identity import SigningIdentity
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protos import rwset as rw

SEED = 0
N_ORGS = 5
N_TXS = 1000  # transactions per block
ENDORSERS = 3  # endorsements per transaction (3-of-5)
N_BLOCKS = 8
DEPTH = 6  # batches in flight before the oldest is collected
EDGE_LANES = 256
MANY_KEYS = 300  # distinct keys of the batch that overflows the key table
# key churn: flushes of CHURN_LANES lanes over CHURN_KEYS keys; two
# working sets that share half their keys hold 1.5 x CHURN_KEYS distinct
# keys, more than the key table's 256
CHURN_KEYS = 200
CHURN_LANES = 2000
CHURN_FLUSHES = 6
TIMING_REPS = 5
PLAIN_REPS = 3

SOURCE = "fabric_tpu_torch/csp/cuda/csrc/p256_verify.cu"
B1_NAME = "p256_verify_keytab"
B2_NAME = "p256_verify_lanekeys"
LANES_SWEEP = (1000, 4000, 8000, 16000)
# The previous designs, one thread per signature, on the same card type
# (H100 80GB HBM3, 700 W; PERF.md, CUDA events, median of 5): ms per
# 8000-lane launch of B1 and per 4000-lane launch of B2, printed beside
# this run's times.
B1_ONE_THREAD_MS = (5.360, 5.601)
B2_ONE_THREAD_MS = (5.272, 5.390)
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
MULS_DBL, MULS_MIXED, MULS_FULL = 8, 11, 16
# B2's own pieces: the curve check of the lane's key (in each of its 8
# threads), and a Q part's table of d Q, d = 1..15 (a doubling and 13
# mixed adds)
MULS_CURVE = 3
MULS_Q_TABLE = MULS_DBL + 13 * MULS_MIXED

# Idemix: the idemix MSP's credential (fabric_tpu/msp/idemixmsp.py:41, :98)
MSP_ATTRS = ("OU", "Role", "EnrollmentID", "RevocationHandle")
MSP_DISCLOSURE = [True, True, False, False]
IDEMIX_BASE_SIGS = 32  # signed in pure Python, then re-signed per lane
IDEMIX_LANES = 1024
B3_EDGE_LANES = 256
FORGED_BATCH = 16
CROSSOVER_SIZES = (1, 2, 3, 4, 8, 16, 64, 256)
CROSSOVER_REPS = 5
B3_SWEEP = (32, 256, 1024, 4096)
# The previous design of the kernel, one thread per signature, on the same
# card type (H100 80GB HBM3, 700 W; PERF.md, CUDA events, median of 5):
# ms per 1024-lane launch, printed beside this run's time.
B3_ONE_THREAD_MS = (30.712, 31.350)
B3_NAME = "bn254_commitments"
B3_SOURCE = "fabric_tpu_torch/csp/cuda/csrc/bn254_commit.cu"
B3_REPLACES = "fabric_tpu/csp/tpu/pallas_bn254.py:408"
# B4, SHA-256: the kernel, what it replaces, and the batches it hashes.
B4_NAME = "sha256_digests"
B4_SOURCE = "fabric_tpu_torch/csp/cuda/csrc/sha256.cu"
B4_REPLACES = "fabric_tpu/csp/tpu/sha256.py:82"
HASH_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 1 << 20, (1 << 20) + 1)
# What hash_batch's callers send (fabric_tpu/peer/txvalidator.py:436-439,
# fabric_tpu/ledger/snapshot.py:341): per transaction one call over its
# endorsements' messages, the proposal-response payload with the
# endorser's identity (1,000-1,800 bytes); per snapshot export one call
# over its five data files, at the sizes scripts/bench_snapshot.py's
# default export writes (200 blocks of 20 transactions).
HASH_TXS = 1000
HASH_RESPONSE_BYTES = (1000, 1800)
HASH_SNAPSHOT_FILES = (23898, 0, 0, 2411560, 79800)
# A batch wide enough for hash_batch's card route: 4000 messages of
# 1,000-4,500 bytes, the lengths of a block's endorsement messages and
# envelope payloads.  No caller sends such a batch today; it drives
# hash_batch onto B4, where the kernel is counted and timed.
HASH_WIDE_MSGS = 4000
HASH_WIDE_BYTES = (1000, 4500)
# hash_batch's routing rule held against both routes' times: batches of
# (count) equal-length (bytes) messages either side of its boundary
HASH_ROUTE_SHAPES = ((55, 256), (55, 1024), (55, 2048), (55, 8192),
                     (2000, 64), (2000, 128), (2000, 256), (2000, 512),
                     (64 << 10, 64), (64 << 10, 128), (64 << 10, 256),
                     (1 << 20, 64), (1 << 20, 128), (1 << 20, 256))
# The plain version runs one 64-round step of tensor operations per block
# of the longest message, so it is held against the kernel on messages of
# at most this many bytes (every message of the wide batch and the edge
# lengths up to 120); the 1 MiB edge messages and the snapshot's public
# state are held against hashlib.
HASH_PLAIN_MAX_BYTES = 4500
# 32-bit integer operations of one compression: 64 rounds of ~25 and 48
# schedule steps of ~13
SHA_OPS_PER_COMPRESSION = 64 * 25 + 48 * 13

# BN254 field multiplications: a mixed add 11, a full add 16, a doubling
# 7; a CIOS product at R = 2^256 is 64 32x32->64-bit multiply-adds for
# the product and 8 x 9 for the reduction.
BN_MULS_MIXED = 11
BN_MULS_FULL = 16
BN_MULS_DBL = 7
BN_WORD_PRODUCTS = 136


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# Every provider a phase makes, for the host check after it.
PROVIDERS: list = []
DEGRADED_KEYS = ("host_lanes", "host_hashes", "races", "device_failures",
                 "trips")


def new_cuda_csp(**kw) -> CUDACSP:
    """A CUDACSP with the arguments users pass (race armed, host_fraction
    0 unless given), registered for `host_check`."""
    csp = CUDACSP(**kw)
    PROVIDERS.append(csp)
    return csp


def new_idemix_csp(**kw) -> IdemixCSP:
    csp = IdemixCSP(**kw)
    PROVIDERS.append(csp)
    return csp


# The armed-path counts of the tracing, profiling and netsplit seams as
# the last check left them: an unarmed phase must not move them.
SEAM_COUNTS: list = []


def seam_counts() -> tuple:
    return (tracing.lookup_count(), profile.lookup_count(),
            netsplit.lookup_count())


def seams_check(label: str) -> None:
    """Fails the run if the seams were consulted since the last check
    (an unarmed phase must find each one a global load and a None
    test)."""
    now = seam_counts()
    if SEAM_COUNTS:
        moved = [b - a for a, b in zip(SEAM_COUNTS[0], now)]
        check(moved == [0, 0, 0], f"{label}: the unarmed seams were "
              f"consulted: tracing, profile, netsplit {moved}")
    SEAM_COUNTS[:] = [now]


def host_check(label: str, degraded: bool = False,
               armed: bool = False) -> dict:
    """Sums the degraded-mode counters of every provider made since the
    last check and prints them.  Outside phase_degraded (`degraded`), a
    lane or digest the host answered in the device's place, a race, a
    device failure or a breaker trip fails the run.  Unless the phase
    armed a seam (`armed`), the seams' lookup counts must not have moved
    since the last check."""
    if armed:
        SEAM_COUNTS[:] = [seam_counts()]
    else:
        seams_check(label)
    total = dict.fromkeys(DEGRADED_KEYS, 0)
    for csp in PROVIDERS:
        for k, v in csp.degraded_stats().items():
            if k in total:
                total[k] += v
    n = len(PROVIDERS)
    PROVIDERS.clear()
    print(f"{label}: host_lanes {total['host_lanes']}, host_hashes "
          f"{total['host_hashes']}, races {total['races']}, device_failures "
          f"{total['device_failures']}, trips {total['trips']} ({n} "
          f"providers)")
    if not degraded:
        check(not any(total.values()), f"{label}: the host answered in the "
              f"device's place: {total}")
    return total


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


def q_eq_g_lane(rng):
    """Q = G (private key 1) with a digest equal to r, so that u1 = u2 =
    k / 2: the key-table kernel's partials u1_j G and u2_j Q are equal
    and its reduction takes the doubling branch.  Valid."""
    while True:
        k = int.from_bytes(rng.bytes(32), "big") % P256_N
        r = hostref.mul_g(k)[0] % P256_N if k else 0
        s = 2 * r * pow(k, -1, P256_N) % P256_N
        if r and s:
            return (P256_GX, P256_GY, r.to_bytes(32, "big"), r,
                    to_low_s(s))


def off_curve_point(rng):
    while True:
        x, y = (int.from_bytes(rng.bytes(32), "big") % P256_P
                for _ in range(2))
        if not on_curve(x, y):
            return x, y


OFF_CURVE_LANES = (14, 15, 16)  # edge lanes whose key is not on P-256


def edge_lanes(rng, n: int):
    """n lanes of (x, y, digest, r, s) and their kernel layouts, with one
    lane of each edge case; returns (lanes, out_of_table lane index,
    the lane of Q = -G that the caller gives u2 = u1)."""
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
    # lane 10: its key index goes outside the table
    lanes[11] = list(q_eq_g_lane(rng))
    neg_g = P256PrivateKey(P256_N - 1, P256PublicKey(P256_GX,
                                                     P256_P - P256_GY))
    digest = hashlib.sha256(b"edge-neg-g").digest()
    lanes[12] = [P256_GX, P256_P - P256_GY, digest,
                 *unmarshal_ecdsa_signature(hostref.sign(neg_g, digest, rng))]
    lanes[13][:2] = [0, 0]  # the zero point as a key
    for i in OFF_CURVE_LANES:
        lanes[i][:2] = off_curve_point(rng)
    return [tuple(v) for v in lanes], 10, 12


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


def bound_muls(packed: dict) -> int:
    """The field multiplications the valid lanes of `packed` need, as one
    joint ladder each (the function's work, whatever computes it)."""
    valid = np.asarray(packed["valid"], bool)

    def nonzero_digits(words):
        w = np.asarray(words, np.uint32)[:, valid]
        return sum(int(((w >> (4 * k)) & 0xF).astype(bool).sum())
                   for k in range(8))

    return (
        int(valid.sum()) * (FIELD_MULS_TABLE + FIELD_MULS_DBL
                            + FIELD_MULS_FINAL)
        + 11 * nonzero_digits(packed["d1"])
        + 16 * nonzero_digits(packed["d2"])
    )


def bound(packed: dict, keytab: bool) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for verifying `packed`: each
    input read once and the mask written once over the HBM rate, against
    the multiply-adds its valid lanes need over the 32-bit peak."""
    lanes = np.asarray(packed["valid"]).shape[0]
    ops = bound_muls(packed) * WORD_PRODUCTS * 2
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
    """Every kernel source compiles (one nvcc each, all at once) and
    loads; prints each one's compile time and ptxas summary."""
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        check(build.load(name) is not None, f"{name} did not load")
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    for name in libs:
        print(f"nvcc {name}: {build.build_seconds(name) or 0.0:.1f} s")
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "stack frame",
                                       "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}")


def opcode(instr: str) -> str:
    """The opcode with its modifiers of one SASS line from `build.sass`,
    without a predicate guard."""
    words = instr.split()[1:]
    return words[1] if words[0].startswith("@") else words[0]


def sass_summary(instrs: list[str]) -> str:
    """Instruction count, the wide and high multiplies, local-memory
    loads and stores, and the five commonest other opcodes."""
    ops = collections.Counter(opcode(i) for i in instrs)
    wide = sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE"))
    hi = sum(v for k, v in ops.items() if k.startswith("IMAD.HI"))
    ldl = sum(v for k, v in ops.items() if k.startswith("LDL"))
    stl = sum(v for k, v in ops.items() if k.startswith("STL"))
    rest = [(k, v) for k, v in ops.most_common()
            if not k.startswith(("IMAD.WIDE", "IMAD.HI", "LDL", "STL"))]
    top = ", ".join(f"{k} {v}" for k, v in rest[:5])
    return (f"{len(instrs)} instructions: IMAD.WIDE {wide}, IMAD.HI {hi}, "
            f"LDL {ldl}, STL {stl}; {top}")


def loop_body(instrs: list[str]) -> list[str]:
    """The instructions of the last backward branch's loop: from its
    target to the branch."""
    addr = [int(i[2:i.index("*/")], 16) for i in instrs]
    for k in range(len(instrs) - 1, -1, -1):
        m = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", instrs[k])
        if m and int(m.group(1), 16) < addr[k]:
            start = addr.index(int(m.group(1), 16))
            return instrs[start:k + 1]
    raise RuntimeError("no loop in the probe's SASS")


def called_body(instrs: list[str], body: list[str]) -> list[str]:
    """The instructions of the function that `body` calls (from the
    CALL's target to its RET), or [] when it calls none."""
    for instr in body:
        m = re.search(r"\bCALL\.\S+\s+0x([0-9a-f]+)", instr)
        if m:
            addr = [int(i[2:i.index("*/")], 16) for i in instrs]
            start = addr.index(int(m.group(1), 16))
            end = next(k for k in range(start, len(instrs))
                       if " RET" in instrs[k])
            return instrs[start:end + 1]
    return []


def phase_sass() -> None:
    """Each verify kernel's SASS, counted (cuobjdump on the built
    library)."""
    for name, path in build.build_all().items():
        for fn, instrs in build.sass(path).items():
            print(f"sass {name} {fn}: {sass_summary(instrs)}")


PROBE_OPS = ("mul", "sqr", "reduce", "add", "sub")


def probe_expect(op: str, a: int, b: int, iters: int) -> int:
    """What `iters` steps of probe op `op` leave, in Python ints."""
    a, b = a % P256_P, b % P256_P
    if op == "mul":
        return a * pow(b, iters, P256_P) % P256_P
    if op == "sqr":
        return pow(a, 1 << iters, P256_P)
    if op == "reduce":
        return a * pow((1 << 256) + 1, iters, P256_P) % P256_P
    if op == "add":
        return (a + iters * b) % P256_P
    return (a - iters * b) % P256_P


def phase_field(device, reps: int = TIMING_REPS) -> dict:
    """The field of p256_verify.cuh, op by op through the probe: the SASS
    of one operation (the probe loop's body), the result of 3 steps on
    256 operand pairs (edge words among them) against Python ints, and
    the time of one operation on a dependent chain at two loads: 64,000
    threads in 256-thread blocks (B1's 8000 lanes) and one warp on each
    of the 132 SMs.  Returns {op: (us at the full load, us at one warp
    an SM)}."""
    lib, path = build.load_probe()
    code = build.sass(path)
    rng = random.Random(SEED + 9)
    edges = [0, 1, P256_P - 1, P256_P, 2**256 - 1, 2**255, P256_P + 1]
    xs = edges + [rng.randrange(2**256) for _ in range(256 - len(edges))]
    ys = edges[::-1] + [rng.randrange(2**256) for _ in range(256 - len(edges))]
    stream = torch.cuda.current_stream(device).cuda_stream

    def words(vals):
        w = np.stack([int_to_words(v) for v in vals], axis=1)
        return torch.as_tensor(w.view(np.int32), device=device).contiguous()

    def run(op_i, a, b, out, n, iters, block):
        rc = lib.p256_field_probe(op_i, a.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), n, iters, block, stream)
        check(rc == 0, f"field probe launch failed: CUDA error {rc}")

    times = {}
    for op_i, op in enumerate(PROBE_OPS):
        fn = [f for f in code if f"probe_kernelILi{op_i}E" in f]
        check(len(fn) == 1, f"probe SASS for {op}: {sorted(code)}")
        body = loop_body(code[fn[0]])
        if op in ("mul", "sqr"):
            # the card's multiplication and squaring are calls: count
            # the called function, not the call
            body = called_body(code[fn[0]], body) or body
        a, b = words(xs), words(ys)
        out = torch.empty_like(a)
        run(op_i, a, b, out, len(xs), 3, 256)
        torch.cuda.synchronize()
        got = out.cpu().numpy().view(np.uint32)
        bad = [k for k in range(len(xs)) if words_to_int(got[:, k])
               != probe_expect(op, xs[k], ys[k], 3)]
        check(not bad, f"field probe {op}: {len(bad)} of "
              f"{len(xs)} results differ from Python ints")
        us = []
        iters = 2000
        for n in (64000, 132 * 32):
            big_a = a.repeat(1, -(-n // len(xs)))[:, :n].contiguous()
            big_b = b.repeat(1, -(-n // len(xs)))[:, :n].contiguous()
            big_out = torch.empty_like(big_a)
            block = 256 if n > 132 * 32 else 32
            ms = cuda_ms(lambda: run(op_i, big_a, big_b, big_out, n, iters,
                                     block), reps)
            us.append(ms * 1e3 / iters)
        times[op] = tuple(us)
        print(f"field probe {op}: {us[0]:.4f} us an operation on a chain "
              f"at 64000 threads, {us[1]:.4f} us at one warp an SM; == "
              f"Python ints on {len(xs)} pairs; one operation's SASS: "
              f"{sass_summary(body)}")
    return times


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
    lanes, out_of_table, neg_g = edge_lanes(rng, n)
    expect = [hostref.verify_rs(*lane) for lane in lanes]
    expect[out_of_table] = hostref.verify_rs(0, 0, *lanes[out_of_table][2:])
    check(expect[neg_g] and expect[11], "the Q = +-G lanes do not verify")
    expect[neg_g] = False  # u2 = u1 below: R = u1 G - u1 G, infinity
    per_lane = pk.prepare_packed(lanes)
    per_lane["qx"][:, out_of_table] = 0  # the zero point, as a key
    per_lane["qy"][:, out_of_table] = 0
    table = pk.dedup_keys(pk.prepare_packed(lanes))
    check("kidx" in table, "edge lanes did not fit the key table")
    table["kidx"][out_of_table] = pk.KEYTAB + 44  # outside the table
    keyed = [0, 11, 12, 13, *OFF_CURVE_LANES]
    bad = table["keybad"][table["kidx"][keyed]].tolist()
    check(bad == [0, 0, 0] + [1] * (len(keyed) - 3),
          f"bad-key flags of the edge keys: {bad}")
    for packed in (per_lane, table):
        packed["d2"][:, neg_g] = packed["d1"][:, neg_g]
    got_k = compare("p256_verify_keytab", table, device, errs)
    got_l = compare("p256_verify_lanekeys", per_lane, device, errs)
    check(got_k == expect, f"keytab kernel vs hostref: "
          f"{[i for i, (a, b) in enumerate(zip(got_k, expect)) if a != b]}")
    check(got_l == expect, f"lanekeys kernel vs hostref: "
          f"{[i for i, (a, b) in enumerate(zip(got_l, expect)) if a != b]}")
    # lanes 1-7, 9, the one outside the table, Q = -G, the zero key and
    # the off-curve keys fail; the cand1 lane 8 and Q = G (11) pass
    check(sum(expect) == n - 11 - len(OFF_CURVE_LANES),
          f"edge cases: {n - sum(expect)} rejected")
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

    csp = new_cuda_csp(device=device, min_device_batch=1)
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
    # the packer of the main path (C++) against its plain version (numpy)
    # on every distinct batch the main path packed
    pack_ms = []
    for name, items in (("block", block), ("bad block", bad_block),
                        ("300-key batch", spread)):
        t1 = time.perf_counter()
        got = pk.pack_items(items)
        native_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        want = pk.prepare_packed(pk.lane_tuples(items))
        plain_ms = (time.perf_counter() - t1) * 1e3
        same = sorted(got) == sorted(want) and all(
            np.array_equal(got[k], want[k]) for k in want)
        check(same, f"packing ({name}): native != prepare_packed")
        pack_ms.append(native_ms)
        print(f"packing {name} ({len(items)} lanes): native "
              f"{native_ms:.2f} ms, plain prepare_packed {plain_ms:.1f} ms; "
              f"equal arrays")
    dispatch_s = csp.dispatch_seconds * len(block) / csp.dispatched_lanes
    print(f"main path: {n_blocks} blocks x {len(block)} lanes in "
          f"{block_s * 1e3:.1f} ms = {lanes / block_s:.0f} lanes/s "
          f"({n_blocks * n_txs / block_s:.0f} tx/s); host dispatch "
          f"{dispatch_s * 1e3:.1f} ms per block (packing one block alone, "
          f"native: {pack_ms[0]:.2f} ms); 300-key batch {len(spread)} lanes "
          f"in {spread_s * 1e3:.1f} ms; launches {launches}")
    # the kernels' inputs as the provider forms them: a flush coalesces
    # two blocks (coalesce_lanes 6144), the 300-key batch stays alone
    flush = pk.dedup_keys(pk.pack_items(block + block))
    wide = pk.dedup_keys(pk.pack_items(spread))
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
            {k: (v if k in pk.TABLE_KEYS else v[..., : lanes // 2])
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
        if name == B1_NAME:
            phase_b1(t, packed, ms, reps)
        else:
            phase_b2(t, packed, ms, reps)
    return rows


def quarter_ladders(words, ok, add_muls: int) -> list:
    """Per quarter j = 0..3 of the scalars packed in `words`, over the
    lanes `ok`: (the field multiplications of its 16-window ladder from
    infinity -- 4 doublings a window after its first nonzero digit and
    `add_muls` per nonzero digit after that first -- and whether it ends
    finite)."""
    shifts = 4 * np.arange(8, dtype=np.uint32)
    per = 64 // pk.QUARTERS
    w = np.asarray(words, np.uint32)[:, ok]
    d = ((w[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(64, -1)
    out = []
    for j in range(pk.QUARTERS):
        nz = d[64 - (j + 1) * per:64 - j * per] != 0  # (per, lanes)
        live = nz.any(axis=0)
        first = np.argmax(nz, axis=0)
        out.append((np.where(live, 4 * MULS_DBL * (per - 1 - first)
                             + add_muls * (nz.sum(axis=0) - 1), 0), live))
    return out


def split_muls(parts: list, guard: int = 0) -> tuple[float, int]:
    """(per lane over all 8 threads, the longest chain) of a split
    kernel whose parts cost `parts` [(muls, finite)] * 8: each thread's
    guard and part, then warp 0's sum (a full add per finite partial
    after the first) and the check."""
    ladders = np.stack([m for m, _ in parts])
    finite = np.stack([f for _, f in parts])
    reduce = (MULS_FULL * np.maximum(finite.sum(axis=0) - 1, 0)
              + FIELD_MULS_FINAL)
    lanes = ladders.shape[1]
    total = int(ladders.sum() + reduce.sum()) + pk.QUARTERS * 2 * guard * lanes
    return total / lanes, int((guard + ladders.max(axis=0) + reduce).max())


def b1_kernel_muls(packed: dict) -> tuple[float, int]:
    """The field multiplications the key-table kernel itself does on
    `packed`, as (per lane over all its threads, the longest chain: a
    lane's longest part, then its reduction and check).  A part copies
    its first nonzero digit's entry, then does 4 doublings a window and a
    mixed add per nonzero digit.  Lanes the guard rejects do none.
    Unlike `bound`, this is the design's count, not the function's."""
    kidx = np.asarray(packed["kidx"]).astype(np.int64)
    inside = kidx < pk.KEYTAB
    ok = (np.asarray(packed["valid"], bool) & inside
          & (np.asarray(packed["keybad"])[np.where(inside, kidx, 0)] == 0))
    return split_muls(quarter_ladders(packed["d1"], ok, MULS_MIXED)
                      + quarter_ladders(packed["d2"], ok, MULS_MIXED))


def b2_kernel_muls(packed: dict) -> tuple[float, int]:
    """The same count for the per-lane-key kernel: every thread checks
    that the lane's key is on the curve; a G part is as in B1; part 4
    builds the lane's table of Q, for which all four Q parts wait; a Q
    part with a nonzero digit then runs its ladder with a full add per
    nonzero digit after the first and doubles the result 64 j times.
    Lanes the guard rejects do only the check."""
    keys = zip((words_to_int(w) for w in np.asarray(packed["qx"]).T),
               (words_to_int(w) for w in np.asarray(packed["qy"]).T))
    ok = np.asarray(packed["valid"], bool) & np.array(
        [on_curve(x % P256_P, y % P256_P) for x, y in keys])
    # the table is on every Q part's chain (the parts run over ok lanes)
    q_parts = [(np.where(live, m + 4 * MULS_DBL * 16 * j, 0) + MULS_Q_TABLE,
                live) for j, (m, live) in enumerate(
                    quarter_ladders(packed["d2"], ok, MULS_FULL))]
    per_lane, longest = split_muls(
        quarter_ladders(packed["d1"], ok, MULS_MIXED) + q_parts,
        guard=MULS_CURVE)
    # split_muls counted the table once a Q part; part 4 alone builds it
    return per_lane - (pk.QUARTERS - 1) * MULS_Q_TABLE, longest


def lanes_sweep(name: str, t: dict, reps: int, sizes=LANES_SWEEP) -> None:
    """A kernel's time against the batch size: `t`'s lanes, cut or
    repeated to each size (the key table, where there is one, kept)."""
    lanes = t["d1"].shape[1]
    for size in sizes:
        copies = -(-size // lanes)
        sub = {k: v if k in pk.TABLE_KEYS else
               torch.cat([v] * copies, dim=-1)[..., :size].contiguous()
               for k, v in t.items()}
        ms = cuda_ms(lambda sub=sub: pk.verify_packed(sub), reps)
        print(f"{name} lanes sweep: {size} lanes, kernel {ms:.3f} ms "
              f"({size / ms * 1e3:.0f} sigs/s)")


def phase_b1(t: dict, packed: dict, ms: float, reps: int = TIMING_REPS):
    """B1 beyond its row, on the main path's flush with its tables already
    on the card: the previous design's recorded time, the kernel's own
    multiplication count beside the bound's, the quarter tables' host
    build per key, and the lanes sweep."""
    lanes = t["kidx"].shape[0]
    lo, hi = B1_ONE_THREAD_MS
    print(f"{B1_NAME}: the one-thread-per-signature design took {lo:.3f}-"
          f"{hi:.3f} ms at 8000 lanes on an H100 80GB HBM3 at 700 W "
          f"(PERF.md); this run {ms:.3f} ms at {lanes} lanes "
          f"({lo / ms:.1f}-{hi / ms:.1f}x)")
    per_lane, longest = b1_kernel_muls(packed)
    valid = int(np.asarray(packed["valid"]).sum())
    print(f"{B1_NAME} kernel's own work: {per_lane:.0f} field "
          f"multiplications per lane over all its threads, the longest "
          f"chain {longest} ({ms * 1e3 / longest:.3f} us a chain "
          f"multiplication); the bound counts "
          f"{bound_muls(packed) / valid:.0f} per lane (one joint ladder)")

    keys = int(np.asarray(packed["keybad"]).size
               - np.asarray(packed["keybad"]).sum())
    t0 = time.perf_counter()
    pk.key_quarter_tables(packed["ktabx"], packed["ktaby"])
    flush_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 5)
    many = [hostref.key_gen(rng).public_key() for _ in range(pk.KEYTAB)]
    kx = np.stack([int_to_words(k.x) for k in many], axis=1)
    ky = np.stack([int_to_words(k.y) for k in many], axis=1)
    t0 = time.perf_counter()
    pk.key_quarter_tables(kx, ky)
    full_s = time.perf_counter() - t0
    print(f"quarter tables, host build: {keys} keys of the flush in "
          f"{flush_s * 1e3:.1f} ms ({flush_s * 1e3 / keys:.2f} ms per key); "
          f"a full {pk.KEYTAB}-key table (an overflow reset) in "
          f"{full_s * 1e3:.1f} ms ({full_s * 1e3 / pk.KEYTAB:.2f} ms per "
          f"key); {np.prod(pk.QTAB_SHAPE) * 4} B per key")

    lanes_sweep(B1_NAME, t, reps)


def phase_b2(t: dict, packed: dict, ms: float, reps: int = TIMING_REPS):
    """B2 beyond its row, on the main path's 300-key batch: the previous
    design's recorded time, the kernel's own multiplication count and
    longest chain beside the bound's, and the lanes sweep."""
    lanes = t["d1"].shape[1]
    lo, hi = B2_ONE_THREAD_MS
    print(f"{B2_NAME}: the one-thread-per-signature design took {lo:.3f}-"
          f"{hi:.3f} ms at 4000 lanes on an H100 80GB HBM3 at 700 W "
          f"(PERF.md); this run {ms:.3f} ms at {lanes} lanes "
          f"({lo / ms:.1f}-{hi / ms:.1f}x)")
    per_lane, longest = b2_kernel_muls(packed)
    valid = int(np.asarray(packed["valid"]).sum())
    print(f"{B2_NAME} kernel's own work: {per_lane:.0f} field "
          f"multiplications per lane over all its threads, the longest "
          f"chain {longest} ({ms * 1e3 / longest:.3f} us a chain "
          f"multiplication); the bound counts "
          f"{bound_muls(packed) / valid:.0f} per lane (one joint ladder)")
    lanes_sweep(B2_NAME, t, reps)


# ---------------------------------------------------------------------------
# Idemix (BN254).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IdemixWorld:
    isk: IssuerKey
    sk: int
    cred: Credential
    bases: list  # per base signature: (signature, hidden secrets, T1..T3)

    @property
    def ipk(self):
        return self.isk.ipk


def idemix_world(seed: int, n_bases: int = IDEMIX_BASE_SIGS) -> IdemixWorld:
    """One issuer key with the MSP's 4 attributes, one credential, and
    n_bases signatures, each kept with the secrets its proof hides and
    its commitments T1..T3, so that `resign` can re-sign it over another
    message with the same randomness."""
    rng = random.Random(seed)
    isk = IssuerKey.generate(list(MSP_ATTRS), rng=rng)
    ipk = isk.ipk
    sk = bn.rand_zr(rng)
    req = new_cred_request(sk, b"chip-smoke", ipk, rng=rng)
    attrs = [attribute_to_scalar(v) for v in ("org1", 1, "user1", 100)]
    cred = new_credential(isk, req, attrs, rng=rng)
    bases = []
    for k in range(n_bases):
        nym, r_nym = isig.make_nym(sk, ipk, rng=rng)
        sign_seed = rng.randrange(1 << 62)
        sig = isig.new_signature(
            cred, sk, ipk, b"idemix-base-%d" % k, disclosure=MSP_DISCLOSURE,
            nym=nym, r_nym=r_nym, rng=random.Random(sign_seed))
        # new_signature draws r1, then r2, from its rng (a nym is given)
        twin = random.Random(sign_seed)
        r1, r2 = bn.rand_zr(twin), bn.rand_zr(twin)
        r3 = pow(r1, -1, bn.R)
        hidden = {
            "neg_e": (-cred.e) % bn.R, "r2": r2, "sk": sk,
            "sprime": (cred.s - r2 * r3) % bn.R, "neg_r3": (-r3) % bn.R,
            "r_nym": r_nym,
            **{f"m_{i}": cred.attrs[i]
               for i, d in enumerate(MSP_DISCLOSURE) if not d},
        }
        rels = isig._relations(ipk, sig.a_prime, sig.a_bar, sig.b_prime,
                               sig.nym, sig.disclosure, sig.disclosed_attrs)
        ts = schnorr.recompute_commitments(rels, sig.challenge,
                                           sig.responses)
        bases.append((sig, hidden, tuple(ts)))
    return IdemixWorld(isk, sk, cred, bases)


def resign(world: IdemixWorld, k: int, msg: bytes):
    """Base signature k over `msg`: the same points and commitments, the
    challenge of the new message, and responses z' = z + (c' - c) x."""
    sig, hidden, ts = world.bases[k]
    c = isig._challenge_bytes(
        world.ipk, list(ts), sig.a_prime, sig.a_bar, sig.b_prime, sig.nym,
        sig.disclosure, sig.disclosed_attrs, msg, sig.nonce)
    responses = {name: (z + (c - sig.challenge) * hidden[name]) % bn.R
                 for name, z in sig.responses.items()}
    return dataclasses.replace(sig, challenge=c, responses=responses)


def idemix_lanes(world: IdemixWorld, n: int, tag: bytes):
    """n (signature, message) lanes: base k = j mod the bases, each over
    its own message."""
    lanes = []
    for j in range(n):
        msg = b"%s-%d" % (tag, j)
        lanes.append((resign(world, j % len(world.bases), msg), msg))
    return lanes


def tamper(sig, how: str):
    if how == "challenge":
        return dataclasses.replace(sig, challenge=(sig.challenge + 1) % bn.R)
    if how == "off_curve":
        return dataclasses.replace(
            sig, a_prime=(sig.a_prime[0], (sig.a_prime[1] + 1) % bn.P))
    if how == "missing_response":
        return dataclasses.replace(
            sig, responses={k: v for k, v in sig.responses.items()
                            if k != "sk"})
    if how == "disclosure_length":
        return dataclasses.replace(sig, disclosure=[True])
    raise ValueError(how)


def msm_oracle(shared, lane_pts, scalars, layout) -> tuple:
    """Per accumulator, the host sum of base^scalar over its terms."""
    tables = (*shared, *lane_pts)
    return tuple(
        bn.g1_msm([(tables[tab], s) for tab, acc, s in
                   zip(layout[0], layout[1], scalars) if acc == a])
        for a in range(bk.N_ACCS))


def compare_b3(t: dict, errs: dict) -> torch.Tensor:
    """The kernel against its plain version on the same CUDA tensors, word
    for word; records the largest |kernel - plain| word and the lanes
    that differ.  Returns the kernel's output."""
    got = bk.commitments(t)
    want = bk.commitments_plain(t)
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(want.shape), f"{B3_NAME}: shape")
    g = got.cpu().numpy().view(np.uint32).astype(np.int64)
    w = want.cpu().numpy().view(np.uint32).astype(np.int64)
    diff = np.abs(g - w)
    seen = errs.setdefault(B3_NAME, {"max_abs_err": 0, "mismatches": 0,
                                     "lanes": 0})
    seen["max_abs_err"] = max(seen["max_abs_err"], int(diff.max()))
    seen["mismatches"] += int(diff.any(axis=0).sum())
    seen["lanes"] += g.shape[1]
    check(not diff.any(), f"{B3_NAME}: kernel and plain version disagree "
          f"on {int(diff.any(axis=0).sum())} lanes")
    return got


def crafted_lanes(world: IdemixWorld, rng):
    """A custom layout and 4 lanes that force the degenerate branches of
    the reduction: T3 = h_attrs[1]^s . a_bar^s, a comb partial beside a
    ladder partial, with a_bar = h_attrs[1] (equal partials: the
    doubling) and a_bar = -h_attrs[1] (opposite: infinity), a generic
    lane and a bad lane."""
    n_shared = 3 + len(MSP_ATTRS)
    layout = ((0, 4, n_shared + 1, n_shared + 1, 0), (0, 2, 2, 0, 2))
    g = bn.G1_GEN
    h = world.ipk.h_attrs[1]
    pts, scs = [], []
    for j, a_bar in enumerate((None, h, bn.g1_neg(h), None)):
        p = [bn.g1_mul(g, 3 + 10 * j + b) for b in range(4)]
        sc = [bn.rand_zr(rng) for _ in layout[0]]
        if a_bar is not None:
            p[1] = a_bar
            sc[2], sc[4] = sc[1], 0
        pts.append(tuple(p))
        scs.append(sc)
    return layout, pts, scs, [True, True, True, False]


def phase_b3_edges(world: IdemixWorld, device, errs: dict,
                   n: int = B3_EDGE_LANES) -> None:
    """B3 against its plain version and the host recomputation: valid
    lanes, a tampered challenge, an off-curve a', a missing response, a
    wrong disclosure length and padding lanes in the MSP layout, then the
    degenerate lanes in a custom layout."""
    ipk = world.ipk
    n_sigs = n - 16  # the rest are padding lanes
    lanes = idemix_lanes(world, n_sigs, b"b3-edge")
    sigs = [s for s, _ in lanes]
    for j, how in ((1, "challenge"), (2, "off_curve"),
                   (3, "missing_response"), (4, "disclosure_length")):
        sigs[j] = tamper(sigs[j], how)
    n_attrs = len(ipk.h_attrs)
    layout = bb.term_layout(n_attrs)
    pts, scs, ok = bb.prepare_sigs(sigs, n_attrs)
    check(ok[:5] == [True, True, False, False, False] and all(ok[5:]),
          f"host prep marked {[j for j, v in enumerate(ok) if not v]} bad")
    key = bb.shared_points(ipk)
    bb.shared_comb.cache_clear()
    t0 = time.perf_counter()
    shared = bb.shared_comb(key)
    print(f"shared_comb: {len(key)} shared bases x {bk.NWINDOWS} windows x "
          f"{bk.TABLE} entries ({shared['xy'].nbytes + shared['inf'].nbytes}"
          f" B) built in {time.perf_counter() - t0:.3f} s, once per issuer "
          f"key")
    t = bk.upload(bk.pack(pts, scs, ok, *layout, lanes=n), shared, device)
    out = compare_b3(t, errs)
    aff = bb.to_affine(bk.unpack(out, n_sigs), ok)
    tampered = isig._relations(ipk, sigs[1].a_prime, sigs[1].a_bar,
                               sigs[1].b_prime, sigs[1].nym,
                               sigs[1].disclosure, sigs[1].disclosed_attrs)
    want_1 = tuple(schnorr.recompute_commitments(
        tampered, sigs[1].challenge, sigs[1].responses))
    for j in range(n_sigs):
        if not ok[j]:
            check(aff[j] is None, f"B3 lane {j}: a bad lane has a result")
            continue
        # a re-signed lane shares its base's commitments
        want = want_1 if j == 1 else world.bases[j % len(world.bases)][2]
        check(aff[j] == want, f"B3 lane {j}: T1..T3 differ from the host")
    check(want_1 != world.bases[1][2], "the tampered lane kept its T")
    pad = out[:, n_sigs:].cpu()
    check(bool((pad[bk.INF_ROW:] == 1).all())
          and not bool(pad[:bk.INF_ROW].any()),
          "padding lanes are not at infinity")

    layout, pts, scs, ok = crafted_lanes(world, random.Random(SEED + 3))
    t = bk.upload(bk.pack(pts, scs, ok, *layout), shared, device)
    aff = bb.to_affine(bk.unpack(compare_b3(t, errs)), [True] * len(ok))
    shared_pts = bb.shared_points(ipk)
    for j in range(len(ok)):
        want = (msm_oracle(shared_pts, pts[j], scs[j], layout) if ok[j]
                else (None,) * bk.N_ACCS)
        check(aff[j] == want, f"B3 custom lane {j}: differs from the host")
    h = ipk.h_attrs[1]
    check(aff[1][2] == bn.g1_mul(h, 2 * scs[1][1]) and aff[2][2] is None,
          "the doubling and infinity lanes did not take their branches")
    seen = errs[B3_NAME]
    print(f"{B3_NAME} edges: {n} + {len(ok)} lanes, kernel == plain word "
          f"for word ({seen['mismatches']} mismatches), == host on every "
          f"valid lane; bad lanes and {n - n_sigs} padding lanes at "
          f"infinity; the doubling and infinity branches taken")


def phase_idemix_main(world: IdemixWorld, device,
                      n: int = IDEMIX_LANES) -> dict:
    """The idemix main path, counted: n signatures (one tampered
    challenge, one off-curve a') through `IdemixCSP.verify_batch` on the
    card; then a forged pairing in a batch of its own; then the wall of
    the n-signature batch split by stage.  Returns what the kernel's
    timing needs."""
    ipk = world.ipk
    lanes = idemix_lanes(world, n, b"main")
    bad = {5: "challenge", n - 3: "off_curve"}
    items = [IdemixVerifyItem(tamper(s, bad[j]) if j in bad else s, m)
             for j, (s, m) in enumerate(lanes)]
    csp = new_idemix_csp(rng=random.Random(SEED), device=device,
                         use_device=True)
    bk.launches_bn254 = 0
    bk.kernel_launches_bn254 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = csp.verify_batch(items, ipk)
    wall = time.perf_counter() - t0
    launches = bk.launches_bn254
    kernel_launches = bk.kernel_launches_bn254
    rejected = [j for j, v in enumerate(mask) if not v]
    check(rejected == sorted(bad), f"idemix batch: rejected {rejected[:8]}, "
          f"expected {sorted(bad)}")
    check(launches > 0 and kernel_launches > 0,
          f"{B3_NAME} did not launch on the main path")
    print(f"idemix main path: {n} signatures in {wall:.3f} s = "
          f"{n / wall:.1f} sigs/s; {launches} launches of {B3_NAME} "
          f"({kernel_launches} CUDA kernel launches: term phase and "
          f"reduction)")

    forged_cred = dataclasses.replace(world.cred,
                                      a=bn.g1_mul(bn.G1_GEN, 5))
    forged = isig.new_signature(forged_cred, world.sk, ipk, b"forged",
                                disclosure=MSP_DISCLOSURE,
                                rng=random.Random(SEED + 1))
    small = [IdemixVerifyItem(s, m) for s, m in
             idemix_lanes(world, FORGED_BATCH - 1, b"forged-batch")]
    small.insert(7, IdemixVerifyItem(forged, b"forged"))
    t0 = time.perf_counter()
    mask = csp.verify_batch(small, ipk)
    forged_s = time.perf_counter() - t0
    check([j for j, v in enumerate(mask) if not v] == [7],
          f"forged-pairing batch: mask {mask}")
    print(f"idemix forged pairing: {FORGED_BATCH} signatures in "
          f"{forged_s:.3f} s (combined check fails, one pairing per lane)")
    native_vs_python(small, ipk)

    # the same batch again, stage by stage
    sigs = [it.sig for it in items]
    n_attrs = len(ipk.h_attrs)
    layout = bb.term_layout(n_attrs)
    stages = {}
    t0 = time.perf_counter()
    pts, scs, ok = bb.prepare_sigs(sigs, n_attrs)
    packed = bk.pack(pts, scs, ok, *layout)
    t = bk.upload(packed, bb.shared_comb(bb.shared_points(ipk)), device)
    torch.cuda.synchronize()
    stages["host prep + packing + upload"] = time.perf_counter() - t0
    kernel_ms = cuda_ms(lambda: bk.commitments(t), TIMING_REPS)
    stages["kernel (CUDA events, median)"] = kernel_ms / 1e3
    out = bk.commitments(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aff = bb.to_affine(bk.unpack(out), ok)
    stages["readback + Jacobian -> affine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok2 = [
        tri is not None and isig._challenge_bytes(
            ipk, list(tri), s.a_prime, s.a_bar, s.b_prime, s.nym,
            s.disclosure, s.disclosed_attrs, it.msg, s.nonce) == s.challenge
        for s, it, tri in zip(sigs, items, aff)
    ]
    stages["challenge re-hash"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mask2 = isig._pairing_mask(sigs, ok2, ipk, random.Random(SEED))
    stages["RLC MSM + two pairings (C++)"] = time.perf_counter() - t0
    check(mask2 == mask_of(n, bad), "stage-by-stage mask differs")
    total = sum(stages.values())
    print(f"idemix wall split ({n} signatures, {total:.3f} s in all; "
          f"verify_batch took {wall:.3f} s):")
    for k, v in stages.items():
        print(f"  {k}: {v * 1e3:.1f} ms ({v / total:.1%})")
    return {"launches": launches, "tensors": t, "packed": packed,
            "n_shared": len(bb.shared_points(ipk)), "wall": wall,
            "kernel_ms": kernel_ms}


def native_vs_python(items, ipk) -> None:
    """The C++ MSM and pairing check against the pure-Python functions on
    the forged-pairing batch's inputs to `signature._pairing_mask`: the
    two RLC MSMs, the combined check (fails) and the per-signature
    checks (only the forged one fails)."""
    sigs = [it.sig for it in items]
    rng = random.Random(SEED)
    weights = [bn.rand_zr(rng) for _ in sigs]
    times = {"native": 0.0, "python": 0.0}

    def both(fn_native, fn_python, *args):
        out = []
        for key, fn in (("native", fn_native), ("python", fn_python)):
            t0 = time.perf_counter()
            out.append(fn(*args))
            times[key] += time.perf_counter() - t0
        check(out[0] == out[1], f"native {fn_native.__name__} != Python")
        return out[0]

    acc = [both(bn.g1_msm, bn._g1_msm_py,
                [(getattr(s, f), w) for s, w in zip(sigs, weights)])
           for f in ("a_prime", "a_bar")]
    one = lambda pairs: bn.multi_pairing(pairs) == bn.FP12_ONE  # noqa: E731
    check(not both(bn.pairing_check, one,
                   [(acc[0], ipk.w), (bn.g1_neg(acc[1]), bn.G2_GEN)]),
          "the forged batch's combined pairing check passed")
    per_sig = [both(bn.pairing_check, one,
                    [(s.a_prime, ipk.w), (bn.g1_neg(s.a_bar), bn.G2_GEN)])
               for s in sigs]
    check([j for j, v in enumerate(per_sig) if not v] == [7],
          f"per-signature pairings: {per_sig}")
    print(f"idemix native vs Python on the forged batch's inputs: 2 MSMs of "
          f"{len(sigs)} terms and {1 + len(sigs)} pairing checks equal; "
          f"native {times['native'] * 1e3:.1f} ms, Python "
          f"{times['python'] * 1e3:.1f} ms")


def mask_of(n: int, bad) -> list[bool]:
    return [j not in bad for j in range(n)]


def phase_crossover(world: IdemixWorld, device, sizes=CROSSOVER_SIZES,
                    reps: int = CROSSOVER_REPS) -> int | None:
    """verify_batch on the card and on the host at each size, `reps`
    times each in turns (the card first on even reps, the host first on
    odd ones), through one provider per path warmed up once.  Returns the
    measured crossover: the smallest size from which the card's median
    beats the host's at every size swept (None if it never does).  Also
    prints the smallest size from which the card's slowest rep beats the
    host's fastest at every size swept (the spreads apart), and the
    margin at each size."""
    ipk = world.ipk
    csps = {use: new_idemix_csp(rng=random.Random(SEED), device=device,
                                use_device=use) for use in (True, False)}
    warm = [IdemixVerifyItem(s, m)
            for s, m in idemix_lanes(world, 1, b"crossover-warm")]
    for use, csp in csps.items():
        check(all(csp.verify_batch(warm, ipk)), f"crossover warm-up "
              f"rejected (device={use})")
    wins, apart, margins = [], [], {}
    for size in sizes:
        items = [IdemixVerifyItem(s, m) for s, m in
                 idemix_lanes(world, size, b"crossover-%d" % size)]
        times = {True: [], False: []}
        for rep in range(reps):
            for use in ((True, False) if rep % 2 == 0 else (False, True)):
                t0 = time.perf_counter()
                mask = csps[use].verify_batch(items, ipk)
                times[use].append(time.perf_counter() - t0)
                check(all(mask), f"crossover {size}: {mask.count(False)} "
                      f"rejected (device={use})")
        card = statistics.median(times[True])
        host = statistics.median(times[False])
        wins.append(card < host)
        apart.append(max(times[True]) < min(times[False]))
        margins[size] = (host - card) / host
        print(f"idemix crossover at {size} signatures, median of {reps} in "
              f"turns: card {card * 1e3:.2f} ms (range "
              f"{min(times[True]) * 1e3:.2f}-{max(times[True]) * 1e3:.2f}; "
              f"{size / card:.1f} sigs/s), host {host * 1e3:.2f} ms (range "
              f"{min(times[False]) * 1e3:.2f}-{max(times[False]) * 1e3:.2f}; "
              f"{size / host:.1f} sigs/s); the card {margins[size]:+.1%} "
              "faster")

    def from_on(flags) -> int | None:
        out = None
        for size, ok in zip(reversed(sizes), reversed(flags)):
            if not ok:
                break
            out = size
        return out

    crossover, clear = from_on(wins), from_on(apart)
    chosen = IdemixCSP.DEVICE_CROSSOVER
    print(f"idemix crossover: the card's median wins from {crossover} "
          f"signatures on, its slowest rep beats the host's fastest from "
          f"{clear} on (sizes {list(sizes)}); DEVICE_CROSSOVER = {chosen}"
          + (f", the card {margins[chosen]:+.1%} faster there"
             if chosen in margins else ""))
    return crossover


# ---------------------------------------------------------------------------
# The idemix MSP: identities, their proofs on B3, nym signatures, the CRI.
# ---------------------------------------------------------------------------

MSP_ID = "IdemixOrg"
MSP_IDENTITIES = 256
# the signers the identities take turns over: (OU, role, enrollment id)
MSP_SIGNERS = (("ou1", idemixmsp.ROLE_MEMBER, "alice"),
               ("ou2", idemixmsp.ROLE_ADMIN, "bob"),
               ("ou1", idemixmsp.ROLE_ADMIN, "carol"),
               ("ou3", idemixmsp.ROLE_MEMBER, "dave"))
# a planted wire fault, and the start of the error it must raise
MSP_LIES = {
    "ou": "idemix identity: OU mismatch",
    "role": "idemix identity: role mismatch",
    "disclosure": "idemix identity: wrong disclosure",
    "unbound": "idemix identity: proof not bound to nym",
    "off_curve": "idemix identity: nym not on curve",
    "malformed": "malformed idemix identity: ",
    "challenge": "idemix identity: credential proof invalid",
    "mspid": f"expected MSP ID {MSP_ID}, got OtherOrg",
}
# the proofs tampered in the B3 batch (chip_smoke.tamper's kinds)
MSP_TAMPERED = ("challenge", "off_curve", "missing_response", "challenge",
                "off_curve", "missing_response", "challenge", "off_curve")
CRI_EPOCH = 7


def msp_world(seed: int, n: int = MSP_IDENTITIES):
    """An issuer with the MSP's 4 attributes, a signer config per
    MSP_SIGNERS, an IdemixMSP built from its own config bytes (the first
    signer its default), and n signing identities, each a fresh nym of
    the next signer's credential."""
    rng = random.Random(seed)
    issuer = idemixmsp.generate_issuer(rng)
    signers = [idemixmsp.issue_signer_config(issuer, MSP_ID, ou, role, eid,
                                             rng=rng)
               for ou, role, eid in MSP_SIGNERS]
    conf = idemixmsp.idemix_msp_config(issuer, MSP_ID, signers[0],
                                       epoch=CRI_EPOCH)
    msp = idemixmsp.IdemixMSP.from_config(mb.MSPConfig.decode(conf.encode()),
                                          rng=rng)
    creds = [(int.from_bytes(sc.sk, "big"), Credential.from_bytes(sc.cred),
              sc.organizational_unit_identifier, sc.role) for sc in signers]
    ids = []
    for j in range(n):
        sk, cred, ou, role = creds[j % len(creds)]
        ids.append(idemixmsp.IdemixSigningIdentity(
            MSP_ID, sk, cred, issuer.ipk, ou, role, rng=rng))
    return msp, issuer, ids


def identity_with(raw: bytes, how: str, other: bytes = b"") -> bytes:
    """A serialized idemix identity with one planted fault: a key of
    MSP_LIES, or "proof:<kind>" for its proof through tamper(); `other`
    lends its nym to "unbound"."""
    sid = mb.SerializedIdentity.decode(raw)
    sii = mb.SerializedIdemixIdentity.decode(sid.id_bytes)
    if how.startswith("proof:"):
        sii.proof = tamper(isig.Signature.from_bytes(sii.proof),
                           how[len("proof:"):]).to_bytes()
    elif how == "ou":
        sii.ou = b"ou-forged"
    elif how == "role":
        role = int.from_bytes(sii.role, "big")
        lie = (idemixmsp.ROLE_ADMIN if role == idemixmsp.ROLE_MEMBER
               else idemixmsp.ROLE_MEMBER)
        sii.role = lie.to_bytes(4, "big")
    elif how == "disclosure":
        proof = isig.Signature.from_bytes(sii.proof)
        sii.proof = dataclasses.replace(
            proof, disclosure=[True, False, False, False]).to_bytes()
    elif how == "unbound":
        donor = mb.SerializedIdemixIdentity.decode(
            mb.SerializedIdentity.decode(other).id_bytes)
        sii.nym_x, sii.nym_y = donor.nym_x, donor.nym_y
    elif how == "off_curve":
        y = (int.from_bytes(sii.nym_y, "big") + 1) % bn.P
        sii.nym_y = y.to_bytes(32, "big")
    elif how == "malformed":
        sii.proof = sii.proof[:40]
    elif how == "challenge":
        sii.proof = tamper(isig.Signature.from_bytes(sii.proof),
                           "challenge").to_bytes()
    elif how == "mspid":
        sid.mspid = "OtherOrg"
    else:
        raise ValueError(how)
    sid.id_bytes = sii.encode()
    return sid.encode()


def msp_verdicts(msp, wire: list) -> tuple[list, list]:
    """deserialize_identity over every identity: (identity or None,
    error text or None) per identity."""
    got, errors = [], []
    for raw in wire:
        try:
            got.append(msp.deserialize_identity(raw))
            errors.append(None)
        except idemixmsp.IdemixMSPError as e:
            got.append(None)
            errors.append(str(e))
    return got, errors


def p384_ms(reps: int = TIMING_REPS) -> tuple[float, float]:
    """hostref384's sign and verify of a CRI-sized message, ms (median)."""
    key = hostref384.key_gen(random.Random(SEED))
    data = b"idemix-cri" + bytes(137)
    sig = key.sign(data)
    return (host_ms(lambda: key.sign(data), reps),
            host_ms(lambda: hostref384.verify(key.public_key(), sig, data),
                    reps))


def phase_idemix_msp(device, n: int = MSP_IDENTITIES,
                     n_nym: int = MSP_IDENTITIES) -> dict:
    """The idemix MSP on the card.  n identities deserialized, one of each
    MSP_LIES planted, each verdict checked; the same n identity proofs
    (msg b"", MSP_TAMPERED's 8 tampered) through one
    `IdemixCSP.verify_batch` on the card, counted, its mask the MSP's
    verdicts on those identities; n_nym nym signatures signed and
    verified, one flipped and refused; a CRI created and verified with
    the port's P-384, a flipped signature byte and a flipped epoch_pk byte
    refused."""
    t0 = time.perf_counter()
    msp, issuer, ids = msp_world(SEED, n)
    setup_s = time.perf_counter() - t0
    raws = [ident.serialize() for ident in ids]
    step = n // len(MSP_LIES)
    lies = {j * step: how for j, how in enumerate(MSP_LIES)}
    wire = [identity_with(raws[j], lies[j], raws[(j + 1) % n])
            if j in lies else raws[j] for j in range(n)]
    t0 = time.perf_counter()
    got, errors = msp_verdicts(msp, wire)
    deser_s = time.perf_counter() - t0
    for j, ident in enumerate(ids):
        if j in lies:
            check(errors[j] is not None
                  and errors[j].startswith(MSP_LIES[lies[j]]),
                  f"identity {j} ({lies[j]}): {errors[j]!r}")
        else:
            check(got[j] is not None and got[j].nym == ident.nym
                  and (got[j].ou, got[j].role) == (ident.ou, ident.role),
                  f"identity {j} did not deserialize: {errors[j]!r}")
    print(f"idemix MSP setup: issuer, {len(MSP_SIGNERS)} signer configs, "
          f"the MSP from its config bytes and {n} signing identities in "
          f"{setup_s:.2f} s")
    print(f"idemix MSP: {n} identities deserialized in {deser_s:.3f} s = "
          f"{n / deser_s:.1f} identities/s; the {len(lies)} planted "
          f"({', '.join(MSP_LIES)}) refused, each with its own error")

    # B3: the identities' proofs, 8 tampered, in one batch on the card
    bad = {j * step + step // 2: how for j, how in enumerate(MSP_TAMPERED)}
    wire = [identity_with(raws[j], "proof:" + bad[j]) if j in bad
            else raws[j] for j in range(n)]
    got, errors = msp_verdicts(msp, wire)
    verdicts = [g is not None for g in got]
    check([j for j, v in enumerate(verdicts) if not v] == sorted(bad),
          f"MSP verdicts on the tampered proofs: {errors}")
    # the proofs as the identities carry them (an off-curve a' does not
    # parse from the wire: the MSP refuses it as malformed)
    items = [IdemixVerifyItem(tamper(ident.proof, bad[j]) if j in bad
                              else ident.proof, b"")
             for j, ident in enumerate(ids)]
    csp = new_idemix_csp(rng=random.Random(SEED), device=device)
    bk.launches_bn254 = 0
    bk.kernel_launches_bn254 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = csp.verify_batch(items, msp.ipk)
    batch_s = time.perf_counter() - t0
    launches = bk.launches_bn254
    check(mask == verdicts, "B3's mask differs from the MSP's verdicts at "
          f"{[j for j in range(n) if mask[j] != verdicts[j]]}")
    check(launches > 0, f"{B3_NAME} did not launch on the idemix MSP batch")
    print(f"idemix MSP batch: {n} identity proofs ({len(bad)} tampered) "
          f"through IdemixCSP.verify_batch in {batch_s:.3f} s = "
          f"{n / batch_s:.1f} proofs/s; mask = the MSP's verdicts; "
          f"{launches} launches of {B3_NAME} "
          f"({bk.kernel_launches_bn254} CUDA kernel launches)")

    # nym signatures
    msgs = [b"tx-payload-%d" % j for j in range(n_nym)]
    signers = [ids[j % n] for j in range(n_nym)]
    t0 = time.perf_counter()
    sigs = [ident.sign(m) for ident, m in zip(signers, msgs)]
    sign_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = [msp.verify(ident, m, sig)
          for ident, m, sig in zip(signers, msgs, sigs)]
    verify_s = time.perf_counter() - t0
    check(all(ok), f"nym signatures refused: {ok.count(False)}")
    flipped = json.loads(sigs[0])
    flipped["z_sk"] = (flipped["z_sk"] + 1) % bn.R
    check(not msp.verify(signers[0], msgs[0], json.dumps(flipped).encode())
          and not msp.verify(signers[0], msgs[1], sigs[0]),
          "a flipped nym signature (or another message) was accepted")
    print(f"idemix MSP nym signatures: {n_nym} signed in {sign_s:.3f} s "
          f"({n_nym / sign_s:.1f}/s), verified in {verify_s:.3f} s "
          f"({n_nym / verify_s:.1f} verifies/s); a flipped one refused")

    # the revocation authority's CRI on the port's P-384
    ra = csp.revocation_key_gen()
    t0 = time.perf_counter()
    cri = csp.create_cri(ra, CRI_EPOCH)
    create_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    check(csp.verify_cri(ra.public_key(), cri), "the CRI does not verify")
    verify_cri_ms = (time.perf_counter() - t0) * 1e3
    back = type(cri).from_bytes(cri.to_bytes())
    check(back == cri, "the CRI's JSON does not round-trip")
    sig = bytearray(cri.epoch_pk_sig)
    sig[len(sig) // 2] ^= 1
    pk = bytearray(cri.epoch_pk)
    pk[5] ^= 1
    check(not csp.verify_cri(ra.public_key(), dataclasses.replace(
        cri, epoch_pk_sig=bytes(sig))), "a flipped signature byte passed")
    check(not csp.verify_cri(ra.public_key(), dataclasses.replace(
        cri, epoch_pk=bytes(pk))), "a flipped epoch_pk byte passed")
    sign_ms, verify_ms = p384_ms()
    print(f"idemix MSP CRI (epoch {CRI_EPOCH}): created in {create_ms:.2f} "
          f"ms, verified in {verify_cri_ms:.2f} ms; a flipped signature "
          f"byte and a flipped epoch_pk byte refused; hostref384 (P-384, "
          f"pure Python) sign {sign_ms:.2f} ms, verify {verify_ms:.2f} ms")
    return {"launches": launches, "identities_per_s": n / deser_s,
            "nym_verifies_per_s": n_nym / verify_s,
            "p384_sign_ms": sign_ms, "p384_verify_ms": verify_ms}


def b3_bound(packed: dict, n_shared: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the commitments of
    `packed`: each input read once and the output written once over the
    HBM rate, against the multiply-adds these digits need over the
    32-bit peak (table chains of the finite lane bases; per accumulator,
    4 doublings a window once it is finite, and one add per nonzero
    digit once it is finite)."""
    meta = np.asarray(packed["termmeta"])
    n_terms = meta.shape[0]
    words = np.asarray(packed["digits"], np.uint32).reshape(n_terms, 8, 1, -1)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :, None]
    digits = ((words >> shifts) & 0xF).reshape(n_terms, bk.NWINDOWS, -1)
    lanes = digits.shape[-1]
    finite_bases = int((np.asarray(packed["laneinf"]) == 0).sum())
    muls = finite_bases * (bk.TABLE - 2) * BN_MULS_MIXED
    for a in range(bk.N_ACCS):
        terms = [t for t in range(n_terms) if meta[t, 1] == a]
        live = np.zeros(lanes, bool)
        for w in range(bk.NWINDOWS):
            muls += 4 * BN_MULS_DBL * int(live.sum())
            for t in terms:
                nz = digits[t, w] != 0
                cost = BN_MULS_MIXED if meta[t, 0] < n_shared else BN_MULS_FULL
                muls += cost * int((nz & live).sum())
                live |= nz
    ops = muls * BN_WORD_PRODUCTS * 2
    nbytes = (lanes * 4 * (64 + 4 + 8 * n_terms + bk.OUT_ROWS)
              + 8 * n_terms + n_shared * bk.TABLE * 4 * 17)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S_32BIT * 1e3
    print(f"{B3_NAME} bound: {muls / lanes:.0f} field multiplications per "
          f"lane, {nbytes / lanes:.0f} bytes per lane")
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b3_kernel_muls(packed: dict, n_shared: int) -> tuple[float, int, int]:
    """The field multiplications the kernel itself does on `packed`, as
    (per lane over all its threads, the longest term thread, the longest
    reduction thread): a shared-base term one mixed add per nonzero digit
    after its first; a lane-base term of a finite base its table chain,
    then, once its partial is finite, 4 doublings a window and one full
    add per nonzero digit; an accumulator one full add per finite partial
    after its first.  Unlike `b3_bound`, this is the design's count, not
    the function's."""
    meta = np.asarray(packed["termmeta"])
    n_terms = meta.shape[0]
    words = np.asarray(packed["digits"], np.uint32).reshape(n_terms, 8, 1, -1)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :, None]
    nz = ((words >> shifts) & 0xF).reshape(n_terms, bk.NWINDOWS, -1) != 0
    lanes = nz.shape[-1]
    laneinf = np.asarray(packed["laneinf"]) != 0
    nnz = nz.sum(axis=1)  # (T, lanes)
    first = np.argmax(nz, axis=1)  # the first nonzero window
    finite = np.zeros((n_terms, lanes), bool)
    term_muls = np.zeros((n_terms, lanes), np.int64)
    for t, (tab, _) in enumerate(meta):
        if tab < n_shared:
            finite[t] = nnz[t] > 0
            term_muls[t] = BN_MULS_MIXED * np.maximum(nnz[t] - 1, 0)
            continue
        base = ~laneinf[tab - n_shared]
        finite[t] = base & (nnz[t] > 0)
        ladder = (4 * BN_MULS_DBL * (bk.NWINDOWS - 1 - first[t])
                  + BN_MULS_FULL * (nnz[t] - 1))
        term_muls[t] = np.where(base, (bk.TABLE - 2) * BN_MULS_MIXED, 0)
        term_muls[t] += np.where(finite[t], ladder, 0)
    reduce_muls = np.stack([
        BN_MULS_FULL * np.maximum(finite[meta[:, 1] == a].sum(axis=0) - 1, 0)
        for a in range(bk.N_ACCS)])
    total = int(term_muls.sum() + reduce_muls.sum())
    return total / lanes, int(term_muls.max()), int(reduce_muls.max())


def phase_b3_kernel(main: dict, errs: dict, reps: int = TIMING_REPS,
                    plain_reps: int = PLAIN_REPS) -> dict:
    t = main["tensors"]
    compare_b3(t, errs)
    ms = cuda_ms(lambda: bk.commitments(t), reps)
    plain_ms = cuda_ms(lambda: bk.commitments_plain(t), plain_reps)
    bound_ms, bound_by = b3_bound(main["packed"], main["n_shared"])
    per_lane, longest, longest_reduce = b3_kernel_muls(main["packed"],
                                                       main["n_shared"])
    print(f"{B3_NAME} kernel's own work: {per_lane:.0f} field "
          f"multiplications per lane over all its threads; the longest "
          f"thread {longest} (a term), then {longest_reduce} (a reduction)")
    lanes = t["lanes"].shape[-1]
    seen = errs[B3_NAME]
    print(f"{B3_NAME}: {lanes} lanes, kernel {ms:.3f} ms "
          f"({lanes / ms * 1e3:.0f} sigs/s), plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {ms / bound_ms:.0f}x); "
          f"{main['launches']} launches on the main path; "
          f"{seen['mismatches']} mismatches in {seen['lanes']} lanes "
          f"against the plain version")
    lo, hi = B3_ONE_THREAD_MS
    print(f"{B3_NAME}: the one-thread-per-signature design took {lo:.3f}-"
          f"{hi:.3f} ms at 1024 lanes on an H100 80GB HBM3 at 700 W "
          f"(PERF.md); this run {ms:.3f} ms ({lo / ms:.1f}-{hi / ms:.1f}x)")
    busy = main["launches"] * ms
    print(f"{B3_NAME}: device busy ~{busy:.1f} ms of the "
          f"{main['wall'] * 1e3:.1f} ms idemix wall "
          f"({busy / (main['wall'] * 1e3):.2%}; launches x kernel ms)")
    return {
        "name": B3_NAME,
        "route": "cuda",
        "source": B3_SOURCE,
        "replaces": B3_REPLACES,
        "launches": main["launches"],
        "max_abs_err": seen["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes a BN254 MSM
    }


def phase_b3_sweep(t: dict, sizes=B3_SWEEP, reps: int = TIMING_REPS):
    """B3's time against the batch size: the main path's lanes, cut or
    repeated to each size (the same issuer key and terms)."""
    n = t["lanes"].shape[-1]
    for size in sizes:
        copies = -(-size // n)
        sub = {k: v if k in ("termmeta", "comb_xy", "comb_inf") else
               torch.cat([v] * copies, dim=-1)[..., :size].contiguous()
               for k, v in t.items()}
        ms = cuda_ms(lambda sub=sub: bk.commitments(sub), reps)
        print(f"{B3_NAME} lanes sweep: {size} lanes, kernel {ms:.3f} ms "
              f"({size / ms * 1e3:.0f} sigs/s)")


def random_messages(rng, lens) -> list[bytes]:
    raw = rng.integers(0, 256, int(np.sum(lens)), dtype=np.uint8).tobytes()
    ends = np.cumsum(lens)
    return [raw[e - int(n):e] for e, n in zip(ends, lens)]


def b4_bound(msgs) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for hashing `msgs`: the
    messages and their offsets read once and the digests written once over
    the HBM rate, against the compressions they need times the integer
    operations of one over the 32-bit peak."""
    lens = np.array([len(m) for m in msgs], np.int64)
    compressions = int(((lens + 9 + 63) // 64).sum())
    t_ops = compressions * SHA_OPS_PER_COMPRESSION / OPS_PER_S_32BIT * 1e3
    nbytes = int(lens.sum()) + 8 * (len(msgs) + 1) + 32 * len(msgs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def host_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the host clock (after a warm-up),
    each run ending in a synchronise."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def hashlib_digests(msgs) -> list[bytes]:
    return [hashlib.sha256(m).digest() for m in msgs]


def upload_messages(msgs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's inputs: the messages joined on the card, their
    offsets pinned on the host."""
    buf, offs = sha.join_messages(msgs)
    return (torch.as_tensor(buf.copy(), device=device),
            torch.from_numpy(offs).pin_memory())


def compare_b4(name: str, msgs, device, errs: dict) -> list[bytes]:
    """B4 on `msgs` against hashlib and, for messages of at most
    HASH_PLAIN_MAX_BYTES, against sha256_plain on the same card; records
    the largest |kernel - plain| digest word and the mismatches."""
    t_buf, t_offs = upload_messages(msgs, device)
    got = sha.sha256_digests(t_buf, t_offs).cpu().numpy()
    digests = [row.tobytes() for row in got]
    want = hashlib_digests(msgs)
    seen = errs.setdefault(B4_NAME, {"max_abs_err": 0, "mismatches": 0,
                                     "lanes": 0, "plain_lanes": 0})
    wrong = [i for i, (a, b) in enumerate(zip(digests, want)) if a != b]
    seen["mismatches"] += len(wrong)
    seen["lanes"] += len(msgs)
    check(not wrong, f"{name}: B4 != hashlib on messages {wrong[:8]}")
    short = [i for i, m in enumerate(msgs) if len(m) <= HASH_PLAIN_MAX_BYTES]
    if short:
        words, nblk = sha.pad_messages([msgs[i] for i in short])
        plain = sha.sha256_plain(
            torch.as_tensor(words.astype(np.int64), device=device),
            torch.as_tensor(nblk, device=device)).cpu().numpy()
        kern = got[short].view(">u4").astype(np.int64)
        err = int(np.abs(kern - plain).max())
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
        seen["plain_lanes"] += len(short)
        check(err == 0, f"{name}: B4 != sha256_plain on "
              f"{int((kern != plain).any(axis=1).sum())} messages")
    print(f"{B4_NAME} {name}: {len(msgs)} messages of {min(map(len, msgs))}"
          f"-{max(map(len, msgs))} bytes == hashlib, {len(short)} of them "
          f"== sha256_plain on the card")
    return digests


def phase_hash_callers(rng, csp: CUDACSP, n_txs: int = HASH_TXS,
                       files=HASH_SNAPSHOT_FILES,
                       reps: int = TIMING_REPS) -> None:
    """hash_batch at its callers' shapes, counted: a block's per-
    transaction calls over three endorsement messages each, and a
    snapshot export's call over its five files.  Both stay under
    min_device_batch, so hashlib answers and B4 does not run; each is
    timed beside the hashlib loop that the parent's hash_batch was."""
    txs = [random_messages(rng, rng.integers(
        HASH_RESPONSE_BYTES[0], HASH_RESPONSE_BYTES[1] + 1, ENDORSERS))
        for _ in range(n_txs)]
    snapshot = random_messages(rng, np.array(files))
    for name, calls in (("per-transaction endorsements", txs),
                        ("snapshot export", [snapshot])):
        sha.launches_sha256 = 0
        got = [csp.hash_batch(msgs) for msgs in calls]
        launches = sha.launches_sha256
        check(got == [hashlib_digests(m) for m in calls],
              f"hash_batch != hashlib at the {name} shape")
        check(launches == 0, f"{B4_NAME} launched {launches} times at the "
              f"{name} shape, under min_device_batch")
        call_ms = host_ms(lambda: [csp.hash_batch(m) for m in calls], reps)
        lib_ms = host_ms(lambda: [hashlib_digests(m) for m in calls], reps)
        print(f"hash callers, {name}: {len(calls)} hash_batch calls of "
              f"{len(calls[0])} messages, {sum(map(len, sum(calls, [])))} "
              f"bytes: {launches} launches of {B4_NAME} (hashlib answers); "
              f"hash_batch {call_ms:.3f} ms, hashlib loop {lib_ms:.3f} ms")


def phase_hash_route(rng, device, shapes=HASH_ROUTE_SHAPES,
                     reps: int = TIMING_REPS) -> None:
    """hash_batch's routing rule (`provider.hash_on_card`) against both
    routes' times, the card's (`sha256_batch`: join, upload, B4,
    readback) and hashlib's, on batches either side of its boundary."""
    wrong = 0
    for length, n in shapes:
        msgs = random_messages(rng, np.full(n, length))
        card = host_ms(lambda: sha.sha256_batch(msgs, device), reps)
        lib = host_ms(lambda: hashlib_digests(msgs), reps)
        rule = "card" if hash_on_card(msgs) else "hashlib"
        faster = "card" if card < lib else "hashlib"
        wrong += rule != faster
        blocks = (length + 72) >> 6
        print(f"hash route: {n} x {length} bytes ({n * blocks} "
              f"compressions, longest {blocks}): card {card:.3f} ms, "
              f"hashlib {lib:.3f} ms; rule takes {rule}, {faster} faster")
    print(f"hash route: the rule took the slower route on {wrong} of "
          f"{len(shapes)} shapes")


def phase_sha256(rng, device, errs: dict, n_wide: int = HASH_WIDE_MSGS,
                 edge_lengths=HASH_EDGE_LENGTHS,
                 files=HASH_SNAPSHOT_FILES, reps: int = TIMING_REPS,
                 plain_reps: int = PLAIN_REPS) -> dict:
    """B4: hash_batch at its callers' shapes (hashlib answers); the wide
    batch through `CUDACSP.hash_batch` on the card, counted; the kernel
    against hashlib and sha256_plain on the edge lengths, the wide batch
    and the snapshot's files; the kernel (CUDA events), the whole
    hash_batch call and hashlib timed on the wide batch, the kernel and
    hashlib on the snapshot's files; the routing rule against both
    routes.  Returns the kernels-line row."""
    csp = new_cuda_csp(device=device)
    phase_hash_callers(rng, csp)
    edge = random_messages(rng, np.array(edge_lengths))
    wide = random_messages(rng, rng.integers(
        HASH_WIDE_BYTES[0], HASH_WIDE_BYTES[1] + 1, n_wide))
    snapshot = random_messages(rng, np.array(files))
    check(hash_on_card(wide), "the wide batch does not take the card route")
    sha.launches_sha256 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = csp.hash_batch(wide)
    wall = time.perf_counter() - t0
    launches = sha.launches_sha256
    check(launches > 0, f"{B4_NAME} did not launch on the card route")
    check(got == hashlib_digests(wide), "hash_batch != hashlib on the "
          "wide batch")
    print(f"hash card route: CUDACSP.hash_batch of {n_wide} messages "
          f"({sum(map(len, wide))} bytes) in {wall * 1e3:.1f} ms, "
          f"{launches} launches of {B4_NAME}; == hashlib")
    compare_b4("edges", edge, device, errs)
    compare_b4("wide", wide, device, errs)
    compare_b4("snapshot files", snapshot, device, errs)

    t_buf, t_offs = upload_messages(wide, device)
    ms = cuda_ms(lambda: sha.sha256_digests(t_buf, t_offs), reps)
    call_ms = host_ms(lambda: csp.hash_batch(wide), reps)
    lib_ms = host_ms(lambda: hashlib_digests(wide), reps)
    bound_ms, bound_by = b4_bound(wide)
    nbytes = sum(map(len, wide))
    print(f"{B4_NAME} wide: {n_wide} messages, {nbytes} bytes: kernel "
          f"{ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s), hash_batch "
          f"{call_ms:.3f} ms, hashlib {lib_ms:.3f} ms "
          f"({nbytes / lib_ms / 1e6:.2f} GB/s), bound {bound_ms:.4f} ms "
          f"({bound_by}, {ms / bound_ms:.0f}x)")
    s_buf, s_offs = upload_messages(snapshot, device)
    s_ms = cuda_ms(lambda: sha.sha256_digests(s_buf, s_offs), reps)
    s_lib = host_ms(lambda: hashlib_digests(snapshot), reps)
    print(f"{B4_NAME} snapshot files: {len(snapshot)} files, "
          f"{sum(map(len, snapshot))} bytes: kernel {s_ms:.3f} ms, hashlib "
          f"{s_lib:.3f} ms (one thread a file; hash_batch takes hashlib)")
    words, nblk = sha.pad_messages(wide)
    t_words = torch.as_tensor(words.astype(np.int64), device=device)
    t_nblk = torch.as_tensor(nblk, device=device)
    plain_ms = cuda_ms(lambda: sha.sha256_plain(t_words, t_nblk), plain_reps)
    print(f"{B4_NAME}: sha256_plain on the wide batch {plain_ms:.1f} ms "
          f"({words.shape[1]} lockstep block steps)")
    phase_hash_route(rng, device)
    chain = b4_chain_floor(wide, device, reps)
    seen = errs[B4_NAME]
    print(f"{B4_NAME}: {seen['mismatches']} mismatches in {seen['lanes']} "
          f"messages against hashlib, max |kernel - plain| "
          f"{seen['max_abs_err']} on {seen['plain_lanes']}")
    return {
        "name": B4_NAME,
        "route": "cuda",
        "source": B4_SOURCE,
        "replaces": B4_REPLACES,
        "launches": launches,
        "max_abs_err": seen["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes SHA-256
        "hashlib_ms": lib_ms,
        "chain_floor_ms": chain,
    }


def largest_loop(instrs: list[str]) -> list[str]:
    """The instructions of the longest backward branch's loop (all of
    them when there is none)."""
    addr = [int(i[2:i.index("*/")], 16) for i in instrs]
    best = instrs
    span = -1
    for k, instr in enumerate(instrs):
        m = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", instr)
        if m and int(m.group(1), 16) < addr[k]:
            start = addr.index(int(m.group(1), 16))
            if k - start > span:
                span = k - start
                best = instrs[start:k + 1]
    return best


def b4_chain_floor(wide, device, reps: int = TIMING_REPS) -> float:
    """B4's serial-chain floor: one message is one thread's chain of
    compressions, so a batch takes at least its longest message's
    compressions times one compression's dependent chain.  That chain is
    timed on the card with a lone thread (one message of the longest
    length against one of 0 bytes, CUDA events), and set beside the SASS
    of the compression loop and the SM clock; returns the floor in ms."""
    longest = max(len(m) for m in wide)
    n_long = (longest + 72) >> 6  # compressions, padding in
    msgs = {"long": [bytes(longest)], "short": [b""]}
    t = {}
    for name, m in msgs.items():
        buf, offs = upload_messages(m, device)
        t[name] = cuda_ms(lambda: sha.sha256_digests(buf, offs), reps)
    per = (t["long"] - t["short"]) / (n_long - 1)
    floor = n_long * per
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip()
    max_mhz = float(clocks.split(",")[1])
    ((_, instrs),) = build.sass(build.build_all()["sha256"]).items()
    body = largest_loop(instrs)
    cycles = per * 1e-3 * max_mhz * 1e6
    print(f"{B4_NAME} serial chain: one thread, {longest} bytes ({n_long} "
          f"compressions) {t['long']:.4f} ms, 0 bytes (1) {t['short']:.4f} "
          f"ms: {per * 1e3:.3f} us a compression; the compression loop is "
          f"{len(body)} SASS instructions ({sass_summary(body)}); SM clock "
          f"{clocks} MHz (now, max): ~{cycles:.0f} cycles a compression at "
          f"the max clock, {cycles / len(body):.2f} a loop instruction; "
          f"floor {n_long} x {per * 1e3:.3f} us = {floor:.4f} ms for the "
          f"wide batch's longest message")
    return floor


def phase_native() -> None:
    """The port's C++ host library builds with the host's g++ and loads."""
    gxx = shutil.which("g++")
    check(gxx is not None, "no g++ on this host")
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    path = native.build()
    native.load()
    print(f"native: {version}; {path.name} ready in "
          f"{time.perf_counter() - t0:.1f} s")


def phase_churn(rng, device, n_keys: int = CHURN_KEYS,
                lanes: int = CHURN_LANES, flushes: int = CHURN_FLUSHES):
    """Traffic whose keys churn past the key table (many client
    identities), as ms per flush of `lanes` lanes over n_keys keys:
    "held", every flush over the keys of A, which the table holds;
    "revisit", A and B in turns, two working sets sharing half their
    keys, so that every flush overflows the table and resets it to keys
    seen before; "fresh", every flush over n_keys keys never seen, each
    flush a reset too.  Each run starts from a fresh provider whose first
    flushes are not timed: over A, and for "revisit" over B as well, so
    that its timed resets meet only keys seen before.  Uses only
    `CUDACSP`'s public API."""
    keys = [hostref.key_gen(rng)
            for _ in range(n_keys * 3 // 2 + flushes * n_keys)]

    def batch(working, tag: bytes):
        out = []
        for i in range(lanes):
            key = working[i % n_keys]
            digest = hashlib.sha256(b"%s-%d" % (tag, i)).digest()
            out.append(VerifyBatchItem(
                key.public_key(), digest, hostref.sign(key, digest, rng)))
        return out

    a = batch(keys[:n_keys], b"churn-a")
    b = batch(keys[n_keys // 2:n_keys * 3 // 2], b"churn-b")
    fresh = [batch(keys[n_keys * (3 + 2 * f) // 2:][:n_keys],
                   b"churn-fresh-%d" % f) for f in range(flushes)]
    ms = {}
    for name, warm, seq in (("held", [a], [a] * flushes),
                            ("revisit", [a, b], [a, b] * (flushes // 2)),
                            ("fresh", [a], fresh)):
        csp = new_cuda_csp(device=device, min_device_batch=1)
        for items in warm:
            check(all(csp.verify_batch(items)),
                  f"key churn ({name}): untimed flush")
        t0 = time.perf_counter()
        for i, items in enumerate(seq):
            mask = csp.verify_batch(items)
            check(all(mask), f"key churn ({name}), flush {i}: "
                  f"{mask.count(False)} lanes rejected")
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(seq)
        csp.close()
    print(f"key churn: {lanes}-lane flushes over {n_keys} keys, ms per "
          f"flush: keys held {ms['held']:.1f}; every flush an overflow "
          f"reset to keys seen before {ms['revisit']:.1f}, to keys never "
          f"seen {ms['fresh']:.1f} ({(ms['fresh'] - ms['held']) / n_keys:.2f}"
          f" ms per new key over held)")
    return ms


# ---------------------------------------------------------------------------
# Block validation (the port's TxValidator over real Fabric blocks).
# ---------------------------------------------------------------------------

VALIDATOR_CHANNEL = "benchch"
VALIDATOR_CC = "benchcc"
VALIDATOR_TS = 1_760_000_000  # channel-header timestamps (seconds)
PLANT_BLOCK = 3  # the block (number) that carries the planted validator faults
MVCC_BLOCK = 4  # the block that carries the planted MVCC conflicts
DUP_BLOCK = 6  # the block that repeats a txid of MVCC_BLOCK
HIST_KEY = "hist"  # written by MVCC_BLOCK and DUP_BLOCK (its history: two)
SNAP_BLOCK = 6  # phase_commit's snapshot: the chain up to this block
SNAP_DUP_BLOCK = 8  # a block after the snapshot that repeats ...
SNAP_DUP_OF = 2  # ... a transaction of this block, from before it
SNAP_DUP_TX = 3  # (the transaction's position in both)
WAL_CHECKPOINT = "4000"  # FABRIC_TPU_WAL_CHECKPOINT of the headline (bench.py)


@dataclasses.dataclass
class ValidatorWorld:
    genesis: bytes
    client: SigningIdentity  # Org1's client
    peers: list  # one peer of each org, Org1 first
    rng: np.random.Generator

    @property
    def genesis_hash(self) -> bytes:
        return pu.block_header_hash(cb.Block.decode(self.genesis).header)


def validator_world(seed: int, n_orgs: int = N_ORGS) -> ValidatorWorld:
    """The 5-org channel of `scripts/bench_pipeline.py:19-47`, minted by the
    port's CA and configtx builder: an org per CA with NodeOUs, a solo
    orderer org, the default MAJORITY Endorsement policy."""
    rng = np.random.default_rng(seed)
    cas = [CA(f"ca.org{i + 1}msp.example.com", f"Org{i + 1}MSP", rng=rng)
           for i in range(n_orgs)]
    oca = CA("ca.orderermsp.example.com", "OrdererMSP", rng=rng)
    app = ctx.application_group({
        f"Org{i + 1}": ctx.org_group(f"Org{i + 1}MSP", msp_config_from_ca(
            ca, f"Org{i + 1}MSP")) for i, ca in enumerate(cas)})
    ordg = ctx.orderer_group({"O": ctx.org_group(
        "OrdererMSP", msp_config_from_ca(oca, "OrdererMSP"))})
    genesis = ctx.genesis_block(VALIDATOR_CHANNEL, ctx.channel_group(app, ordg),
                                nonce=rng.bytes(24), timestamp=VALIDATOR_TS)

    def signer(ca, mspid, name, ou):
        pair = ca.issue(name, ous=[ou])
        return SigningIdentity(mspid, pair.cert, pair.key, rng)

    client = signer(cas[0], "Org1MSP", "client", "client")
    peers = [signer(ca, f"Org{i + 1}MSP", "peer0", "peer")
             for i, ca in enumerate(cas)]
    return ValidatorWorld(genesis.encode(), client, peers, rng)


def tx_rwset(b: int, i: int, reads=(), ranges=(), writes=()) -> rw.KVRWSet:
    """The rwset of transaction i of block index b: a write of `benchcc`
    key k{b}-{i} = v{i}, after the planted `reads` [(key, (block, tx) or
    None)], `ranges` [(start, end, [(key, (block, tx))])] and extra
    `writes` [(key, value)]."""
    def version(v):
        return {} if v is None else {"version": rw.Version(
            block_num=v[0], tx_num=v[1])}

    return rw.KVRWSet(
        reads=[rw.KVRead(key=k, **version(v)) for k, v in reads],
        range_queries_info=[rw.RangeQueryInfo(
            start_key=lo, end_key=hi, itr_exhausted=True,
            raw_reads=rw.QueryReads(kv_reads=[
                rw.KVRead(key=k, **version(v)) for k, v in got]))
            for lo, hi, got in ranges],
        writes=[rw.KVWrite(key=f"k{b}-{i}", value=b"v%d" % i)]
        + [rw.KVWrite(key=k, value=v) for k, v in writes])


def signed_tx(world: ValidatorWorld, cc: str, args: list, results: bytes,
              timestamp: int, endorsers: int = ENDORSERS,
              bad_endorsements=()) -> bytes:
    """One transaction as `_make_blocks` builds it: Org1's client signs the
    proposal of chaincode `cc` and the envelope; `endorsers` peers (Org1
    first) sign responses carrying `results` (a marshaled
    TxReadWriteSet); the endorsements at `bad_endorsements` are signed
    over other bytes."""
    client = world.client
    prop, _ = pu.create_chaincode_proposal(
        client.serialize(), VALIDATOR_CHANNEL, cc, args,
        nonce=world.rng.bytes(24), timestamp=timestamp)
    resps = []
    for j, peer in enumerate(world.peers[:endorsers]):
        resp = pu.create_proposal_response(
            prop, results, b"", pb.Response(status=200),
            pb.ChaincodeID(name=cc), peer)
        if j in bad_endorsements:
            resp.endorsement = pb.Endorsement(
                endorser=resp.endorsement.endorser,
                signature=peer.sign(b"not the response"))
        resps.append(resp)
    return pu.create_signed_tx(prop, client, resps).encode()


def endorsed_tx(world: ValidatorWorld, b: int, i: int, endorsers: int,
                bad_endorsements=(), kv: rw.KVRWSet | None = None) -> bytes:
    """Transaction i of block index b: its rwset (`kv`, by default
    `tx_rwset(b, i)`) writes `benchcc` key k{b}-{i}."""
    kv = tx_rwset(b, i) if kv is None else kv
    results = rw.TxReadWriteSet(ns_rwset=[rw.NsReadWriteSet(
        namespace=VALIDATOR_CC, rwset=kv.encode())]).encode()
    return signed_tx(world, VALIDATOR_CC, [b"k%d-%d" % (b, i), b"v%d" % i],
                     results, VALIDATOR_TS + b, endorsers, bad_endorsements)


def seal_block(num: int, prev_hash: bytes, envs: list) -> bytes:
    """Block `num` of the envelopes, chained onto `prev_hash`."""
    blk = pu.new_block(num, prev_hash)
    blk.data = cb.BlockData(data=envs)
    blk.header.data_hash = pu.block_data_hash(blk.data)
    return blk.encode()


def plant_validator(world: ValidatorWorld, b: int, envs: list,
                    expect: dict) -> None:
    """Transactions 1-6 of block index b: the faults the validator flags."""
    env = cb.Envelope.decode(envs[1])
    envs[1] = cb.Envelope(  # the creator's signature, over other bytes
        payload=env.payload,
        signature=world.client.sign(b"not the payload")).encode()
    expect[b, 1] = pb.BAD_CREATOR_SIGNATURE
    # 4 endorsements, one bad: 3 of 5 orgs still sign (MAJORITY)
    envs[2] = endorsed_tx(world, b, 2, 4, bad_endorsements=(1,))
    expect[b, 2] = pb.VALID
    envs[3] = endorsed_tx(world, b, 3, ENDORSERS, bad_endorsements=(2,))
    expect[b, 3] = pb.ENDORSEMENT_POLICY_FAILURE
    envs[4] = endorsed_tx(world, b, 4, ENDORSERS, bad_endorsements=(0, 2))
    expect[b, 4] = pb.ENDORSEMENT_POLICY_FAILURE
    envs[5] = envs[0]  # a repeated txid
    expect[b, 5] = pb.DUPLICATE_TXID
    env = cb.Envelope.decode(envs[6])
    envs[6] = cb.Envelope(payload=env.payload[:len(env.payload) // 2],
                          signature=env.signature).encode()
    expect[b, 6] = pb.BAD_PAYLOAD


def plant_mvcc(world: ValidatorWorld, b: int, envs: list,
               conflicts: dict) -> None:
    """Transactions 1-5 of block index b, over the keys block index 0
    committed: a read at the committed version with a range read that
    matches (VALID; it also writes HIST_KEY), a read at a stale version, a
    write of a fresh key and a read of it at its committed (absent)
    version after it, and a range read that misses a committed key."""
    fresh = f"fresh{b}"
    plants = {
        1: (tx_rwset(b, 1, reads=[("k0-7", (1, 7))],
                     ranges=[("k0-6", "k0-60", [("k0-6", (1, 6))])],
                     writes=[(HIST_KEY, b"h%d" % b)]), pb.VALID),
        2: (tx_rwset(b, 2, reads=[("k0-8", (1, 9))]), pb.MVCC_READ_CONFLICT),
        3: (tx_rwset(b, 3, writes=[(fresh, b"f")]), pb.VALID),
        4: (tx_rwset(b, 4, reads=[(fresh, None)]), pb.MVCC_READ_CONFLICT),
        5: (tx_rwset(b, 5, ranges=[("k0-5", "k0-50", [])]),
            pb.PHANTOM_READ_CONFLICT),
    }
    for i, (kv, flag) in plants.items():
        envs[i] = endorsed_tx(world, b, i, ENDORSERS, kv=kv)
        if flag != pb.VALID:
            conflicts[b, i] = flag


def validator_blocks(world: ValidatorWorld, n_blocks: int, n_txs: int,
                     prev_hash: bytes, plant: bool = True,
                     mvcc: bool = False):
    """`n_blocks` distinct blocks of `n_txs` transactions (3 endorsements
    each), numbered from 1 and chained onto `prev_hash`.  With `plant`,
    block PLANT_BLOCK (or the last) carries the validator's faults; with
    `mvcc` (and at least DUP_BLOCK blocks), block MVCC_BLOCK carries MVCC
    conflicts, and transaction 1 of block DUP_BLOCK repeats transaction 1
    of block MVCC_BLOCK and writes HIST_KEY again; with `mvcc` and at
    least SNAP_DUP_BLOCK blocks, transaction SNAP_DUP_TX of block
    SNAP_DUP_BLOCK repeats that of block SNAP_DUP_OF, from before
    phase_commit's snapshot (a validator with no ledger, whose window has
    let block SNAP_DUP_OF go, passes it; the ledger's txid index flags
    it).  Returns (block bytes, {(block index, tx): validator flag},
    {(block index, tx): commit flag}): the validator's flags at depth
    >= 3 and the flags that only the commit sets."""
    plant_at = min(PLANT_BLOCK, n_blocks) - 1 if plant else -1
    snap_dup = mvcc and n_blocks >= SNAP_DUP_BLOCK
    mvcc = mvcc and n_blocks >= DUP_BLOCK
    blocks, expect, conflicts, all_envs = [], {}, {}, []
    for b in range(n_blocks):
        envs = [endorsed_tx(world, b, i, ENDORSERS) for i in range(n_txs)]
        all_envs.append(envs)
        if b == plant_at:
            plant_validator(world, b, envs, expect)
        if mvcc and b == MVCC_BLOCK - 1:
            plant_mvcc(world, b, envs, conflicts)
            mvcc_envs = envs
        if mvcc and b == DUP_BLOCK - 1:
            envs[1] = mvcc_envs[1]
            expect[b, 1] = pb.DUPLICATE_TXID
            envs[2] = endorsed_tx(world, b, 2, ENDORSERS, kv=tx_rwset(
                b, 2, writes=[(HIST_KEY, b"h%d" % b)]))
        if snap_dup and b == SNAP_DUP_BLOCK - 1:
            envs[SNAP_DUP_TX] = all_envs[SNAP_DUP_OF - 1][SNAP_DUP_TX]
            conflicts[b, SNAP_DUP_TX] = pb.DUPLICATE_TXID
        blocks.append(seal_block(1 + b, prev_hash, envs))
        prev_hash = pu.block_header_hash(cb.Block.decode(blocks[-1]).header)
    return blocks, expect, conflicts


class EmptyLedger:
    """A ledger with no committed transaction and no state (the JAX
    tests' stand-in): what the validator asks of a ledger."""

    def tx_id_exists(self, txid: str) -> bool:
        return False

    def tx_ids_exist(self, txids) -> set:
        return set()

    def get_state_metadata(self, ns: str, key: str) -> dict:
        return {}

    def may_have_state_metadata(self, ns: str) -> bool:
        return False


class RecordingCSP:
    """A CSP that passes verify batches to `inner` and keeps each batch's
    items and mask (to hold the mask against hostref afterwards), and the
    seconds spent inside `inner.verify_batch_async`: the CSP's flush and
    host dispatch, which the validator's collect stage includes."""

    def __init__(self, inner):
        self.inner = inner
        self.batches: list = []
        self.dispatch_s = 0.0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def verify_batch_async(self, items):
        t0 = time.perf_counter()
        collect = self.inner.verify_batch_async(items)
        self.dispatch_s += time.perf_counter() - t0
        rec = [list(items), None]
        self.batches.append(rec)

        def collector():
            rec[1] = collect()
            return rec[1]

        return collector

    def verify_batch(self, items):
        return self.verify_batch_async(items)()

    def reset(self) -> None:
        self.batches.clear()
        self.dispatch_s = 0.0


def check_mask(csp: RecordingCSP, label: str) -> int:
    """Holds every recorded verify mask against hostref's (in 8 worker
    processes); returns the lane count."""
    t1 = time.perf_counter()
    items = [it for b, _ in csp.batches for it in b]
    mask = [ok for _, m in csp.batches for ok in m]
    workers = min(8, os.cpu_count() or 1)
    step = -(-len(items) // workers)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        want = [ok for part in ex.map(
            hostref.verify_batch,
            [items[i:i + step] for i in range(0, len(items), step)])
            for ok in part]
    check(mask == want, f"the {label}'s verify mask differs from "
          f"hostref's on {sum(a != b for a, b in zip(mask, want))} lanes")
    print(f"{label}: verify mask of {len(items)} lanes equal to hostref's "
          f"({time.perf_counter() - t1:.1f} s on the host, {workers} "
          f"processes)")
    return len(items)


def stage_line(st: dict, dispatch_s: float, n_blocks: int) -> str:
    """The validator's stages per block, the CSP dispatch share apart."""
    return (f"per block collect {st['collect'] / n_blocks * 1e3:.1f} ms (CSP "
            f"flush and host dispatch {dispatch_s / n_blocks * 1e3:.1f} ms of "
            f"it, the walk and Python collect "
            f"{(st['collect'] - dispatch_s) / n_blocks * 1e3:.1f} ms), "
            f"verify_wait {st['verify_wait'] / n_blocks * 1e3:.1f} ms, "
            f"policy {st['policy'] / n_blocks * 1e3:.1f} ms")


def phase_validator(device, world: ValidatorWorld, blocks: list, expect: dict,
                    depth: int = DEPTH) -> dict:
    """Validate real 1000-tx blocks through the port's TxValidator into
    CUDACSP (B1), counted; every flag is held against the planted ones and
    the verify mask against hostref."""
    n_blocks = len(blocks)
    bundle = bundle_from_genesis(world.genesis)
    native.load()
    print(f"validator: collect.cc SHA-256 = {native.sha256_impl()}")
    csp = RecordingCSP(new_cuda_csp(device=device))
    validator = TxValidator(VALIDATOR_CHANNEL, EmptyLedger(), bundle, csp)
    # warm-up on a block not timed: key table, quarter tables, MSP caches
    validator.validate(validator_blocks(world, 1, 64, world.genesis_hash,
                                        plant=False)[0][0])
    csp.reset()
    validator.validate_stage_seconds.clear()
    csp.inner.drain()
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = list(validator.validate_pipeline(blocks, depth=depth))
    csp.inner.drain()
    wall = time.perf_counter() - t0
    launches = {"p256_verify_keytab": pk.launches_keytab,
                "p256_verify_lanekeys": pk.launches_lanekeys}
    check(launches["p256_verify_keytab"] > 0,
          f"B1 did not launch on the validator path: {launches}")
    n_txs = len(flags[0])
    for b, got in enumerate(flags):
        check(len(got) == n_txs, f"block {b}: {len(got)} flags")
        for i, f in enumerate(got):
            want = expect.get((b, i), pb.VALID)
            check(f == want, f"block {b} tx {i}: flag {f}, expected {want}")
    lanes = check_mask(csp, "validator")
    st = validator.validate_stage_seconds
    n_tx = n_blocks * n_txs
    print(f"validator: {n_blocks} blocks x {n_txs} transactions through "
          f"validate_pipeline(depth={depth}) in {wall * 1e3:.1f} ms = "
          f"{n_tx / wall:.0f} validated tx/s, {wall / n_blocks * 1e3:.1f} ms "
          f"a block; {stage_line(st, csp.dispatch_s, n_blocks)}; {lanes} "
          f"verify lanes; launches {launches}; planted flags "
          f"{sorted(set(expect.values()))} as expected, every other "
          f"transaction VALID")
    return {"launches": launches, "wall_s": wall, "lanes": lanes,
            "stages": dict(st), "dispatch_s": csp.dispatch_s}


# ---------------------------------------------------------------------------
# The commit path (Committer.store_stream into an on-disk KVLedger).
# ---------------------------------------------------------------------------

COMMIT_STAGES = ("mvcc", "mvcc_preload", "mvcc_check", "mvcc_prepare",
                 "block_append", "pvt", "state", "history", "fsync", "kv_txn")


def fs_type(path: str) -> str:
    """The file system type of the mount that holds `path`
    (/proc/mounts)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return f"{kind} ({best})"


def phase_commit(device, world: ValidatorWorld, blocks: list, expect: dict,
                 conflicts: dict, depth: int = DEPTH,
                 root_dir: str | None = None, mask_check: bool = True,
                 on_start=None) -> dict:
    """Validate and commit the blocks through the port's
    `Committer.store_stream` into an on-disk KVLedger (B1 on the card
    through CUDACSP; MVCC at the default width), counted; then hold the
    flags, the state, the block readers, the history and a reopen.  With
    at least SNAP_BLOCK blocks, a snapshot requested before the run is
    generated as block SNAP_BLOCK commits.  The ledger lives under
    `root_dir`, kept for phase_snapshot, else under a temporary directory
    removed at the end.  `mask_check` False skips the hostref mask check
    (a pass whose flags are held against a checked one); `on_start` runs
    just before the timed run (a traced pass clears its recorder)."""
    import sqlite3

    from fabric_tpu_torch.ledger import snapshot as snap
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.committer import Committer

    os.environ["FABRIC_TPU_WAL_CHECKPOINT"] = WAL_CHECKPOINT
    n_blocks = len(blocks)
    n_txs = len(cb.Block.decode(blocks[0]).data.data)
    bundle = bundle_from_genesis(world.genesis)
    genesis = cb.Block.decode(world.genesis)
    csp = RecordingCSP(new_cuda_csp(device=device))
    place = (contextlib.nullcontext(root_dir) if root_dir is not None
             else tempfile.TemporaryDirectory(prefix="chip_smoke_ledger_"))
    with place as tmp:
        # warm-up in a ledger of its own, not timed: the key table and
        # quarter tables, the MSP caches, the first segment's allocation
        warm_provider = LedgerProvider(os.path.join(tmp, "warm"))
        warm = warm_provider.create(cb.Block.decode(world.genesis))
        warm_block = validator_blocks(world, 1, 64, world.genesis_hash,
                                      plant=False)[0][0]
        Committer(TxValidator(VALIDATOR_CHANNEL, warm, bundle, csp),
                  warm).store_block(warm_block)
        warm_provider.close()
        root = os.path.join(tmp, "ledger")
        provider = LedgerProvider(root, csp=csp)
        ledger = provider.create(genesis)
        check(ledger.height == 1, f"height after genesis {ledger.height}")
        validator = TxValidator(VALIDATOR_CHANNEL, ledger, bundle, csp)
        committer = Committer(validator, ledger)
        flushes = [0]
        flush = ledger.commit_group_flush

        def counted_flush(group):
            flushes[0] += bool(group.blocks)
            flush(group)

        ledger.commit_group_flush = counted_flush
        groups = []  # the committer's groups, for their MVCC validators
        begin = ledger.begin_commit_group

        def kept_begin():
            groups.append(begin())
            return groups[-1]

        ledger.begin_commit_group = kept_begin
        # the snapshot, requested before the run and generated in it, on
        # the manager's thread, as block SNAP_BLOCK commits (timed here)
        snapshot = n_blocks >= SNAP_BLOCK
        export: dict = {}
        generate = snap.generate_snapshot

        def timed_generate(*args, **kwargs):
            b4_before = sha.launches_sha256
            t = time.perf_counter()
            out = generate(*args, **kwargs)
            export.update(s=time.perf_counter() - t,
                          b4=sha.launches_sha256 - b4_before)
            return out

        if snapshot:
            snap.generate_snapshot = timed_generate
            got = ledger.snapshots.submit_request(SNAP_BLOCK)
            check(got["snapshot_dir"] is None and ledger.snapshots
                  .list_pending() == [SNAP_BLOCK], f"the request: {got}")
        # the timeline: when each block's flags are finished (validated)
        # and when it is durable (its group flushed, the listener called)
        validated, durable = [], []
        finish_block = validator._finish_block

        def timed_finish(*args):
            flags = finish_block(*args)
            validated.append(time.perf_counter())
            return flags

        validator._finish_block = timed_finish
        committer.add_commit_listener(
            lambda block, flags: durable.append(time.perf_counter()))
        csp.reset()
        csp.inner.drain()
        if on_start is not None:
            on_start()
        pk.launches_keytab = 0
        pk.launches_lanekeys = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            flags = list(committer.store_stream(blocks, depth=depth))
            csp.inner.drain()
            wall = time.perf_counter() - t0
            check(ledger.snapshots.wait_idle(60.0), "the snapshot export "
                  "did not finish")
        finally:
            snap.generate_snapshot = generate
        launches = {"p256_verify_keytab": pk.launches_keytab,
                    "p256_verify_lanekeys": pk.launches_lanekeys}
        check(launches["p256_verify_keytab"] > 0,
              f"B1 did not launch on the commit path: {launches}")
        snapshot_dir = None
        if snapshot:
            check(snap.list_completed(provider.snapshots_root,
                                      VALIDATOR_CHANNEL) == [SNAP_BLOCK]
                  and not ledger.snapshots.list_pending() and export,
                  "no snapshot at block %d" % SNAP_BLOCK)
            snapshot_dir = snap.completed_snapshot_dir(
                provider.snapshots_root, VALIDATOR_CHANNEL, SNAP_BLOCK)
        fanout = groups[0].mvcc.fanout
        parallel = sum(g.mvcc.parallel_prepare_blocks for g in groups)

        # flags, height, state
        want_all = {**expect, **conflicts}
        for b, got in enumerate(flags):
            check(len(got) == n_txs, f"block {b}: {len(got)} flags")
            for i, f in enumerate(got):
                want = want_all.get((b, i), pb.VALID)
                check(f == want, f"committed block {b + 1} tx {i}: flag {f}, "
                      f"expected {want}")
        check(ledger.height == n_blocks + 1 and committer.height
              == n_blocks + 1, f"height {ledger.height}, durable "
              f"{committer.height}, expected {n_blocks + 1}")
        state = ledger.state_db
        for b, got in enumerate(flags):
            for i, f in enumerate(got):
                if f == pb.DUPLICATE_TXID:
                    continue  # its key is the first copy's
                vv = state.get_state(VALIDATOR_CC, f"k{b}-{i}")
                if f == pb.VALID:
                    check(vv is not None and vv.value == b"v%d" % i
                          and (vv.version.block_num, vv.version.tx_num)
                          == (b + 1, i), f"k{b}-{i} reads back {vv}")
                else:
                    check(vv is None, f"k{b}-{i} of an invalid transaction "
                          f"reads back {vv}")
        # the block readers
        committed = [world.genesis] + blocks
        for n, raw in enumerate(committed):
            got = ledger.get_block_by_number(n)
            sent = cb.Block.decode(raw)
            check(got is not None and got.header == sent.header
                  and list(got.data.data) == list(sent.data.data),
                  f"block {n} reads back other than committed")
            want_filter = bytes(flags[n - 1]) if n else b"\x00"
            check(got.metadata.metadata[cb.TRANSACTIONS_FILTER]
                  == want_filter, f"block {n}: TRANSACTIONS_FILTER "
                  f"{got.metadata.metadata[cb.TRANSACTIONS_FILTER][:16]!r}")
            check(ledger.get_block_by_hash(pu.block_header_hash(got.header))
                  .header == got.header, f"block {n} by hash")
        hist = ledger.get_history_for_key(VALIDATOR_CC, HIST_KEY)
        want_hist = [(MVCC_BLOCK, 1), (DUP_BLOCK, 2)]
        check(hist == want_hist, f"history of {HIST_KEY}: {hist}, expected "
              f"{want_hist}")
        lanes = (check_mask(csp, "commit") if mask_check
                 else sum(len(b) for b, _ in csp.batches))

        # reopen: a fresh provider on the same directory
        before = (ledger.height, ledger.durable_block_hash,
                  list(provider.kv.iterate()))
        sync_level = provider.kv.sync_level
        wal_pages = provider.kv.wal_autocheckpoint
        provider.close()
        with sqlite3.connect(os.path.join(root, "index.sqlite")) as conn:
            journal = conn.execute("PRAGMA journal_mode").fetchone()[0]
        conn.close()
        again = LedgerProvider(root)
        reopened = again.open(VALIDATOR_CHANNEL)
        after = (reopened.height, reopened.durable_block_hash,
                 list(again.kv.iterate()))
        check(after == before, "the reopened ledger differs: height "
              f"{after[0]} / {before[0]}, {len(after[2])} / {len(before[2])} "
              "KV pairs")
        again.close()
        fs = fs_type(root)
    stages = dict(ledger.commit_stage_seconds)
    vst = validator.validate_stage_seconds
    n_tx = n_blocks * n_txs
    print(f"commit: {n_blocks} blocks x {n_txs} transactions through "
          f"Committer.store_stream(depth={depth}) in {wall * 1e3:.1f} ms = "
          f"{n_tx / wall:.0f} committed tx/s, {wall / n_blocks * 1e3:.1f} ms "
          f"a block; {flushes[0]} group flushes; {lanes} verify lanes; "
          f"launches {launches}")
    print(f"commit: validator {stage_line(vst, csp.dispatch_s, n_blocks)}")
    print("commit: timeline from the start, ms: validated "
          + ", ".join(f"{(v - t0) * 1e3:.1f}" for v in validated)
          + "; durable " + ", ".join(f"{(d - t0) * 1e3:.1f}" for d in durable)
          + "; the last block durable "
          f"{(durable[-1] - validated[-1]) * 1e3:.1f} ms after it was "
          "validated")
    busy = sum(stages.get(k, 0.0) for k in COMMIT_STAGES
               if not k.startswith("mvcc_"))
    print("commit: commit_stage_seconds per block (committer thread): "
          + ", ".join(f"{k} {stages.get(k, 0.0) / n_blocks * 1e3:.2f} ms"
                      for k in COMMIT_STAGES)
          + f"; the committer thread inside commits and flushes "
          f"{busy * 1e3:.1f} ms, {busy / wall:.1%} of the wall")
    print(f"commit: sqlite {sqlite3.sqlite_version}, journal_mode={journal}, "
          f"synchronous={sync_level}, wal_autocheckpoint={wal_pages}; ledger "
          f"directory on {fs}")
    print(f"commit: MVCC width {fanout} (the default: "
          f"FABRIC_TPU_MVCC_POOL unset, {os.cpu_count()} CPUs), "
          f"parallel_prepare_blocks {parallel} (one namespace a block: its "
          f"prepare has one group)")
    if snapshot:
        print(f"commit: snapshot of block {SNAP_BLOCK} generated as it "
              f"committed, on the manager's thread: export "
              f"{export['s'] * 1e3:.1f} ms, {export['b4']} launches of "
              f"{B4_NAME}")
    print(f"commit: every planted flag as expected "
          f"({sorted(set(want_all.values()))}), every other transaction "
          f"VALID; height {n_blocks + 1}; state, block readers, history of "
          f"{HIST_KEY!r} and the reopen held")
    return {"launches": launches, "wall_s": wall, "stages": stages,
            "flushes": flushes[0], "lanes": lanes, "flags": flags,
            "root": root, "snapshot_dir": snapshot_dir,
            "export_s": export.get("s"), "export_b4": export.get("b4"),
            "fanout": fanout, "parallel_prepare_blocks": parallel}


# ---------------------------------------------------------------------------
# SmallBank: hot-key contention through the simulator and the commit path.
# ---------------------------------------------------------------------------

SB_ACCOUNTS = 1000  # bench.py:285-287, the JAX package's scenario
SB_HOT = 10  # hot accounts ...
SB_HOT_PROB = 0.25  # ... that draw a quarter of the endpoints
SB_TXS = 400  # payments a block
SB_BLOCKS = 6
SB_SEED = 11  # random.Random of the payments
SB_BALANCE = 1000  # every account's seeded checking and savings
SB_CC = "checking"  # the chaincode (namespace) that bench.py's payments name


def smallbank_blocks(world: ValidatorWorld, prev_hash: bytes,
                     n_accounts: int = SB_ACCOUNTS, n_hot: int = SB_HOT,
                     hot_prob: float = SB_HOT_PROB, n_txs: int = SB_TXS,
                     n_blocks: int = SB_BLOCKS, seed: int = SB_SEED):
    """The JAX package's SmallBank scenario (`bench.py:264-343`) with real
    signatures: block 1 seeds every account's `checking` and `savings`
    namespace key in one transaction; each of `n_blocks` blocks holds
    `n_txs` payments, each reading both `checking` balances and the
    source's `savings` and writing both `checking` balances, a quarter of
    the endpoints drawn from `n_hot` hot accounts by `random.Random(seed)`
    in bench.py's order.  Each block is simulated with the port's
    TxSimulator against an in-memory build ledger one block behind (the
    endorse-order-commit staleness), then committed there.  Returns (seed
    block, payment blocks, [[(src, dst)] per block], the build ledger's
    flags per block), the blocks as bytes, chained onto `prev_hash`."""
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider

    rng = random.Random(seed)
    accounts = [f"acct{a:04d}" for a in range(n_accounts)]
    provider = LedgerProvider(None)
    ledger = provider.create(cb.Block.decode(world.genesis))
    sim = ledger.new_tx_simulator()
    for a in accounts:
        sim.set_state("checking", a, b"%d" % SB_BALANCE)
        sim.set_state("savings", a, b"%d" % SB_BALANCE)
    seed_blk = seal_block(1, prev_hash, [signed_tx(
        world, SB_CC, [b"seed"], sim.get_tx_simulation_results(),
        VALIDATOR_TS)])
    ledger.commit(cb.Block.decode(seed_blk))

    def pick() -> str:
        if rng.random() < hot_prob:
            return accounts[rng.randrange(n_hot)]
        return accounts[rng.randrange(n_accounts)]

    blocks, payments, build_flags = [], [], []
    prev = pu.block_header_hash(cb.Block.decode(seed_blk).header)
    for bno in range(n_blocks):
        envs, pays = [], []
        for i in range(n_txs):
            src = pick()
            dst = pick()
            while dst == src:
                dst = accounts[rng.randrange(n_accounts)]
            s = ledger.new_tx_simulator()
            a = int(s.get_state("checking", src) or b"0")
            b = int(s.get_state("checking", dst) or b"0")
            s.get_state("savings", src)  # the overdraft check
            s.set_state("checking", src, b"%d" % (a - 1))
            s.set_state("checking", dst, b"%d" % (b + 1))
            envs.append(signed_tx(
                world, SB_CC, [b"pay", src.encode(), dst.encode()],
                s.get_tx_simulation_results(), VALIDATOR_TS + 2 + bno))
            pays.append((src, dst))
        blocks.append(seal_block(2 + bno, prev, envs))
        blk = cb.Block.decode(blocks[-1])
        prev = pu.block_header_hash(blk.header)
        payments.append(pays)
        ledger.commit(blk)
        build_flags.append(list(pu.tx_filter(blk)))
    provider.close()
    return seed_blk, blocks, payments, build_flags


def smallbank_replay(payments: list, flags: list,
                     n_accounts: int = SB_ACCOUNTS) -> dict:
    """Each account's `checking` balance after the VALID payments, in
    commit order: the plain replay the ledger is held against."""
    bal = {f"acct{a:04d}": SB_BALANCE for a in range(n_accounts)}
    for pays, got in zip(payments, flags):
        for (src, dst), f in zip(pays, got):
            if f == pb.VALID:
                bal[src] -= 1
                bal[dst] += 1
    return bal


def phase_smallbank(device, world: ValidatorWorld, tmp: str,
                    depth: int = DEPTH, **sizes) -> dict:
    """The SmallBank stream through `Committer.store_stream(depth)` into an
    on-disk KVLedger with CUDACSP (B1), twice, counted from the first
    pass, each followed by a streamed pass at FABRIC_TPU_MVCC_POOL=0 (the
    width's A/B); then once serially (width 0, store_block a block), and
    once streamed at FABRIC_TPU_STORE_SHARDS = STORE_SHARDS.  Holds the
    flags of the six passes and the build ledger's equal, the sharded
    pass's KV pairs equal to the first pass's, its seed block's flush
    spread over two shards or more, the first pass's verify mask against hostref, and
    every account's balances against the replay of the committed
    payments."""
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.committer import Committer

    os.environ["FABRIC_TPU_WAL_CHECKPOINT"] = WAL_CHECKPOINT
    t0 = time.perf_counter()
    seed_blk, blocks, payments, build_flags = smallbank_blocks(
        world, world.genesis_hash, **sizes)
    n_accounts = sizes.get("n_accounts", SB_ACCOUNTS)
    print(f"smallbank setup: {len(blocks)} blocks of {len(payments[0])} "
          f"payments over {n_accounts} accounts simulated and signed in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(map(len, blocks)) / 1e6:.2f} MB)")
    bundle = bundle_from_genesis(world.genesis)
    genesis = cb.Block.decode(world.genesis)
    csp = RecordingCSP(new_cuda_csp(device=device))
    want_bal = smallbank_replay(payments, build_flags, n_accounts)

    def run(name: str, serial: bool) -> dict:
        provider = LedgerProvider(os.path.join(tmp, name), csp=csp)
        ledger = provider.create(genesis)
        groups = []
        begin = ledger.begin_commit_group

        def kept_begin():
            groups.append(begin())
            return groups[-1]

        ledger.begin_commit_group = kept_begin
        committer = Committer(TxValidator(VALIDATOR_CHANNEL, ledger, bundle,
                                          csp), ledger)
        check(committer.store_block(seed_blk) == [pb.VALID],
              "the seed block is not VALID")
        seed_stages = dict(ledger.commit_stage_seconds)
        groups.clear()
        ledger.commit_stage_seconds.clear()
        csp.reset()
        csp.inner.drain()
        workpool.reset_stats()
        pk.launches_keytab = 0
        pk.launches_lanekeys = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if serial:
            flags = [committer.store_block(b) for b in blocks]
        else:
            flags = list(committer.store_stream(blocks, depth=depth))
        csp.inner.drain()
        wall = time.perf_counter() - t1
        out = {
            "flags": flags, "wall_s": wall,
            "launches": {"p256_verify_keytab": pk.launches_keytab,
                         "p256_verify_lanekeys": pk.launches_lanekeys},
            "stages": dict(ledger.commit_stage_seconds),
            "seed_stages": seed_stages,
            "pool": workpool.stats(),
            "fanout": groups[0].mvcc.fanout,
            "parallel": sum(g.mvcc.parallel_prepare_blocks for g in groups),
        }
        got_bal = dict(zip(sorted(want_bal), (
            int(v) for v in ledger.get_state_multiple(
                "checking", sorted(want_bal)))))
        savings = set(ledger.get_state_multiple("savings", sorted(want_bal)))
        check(got_bal == smallbank_replay(payments, flags, n_accounts)
              == want_bal and savings == {b"%d" % SB_BALANCE},
              f"smallbank {name}: balances differ from the replay")
        check(ledger.height == len(blocks) + 2, f"smallbank {name}: height "
              f"{ledger.height}")
        provider.close()
        return out

    def at_width0(name: str, serial: bool = False) -> dict:
        knob = os.environ.get("FABRIC_TPU_MVCC_POOL")
        os.environ["FABRIC_TPU_MVCC_POOL"] = "0"
        try:
            return run(name, serial)
        finally:
            if knob is None:
                os.environ.pop("FABRIC_TPU_MVCC_POOL")
            else:
                os.environ["FABRIC_TPU_MVCC_POOL"] = knob

    # the default width and width 0 in turns: the width's A/B
    first = run("pass1", serial=False)
    lanes = check_mask(csp, "smallbank")
    zero1 = at_width0("width0_1")
    second = run("pass2", serial=False)
    zero2 = at_width0("width0_2")
    serial = at_width0("serial", serial=True)
    check(first["flags"] == second["flags"] == zero1["flags"]
          == zero2["flags"], "smallbank flags differ between the streamed "
          "passes")
    check(first["flags"] == serial["flags"] == build_flags, "smallbank "
          "flags differ from the serial pass or the build ledger's")
    # once more at STORE_SHARDS, held against the single-file first pass:
    # the seed block writes both namespaces, which route to different
    # shards, so its flush fans out over FABRIC_TPU_STORE_POOL; the
    # payments write `checking` alone, one shard
    os.environ["FABRIC_TPU_STORE_SHARDS"] = str(STORE_SHARDS)
    try:
        sharded = run("sharded", serial=False)
    finally:
        del os.environ["FABRIC_TPU_STORE_SHARDS"]
    pairs = store_pairs(os.path.join(tmp, "sharded"))
    check(sharded["flags"] == first["flags"], "smallbank flags differ "
          f"between {STORE_SHARDS} shards and the single file")
    check(pairs == store_pairs(os.path.join(tmp, "pass1")), f"smallbank: "
          f"the sharded store's {len(pairs)} KV pairs differ from the single "
          "file's")
    touched = sorted(k for k in sharded["seed_stages"]
                     if k.startswith("kv_shard"))
    pool_width = min(workpool.stage_width("FABRIC_TPU_STORE_POOL"),
                     len(touched))
    check(len(touched) >= 2 and pool_width >= 2, f"smallbank: the sharded "
          f"seed block's flush touched {touched} at pool width {pool_width}")
    check(sharded["launches"]["p256_verify_keytab"] > 0,
          f"B1 did not launch on the sharded smallbank path: "
          f"{sharded['launches']}")
    check(first["launches"]["p256_verify_keytab"] > 0,
          f"B1 did not launch on the smallbank path: {first['launches']}")
    check(first["parallel"] > 0 and second["parallel"] > 0
          and serial["parallel"] == zero1["parallel"] == zero2["parallel"]
          == 0, "the MVCC prepare did not fan out at the default width, or "
          "did at width 0")
    flat = [f for got in first["flags"] for f in got]
    committed = flat.count(pb.VALID)
    by_code = dict(sorted(collections.Counter(
        f for f in flat if f != pb.VALID).items()))
    best = min(first, second, key=lambda r: r["wall_s"])
    n_blocks = len(blocks)
    for label, r in (("pass 1", first), ("width 0, 1", zero1),
                     ("pass 2", second), ("width 0, 2", zero2),
                     ("serial", serial), (f"{STORE_SHARDS} shards", sharded)):
        st = r["stages"]
        print(f"smallbank {label}: {len(flat)} payments in "
              f"{r['wall_s'] * 1e3:.1f} ms = "
              f"{committed / r['wall_s']:.0f} committed tx/s "
              f"({len(flat) / r['wall_s']:.0f} attempted); MVCC width "
              f"{r['fanout']}, parallel_prepare_blocks {r['parallel']}, "
              f"workpool {r['pool']}; launches {r['launches']}; "
              "commit_stage_seconds per block: "
              + ", ".join(f"{k} {st.get(k, 0.0) / n_blocks * 1e3:.2f} ms"
                          for k in COMMIT_STAGES))
    mvcc_ms = [r["stages"].get("mvcc", 0.0) / n_blocks * 1e3
               for r in (first, second, zero1, zero2)]
    print(f"smallbank: MVCC width {first['fanout']} against 0, in turns: "
          f"walls {first['wall_s'] * 1e3:.1f}, {second['wall_s'] * 1e3:.1f} "
          f"against {zero1['wall_s'] * 1e3:.1f}, {zero2['wall_s'] * 1e3:.1f} "
          f"ms; mvcc a block {mvcc_ms[0]:.2f}, {mvcc_ms[1]:.2f} against "
          f"{mvcc_ms[2]:.2f}, {mvcc_ms[3]:.2f} ms")
    print(f"smallbank {STORE_SHARDS} shards: flags and {len(pairs)} KV "
          f"pairs equal to the single-file pass 1; the seed block's flush "
          f"touched {', '.join(touched)} at store pool width {pool_width} "
          f"(kv ms: {kv_line(sharded['seed_stages'], 1)}); the stream's kv "
          f"stages per block, ms: {kv_line(sharded['stages'], n_blocks)} "
          f"(pass 1: {kv_line(first['stages'], n_blocks)})")
    print(f"smallbank: {committed} committed, {len(flat) - committed} "
          f"conflicted of {len(flat)} (invalid_by_code {by_code}); flags "
          f"equal in the streamed passes (widths {first['fanout']} and 0), "
          f"the serial pass (store_block a block) and the build ledger; "
          f"{lanes} verify lanes equal to hostref's; every account's "
          f"balances equal the replay of the committed payments; best "
          f"{committed / best['wall_s']:.0f} committed tx/s")
    return {"launches": first["launches"], "wall_s": first["wall_s"],
            "launches_sharded": sharded["launches"],
            "best_s": best["wall_s"], "committed": committed,
            "conflicted": len(flat) - committed, "by_code": by_code}


# ---------------------------------------------------------------------------
# Snapshots: verify, refuse a tampered copy, bootstrap, stream on.
# ---------------------------------------------------------------------------


def block_txids(raw: bytes) -> list:
    """The txids of a block's envelopes that parse (a planted truncated
    payload does not)."""
    from fabric_tpu_torch.protos.wire import DecodeError

    out = []
    for env in cb.Block.decode(raw).data.data:
        try:
            out.append(cb.ChannelHeader.decode(cb.Payload.decode(
                cb.Envelope.decode(env).payload).header.channel_header).tx_id)
        except DecodeError:
            continue
    return out


def phase_snapshot(device, world: ValidatorWorld, blocks: list, com: dict,
                   tmp: str, depth: int = DEPTH) -> dict:
    """phase_commit's snapshot (the chain to SNAP_BLOCK): verified through
    `CUDACSP.hash_batch`, a copy with one byte flipped refused, a new
    ledger created from it, and the blocks after it streamed into that
    ledger through the Committer with CUDACSP (B1), counted.  The new
    ledger must equal phase_commit's from SNAP_BLOCK + 1 on: flags, state,
    the txid index, the blocks and the history, a txid from before the
    snapshot flagged DUPLICATE_TXID in both."""
    from fabric_tpu_torch.ledger import snapshot as snap
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.committer import Committer

    snap_dir = com["snapshot_dir"]
    names = sorted(os.listdir(snap_dir))
    nbytes = sum(os.path.getsize(os.path.join(snap_dir, n)) for n in names)
    blobs = []
    for n in snap.DATA_FILES:
        with open(os.path.join(snap_dir, n), "rb") as f:
            blobs.append(f.read())
    route = "card" if hash_on_card(blobs) else "hashlib"
    csp = RecordingCSP(new_cuda_csp(device=device))
    sha.launches_sha256 = 0
    t0 = time.perf_counter()
    meta = snap.verify_snapshot(snap_dir, csp=csp)
    verify_s = time.perf_counter() - t0
    check(meta["last_block_number"] == SNAP_BLOCK, f"snapshot metadata {meta}")
    tampered = os.path.join(tmp, "tampered")
    shutil.copytree(snap_dir, tampered)
    path = os.path.join(tampered, snap.PUBLIC_STATE_FILE)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 1]))
    try:
        snap.verify_snapshot(tampered, csp=csp)
        refused = False
    except snap.SnapshotError as e:
        refused = snap.PUBLIC_STATE_FILE in str(e)
    check(refused, "a snapshot with one byte flipped was not refused")

    provider = LedgerProvider(os.path.join(tmp, "bootstrapped"), csp=csp)
    t0 = time.perf_counter()
    ledger = provider.create_from_snapshot(snap_dir)
    import_s = time.perf_counter() - t0
    b4 = sha.launches_sha256
    check(b4 == 0 and com["export_b4"] == 0, f"{B4_NAME} launched at the "
          f"snapshot's shape: export {com['export_b4']}, verify and import "
          f"{b4}")
    check(ledger.height == SNAP_BLOCK + 1 and ledger.block_store
          .bootstrap_height == SNAP_BLOCK + 1, f"bootstrapped height "
          f"{ledger.height}")
    bundle = bundle_from_genesis(world.genesis)
    committer = Committer(TxValidator(VALIDATOR_CHANNEL, ledger, bundle, csp),
                          ledger)
    after = blocks[SNAP_BLOCK:]
    csp.inner.drain()
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = list(committer.store_stream(after, depth=depth))
    csp.inner.drain()
    wall = time.perf_counter() - t0
    launches = {"p256_verify_keytab": pk.launches_keytab,
                "p256_verify_lanekeys": pk.launches_lanekeys}
    check(launches["p256_verify_keytab"] > 0,
          f"B1 did not launch on the bootstrapped ledger: {launches}")

    orig_provider = LedgerProvider(com["root"])
    orig = orig_provider.open(VALIDATOR_CHANNEL)
    check(flags == com["flags"][SNAP_BLOCK:], "the bootstrapped ledger's "
          "flags differ from the original's")
    dup = flags[SNAP_DUP_BLOCK - SNAP_BLOCK - 1][SNAP_DUP_TX]
    dup_orig = com["flags"][SNAP_DUP_BLOCK - 1][SNAP_DUP_TX]
    check(dup == dup_orig == pb.DUPLICATE_TXID, f"the txid of block "
          f"{SNAP_DUP_OF} repeated in block {SNAP_DUP_BLOCK}: flags {dup} "
          f"(bootstrapped), {dup_orig} (original)")
    check((ledger.height, ledger.durable_block_hash) == (
        orig.height, orig.durable_block_hash), "heights or hashes differ")
    check(list(ledger.state_db.export_records())
          == list(orig.state_db.export_records()), "the state differs")
    check(list(ledger.block_store.export_txids())
          == list(orig.block_store.export_txids()), "the txid index differs")
    before = {t for raw in blocks[:SNAP_BLOCK] for t in block_txids(raw)}
    for raw in after:
        for t in block_txids(raw):
            got = ledger.block_store.get_tx_loc(t)
            want = None if t in before else orig.block_store.get_tx_loc(t)
            check(got == want, f"txid {t[:16]}: location {got}, expected "
                  f"{want}")
    n_txs = len(cb.Block.decode(blocks[0]).data.data)
    keys = [HIST_KEY] + [f"k{b}-{i}" for b in range(SNAP_BLOCK, len(blocks))
                         for i in range(n_txs)]
    for key in keys:
        got = ledger.get_history_for_key(VALIDATOR_CC, key)
        want = [h for h in orig.get_history_for_key(VALIDATOR_CC, key)
                if h[0] > SNAP_BLOCK]
        check(got == want, f"history of {key}: {got}, expected {want}")
    for n in range(SNAP_BLOCK + 1, len(blocks) + 1):
        check(ledger.get_block_by_number(n).encode()
              == orig.get_block_by_number(n).encode(), f"block {n} differs")
    check(ledger.get_block_by_number(SNAP_BLOCK) is None,
          "the bootstrapped ledger holds a block before its snapshot")
    orig_provider.close()
    provider.close()
    n_tx = len(after) * n_txs
    print(f"snapshot: {len(names)} files, {nbytes} bytes, export "
          f"{com['export_s'] * 1e3:.1f} ms (phase_commit, as block "
          f"{SNAP_BLOCK} committed); verify {verify_s * 1e3:.1f} ms, hash "
          f"route {route} ({B4_NAME} launches: export {com['export_b4']}, "
          f"verify and import {b4}); a copy with one byte flipped refused; "
          f"import (create_from_snapshot, verify included) "
          f"{import_s * 1e3:.1f} ms")
    print(f"snapshot: blocks {SNAP_BLOCK + 1}-{len(blocks)} ({n_tx} "
          f"transactions) streamed into the bootstrapped ledger in "
          f"{wall * 1e3:.1f} ms = {n_tx / wall:.0f} committed tx/s; launches "
          f"{launches}; flags, state, txid index, blocks and history equal "
          f"the original's; the txid of block {SNAP_DUP_OF} repeated in "
          f"block {SNAP_DUP_BLOCK} DUPLICATE_TXID in both")
    return {"launches": launches, "wall_s": wall, "b4": b4 + com["export_b4"],
            "export_s": com["export_s"], "import_s": import_s, "bytes": nbytes}


# ---------------------------------------------------------------------------
# The runtime seams armed: the commit cell traced and profiled.
# ---------------------------------------------------------------------------

TRACE_STAGES = ("collect", "verify_wait", "policy", "mvcc", "block_append",
                "pvt", "state", "history", "fsync", "kv_txn")


def ledger_view(root: str) -> tuple:
    """A closed ledger root's KV pairs and block files' bytes."""
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider

    provider = LedgerProvider(root)
    pairs = list(provider.kv.iterate())
    provider.close()
    return pairs, dir_files(os.path.join(root, VALIDATOR_CHANNEL, "chains"))


def phase_traced_commit(device, world: ValidatorWorld, blocks: list,
                        expect: dict, conflicts: dict, com: dict, tmp: str,
                        depth: int = DEPTH) -> dict:
    """phase_commit's cell twice more, each into a fresh root: under
    `tracing.scope()`, then under `tracing.scope()` and `profile.scope()`.
    Each pass's flags, KV pairs, block files and snapshot must equal the
    untraced pass's (`com`).  Prints the traced pass's committed tx/s
    beside the untraced one's, `critical_path_ms` per stage over the
    blocks, the spans recorded and dropped; then the profiled pass's top
    `self_cpu_ms` stages and the collect stage's top collapsed stacks."""
    want = ledger_view(com["root"])
    want_snap = dir_files(com["snapshot_dir"])
    runs = {}
    for label in ("traced", "profiled"):
        prof_scope = (profile.scope() if label == "profiled"
                      else contextlib.nullcontext())

        def fresh():
            tracing.reset()
            profile.reset()

        with tracing.scope(capacity=1 << 16) as rec, prof_scope as prof:
            run = phase_commit(device, world, blocks, expect, conflicts,
                               depth=depth, mask_check=False,
                               root_dir=os.path.join(tmp, label),
                               on_start=fresh)
            doc = tracing.export(rec)
            pdoc = prof.export() if prof is not None else None
        check(run["flags"] == com["flags"], f"the {label} pass's flags "
              "differ from the untraced pass's")
        check(ledger_view(run["root"]) == want, f"the {label} pass's KV "
              "pairs or block files differ from the untraced pass's")
        check(dir_files(run["snapshot_dir"]) == want_snap, f"the {label} "
              "pass's snapshot differs from the untraced pass's")
        check(run["launches"][B1_NAME] > 0, f"B1 did not launch in the "
              f"{label} pass")
        runs[label] = (run, doc, pdoc)
    run, doc, _ = runs["traced"]
    events = doc["traceEvents"]
    spans = [ev for ev in events if ev["ph"] == "X"]
    recorded = doc["otherData"]["last_event_id"]
    cp = tracing.critical_path_ms(events)
    n_blocks = len(blocks)
    untraced = com["wall_s"]
    n_tx = n_blocks * len(cb.Block.decode(blocks[0]).data.data)
    print(f"traced commit: {n_blocks} blocks in {run['wall_s'] * 1e3:.1f} "
          f"ms = {n_tx / run['wall_s']:.0f} committed tx/s against "
          f"{n_tx / untraced:.0f} untraced ({run['wall_s'] / untraced:.3f}x "
          f"the wall); flags, KV pairs, block files and the snapshot equal "
          f"the untraced pass's; launches {run['launches']}")
    print("traced commit: critical_path_ms per block (over the "
          f"{n_blocks} blocks): " + ", ".join(
              f"{k} {cp.get(k, 0.0) / n_blocks:.2f}" for k in TRACE_STAGES)
          + f"; sum {sum(cp.values()) / n_blocks:.2f} ms; other stages "
          + (", ".join(f"{k} {v / n_blocks:.2f}" for k, v in sorted(
              cp.items()) if k not in TRACE_STAGES) or "none"))
    names = collections.Counter(ev["name"] for ev in spans)
    print(f"traced commit: {recorded} events recorded ({len(spans)} spans "
          f"kept, {recorded - len(events)} dropped by the ring); spans by "
          "name: " + ", ".join(f"{k} {v}" for k, v in sorted(names.items())))
    run_p, _, pdoc = runs["profiled"]
    other = pdoc["otherData"]
    top = sorted(other["self_cpu_ms"].items(), key=lambda kv: -kv[1])[:8]
    print(f"profiled commit: {n_tx / run_p['wall_s']:.0f} committed tx/s "
          f"({run_p['wall_s'] / untraced:.3f}x the untraced wall); "
          f"{other['samples']} samples at {other['interval_s'] * 1e3:.0f} "
          "ms; self_cpu_ms by span: "
          + ", ".join(f"{k} {v:.0f}" for k, v in top))
    stacks = []
    for line in other["collapsed"]:
        stack, _, count = line.rpartition(" ")
        if "_collect_block" in stack:
            stacks.append((int(count), stack.split(";")))
    stacks.sort(key=lambda sc: -sc[0])
    for count, frames in stacks[:5]:
        print(f"profiled commit: collect stack x{count}: "
              + " <- ".join(reversed(frames[-4:])))
    locks = sorted(other["locks"].items(), key=lambda kv: -kv[1]["wait_s"])
    print("profiled commit: lock waits " + ", ".join(
        f"{r} {c['wait_s'] * 1e3:.1f} ms / {c['wait_count']}"
        for r, c in locks[:5]) + f"; workpool {other['workpool']}")
    return {"wall_s": run["wall_s"], "critical_path_ms": cp,
            "profiled_wall_s": run_p["wall_s"], "spans": len(spans),
            "dropped": recorded - len(events)}


# ---------------------------------------------------------------------------
# A joining peer: the snapshot fetched over mutual TLS, the chain after it
# streamed through B1.
# ---------------------------------------------------------------------------

FETCH_CA_SEED = 13


def phase_fetch(device, world: ValidatorWorld, blocks: list, com: dict,
                tmp: str, depth: int = DEPTH) -> dict:
    """phase_commit's snapshot of block SNAP_BLOCK served by a port
    RPCServer (``admin.SnapshotFetch``) under mutual TLS with
    certificates of the port's CA, fetched by a port RPCClient over
    loopback (timed), byte for byte the served files; a new ledger joins
    from it (verify included) and the blocks after it stream through
    `store_stream` with CUDACSP, B1 counted: the flags must be the
    original ledger's and the KV pairs phase_snapshot's bootstrapped
    ledger's.  Then a netsplit plan that severs the joiner from the
    donor makes the fetch raise NetsplitDenied, and after the heal it
    fetches again; a `raise` at ``snapshot.fetch.chunk`` (the third
    chunk) surfaces as RPCError, and an import of the partial directory
    is refused."""
    from fabric_tpu_torch.comm import RPCClient, RPCError, RPCServer
    from fabric_tpu_torch.comm.tls import credentials_from_ca
    from fabric_tpu_torch.ledger import snapshot as snap
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.peer.committer import Committer

    snap_dir = com["snapshot_dir"]
    served = dir_files(snap_dir)
    nbytes = sum(len(v) for v in served.values())
    snapshots_root = os.path.dirname(os.path.dirname(os.path.dirname(
        snap_dir)))
    ca = CA("tlsca.fetch.example.com", "fetch.example.com",
            rng=np.random.default_rng(FETCH_CA_SEED))
    donor = RPCServer(tls=credentials_from_ca(ca, "donor"))
    donor.register("admin.SnapshotFetch",
                   snap.snapshot_fetch_handler(snapshots_root))
    donor.start()
    joiner_tls = credentials_from_ca(ca, "joiner")
    check(donor.tls.require_client_auth and joiner_tls.verify_server_name,
          "the fetch is not mutual TLS")

    def fetch(dest: str) -> str:
        return snap.fetch_snapshot(RPCClient(*donor.addr, tls=joiner_tls),
                                   VALIDATOR_CHANNEL, SNAP_BLOCK,
                                   os.path.join(tmp, dest))

    try:
        t0 = time.perf_counter()
        got = fetch("fetched")
        fetch_s = time.perf_counter() - t0
        check(dir_files(got) == served, "the fetched snapshot differs from "
              "the served one")
        csp = RecordingCSP(new_cuda_csp(device=device))
        provider = LedgerProvider(os.path.join(tmp, "joiner"), csp=csp)
        t0 = time.perf_counter()
        ledger = provider.create_from_snapshot(got)
        import_s = time.perf_counter() - t0
        bundle = bundle_from_genesis(world.genesis)
        committer = Committer(TxValidator(VALIDATOR_CHANNEL, ledger, bundle,
                                          csp), ledger)
        after = blocks[SNAP_BLOCK:]
        csp.inner.drain()
        pk.launches_keytab = 0
        pk.launches_lanekeys = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags = list(committer.store_stream(after, depth=depth))
        csp.inner.drain()
        wall = time.perf_counter() - t0
        launches = {B1_NAME: pk.launches_keytab,
                    B2_NAME: pk.launches_lanekeys}
        check(launches[B1_NAME] > 0, f"B1 did not launch on the joiner: "
              f"{launches}")
        check(flags == com["flags"][SNAP_BLOCK:], "the joiner's flags "
              "differ from the original ledger's")
        pairs = list(provider.kv.iterate())
        provider.close()
        boot = LedgerProvider(os.path.join(tmp, "bootstrapped"))
        check(pairs == list(boot.kv.iterate()), "the joiner's KV pairs "
              "differ from phase_snapshot's bootstrapped ledger's")
        boot.close()
        seams_check("fetch (unarmed)")

        host, port = donor.addr
        plan = {"mode": "full", "groups": [["joiner"], ["donor"]],
                "node": "joiner", "addrs": {f"{host}:{port}": "donor"}}
        with netsplit.use_plan(plan):
            try:
                fetch("severed")
                denied = None
            except netsplit.NetsplitDenied as e:
                denied = str(e)
        # the receiver makes its directory first; a denied connect leaves
        # it empty
        check(denied is not None and not os.listdir(
            os.path.join(tmp, "severed")), "a severed joiner fetched")
        check(dir_files(fetch("healed")) == served, "the fetch after the "
              "heal differs")
        torn_plan = {"faults": [{"point": "snapshot.fetch.chunk",
                                 "action": "raise", "nth": 3}]}
        with faultline.use_plan(torn_plan):
            try:
                fetch("partial")
                torn = None
            except RPCError as e:
                torn = str(e)
        check(torn is not None and "snapshot.fetch.chunk" in torn,
              f"the torn stream did not raise: {torn}")
        partial = os.path.join(tmp, "partial")
        kept = len(os.listdir(partial))
        check(0 < kept < len(served), f"the torn fetch left {kept} files")
        refused = LedgerProvider(os.path.join(tmp, "refused"), csp=csp)
        try:
            refused.create_from_snapshot(partial)
            why = None
        except (snap.SnapshotError, OSError) as e:
            why = str(e)
        refused.close()
        check(why is not None, "the partial snapshot was imported")
    finally:
        donor.stop()
    n_tx = len(after) * len(cb.Block.decode(blocks[0]).data.data)
    print(f"fetch: snapshot of block {SNAP_BLOCK} ({len(served)} files, "
          f"{nbytes} bytes) over mutual TLS (loopback, the port's CA) in "
          f"{fetch_s * 1e3:.1f} ms = {nbytes / fetch_s / 1e6:.1f} MB/s; "
          f"byte for byte the served files")
    print(f"fetch: joined from it in {import_s * 1e3:.1f} ms (verify "
          f"included) and streamed blocks {SNAP_BLOCK + 1}-{len(blocks)} "
          f"({n_tx} transactions) in {wall * 1e3:.1f} ms = "
          f"{n_tx / wall:.0f} committed tx/s; launches {launches}; flags "
          f"the original's, KV pairs phase_snapshot's")
    print(f"fetch: severed by netsplit: NetsplitDenied ({denied}); healed "
          f"and fetched again; a raise at the third chunk: RPCError "
          f"({torn}), {kept} of {len(served)} files kept, import refused "
          f"({why[:80]})")
    return {"launches": launches, "wall_s": wall, "fetch_s": fetch_s,
            "bytes": nbytes}


# ---------------------------------------------------------------------------
# Key custody: an HSM-style daemon signs, CUDACSP verifies on the card.
# ---------------------------------------------------------------------------

CUSTODY_KEYS = 4
CUSTODY_SIGNS = 4000
CUSTODY_TAMPERED = 16
CUSTODY_WIDE_LANES = 1200  # the 300-key batch: 4 lanes a key


def phase_custody(device, errs: dict) -> dict:
    """A `KeyCustodyServer` (a thread over comm's RPC) generates and holds
    CUSTODY_KEYS keys; a `CustodyCSP` whose local provider is CUDACSP on
    the card signs CUSTODY_SIGNS digests through it (timed), then
    verifies them as one block-shaped verify_batch with CUSTODY_TAMPERED
    digests flipped (B1, counted), and a batch over MANY_KEYS custody
    keys (B2, counted).  Each mask must be the planted one, the kernel's
    plain version's on the same packed lanes, and hostref's.  On the
    card, a CustodyCSP given no `verify_csp` must verify on CUDACSP
    there."""
    from fabric_tpu_torch.csp.custody import (
        CustodyCSP,
        CustodyKeyHandle,
        KeyCustodyServer,
    )

    token = b"chip-smoke-custody"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_custody_") as keys:
        daemon = KeyCustodyServer(keys, token)
        daemon.start()
        try:
            if device.type == "cuda":
                default = CustodyCSP(daemon.addr, token)._local
                check(isinstance(default, CUDACSP)
                      and default.device.type == "cuda",
                      f"CustodyCSP's default local provider {default!r} "
                      f"is not CUDACSP on the card")
            local = RecordingCSP(new_cuda_csp(device=device))
            csp = CustodyCSP(daemon.addr, token, verify_csp=local)
            held = [csp.key_gen() for _ in range(CUSTODY_KEYS)]
            check(all(isinstance(k, CustodyKeyHandle) for k in held)
                  and len(os.listdir(keys)) == CUSTODY_KEYS,
                  "the daemon does not hold the keys")
            digests = [hashlib.sha256(b"custody-%d" % i).digest()
                       for i in range(CUSTODY_SIGNS)]
            t0 = time.perf_counter()
            sigs = [csp.sign(held[i % CUSTODY_KEYS], d)
                    for i, d in enumerate(digests)]
            sign_s = time.perf_counter() - t0
            items = [VerifyBatchItem(held[i % CUSTODY_KEYS], d, s)
                     for i, (d, s) in enumerate(zip(digests, sigs))]
            bad = list(range(7, CUSTODY_SIGNS, CUSTODY_SIGNS
                             // CUSTODY_TAMPERED))[:CUSTODY_TAMPERED]
            for i in bad:
                it = items[i]
                items[i] = VerifyBatchItem(
                    it.key, bytes([it.digest[0] ^ 1]) + it.digest[1:],
                    it.signature)
            wide_keys = held + [csp.key_gen() for _ in
                                range(MANY_KEYS - CUSTODY_KEYS)]
            wide = []
            for i in range(CUSTODY_WIDE_LANES):
                key = wide_keys[i % MANY_KEYS]
                d = hashlib.sha256(b"custody-wide-%d" % i).digest()
                wide.append(VerifyBatchItem(key, d, csp.sign(key, d)))
            n = CUSTODY_WIDE_LANES
            wide_bad = [3, n // 3 + 1, 2 * n // 3 + 2, n - 1]
            for i in wide_bad:
                it = wide[i]
                wide[i] = VerifyBatchItem(
                    it.key, it.digest, it.signature[:-1] + bytes(
                        [it.signature[-1] ^ 1]))
            out = {}
            for label, batch, planted in (("block", items, bad),
                                          ("300-key", wide, wide_bad)):
                local.inner.drain()
                pk.launches_keytab = 0
                pk.launches_lanekeys = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mask = csp.verify_batch(batch)
                wall = time.perf_counter() - t0
                launches = {B1_NAME: pk.launches_keytab,
                            B2_NAME: pk.launches_lanekeys}
                check([i for i, ok in enumerate(mask) if not ok] == planted,
                      f"custody {label}: rejected "
                      f"{[i for i, ok in enumerate(mask) if not ok][:20]}")
                public = [VerifyBatchItem(it.key.public_key(), it.digest,
                                          it.signature) for it in batch]
                packed = pk.pack_items(public)
                name = B1_NAME if label == "block" else B2_NAME
                check(launches[name] > 0, f"custody {label}: {name} did not "
                      f"launch: {launches}")
                if name == B1_NAME:
                    packed = pk.dedup_keys(packed)
                plain = compare(name, packed, device, errs)
                check(plain == mask, f"custody {label}: the card's mask "
                      "differs from the plain version's")
                out[label] = (wall, launches, len(batch))
            lanes = check_mask(local, "custody")
        finally:
            daemon.stop()
    print(f"custody: {CUSTODY_SIGNS} digests signed through the custody "
          f"daemon ({CUSTODY_KEYS} keys, one RPC a signature) in "
          f"{sign_s * 1e3:.1f} ms = {CUSTODY_SIGNS / sign_s:.0f} signs/s")
    for label, (wall, launches, n) in out.items():
        print(f"custody: {label} batch of {n} lanes through "
              f"CustodyCSP.verify_batch on CUDACSP in {wall * 1e3:.1f} ms "
              f"({n / wall:.0f} lanes/s); launches {launches}; mask the "
              "planted one, the plain version's and hostref's")
    print(f"custody: {lanes} lanes held against hostref")
    return {"sign_s": sign_s, "launches": {
        B1_NAME: out["block"][1][B1_NAME],
        B2_NAME: out["300-key"][1][B2_NAME]},
        "block_wall_s": out["block"][0], "wide_wall_s": out["300-key"][0]}


# ---------------------------------------------------------------------------
# The degraded mode (CUDACSP's breaker and probe, each fault raised on
# the card; the idemix path's), driven by faultline plans, and the host
# verifier.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The commit path on the namespace-sharded store.
# ---------------------------------------------------------------------------

STORE_SHARDS = 4
KV_STAGES = ("kv_txn", "kv_prepare", "kv_commit", "kv_apply")


def store_pairs(root: str) -> list:
    """Every KV pair of a ledger root, less the sharded store's own
    records (its width and flush epoch)."""
    from fabric_tpu_torch.ledger import kvstore

    kv = kvstore.open_store_root(root)
    try:
        return [(k, v) for k, v in kv.iterate()
                if not k.startswith(b"\x00storev2\x00")]
    finally:
        kv.close()


def dir_files(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def kv_line(stages: dict, n_blocks: int) -> str:
    shards = sorted(k for k in stages if k.startswith("kv_shard"))
    return ", ".join(f"{k} {stages.get(k, 0.0) / n_blocks * 1e3:.2f}"
                     for k in KV_STAGES + tuple(shards))


def phase_commit_sharded(device, world: ValidatorWorld, blocks: list,
                         expect: dict, conflicts: dict, com: dict, tmp: str,
                         depth: int = DEPTH,
                         shards: int = STORE_SHARDS) -> dict:
    """phase_commit again, into a fresh root at FABRIC_TPU_STORE_SHARDS =
    `shards` (B1 on the card, counted), held against `com`, the
    single-file run of the same blocks: the flags, every KV pair, the
    snapshot of block SNAP_BLOCK file for file, and B1's launches; the
    root must reopen sharded, at its width and height, with the knob
    unset."""
    from fabric_tpu_torch.ledger import kvstore
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider

    root_dir = os.path.join(tmp, "sharded")
    os.environ["FABRIC_TPU_STORE_SHARDS"] = str(shards)
    try:
        shc = phase_commit(device, world, blocks, expect, conflicts,
                           depth=depth, root_dir=root_dir)
    finally:
        del os.environ["FABRIC_TPU_STORE_SHARDS"]
    n_blocks = len(blocks)
    check(shc["flags"] == com["flags"], "the sharded run's flags differ "
          "from the single-file run's")
    pairs = store_pairs(shc["root"])
    check(pairs == store_pairs(com["root"]), f"the sharded store's "
          f"{len(pairs)} KV pairs differ from the single-file store's")
    if com["snapshot_dir"] is not None:
        check(dir_files(shc["snapshot_dir"])
              == dir_files(com["snapshot_dir"]), f"the snapshot of block "
              f"{SNAP_BLOCK} differs from the single-file run's")
    provider = LedgerProvider(shc["root"])
    height = provider.open(VALIDATOR_CHANNEL).height
    kv = provider.kv
    check(isinstance(kv, kvstore.ShardedKVStore) and kv.shards == shards
          and height == n_blocks + 1, f"the sharded root reopened as "
          f"{type(kv).__name__} at height {height}")
    files = sorted(f for f in os.listdir(shc["root"]) if f.endswith(".sqlite"))
    provider.close()
    b1 = shc["launches"][B1_NAME]
    check(b1 == com["launches"][B1_NAME], f"B1 launched {b1} times on the "
          f"sharded run, {com['launches'][B1_NAME]} on the single file")
    n_tx = sum(len(f) for f in shc["flags"])
    print(f"commit sharded: {shards} shards ({', '.join(files)}): "
          f"{n_tx / shc['wall_s']:.0f} committed tx/s, "
          f"{shc['wall_s'] / n_blocks * 1e3:.1f} ms a block; the single file "
          f"in this run {n_tx / com['wall_s']:.0f} tx/s, "
          f"{com['wall_s'] / n_blocks * 1e3:.1f} ms a block; "
          f"{shc['flushes']} group flushes; {b1} launches of {B1_NAME}")
    print("commit sharded: kv stages per block, ms: "
          f"{kv_line(shc['stages'], n_blocks)} (single file: "
          f"{kv_line(com['stages'], n_blocks)})")
    print(f"commit sharded: flags, {len(pairs)} KV pairs and the snapshot of "
          f"block {SNAP_BLOCK} equal to the single file's; reopened at "
          f"height {height} with the knob unset")
    return shc


def shards_ab(turns: int = 4) -> int:
    """phase_commit at widths 1 and STORE_SHARDS in turns (1, 4, 4, 1,
    ...), one process, each into a fresh root; prints each turn's
    committed tx/s and kv stages."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print_device()
    phase_build()
    world = validator_world(SEED)
    blocks, expect, conflicts = validator_blocks(
        world, N_BLOCKS, N_TXS, world.genesis_hash, mvcc=True)
    widths = [(1, STORE_SHARDS), (STORE_SHARDS, 1)]
    order = [w for t in range(turns) for w in widths[t % 2]][:turns]
    rates = collections.defaultdict(list)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        for turn, width in enumerate(order):
            os.environ["FABRIC_TPU_STORE_SHARDS"] = str(width)
            try:
                run = phase_commit(device, world, blocks, expect, conflicts,
                                   root_dir=os.path.join(tmp, f"t{turn}"))
            finally:
                del os.environ["FABRIC_TPU_STORE_SHARDS"]
            rate = N_BLOCKS * N_TXS / run["wall_s"]
            rates[width].append(rate)
            print(f"shards A/B turn {turn}: width {width}, {rate:.0f} "
                  f"committed tx/s; kv stages per block, ms: "
                  f"{kv_line(run['stages'], N_BLOCKS)}")
            host_check(f"shards A/B turn {turn}")
    workpool.shutdown()
    print("shards A/B: " + "; ".join(
        f"width {w}: " + ", ".join(f"{r:.0f}" for r in rs)
        for w, rs in sorted(rates.items())) + " committed tx/s")
    return 0


DEGRADED_THRESHOLD = 3
DEGRADED_PROBE_EVERY = 2
DEGRADED_DELAY_S = 1.0  # the stalled collect a card sits out
HOST_RATE_SIZES = (1000, 8000)  # libcrypto's batches; hostref at the first
IDEMIX_DEGRADED_SIGS = 64


def hostref_mask(items) -> list[bool]:
    """hostref's verdicts, in 8 worker processes."""
    workers = min(8, os.cpu_count() or 1)
    step = -(-len(items) // workers)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return [ok for part in ex.map(
            hostref.verify_batch,
            [items[i:i + step] for i in range(0, len(items), step)])
            for ok in part]


def breaker_state(csp: CUDACSP) -> str:
    b = csp.breaker
    return (f"open {b.open}, trips {b.trips}, consecutive {b._consecutive}, "
            f"probes {b.probes}")


def host_rates(items, sizes=HOST_RATE_SIZES, reps: int = 3) -> dict:
    """Lanes/s of the host verifiers on this host: libcrypto's batch
    (`native.ecdsa_verify_host`, one thread) at each of `sizes`, median
    of `reps`, and hostref at the smallest, once."""
    out = {}
    for n in sizes:
        lanes = items[:n]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            mask = native.ecdsa_verify_host(lanes)
            times.append(time.perf_counter() - t0)
        check(mask is not None, "no libcrypto loads on this host")
        out[f"libcrypto_{n}"] = n / statistics.median(times)
        out[f"mask_{n}"] = mask
    n = sizes[0]
    t0 = time.perf_counter()
    ref = hostref.verify_batch(items[:n])
    out[f"hostref_{n}"] = n / (time.perf_counter() - t0)
    check(ref == out[f"mask_{n}"], "hostref and libcrypto disagree")
    return out


def phase_degraded(rng, device, world: IdemixWorld, n_txs: int = N_TXS,
                   rate_sizes=HOST_RATE_SIZES, frac_lanes: int = 8000,
                   n_idemix: int = IDEMIX_DEGRADED_SIGS,
                   n_msgs: int = HASH_WIDE_MSGS) -> dict:
    """CUDACSP's and IdemixCSP's degraded mode on the card, driven by
    faultline plans.  On a card the host answers nothing in the device's
    place, so every fault must reach the caller, counted:
    1. a collect fault raises out of both collectors of a two-segment
       flush; the breaker counts 1, and the next flush (hostref's mask)
       resets the count;
    2. `threshold` dispatch faults, each raised, open the breaker; a held
       call is refused (BreakerOpenError) with no flush queued and no
       launch of B1, and the health check fails;
    3. the next held call probes through B1, which closes the breaker,
       and the call itself runs on the card (B1's launches rise);
    4. a hash fault raises out of hash_batch, counted; B4's digests then
       equal hashlib's;
    5. the B3 path raising (its entry swapped for one that raises): the
       idemix verify raises, counted, and the card's masks after are
       right;
    6. a `delay` at tpu.collect: no race on a card; the collector sits
       it out and returns the card's mask;
    7. host_fraction is refused on a card.
    Also the host verifiers' lanes/s on this host at `rate_sizes` over
    a `frac_lanes`-lane flush (the rate the CPU provider's deadlines
    assume).  Returns the numbers printed."""
    client, peers = block_world(rng)
    block = block_items(rng, client, peers[:ENDORSERS], n_txs)
    items, bad = plant_bad(block)
    want = [i not in bad for i in range(len(items))]
    t0 = time.perf_counter()
    ref = hostref_mask(items)
    check(ref == want, "hostref's mask of the degraded block is not the "
          "planted one")
    print(f"degraded: block of {len(items)} lanes, planted {bad}; hostref's "
          f"mask in {time.perf_counter() - t0:.1f} s (8 processes)")
    copies = -(-frac_lanes // len(items))
    eight = ((items + block) * copies)[:frac_lanes]
    want8 = ((want + [True] * len(block)) * copies)[:frac_lanes]
    rates = host_rates(eight, rate_sizes)
    top = rate_sizes[-1]
    check(rates[f"mask_{top}"] == want8[:top],
          "libcrypto's mask is not hostref's")
    print(f"degraded: host verifier on this host ({native.ecdsa_impl()}): "
          + ", ".join(f"libcrypto {rates[f'libcrypto_{n}']:.0f} lanes/s at "
                      f"{n}" for n in rate_sizes)
          + f"; hostref {rates[f'hostref_{rate_sizes[0]}']:.0f} "
          f"lanes/s at {rate_sizes[0]} (one thread each; the "
          f"provider's HOST_RATE_HINT {cuda_provider.HOST_RATE_HINT:.0f})")
    out = {k: v for k, v in rates.items() if not k.startswith("mask")}

    prom = PrometheusProvider()
    csp = new_cuda_csp(device=device, breaker_threshold=DEGRADED_THRESHOLD,
                       breaker_probe_every=DEGRADED_PROBE_EVERY,
                       metrics=CSPMetrics(prom),
                       coalesce_lanes=2 * len(items))
    check(csp.verify_batch(items) == want, "the healthy flush's mask")

    def raising(point: str, **rule) -> dict:
        return {"faults": [dict(point=point, action="raise",
                                error="DeviceUnavailable", **rule)]}

    def raises(fn, exc_type) -> float:
        """Milliseconds until `fn()` raised `exc_type`; fails the run if
        it returned."""
        t0 = time.perf_counter()
        try:
            fn()
        except exc_type:
            return (time.perf_counter() - t0) * 1e3
        raise RuntimeError(f"{fn} did not raise {exc_type.__name__}")

    # 1. a collect fault reaches both collectors of the flush
    half = len(items) // 2
    with faultline.use_plan(raising("tpu.collect", nth=1)):
        cols = [csp.verify_batch_async(items[:half]),
                csp.verify_batch_async(items[half:])]
        ms = [raises(col, faultline.DeviceUnavailable) for col in cols]
    st = csp.degraded_stats()
    check(st["device_failures"] == 1 and st["host_lanes"] == 0
          and not csp.breaker_open and csp.breaker._consecutive == 1,
          f"collect fault: {st}, {breaker_state(csp)}")
    out["collect_fault_ms"] = ms[0]
    print(f"degraded 1, collect fault: both collectors of a {len(items)}-"
          f"lane flush raised DeviceUnavailable ({ms[0]:.1f} ms, then "
          f"{ms[1]:.1f} ms); breaker {breaker_state(csp)}; host_lanes 0")
    check(csp.verify_batch(items) == want and csp.breaker._consecutive == 0,
          "a healthy flush after the fault did not reset the count")

    # 2. threshold dispatch faults open the breaker
    with faultline.use_plan(raising("tpu.dispatch",
                                    count=DEGRADED_THRESHOLD)):
        for _ in range(DEGRADED_THRESHOLD):
            raises(lambda: csp.verify_batch(items),
                   faultline.DeviceUnavailable)
    t_open = time.perf_counter()
    check(csp.breaker_open and csp.breaker.trips == 1,
          f"the breaker did not open: {breaker_state(csp)}")
    b1 = pk.launches_keytab
    gen = csp._gen
    held_ms = raises(lambda: csp.verify_batch(items),
                     cuda_provider.BreakerOpenError)
    health = csp.health_checker()
    check(csp.breaker_open and csp._gen == gen and pk.launches_keytab == b1,
          f"held call: gen {csp._gen - gen}, B1 {pk.launches_keytab - b1}")
    raises(health, RuntimeError)
    print(f"degraded 2, {DEGRADED_THRESHOLD} dispatch faults, each raised: "
          f"breaker {breaker_state(csp)}; a held call refused "
          f"(BreakerOpenError) in {held_ms:.3f} ms, no flush queued, B1 "
          "launches +0; the health check fails")

    # 3. the probe closes the breaker
    t0 = time.perf_counter()
    mask = csp.verify_batch(items)
    t_close = time.perf_counter()
    probe_b1 = pk.launches_keytab - b1
    check(mask == want and not csp.breaker_open and health()
          and csp.breaker.probes == {"ok": 1, "fail": 0} and probe_b1 >= 2,
          f"probe: {breaker_state(csp)}, B1 +{probe_b1}")
    out["open_to_close_calls"] = 2
    out["open_to_close_ms"] = (t_close - t_open) * 1e3
    out["probe_call_ms"] = (t_close - t0) * 1e3
    print(f"degraded 3, recovery: the probe ran through B1 and closed the "
          f"breaker; open -> closed in 2 calls, "
          f"{out['open_to_close_ms']:.1f} ms (the probing call "
          f"{out['probe_call_ms']:.1f} ms, probe and the call's own flush "
          f"on the card, mask hostref's); B1 launches +{probe_b1}")

    # 4. a hash fault
    msgs = random_messages(rng, rng.integers(*HASH_WIDE_BYTES, n_msgs))
    check(hash_on_card(msgs), "the degraded hash batch is not card-wide")
    with faultline.use_plan(raising("tpu.hash", nth=1)):
        raises(lambda: csp.hash_batch(msgs), faultline.DeviceUnavailable)
    check(csp.degraded_stats()["host_hashes"] == 0
          and csp.breaker._consecutive == 1,
          f"hash fault: {csp.degraded_stats()}")
    sha.launches_sha256 = 0
    check(csp.hash_batch(msgs) == hashlib_digests(msgs)
          and sha.launches_sha256 >= 1 and csp.breaker._consecutive == 0,
          "B4 after the hash fault")
    print(f"degraded 4, hash fault: hash_batch of {len(msgs)} messages "
          f"raised, counted (consecutive 1); unarmed, {B4_NAME} "
          f"({sha.launches_sha256} launches) gave hashlib's digests")
    deg1 = csp.degraded_stats()
    exposed = [line for line in prom.registry.expose().splitlines()
               if line.startswith("csp_tpu_")]
    print(f"degraded: /metrics {'; '.join(exposed)}")
    csp.close()

    # 5. the B3 path raising
    ipk = world.ipk
    lanes = idemix_lanes(world, n_idemix, b"degraded")
    ibad = {3: "challenge"}
    iitems = [IdemixVerifyItem(tamper(s, ibad[j]) if j in ibad else s, m)
              for j, (s, m) in enumerate(lanes)]
    icsp = new_idemix_csp(rng=random.Random(SEED), device=device,
                          use_device=True)
    entry = bb.schnorr_commitments_batch

    class Lost(RuntimeError):
        pass

    def lost(*args, **kwargs):
        raise Lost("injected: the B3 path lost its device")

    bb.schnorr_commitments_batch = lost
    try:
        raises(lambda: icsp.verify_batch(iitems, ipk), Lost)
    finally:
        bb.schnorr_commitments_batch = entry
    bk.launches_bn254 = 0
    card_mask = icsp.verify_batch(iitems, ipk)
    check(card_mask == mask_of(len(iitems), ibad)
          and icsp.degraded_stats() == {"host_lanes": 0,
                                        "device_failures": 1}
          and bk.launches_bn254 >= 1, f"B3 fault: {icsp.degraded_stats()}")
    print(f"degraded 5, B3 path fault: the idemix verify of {len(iitems)} "
          f"signatures raised, counted; after it the card's mask is right "
          f"({B3_NAME} {bk.launches_bn254} launches)")

    # 6. a delayed collect: no race on a card
    # flushes at enqueue, so that the collect alone is timed
    rcsp = new_cuda_csp(device=device, coalesce_lanes=len(items))
    check(rcsp.verify_batch(items) == want, "delay warm-up")
    with faultline.use_plan({"faults": [
            {"point": "tpu.collect", "action": "delay",
             "delay_s": DEGRADED_DELAY_S, "nth": 1}]}):
        col = rcsp.verify_batch_async(items)
        t0 = time.perf_counter()
        mask = col()
        delay_ms = (time.perf_counter() - t0) * 1e3
    st = rcsp.degraded_stats()
    check(mask == want and st["races"] == 0 and st["host_lanes"] == 0
          and delay_ms >= DEGRADED_DELAY_S * 1e3,
          f"delay: {st}, {delay_ms:.1f} ms")
    out["delayed_collect_ms"] = delay_ms
    print(f"degraded 6, delay: a {DEGRADED_DELAY_S:.1f} s delay at "
          f"tpu.collect; the collector returned the card's mask after "
          f"{delay_ms:.1f} ms, races 0, host_lanes 0")
    rcsp.close()

    # 7. host_fraction stays on the CPU
    raises(lambda: CUDACSP(device=device, host_fraction=0.25), ValueError)
    print("degraded 7, host_fraction 0.25 on the card: refused "
          "(ValueError)")
    total = host_check("degraded", degraded=True)
    check(total["trips"] == 1 and deg1["probes_ok"] == 1
          and total["host_lanes"] == total["host_hashes"] == 0
          and total["races"] == 0, "degraded totals")
    return out


# one --commit-ab turn, run in the tree under test: the world and blocks
# come from the tree's own pickle when an earlier turn left one (the
# signing takes most of a turn), so every turn of a tree commits the
# same blocks
AB_TURN = (
    "import json, os, pickle, sys, torch\n"
    "import chip_smoke as c\n"
    "c.phase_build()\n"
    "path = sys.argv[1]\n"
    "if os.path.exists(path):\n"
    "    with open(path, 'rb') as f:\n"
    "        w, b, e, m = pickle.load(f)\n"
    "else:\n"
    "    w = c.validator_world(c.SEED)\n"
    "    b, e, m = c.validator_blocks(w, c.N_BLOCKS, c.N_TXS, "
    "w.genesis_hash, mvcc=True)\n"
    "    with open(path, 'wb') as f:\n"
    "        pickle.dump((w, b, e, m), f)\n"
    "r = c.phase_commit(torch.device('cuda', 0), w, b, e, m)\n"
    "c.workpool.shutdown()\n"
    "print('AB ' + json.dumps({'wall_s': r['wall_s'], 'n': "
    "c.N_BLOCKS * c.N_TXS}))\n"
)


def seam_functions() -> dict:
    """The runtime seams on the commit path, by name: each is a global
    load and a None test (or an environment read, `guarded`) while
    nothing is armed."""
    from fabric_tpu_torch.devtools import lockwatch

    return {
        "faultline.point": faultline.point,
        "faultline.stall": faultline.stall,
        "faultline.guard": faultline.guard,
        "tracing.begin": tracing.begin,
        "tracing.noop_enter": type(tracing.begin("x")).__enter__,
        "tracing.noop_exit": type(tracing.begin("x")).__exit__,
        "tracing.instant": tracing.instant,
        "tracing.annotate": tracing.annotate,
        "tracing.current": tracing.current,
        "tracing.attached": tracing.attached,
        "tracing.enabled": tracing.enabled,
        "profile.enabled": profile.enabled,
        "profile.note_chunk": profile.note_chunk,
        "lockwatch.guarded": lockwatch.guarded,
    }


def seam_ns(calls: int = 200_000) -> dict:
    """ns a call of each unarmed seam on this host (the loop's own cost
    included), with the arguments the commit path gives it."""
    from fabric_tpu_torch.devtools import lockwatch

    span = tracing.begin("x")
    args = {
        "faultline.point": (("commit.stage",), {"stage": "mvcc"}),
        "faultline.stall": (("tpu.collect",), {"n": 4000}),
        "faultline.guard": (("recovery_truncate",), {}),
        "tracing.begin": (("mvcc",), {"block": 1, "txs": 1000}),
        "tracing.noop_enter": ((span,), {}),
        "tracing.noop_exit": ((span, None, None, None), {}),
        "tracing.instant": (("snapshot.stage",), {"stage": "x"}),
        "tracing.annotate": ((), {"lanes": 4000}),
        "tracing.current": ((), {}),
        "tracing.attached": ((None,), {}),
        "tracing.enabled": ((), {}),
        "profile.enabled": ((), {}),
        "profile.note_chunk": ((0.0, 0.0), {}),
        "lockwatch.guarded": ((span, "_active_group"),
                              {"by": "kvledger.commit_lock"}),
    }
    out = {}
    for name, fn in seam_functions().items():
        a, kw = args[name]
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn(*a, **kw)
        out[name] = (time.perf_counter_ns() - t0) / calls
    check(tracing.lookup_count() == 0 and profile.lookup_count() == 0,
          "timing the unarmed seams moved their lookup counts")
    return out


# the census: this tree's headline commit with a profile hook that counts
# the calls of every seam (the hook slows the run; nothing is timed)
AB_CENSUS = (
    "import collections, json, pickle, sys, threading, torch\n"
    "import chip_smoke as c\n"
    "c.phase_build()\n"
    "with open(sys.argv[1], 'rb') as f:\n"
    "    w, b, e, m = pickle.load(f)\n"
    "codes = {fn.__code__: name for name, fn in "
    "c.seam_functions().items()}\n"
    "count = collections.Counter()\n"
    "def hook(frame, event, arg):\n"
    "    if event == 'call' and frame.f_code in codes:\n"
    "        count[codes[frame.f_code]] += 1\n"
    "def on_start():\n"
    "    count.clear()\n"
    "    threading.setprofile_all_threads(hook)\n"
    "try:\n"
    "    c.phase_commit(torch.device('cuda', 0), w, b, e, m, "
    "on_start=on_start)\n"
    "finally:\n"
    "    threading.setprofile_all_threads(None)\n"
    "c.workpool.shutdown()\n"
    "print('CENSUS ' + json.dumps(dict(count)))\n"
)


def commit_ab(parent: str, turns: int = 4) -> int:
    """`python3 chip_smoke.py --commit-ab PARENT_TREE [TURNS]`: the
    headline's committed tx/s (phase_commit at full size) of another tree
    of this repository (the parent, unpacked by `git archive`) and of
    this one, in turns (parent, this, this, parent, ...), each in a
    process of its own on card 0.  Prints one line a turn, then each
    tree's turns, median and quartiles, the pairs (a turn of each, in
    order) this tree won, and what the unarmed seams cost: their calls a
    block in this tree's run (counted from the timed run's start to the
    end of phase_commit's checks, so an upper bound), each call's ns on
    this host, and the product in ms a block."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "this": here}
    order = [("parent", "this", "this", "parent")[k % 4]
             for k in range(turns)]
    got: dict = {"parent": [], "this": []}
    seq = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        cache = {label: os.path.join(tmp, f"{label}.pickle")
                 for label in trees}
        for label in order:
            proc = subprocess.run(
                [sys.executable, "-c", AB_TURN, cache[label]],
                cwd=trees[label], capture_output=True, text=True)
            for line in proc.stdout.splitlines():
                if line.startswith("commit:"):
                    print(f"{label}: {line}")
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:],
                      file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.split("AB ", 1)[1].splitlines()[0])
            got[label].append(res["n"] / res["wall_s"])
            seq.append((label, got[label][-1]))
            print(f"commit A/B turn {len(seq)}: {label} "
                  f"{got[label][-1]:.0f} committed tx/s", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", AB_CENSUS, cache["this"]], cwd=here,
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        census = json.loads(
            proc.stdout.split("CENSUS ", 1)[1].splitlines()[0])
    for label, vals in got.items():
        q1, q2, q3 = (statistics.quantiles(vals, n=4) if len(vals) > 1
                      else vals * 3)
        print(f"commit A/B {label}: {', '.join(f'{v:.0f}' for v in vals)} "
              f"committed tx/s; median {statistics.median(vals):.1f}, "
              f"quartiles {q1:.1f}-{q3:.1f}, range {min(vals):.0f}-"
              f"{max(vals):.0f}")
    pairs = [dict(seq[k:k + 2]) for k in range(0, len(seq) - 1, 2)]
    wins = sum(p["this"] > p["parent"] for p in pairs)
    print(f"commit A/B pairs: this tree won {wins} of {len(pairs)}")
    ns = seam_ns()
    cost = {name: census.get(name, 0) * ns[name] / N_BLOCKS / 1e6
            for name in ns}
    print("commit A/B unarmed seams a block: " + ", ".join(
        f"{name} {census.get(name, 0) / N_BLOCKS:.1f} calls x "
        f"{ns[name]:.0f} ns" for name in ns))
    block_ms = N_TXS / statistics.median(got["this"]) * 1e3
    print(f"commit A/B unarmed seams: {sum(cost.values()):.4f} ms a block "
          f"(upper bound), against {block_ms:.1f} ms a block at this "
          f"tree's median")
    return 0


MULTI_FLUSHES = 8


def multi_card(turns: int = 3, n_flushes: int = MULTI_FLUSHES,
               cards=None, n_txs: int = N_TXS) -> int:
    """`python3 chip_smoke.py --multi-card`: CUDACSP over every visible
    card (two or more; `cards` and `n_txs` rehearse it on the CPU at a
    small size), each flush on the next card; see the module's
    docstring."""
    if cards is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("chip_smoke: --multi-card needs two CUDA devices or more",
                  file=sys.stderr)
            return 1
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        print(f"device: {len(cards)} x {torch.cuda.get_device_name(0)}")
        print("nvidia-smi: " + "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()))
        phase_build()
    n = len(cards)
    rng = np.random.default_rng(SEED)
    client, peers = block_world(rng)
    items, bad = plant_bad(block_items(rng, client, peers[:ENDORSERS],
                                       n_txs))
    want = [i not in bad for i in range(len(items))]
    providers = {"one card": CUDACSP(device=cards[:1],
                                     coalesce_lanes=len(items)),
                 f"{n} cards": CUDACSP(device=cards,
                                       coalesce_lanes=len(items))}
    for csp in providers.values():  # each card loads B1, gets its table
        for _ in range(n):
            check(csp.verify_batch(items) == want, "warm-up mask")

    def run(csp: CUDACSP) -> tuple[float, list]:
        """Seconds for n_flushes flushes enqueued together, then
        collected; the cards each flush took."""
        if cards[0].type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols, used = [], []
        for _ in range(n_flushes):
            cols.append(csp.verify_batch_async(items))  # flushes here
            used.append(csp.last_dispatch_devices)
        masks = [col() for col in cols]
        wall = time.perf_counter() - t0
        check(all(m == want for m in masks), "a flush's mask")
        return wall, used

    multi = providers[f"{n} cards"]
    b1 = pk.launches_keytab
    _, used = run(multi)
    check(pk.launches_keytab - b1 == n_flushes,
          f"B1 launches {pk.launches_keytab - b1} for {n_flushes} flushes")
    turn = [u[0].index for u in used]
    check(all(len(u) == 1 for u in used)
          and all((b - a) % n == 1 for a, b in zip(turn, turn[1:])),
          f"the flushes' cards: {used}")
    print(f"multi-card: {n_flushes} flushes of {len(items)} lanes took "
          f"cards {turn} in turn, B1 {n_flushes} launches, every mask the "
          f"planted one")
    got: dict = {label: [] for label in providers}
    for k in range(turns):
        for label in (list(providers) if k % 2 == 0
                      else list(providers)[::-1]):
            wall, _ = run(providers[label])
            got[label].append(n_flushes * len(items) / wall)
    for label, rates in got.items():
        print(f"multi-card: {label}: "
              f"{', '.join(f'{r:.0f}' for r in rates)} lanes/s "
              f"({n_flushes} flushes enqueued together, in turns)")
    for csp in providers.values():
        csp.close()
    return 0


def print_device() -> str:
    """Prints the card's name, and its name and power limit as nvidia-smi
    gives them; returns the name."""
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")
    return kind


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--commit-ab"] and len(argv) in (2, 3):
        return commit_ab(argv[1], *(int(a) for a in argv[2:]))
    if argv == ["--multi-card"]:
        return multi_card()
    if argv[:1] == ["--shards-ab"] and len(argv) in (1, 2):
        return shards_ab(*(int(a) for a in argv[1:]))
    if argv:
        print("usage: chip_smoke.py [--commit-ab PARENT_TREE [TURNS] | "
              "--multi-card | --shards-ab [TURNS]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = print_device()
    seams_check("start")
    phase_build()
    phase_native()
    phase_sass()
    phase_field(device)
    rng = np.random.default_rng(SEED)
    errs: dict = {}
    phase_edges(rng, device, errs)
    launches, walls, shapes = phase_main(rng, device)
    host_check("main path")
    rows = phase_kernels(device, launches, shapes, errs)
    for row in rows:
        # device share of the main path's wall, from the launches and the
        # kernel's time at the same shape
        busy = row["launches"] * row["ms"]
        wall = walls[row["name"]] * 1e3
        print(f"{row['name']}: device busy ~{busy:.1f} ms of the "
              f"{wall:.1f} ms wall ({busy / wall:.1%}; launches x kernel ms)")
    t0 = time.perf_counter()
    world = validator_world(SEED)
    t1 = time.perf_counter()
    blocks, expect, conflicts = validator_blocks(
        world, N_BLOCKS, N_TXS, world.genesis_hash, mvcc=True)
    print(f"validator setup: 5-org world {t1 - t0:.1f} s, {N_BLOCKS} blocks "
          f"of {N_TXS} transactions {time.perf_counter() - t1:.1f} s "
          f"({sum(map(len, blocks)) / 1e6:.2f} MB)")
    val = phase_validator(device, world, blocks, expect)
    host_check("validator")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        com = phase_commit(device, world, blocks, expect, conflicts,
                           root_dir=os.path.join(tmp, "commit"))
        host_check("commit")
        snp = phase_snapshot(device, world, blocks, com, tmp)
        host_check("snapshot")
        fet = phase_fetch(device, world, blocks, com, tmp)
        host_check("fetch", armed=True)
        shc = phase_commit_sharded(device, world, blocks, expect, conflicts,
                                   com, tmp)
        host_check("commit sharded")
        sb = phase_smallbank(device, world, os.path.join(tmp, "smallbank"))
        host_check("smallbank")
        phase_traced_commit(device, world, blocks, expect, conflicts, com,
                            tmp)
        host_check("traced commit", armed=True)
    b1 = next(row for row in rows if row["name"] == B1_NAME)
    for label, run in (("validator", val), ("commit", com),
                       ("commit_sharded", shc), ("smallbank", sb),
                       ("bootstrap", snp)):
        b1[f"launches_{label}"] = run["launches"][B1_NAME]
        busy = b1[f"launches_{label}"] * b1["ms"]
        wall = run["wall_s"] * 1e3
        print(f"{label}: device busy (B1) ~{busy:.1f} ms of the {wall:.1f} "
              f"ms wall ({busy / wall:.1%}; launches x B1's ms at 8000 "
              "lanes)")
    b1["launches_smallbank_sharded"] = sb["launches_sharded"][B1_NAME]
    cus = phase_custody(device, errs)
    host_check("custody")
    b2 = next(row for row in rows if row["name"] == B2_NAME)
    for row in (b1, b2):
        row["launches_fetch"] = fet["launches"][row["name"]]
        row["launches_custody"] = cus["launches"][row["name"]]
        # custody's comparisons with the plain version count too
        row["max_abs_err"] = errs[row["name"]]["max_abs_err"]
    phase_churn(rng, device)
    host_check("churn")
    rows.append(phase_sha256(rng, device, errs))
    host_check("sha256")
    rows[-1]["launches_snapshot"] = snp["b4"]

    t0 = time.perf_counter()
    world = idemix_world(SEED)
    print(f"idemix setup: issuer key ({len(MSP_ATTRS)} attributes), "
          f"credential and {len(world.bases)} signatures in "
          f"{time.perf_counter() - t0:.1f} s")
    sig, msg = idemix_lanes(world, 1, b"host-check")[0]
    check(isig.verify(sig, world.ipk, msg), "a re-signed signature does "
          "not verify on the host")
    phase_b3_edges(world, device, errs)
    main_b3 = phase_idemix_main(world, device)
    host_check("idemix")
    phase_crossover(world, device)
    host_check("crossover")
    msp = phase_idemix_msp(device)
    host_check("idemix msp")
    rows.append(phase_b3_kernel(main_b3, errs))
    rows[-1]["launches_idemix_msp"] = msp["launches"]
    phase_b3_sweep(main_b3["tensors"])
    phase_degraded(rng, device, world)
    workpool.shutdown()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
