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
   The ordered commit (`phase_order`): the same 8000 envelopes broadcast
   by one thread through the port's `BroadcastHandler` into a solo
   `Registrar` (the channel minted again with BatchSize 1000 messages,
   PreferredMaxBytes 8 MiB, AbsoluteMaxBytes 10 MiB, BatchTimeout 2s;
   the orderer's identity from the world's orderer CA), while a
   `DeliverClient` over an in-process `DeliverService` (two endpoints,
   each of whose first stream carries block 1 with its signature
   flipped) streams the signed blocks into `Committer.store_stream(
   depth=6)` on an on-disk `KVLedger` with `CUDACSP`, B1 counted.  The
   refused envelopes must be the predicted ones (the bad creator
   signature FORBIDDEN, the truncated payload BAD_REQUEST), the blocks
   1000 envelopes each and the last partial, both tampered blocks
   refused with a rotation, every committed block's signature valid
   under /Channel/Orderer/BlockValidation, each admitted transaction's
   flag and the state's keys and values phase_commit's, and the mask
   the host route's (libcrypto).  Then 2 blocks again to a second peer over a port
   `RPCServer` under mutual TLS (`deliver_response_frames`), and the
   first peer's FilteredBlocks (`deliver_filtered_frames`): flags and
   FilteredBlocks equal the in-process pass's.  Prints envelopes
   broadcast a second with the signature filter's share, blocks cut and
   ms a block to cut, sign and write, the deliver latency a block,
   committed tx/s and ms a block at the peer, and B1's launches.
   The gateway and gossip (`phase_gateway`, after `phase_endorse` on the
   raft cluster's second channel): five fresh peers (Org1-5), each on its
   own root, join one gossip network over `TCPGossipComm` (mutual TLS,
   `SignerMCS`), one after another; the elected leader alone runs its
   deliver client on the cluster, the others take the channel's blocks
   by push, pull and state transfer, and each commits through
   `PrivDataCoordinator` over `TxValidator` into B1 (counted a peer);
   their states must be phase_endorse's.  `DiscoveryService` on Org1's
   peer (comm's RPC, mutual TLS) gives `benchcc`'s descriptor (four
   layouts, three of Org1-4); two blocks' worth of 1000 proposals, each
   endorsed at the peers `select_endorsers` picks, go back to back
   through one `Gateway` over `ab.BroadcastStream` to the orderers (a
   follower first), 10 txids resubmitted in flight (dedup), a raise at
   the 600th stream write (failover and the unresolved window
   resubmitted, its ordered copies DUPLICATE_TXID), Org5's peer stopped
   after the first worth and restarted after the second (state transfer
   alone).  Every status must be the peers' flag, the flags the
   prediction, the five peers' flags and states equal, one deliver
   client at a time; prints blocks by source, submit-to-commit p50 and
   p99, the window and failovers, committed tx/s, the leader-to-last
   commit lag, envelopes/s through the stream and the block sizes.
   A network from the command line (`phase_nodes`): the port's cryptogen
   and configtxgen write an orderer org's and Org1-3's material and a solo
   channel (phase_order's batch values) in this process; an orderer and
   three peers start as processes of `python -m fabric_tpu_torch.cmd.
   orderer` and `... cmd.peer node start` (each on its own root and
   operations port, the peers on `sampleconfig/core.yaml`, whose
   `bccsp.default: TPU` is CUDACSP on the card, with a KV chaincode by
   `--chaincode` spec and tracing armed), joined by `peer channel join`.
   Three worths of 1000 transactions (a read and a write each), each
   proposal endorsed at the three peers and each worth broadcast over one
   `ab.BroadcastStream`, the endorse cell's faults planted in the first
   (one endorsement of three where the channel's MAJORITY needs two);
   Org3's peer is killed (SIGKILL) in the second worth, after its
   endorsements, and started again on its root once the others hold the
   worth's block.  Every peer must reach the
   same height with the planted flags, equal at the three, the same state
   through `peer chaincode query`, /healthz OK, no device failure on
   /metrics, `tpu.collect` spans in its /traces whose lanes add up to each
   block's (their flushes give B1's `launches_nodes`), no module of the
   JAX package, and exit 0 on SIGTERM; prints each process's start-up,
   envelopes/s into the orderer, committed tx/s at each peer, each
   block's validate ms, the restarted peer's catch-up and B1's launches.
   Then, before the teardown, the tools pass, each step a process of the
   port's CLIs: `peer channel fetch config`, `configtxlator proto_decode`
   of the block, its envelope and payload down to `common.Config`, the
   Orderer group's BatchSize MaxMessageCount set from 1000 to 500 (the
   value's bytes built with the port's `orderer` schema), `proto_encode`
   and `compute_update`, `peer channel signconfigtx` by the orderer org's
   admin and `peer channel update`; one more worth of 1000 transactions
   over one `ab.BroadcastStream`; `discover peers` and `discover
   endorsers` against each peer and `discover config` against one.  Every
   peer's config sequence must move by one, the worth's blocks hold at
   most 500 transactions, B1's launches at each peer (from its
   `tpu.dispatch` spans: `launches_nodes_tools`) equal its chunks with
   every flush on `cuda:N`, and each peer list itself at the new height
   with `benchcc` and its endorser.
   The chaos harness (`phase_netharness`): the JAX package's soak
   topology (3 orgs x 2 peers, 3 raft orderers, each a process of
   `python -m fabric_tpu_torch.devtools.netnode`), 240 transactions under
   its seeded kill schedule (two peers and an orderer SIGKILLed and
   restarted) with netscope attached, judged by the invariants oracle on
   every peer; then a `faultfuzz.Campaign(seed=7, plans=5)`.  Both run
   the harness's fake identity plane, as the JAX package's do: no kernel.
   The port's fabriclint (`phase_lint`): `lint_tree(cache=False)` over
   the port's tree on this machine, clean (files, seconds, suppressions
   by rule, the guard map and the static lock graph printed); the
   headline commit and a snapshot `generate()` in a process armed with
   FABRIC_TPU_LOCKWATCH=1, whose lock-order edges must all be edges of
   the static graph, with no violation raised, and B1's launches counted
   from its `tpu.dispatch` spans (`launches_lockwatch`); the soak's
   verdict pinning `rpcmap_sha256` = `netharness.rpcmap_hash()`, its
   repro replayed to the same verdict (but for which killed nodes had
   anything to catch up), and `faultfuzz.export_registry()` equal to the
   checked-in `faultmap_registry.json`.
   Key custody (`phase_custody`): a `KeyCustodyServer` thread generates
   and holds 4 keys; a `CustodyCSP` whose local provider is `CUDACSP`
   signs 4000 digests through it (signs/s printed), then verifies them
   as one block-shaped `verify_batch` with 16 digests flipped (B1,
   counted) and 1200 lanes over 300 custody keys with 4 signatures
   flipped (B2, counted); each mask must be the planted one, the
   kernel's plain version's on the same packed lanes, and hostref's.
   Then the daemon as its CLI runs it (`python -m
   fabric_tpu_torch.cmd.custody` with a token file): 400 digests signed
   through it, a 100-lane block over 4 keys on B1 and one lane on each
   of 300 keys on B2 (4 tampered in each), the same checks, and exit 0
   on SIGTERM (`launches_custody_cli`).
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
   and P-384's sign and verify ms.  Then `idemixgen`, through its
   `main()`: `ca-keygen` and four `signerconfig` calls (member and admin,
   three OUs), the MSP from the issuer key it wrote, and 256 identity
   proofs of the four signer configs (8 tampered) in one batch on B3, its
   mask the planted one (`launches_idemixgen`).
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
   ordered-commit, joining-peer, custody (and its CLI), raft, endorse,
   gateway, nodes, tools-pass and lockwatch-armed paths, B2's on custody
   (and its CLI),
   raft and endorse, B3's with its launches on the idemix MSP's and
   idemixgen's batches, B4's with its launches at the snapshot's shape), then
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

    python3 chip_smoke.py --nodes

builds the kernels and the host library, then runs `phase_nodes` alone (a
network of the port's CLIs: the orderer and three peer processes).

    python3 chip_smoke.py --lint

builds the kernels and the host library, makes the validator's world and
blocks, then runs `phase_netharness` and `phase_lint` alone.

Exits non-zero, before printing any result, on a host without CUDA; any
failed phase raises.  Inputs are made from a seed (numpy for P-256 and
the validator's world, `random.Random` for idemix, as its API takes).
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import io
import json
import multiprocessing
import os
import queue
import random
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from fabric_tpu_torch import native
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.chaincode.shim import Chaincode
from fabric_tpu_torch.chaincode.shim import error as shim_error
from fabric_tpu_torch.chaincode.shim import success as shim_success
from fabric_tpu_torch.comm import RPCClient, RPCServer
from fabric_tpu_torch.comm.rpc import RPCError
from fabric_tpu_torch.comm.tls import TLSCredentials
from fabric_tpu_torch.common import configtx_builder as ctx
from fabric_tpu_torch.common import deliver
from fabric_tpu_torch.common import profile, tracing, workpool
from fabric_tpu_torch.common.channelconfig import bundle_from_genesis
from fabric_tpu_torch.common.crypto import CA, key_pem
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
from fabric_tpu_torch.orderer.multichannel import ChannelStepRouter, Registrar
from fabric_tpu_torch.orderer.raft import TCPTransport
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import orderer as ob
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
# B4's bound counts one compression's instructions on this card's
# instruction set, where a rotate is one funnel shift (SHF.R.W), logic of
# three inputs one LOP3 and an add of three one IADD3.  A round: Sigma1
# and Sigma0 (3 rotates and a LOP3 each), Ch and Maj (a LOP3 each): 10
# logic; T1 = h + Sigma1 + Ch + (K + W) (2 adds), e = d + T1 and
# a = T1 + Sigma0 + Maj: 4 adds.  A schedule step: sigma0 and sigma1 (2
# rotates, a shift and a LOP3 each): 8 logic; W (2 adds) and K + W: 3
# adds.  The first 16 K + W and the state's 8 adds end it.  So 1,024
# logic and 424 adds, 1,448 in all.
SHA_LOGIC_PER_COMPRESSION = 64 * 10 + 48 * 8
SHA_ADDS_PER_COMPRESSION = 64 * 4 + 48 * 3 + 16 + 8
# The rates they meet, from the CUDA C++ Programming Guide's throughput
# table for compute capability 9.0: 64 results a clock an SM for 32-bit
# shifts and bitwise operations (the integer pipe), and an add may go
# as an integer multiply-add (IMAD, 64 a clock an SM, on the FMA pipe),
# as the compiler does with part of them; the four schedulers of an SM
# dispatch at most 4 x 32 results a clock in all.  Times the SMs and the max
# SM clock that nvidia-smi reports.  (OPS_PER_S_32BIT, the float32 FMA
# rate counting an FMA as two, stays for B1-B3's IMAD.WIDE.)
INT32_RESULTS_PER_CLOCK_SM = 64
DISPATCH_RESULTS_PER_CLOCK_SM = 4 * 32
# The count the bound used before (source operations: 5 for each Sigma,
# Ch 4, Maj 5, every add apart; 64 rounds of ~25, 48 steps of ~13) over
# OPS_PER_S_32BIT, printed beside it once
SHA_SOURCE_OPS_PER_COMPRESSION = 64 * 25 + 48 * 13
# B4's alignment set: a message starting at every address mod 16, at each
# of these lengths (the padding edges and a few full blocks), and the
# ragged warp: one long message among 31 empty ones in one warp pair
HASH_ALIGN_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 200)
HASH_RAGGED_BYTES = 1 << 20
HASH_RAGGED_WARP = 32
# Messages of the batch wider than the card holds at once
HASH_MANY = (8192, 55)
# concurrent hash_batch callers on one provider, and their calls each
HASH_THREADS = 2
HASH_THREAD_CALLS = 4
# kernel_ms: bare launches between one pair of CUDA events
KERNEL_COUNT = 20

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


def kernel_ms(launch, reps: int = TIMING_REPS,
              count: int = KERNEL_COUNT) -> float:
    """A kernel's own milliseconds a launch: `launch` is the bare launch
    its wrapper makes (a prepared ctypes call on the current stream,
    returning the CUDA error code).  After a checked warm-up, `count`
    launches go back to back between one pair of CUDA events, behind a
    spin of the card long enough for the host to queue them all, so no
    host gap falls inside the window; the median of `reps` such windows,
    divided by `count`."""
    check(launch() == 0, "the kernel's launch failed")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(count * 40_000)  # ~20 us a launch to queue
        start.record()
        for _ in range(count):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def profiler_ms(launch, count: int = KERNEL_COUNT):
    """The device time a launch that torch.profiler's key_averages() give
    for `count` bare launches (ms), or None when it shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            launch()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        total_us += (getattr(evt, "self_device_time_total", 0)
                     or getattr(evt, "self_cuda_time_total", 0) or 0)
    return total_us / count / 1e3 if total_us > 0 else None


def timed_row(name: str, launch, wrapper, reps: int = TIMING_REPS) -> dict:
    """A kernel's kernel-only ms (`kernel_ms`), its profiler ms and its
    ms a wrapper call (CUDA events around one wrapper call), printed."""
    ms = kernel_ms(launch, reps)
    prof = profiler_ms(launch)
    wrapper_ms = cuda_ms(wrapper, reps)
    shown = "no device time" if prof is None else f"{prof:.4f} ms"
    print(f"{name}: kernel-only {ms:.4f} ms a launch ({KERNEL_COUNT} bare "
          f"launches between CUDA events, median of {reps}); profiler "
          f"{shown}; a wrapper call {wrapper_ms:.4f} ms")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "profiler_ms": prof}


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


def spread_items(rng, n: int, many_keys: int = MANY_KEYS) -> list:
    """n lanes signed by many_keys keys in turn: the batch that overflows
    the key table and takes the per-lane-key kernel."""
    many = [hostref.key_gen(rng) for _ in range(many_keys)]
    spread = []
    for i in range(n):
        key = many[i % many_keys]
        digest = hashlib.sha256(b"spread-%d" % i).digest()
        spread.append(VerifyBatchItem(
            key.public_key(), digest, hostref.sign(key, digest, rng)))
    return spread


def phase_main(rng, device, n_txs: int = N_TXS, n_blocks: int = N_BLOCKS,
               many_keys: int = MANY_KEYS):
    """The main path, counted; returns what the kernel timings need."""
    client, peers = block_world(rng)
    t0 = time.perf_counter()
    block = block_items(rng, client, peers[:ENDORSERS], n_txs)
    bad_block, bad = plant_bad(block)
    spread = spread_items(rng, n_txs * (1 + ENDORSERS), many_keys)
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
        timed = timed_row(name, pk.launcher(t)[0],
                          lambda: pk.verify_packed(t), reps)
        ms = timed["ms"]
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
            "wrapper_ms": timed["wrapper_ms"],
            "profiler_ms": timed["profiler_ms"],
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
    gen = idemixgen_pass(device, n)
    return {"launches": launches, "identities_per_s": n / deser_s,
            "nym_verifies_per_s": n_nym / verify_s,
            "p384_sign_ms": sign_ms, "p384_verify_ms": verify_ms,
            "launches_idemixgen": gen["launches"]}


def idemixgen_pass(device, n: int = MSP_IDENTITIES) -> dict:
    """The idemix material as `idemixgen` writes it: `ca-keygen`, then a
    `signerconfig` for each of MSP_SIGNERS (member and admin, two OUs and
    more), through its `main()` as phase_nodes calls cryptogen's; an idemix
    MSP from the issuer key it wrote (read back by `load_issuer`) and the
    first signer config, the four signer configs loaded into signing
    identities, and n identity proofs of those (MSP_TAMPERED's 8
    tampered) through one `IdemixCSP.verify_batch` on the card (B3,
    counted).  The mask must be the planted one, and the MSP must take
    an untampered identity and refuse a tampered one."""
    from fabric_tpu_torch.cmd import idemixgen

    rng = random.Random(SEED + 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_idemixgen_") as d:
        t0 = time.perf_counter()
        base = os.path.join(d, "idemix-config")
        with contextlib.redirect_stdout(io.StringIO()):
            check(idemixgen.main(["ca-keygen", "--output", base]) == 0,
                  "idemixgen ca-keygen failed")
            signers = []
            for k, (ou, role, eid) in enumerate(MSP_SIGNERS):
                out = os.path.join(d, f"signer{k}")
                shutil.copytree(os.path.join(base, "ca"),
                                os.path.join(out, "ca"))
                argv = ["signerconfig", "--output", out, "--org-unit", ou,
                        "--enrollment-id", eid]
                if role == idemixmsp.ROLE_ADMIN:
                    argv.append("--admin")
                check(idemixgen.main(argv) == 0,
                      f"idemixgen signerconfig {k} failed")
                with open(os.path.join(out, "user", "SignerConfig.pb"),
                          "rb") as f:
                    signers.append(mb.IdemixMSPSignerConfig.decode(f.read()))
        gen_s = time.perf_counter() - t0
        issuer = idemixgen.load_issuer(os.path.join(base, "ca",
                                                    "IssuerKey.pkl"))
    check([(sc.organizational_unit_identifier, sc.role,
            sc.enrollment_id.decode()) for sc in signers]
          == [(ou, role, eid) for ou, role, eid in MSP_SIGNERS],
          "the signer configs carry other attributes than asked")
    conf = idemixmsp.idemix_msp_config(issuer, "IdemixMSP", signers[0])
    msp = idemixmsp.IdemixMSP.from_config(mb.MSPConfig.decode(conf.encode()),
                                          rng=rng)
    t0 = time.perf_counter()
    ids = [idemixmsp.IdemixSigningIdentity(
        "IdemixMSP", int.from_bytes(sc.sk, "big"),
        Credential.from_bytes(sc.cred), issuer.ipk,
        sc.organizational_unit_identifier, sc.role, rng=rng)
        for j in range(n) for sc in (signers[j % len(signers)],)]
    ids_s = time.perf_counter() - t0
    step = n // len(MSP_TAMPERED)
    bad = {j * step + step // 3: how for j, how in enumerate(MSP_TAMPERED)}
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
    check([j for j, ok in enumerate(mask) if not ok] == sorted(bad),
          f"idemixgen batch: rejected "
          f"{[j for j, ok in enumerate(mask) if not ok]}, planted "
          f"{sorted(bad)}")
    check(launches > 0, f"{B3_NAME} did not launch on the idemixgen batch")
    good = next(j for j in range(n) if j not in bad)
    back = msp.deserialize_identity(ids[good].serialize())
    check((back.ou, back.role) == (ids[good].ou, ids[good].role),
          "the MSP does not take an idemixgen identity")
    tampered = identity_with(ids[sorted(bad)[0]].serialize(),
                             "proof:challenge")
    check(msp_verdicts(msp, [tampered])[0] == [None],
          "the MSP took a tampered idemixgen identity")
    print(f"idemixgen: ca-keygen and {len(signers)} signerconfig calls in "
          f"{gen_s:.2f} s; {n} identities of those signer configs in "
          f"{ids_s:.2f} s; their proofs ({len(bad)} tampered) through "
          f"IdemixCSP.verify_batch in {batch_s:.3f} s = {n / batch_s:.1f} "
          f"proofs/s; mask the planted one; {launches} launches of "
          f"{B3_NAME}; the MSP takes an identity and refuses a tampered "
          "one")
    return {"launches": launches}


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
    timed = timed_row(B3_NAME, bk.launcher(t)[0], lambda: bk.commitments(t),
                      reps)
    ms = timed["ms"]
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
        "wrapper_ms": timed["wrapper_ms"],
        "profiler_ms": timed["profiler_ms"],
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


def sm_clocks() -> tuple[float, float]:
    """The SM clock now and its max (MHz), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    now, top = (float(v) for v in out.split(","))
    return now, top


def b4_bound(msgs, device) -> tuple[float, str, float]:
    """(least ms, "bytes" or "operations", the figure the bound gave
    before) for hashing `msgs`: the messages and their offsets read once
    and the digests written once over the HBM rate, against the
    compressions they need, each SHA_LOGIC_PER_COMPRESSION shifts and
    logic on the integer pipe and SHA_ADDS_PER_COMPRESSION adds that may
    go to the FMA pipe: the larger of logic over
    INT32_RESULTS_PER_CLOCK_SM and all of them over
    DISPATCH_RESULTS_PER_CLOCK_SM, in clocks of an SM, over the SMs and the
    max SM clock.  The third figure is SHA_SOURCE_OPS_PER_COMPRESSION
    over OPS_PER_S_32BIT."""
    lens = np.array([len(m) for m in msgs], np.int64)
    comps = int(((lens + 9 + 63) // 64).sum())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clocks = max(SHA_LOGIC_PER_COMPRESSION / INT32_RESULTS_PER_CLOCK_SM,
                 (SHA_LOGIC_PER_COMPRESSION + SHA_ADDS_PER_COMPRESSION)
                 / DISPATCH_RESULTS_PER_CLOCK_SM)
    t_ops = comps * clocks / (sms * sm_clocks()[1] * 1e6) * 1e3
    nbytes = int(lens.sum()) + 8 * (len(msgs) + 1) + 32 * len(msgs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    before = max(comps * SHA_SOURCE_OPS_PER_COMPRESSION / OPS_PER_S_32BIT
                 * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", before
    return t_bytes, "bytes", before


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
    """The kernel's inputs: the messages joined on the card (a fresh
    allocation, so a message's offset mod 16 is its address's), their
    offsets pinned on the host."""
    buf, offs = sha.join_messages(msgs)
    return (torch.as_tensor(buf.copy(), device=device),
            torch.from_numpy(offs).pin_memory())


def b4_launch(msgs, device):
    """(B4's bare launch on `msgs`, the digests it writes): the messages
    and offsets on the card, as the wrapper hands them to the kernel."""
    t_buf, t_offs = upload_messages(msgs, device)
    out = torch.empty((len(msgs), 32), dtype=torch.uint8, device=device)
    return sha.launcher(t_buf, t_offs.to(device), out), out


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


def aligned_messages(rng, lengths=HASH_ALIGN_LENGTHS) -> list[bytes]:
    """A message of each length starting at every offset mod 16 of the
    joined buffer: between them, filler messages of 0-15 bytes (hashed
    and checked too) set where the next one starts."""
    lens = []
    pos = 0
    for start in range(16):
        for n in lengths:
            filler = (start - pos) % 16
            lens += [filler, n]
            pos += filler + n
    return random_messages(rng, np.array(lens))


def ragged_warp(rng, n_bytes: int = HASH_RAGGED_BYTES,
                lanes: int = HASH_RAGGED_WARP) -> list[bytes]:
    """One long message among lanes - 1 empty ones: one warp pair whose
    lanes but one are done after their first block."""
    msgs = [b""] * lanes
    msgs[lanes // 2 + 1] = random_messages(rng, np.array([n_bytes]))[0]
    return msgs


def hash_threads(csp: CUDACSP, batches: list,
                 calls: int = HASH_THREAD_CALLS) -> int:
    """Each batch hashed `calls` times through one provider by a thread of
    its own, all at once; every answer must be hashlib's.  Returns B4's
    launches."""
    want = [hashlib_digests(m) for m in batches]
    got: list = [None] * len(batches)
    errors: list = []

    def work(j):
        try:
            got[j] = [csp.hash_batch(batches[j]) for _ in range(calls)]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    sha.launches_sha256 = 0
    threads = [threading.Thread(target=work, args=(j,))
               for j in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"concurrent hash_batch raised: {errors[:1]}")
    for j, runs in enumerate(got):
        check(all(r == want[j] for r in runs),
              f"concurrent hash_batch, thread {j}: != hashlib")
    return sha.launches_sha256


def route_split(msgs, device, reps: int = TIMING_REPS) -> dict:
    """`CUDACSP.hash_batch`'s card route (`sha256_batch`) on `msgs` split
    by stage (each ending in a synchronise): stage (the messages written
    into a pinned tensor, the offsets), upload, kernel (the wrapper:
    offsets checked and copied, the launch), readback, digests (the list
    of bytes); ms, the median of `reps` runs after a warm-up."""
    runs = []
    for _ in range(reps + 1):
        times: dict = {}
        sha.sha256_batch(msgs, device, times)
        runs.append(times)
    return {k: statistics.median(r[k] for r in runs[1:]) * 1e3
            for k in runs[0]}


def wrapper_split(device, reps: int = 200) -> None:
    """Where a call of `sha256_digests` on one empty message spends its
    host time: each step's median microseconds over `reps` calls
    (perf_counter, a synchronise after each call), then the profiler's
    CPU ops over 20 calls."""
    from torch.profiler import ProfilerActivity, profile

    t_buf, t_offs = upload_messages([b""], device)
    steps = collections.defaultdict(list)
    for _ in range(reps):
        t = [time.perf_counter()]
        n = sha._check(t_buf, t_offs)
        t.append(time.perf_counter())
        d_offs = t_offs.to(device, non_blocking=True)
        t.append(time.perf_counter())
        out = torch.empty((n, 32), dtype=torch.uint8, device=device)
        t.append(time.perf_counter())
        launch = sha.launcher(t_buf, d_offs, out)
        t.append(time.perf_counter())
        launch()
        t.append(time.perf_counter())
        sha.sha256_digests(t_buf, t_offs)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        for name, a, b in zip(("check", "offsets to the card", "output",
                               "launcher (library, stream, pointers)",
                               "the launch (ctypes)", "a whole call"),
                              t, t[1:]):
            steps[name].append((b - a) * 1e6)
    print(f"{B4_NAME} wrapper, one empty message, host us a step (median "
          f"of {reps}): " + ", ".join(
              f"{k} {statistics.median(v):.1f}" for k, v in steps.items()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            sha.sha256_digests(t_buf, t_offs)
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
    print(f"{B4_NAME} wrapper, profiler over 20 calls (us a call): " +
          ", ".join(f"{e.key} cpu {e.cpu_time_total / 20:.1f} device "
                    f"{(getattr(e, 'device_time_total', 0) or 0) / 20:.1f}"
                    for e in rows[:8]))


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
                     reps: int = TIMING_REPS) -> int:
    """hash_batch's routing rule (`provider.hash_on_card`) against both
    routes' times, the card's (`sha256_batch`: stage, upload, B4,
    readback) and hashlib's, on batches either side of its boundary;
    returns the shapes where the rule took the slower route."""
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
    print(f"hash route: the rule (HASH_WIDTH {cuda_provider.HASH_WIDTH}, "
          f"HASH_FIXED {cuda_provider.HASH_FIXED}) took the slower route "
          f"on {wrong} of {len(shapes)} shapes")
    return wrong


def phase_sha256(rng, device, errs: dict, n_wide: int = HASH_WIDE_MSGS,
                 edge_lengths=HASH_EDGE_LENGTHS,
                 files=HASH_SNAPSHOT_FILES, reps: int = TIMING_REPS,
                 plain_reps: int = PLAIN_REPS) -> dict:
    """B4: hash_batch at its callers' shapes (hashlib answers); the wide
    batch through `CUDACSP.hash_batch` on the card, counted; two threads
    through one provider at once; the kernel against hashlib and
    sha256_plain on the edge lengths, the alignment set, a ragged warp,
    the wide batch and the snapshot's files; the kernel timed apart from
    its wrapper (kernel_ms) and with it, hash_batch split by stage beside
    hashlib on the wide batch, the kernel and hashlib on the snapshot's
    files; the routing rule against both routes.  Returns
    the kernels-line row."""
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
    halves = [wide[:n_wide // 2], wide[n_wide // 2:]]
    check(all(hash_on_card(h) for h in halves), "a half of the wide batch "
          "does not take the card route")
    both = hash_threads(csp, halves[:HASH_THREADS])
    print(f"hash card route: {HASH_THREADS} threads x {HASH_THREAD_CALLS} "
          f"hash_batch calls of {len(halves[0])} messages through one "
          f"provider at once: == hashlib, {both} launches of {B4_NAME}")
    compare_b4("edges", edge, device, errs)
    compare_b4("alignment", aligned_messages(rng), device, errs)
    compare_b4("ragged warp", ragged_warp(rng), device, errs)
    compare_b4("wide", wide, device, errs)
    compare_b4("snapshot files", snapshot, device, errs)

    t_buf, t_offs = upload_messages(wide, device)
    timed = timed_row(f"{B4_NAME} wide", b4_launch(wide, device)[0],
                      lambda: sha.sha256_digests(t_buf, t_offs), reps)
    ms = timed["ms"]
    call_ms = host_ms(lambda: csp.hash_batch(wide), reps)
    lib_ms = host_ms(lambda: hashlib_digests(wide), reps)
    split = route_split(wide, device, reps)
    bound_ms, bound_by, fp32_ms = b4_bound(wide, device)
    nbytes = sum(map(len, wide))
    print(f"{B4_NAME} wide: {n_wide} messages, {nbytes} bytes: kernel "
          f"{ms:.4f} ms ({nbytes / ms / 1e6:.2f} GB/s), a wrapper call "
          f"{timed['wrapper_ms']:.4f} ms, hash_batch {call_ms:.3f} ms, "
          f"hashlib {lib_ms:.3f} ms ({nbytes / lib_ms / 1e6:.2f} GB/s), "
          f"bound {bound_ms:.4f} ms ({bound_by}: instructions on the "
          f"integer and FMA pipes; {ms / bound_ms:.1f}x), {fp32_ms:.4f} ms "
          f"by the source operations at the float32 rate used before")
    print(f"{B4_NAME} wide: hash_batch's card route by stage (ms, median "
          f"of {reps}, a synchronise after each): " + ", ".join(
              f"{k} {v:.3f}" for k, v in split.items()) +
          f"; {sum(split.values()):.3f} in all, hashlib {lib_ms:.3f}")
    wrapper_split(device)
    for label, msgs in (("lone 4500 bytes", [bytes(4500)]),
                        ("2048 x 55 bytes", [bytes(55)] * 2048),
                        (f"{HASH_MANY[0]} x {HASH_MANY[1]} bytes",
                         [bytes(HASH_MANY[1])] * HASH_MANY[0])):
        kms = kernel_ms(b4_launch(msgs, device)[0], reps)
        print(f"{B4_NAME} {label}: kernel-only {kms:.4f} ms")
    s_buf, s_offs = upload_messages(snapshot, device)
    s_ms = kernel_ms(b4_launch(snapshot, device)[0], reps)
    s_lib = host_ms(lambda: hashlib_digests(snapshot), reps)
    print(f"{B4_NAME} snapshot files: {len(snapshot)} files, "
          f"{sum(map(len, snapshot))} bytes: kernel {s_ms:.3f} ms, hashlib "
          f"{s_lib:.3f} ms (a lane a file; hash_batch takes hashlib)")
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
        "wrapper_ms": timed["wrapper_ms"],
        "profiler_ms": timed["profiler_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ms_fp32_rate": fp32_ms,
        "library_ms": None,  # no single PyTorch call computes SHA-256
        "hashlib_ms": lib_ms,
        "hash_batch_ms": call_ms,
        "chain_floor_ms": chain,
        "launches_threads": both,
    }


def sass_spans(instrs: list[str]) -> list[list[str]]:
    """Every backward branch's span of a kernel's SASS, from its target
    to the branch."""
    addr = [int(i[2:i.index("*/")], 16) for i in instrs]
    spans = []
    for k, instr in enumerate(instrs):
        m = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", instr)
        if m and int(m.group(1), 16) < addr[k]:
            spans.append(instrs[addr.index(int(m.group(1), 16)):k + 1])
    return spans


def b4_sass(path) -> tuple[list[str], list[str]]:
    """The kernel's two loops in the built library `path`, told
    apart by what they hold: (the consumer's block loop, with its shared
    loads, LDS; the producer's, with its shared stores, STS).  A span
    holding both is a barrier's retry branch, placed after both."""
    kernels = build.sass(path)
    name = next(k for k in kernels if "sha256_pair_kernel" in k)
    spans = sass_spans(kernels[name])

    def only(op, other):
        return max((sp for sp in spans
                    if any(opcode(i).startswith(op) for i in sp)
                    and not any(opcode(i).startswith(other) for i in sp)),
                   key=len)

    return only("LDS", "STS"), only("STS", "LDS")


def b4_chain_floor(wide, device, reps: int = TIMING_REPS) -> float:
    """B4's serial-chain floor: a message's compressions are one chain,
    so a batch takes at least its longest message's compressions times
    one compression's latency.  That latency is timed on the card with a
    lone message (one of the longest length against one of 0 bytes,
    kernel-only), and set beside the SASS of the consumer's and the
    producer's loops and the SM clock; returns the floor in ms."""
    longest = max(len(m) for m in wide)
    n_long = (longest + 72) >> 6  # compressions, padding in
    t = {name: kernel_ms(b4_launch(m, device)[0], reps)
         for name, m in (("long", [bytes(longest)]), ("short", [b""]))}
    per = (t["long"] - t["short"]) / (n_long - 1)
    floor = n_long * per
    now, top = sm_clocks()
    consumer, producer = b4_sass(build.build_all()["sha256"])
    cycles = per * 1e-3 * top * 1e6
    print(f"{B4_NAME} serial chain: one message, {longest} bytes "
          f"({n_long} compressions) {t['long']:.4f} ms, 0 bytes (1) "
          f"{t['short']:.4f} ms, kernel-only: {per * 1e3:.3f} us a "
          f"compression; the consumer's loop is {len(consumer)} SASS "
          f"instructions ({sass_summary(consumer)}), the producer's "
          f"{len(producer)} ({sass_summary(producer)}), "
          f"{len(consumer) + len(producer)} in all a compression; SM clock "
          f"{now:.0f}, {top:.0f} MHz (now, max): ~{cycles:.0f} cycles a "
          f"compression at the max clock, {cycles / len(consumer):.2f} a "
          f"consumer instruction; floor {n_long} x {per * 1e3:.3f} us = "
          f"{floor:.4f} ms for the wide batch's longest message")
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
    orderer_ca: CA | None = None  # the orderer org's CA (OrdererMSP)

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
    return ValidatorWorld(genesis.encode(), client, peers, rng, oca)


def orderer_identity(world: ValidatorWorld, name: str = "orderer0",
                     ou: str = "orderer") -> SigningIdentity:
    """A new OrdererMSP identity from the world's orderer CA (its key and
    serial drawn from the world's generator)."""
    pair = world.orderer_ca.issue(name, ous=[ou])
    return SigningIdentity("OrdererMSP", pair.cert, pair.key, world.rng)


def order_genesis(world: ValidatorWorld, max_message_count: int,
                  preferred_max_bytes: int, absolute_max_bytes: int,
                  batch_timeout: str, consensus_type: str = "solo",
                  consensus_metadata: bytes = b"",
                  channel_id: str = VALIDATOR_CHANNEL) -> bytes:
    """The world's genesis block minted again with the orderer's
    ConsensusType (its type and metadata), BatchSize and BatchTimeout set
    (the same orgs and policies; the same channel unless `channel_id`
    names another)."""
    config = bundle_from_genesis(world.genesis).config
    group = config.channel_group
    ordg = ctx.orderer_group(
        group.groups["Orderer"].groups, consensus_type=consensus_type,
        consensus_metadata=consensus_metadata,
        max_message_count=max_message_count,
        absolute_max_bytes=absolute_max_bytes,
        preferred_max_bytes=preferred_max_bytes, batch_timeout=batch_timeout)
    genesis = ctx.genesis_block(
        channel_id,
        ctx.channel_group(group.groups["Application"], ordg),
        nonce=hashlib.sha256(world.genesis).digest()[:24],
        timestamp=VALIDATOR_TS)
    return genesis.encode()


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


def check_mask_host(csp: RecordingCSP, label: str) -> int:
    """Holds every recorded verify mask against the provider's host route
    (`native.ecdsa_verify_host`, libcrypto, whose verdicts are hostref's;
    hostref where it does not load); returns the lane count."""
    t1 = time.perf_counter()
    items = [it for b, _ in csp.batches for it in b]
    mask = [ok for _, m in csp.batches for ok in m]
    want = cuda_provider._host_verify_batch(hostref, items)
    check(mask == want, f"the {label}'s verify mask differs from the host "
          f"route's on {sum(a != b for a, b in zip(mask, want))} lanes")
    print(f"{label}: verify mask of {len(items)} lanes equal to the host "
          f"route's ({native.ecdsa_impl()}, {time.perf_counter() - t1:.1f} "
          "s)")
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
# The ordered commit cell: the port's orderer cuts and signs the blocks,
# the deliver client streams them into the committer.
# ---------------------------------------------------------------------------

ORDER_MAX_COUNT = 1000  # BatchSize.MaxMessageCount: the count cuts
ORDER_PREFERRED = 8 << 20  # above 1000 envelopes of ~4.3 KB
ORDER_ABSOLUTE = 10 << 20
ORDER_TIMEOUT = "2s"  # cuts the last, partial batch; never a full one
ORDER_COMM_BLOCKS = 2  # blocks of the pass over comm's RPC
ORDER_CA_SEED = 17
ORDER_STATUS = {pb.BAD_CREATOR_SIGNATURE: cb.FORBIDDEN,
                pb.BAD_PAYLOAD: cb.BAD_REQUEST}


def order_refusals(expect: dict) -> dict:
    """The broadcast status of each envelope the orderer refuses, by
    (block index, tx): the creator's bad signature fails the signature
    filter (FORBIDDEN), the truncated payload does not decode
    (BAD_REQUEST); the other planted faults are the peer's to find."""
    return {k: ORDER_STATUS[f] for k, f in expect.items()
            if f in ORDER_STATUS}


class FullCollections:
    """Records the wall of each full (generation 2) garbage collection
    while it is entered: a pause every thread of the process waits out."""

    def __init__(self):
        self.pauses: list = []
        self._t = 0.0

    def _callback(self, phase, info):
        if info["generation"] == 2:
            if phase == "start":
                self._t = time.perf_counter()
            else:
                self.pauses.append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False


class Timed:
    """Wraps a callable and sums the seconds spent in it."""

    def __init__(self, fn):
        self.fn = fn
        self.s = 0.0
        self.n = 0

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.s += time.perf_counter() - t
            self.n += 1


def state_pairs(ledger) -> list:
    """The (key, value) pairs of VALIDATOR_CC's state, versions aside."""
    return list(ledger.get_state_range(VALIDATOR_CC, "", ""))


@dataclasses.dataclass
class ChainView:
    """What a DeliverService reads of a channel."""

    store: object  # height, get_block_by_number
    bundle: object


def tampering(endpoint):
    """An endpoint whose first stream starts with its first block's
    orderer signature flipped; later streams pass through."""
    opened = [0]

    def connect(start):
        opened[0] += 1
        for k, blk in enumerate(endpoint(start)):
            if opened[0] == 1 and k == 0:
                blk = cb.Block.decode(blk.encode())
                meta = cb.Metadata.decode(blk.metadata.metadata[cb.SIGNATURES])
                sig = bytearray(meta.signatures[0].signature)
                sig[8] ^= 0x40
                meta.signatures[0].signature = bytes(sig)
                blk.metadata.metadata[cb.SIGNATURES] = meta.encode()
            yield blk

    return connect


def phase_order(device, world: ValidatorWorld, blocks: list, expect: dict,
                com: dict, tmp: str, depth: int = DEPTH) -> dict:
    """The commit cell's envelopes ordered by the port: one thread
    broadcasts them through `BroadcastHandler.process_message` into a
    solo `Registrar` (MaxMessageCount 1000, the orderer's identity from
    the world's orderer CA), while a `DeliverClient` over an in-process
    `DeliverService` (two endpoints, each of whose first stream carries a
    block with a flipped signature) streams the blocks into
    `Committer.store_stream` on an on-disk KVLedger with CUDACSP, B1
    counted.  The refused envelopes and their statuses must be the
    predicted ones, every delivered block's signature must verify, each
    admitted transaction's flag and the state's keys and values must be
    phase_commit's, and the mask the host route's.  Then ORDER_COMM_BLOCKS
    blocks again, to a second peer, over comm's RPCServer under mutual
    TLS (`deliver_response_frames`), and their FilteredBlocks
    (`deliver_filtered_frames` on the first peer's ledger): flags and
    FilteredBlocks must equal the in-process pass's."""
    from fabric_tpu_torch.comm import RPCClient, RPCServer
    from fabric_tpu_torch.comm.tls import credentials_from_ca
    from fabric_tpu_torch.common import deliver
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.orderer.blockwriter import verify_block_signature
    from fabric_tpu_torch.orderer.broadcast import BroadcastHandler
    from fabric_tpu_torch.orderer.multichannel import Registrar
    from fabric_tpu_torch.peer.committer import Committer
    from fabric_tpu_torch.peer.deliverclient import DeliverClient
    from fabric_tpu_torch.protos import orderer as ob

    os.environ["FABRIC_TPU_WAL_CHECKPOINT"] = WAL_CHECKPOINT
    envs, keys = [], []
    for b, raw in enumerate(blocks):
        for i, env in enumerate(cb.Block.decode(raw).data.data):
            envs.append(env)
            keys.append((b, i))
    sizes = [len(e) for e in envs]
    predicted = order_refusals(expect)
    admitted = [k for k in keys if k not in predicted]
    print(f"order: {len(envs)} envelopes of {min(sizes)}-{max(sizes)} bytes "
          f"({statistics.mean(sizes):.0f} mean; the first "
          f"{ORDER_MAX_COUNT}: {sum(sizes[:ORDER_MAX_COUNT])} bytes); "
          f"BatchSize {ORDER_MAX_COUNT} messages, PreferredMaxBytes "
          f"{ORDER_PREFERRED}, AbsoluteMaxBytes {ORDER_ABSOLUTE}, "
          f"BatchTimeout {ORDER_TIMEOUT}; predicted refusals "
          f"{sorted(predicted.items())}")
    check(sum(sizes[:ORDER_MAX_COUNT]) < ORDER_PREFERRED
          and max(sizes) < ORDER_ABSOLUTE, "the batch size does not let "
          "the count cut")
    genesis_raw = order_genesis(world, ORDER_MAX_COUNT, ORDER_PREFERRED,
                                ORDER_ABSOLUTE, ORDER_TIMEOUT)
    genesis = cb.Block.decode(genesis_raw)
    bundle = bundle_from_genesis(genesis_raw)
    orderer = orderer_identity(world)
    sign = orderer.sign = Timed(orderer.sign)
    root = os.path.join(tmp, "order")
    reg = Registrar(os.path.join(root, "orderer"),
                    new_cuda_csp(device=device), signer=orderer)
    reg.startup([genesis])
    support = reg.get_chain(VALIDATOR_CHANNEL)
    create = support.writer.create_next_block = Timed(
        support.writer.create_next_block)
    write = support.writer.write_block = Timed(support.writer.write_block)
    sig_filter = support.processor._sig_filter = Timed(
        support.processor._sig_filter)
    svc = deliver.DeliverService(reg.get_chain, new_cuda_csp(device=device))
    ordered: list = []  # the envelopes of each block written, in order
    written_at: dict = {}

    def on_block(channel, blk):
        written_at[blk.header.number] = time.perf_counter()
        ordered.append(len(blk.data.data))
        svc.notifier.notify()

    reg.add_block_listener(on_block)
    policy = bundle.policy_manager.get_policy(
        "/Channel/Orderer/BlockValidation")
    csp = RecordingCSP(new_cuda_csp(device=device))
    # warm-up in a ledger of its own, not timed (as phase_commit's)
    warm_provider = LedgerProvider(os.path.join(root, "warm"))
    warm = warm_provider.create(cb.Block.decode(world.genesis))
    Committer(TxValidator(VALIDATOR_CHANNEL, warm, bundle, csp), warm) \
        .store_block(validator_blocks(world, 1, 64, world.genesis_hash,
                                      plant=False)[0][0])
    warm_provider.close()
    provider = LedgerProvider(os.path.join(root, "peer"), csp=csp)
    ledger = provider.create(genesis)
    validator = TxValidator(VALIDATOR_CHANNEL, ledger, bundle, csp)
    committer = Committer(validator, ledger)

    def endpoint(start):
        env = deliver.make_seek_info_envelope(
            VALIDATOR_CHANNEL, start, 1 << 62, signer=world.client)
        return (value for kind, value in svc.deliver(env) if kind == "block")

    inbox: queue.Queue = queue.Queue()
    sunk = [1]  # the peer's next height
    arrived_at: dict = {}

    def sink(seq, raw):
        arrived_at[seq] = time.perf_counter()
        sunk[0] = seq + 1
        inbox.put(raw)

    client = DeliverClient(VALIDATOR_CHANNEL,
                           [tampering(endpoint), tampering(endpoint)],
                           lambda: sunk[0], sink, bundle=bundle,
                           csp=csp.inner)
    verify = client._verify = Timed(client._verify)
    flags: list = []
    durable: list = []
    committer.add_commit_listener(
        lambda block, f: durable.append(time.perf_counter()))

    def commit():
        for f in committer.store_stream(iter(inbox.get, None), depth=depth):
            flags.append(list(f))

    committing = threading.Thread(target=commit, name="order-commit")
    csp.reset()
    csp.inner.drain()
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0
    torch.cuda.synchronize()
    gc_watch = FullCollections()
    t0 = time.perf_counter()
    with gc_watch:
        committing.start()
        client.start()
        handler = BroadcastHandler(reg)
        statuses, longest = [], 0.0
        last = time.perf_counter()
        for e in envs:
            statuses.append(handler.process_message(cb.Envelope.decode(e)))
            now = time.perf_counter()
            longest, last = max(longest, now - last), now
        t_broadcast = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while sum(ordered) < len(admitted) and time.monotonic() < deadline:
            time.sleep(0.005)
        t_ordered = time.perf_counter() - t0
        n_blocks = len(ordered)
        while sunk[0] <= n_blocks and time.monotonic() < deadline:
            time.sleep(0.005)
        inbox.put(None)
        committing.join(timeout=max(1.0, deadline - time.monotonic()))
        csp.inner.drain()
    pauses = gc_watch.pauses
    launches = {B1_NAME: pk.launches_keytab, B2_NAME: pk.launches_lanekeys}
    svc.stop()
    client.stop()
    reg.halt_all()
    check(not committing.is_alive() and len(flags) == n_blocks,
          f"{len(flags)} of {n_blocks} ordered blocks committed")

    got_refused = {keys[j]: s for j, s in enumerate(statuses)
                   if s != cb.SUCCESS}
    check(got_refused == predicted, f"refused {sorted(got_refused.items())},"
          f" predicted {sorted(predicted.items())}")
    check(ordered == [ORDER_MAX_COUNT] * (len(admitted) // ORDER_MAX_COUNT)
          + ([len(admitted) % ORDER_MAX_COUNT]
             if len(admitted) % ORDER_MAX_COUNT else []),
          f"blocks of {ordered} envelopes (the longest broadcast call "
          f"{longest * 1e3:.1f} ms; the timer cuts after {ORDER_TIMEOUT})")
    check(launches[B1_NAME] > 0, f"B1 did not launch on the order path: "
          f"{launches}")
    check(verify.n == n_blocks + 2, f"the deliver client checked "
          f"{verify.n} blocks, {n_blocks} delivered and 2 tampered "
          f"(endpoints {list(client.endpoint_log)}, backoffs "
          f"{list(client.backoff_log)})")
    log = list(client.endpoint_log)
    check(len(log) >= 3 and log[0] != log[1] and log[2] == log[0],
          f"the deliver client's rotation {log}")
    # every committed block: the orderer's, its signature valid
    sig_ok = 0
    for n in range(1, n_blocks + 1):
        blk = ledger.get_block_by_number(n)
        sig_ok += verify_block_signature(blk, policy, hostref.HostCSP())
    check(sig_ok == n_blocks, f"{n_blocks - sig_ok} committed blocks fail "
          "the BlockValidation policy")
    data_hashes = [bytes(ledger.get_block_by_number(n).header.data_hash)
                   for n in range(1, n_blocks + 1)]
    got_flags = [f for block in flags for f in block]
    want_flags = [com["flags"][b][i] for b, i in admitted]
    differ = sum(a != b for a, b in zip(got_flags, want_flags))
    check(got_flags == want_flags, "the ordered commit's flags differ from "
          f"phase_commit's on {differ} transactions")
    base_provider = LedgerProvider(com["root"])
    want_state = state_pairs(base_provider.open(VALIDATOR_CHANNEL))
    base_provider.close()
    got_state = state_pairs(ledger)
    check(got_state == want_state, f"the ordered commit's state ("
          f"{len(got_state)} keys) differs from phase_commit's "
          f"({len(want_state)} keys)")
    lanes = check_mask_host(csp, "order")
    n_tx = len(admitted)
    valid = got_flags.count(pb.VALID)
    peer_wall = durable[-1] - t0
    peer_own = durable[-1] - arrived_at[1]
    latency = [arrived_at[n] - written_at[n] for n in range(1, n_blocks + 1)]

    # the pass over comm's RPC: blocks 1-2 to a second peer, and the first
    # peer's FilteredBlocks
    peer_svc = deliver.DeliverService(
        lambda ch: (ChainView(ledger, bundle) if ch == VALIDATOR_CHANNEL
                    else None), csp.inner)
    order_svc = deliver.DeliverService(reg.get_chain, csp.inner)
    ca = CA("tlsca.order.example.com", "order.example.com",
            rng=np.random.default_rng(ORDER_CA_SEED))
    server = RPCServer(tls=credentials_from_ca(ca, "orderer"))
    server.register("orderer.Deliver", lambda body, stream:
                    deliver.deliver_response_frames(order_svc, body))
    server.register("peer.DeliverFiltered", lambda body, stream:
                    deliver.deliver_filtered_frames(peer_svc, body))
    server.start()
    peer_tls = credentials_from_ca(ca, "peer")
    check(server.tls.require_client_auth and peer_tls.verify_server_name,
          "the deliver pass is not mutual TLS")
    last = ORDER_COMM_BLOCKS
    try:
        def remote(start):
            env = deliver.make_seek_info_envelope(
                VALIDATOR_CHANNEL, start, last, signer=world.client,
                behavior=ob.SeekInfo.FAIL_IF_NOT_READY)
            for frame in RPCClient(*server.addr, tls=peer_tls).stream(
                    "orderer.Deliver", env.encode()):
                resp = ob.DeliverResponse.decode(frame)
                if resp.which("Type") == "block":
                    yield resp.block

        csp2 = new_cuda_csp(device=device)
        provider2 = LedgerProvider(os.path.join(root, "peer2"), csp=csp2)
        ledger2 = provider2.create(genesis)
        got2: list = []
        t1 = time.perf_counter()
        client2 = DeliverClient(VALIDATOR_CHANNEL, [remote],
                                lambda: 1 + len(got2),
                                lambda seq, raw: got2.append(raw),
                                bundle=bundle, csp=csp2)
        client2.start()
        stop_at = time.monotonic() + 30
        while len(got2) < last and time.monotonic() < stop_at:
            time.sleep(0.005)
        client2.stop()
        fetch_s = time.perf_counter() - t1
        check(len(got2) == last, f"{len(got2)} of {last} blocks over RPC")
        csp2.drain()
        pk.launches_keytab = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flags2 = [list(f) for f in Committer(TxValidator(
            VALIDATOR_CHANNEL, ledger2, bundle, csp2), ledger2)
            .store_stream(got2[:last], depth=depth)]
        csp2.drain()
        comm_wall = time.perf_counter() - t1
        comm_launches = pk.launches_keytab
        check(comm_launches > 0, "B1 did not launch on the RPC pass")
        check(flags2 == flags[:last], "the RPC pass's flags differ from "
              "the in-process pass's")
        env = deliver.make_seek_info_envelope(
            VALIDATOR_CHANNEL, 1, last, signer=world.client,
            behavior=ob.SeekInfo.FAIL_IF_NOT_READY)
        filtered = [pb.DeliverResponse.decode(f) for f in RPCClient(
            *server.addr, tls=peer_tls).stream("peer.DeliverFiltered",
                                               env.encode())]
        check([r.which("Type") for r in filtered] == ["filtered_block"]
              * last + ["status"] and filtered[-1].status == cb.SUCCESS,
              "the filtered stream's responses")
        for n, resp in enumerate(filtered[:last], 1):
            want = deliver.filter_block(ledger.get_block_by_number(n))
            check(resp.filtered_block.encode() == want.encode()
                  and deliver.filter_block(ledger2.get_block_by_number(n))
                  .encode() == want.encode(), f"FilteredBlock {n} differs")
            check([t.tx_validation_code for t in
                   resp.filtered_block.filtered_transactions]
                  == flags[n - 1], f"FilteredBlock {n}'s codes")
        provider2.close()
    finally:
        server.stop()
        provider.close()
    sig_s = sig_filter.s
    per_block = (create.s + write.s) / n_blocks
    print(f"order: broadcast {len(envs)} envelopes in {t_broadcast * 1e3:.1f}"
          f" ms = {len(envs) / t_broadcast:.0f} envelopes/s (the signature "
          f"filter {sig_s * 1e3:.1f} ms, {sig_s / t_broadcast:.1%}; the "
          f"longest call {longest * 1e3:.1f} ms; {len(pauses)} full garbage "
          f"collections in the run, the longest "
          f"{max(pauses, default=0.0) * 1e3:.1f} ms); statuses "
          f"{dict(sorted(collections.Counter(statuses).items()))}, the "
          f"refused ones as predicted")
    print(f"order: {n_blocks} blocks cut ({ordered} envelopes), the last "
          f"ordered {t_ordered * 1e3:.1f} ms from the start; on the orderer "
          f"{per_block * 1e3:.2f} ms a block to cut, sign and write "
          f"(create_next_block {create.s / n_blocks * 1e3:.2f}, write_block "
          f"{write.s / n_blocks * 1e3:.2f}, of it signing "
          f"{sign.s / max(sign.n, 1) * 1e3:.2f})")
    print(f"order: deliver, a block written to its hand-off to the peer: "
          f"median {statistics.median(latency) * 1e3:.2f} ms, blocks 2-"
          f"{n_blocks} max {max(latency[1:], default=0) * 1e3:.2f} ms, block "
          f"1 {latency[0] * 1e3:.1f} ms (two refusals and their backoffs); "
          f"the client's signature check {verify.s / verify.n * 1e3:.2f} ms "
          f"a block; 2 tampered blocks refused, endpoints {log[:3]}, backoffs"
          f" {list(client.backoff_log)[:2]}; {sig_ok} committed blocks pass "
          "/Channel/Orderer/BlockValidation")
    print(f"order: peer committed {n_tx} transactions ({valid} VALID) in "
          f"{peer_wall * 1e3:.1f} ms from the first broadcast = "
          f"{n_tx / peer_wall:.0f} committed tx/s; from the first block in "
          f"to the last durable {peer_own * 1e3:.1f} ms = "
          f"{peer_own / n_blocks * 1e3:.1f} ms a block; {lanes} verify "
          f"lanes; launches {launches}; flags and state (keys and values) "
          "phase_commit's")
    print(f"order: over RPC (mutual TLS, loopback) {last} blocks delivered "
          f"in {fetch_s * 1e3:.1f} ms and committed in {comm_wall * 1e3:.1f}"
          f" ms with {comm_launches} launches of {B1_NAME}; flags and "
          f"FilteredBlocks the in-process pass's")
    return {"launches": launches, "wall_s": peer_wall, "blocks": n_blocks,
            "broadcast_s": t_broadcast, "comm_launches": comm_launches,
            "data_hashes": data_hashes}


# ---------------------------------------------------------------------------
# Raft: the commit cell's envelopes ordered by a 3-node raft cluster over
# pinned mutual TLS, through a planted leader halt and a restart; then
# execute-order-validate: three endorsing peers, `_lifecycle`, a shim
# chaincode, the same cluster, deliver and the committer with B1.
# ---------------------------------------------------------------------------

RAFT_TICK_MS = 500  # Fabric's sampleconfig/orderer.yaml: TickInterval 500ms,
RAFT_ELECTION_TICK = 10  # ElectionTick 10,
RAFT_HEARTBEAT_TICK = 1  # HeartbeatTick 1,
RAFT_MAX_INFLIGHT = 5  # MaxInflightBlocks 5,
RAFT_SNAPSHOT_BYTES = 16 << 20  # SnapshotIntervalSize 16 MB
RAFT_NODES = (1, 2, 3)
RAFT_HALT_AFTER = 4  # the leader halts once this block is on all three
RAFT_CA_SEED = 19
RAFT_WAIT_S = 60.0  # the longest wait for any one step
ENDORSE_CHANNEL = "endorsech"  # phase_endorse's channel, on the same cluster
ENDORSE_TXS = 1000  # proposals a block
ENDORSE_BLOCKS = 2
ENDORSE_SEED = 23
ENDORSE_POLICY = ("OutOf(3, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer', "
                  "'Org4MSP.peer', 'Org5MSP.peer')")


def raft_metadata(ports: dict, certs: dict) -> bytes:
    """The etcdraft ConsensusType metadata: the consenters on 127.0.0.1
    with their TLS certificates, and the sample config's options."""
    return ob.ConfigMetadata(
        consenters=[ob.Consenter(id=n, host="127.0.0.1", port=ports[n],
                                 client_tls_cert=certs[n],
                                 server_tls_cert=certs[n])
                    for n in sorted(ports)],
        options=ob.Options(tick_interval_ms=RAFT_TICK_MS,
                           election_tick=RAFT_ELECTION_TICK,
                           heartbeat_tick=RAFT_HEARTBEAT_TICK,
                           max_inflight_blocks=RAFT_MAX_INFLIGHT,
                           snapshot_interval_size=RAFT_SNAPSHOT_BYTES)
    ).encode()


def wait_for(pred, what: str, timeout: float = RAFT_WAIT_S,
             on_timeout=None, poll: float = 0.02) -> float:
    """Polls `pred` every `poll` seconds; fails the run after `timeout`
    (with what `on_timeout()` says of the state); returns the seconds
    waited."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            state = on_timeout() if on_timeout is not None else ""
            check(False, f"timed out after {timeout} s waiting for {what} "
                  f"{state}")
        time.sleep(poll)
    return time.perf_counter() - t0


class RaftStats:
    """What the cluster's chains did, recorded by wrappers on each
    chain: elections won, blocks proposed, WAL saves, applies,
    snapshots."""

    def __init__(self):
        self.elections: list = []  # (perf time, channel, node, term)
        self.cut: dict = collections.defaultdict(float)  # channel -> s
        self.proposed: dict = collections.defaultdict(list)  # (ch) -> [s]
        self.wal_block: dict = collections.defaultdict(list)  # leader saves
        self.applied_at: dict = {}  # (channel, node, block) -> perf time
        self.apply_s: dict = collections.defaultdict(list)  # (ch, node)
        self.snapshots: dict = collections.defaultdict(int)  # (ch, node)

    def watch(self, channel: str, nid: int, cs) -> None:
        chain = cs.chain
        node = chain.node
        won = node._become_leader

        def become_leader():
            won()
            self.elections.append((time.monotonic(), channel, nid,
                                   node.term))

        node._become_leader = become_leader
        cut = cs.cutter.ordered

        def ordered(env_bytes):
            t = time.monotonic()
            try:
                return cut(env_bytes)
            finally:
                self.cut[channel] += time.monotonic() - t

        cs.cutter.ordered = ordered
        propose = chain._propose_batch

        def propose_batch(batch, is_config=False):
            t = time.monotonic()
            propose(batch, is_config)
            self.proposed[channel].append(time.monotonic() - t)

        chain._propose_batch = propose_batch
        save = chain._wal.save

        def wal_save(hard_state, entries):
            t = time.monotonic()
            save(hard_state, entries)
            if node.is_leader and any(len(e.data) > 1 for e in entries):
                self.wal_block[channel].append(time.monotonic() - t)

        chain._wal.save = wal_save
        apply_block = chain._apply_block

        def apply(blk, is_config, entry):
            t = time.monotonic()
            apply_block(blk, is_config, entry)
            now = time.monotonic()
            self.applied_at.setdefault((channel, nid, blk.header.number), now)
            self.apply_s[channel, nid].append(now - t)

        chain._apply_block = apply
        take = chain._take_snapshot

        def take_snapshot(entry):
            take(entry)
            self.snapshots[channel, nid] += 1

        chain._take_snapshot = take_snapshot

    def leaders(self, channel: str) -> list:
        return [e for e in self.elections if e[1] == channel]

    def export(self) -> dict:
        """The records as JSON values (an orderer process's report)."""
        return {"elections": self.elections, "cut": self.cut,
                "proposed": self.proposed, "wal_block": self.wal_block,
                "applied_at": [[*k, v] for k, v in self.applied_at.items()],
                "apply_s": [[*k, v] for k, v in self.apply_s.items()],
                "snapshots": [[*k, v] for k, v in self.snapshots.items()]}

    def merge(self, doc: dict) -> None:
        """Adds an orderer process's report (`export`)."""
        self.elections += [tuple(e) for e in doc["elections"]]
        for ch, s in doc["cut"].items():
            self.cut[ch] += s
        for ch, v in doc["proposed"].items():
            self.proposed[ch] += v
        for ch, v in doc["wal_block"].items():
            self.wal_block[ch] += v
        for ch, nid, b, t in doc["applied_at"]:
            self.applied_at.setdefault((ch, nid, b), t)
        for ch, nid, v in doc["apply_s"]:
            self.apply_s[ch, nid] += v
        for ch, nid, v in doc["snapshots"]:
            self.snapshots[ch, nid] += v


class RaftOrderer:
    """One orderer node: its TCPTransport (pinned mutual TLS) behind a
    ChannelStepRouter, its Registrar on its own root, one DeliverService,
    and an RPC server (mutual TLS) with the node's Broadcast (a duplex
    stream of envelopes and statuses), Deliver, and the run's own calls:
    its state, its blocks, a halt.  It runs in a process of its own
    (`chip_smoke.py --raft-orderer SPEC`), as an orderer does."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.nid = spec["nid"]
        self.stats = RaftStats()
        pinned = [bytes.fromhex(h) for h in spec["pinned"]]
        self.tls = TLSCredentials(cert_pem=spec["cert"].encode(),
                                  key_pem=spec["key"].encode(),
                                  ca_pems=[spec["ca"].encode()],
                                  pinned_certs=pinned)
        self.rpc_tls = TLSCredentials(cert_pem=spec["cert"].encode(),
                                      key_pem=spec["key"].encode(),
                                      ca_pems=[spec["ca"].encode()])
        self.signer = SigningIdentity.from_pem(
            "OrdererMSP", spec["signer_cert"].encode(),
            spec["signer_key"].encode())
        self.device = torch.device(spec["device"])
        self.transport = TCPTransport(self.nid, ("127.0.0.1",
                                                 spec["raft_port"]),
                                      tls=self.tls)
        router = ChannelStepRouter(self.transport)
        for other, port in spec["peers"].items():
            if int(other) != self.nid:
                router.set_peer(int(other), ("127.0.0.1", port))
        self.reg = Registrar(spec["root"], new_cuda_csp(device=self.device),
                             signer=self.signer, node_id=self.nid,
                             transport=router)
        self.svc = deliver.DeliverService(self.reg.get_chain,
                                          new_cuda_csp(device=self.device))
        self.reg.add_block_listener(lambda ch, blk: self.svc.notifier.notify())
        for path in spec["geneses"]:
            with open(path, "rb") as f:
                cs = self.reg.create_chain(cb.Block.decode(f.read()))
            self.stats.watch(cs.channel_id, self.nid, cs)
        self.halted = threading.Event()
        self.server = RPCServer(port=spec["rpc_port"], tls=self.rpc_tls)
        from fabric_tpu_torch.orderer.broadcast import (
            broadcast_stream_handler,
        )

        for name, fn in (("orderer.Broadcast", self._broadcast),
                         ("ab.BroadcastStream",
                          broadcast_stream_handler(self.reg)),
                         ("orderer.Deliver", self._deliver),
                         ("raft.State", self._state),
                         ("raft.Blocks", self._blocks),
                         ("raft.Halt", self._halt)):
            self.server.register(name, fn)
        self.server.start()

    def _broadcast(self, body: bytes, stream):
        """A duplex stream: each request frame a BlockData of envelopes,
        handled one at a time, each reply a BlockData of their
        BroadcastResponses; an empty frame ends it."""
        from fabric_tpu_torch.orderer.broadcast import BroadcastHandler

        handler = BroadcastHandler(self.reg)
        while True:
            frame = stream.recv()
            if not frame:
                return None
            stream.send(cb.BlockData(data=[
                ob.BroadcastResponse(status=handler.process_message(
                    cb.Envelope.decode(raw))).encode()
                for raw in cb.BlockData.decode(frame).data]).encode())

    def _deliver(self, body: bytes, stream):
        return deliver.deliver_response_frames(self.svc, body)

    def _state(self, body: bytes, stream) -> bytes:
        chans = {}
        for ch in self.reg.channel_list():
            cs = self.reg.get_chain(ch)
            node = cs.chain.node
            chans[ch] = {"height": cs.store.height, "leader": node.leader,
                         "is_leader": node.is_leader, "term": node.term,
                         "voted_for": node.voted_for, "commit": node.commit,
                         "last_index": node.log.last_index,
                         "snap_index": node.log.snap_index,
                         "pending": cs.cutter.pending,
                         "wal_bytes": os.path.getsize(os.path.join(
                             self.spec["root"], "raft", ch, "raft.wal"))}
        return json.dumps({"channels": chans,
                           "stats": self.stats.export()}).encode()

    def _blocks(self, body: bytes, stream):
        """Blocks from a number of a channel (`channel:number`), whole."""
        ch, _, num = body.decode().partition(":")
        store = self.reg.get_chain(ch).store
        return (store.get_block_by_number(n).encode()
                for n in range(int(num), store.height))

    def _halt(self, body: bytes, stream) -> bytes:
        self.halted.set()
        return b"halting"

    def serve(self) -> None:
        parent = os.getppid()
        while not self.halted.wait(0.5):
            if os.getppid() != parent:
                break  # the run that started this process is gone
        self.svc.stop()
        self.reg.halt_all()
        self.transport.close()
        self.server.stop()


def raft_orderer_main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    node = RaftOrderer(spec)
    # a standing orderer keeps its start-up objects out of full collections
    gc.collect()
    gc.freeze()
    print(f"orderer{node.nid - 1} ready", flush=True)
    node.serve()
    workpool.shutdown()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RemoteOrderer:
    """The run's handle on one orderer process."""

    def __init__(self, nid: int, spec: dict, root: str, client_tls):
        self.nid = nid
        self.spec = spec
        self.root = spec["root"]
        self.addr = ("127.0.0.1", spec["rpc_port"])
        self.spec_path = os.path.join(root, f"orderer{nid - 1}.json")
        self.log_path = os.path.join(root, f"orderer{nid - 1}.log")
        self._tls = client_tls
        self.proc = None
        self.up = False

    def start(self) -> None:
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)
        self._log = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--raft-orderer",
             self.spec_path], stdout=self._log, stderr=subprocess.STDOUT)
        self.up = True

    def rpc(self) -> RPCClient:
        return RPCClient(*self.addr, tls=self._tls, timeout=30.0)

    def state(self) -> dict | None:
        """The node's report, or None while its server does not answer."""
        try:
            return json.loads(self.rpc().call("raft.State"))
        except (OSError, RPCError):
            return None

    def chan(self, ch: str) -> dict:
        st = self.state()
        return st["channels"][ch] if st else {}

    def blocks(self, ch: str, start: int = 1) -> list:
        return [cb.Block.decode(raw) for raw in self.rpc().stream(
            "raft.Blocks", f"{ch}:{start}".encode())]

    def halt(self) -> None:
        """Stop the process (its registrar, transport and servers), as a
        crash would."""
        self.up = False
        try:
            self.rpc().call("raft.Halt")
            self.proc.wait(timeout=20)
        except (OSError, RPCError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()
        self._log.close()

    def log_tail(self, n: int = 2000) -> str:
        with open(self.log_path, "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")

    def endpoint(self, ch: str, client):
        """A deliver endpoint: blocks over the node's Deliver RPC."""

        def connect(start):
            if not self.up:
                raise ConnectionError(f"orderer{self.nid - 1} is down")
            env = deliver.make_seek_info_envelope(ch, start, 1 << 62,
                                                  signer=client)
            for frame in self.rpc().stream("orderer.Deliver", env.encode()):
                resp = ob.DeliverResponse.decode(frame)
                if resp.which("Type") == "block":
                    yield resp.block

        return connect

    def broadcaster(self) -> "RemoteBroadcast":
        return RemoteBroadcast(self.rpc().duplex("orderer.Broadcast"))


class RemoteBroadcast:
    """A client's Broadcast stream: envelopes out in frames of up to FRAME,
    their statuses back in order, up to WINDOW frames outstanding.  One
    thread drives it (a TLS socket is not written and read from two
    threads at once)."""

    FRAME = 16
    WINDOW = 4

    def __init__(self, stream):
        self._stream = stream
        self.statuses: list = []
        self._batch: list = []
        self._outstanding = 0

    def _read_one(self) -> None:
        frame = self._stream.recv()
        check(frame is not None, "the broadcast stream ended early")
        self.statuses += [ob.BroadcastResponse.decode(raw).status
                          for raw in cb.BlockData.decode(frame).data]
        self._outstanding -= 1

    def _flush(self) -> None:
        if self._batch:
            self._stream.send(cb.BlockData(data=self._batch).encode())
            self._batch = []
            self._outstanding += 1
            if self._outstanding > self.WINDOW:
                self._read_one()

    def send(self, env: cb.Envelope) -> None:
        self._batch.append(env.encode())
        if len(self._batch) >= self.FRAME:
            self._flush()

    def drain(self) -> None:
        self._flush()
        while self._outstanding:
            self._read_one()

    def burst(self, envs: list) -> list:
        """Send the envelopes; their statuses."""
        k = len(self.statuses)
        for env in envs:
            self.send(env)
        self.drain()
        return self.statuses[k:]

    def process_message(self, env: cb.Envelope) -> int:
        return self.burst([env])[0]

    def close(self) -> None:
        self.drain()
        self._stream.finish()
        self._stream.recv()  # END
        self._stream.close()


class RaftCluster:
    """Three orderer processes on both channels (VALIDATOR_CHANNEL and
    ENDORSE_CHANNEL), each on its own root under `root`."""

    def __init__(self, device, world: ValidatorWorld, root: str,
                 genesis_args: dict):
        self.world = world
        self.stats = RaftStats()
        os.makedirs(root, exist_ok=True)
        ca = CA("tlsca.orderermsp.example.com", "orderermsp.example.com",
                rng=np.random.default_rng(RAFT_CA_SEED))
        pairs = {n: ca.issue(f"orderer{n - 1}", sans=["127.0.0.1",
                                                     "localhost"],
                             client=True, server=True) for n in RAFT_NODES}
        client = ca.issue("raft-client", sans=["127.0.0.1"], client=True)
        self.client_tls = TLSCredentials(cert_pem=client.cert_pem,
                                         key_pem=client.key_pem,
                                         ca_pems=[ca.cert_pem])
        self.pinned = [p.cert.der for p in pairs.values()]
        self.ports = {n: free_port() for n in RAFT_NODES}
        meta = raft_metadata(self.ports, {n: pairs[n].cert_pem
                                          for n in RAFT_NODES})
        self.geneses = [order_genesis(world, consensus_type="etcdraft",
                                      consensus_metadata=meta,
                                      channel_id=ch, **genesis_args)
                        for ch in (VALIDATOR_CHANNEL, ENDORSE_CHANNEL)]
        paths = []
        for ch, raw in zip((VALIDATOR_CHANNEL, ENDORSE_CHANNEL),
                           self.geneses):
            paths.append(os.path.join(root, f"{ch}.genesis"))
            with open(paths[-1], "wb") as f:
                f.write(raw)
        self.nodes = {}
        for n in RAFT_NODES:
            signer = orderer_identity(world, f"orderer{n - 1}")
            spec = {"nid": n, "root": os.path.join(root, f"orderer{n - 1}"),
                    "raft_port": self.ports[n], "rpc_port": free_port(),
                    "peers": self.ports, "cert": pairs[n].cert_pem.decode(),
                    "key": pairs[n].key_pem.decode(),
                    "ca": ca.cert_pem.decode(),
                    "pinned": [d.hex() for d in self.pinned],
                    "signer_cert": signer.cert.pem().decode(),
                    "signer_key": key_pem(signer._key).decode(),
                    "device": str(device), "geneses": paths}
            self.nodes[n] = RemoteOrderer(n, spec, root, self.client_tls)
        for o in self.nodes.values():
            o.start()
        wait_for(lambda: all(o.state() for o in self.nodes.values()),
                 "the orderer processes to serve", poll=0.2,
                 on_timeout=self.log_tails)

    def log_tails(self) -> str:
        return " | ".join(f"orderer{n - 1}: {o.log_tail(600)}"
                          for n, o in self.nodes.items())

    def leader(self, ch: str, among=None) -> int | None:
        for n in among or RAFT_NODES:
            o = self.nodes[n]
            if o.up and o.chan(ch).get("is_leader"):
                return n
        return None

    def up(self) -> list:
        return [n for n, o in self.nodes.items() if o.up]

    def halt_all(self) -> None:
        for o in self.nodes.values():
            if o.up:
                o.halt()


def phase_raft(device, world: ValidatorWorld, blocks: list, expect: dict,
               com: dict, order: dict, tmp: str, depth: int = DEPTH):
    """The commit cell's 8000 envelopes ordered by three port Registrars
    (etcdraft, the sample config's options, TCPTransports over loopback
    mutual TLS pinned to the consenters' certificates behind
    ChannelStepRouters), each in a process of its own on its own root.
    One client thread broadcasts to a follower (a Broadcast stream over
    mutual TLS), which forwards to the leader; once block RAFT_HALT_AFTER
    is on all three and nothing is pending, the leader halts, and the
    broadcast goes on after a new leader is elected.  A DeliverClient
    with all three orderers as endpoints takes the blocks; once the cell
    is ordered, `Committer.store_stream` commits them with CUDACSP, B1
    counted.  After the last block the halted orderer restarts from its
    root.  The refusals, the blocks' sizes and data (phase_order's), the
    survivors' agreement, the elections, the signatures, flags, state,
    mask and the restarted node's height are held.  Returns the cluster,
    still running, for phase_endorse, and the numbers."""
    os.environ["FABRIC_TPU_WAL_CHECKPOINT"] = WAL_CHECKPOINT
    ch = VALIDATOR_CHANNEL
    envs, keys = [], []
    for b, raw in enumerate(blocks):
        for i, env in enumerate(cb.Block.decode(raw).data.data):
            envs.append(env)
            keys.append((b, i))
    predicted = order_refusals(expect)
    admitted = [k for k in keys if k not in predicted]
    want_sizes = ([ORDER_MAX_COUNT] * (len(admitted) // ORDER_MAX_COUNT)
                  + ([len(admitted) % ORDER_MAX_COUNT]
                     if len(admitted) % ORDER_MAX_COUNT else []))
    n_blocks = len(want_sizes)
    # the envelopes up to the last of block RAFT_HALT_AFTER
    first = keys.index(admitted[RAFT_HALT_AFTER * ORDER_MAX_COUNT])
    root = os.path.join(tmp, "raft")
    t_setup = time.perf_counter()
    cluster = RaftCluster(device, world, root, dict(
        max_message_count=ORDER_MAX_COUNT,
        preferred_max_bytes=ORDER_PREFERRED,
        absolute_max_bytes=ORDER_ABSOLUTE, batch_timeout=ORDER_TIMEOUT))
    try:
        return cluster, raft_cell(device, world, cluster, envs, keys,
                                  predicted, admitted, want_sizes, first,
                                  com, order, root, depth, t_setup)
    except BaseException:
        print(f"raft: the orderers' logs: {cluster.log_tails()}")
        cluster.halt_all()
        raise


def raft_cell(device, world, cluster, envs, keys, predicted, admitted,
              want_sizes, first, com, order, root, depth, t_setup) -> dict:
    """phase_raft's run, checks and prints."""
    from fabric_tpu_torch.ledger.kvledger import LedgerProvider
    from fabric_tpu_torch.orderer.blockwriter import verify_block_signature
    from fabric_tpu_torch.peer.committer import Committer
    from fabric_tpu_torch.peer.deliverclient import DeliverClient

    ch = VALIDATOR_CHANNEL
    n_blocks = len(want_sizes)
    stats = cluster.stats
    nodes = cluster.nodes
    bundle = bundle_from_genesis(cluster.geneses[0])
    policy = bundle.policy_manager.get_policy(
        "/Channel/Orderer/BlockValidation")
    print(f"raft: 3 orderer processes (etcdraft: tick {RAFT_TICK_MS} ms, "
          f"election tick {RAFT_ELECTION_TICK}, heartbeat tick "
          f"{RAFT_HEARTBEAT_TICK}, snapshot interval {RAFT_SNAPSHOT_BYTES} "
          f"bytes; BatchSize {ORDER_MAX_COUNT}, BatchTimeout "
          f"{ORDER_TIMEOUT}), channels {ch} and {ENDORSE_CHANNEL}, TCP over "
          f"loopback mutual TLS pinned to {len(cluster.pinned)} "
          f"certificates, raft ports {sorted(cluster.ports.values())}; up "
          f"in {time.perf_counter() - t_setup:.1f} s")
    t_elect = wait_for(lambda: cluster.leader(ch) is not None
                       and cluster.leader(ENDORSE_CHANNEL) is not None,
                       "the first elections", poll=0.05)
    lead = cluster.leader(ch)
    target = next(n for n in RAFT_NODES if n != lead)
    print(f"raft: first elections {t_elect:.2f} s after the processes "
          f"served: {ch} led by orderer{lead - 1}, {ENDORSE_CHANNEL} by "
          f"orderer{cluster.leader(ENDORSE_CHANNEL) - 1}; the client "
          f"broadcasts to orderer{target - 1}")

    csp = RecordingCSP(new_cuda_csp(device=device))
    provider = LedgerProvider(os.path.join(root, "peer"), csp=csp)
    ledger = provider.create(cb.Block.decode(cluster.geneses[0]))
    committer = Committer(TxValidator(ch, ledger, bundle, csp), ledger)
    inbox: queue.Queue = queue.Queue()
    sunk = [1]
    arrived_at: dict = {}

    def sink(seq, raw):
        arrived_at[seq] = time.monotonic()
        sunk[0] = seq + 1
        inbox.put(raw)

    client = DeliverClient(ch, [nodes[n].endpoint(ch, world.client)
                                for n in RAFT_NODES],
                           lambda: sunk[0], sink, bundle=bundle,
                           csp=csp.inner)
    flags: list = []
    durable: list = []
    committer.add_commit_listener(
        lambda block, f: durable.append(time.monotonic()))

    def commit():
        for f in committer.store_stream(iter(inbox.get, None), depth=depth):
            flags.append(list(f))

    # fabriclint: allow[thread-hygiene] a phase thread of the card script,
    # joined with a timeout at the phase's end; a daemon so that a wedged
    # phase fails the run instead of holding the interpreter
    committing = threading.Thread(target=commit, name="raft-commit",
                                  daemon=True)
    stream = nodes[target].broadcaster()
    resume = threading.Event()
    sent = [0]

    def client_thread():
        for j, e in enumerate(envs):
            if j == first:
                stream.drain()
                resume.wait()
            stream.send(cb.Envelope.decode(e))
            sent[0] = j + 1
        stream.drain()

    # fabriclint: allow[thread-hygiene] a phase thread of the card script,
    # joined with a timeout at the phase's end (as the commit thread above)
    broadcaster = threading.Thread(target=client_thread, name="raft-client",
                                   daemon=True)
    leader_state = {}

    def chan(n):
        return nodes[n].chan(ch)

    try:
        csp.reset()
        csp.inner.drain()
        pk.launches_keytab = 0
        pk.launches_lanekeys = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        client.start()
        broadcaster.start()
        wait_for(lambda: len(stream.statuses) == first,
                 "the first segment's statuses")
        t_seg1 = time.monotonic() - t0

        def drained():
            c = chan(lead)
            return (all(chan(n).get("height", 0) > RAFT_HALT_AFTER
                        for n in RAFT_NODES) and not c["pending"]
                    and c["commit"] == c["last_index"])

        wait_for(drained, f"block {RAFT_HALT_AFTER} on all three",
                 poll=0.05)
        heights_at_halt = {n: chan(n)["height"] for n in RAFT_NODES}
        leader_state = nodes[lead].state()
        halted_last = leader_state["channels"][ch]["last_index"]
        led_endorse = cluster.leader(ENDORSE_CHANNEL)
        streaming_from = client.endpoint_log[-1]  # an endpoint index
        t_halt = time.monotonic()
        nodes[lead].halt()
        survivors = [n for n in RAFT_NODES if n != lead]
        wait_for(lambda: cluster.leader(ch, survivors) is not None,
                 "a new leader among the survivors", poll=0.05)
        t_new = time.monotonic() - t_halt
        new_lead = cluster.leader(ch, survivors)
        resume.set()
        wait_for(lambda: len(stream.statuses) == len(envs),
                 "the broadcast's statuses")
        t_broadcast = time.monotonic() - t0
        broadcaster.join(timeout=RAFT_WAIT_S)
        stream.close()
        wait_for(lambda: all(chan(n)["height"] > n_blocks
                             for n in survivors),
                 f"{n_blocks} blocks on the survivors", poll=0.05,
                 on_timeout=lambda: f"heights {[chan(n)['height'] for n in survivors]}")
        t_ordered = time.monotonic() - t0
        # the peer's commit starts once the cell is ordered
        committing.start()
        wait_for(lambda: sunk[0] > n_blocks, "the peer's deliver")
        inbox.put(None)
        committing.join(timeout=RAFT_WAIT_S)
        csp.inner.drain()
        launches = {B1_NAME: pk.launches_keytab,
                    B2_NAME: pk.launches_lanekeys}
        # behind the survivors' compaction point, the restarted node gets
        # a snapshot and, with no block puller, writes no block (the CPU
        # parity test's finding, ROADMAP Queue C); else it catches up
        snap_index = chan(new_lead)["snap_index"]
        behind = halted_last < snap_index
        predicted_h = heights_at_halt[lead] if behind else 1 + n_blocks
        t_restart = time.monotonic()
        nodes[lead].start()

        def settled():
            leader, node = chan(new_lead), chan(lead)
            return (node.get("term") == leader["term"]
                    and node["leader"] == new_lead
                    and node["commit"] >= leader["commit"]
                    and node["height"] >= predicted_h)

        wait_for(settled, "the restarted orderer to join", poll=0.1,
                 on_timeout=lambda: {n: {k: chan(n).get(k) for k in (
                     "term", "leader", "commit", "height", "last_index",
                     "snap_index")} for n in RAFT_NODES})
        time.sleep(3 * RAFT_TICK_MS / 1e3)  # heartbeats: nothing more lands
        t_rejoin = time.monotonic() - t_restart
        rejoined_h = chan(lead)["height"]
        client.stop()
        check(not committing.is_alive() and len(flags) == n_blocks,
              f"{len(flags)} of {n_blocks} blocks committed at the peer")
        states = {n: nodes[n].state() for n in RAFT_NODES}
    except BaseException:
        client.stop()
        inbox.put(None)
        raise
    for st in [leader_state] + [states[n] for n in survivors]:
        stats.merge(st["stats"])

    # -- checks
    statuses = stream.statuses
    got_refused = {keys[j]: s for j, s in enumerate(statuses)
                   if s != cb.SUCCESS}
    check(got_refused == predicted, f"refused {sorted(got_refused.items())},"
          f" predicted {sorted(predicted.items())}")
    chains = {n: nodes[n].blocks(ch) for n in survivors}
    sizes = [len(b.data.data) for b in chains[new_lead]]
    check(sizes == want_sizes, f"blocks of {sizes} envelopes, predicted "
          f"{want_sizes}")
    views = {n: [(pu.block_header_bytes(b.header), list(b.data.data))
                 for b in chains[n]] for n in survivors}
    check(views[survivors[0]] == views[survivors[1]],
          "the survivors' chains differ")
    data_hashes = [bytes(b.header.data_hash) for b in chains[new_lead]]
    check(data_hashes == order["data_hashes"], "a block's data differs from "
          "phase_order's block of the same number")
    leaders = stats.leaders(ch)
    elected = [(round(t - t0, 3), f"orderer{n - 1}", term)
               for t, _, n, term in leaders]
    check(len(leaders) == 2 and leaders[0][2] == lead
          and leaders[1][2] == new_lead and leaders[1][0] > t_halt,
          f"elections on {ch}: {elected} (planted: the first and one after "
          f"the halt at {t_halt - t0:.3f} s; heights {heights_at_halt})")
    e_leaders = stats.leaders(ENDORSE_CHANNEL)
    check(len(e_leaders) == 1 + (led_endorse == lead),
          f"elections on {ENDORSE_CHANNEL}: "
          f"{[(round(t - t0, 3), n, term) for t, _, n, term in e_leaders]}"
          f" (orderer{led_endorse - 1} led it at the halt)")
    sig_ok = sum(verify_block_signature(ledger.get_block_by_number(n),
                                        policy, hostref.HostCSP())
                 for n in range(1, n_blocks + 1))
    check(sig_ok == n_blocks, f"{n_blocks - sig_ok} delivered blocks fail "
          "/Channel/Orderer/BlockValidation")
    check(launches[B1_NAME] > 0, f"B1 did not launch on the raft path: "
          f"{launches}")
    got_flags = [f for block in flags for f in block]
    want_flags = [com["flags"][b][i] for b, i in admitted]
    check(got_flags == want_flags, "the raft commit's flags differ from "
          f"phase_commit's on "
          f"{sum(a != b for a, b in zip(got_flags, want_flags))} transactions")
    base_provider = LedgerProvider(com["root"])
    want_state = state_pairs(base_provider.open(ch))
    base_provider.close()
    check(state_pairs(ledger) == want_state, "the raft commit's state "
          "differs from phase_commit's")
    lanes = check_mask_host(csp, "raft")
    log = list(client.endpoint_log)
    check(streaming_from != RAFT_NODES.index(lead) or len(log) > 1,
          f"the deliver client stayed on the halted orderer: endpoints "
          f"{log}")
    check(rejoined_h == predicted_h, f"the restarted orderer's height "
          f"{rejoined_h}, predicted {predicted_h} (its last raft index "
          f"{halted_last}, the survivors compacted to {snap_index})")
    provider.close()

    # -- prints
    n_env = len(envs)
    lead_cut = stats.cut[ch] / n_env * 1e3
    prop = stats.proposed[ch]
    wal = stats.wal_block[ch]
    lead_apply = stats.apply_s[ch, lead] + stats.apply_s[ch, new_lead]
    lat = []  # the restarted node's catch-up aside
    for b in range(1, n_blocks + 1):
        proposer = lead if b <= RAFT_HALT_AFTER else new_lead
        t_l = stats.applied_at[ch, proposer, b]
        lat += [stats.applied_at[ch, n, b] - t_l for n in RAFT_NODES
                if n != proposer and (ch, n, b) in stats.applied_at
                and (n != lead or b <= RAFT_HALT_AFTER)]
    deliver_lat = [arrived_at[b] - min(stats.applied_at[ch, n, b]
                                       for n in RAFT_NODES
                                       if (ch, n, b) in stats.applied_at)
                   for b in range(1, n_blocks + 1)]
    wal_bytes = {f"orderer{n - 1}": states[n]["channels"][ch]["wal_bytes"]
                 for n in RAFT_NODES}
    snaps = {f"orderer{n - 1}": stats.snapshots[ch, n] for n in RAFT_NODES}
    n_tx = len(admitted)
    peer_wall = durable[-1] - t0
    print(f"raft: broadcast {n_env} envelopes in {t_broadcast * 1e3:.1f} ms "
          f"(the first {first} in {t_seg1 * 1e3:.1f} ms = "
          f"{first / t_seg1:.0f} envelopes/s; the halt and election "
          f"between); statuses "
          f"{dict(sorted(collections.Counter(statuses).items()))}, the "
          f"refused ones as predicted")
    print(f"raft: on the leader, ms a block: cut "
          f"{lead_cut * ORDER_MAX_COUNT:.2f} ({lead_cut * 1e3:.1f} us an "
          f"envelope), propose {statistics.mean(prop) * 1e3:.2f} (build, "
          f"marshal, raft append; {len(prop)} proposals), WAL append with "
          f"its fsync {statistics.mean(wal) * 1e3:.2f} (max "
          f"{max(wal) * 1e3:.2f}, {fs_type(root)}), apply (write, sign) "
          f"{statistics.mean(lead_apply) * 1e3:.2f}")
    print(f"raft: the leader's apply to a follower's: median "
          f"{statistics.median(lat) * 1e3:.2f} ms, max {max(lat) * 1e3:.2f} "
          f"ms over {len(lat)} (block, follower) pairs; a block's first "
          f"apply to its hand-off to the peer: median "
          f"{statistics.median(deliver_lat) * 1e3:.2f} ms, max "
          f"{max(deliver_lat) * 1e3:.2f} ms; the deliver client on "
          f"orderer{streaming_from} at the halt, endpoints {log[:6]}")
    print(f"raft: halted orderer{lead - 1} (the leader) at heights "
          f"{heights_at_halt}; orderer{new_lead - 1} led {t_new:.3f} s "
          f"after the halt; elections {elected}; the restarted orderer "
          f"rejoined in {t_rejoin:.1f} s at height {rejoined_h} (predicted "
          f"{predicted_h}: its last raft index {halted_last}, the survivors "
          f"compacted to {snap_index}, no block puller)")
    print(f"raft: peer committed {n_tx} transactions "
          f"({got_flags.count(pb.VALID)} VALID) in {peer_wall * 1e3:.1f} ms "
          f"from the first broadcast = {n_tx / peer_wall:.0f} committed "
          f"tx/s (its commit from {t_ordered * 1e3:.1f} ms, when all "
          f"{n_blocks} were ordered); {lanes} verify lanes; launches "
          f"{launches}; flags, state and block data phase_order's and "
          f"phase_commit's; {sig_ok} blocks pass "
          "/Channel/Orderer/BlockValidation")
    print(f"raft: WAL bytes {wal_bytes}, snapshots taken {snaps}")
    return {"launches": launches, "wall_s": peer_wall, "blocks": n_blocks}


class BenchCC(Chaincode):
    """The endorse cell's chaincode: read one key, write another (the
    headline's transaction shape), or fail with status 500."""

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "rw":
            got = stub.get_state(params[0].decode())
            stub.put_state(params[1].decode(), params[2])
            return shim_success(got)
        if fn == "fail":
            return shim_error("refused by the chaincode", status=500)
        return shim_error(f"unknown function {fn!r}")


LAUNCH_LOCK = threading.Lock()


def count_launches(csp: CUDACSP, peer) -> None:
    """Adds to `peer.launches` the B1 launches of `csp`: the global
    counter's step over each of its launches (the peers launch one at a
    time under LAUNCH_LOCK)."""
    launch = csp._launch

    def counted(packed, dev, keytab):
        with LAUNCH_LOCK:
            before = pk.launches_keytab
            out = launch(packed, dev, keytab)
            peer.launches += pk.launches_keytab - before
        return out

    csp._launch = counted


class EndorsingPeer:
    """A peer of phase_endorse: its KVLedger, a ChaincodeSupport with
    `_lifecycle`, `qscc` and `benchcc` over InProcStreams, an Endorser
    (its split timed), and a DeliverClient on the raft cluster streaming
    into `Committer.store_stream` with CUDACSP (its B1 launches counted)
    and the committed definitions."""

    def __init__(self, device, world: ValidatorWorld, k: int, root: str,
                 cluster: RaftCluster, genesis_raw: bytes):
        import itertools

        from fabric_tpu_torch.chaincode.lifecycle import (
            NAMESPACE,
            DefinitionProvider,
            LifecycleSCC,
            PackageStore,
        )
        from fabric_tpu_torch.chaincode.scc import QSCC
        from fabric_tpu_torch.chaincode.support import (
            ChaincodeSupport,
            InProcStream,
        )
        from fabric_tpu_torch.ledger.kvledger import LedgerProvider
        from fabric_tpu_torch.peer.committer import Committer
        from fabric_tpu_torch.peer.deliverclient import DeliverClient
        from fabric_tpu_torch.peer.endorser import Endorser

        self.name = f"peer0.org{k + 1}"
        peer = world.peers[k]
        self.signer = SigningIdentity(peer.mspid, peer.cert, peer._key,
                                      world.rng)
        self.sign = self.signer.sign = Timed(self.signer.sign)
        self.bundle = bundle = bundle_from_genesis(genesis_raw)
        inner = new_cuda_csp(device=device)
        self.csp = RecordingCSP(inner)
        self.launches = 0
        count_launches(inner, self)
        self.provider = LedgerProvider(os.path.join(root, self.name),
                                       csp=self.csp)
        self.ledger = ledger = self.provider.create(
            cb.Block.decode(genesis_raw))
        self.support = ChaincodeSupport()
        orgs = [f"Org{i + 1}MSP" for i in range(N_ORGS)]
        self.streams = [
            InProcStream(self.support, LifecycleSCC(
                PackageStore(os.path.join(root, self.name + "-packages")),
                org_lister=lambda: orgs), NAMESPACE),
            InProcStream(self.support, QSCC(
                lambda c: ledger if c == ENDORSE_CHANNEL else None), "qscc"),
            InProcStream(self.support, BenchCC(), VALIDATOR_CC)]
        names = [NAMESPACE, "qscc", VALIDATOR_CC]
        for s, name in zip(self.streams, names):
            s.start()
            s.wait_registered(self.support, name)
        seq = itertools.count()
        # the proposal being endorsed, handed to the chaincode (its
        # creator: `_lifecycle` approves for the creator's org)
        self._proposal = b""

        def adapter(name):
            def run(sim, args):
                resp, _ = self.support.execute(
                    name, "", f"{self.name}-{next(seq)}", sim, args,
                    signed_proposal_bytes=self._proposal)
                return resp.status, resp.message, resp.payload
            return run

        self.endorser = Endorser(ENDORSE_CHANNEL, ledger, bundle,
                                 self.signer,
                                 {n: adapter(n) for n in names},
                                 new_cuda_csp(device=device))
        e = self.endorser
        self.t_creator = e._check_creator = Timed(e._check_creator)
        self.t_acl = e._check_acl = Timed(e._check_acl)
        self.t_endorse = e.endorse = Timed(e.endorse)
        self.definitions = DefinitionProvider(ledger)
        self.committer = Committer(TxValidator(
            ENDORSE_CHANNEL, ledger, bundle, self.csp,
            definition_provider=self.definitions), ledger)
        self.inbox: queue.Queue = queue.Queue()
        self.next = [1]

        def sink(seq_, raw):
            self.next[0] = seq_ + 1
            self.inbox.put(raw)

        self.client = DeliverClient(
            ENDORSE_CHANNEL, [o.endpoint(ENDORSE_CHANNEL, world.client)
                              for o in cluster.nodes.values()],
            lambda: self.next[0], sink, bundle=bundle, csp=inner)

        def commit():
            # depth 1: each block is committed before the next is validated
            # (a committed definition governs the next block), and the
            # stream does not wait for more blocks than the run sends
            for _ in self.committer.store_stream(iter(self.inbox.get, None),
                                                 depth=1):
                pass  # the flags are read from the committed blocks

        # fabriclint: allow[thread-hygiene] the gateway peer's commit
        # thread, joined with a timeout when the peer stops; a daemon so a
        # wedged peer fails the run instead of holding the interpreter
        self.committing = threading.Thread(target=commit,
                                           name=f"{self.name}-commit",
                                           daemon=True)
        self.committing.start()
        self.client.start()

    @property
    def height(self) -> int:
        """The durable height: blocks and state flushed."""
        return self.ledger.durable_height

    def flags_of(self, lo: int, hi: int) -> list:
        """The committed TRANSACTIONS_FILTER of blocks lo..hi-1."""
        return [list(pu.tx_filter(self.ledger.get_block_by_number(n)))
                for n in range(lo, hi)]

    def process(self, sp):
        self._proposal = sp.encode()
        return self.endorser.process_proposal(sp)

    def stop(self) -> None:
        self.client.stop()
        self.inbox.put(None)
        self.committing.join(timeout=RAFT_WAIT_S)
        for s in self.streams:
            s.stop()
        self.csp.inner.drain()
        if not self.committing.is_alive():  # else it still reads the store
            self.provider.close()


# The planted faults of the endorse cell, by proposal index: a bad creator
# signature, a creator outside /Channel/Application/Writers, a chaincode
# status of 500, two endorsements, and a read of the key that an earlier
# transaction of the same block writes.
ENDORSE_PLAN = {3: "bad_signature", 5: "outsider", 7: "status_500",
                9: "two_endorsements", 14: ("reads_write_of", 12)}


def phase_endorse(device, world: ValidatorWorld, cluster: RaftCluster,
                  tmp: str, n_txs: int = ENDORSE_TXS,
                  n_blocks: int = ENDORSE_BLOCKS):
    """Execute-order-validate on the raft cluster's second channel: three
    endorsing peers (Org1-3).  `_lifecycle` approves `benchcc` for each
    org (each approval endorsed by the three peers, ordered and committed
    at all three), then commits its definition with the validation
    parameter ENDORSE_POLICY.  Then `n_blocks` blocks of `n_txs`
    transactions: each proposal goes to the three endorsers in turn (not
    batched), the client assembles the endorsed transactions and
    broadcasts a block's worth at once to a follower.  The planted faults' outcomes, the flags
    at all three peers (predicted before the run), their states, qscc's
    GetChainInfo and each peer's B1 launches are held."""
    genesis_raw = cluster.geneses[1]
    root = os.path.join(tmp, "endorse")
    peers = [EndorsingPeer(device, world, k, root, cluster, genesis_raw)
             for k in range(ENDORSERS)]
    try:
        return endorse_cell(world, cluster, peers, n_txs, n_blocks)
    finally:
        for p in peers:
            p.stop()


def endorse_cell(world: ValidatorWorld, cluster: RaftCluster, peers: list,
                 n_txs: int, n_blocks: int) -> dict:
    """phase_endorse's lifecycle, traffic, checks and prints."""
    from fabric_tpu_torch.peer.endorser import ACLDeniedError, EndorserError
    from fabric_tpu_torch.policies import policydsl
    from fabric_tpu_torch.protos import lifecycle as lc

    ch = ENDORSE_CHANNEL
    rng = np.random.default_rng(ENDORSE_SEED)
    client = world.client
    outsider = orderer_identity(world, "outsider", ou="client")

    def proposal(cc, args, signer=client, tamper=False):
        prop, _ = pu.create_chaincode_proposal(
            signer.serialize(), ch, cc, args, nonce=rng.bytes(24))
        raw = prop.encode()
        sig = signer.sign(b"not the proposal" if tamper else raw)
        return prop, pb.SignedProposal(proposal_bytes=raw, signature=sig)

    def submit(handler, prop, signer, resps):
        env = pu.create_signed_tx(prop, signer, resps)
        check(handler.process_message(env) == cb.SUCCESS,
              "a broadcast was refused")

    def follower():
        lead = cluster.leader(ch)
        return next(n for n in cluster.up() if n != lead)

    def committed(height):
        wait_for(lambda: all(p.height >= height for p in peers),
                 f"height {height} at the three peers", on_timeout=lambda: (
                     f"peers {[p.height for p in peers]}, orderers "
                     f"{[o.height(ch) if o.up else None for o in cluster.nodes.values()]}, "
                     f"leader {cluster.leader(ch)}"))

    # -- the definition, through endorse-order-commit
    wait_for(lambda: cluster.leader(ch) is not None, f"a leader of {ch}",
             poll=0.05)
    handler = cluster.nodes[follower()].broadcaster()
    definition = lc.ChaincodeDefinition(
        sequence=1, name=VALIDATOR_CC, version="1.0",
        validation_parameter=pb.ApplicationPolicy(
            signature_policy=policydsl.from_string(ENDORSE_POLICY)).encode())
    t_life = time.perf_counter()
    for k in range(ENDORSERS):
        args = lc.ApproveChaincodeDefinitionForMyOrgArgs(
            definition=definition).encode()
        prop, sp = proposal("_lifecycle", [
            b"ApproveChaincodeDefinitionForMyOrg", args],
            signer=world.peers[k])
        submit(handler, prop, world.peers[k], [p.process(sp) for p in peers])
    committed(2)
    prop, sp = proposal("_lifecycle", [
        b"CheckCommitReadiness",
        lc.CheckCommitReadinessArgs(definition=definition).encode()])
    ready = lc.CheckCommitReadinessResult.decode(
        peers[0].process(sp).response.payload)
    check(dict(ready.approvals) == {f"Org{i + 1}MSP": i < ENDORSERS
                                    for i in range(N_ORGS)},
          f"commit readiness {dict(ready.approvals)}")
    prop, sp = proposal("_lifecycle", [
        b"CommitChaincodeDefinition",
        lc.CommitChaincodeDefinitionArgs(definition=definition).encode()])
    submit(handler, prop, client, [p.process(sp) for p in peers])
    committed(3)
    t_life = time.perf_counter() - t_life
    for p in peers:
        check(p.definitions.validation_info(VALIDATOR_CC)
              == ("vscc", definition.validation_parameter),
              f"{p.name}'s committed definition")
        check(p.flags_of(1, 3) == [[pb.VALID] * ENDORSERS, [pb.VALID]],
              f"{p.name}'s lifecycle flags {p.flags_of(1, 3)}")

    # -- the prediction, then the traffic
    plan = ENDORSE_PLAN
    total = n_txs * n_blocks + sum(
        1 for v in plan.values()
        if v in ("bad_signature", "outsider", "status_500"))
    want_refusals = {k: {"bad_signature": "EndorserError",
                         "outsider": "ACLDeniedError",
                         "status_500": 500}[v]
                     for k, v in plan.items() if isinstance(v, str)
                     and v in ("bad_signature", "outsider", "status_500")}
    envelope_of = [k for k in range(total) if k not in want_refusals]
    predicted = [pb.VALID] * (n_txs * n_blocks)
    for k, v in plan.items():
        if v == "two_endorsements":
            predicted[envelope_of.index(k)] = pb.ENDORSEMENT_POLICY_FAILURE
        elif isinstance(v, tuple):
            check(envelope_of.index(k) // n_txs
                  == envelope_of.index(v[1]) // n_txs, "the planted read "
                  "and its write fall in different blocks")
            predicted[envelope_of.index(k)] = pb.MVCC_READ_CONFLICT
    print(f"endorse: {ch} on the raft cluster; `_lifecycle` approved and "
          f"committed `{VALIDATOR_CC}` (validation parameter "
          f"{ENDORSE_POLICY}) in {t_life:.2f} s (3 blocks with the timer "
          f"cuts); predicted refusals {sorted(want_refusals.items())}, "
          f"flags {dict(collections.Counter(predicted))}")
    for p in peers:
        for t in (p.t_creator, p.t_acl, p.t_endorse, p.sign):
            t.s, t.n = 0.0, 0
    base = [p.launches for p in peers]
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0
    for p in peers:
        p.csp.reset()
    refusals = {}
    batch: list = []  # a block's endorsed transactions, broadcast together
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(total):
        kind = plan.get(k)
        read = f"r-{k}"
        if isinstance(kind, tuple):
            read = f"w-{kind[1]}"
        args = [b"rw", read.encode(), b"w-%d" % k, b"v%d" % k]
        signer = client
        if kind == "status_500":
            args = [b"fail"]
        elif kind == "outsider":
            signer = outsider
        prop, sp = proposal(VALIDATOR_CC, args, signer=signer,
                            tamper=kind == "bad_signature")
        endorsers = peers[:2] if kind == "two_endorsements" else peers
        try:
            resps = [p.process(sp) for p in endorsers]
        except (ACLDeniedError, EndorserError) as exc:
            refusals[k] = type(exc).__name__
            continue
        if resps[0].response.status >= 400:
            refusals[k] = resps[0].response.status
            continue
        batch.append(pu.create_signed_tx(prop, client, resps))
        if len(batch) == n_txs:
            # the block's envelopes in one burst: the count cuts it, not
            # the BatchTimeout that the endorsements would outlast
            check(handler.burst(batch) == [cb.SUCCESS] * n_txs,
                  "a broadcast was refused")
            batch = []
    check(not batch, f"{len(batch)} endorsed transactions left over")
    t_endorsed = time.perf_counter() - t0
    committed(3 + n_blocks)
    t_wall = time.perf_counter() - t0
    handler.close()
    launches = {B1_NAME: pk.launches_keytab, B2_NAME: pk.launches_lanekeys}
    per_peer = [p.launches - b for p, b in zip(peers, base)]
    check(refusals == want_refusals, f"refusals {sorted(refusals.items())},"
          f" predicted {sorted(want_refusals.items())}")
    got = [p.flags_of(3, 3 + n_blocks) for p in peers]
    for p, f in zip(peers, got):
        flat = [x for block in f for x in block]
        check(flat == predicted, f"{p.name}'s flags differ from the "
              f"prediction on {sum(a != b for a, b in zip(flat, predicted))}"
              " transactions")
    states = [list(p.ledger.get_state_range(VALIDATOR_CC, "", ""))
              for p in peers]
    check(states[0] == states[1] == states[2]
          and len(states[0]) == predicted.count(pb.VALID),
          f"the peers' states differ or hold {len(states[0])} keys")
    heights = []
    for p in peers:
        _, sp = proposal("qscc", [b"GetChainInfo", ch.encode()])
        resp = p.process(sp).response
        check(resp.status == 200, f"qscc at {p.name}: {resp.message}")
        heights.append(cb.BlockchainInfo.decode(resp.payload).height)
    check(heights == [3 + n_blocks] * 3, f"qscc heights {heights}")
    check(all(n >= 1 for n in per_peer) and sum(per_peer)
          == launches[B1_NAME], f"B1 launches a peer {per_peer}, of "
          f"{launches[B1_NAME]}")
    lanes = sum(check_mask_host(p.csp, f"endorse {p.name}") for p in peers)
    for p in peers:
        n = p.t_creator.n
        print(f"endorse: {p.name} {n} proposals, "
              f"{n / (p.t_creator.s + p.t_acl.s + p.t_endorse.s):.0f} "
              f"proposals/s: creator verify "
              f"{p.t_creator.s / n * 1e3:.3f} ms, ACL "
              f"{p.t_acl.s / max(p.t_acl.n, 1) * 1e3:.3f} ms, simulation "
              f"through the shim "
              f"{(p.t_endorse.s - p.sign.s) / max(p.t_endorse.n, 1) * 1e3:.3f}"
              f" ms, signing {p.sign.s / max(p.sign.n, 1) * 1e3:.3f} ms; "
              f"B1 launches {p.launches}")
    n_tx = n_txs * n_blocks
    print(f"endorse: {total} proposals endorsed and broadcast in "
          f"{t_endorsed:.2f} s; {n_tx} transactions committed at all three "
          f"peers {t_wall:.2f} s from the first proposal = "
          f"{n_tx / t_wall:.0f} tx/s end to end; flags as predicted "
          f"({predicted.count(pb.VALID)} VALID) and equal states at the "
          f"three; qscc heights {heights}; {lanes} verify lanes; launches "
          f"{launches}")
    return {"launches": launches, "wall_s": t_wall, "per_peer": per_peer,
            "state": states[0], "height": 3 + n_blocks}


# ---------------------------------------------------------------------------
# The gateway and gossip: a client's transactions through discovery, the
# gateway and the raft cluster to five peers joined by gossip.
# ---------------------------------------------------------------------------

GATEWAY_PEERS = 5  # one a org; Org1-4 endorse `benchcc`, Org5 commits only
GATEWAY_TICK_S = 0.5  # every peer's gossip tick
GATEWAY_ALIVE_TICKS = 20  # a peer silent this long is dead (10 s)
GATEWAY_LEADER_TIMEOUT = 20  # ticks without a declaration: a new election
GATEWAY_STARTUP_TICKS = 10  # a started peer only proposes for 5 s
GATEWAY_TTL_TICKS = 4  # a block leaves a gossip store after 2 s
GATEWAY_SEED = 29
GATEWAY_TEAR_AT = 600  # the gateway's stream raises at this write
GATEWAY_DUPS = range(100, 110)  # submitted again at once, while in flight
GATEWAY_WINDOW = (1024, 4096)  # the gateway's admission window, min and max


def ledger_tail(ledger, stop: threading.Event):
    """A deliver endpoint over a peer's ledger: its committed blocks (with
    the validator's flags) from `start`, as they land."""

    def connect(start):
        n = start
        while not stop.is_set():
            if n < ledger.height:
                yield ledger.get_block_by_number(n)
                n += 1
            else:
                time.sleep(0.005)

    return connect


class CountedStream:
    """A duplex stream whose sends and acks are stamped into `log`."""

    def __init__(self, stream, log: list):
        self._stream = stream
        self._log = log

    def send(self, body: bytes) -> None:
        self._stream.send(body)
        self._log.append((time.perf_counter(), "send"))

    def recv(self):
        body = self._stream.recv()
        if body is not None:
            self._log.append((time.perf_counter(), "ack"))
        return body

    def finish(self) -> None:
        self._stream.finish()

    def close(self) -> None:
        self._stream.close()


class _Detached:
    """What a stopped peer's state provider commits into: nothing (every
    block is below its height)."""

    height = 1 << 62


class GossipPeer:
    """A peer of phase_gateway: its KVLedger (created from the channel's
    genesis block, or reopened on its root), a `PrivDataCoordinator` over
    `TxValidator` with CUDACSP (its B1 launches counted) and the committed
    definitions, a `GossipService` over `TCPGossipComm` (mutual TLS,
    `SignerMCS`) ticked by a `GossipRunner`, and a deliver client on the
    raft cluster that the service runs while this peer leads the channel;
    for Org1-4 an Endorser with `benchcc`.  `events` gets each start and
    stop of the deliver client."""

    def __init__(self, device, world: ValidatorWorld, k: int, root: str,
                 cluster: RaftCluster, genesis_raw: bytes, tls_ca: CA,
                 port: int, bootstrap: str | None, events: list,
                 restart: bool = False):
        from fabric_tpu_torch.chaincode.lifecycle import DefinitionProvider
        from fabric_tpu_torch.chaincode.support import (
            ChaincodeSupport,
            InProcStream,
        )
        from fabric_tpu_torch.comm.tls import credentials_from_ca
        from fabric_tpu_torch.common.privdata import CollectionStore
        from fabric_tpu_torch.gossip import (
            GossipRunner,
            GossipService,
            SignerMCS,
            TCPGossipComm,
        )
        from fabric_tpu_torch.gossip.privdata import PrivDataCoordinator
        from fabric_tpu_torch.ledger.kvledger import LedgerProvider
        from fabric_tpu_torch.ledger.kvstore import MemKVStore
        from fabric_tpu_torch.ledger.transientstore import TransientStore
        from fabric_tpu_torch.peer.deliverclient import DeliverClient
        from fabric_tpu_torch.peer.endorser import Endorser

        import itertools

        self.k = k
        self.name = f"peer0.org{k + 1}"
        signer = world.peers[k]
        self.identity = signer.serialize()
        self.bundle = bundle = bundle_from_genesis(genesis_raw)
        self.inner = inner = new_cuda_csp(device=device)
        self.launches = 0
        count_launches(inner, self)
        self.provider = LedgerProvider(os.path.join(root, self.name),
                                       csp=inner)
        self.ledger = (self.provider.open(ENDORSE_CHANNEL) if restart else
                       self.provider.create(cb.Block.decode(genesis_raw)))
        self.definitions = DefinitionProvider(self.ledger)
        self.coordinator = PrivDataCoordinator(
            TxValidator(ENDORSE_CHANNEL, self.ledger, bundle, inner,
                        definition_provider=self.definitions),
            self.ledger, TransientStore(MemKVStore(), ENDORSE_CHANNEL),
            CollectionStore(bundle.msp_manager), self.identity)
        self.committed_at: dict = {}  # block number -> perf time
        self.coordinator.add_commit_listener(
            lambda blk, flags: self.committed_at.__setitem__(
                blk.header.number, time.perf_counter()))
        self.streams = []
        self.endorser = None
        if k < GATEWAY_PEERS - 1:
            self.support = ChaincodeSupport()
            stream = InProcStream(self.support, BenchCC(), VALIDATOR_CC)
            stream.start()
            stream.wait_registered(self.support, VALIDATOR_CC)
            self.streams.append(stream)
            seq = itertools.count()

            def run(sim, args):
                resp, _ = self.support.execute(
                    VALIDATOR_CC, "", f"{self.name}-gw-{next(seq)}", sim,
                    args)
                return resp.status, resp.message, resp.payload

            self.endorser = Endorser(ENDORSE_CHANNEL, self.ledger, bundle,
                                     signer, {VALIDATOR_CC: run},
                                     new_cuda_csp(device=device))
        self.comm = TCPGossipComm(
            ("127.0.0.1", port), self.identity,
            mcs=SignerMCS(signer, bundle.msp_manager, inner),
            tls=credentials_from_ca(tls_ca, self.name))
        self.endpoint = self.comm.endpoint
        self.service = GossipService(
            self.comm, [bootstrap or self.endpoint],
            alive_expiration_ticks=GATEWAY_ALIVE_TICKS,
            rng=random.Random(GATEWAY_SEED * 10 + k))
        self.handle = None

        def sink(seq_, raw):
            self.handle.state.add_payload(seq_, raw, from_orderer=True)

        self.client = DeliverClient(
            ENDORSE_CHANNEL, [o.endpoint(ENDORSE_CHANNEL, world.client)
                              for o in cluster.nodes.values()],
            lambda: self.coordinator.height, sink, bundle=bundle, csp=inner)
        start, stop = self.client.start, self.client.stop

        def started():
            events.append((time.perf_counter(), k, "start"))
            start()

        def stopped():
            stop()
            events.append((time.perf_counter(), k, "stop"))

        self.client.start, self.client.stop = started, stopped
        self.handle = self.service.join_channel(
            ENDORSE_CHANNEL, self.coordinator, deliver_client=self.client,
            store_ttl_ticks=GATEWAY_TTL_TICKS,
            leader_timeout_ticks=GATEWAY_LEADER_TIMEOUT,
            election_startup_ticks=GATEWAY_STARTUP_TICKS)
        self.watch_commits()
        self.runner = GossipRunner(self.service, GATEWAY_TICK_S)
        self.runner.start()

    def watch_commits(self) -> None:
        """Times each pass of the state layer's ordered commit that
        committed a block, (start, end, the thread's name) into `drains`,
        and each leadership declaration's arrival into `declarations`:
        the report sets the two side by side."""
        self.drains: list = []
        self.declarations: list = []
        state = self.handle.state
        drain = state._drain

        def timed_drain():
            t0, h0 = time.perf_counter(), self.coordinator.height
            drain()
            if self.coordinator.height > h0:
                self.drains.append((t0, time.perf_counter(),
                                    threading.current_thread().name))

        def heard(rm):
            m = rm.msg
            if (m.which("content") == "leadership_msg"
                    and m.leadership_msg.is_declaration):
                self.declarations.append(time.perf_counter())

        state._drain = timed_drain
        self.comm.subscribe(heard)

    def commit_report(self) -> str:
        """Where the state layer's commits ran (the state worker, a
        connection's reader, the deliver client), the longest of each in
        s, and the declarations heard while the state worker committed."""
        by: dict = collections.defaultdict(list)
        for t0, t1, name in self.drains:
            by[name].append(t1 - t0)
        worker = [(t0, t1) for t0, t1, name in self.drains
                  if name == "gossip-state-commit"]
        during = sum(any(a <= d <= b for a, b in worker)
                     for d in self.declarations)
        return (f"{self.name}: commits " + ", ".join(
            f"{name} {len(v)} (longest {max(v):.3f} s)"
            for name, v in sorted(by.items())) +
            f"; {len(self.declarations)} declarations heard, {during} of "
            f"them while the state worker committed")

    @property
    def height(self) -> int:
        """The durable height: blocks and state flushed."""
        return self.ledger.durable_height

    def sources(self) -> dict:
        """Blocks received, by route."""
        return {"deliver": self.client.delivered,
                **self.handle.gossip.received,
                "state": self.handle.state.blocks_received}

    def flags_of(self, lo: int, hi: int) -> list:
        return [list(pu.tx_filter(self.ledger.get_block_by_number(n)))
                for n in range(lo, hi)]

    def process(self, sp):
        return self.endorser.process_proposal(sp)

    def stop(self) -> None:
        """Stop ticking and serving, detach the state layer from the
        ledger (a message still in flight commits nothing), close."""
        self.runner.stop()
        self.client.stop()
        self.comm.close()
        state = self.handle.state
        with state._commit_lock:
            state._committer = _Detached()
        for s in self.streams:
            s.stop()
        self.inner.drain()
        self.provider.close()


def gateway_discovery(peers: list, tls_ca: CA):
    """`DiscoveryService` on peers[0] over comm's RPC (mutual TLS): its
    peers are its gossip membership and itself, with ledger heights, and
    only those with `benchcc` installed (Org1-4: what gossip's state info
    carries in the reference); its chaincode policy the committed
    definition's; its ACL the channel's Writers.  Returns the server and
    the client's `send`."""
    from fabric_tpu_torch.comm.tls import credentials_from_ca
    from fabric_tpu_torch.discovery import (
        DiscoveryService,
        DiscoverySupport,
        PeerInfo,
    )
    from fabric_tpu_torch.protos import discovery as dpb
    from fabric_tpu_torch.protos.msp import SerializedIdentity

    me = peers[0]
    installed = {p.endpoint: (VALIDATOR_CC,) for p in peers
                 if p.endorser is not None}
    csp = me.inner

    def members(channel):
        out = [PeerInfo(me.endpoint, me.identity, me.bundle.msp_manager
                        .deserialize_identity(me.identity).mspid, me.height,
                        installed.get(me.endpoint, ()))]
        heights = dict(me.handle.gossip._heights)
        for ps in me.service.discovery.alive_peers():
            ident = me.comm.identity_of(ps.pki_id)
            if ident is None:
                continue
            out.append(PeerInfo(ps.endpoint, ident,
                                SerializedIdentity.decode(ident).mspid,
                                heights.get(ps.pki_id, 0),
                                installed.get(ps.endpoint, ())))
        return [p for p in out if VALIDATOR_CC in p.chaincodes]

    def cc_policy(channel, cc):
        info = me.definitions.validation_info(cc)
        if info is None or not info[1]:
            return None
        ap = pb.ApplicationPolicy.decode(info[1])
        return ap.signature_policy if ap.which("type") == \
            "signature_policy" else None

    writers = me.bundle.policy_manager.get_policy(
        "/Channel/Application/Writers")

    def acl_check(channel, sd):
        if not writers.evaluate_signed_data([sd], csp):
            raise PermissionError("discovery request does not satisfy the "
                                  "channel's Writers policy")

    svc = DiscoveryService(DiscoverySupport(
        channels=lambda: [ENDORSE_CHANNEL], bundle=lambda ch: me.bundle,
        peers=members, msp_configs=lambda ch: {}, orderer_endpoints=lambda
        ch: {}, chaincode_policy=cc_policy,
        collection_filter=lambda ch, cc, colls: (lambda p: True),
        acl_check=acl_check), csp)
    server = RPCServer(tls=credentials_from_ca(tls_ca, "discovery"))
    server.register("discovery.Discover", lambda body, stream: svc.process(
        dpb.SignedRequest.decode(body)).encode())
    server.start()
    client_tls = credentials_from_ca(tls_ca, "discovery-client")

    def send(sreq):
        return dpb.Response.decode(RPCClient(
            *server.addr, tls=client_tls, timeout=30.0).call(
                "discovery.Discover", sreq.encode()))

    return server, send


def phase_gateway(device, world: ValidatorWorld, cluster: RaftCluster,
                  tmp: str, endorse: dict):
    """A client's transactions through discovery and the gateway to five
    peers joined by gossip, on the raft cluster's second channel.  Five
    fresh peers (Org1-5) start behind the channel's blocks, one after
    another, each on its own root, joined by `TCPGossipComm` (mutual
    TLS); Org1's peer, elected before the others start, alone runs its
    deliver client, the others
    take the blocks by gossip (push, pull, state transfer), and each
    commits through `PrivDataCoordinator` into B1; their states must be
    phase_endorse's.  `DiscoveryService` on Org1's peer answers the
    client over RPC with `benchcc`'s descriptor (four layouts, three of
    Org1-4).  Then two blocks' worth of ENDORSE_TXS proposals (the
    endorse cell's planted faults in the first), each endorsed at the
    peers `select_endorsers` picks, submitted back to back through one
    `Gateway` over `orderer_stream_connect` to the three orderers'
    `ab.BroadcastStream` (a follower first), its status read off Org2's
    blocks.  Planted: GATEWAY_DUPS resubmitted in flight (dedup), a raise
    at the gateway's GATEWAY_TEAR_AT-th stream write (failover, the
    unresolved window resubmitted, its ordered copies DUPLICATE_TXID),
    Org5's peer stopped after the first worth and restarted after the
    second (catch-up by state transfer alone)."""
    genesis_raw = cluster.geneses[1]
    root = os.path.join(tmp, "gateway")
    tls_ca = CA("tlsca.gossip.example.com", "gossip.example.com",
                rng=np.random.default_rng(GATEWAY_SEED))
    ports = [free_port() for _ in range(GATEWAY_PEERS)]
    events: list = []
    peers: list = []
    stop = threading.Event()
    server = None
    t_phase = time.perf_counter()
    pk.launches_keytab = 0
    pk.launches_lanekeys = 0

    def start_peer(k, restart=False):
        return GossipPeer(device, world, k, root, cluster, genesis_raw,
                          tls_ca, ports[k], peers[0].endpoint if peers
                          else None, events, restart=restart)

    try:
        for k in range(GATEWAY_PEERS):
            peers.append(start_peer(k))
            if k:
                wait_for(lambda: len(peers[0].service.discovery
                                     .alive_peers()) == k,
                         f"{peers[k].name} in the bootstrap's membership",
                         poll=0.05)
            else:
                # Org1's peer leads before the others start: each hears
                # its declarations within its own startup ticks
                wait_for(lambda: peers[0].handle.election.is_leader,
                         f"{peers[0].name} to lead", poll=0.05)
        t_start = time.perf_counter() - t_phase
        target = endorse["height"]
        wait_for(lambda: all(p.height >= target for p in peers),
                 f"the five peers at height {target}", poll=0.05,
                 on_timeout=lambda: str([p.height for p in peers]))
        t_catch = time.perf_counter() - t_phase
        for p in peers:
            check(state_pairs(p.ledger) == endorse["state"],
                  f"{p.name}'s state after the catch-up differs from "
                  "phase_endorse's peers'")
        caught = [p.sources() for p in peers]
        server, send = gateway_discovery(peers, tls_ca)
        return gateway_cell(world, cluster, peers, send, start_peer, events,
                            stop, target, {"start_s": t_start,
                                           "catch_s": t_catch,
                                           "caught": caught,
                                           "t_phase": t_phase})
    finally:
        stop.set()
        if server is not None:
            server.stop()
        for p in peers:
            if p is not None:
                p.stop()


def gateway_cell(world: ValidatorWorld, cluster: RaftCluster, peers: list,
                 send, start_peer, events: list, stop: threading.Event,
                 start_height: int, setup: dict) -> dict:
    """phase_gateway's discovery, traffic, checks and prints."""
    from fabric_tpu_torch.common.metrics import GatewayMetrics
    from fabric_tpu_torch.discovery import DiscoveryClient, select_endorsers
    from fabric_tpu_torch.gateway import Gateway, orderer_stream_connect
    from fabric_tpu_torch.peer.endorser import ACLDeniedError, EndorserError

    ch = ENDORSE_CHANNEL
    rng = np.random.default_rng(GATEWAY_SEED)
    pick = random.Random(GATEWAY_SEED)
    client = world.client
    outsider = orderer_identity(world, "gateway-outsider", ou="client")
    by_endpoint = {p.endpoint: p for p in peers}

    # -- discovery
    desc = DiscoveryClient(client, send).endorsers(ch, VALIDATOR_CC)
    layouts = sorted(tuple(sorted(lay.quantities_by_group.items()))
                     for lay in desc.layouts)
    groups = {g: sorted(p.endpoint for p in grp.peers)
              for g, grp in desc.endorsers_by_groups.items()}
    check(len(layouts) == 4 and all(len(lay) == 3 for lay in layouts)
          and sorted(groups) == ["G0", "G1", "G2", "G3"]
          and all(len(v) == 1 for v in groups.values())
          and peers[GATEWAY_PEERS - 1].endpoint not in
          {e for v in groups.values() for e in v},
          f"benchcc's descriptor: layouts {layouts}, groups {groups}")
    members = DiscoveryClient(client, send).peers(ch)

    # -- the proposals, endorsed at the picked peers
    def proposal(args, signer=client, tamper=False):
        prop, _ = pu.create_chaincode_proposal(
            signer.serialize(), ch, VALIDATOR_CC, args, nonce=rng.bytes(24))
        raw = prop.encode()
        sig = signer.sign(b"not the proposal" if tamper else raw)
        return prop, pb.SignedProposal(proposal_bytes=raw, signature=sig)

    def endorse_worth(w: int):
        plan = ENDORSE_PLAN if w == 0 else {}
        envs, kinds, ks, refusals = [], [], [], {}
        k = 0
        t0 = time.perf_counter()
        while len(envs) < ENDORSE_TXS:
            kind = plan.get(k)
            read = f"gr-{w}-{k}"
            if isinstance(kind, tuple):
                read = f"gw-{w}-{kind[1]}"
            args = [b"rw", read.encode(), f"gw-{w}-{k}".encode(), b"v%d" % k]
            signer = client
            if kind == "status_500":
                args = [b"fail"]
            elif kind == "outsider":
                signer = outsider
            prop, sp = proposal(args, signer, tamper=kind == "bad_signature")
            chosen = [by_endpoint[p.endpoint]
                      for p in select_endorsers(desc, pick)]
            if kind == "two_endorsements":
                chosen = chosen[:2]
            # the endorsers at once, as the reference's client calls them
            futs = [pool.submit(p.process, sp) for p in chosen]
            concurrent.futures.wait(futs)
            try:
                resps = [f.result() for f in futs]
            except (ACLDeniedError, EndorserError) as exc:
                refusals[k] = type(exc).__name__
                k += 1
                continue
            if resps[0].response.status >= 400:
                refusals[k] = resps[0].response.status
                k += 1
                continue
            envs.append(pu.create_signed_tx(prop, client, resps).encode())
            kinds.append(kind)
            ks.append(k)
            k += 1
        return envs, kinds, ks, refusals, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(3)
    # -- the gateway
    stream_log: list = []
    lead = cluster.leader(ch)
    order = [n for n in RAFT_NODES if n != lead] + [lead]

    def connect_to(n):
        base = orderer_stream_connect(cluster.nodes[n].addr, timeout=30.0,
                                      tls=cluster.client_tls)
        return lambda: CountedStream(base(), stream_log)

    observed: list = []
    metrics = GatewayMetrics(PrometheusProvider())
    hist = metrics.submit_to_commit_seconds

    class Observed:
        def With(self, *labels):
            inner = hist.With(*labels)

            class Child:
                def observe(self, v):
                    observed.append(v)
                    inner.observe(v)

            return Child()

    metrics.submit_to_commit_seconds = Observed()
    tail = peers[1]
    gw = Gateway(ch, [connect_to(n) for n in order],
                 deliver_endpoints=[ledger_tail(tail.ledger, stop)],
                 start_height=tail.height, name="gateway", metrics=metrics,
                 min_window=GATEWAY_WINDOW[0], max_window=GATEWAY_WINDOW[1],
                 initial_window=GATEWAY_WINDOW[0], max_backoff_s=0.5)
    gw.start()
    dedup: list = []
    worths = []
    gone = None
    try:
        for w in range(ENDORSE_BLOCKS):
            envs, kinds, ks, refusals, t_endorse = endorse_worth(w)
            plan = ({"faults": [{"point": "gateway.stream.write",
                                 "action": "raise", "error": "OSError",
                                 "nth": GATEWAY_TEAR_AT}]} if w == 0
                    else None)
            t0 = time.perf_counter()
            with (faultline.use_plan(plan) if plan
                  else contextlib.nullcontext()):
                for i, env in enumerate(envs):
                    res = gw.submit(env)
                    while not res.accepted:
                        time.sleep(res.retry_after_s)
                        res = gw.submit(env)
                    if w == 0 and i in GATEWAY_DUPS:
                        before = gw.in_flight
                        again = gw.submit(env)
                        dedup.append((again.accepted, again.dedup,
                                      again.status, gw.in_flight - before))
                t_sent = time.perf_counter()
                txids = [pu.channel_header(cb.Envelope.decode(e)).tx_id
                         for e in envs]
                wait_for(lambda: all(gw.status(t) not in ("PENDING", None)
                                     for t in txids),
                         f"worth {w}'s statuses", on_timeout=lambda: (
                             f"{sum(gw.status(t) == 'PENDING' for t in txids)}"
                             f" pending, heights "
                             f"{[p.height for p in peers if p]}"))
            t_resolved = time.perf_counter()
            running = [p for p in peers if p is not None]
            # every copy ordered: the leader's cutter empty, then its height
            wait_for(lambda: cluster.nodes[lead].chan(ch).get("pending") == 0,
                     f"the leader's cutter to empty after worth {w}",
                     poll=0.1)
            top = cluster.nodes[lead].chan(ch)["height"]
            wait_for(lambda: all(p.height >= top for p in running),
                     f"worth {w}'s blocks at every running peer",
                     on_timeout=lambda: str([p.height for p in running]))
            t_all = time.perf_counter()
            worths.append({"envs": envs, "kinds": kinds, "ks": ks,
                           "txids": txids,
                           "refusals": refusals, "t_endorse": t_endorse,
                           "t0": t0, "t_sent": t_sent,
                           "t_resolved": t_resolved, "t_all": t_all,
                           "top": top, "peers": len(running)})
            if w == 0:
                # Org5's peer leaves, every block of the first worth in
                # its ledger
                gone = peers[GATEWAY_PEERS - 1]
                peers[GATEWAY_PEERS - 1] = None
                gone.stop()
    finally:
        stop.set()  # the tail's generator, then the gateway
        gw.stop()
        pool.shutdown()
    # the stores let the second worth's blocks go, then Org5's peer comes
    # back on its root
    running = [p for p in peers if p is not None]
    wait_for(lambda: all(not p.handle.gossip.store.digests()
                         for p in running),
             "the gossip stores to empty", poll=0.1)
    t_back = time.perf_counter()
    peers[GATEWAY_PEERS - 1] = late = start_peer(GATEWAY_PEERS - 1,
                                                 restart=True)
    top = worths[-1]["top"]
    wait_for(lambda: late.height >= top, "Org5's peer to catch up",
             on_timeout=lambda: f"at {late.height} of {top}")
    t_caught = time.perf_counter() - t_back
    t_phase = time.perf_counter() - setup["t_phase"]
    launches = {B1_NAME: pk.launches_keytab, B2_NAME: pk.launches_lanekeys}

    # -- checks
    lo = start_height
    flags = [p.flags_of(lo, top) for p in peers]
    check(all(f == flags[0] for f in flags), "the five peers' flags differ")
    states = [state_pairs(p.ledger) for p in peers]
    check(all(s == states[0] for s in states), "the five peers' states "
          "differ")
    blocks = [tail.ledger.get_block_by_number(n) for n in range(lo, top)]
    first: dict = {}  # txid -> (block, index, flag)
    copies = collections.Counter()
    dup_flags = []
    for n, (blk, fl) in enumerate(zip(blocks, flags[0])):
        for i, raw in enumerate(blk.data.data):
            txid = pu.channel_header(cb.Envelope.decode(raw)).tx_id
            copies[txid] += 1
            if txid in first:
                dup_flags.append(fl[i])
            else:
                first[txid] = (n, i, fl[i])
    all_txids = [t for wv in worths for t in wv["txids"]]
    check(set(first) == set(all_txids) and len(all_txids) == len(set(
        all_txids)), f"{len(set(all_txids) - set(first))} submitted txids "
          f"not ordered, {len(set(first) - set(all_txids))} unknown")
    check(all(f == pb.DUPLICATE_TXID for f in dup_flags),
          f"a second copy's flags {collections.Counter(dup_flags)}")
    predicted = {}
    for wv in worths:
        for txid, kind in zip(wv["txids"], wv["kinds"]):
            want = pb.VALID
            if kind == "two_endorsements":
                want = pb.ENDORSEMENT_POLICY_FAILURE
            elif isinstance(kind, tuple):
                # a read of a key that an earlier transaction writes:
                # stale once that write is ordered first
                writer = wv["txids"][wv["ks"].index(kind[1])]
                want = (pb.MVCC_READ_CONFLICT if first[writer][:2]
                        < first[txid][:2] else pb.VALID)
            predicted[txid] = want
    got_flags = {t: first[t][2] for t in all_txids}
    check(got_flags == predicted, "flags differ from the prediction on "
          f"{sum(got_flags[t] != predicted[t] for t in all_txids)} "
          "transactions")
    statuses = {t: gw.status(t) for t in all_txids}
    check(not any(s in ("TIMEOUT", "PENDING", None)
                  for s in statuses.values()),
          f"statuses {collections.Counter(statuses.values())}")
    check(all(statuses[t] == ("VALID" if got_flags[t] == pb.VALID
                              else "INVALID") for t in all_txids),
          "a status differs from the peers' flag")
    want_refusals = {k: {"bad_signature": "EndorserError",
                         "outsider": "ACLDeniedError",
                         "status_500": 500}[v]
                     for k, v in ENDORSE_PLAN.items() if isinstance(v, str)
                     and v in ("bad_signature", "outsider", "status_500")}
    check(worths[0]["refusals"] == want_refusals and
          not worths[1]["refusals"], f"refusals "
          f"{[sorted(wv['refusals'].items()) for wv in worths]}")
    check(dedup == [(True, True, "PENDING", 0)] * len(GATEWAY_DUPS),
          f"the in-flight resubmissions {dedup}")
    log = list(gw.endpoint_log)
    check(gw.failovers >= 1 and len(set(log)) >= 2,
          f"failovers {gw.failovers}, endpoints {log}")
    running_at = set()
    overlap = False
    for _, k, what in sorted(events):
        if what == "start":
            running_at.add(k)
            overlap |= len(running_at) > 1
        else:
            running_at.discard(k)
    leaders = sorted({k for _, k, what in events if what == "start"})
    for p in [*peers, gone]:
        print(f"gateway: {p.commit_report()}")
    check(not overlap and leaders == [0],
          f"deliver clients {sorted(events)}")
    check(late.client.delivered == 0 and gone.client.delivered == 0
          and late.handle.state.requests_sent
          and late.handle.state.blocks_received >= 1
          and sum(late.handle.gossip.received.values()) == 0,
          f"Org5's restart: {late.sources()}, requests "
          f"{list(late.handle.state.requests)}")
    per_peer = [p.launches for p in peers]
    per_peer[-1] += gone.launches
    check(all(n > 0 for n in per_peer), f"B1 launches a peer {per_peer}")

    # -- prints
    sizes = [len(b.data.data) for b in blocks]
    print(f"gateway: five peers (tick {GATEWAY_TICK_S} s, alive "
          f"expiration {GATEWAY_ALIVE_TICKS} ticks, election timeout "
          f"{GATEWAY_LEADER_TIMEOUT} ticks, {GATEWAY_STARTUP_TICKS} ticks "
          f"before a first declaration, store TTL {GATEWAY_TTL_TICKS} "
          f"ticks) up in {setup['start_s']:.2f} s, at height "
          f"{start_height} (phase_endorse's state) {setup['catch_s']:.2f} s"
          f" from the start; blocks by source at the catch-up "
          f"{setup['caught']}")
    print(f"gateway: discovery on {peers[0].name}: {len(members)} peers "
          f"with {VALIDATOR_CC}, descriptor layouts {layouts}")
    for w, wv in enumerate(worths):
        n = len(wv["envs"])
        acks = [t for t, what in stream_log if what == "ack"
                and wv["t0"] <= t <= wv["t_resolved"]]
        sends = [t for t, what in stream_log if what == "send"
                 and wv["t0"] <= t <= wv["t_resolved"]]
        span = max(acks + sends) - wv["t0"]
        print(f"gateway: worth {w}: {n} transactions endorsed in "
              f"{wv['t_endorse']:.2f} s (refusals "
              f"{sorted(wv['refusals'].items())}); submitted in "
              f"{(wv['t_sent'] - wv['t0']) * 1e3:.1f} ms; {len(sends)} "
              f"envelopes through ab.BroadcastStream, {len(acks)} acked, "
              f"{len(sends) / span:.0f} envelopes/s; all resolved "
              f"{wv['t_resolved'] - wv['t0']:.2f} s after the first "
              f"submission; committed at all {wv['peers']} running peers "
              f"{wv['t_all'] - wv['t0']:.2f} s after it = "
              f"{n / (wv['t_all'] - wv['t0']):.0f} committed tx/s")
    lags = []
    for n in range(lo, top):
        times = [p.committed_at[n] for p in peers[:-1] if n in
                 p.committed_at]
        if n in peers[0].committed_at and len(times) == len(peers) - 1:
            lags.append(max(times) - peers[0].committed_at[n])
    obs = sorted(observed)
    print(f"gateway: submit to commit p50 {statistics.median(obs):.3f} s, "
          f"p99 {obs[int(len(obs) * 0.99)]:.3f} s over {len(obs)} "
          f"(GatewayMetrics); window {gw.window}; failovers "
          f"{gw.failovers}, endpoints {log}; dedup hits "
          f"{len(dedup)}; copies ordered twice {len(dup_flags)} "
          "(DUPLICATE_TXID at every peer)")
    print(f"gateway: blocks {sizes}; the leader's commit to the last "
          f"peer's, a block: median {statistics.median(lags) * 1e3:.1f} ms,"
          f" max {max(lags) * 1e3:.1f} ms over {len(lags)} blocks")
    print(f"gateway: blocks by source {[p.sources() for p in peers]} "
          f"(Org5's stopped incarnation {gone.sources()}); Org5's restart "
          f"caught up {top - worths[0]['top']} blocks in {t_caught:.2f} s "
          f"by state transfer, {late.handle.state.requests_sent} requests "
          f"{sorted(set(late.handle.state.requests))}; the deliver client "
          f"ran on {[peers[k].name for k in leaders]} alone")
    print(f"gateway: flags {dict(collections.Counter(got_flags.values()))}"
          f" as predicted, statuses "
          f"{dict(collections.Counter(statuses.values()))}; B1 launches a "
          f"peer {per_peer}, launches {launches}; the phase {t_phase:.1f} s")
    return {"launches": launches, "wall_s": t_phase, "per_peer": per_peer}


# ---------------------------------------------------------------------------
# A network started from the command line: the port's cryptogen and
# configtxgen, then one orderer and three peers as processes of the port's
# CLIs, each peer validating its blocks on the card.
# ---------------------------------------------------------------------------

NODES_CHANNEL = "nodesch"
NODES_ORGS = 3  # Org1-3, one peer each
NODES_TXS = 1000  # transactions a worth, one block's
NODES_WORTHS = 3
NODES_KILL_WORTH = 1  # Org3's peer is killed during this worth's
NODES_SEED = 43
NODES_WORKERS = 16  # the client's proposals in flight
NODES_WINDOW = 64  # envelopes unacknowledged on the broadcast stream
NODES_WAIT_S = 120.0  # the longest wait for any one step
NODES_STOP_S = 30.0  # a process must exit this soon after SIGTERM
NODES_TRACE_EVENTS = 1 << 18  # each peer's flight recorder (FABRIC_TPU_TRACE)
NODES_TOOLS_COUNT = 500  # the tools pass's BatchSize.MaxMessageCount
# the endorse cell's five faults, by proposal index of the first worth: a
# bad creator signature, a creator outside the channel's writers, a
# chaincode status of 500, too few endorsements (one of the three: the
# channel's default MAJORITY Endorsement needs two), and a read of the key
# an earlier transaction of the block writes
NODES_PLAN = {3: "bad_signature", 5: "outsider", 7: "status_500",
              9: "one_endorsement", 14: ("reads_write_of", 12)}

# the peers' chaincode, written with the port's shim and installed by a
# `--chaincode benchcc=nodes_kv:KV` spec: one read and one write a
# transaction, the whole state as JSON, the process's modules of the JAX
# package, or a refusal
NODES_KV = '''"""The KV chaincode of chip_smoke.phase_nodes."""

import json
import sys

from fabric_tpu_torch.chaincode.shim import Chaincode, error, success


class KV(Chaincode):
    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "rw":
            got = stub.get_state(params[0].decode())
            stub.put_state(params[1].decode(), params[2])
            return success(got or b"")
        if fn == "get":
            return success(stub.get_state(params[0].decode()) or b"")
        if fn == "range":
            return success(json.dumps(
                {k: v.decode() for k, v in stub.get_state_by_range("", "")},
                sort_keys=True).encode())
        if fn == "modules":
            return success(json.dumps(sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "fabric_tpu"))
            ).encode())
        if fn == "fail":
            return error("refused by the chaincode", status=500)
        return error(f"unknown function {fn!r}")
'''


def nodes_crypto_config(n_orgs: int = NODES_ORGS) -> str:
    """crypto-config.yaml: the orderer org and Org1..n, a peer and a user
    each (the layout of `tests/test_nwo.py`)."""
    return ("OrdererOrgs:\n"
            "  - Name: Orderer\n    Domain: example.com\n"
            "    Specs: [{Hostname: orderer}]\n"
            "PeerOrgs:\n" + "".join(
                f"  - Name: Org{i}\n    Domain: org{i}.example.com\n"
                "    Template: {Count: 1}\n    Users: {Count: 1}\n"
                for i in range(1, n_orgs + 1)))


def nodes_configtx(n_orgs: int = NODES_ORGS) -> str:
    """configtx.yaml: a solo profile with phase_order's batch values."""
    orgs = ", ".join(f"Org{i}" for i in range(1, n_orgs + 1))
    return ("Organizations:\n"
            "  - Name: OrdererOrg\n    ID: OrdererMSP\n"
            "    MSPDir: crypto-config/ordererOrganizations/example.com/msp\n"
            + "".join(
                f"  - Name: Org{i}\n    ID: Org{i}MSP\n    MSPDir: "
                f"crypto-config/peerOrganizations/org{i}.example.com/msp\n"
                for i in range(1, n_orgs + 1))
            + "Profiles:\n"
            "  Nodes:\n"
            "    Orderer:\n"
            "      OrdererType: solo\n"
            f"      BatchTimeout: {ORDER_TIMEOUT}\n"
            "      BatchSize:\n"
            f"        MaxMessageCount: {ORDER_MAX_COUNT}\n"
            f"        AbsoluteMaxBytes: {ORDER_ABSOLUTE}\n"
            f"        PreferredMaxBytes: {ORDER_PREFERRED}\n"
            "      Organizations: [OrdererOrg]\n"
            "    Application:\n"
            f"      Organizations: [{orgs}]\n")


def ops_get(port: int, path: str) -> tuple[int, bytes]:
    """(status, body) of a GET on an operations endpoint."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class NodeProcess:
    """One orderer or peer process of the port's CLI: its argv (ports
    filled in at each start), its log, its operations endpoint."""

    def __init__(self, name: str, argv, env: dict, root: str, client_tls,
                 ops_env: str | None = None):
        self.name = name
        self._argv = argv  # (listen port, operations port) -> argv
        self.env = env
        # the variable that gives the operations address, where the CLI
        # takes it from its config and not from a flag
        self._ops_env = ops_env
        self.log_path = os.path.join(root, f"{name}.log")
        self._tls = client_tls
        self.proc = None
        self.port = self.ops = 0
        self.t_start = 0.0
        self.t_first = 0.0  # the first life's start
        self._log_start = 0
        self._client = None

    def start(self) -> float:
        """Starts the process and waits until it listens; returns the
        seconds.  A port taken between the probe and the bind is retried
        on other ports."""
        for _ in range(3):
            self.port, self.ops = free_port(), free_port()
            with open(self.log_path, "ab") as log:
                self._log_start = log.tell()
                self.t_start = time.monotonic()
                if not self.t_first:
                    self.t_first = self.t_start
                env = self.env if self._ops_env is None else dict(
                    self.env, **{self._ops_env: f"127.0.0.1:{self.ops}"})
                self.proc = subprocess.Popen(
                    [sys.executable, "-m", *self._argv(self.port, self.ops)],
                    stdout=log, stderr=subprocess.STDOUT, env=env)
            while True:
                if "listening on" in self.log_tail(1 << 20):
                    return time.monotonic() - self.t_start
                if self.proc.poll() is not None:
                    break
                check(time.monotonic() - self.t_start < NODES_WAIT_S,
                      f"{self.name} did not listen: {self.log_tail()}")
                time.sleep(0.02)
            if "Address already in use" not in self.log_tail():
                break
        check(False, f"{self.name} exited with {self.proc.returncode}: "
              f"{self.log_tail()}")

    def log_tail(self, n: int = 3000) -> str:
        """The end of this life's log."""
        try:
            with open(self.log_path, "rb") as f:
                f.seek(self._log_start)
                return f.read()[-n:].decode("utf-8", "replace")
        except FileNotFoundError:
            return ""

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    def rpc(self) -> RPCClient:
        """A client of this life's port (one TLS context, shared by the
        threads that call it)."""
        if self._client is None or self._client._addr[1] != self.port:
            self._client = RPCClient("127.0.0.1", self.port, tls=self._tls,
                                     timeout=60)
        return self._client

    def height(self, ch: str) -> int:
        return int(self.rpc().call("admin.Height", ch.encode()))

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def terminate(self) -> tuple[int, float]:
        """SIGTERM; (exit code, seconds to exit), or (None, s) when it did
        not exit within NODES_STOP_S (then it is killed)."""
        t0 = time.monotonic()
        self.proc.terminate()
        try:
            rc = self.proc.wait(timeout=NODES_STOP_S)
        except subprocess.TimeoutExpired:
            self.kill()
            rc = None
        return rc, time.monotonic() - t0


class PeerTrace:
    """A peer's trace events, read from its /traces by cursor, a list a
    life (a restarted process starts a new recorder, and its span ids
    start again)."""

    def __init__(self):
        self.lives: list = [[]]
        self._cursor = None

    def poll(self, ops_port: int) -> None:
        path = "/traces" if self._cursor is None else \
            f"/traces?since={self._cursor}"
        status, body = ops_get(ops_port, path)
        check(status == 200, f"/traces answered {status}")
        doc = json.loads(body)
        check(doc["otherData"]["armed"], "a peer's tracing is not armed")
        self.lives[-1] += doc["traceEvents"]
        self._cursor = doc["otherData"]["last_event_id"]

    def new_life(self) -> None:
        self.lives.append([])
        self._cursor = None

    def dispatches(self) -> list:
        """The args of every `tpu.dispatch` span: the flush's device and
        the launches its kernels' wrappers counted in the peer."""
        return [ev["args"] for events in self.lives for ev in events
                if ev.get("ph") == "X" and ev["name"] == "tpu.dispatch"]

    def blocks(self) -> dict:
        """block number -> {lanes, device_lanes, ms, life, end_s}: the
        tpu.collect spans under each block's verify_wait, and the block's
        collect, verify_wait and policy spans."""
        out: dict = {}
        for life, events in enumerate(self.lives):
            spans = {ev["args"]["span"]: ev for ev in events
                     if ev.get("ph") == "X"}
            for ev in spans.values():
                a = ev["args"]
                if ev["name"] in ("collect", "verify_wait", "policy") \
                        and "block" in a:
                    check(out.get(a["block"], {}).get("life", life) == life,
                          f"block {a['block']} validated in two lives")
                    b = out.setdefault(a["block"], {
                        "lanes": 0, "device_lanes": {}, "ms": 0.0,
                        "life": life, "end_s": 0.0})
                    b["ms"] += ev["dur"] / 1e3
                    # the process's monotonic clock, the host's
                    b["end_s"] = max(b["end_s"],
                                     (ev["ts"] + ev["dur"]) / 1e6)
            for ev in spans.values():
                if ev["name"] != "tpu.collect":
                    continue
                parent = spans.get(ev["args"].get("parent"))
                check(parent is not None and parent["name"] == "verify_wait",
                      "a tpu.collect span outside a block's verify_wait")
                b = out[parent["args"]["block"]]
                b["lanes"] += ev["args"]["lanes"]
                b["device_lanes"][(life, ev["args"]["batch"])] = \
                    ev["args"]["device_lanes"]
        return out


def nodes_block_view(raw_blocks: list) -> tuple[dict, list, list]:
    """({txid: flag}, block sizes, lanes a block) of delivered blocks:
    a creator lane and one a endorsement for each transaction."""
    flags, sizes, lanes = {}, [], []
    for blk in raw_blocks:
        filt = pu.tx_filter(blk)
        sizes.append(len(blk.data.data))
        n = 0
        for i, raw in enumerate(blk.data.data):
            env = cb.Envelope.decode(raw)
            payload = cb.Payload.decode(env.payload)
            txid = cb.ChannelHeader.decode(
                payload.header.channel_header).tx_id
            flags[txid] = filt[i]
            tx = pb.Transaction.decode(payload.data)
            cap = pb.ChaincodeActionPayload.decode(tx.actions[0].payload)
            n += 1 + len(cap.action.endorsements)
        lanes.append(n)
    return flags, sizes, lanes


def phase_nodes(device, tmp: str, n_txs: int = NODES_TXS,
                n_worths: int = NODES_WORTHS) -> dict:
    """A network started the way a user starts one (README "Running a
    network on the port"): the port's cryptogen and configtxgen write the
    material of an orderer org and Org1-3 and a solo channel with
    phase_order's batch values (in this process); an orderer and three
    peers start as processes of `python -m fabric_tpu_torch.cmd.orderer` and
    `... cmd.peer node start`, each on its own root and operations port,
    the peers on `sampleconfig/core.yaml` (`bccsp.default: TPU`: CUDACSP
    on the card), with the KV chaincode by `--chaincode` spec and tracing
    armed; `peer channel join` joins each.  Then `n_worths` worths of
    `n_txs` transactions (a read and a write each), each proposal endorsed
    at the three peers and each worth broadcast to the orderer process
    once endorsed, the endorse cell's five faults planted in the first
    worth; Org3's peer is killed (SIGKILL) during the second worth (after
    its endorsements, before the broadcast) and started again on its root
    once the others have committed the worth's block, which it then
    takes from the orderer.  Every peer must reach the same height with the planted flags,
    equal at the three, the same state through `peer chaincode query`,
    /healthz OK, no device failure, `tpu.collect` spans whose lanes add up
    to each block's, and exit 0 on SIGTERM."""
    from fabric_tpu_torch.cmd import configtxgen, cryptogen
    from fabric_tpu_torch.cmd.common import load_signer
    from fabric_tpu_torch.comm.tls import credentials_from_files

    root = os.path.join(tmp, "nodes")
    os.makedirs(root)
    repo = os.path.dirname(os.path.abspath(__file__))
    ch = NODES_CHANNEL
    t0 = time.perf_counter()
    with open(os.path.join(root, "crypto-config.yaml"), "w") as f:
        f.write(nodes_crypto_config())
    with open(os.path.join(root, "configtx.yaml"), "w") as f:
        f.write(nodes_configtx())
    with open(os.path.join(root, "nodes_kv.py"), "w") as f:
        f.write(NODES_KV)
    cc_dir = os.path.join(root, "crypto-config")
    check(cryptogen.main(["generate", "--config",
                          os.path.join(root, "crypto-config.yaml"),
                          "--output", cc_dir]) == 0, "cryptogen failed")
    t1 = time.perf_counter()
    block_path = os.path.join(root, f"{ch}.block")
    check(configtxgen.main(["-profile", "Nodes", "-channelID", ch,
                            "-outputBlock", block_path,
                            "-configPath", root]) == 0, "configtxgen failed")
    t2 = time.perf_counter()

    ordo = os.path.join(cc_dir, "ordererOrganizations", "example.com")
    org = [os.path.join(cc_dir, "peerOrganizations", f"org{i}.example.com")
           for i in range(1, NODES_ORGS + 1)]
    tlscas = [os.path.join(ordo, "tlsca", "tlsca.example.com-cert.pem")] + [
        os.path.join(o, "tlsca", f"tlsca.org{i + 1}.example.com-cert.pem")
        for i, o in enumerate(org)]
    user = os.path.join(org[0], "users", "User1@org1.example.com")
    client = load_signer(os.path.join(user, "msp"), "Org1MSP")
    outsider = load_signer(os.path.join(ordo, "users", "Admin@example.com",
                                        "msp"), "OrdererMSP")
    client_tls = credentials_from_files(
        os.path.join(user, "tls", "client.crt"),
        os.path.join(user, "tls", "client.key"), tlscas)
    roots = [a for path in tlscas for a in ("--tls-root", path)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo, root])
    env["FABRIC_CFG_PATH"] = os.path.join(repo, "sampleconfig")
    # the nodes' CSP comes from their config files alone: on the card
    # CUDACSP on "cuda", in a rehearsal on the CPU its plain versions
    for k in [k for k in env if k.startswith(("CORE_BCCSP_",
                                              "ORDERER_GENERAL_BCCSP_"))]:
        del env[k]
    if device.type == "cpu":
        env["CORE_BCCSP_TPU_DEVICE"] = "cpu"
        env["ORDERER_GENERAL_BCCSP_TPU_DEVICE"] = "cpu"
    peer_env = dict(env, FABRIC_TPU_TRACE=str(NODES_TRACE_EVENTS))
    oroot = os.path.join(ordo, "orderers", "orderer.example.com")

    def orderer_argv(port, ops):
        return ["fabric_tpu_torch.cmd.orderer", "--listen",
                f"127.0.0.1:{port}", "--root", os.path.join(root, "orderer"),
                "--genesis", block_path, "--mspid", "OrdererMSP",
                "--msp-dir", os.path.join(oroot, "msp"), "--tls-dir",
                os.path.join(oroot, "tls"), *roots]

    orderer = NodeProcess("orderer", orderer_argv, env, root, client_tls,
                          ops_env="ORDERER_OPERATIONS_LISTENADDRESS")

    def peer_argv(k):
        proot = os.path.join(org[k], "peers", f"peer0.org{k + 1}.example.com")

        def argv(port, ops):
            return ["fabric_tpu_torch.cmd.peer", "node", "start", "--listen",
                    f"127.0.0.1:{port}", "--root",
                    os.path.join(root, f"peer{k}"), "--mspid",
                    f"Org{k + 1}MSP", "--msp-dir", os.path.join(proot, "msp"),
                    "--orderer", orderer.endpoint, "--chaincode",
                    f"{VALIDATOR_CC}=nodes_kv:KV", "--tls-dir",
                    os.path.join(proot, "tls"), *roots,
                    "--operations-port", str(ops)]
        return argv

    peers = [NodeProcess(f"peer0.org{k + 1}", peer_argv(k), peer_env, root,
                         client_tls) for k in range(NODES_ORGS)]
    traces = [PeerTrace() for _ in peers]
    procs = [orderer] + peers
    rng = np.random.default_rng(NODES_SEED)
    out: dict = {}
    try:
        up = {"orderer": orderer.start()}
        with concurrent.futures.ThreadPoolExecutor(len(peers)) as pool:
            for p, s in zip(peers, pool.map(NodeProcess.start, peers)):
                up[p.name] = s
        t3 = time.perf_counter()

        def cli(args, admin_of: int | None = None):
            """A run of the port's peer CLI as an org's admin or the
            client user (TLS on)."""
            if admin_of is None:
                who, mspid = user, "Org1MSP"
            else:
                who = os.path.join(org[admin_of], "users",
                                   f"Admin@org{admin_of + 1}.example.com")
                mspid = f"Org{admin_of + 1}MSP"
            msp = ["--mspid", mspid, "--msp-dir", os.path.join(who, "msp")] \
                if args[0] == "chaincode" else []
            return subprocess.run(
                [sys.executable, "-m", "fabric_tpu_torch.cmd.peer", *args,
                 *msp, "--tls-dir", os.path.join(who, "tls"), *roots],
                env=env, capture_output=True, timeout=NODES_WAIT_S)

        with concurrent.futures.ThreadPoolExecutor(len(peers)) as pool:
            joins = list(pool.map(lambda k: cli(
                ["channel", "join", "--block", block_path, "--peer",
                 peers[k].endpoint], admin_of=k), range(len(peers))))
        for p, r in zip(peers, joins):
            check(r.returncode == 0 and r.stdout.strip()
                  == f"joined channel {ch}".encode(),
                  f"peer channel join at {p.name}: {r.stdout!r} {r.stderr!r}")

        def deliver_lines(p):
            text = ops_get(p.ops, "/metrics")[1].decode()
            return [ln for ln in text.splitlines()
                    if ln.startswith("deliver_")]

        def heights(alive=peers):
            return [p.height(ch) for p in alive]

        def reach(height, alive=peers):
            """Waits until every peer of `alive` is at `height`; the
            monotonic time each reached it."""
            at = {}
            deadline = time.monotonic() + NODES_WAIT_S
            while len(at) < len(alive):
                for p in alive:
                    if p.name not in at and p.height(ch) >= height:
                        at[p.name] = time.monotonic()
                check(time.monotonic() < deadline, f"height {height} not "
                      f"reached: {heights(alive)}, deliver metrics "
                      f"{[deliver_lines(p) for p in alive]}, logs "
                      f"{[p.log_tail(600) for p in alive]}")
                time.sleep(0.02)
            return at

        reach(1)
        t4 = time.perf_counter()
        print(f"nodes: material in {t1 - t0:.2f} s (cryptogen: an orderer "
              f"org and Org1-{NODES_ORGS}) + {t2 - t1:.2f} s (configtxgen); "
              f"processes listening after "
              + ", ".join(f"{n} {s:.2f} s" for n, s in up.items())
              + f"; joined by `peer channel join` in {t4 - t3:.2f} s")

        def proposal(k, w, kind):
            read = f"r-{w}-{k}"
            if isinstance(kind, tuple):
                read = f"w-{w}-{kind[1]}"
            args = [b"rw", read.encode(), f"w-{w}-{k}".encode(),
                    f"v{w}-{k}".encode()]
            if kind == "status_500":
                args = [b"fail"]
            signer = outsider if kind == "outsider" else client
            prop, txid = pu.create_chaincode_proposal(
                signer.serialize(), ch, VALIDATOR_CC, args,
                nonce=rng.bytes(24))
            raw = prop.encode()
            sig = signer.sign(b"not the proposal" if kind == "bad_signature"
                              else raw)
            return prop, txid, pb.SignedProposal(proposal_bytes=raw,
                                                 signature=sig).encode()

        def endorse_one(job):
            k, prop, txid, sp, endorsers = job
            try:
                resps = [pb.ProposalResponse.decode(
                    p.rpc().call("endorser.ProcessProposal", sp))
                    for p in endorsers]
            except RPCError as exc:
                return k, txid, ("refused", str(exc)[:60]), None
            if resps[0].response.status >= 400:
                return k, txid, ("status", resps[0].response.status), None
            return k, txid, None, pu.create_signed_tx(prop, client,
                                                      resps).encode()

        def broadcast(raws) -> list:
            """The envelopes over one `ab.BroadcastStream`, up to
            NODES_WINDOW unacknowledged; their statuses, in order."""
            stream = orderer.rpc().duplex("ab.BroadcastStream")
            statuses = []
            try:
                for i, raw in enumerate(raws):
                    stream.send(raw)
                    if i >= NODES_WINDOW - 1:
                        statuses.append(ob.BroadcastResponse.decode(
                            stream.recv()).status)
                while len(statuses) < len(raws):
                    statuses.append(ob.BroadcastResponse.decode(
                        stream.recv()).status)
                stream.finish()
                check(stream.recv() is None, "the stream did not end")
            finally:
                stream.close()
            return statuses

        def tool(module, *args, admin=None) -> str:
            """A run of one of the port's CLIs as its own process, as
            the client user (or the orderer org's admin); its stdout."""
            who = user if admin is None else admin
            r = subprocess.run([sys.executable, "-m", module, *args],
                               env=env, capture_output=True,
                               timeout=NODES_WAIT_S)
            check(r.returncode == 0, f"{module} {' '.join(args[:2])} "
                  f"({who}): {r.stdout[-300:]!r} {r.stderr[-1500:]!r}")
            return r.stdout.decode()

        def tools_pass(h0: int) -> dict:
            """The tools pass (README "Running a network on the port"):
            `peer channel fetch config`, configtxlator down to the
            channel's Config, its BatchSize's MaxMessageCount set from
            ORDER_MAX_COUNT to NODES_TOOLS_COUNT, `proto_encode` and
            `compute_update`, `peer channel signconfigtx` by the orderer
            org's admin and `peer channel update`; then one more worth of
            n_txs transactions through one ab.BroadcastStream, and
            `discover` against the peers.  Every peer's config sequence
            moves by one, the worth's blocks hold at most
            NODES_TOOLS_COUNT transactions, and B1's launches at each
            peer equal its chunks of device lanes for those blocks."""
            t0 = time.perf_counter()
            tdir = os.path.join(root, "tools")
            os.makedirs(tdir)
            tls = ["--tls-dir", os.path.join(user, "tls"), *roots]
            umsp = ["--mspid", "Org1MSP", "--msp-dir",
                    os.path.join(user, "msp")]
            oadmin = os.path.join(ordo, "users", "Admin@example.com")
            lator = "fabric_tpu_torch.cmd.configtxlator"
            peer_cli = "fabric_tpu_torch.cmd.peer"
            marks = {p.name: (len(tr.dispatches()), tr) for p, tr in
                     zip(peers, traces)}

            def decoded(typ, raw, name):
                src = os.path.join(tdir, f"{name}.pb")
                with open(src, "wb") as f:
                    f.write(raw)
                dst = os.path.join(tdir, f"{name}.json")
                tool(lator, "proto_decode", "--type", typ, "--input", src,
                     "--output", dst)
                with open(dst) as f:
                    return json.load(f)

            def encoded(typ, js, name):
                src = os.path.join(tdir, f"{name}.json")
                with open(src, "w") as f:
                    json.dump(js, f, indent=2)
                dst = os.path.join(tdir, f"{name}.pb")
                tool(lator, "proto_encode", "--type", typ, "--input", src,
                     "--output", dst)
                return dst

            cfg_block = os.path.join(tdir, "config.block")
            tool(peer_cli, "channel", "fetch", "config", cfg_block, "-c", ch,
                 "--orderer", orderer.endpoint, *umsp, *tls)
            with open(cfg_block, "rb") as f:
                blk = decoded("common.Block", f.read(), "block")
            env_js = decoded("common.Envelope",
                             base64.b64decode(blk["data"]["data"][0]),
                             "envelope")
            pay_js = decoded("common.Payload",
                             base64.b64decode(env_js["payload"]), "payload")
            cenv = decoded("common.ConfigEnvelope",
                           base64.b64decode(pay_js["data"]),
                           "config_envelope")
            original = cenv["config"]
            seq0 = int(original.get("sequence", "0"))
            updated = copy.deepcopy(original)
            value = updated["channel_group"]["groups"]["Orderer"]["values"][
                "BatchSize"]
            batch = ob.BatchSize.decode(base64.b64decode(value["value"]))
            check(batch.max_message_count == ORDER_MAX_COUNT,
                  f"the fetched BatchSize is {batch!r}")
            batch.max_message_count = NODES_TOOLS_COUNT
            value["value"] = base64.b64encode(batch.encode()).decode()
            upd = os.path.join(tdir, "update.pb")
            tool(lator, "compute_update", "--channel_id", ch, "--original",
                 encoded("common.Config", original, "original"),
                 "--updated", encoded("common.Config", updated, "updated"),
                 "--output", upd)
            with open(upd, "rb") as f:
                cu = f.read()
            # the CONFIG_UPDATE envelope around it, its header the orderer
            # admin's; signconfigtx adds the admin's config signature and
            # signs the envelope
            admin_id = load_signer(os.path.join(oadmin, "msp"), "OrdererMSP")
            env_path = os.path.join(tdir, "update_envelope.pb")
            with open(env_path, "wb") as f:
                f.write(cb.Envelope(payload=pu.make_payload_bytes(
                    pu.make_channel_header(cb.CONFIG_UPDATE, ch),
                    pu.make_signature_header(admin_id.serialize(),
                                             pu.random_nonce()),
                    cb.ConfigUpdateEnvelope(config_update=cu).encode()
                )).encode())
            tool(peer_cli, "channel", "signconfigtx", "-f", env_path,
                 "--mspid", "OrdererMSP", "--msp-dir",
                 os.path.join(oadmin, "msp"), admin=oadmin)
            out = tool(peer_cli, "channel", "update", "-f", env_path,
                       "--orderer", orderer.endpoint, "--tls-dir",
                       os.path.join(oadmin, "tls"), *roots, admin=oadmin)
            check(out.strip() == "update status: 200", f"update: {out!r}")
            reach(h0 + 1)
            t_config = time.perf_counter() - t0
            seqs = {}
            for p in peers:
                seek = deliver.make_seek_info_envelope(ch, h0, h0,
                                                       signer=client)
                got = [ob.DeliverResponse.decode(fr) for fr in
                       p.rpc().stream("deliver.Deliver", seek.encode())]
                cblk = next(r.block for r in got if r.which("Type") ==
                            "block")
                seqs[p.name] = cb.ConfigEnvelope.decode(cb.Payload.decode(
                    cb.Envelope.decode(cblk.data.data[0]).payload).data
                ).config.sequence
            check(all(v == seq0 + 1 for v in seqs.values()),
                  f"config sequences {seqs} after the update (was {seq0})")

            # one more worth, cut by the new count
            w = n_worths
            jobs = []
            for k in range(n_txs):
                prop, txid, sp = proposal(k, w, None)
                jobs.append((k, prop, txid, sp, peers))
            with concurrent.futures.ThreadPoolExecutor(NODES_WORKERS) as pool:
                done = sorted(pool.map(endorse_one, jobs))
            envs = [raw for _, _, refused, raw in done if refused is None]
            check(len(envs) == n_txs, f"tools worth: {len(envs)} endorsed")
            tb = time.monotonic()
            statuses = broadcast(envs)
            check(statuses == [cb.SUCCESS] * n_txs,
                  f"tools worth: statuses {collections.Counter(statuses)}")
            n_blocks = -(-n_txs // NODES_TOOLS_COUNT)
            at = reach(h0 + 1 + n_blocks)
            rates = {n: n_txs / (t - tb) for n, t in sorted(at.items())}
            seek = deliver.make_seek_info_envelope(ch, h0 + 1, h0 + n_blocks,
                                                   signer=client)
            sizes = [len(ob.DeliverResponse.decode(fr).block.data.data)
                     for fr in peers[0].rpc().stream("deliver.Deliver",
                                                     seek.encode())
                     if ob.DeliverResponse.decode(fr).which("Type")
                     == "block"]
            check(len(sizes) == n_blocks and sum(sizes) == n_txs
                  and max(sizes) <= NODES_TOOLS_COUNT,
                  f"the tools worth's blocks hold {sizes} transactions")
            # B1 at each peer, from its tpu.dispatch spans since the pass
            # began, against the chunks of the blocks it validated since
            launches = {}
            for p in peers:
                first, tr = marks[p.name]
                tr.poll(p.ops)
                blocks = tr.blocks()
                check(set(range(h0 + 1, h0 + 1 + n_blocks)) <= set(blocks),
                      f"{p.name}: blocks traced {sorted(blocks)[-6:]}")
                chunks = sum(len(cuda_provider._chunk_plan(
                    dl, cuda_provider._MAX_CHUNK))
                    for b, v in blocks.items() if b >= h0
                    for dl in v["device_lanes"].values() if dl)
                disp = tr.dispatches()[first:]
                devs = sorted({str(d.get("device")) for d in disp})
                n = sum(d.get("launches_keytab", 0) for d in disp)
                if device.type == "cuda":
                    check(chunks >= n_blocks and n == chunks and devs and all(
                        d.startswith("cuda:") for d in devs),
                          f"{p.name}: tools pass flushes on {devs}, B1 "
                          f"launched {n} times for {chunks} chunks")
                else:
                    check(chunks >= n_blocks and devs == ["cpu"] and n == 0,
                          f"{p.name}: tools pass flushes on {devs}, {n}")
                launches[p.name] = n

            # discover: each peer lists itself (a peer node's discovery
            # answers from its own view) at the new height, with benchcc
            def discover(cmd, p):
                extra = ["--chaincode", VALIDATOR_CC] if cmd == "endorsers" \
                    else []
                return json.loads(tool(
                    "fabric_tpu_torch.cmd.discover", cmd, "--channel", ch,
                    "--peer", p.endpoint, *umsp, *tls, *extra))

            calls = [("peers", p) for p in peers] + [
                ("endorsers", p) for p in peers] + [("config", peers[0])]
            with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
                answers = list(pool.map(lambda c: discover(*c), calls))
            listed = [a for (cmd, _), a in zip(calls, answers)
                      if cmd == "peers"]
            endorsers = [a for (cmd, _), a in zip(calls, answers)
                         if cmd == "endorsers"]
            height = h0 + 1 + n_blocks
            check([[(x["endpoint"], x["ledger_height"],
                     VALIDATOR_CC in x["chaincodes"]) for x in a]
                   for a in listed]
                  == [[(p.endpoint, height, True)] for p in peers]
                  and endorsers == [[p.endpoint] for p in peers]
                  and answers[-1] == {"msps": []},
                  f"discover: peers {listed}, endorsers {endorsers}, "
                  f"config {answers[-1]}")
            wall = time.perf_counter() - t0
            print(f"nodes: tools pass: `peer channel fetch config`, "
                  f"configtxlator (decode to common.Config, encode, "
                  f"compute_update), signconfigtx and `peer channel update` "
                  f"in {t_config:.2f} s; config sequence {seq0} -> "
                  f"{seq0 + 1} at every peer; BatchSize MaxMessageCount "
                  f"{ORDER_MAX_COUNT} -> {NODES_TOOLS_COUNT}: the next "
                  f"{n_txs} transactions in blocks of {sizes}; committed "
                  f"tx/s from the first broadcast: " + ", ".join(
                      f"{n} {r:.0f}" for n, r in rates.items())
                  + f"; B1 launches {launches}; discover lists the "
                  f"{len(peers)} peers at height {height} with "
                  f"{VALIDATOR_CC}'s endorsers; the pass {wall:.1f} s")
            return {"launches": sum(launches.values()), "per_peer": launches,
                    "wall_s": wall, "config_s": t_config, "rates": rates,
                    "sizes": sizes}

        predicted: dict = {}
        refusals: dict = {}
        worth_lines = []
        alive = list(peers)
        restart = {}
        for w in range(n_worths):
            plan = NODES_PLAN if w == 0 else {}
            total = n_txs + sum(1 for v in plan.values() if v in (
                "bad_signature", "outsider", "status_500"))
            jobs = []
            for k in range(total):
                kind = plan.get(k)
                prop, txid, sp = proposal(k, w, kind)
                jobs.append((k, prop, txid, sp, peers[:1]
                             if kind == "one_endorsement" else peers))
            te = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(NODES_WORKERS) as pool:
                done = sorted(pool.map(endorse_one, jobs))
            t_endorsed = time.perf_counter() - te
            envs = []
            for k, txid, refused, raw in done:
                if refused is not None:
                    refusals[(w, k)] = refused
                    continue
                kind = plan.get(k)
                predicted[txid] = (
                    pb.ENDORSEMENT_POLICY_FAILURE
                    if kind == "one_endorsement"
                    else pb.MVCC_READ_CONFLICT if isinstance(kind, tuple)
                    else pb.VALID)
                envs.append(raw)
            check(len(envs) == n_txs, f"worth {w}: {len(envs)} endorsed")
            if w == NODES_KILL_WORTH:
                # Org3's peer dies after its endorsements, before the
                # worth's block: it commits the block after its restart
                victim = peers[-1]
                traces[-1].poll(victim.ops)
                victim.kill()
                traces[-1].new_life()
                alive = peers[:-1]
            tb = time.monotonic()
            statuses = broadcast(envs)
            t_bcast = time.monotonic() - tb
            check(statuses == [cb.SUCCESS] * n_txs,
                  f"worth {w}: broadcast statuses "
                  f"{collections.Counter(statuses)}")
            at = reach(w + 2, alive)
            if w == NODES_KILL_WORTH:
                t_restart = time.monotonic()
                restart["listening_s"] = victim.start()
                at.update(reach(w + 2, [victim]))
                restart["catch_up_s"] = (at[victim.name] - t_restart
                                         - restart["listening_s"])
                alive = peers
            rates = ", ".join(
                f"{n} {n_txs / (t - tb):.0f}" for n, t in sorted(at.items())
                if not (w == NODES_KILL_WORTH and n == victim.name))
            worth_lines.append(
                f"nodes: worth {w}: {total} proposals endorsed at "
                f"{len(peers)} peers in {t_endorsed:.2f} s "
                f"({total / t_endorsed:.0f}/s), {n_txs} envelopes into the "
                f"orderer in {t_bcast:.3f} s ({n_txs / t_bcast:.0f}/s); "
                f"committed tx/s from the first broadcast: {rates}")
        for line in worth_lines:
            print(line)
        want_refusals = {(0, k): v for k, v in NODES_PLAN.items()
                         if v in ("bad_signature", "outsider", "status_500")}
        check(set(refusals) == set(want_refusals)
              and refusals[(0, 7)] == ("status", 500)
              and all(refusals[k][0] == "refused" for k in refusals
                      if k != (0, 7)),
              f"refusals {refusals}, predicted {want_refusals}")

        # -- the flags, the lanes and the state at every peer
        height = n_worths + 1
        views = []
        for p in peers:
            env_seek = deliver.make_seek_info_envelope(ch, 1, height - 1,
                                                       signer=client)
            raw_blocks = [ob.DeliverResponse.decode(fr).block for fr in
                          p.rpc().stream("deliver.Deliver", env_seek.encode())
                          if ob.DeliverResponse.decode(fr).which("Type")
                          == "block"]
            views.append(nodes_block_view(raw_blocks))
        flags, sizes, lanes = views[0]
        check(all(v == views[0] for v in views), "the peers' blocks differ")
        check(flags == predicted, "flags differ from the prediction on "
              f"{sum(flags.get(t) != f for t, f in predicted.items())} "
              "transactions")
        queries = {}
        with concurrent.futures.ThreadPoolExecutor(len(peers)) as pool:
            for p, r in zip(peers, pool.map(lambda p: cli(
                    ["chaincode", "query", "-C", ch, "-n", VALIDATOR_CC,
                     "-a", "range", "--peer", p.endpoint]), peers)):
                check(r.returncode == 0, f"peer chaincode query at {p.name}: "
                      f"{r.stderr[-500:]!r}")
                queries[p.name] = json.loads(r.stdout)
        state = queries[peers[0].name]
        n_valid = list(predicted.values()).count(pb.VALID)
        check(all(q == state for q in queries.values())
              and len(state) == n_valid
              and state.get(f"w-{n_worths - 1}-0") == f"v{n_worths - 1}-0",
              f"the peers' states differ or hold {len(state)} keys "
              f"(predicted {n_valid})")
        mods = cli(["chaincode", "query", "-C", ch, "-n", VALIDATOR_CC,
                    "-a", "modules", "--peer", peers[-1].endpoint])
        check(mods.returncode == 0 and json.loads(mods.stdout) == [],
              f"a peer process imported {mods.stdout!r} {mods.stderr!r}")

        launches, per_peer, first_ms, later_ms, first_s = 0, {}, {}, {}, {}
        for p, tr in zip(peers, traces):
            tr.poll(p.ops)
            status, body = ops_get(p.ops, "/healthz")
            check(status == 200 and json.loads(body)["status"] == "OK",
                  f"{p.name} /healthz {status} {body!r}")
            status, body = ops_get(p.ops, "/metrics")
            text = body.decode()
            check("# TYPE csp_tpu_device_failures_total counter" in text
                  and not re.search(
                      r"^csp_tpu_device_failures_total [1-9]", text, re.M),
                  f"{p.name}: device failures on /metrics")
            blocks = tr.blocks()
            check(sorted(blocks) == list(range(1, height)) and all(
                blocks[n]["lanes"] == lanes[n - 1] for n in blocks),
                  f"{p.name}: tpu.collect lanes "
                  f"{[blocks[n]['lanes'] for n in sorted(blocks)]}, "
                  f"the blocks' {lanes}")
            # B1's launches as the peer's wrapper counted them, from its
            # tpu.dispatch spans, each flush on the peer's CSP device
            chunks = sum(len(cuda_provider._chunk_plan(
                dl, cuda_provider._MAX_CHUNK)) for b in blocks.values()
                for dl in b["device_lanes"].values() if dl)
            disp = tr.dispatches()
            devs = sorted({d.get("device") for d in disp})
            n = sum(d.get("launches_keytab", 0) for d in disp)
            n_b2 = sum(d.get("launches_lanekeys", 0) for d in disp)
            if device.type == "cuda":
                check(chunks >= 1 and devs and all(
                    str(d).startswith("cuda:") for d in devs) and n == chunks
                      and n_b2 == 0,
                      f"{p.name}: flushes on {devs}, B1 launched {n} times "
                      f"and B2 {n_b2} for {chunks} chunks of device lanes")
            else:
                check(chunks >= 1 and devs == ["cpu"] and n == n_b2 == 0,
                      f"{p.name}: flushes on {devs}, {n} + {n_b2} launches")
            per_peer[p.name] = n
            launches += n
            first_ms[p.name] = blocks[1]["ms"]
            first_s[p.name] = blocks[1]["end_s"] - p.t_first
            later_ms[p.name] = [round(blocks[b]["ms"], 1)
                                for b in sorted(blocks)[1:]]
        tools = tools_pass(height)
        status, body = ops_get(orderer.ops, "/healthz")
        check(status == 200, f"orderer /healthz {status} {body!r}")
        exits = {}
        for p in procs:
            exits[p.name] = p.terminate()
        check(all(rc == 0 for rc, _ in exits.values()),
              f"exit codes on SIGTERM {exits}")
        wall = time.perf_counter() - t0
        print(f"nodes: blocks of {sizes} transactions, lanes {lanes}; flags "
              f"as predicted ({n_valid} VALID) and equal at the "
              f"{len(peers)} peers; refusals {sorted(refusals.values())}; "
              f"states equal through `peer chaincode query` ({len(state)} "
              f"keys); no module of the JAX package in a peer")
        print("nodes: a peer's start to its first block validated: "
              + ", ".join(f"{n} {v:.2f} s" for n, v in first_s.items())
              + " (the block's broadcast waits for the worth's "
              "endorsements)")
        print("nodes: validate ms a block (collect + verify_wait + policy, "
              "from each peer's /traces): first block "
              + ", ".join(f"{n} {v:.1f}" for n, v in first_ms.items())
              + "; later " + ", ".join(f"{n} {v}" for n, v in
                                       later_ms.items()))
        print(f"nodes: {peers[-1].name} killed before worth "
              f"{NODES_KILL_WORTH}'s block and started again once the "
              f"others committed it: listening "
              f"{restart['listening_s']:.2f} s after its restart, at the "
              f"others' height {restart['catch_up_s']:.2f} s after that")
        print(f"nodes: B1 launches a peer (its wrapper's count, from its "
              f"tpu.dispatch spans) {per_peer}; "
              "exit on SIGTERM " + ", ".join(
                  f"{n} rc {rc} in {s:.2f} s" for n, (rc, s) in
                  exits.items()) + f"; the phase {wall:.1f} s")
        out = {"launches": launches, "per_peer": per_peer, "wall_s": wall,
               "tools": tools}
    finally:
        for p in procs:
            if p.proc is not None and p.proc.poll() is None:
                p.kill()
    return out


# ---------------------------------------------------------------------------
# The chaos harness: the JAX package's soak topology as processes of the
# port, and a fault-plan campaign.  Neither touches the card: both run the
# harness's fake identity plane (netident), as the JAX package's do.
# ---------------------------------------------------------------------------

SOAK_TXS = 240  # tests/test_netharness.py:496-530, the reference's soak
SOAK_SEED = 11
SOAK_SCHEDULE_HEIGHT = 31  # 1 + ceil(240 / 8): the schedule's height span
CAMPAIGN_SEED = 7
CAMPAIGN_PLANS = 5


def phase_netharness(tmp: str) -> dict:
    """`Topology(orgs=3, peers_per_org=2, orderers=3, seed=11,
    max_message_count=8, ops=True)`: three raft orderers and six peers,
    each a process of `python -m fabric_tpu_torch.devtools.netnode`,
    SOAK_TXS transactions under `generate_kill_schedule(11, topo, 31,
    kills=2)` (two peers and an orderer SIGKILLed and restarted), with
    netscope scraping every node; the verdict must be ok, the state
    digests equal, one height, no violation and nothing missing, the
    killed peers caught up; then every member, the orderers too, must
    answer one height (a restarted orderer that reaches the tip after the
    stream settled is not in the verdict's `caught_up`).  Then a
    `faultfuzz.Campaign(seed=7, plans=5)` whose every verdict is green.
    The harness validates with its fake identity plane (`FakeCSP`): this
    phase launches no kernel."""
    from fabric_tpu_torch.devtools import faultfuzz
    from fabric_tpu_torch.devtools import netharness as nh

    t0 = time.perf_counter()
    topo = nh.Topology(orgs=3, peers_per_org=2, orderers=3, seed=SOAK_SEED,
                       max_message_count=8, ops=True)
    schedule = nh.generate_kill_schedule(SOAK_SEED, topo,
                                         SOAK_SCHEDULE_HEIGHT, kills=2)
    check(any(r.node.startswith("orderer") for r in schedule),
          f"the soak's schedule kills no orderer: {schedule}")
    with nh.Network(os.path.join(tmp, "netharness"), topo) as net:
        net.start(timeout=NODES_WAIT_S)
        t_up = time.perf_counter() - t0
        scope = nh.attach_netscope(net)
        try:
            result = nh.run_stream(net, txs=SOAK_TXS, kill_schedule=schedule,
                                   settle_timeout_s=240, scope=scope)
        finally:
            scope.stop()
        slo = scope.slo()
        # every member at one height, the orderers too: the stream settles
        # on the peers', so a restarted orderer that reaches the tip after
        # it is not among the verdict's caught_up (timing, not recovery)
        t1 = time.perf_counter()
        members: dict = {}
        while True:
            for name in net.nodes:
                try:
                    members[name] = net.status(name)["height"]
                except Exception:
                    members[name] = None  # not answering yet
            if len(set(members.values())) == 1 and None not in members:
                break
            check(time.perf_counter() - t1 < NODES_WAIT_S,
                  f"the soak's members never reached one height: {members}")
            time.sleep(0.2)
        level_s = time.perf_counter() - t1
    # the verdict pins the port's rpcmap hash: a fabriclint pass the
    # first time, timed apart from the soak
    t1 = time.perf_counter()
    verdict = nh.verdict_doc(result)
    hash_s = time.perf_counter() - t1
    check(result["ok"] and result["errors"] == []
          and result["state_digests_agree"]
          and len(set(result["heights"].values())) == 1
          and result["violations"] == {} and result["missing"] == []
          and {r.node for r in schedule if "peer" in r.node}
          <= set(verdict["caught_up"]) <= {r.node for r in schedule},
          f"netharness soak: {json.dumps(verdict, sort_keys=True)} "
          f"errors {result['errors']}")
    soak_s = time.perf_counter() - t0 - hash_s
    print(f"netharness: the verdict's rpcmap_hash() in {hash_s:.2f} s (a "
          "fabriclint pass), outside the soak's seconds")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faultfuzz_") as d:
        summary = faultfuzz.Campaign(seed=CAMPAIGN_SEED, plans=CAMPAIGN_PLANS,
                                     workdir=os.path.join(d, "work"),
                                     out_dir=os.path.join(d, "out")).run()
    check(summary["verdicts"] == ["pass"] * CAMPAIGN_PLANS,
          f"faultfuzz campaign: {summary['verdicts']}")
    campaign_s = time.perf_counter() - t1
    print(f"netharness: soak topology (3 orgs x 2 peers, 3 raft orderers, "
          f"processes of devtools.netnode; fake identity plane, no kernel) "
          f"up in {t_up:.2f} s; {SOAK_TXS} transactions under the kill "
          f"schedule {[(r.node, r.at_height) for r in schedule]}: ok "
          f"{verdict['ok']}, state digests agree "
          f"{verdict['state_digests_agree']}, heights "
          f"{sorted(set(result['heights'].values()))} (every member at "
          f"{sorted(set(members.values()))} {level_s:.2f} s after), caught "
          f"up {verdict['caught_up']}, stalled {verdict['stalled_nodes']}, "
          f"rpcmap_sha256 {verdict['rpcmap_sha256']}; catch-up s "
          f"{result['catch_up_s']}; elapsed {result['elapsed_s']} s, "
          f"committed tx/s {result['committed_tx_per_s']}, netscope's "
          f"sustained tx/s {slo['sustained_tx_per_s']} over {slo['rounds']} "
          f"rounds; max cross-peer lag {result['max_cross_peer_lag_ms']} ms; "
          f"rebroadcasts {result['rebroadcasts']}; the soak {soak_s:.1f} s")
    print(f"netharness: faultfuzz Campaign(seed={CAMPAIGN_SEED}, "
          f"plans={CAMPAIGN_PLANS}) over {summary['registry_points']} fault "
          f"points: verdicts {summary['verdicts']}, {summary['trips_total']} "
          f"trips, in {campaign_s:.1f} s")
    return {"wall_s": soak_s + campaign_s, "verdict": verdict,
            "result": result}


# the lockwatch-armed headline commit of phase_lint, in a process of its own
# (FABRIC_TPU_LOCKWATCH=1 in its environment: the port's named locks are
# watched from their construction, and an inversion or an unguarded access
# raises): phase_commit on card 0 (its snapshot request, crossed by the
# commit, generated on the manager's thread), then generate() on the
# reopened ledger, under a tracing scope whose tpu.dispatch spans give B1's
# launches (as phase_nodes counts them in the peers)
LINT_LOCKWATCH = (
    "import json, os, pickle, sys, torch\n"
    "import chip_smoke as c\n"
    "from fabric_tpu_torch.common import tracing\n"
    "from fabric_tpu_torch.devtools import lockwatch\n"
    "from fabric_tpu_torch.ledger.kvledger import LedgerProvider\n"
    "assert lockwatch.enabled() and lockwatch._raise_mode()\n"
    "c.phase_build()\n"
    "class Unpickler(pickle.Unpickler):\n"
    "    # the world was pickled by chip_smoke run as __main__\n"
    "    def find_class(self, mod, name):\n"
    "        return super().find_class(\n"
    "            'chip_smoke' if mod == '__main__' else mod, name)\n"
    "with open(sys.argv[1], 'rb') as f:\n"
    "    w, b, e, m = Unpickler(f).load()\n"
    "root = sys.argv[2]\n"
    "with tracing.scope(capacity=1 << 16) as rec:\n"
    "    r = c.phase_commit(torch.device('cuda', 0), w, b, e, m, "
    "root_dir=root)\n"
    "    p = LedgerProvider(os.path.join(root, 'ledger'), "
    "csp=c.new_cuda_csp(device=torch.device('cuda', 0)))\n"
    "    led = p.open(c.VALIDATOR_CHANNEL)\n"
    "    made = led.snapshots.generate()\n"
    "    p.close()\n"
    "    doc = tracing.export(rec)\n"
    "c.workpool.shutdown()\n"
    "spans = [ev['args'] for ev in doc['traceEvents'] "
    "if ev.get('ph') == 'X' and ev['name'] == 'tpu.dispatch']\n"
    "print('LOCKWATCH ' + json.dumps({\n"
    "    'edges': {k: sorted(v) for k, v in lockwatch.edges().items()},\n"
    "    'violations': lockwatch.violations, 'dispatch': spans,\n"
    "    'launches': r['launches'], 'wall_s': r['wall_s'],\n"
    "    'generated': os.path.isdir(made)}))\n"
)


# the registry export of phase_lint, in a process of its own
LINT_EXPORT = (
    "import json, time\n"
    "from fabric_tpu_torch.devtools import faultfuzz\n"
    "t = time.perf_counter()\n"
    "reg = faultfuzz.export_registry()\n"
    "print('EXPORT ' + json.dumps({'registry': reg, "
    "'s': time.perf_counter() - t}))\n"
)


def phase_lint(device, world: ValidatorWorld, blocks: list, expect: dict,
               conflicts: dict, harness: dict, tmp: str) -> dict:
    """The port's fabriclint on this machine, and what it guards on the
    card.  First, alone on the host, `phase_netharness`'s soak repro is
    replayed: the same verdict but for which killed nodes had anything
    to catch up.  (a) `lint_tree(cache=False)` over the port's tree must find
    nothing unsuppressed; prints the files and the wall time, the
    suppressed findings by rule, the guard map's size and its
    `hb-publish` count, the static lock graph's edges and
    `netharness.rpcmap_hash()`.  (b) The headline commit (`phase_commit`,
    its snapshot request crossed by the commit) and a `generate()` run in
    a process of their own with FABRIC_TPU_LOCKWATCH=1: no LockOrderError
    or unguarded access may be raised, every lock-order edge lockwatch
    saw must be an edge of the static graph, and B1's launches, counted
    from the process's `tpu.dispatch` spans (on `cuda:N`), must be above 0
    (`launches_lockwatch`).  It runs beside the lint passes, which use
    the host only.  (c) `phase_netharness`'s soak verdict pins
    `rpcmap_sha256` equal to `rpcmap_hash()`, and
    `faultfuzz.export_registry()`, in a process of its own beside the
    commit, equals the checked-in `faultmap_registry.json`."""
    import pickle

    from fabric_tpu_torch.devtools import lint as flint
    from fabric_tpu_torch.devtools import netharness as nh

    t0 = time.perf_counter()
    # (c) first, alone on the host: the soak's repro replayed (a network
    # of processes whose kills and catch-up are polled)
    verdict = harness["verdict"]
    t1 = time.perf_counter()
    repro = nh.write_repro(harness["result"],
                           os.path.join(tmp, "soak_repro.json"))
    replayed = nh.replay_repro(repro,
                               os.path.join(tmp, "soak_replay"))
    again = nh.verdict_doc(replayed)
    # who is reported caught up is timing's (a node killed while
    # level with the others has nothing to catch up); the rest of
    # the verdict is the seed's
    check({k: v for k, v in again.items() if k != "caught_up"}
          == {k: v for k, v in verdict.items() if k != "caught_up"}
          and set(again["caught_up"])
          <= {r["node"] for r in verdict["kill_schedule"]},
          "the soak's repro replayed to "
          f"{json.dumps(again, sort_keys=True)}")
    replay_s = time.perf_counter() - t1
    pick = os.path.join(tmp, "lint_world.pickle")
    with open(pick, "wb") as f:
        pickle.dump((world, blocks, expect, conflicts), f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, FABRIC_TPU_LOCKWATCH="1")
    log_path = os.path.join(tmp, "lint_lockwatch.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", LINT_LOCKWATCH, pick,
             os.path.join(tmp, "lint_commit")],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=log,
            text=True)
        # the registry export (a lint pass and a discovery run) beside
        export = subprocess.Popen(
            [sys.executable, "-c", LINT_EXPORT], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # (a) on the host, while the card commits
            t1 = time.perf_counter()
            report = flint.lint_tree(cache=False)
            lint_s = time.perf_counter() - t1
            bad = [str(v) for v in report.unsuppressed]
            check(not bad, "fabriclint over the port's tree:\n"
                  + "\n".join(bad))
            suppressed = collections.Counter(
                v.rule for v in report.suppressed)
            guards = report.guard_map()
            hb = sum(g.get("source") == "hb-publish"
                     for g in guards.values())
            static = report.lock_graph()["edges"]
            n_static = sum(len(d) for d in static.values())
            print(f"lint: fabriclint over the port's tree on this machine "
                  f"(Python {sys.version.split()[0]}): {report.files} files "
                  f"in {lint_s:.2f} s, clean; suppressed by rule "
                  f"{dict(sorted(suppressed.items()))}; "
                  f"{len(report.warnings)} advisory (relaxed profile)")
            print(f"lint: guard map {len(guards)} fields, {hb} hb-publish; "
                  f"static lock graph {n_static} edges: " + "; ".join(
                      f"{s} -> {', '.join(sorted(d))}"
                      for s, d in sorted(static.items())))
            n_files = report.files
            # the whole-program model is large: freed here, not in a
            # collection inside a later phase
            del report, guards
            gc.collect()
            t1 = time.perf_counter()
            rpc_hash = nh.rpcmap_hash()
            print(f"lint: rpcmap_hash() {rpc_hash} "
                  f"({time.perf_counter() - t1:.2f} s)")
            # (c) the verdict's pin and the registry export
            check(verdict["rpcmap_sha256"] == rpc_hash,
                  f"the soak's verdict pins {verdict['rpcmap_sha256']}, "
                  f"the tree's rpcmap is {rpc_hash}")
            ex_out, ex_err = export.communicate(timeout=600)
            check(export.returncode == 0 and "EXPORT " in ex_out,
                  f"export_registry() exited {export.returncode}: "
                  f"{ex_err[-3000:]}")
            got = json.loads(ex_out.split("EXPORT ", 1)[1].splitlines()[0])
            with open(flint.FAULTMAP_REGISTRY_PATH, encoding="utf-8") as f:
                pinned = json.load(f)
            check(got["registry"] == pinned, "export_registry() differs "
                  "from the checked-in registry: "
                  f"{sorted(set(got['registry']['points']) ^ set(pinned['points']))}")
            print(f"lint: the soak's verdict pins rpcmap_sha256 = "
                  f"rpcmap_hash(); its repro replayed in {replay_s:.1f} s to "
                  f"the same verdict (caught up {again['caught_up']}, the "
                  f"soak's {verdict['caught_up']}); export_registry() "
                  f"equals the checked-in registry "
                  f"({len(pinned['points'])} points, {got['s']:.1f} s in a "
                  f"process of its own)")
            out, _ = proc.communicate(timeout=600)
        finally:
            for p in (proc, export):
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if proc.returncode != 0 or "LOCKWATCH " not in out:
        with open(log_path) as f:
            print(out[-3000:], f.read()[-6000:], file=sys.stderr)
        check(False, f"the lockwatch-armed commit exited {proc.returncode}")
    for line in out.splitlines():
        if line.startswith("commit:"):
            print(f"lint: lockwatch-armed {line}")
    got = json.loads(out.split("LOCKWATCH ", 1)[1].splitlines()[0])
    check(not got["violations"], f"lockwatch: {got['violations']}")
    observed = [(s, d) for s, ds in sorted(got["edges"].items())
                for d in ds]
    missing = [(s, d) for s, d in observed if d not in static.get(s, {})]
    check(("kvledger.commit_lock", "snapshot.manager") in observed,
          f"the armed commit saw no commit -> snapshot order: {observed}")
    check(not missing, f"runtime lock edges missing from the static "
          f"graph: {missing}")
    devices = {a.get("device") for a in got["dispatch"]}
    launches = sum(a.get("launches_keytab", 0) for a in got["dispatch"])
    check(devices and all(str(d).startswith("cuda") for d in devices),
          f"a flush of the armed commit ran on {devices}")
    check(launches >= got["launches"][B1_NAME] > 0,
          f"B1's launches from the spans {launches}, in the timed run "
          f"{got['launches'][B1_NAME]}")
    check(got["generated"], "generate() made no snapshot directory")
    wall = time.perf_counter() - t0
    print(f"lint: lockwatch-armed commit on {sorted(devices)}: "
          f"{len(observed)} runtime lock edges, all in the static graph's "
          f"{n_static}: " + "; ".join(f"{s} -> {d}" for s, d in observed)
          + f"; no violation; B1 launched {launches} times (from "
          f"{len(got['dispatch'])} tpu.dispatch spans; "
          f"{got['launches'][B1_NAME]} in the timed run)")
    print(f"lint: phase_lint {wall:.1f} s")
    return {"launches": launches, "wall_s": wall, "lint_s": lint_s,
            "files": n_files, "runtime_edges": len(observed),
            "static_edges": n_static}


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
    cli = custody_cli_pass(device, errs)
    return {"sign_s": sign_s, "launches": {
        B1_NAME: out["block"][1][B1_NAME],
        B2_NAME: out["300-key"][1][B2_NAME]},
        "block_wall_s": out["block"][0], "wide_wall_s": out["300-key"][0],
        "cli": cli}


CUSTODY_CLI_BLOCK = 100  # the CLI daemon's block: 100 lanes on 4 keys ...
CUSTODY_CLI_WIDE = MANY_KEYS  # ... and one lane on each of 300 keys
CUSTODY_CLI_TAMPERED = 4  # in each


def custody_cli_pass(device, errs: dict) -> dict:
    """The custody daemon as a user runs it: `python -m
    fabric_tpu_torch.cmd.custody` with a token file, a process of its
    own.  It generates CUSTODY_KEYS + CUSTODY_CLI_WIDE keys and signs
    CUSTODY_CLI_BLOCK + CUSTODY_CLI_WIDE digests; a CustodyCSP on CUDACSP
    verifies a block over the CUSTODY_KEYS keys (B1) and a batch over the
    CUSTODY_CLI_WIDE keys (B2), CUSTODY_CLI_TAMPERED of each tampered.
    Each mask must be the planted one and its kernel's plain version's,
    every lane hostref's; the daemon exits 0 on SIGTERM."""
    from fabric_tpu_torch.csp.custody import CustodyCSP, load_token

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_custody_cli_") as d:
        token_file = os.path.join(d, "token")
        with open(token_file, "wb") as f:
            f.write(b"chip-smoke-custody-cli\n")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "fabric_tpu_torch.cmd.custody",
             "--keystore", os.path.join(d, "keys"), "--token-file",
             token_file, "--listen", "127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=repo))
        try:
            line = proc.stdout.readline()
            m = re.match(r"custody daemon on ([\d.]+):(\d+)", line)
            check(m is not None, f"the custody CLI printed {line!r}")
            up_s = time.perf_counter() - t0
            local = RecordingCSP(new_cuda_csp(device=device))
            csp = CustodyCSP((m.group(1), int(m.group(2))),
                             load_token(token_file), verify_csp=local)
            keys = [csp.key_gen() for _ in range(CUSTODY_KEYS)]
            wide_keys = [csp.key_gen() for _ in range(CUSTODY_CLI_WIDE)]
            check(len(os.listdir(os.path.join(d, "keys")))
                  == CUSTODY_KEYS + CUSTODY_CLI_WIDE,
                  "the CLI daemon does not hold the keys")
            t1 = time.perf_counter()
            block = []
            for i in range(CUSTODY_CLI_BLOCK):
                key = keys[i % CUSTODY_KEYS]
                dg = hashlib.sha256(b"custody-cli-%d" % i).digest()
                block.append(VerifyBatchItem(key, dg, csp.sign(key, dg)))
            wide = []
            for i, key in enumerate(wide_keys):
                dg = hashlib.sha256(b"custody-cli-wide-%d" % i).digest()
                wide.append(VerifyBatchItem(key, dg, csp.sign(key, dg)))
            sign_s = time.perf_counter() - t1
            step = CUSTODY_CLI_BLOCK // CUSTODY_CLI_TAMPERED
            bad = [step * j + 5 for j in range(CUSTODY_CLI_TAMPERED)]
            for i in bad:
                it = block[i]
                block[i] = VerifyBatchItem(
                    it.key, bytes([it.digest[0] ^ 1]) + it.digest[1:],
                    it.signature)
            wstep = CUSTODY_CLI_WIDE // CUSTODY_CLI_TAMPERED
            wide_bad = [wstep * j + 3 for j in range(CUSTODY_CLI_TAMPERED)]
            for i in wide_bad:
                it = wide[i]
                wide[i] = VerifyBatchItem(it.key, it.digest, it.signature[:-1]
                                          + bytes([it.signature[-1] ^ 1]))
            out = {}
            for label, batch, planted, name in (
                    ("block", block, bad, B1_NAME),
                    ("300-key", wide, wide_bad, B2_NAME)):
                local.inner.drain()
                pk.launches_keytab = 0
                pk.launches_lanekeys = 0
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                mask = csp.verify_batch(batch)
                wall = time.perf_counter() - t2
                launches = {B1_NAME: pk.launches_keytab,
                            B2_NAME: pk.launches_lanekeys}
                check([i for i, ok in enumerate(mask) if not ok] == planted,
                      f"custody CLI {label}: rejected "
                      f"{[i for i, ok in enumerate(mask) if not ok][:20]}")
                check(launches[name] > 0, f"custody CLI {label}: {name} did "
                      f"not launch: {launches}")
                packed = pk.pack_items([VerifyBatchItem(
                    it.key.public_key(), it.digest, it.signature)
                    for it in batch])
                if name == B1_NAME:
                    packed = pk.dedup_keys(packed)
                check(compare(name, packed, device, errs) == mask,
                      f"custody CLI {label}: the card's mask differs from "
                      "the plain version's")
                out[label] = (wall, launches, len(batch))
            lanes = check_mask(local, "custody CLI")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=NODES_STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = None
            tail = proc.stdout.read()[-600:]
    check(rc == 0, f"the custody CLI exited {rc} on SIGTERM: {tail!r}")
    print(f"custody CLI: the daemon process listening after {up_s:.2f} s; "
          f"{CUSTODY_CLI_BLOCK + CUSTODY_CLI_WIDE} digests signed through "
          f"it in {sign_s * 1e3:.1f} ms; " + "; ".join(
              f"{label} batch of {n} lanes in {wall * 1e3:.1f} ms, launches "
              f"{launches}" for label, (wall, launches, n) in out.items())
          + f"; masks the planted ones, the plain versions' and hostref's "
          f"({lanes} lanes); exit 0 on SIGTERM")
    return {"launches": {B1_NAME: out["block"][1][B1_NAME],
                         B2_NAME: out["300-key"][1][B2_NAME]}}


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


def nodes_only() -> int:
    """`--nodes`: the kernels and the host library built, then
    `phase_nodes` alone (a short call for that phase; card only)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print_device()
    phase_build()
    phase_native()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out = phase_nodes(torch.device("cuda", 0), tmp)
    print(json.dumps({"launches_nodes": out["launches"],
                      "per_peer": out["per_peer"]}))
    return 0


def lint_only() -> int:
    """`--lint`: the kernels and the host library built, the validator's
    world and blocks made, then `phase_netharness` and `phase_lint` (a
    short call for that phase; card only)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print_device()
    phase_build()
    phase_native()
    world = validator_world(SEED)
    blocks, expect, conflicts = validator_blocks(
        world, N_BLOCKS, N_TXS, world.genesis_hash, mvcc=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        harness = phase_netharness(tmp)
        out = phase_lint(torch.device("cuda", 0), world, blocks, expect,
                         conflicts, harness, tmp)
    workpool.shutdown()
    print(json.dumps({"launches_lockwatch": out["launches"],
                      "phase_lint_s": out["wall_s"]}))
    return 0


def hash_only() -> int:
    """`--hash`: the kernels built, `phase_sha256`, then the kernel-only
    and wrapper-call times of the other kernels' rows at their main
    path's shapes (B1 on a flush of two blocks, B2 on the 300-key batch,
    B3 on a 1024-signature batch; card only)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    errs: dict = {}
    rows = {B4_NAME: phase_sha256(rng, device, errs)}
    host_check("sha256")
    client, peers = block_world(rng)
    block = block_items(rng, client, peers[:ENDORSERS], N_TXS)
    spread = spread_items(rng, len(block))
    for name, items in ((B1_NAME, block + block), (B2_NAME, spread)):
        t = pk.upload(pk.dedup_keys(pk.pack_items(items)), device)
        rows[name] = timed_row(name, pk.launcher(t)[0],
                               lambda t=t: pk.verify_packed(t))
    world = idemix_world(SEED)
    sigs = [sig for sig, _ in idemix_lanes(world, IDEMIX_LANES, b"main")]
    n_attrs = len(world.ipk.h_attrs)
    pts, scs, ok = bb.prepare_sigs(sigs, n_attrs)
    t = bk.upload(bk.pack(pts, scs, ok, *bb.term_layout(n_attrs)),
                  bb.shared_comb(bb.shared_points(world.ipk)), device)
    rows[B3_NAME] = timed_row(B3_NAME, bk.launcher(t)[0],
                              lambda: bk.commitments(t))
    workpool.shutdown()
    print(json.dumps({"kernel_times": {
        name: {k: row[k] for k in ("ms", "wrapper_ms", "profiler_ms")}
        for name, row in rows.items()}}))
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
    if argv[:1] == ["--raft-orderer"] and len(argv) == 2:
        return raft_orderer_main(argv[1])
    if argv[:1] == ["--shards-ab"] and len(argv) in (1, 2):
        return shards_ab(*(int(a) for a in argv[1:]))
    if argv == ["--nodes"]:
        return nodes_only()
    if argv == ["--lint"]:
        return lint_only()
    if argv == ["--hash"]:
        return hash_only()
    if argv:
        print("usage: chip_smoke.py [--commit-ab PARENT_TREE [TURNS] | "
              "--multi-card | --shards-ab [TURNS] | --raft-orderer SPEC | "
              "--nodes | --lint | --hash]", file=sys.stderr)
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
        order = phase_order(device, world, blocks, expect, com, tmp)
        host_check("order")
        t_cell = time.perf_counter()
        # a standing client or peer keeps its start-up objects out of the
        # full collections, which otherwise stop every thread for up to
        # ~0.7 s: a pause of the broadcast longer than raft's batch timer
        # can spare
        gc.collect()
        gc.freeze()
        try:
            cluster, raft = phase_raft(device, world, blocks, expect, com,
                                       order, tmp)
            host_check("raft")
            try:
                endorse = phase_endorse(device, world, cluster, tmp)
                host_check("endorse")
                gwy = phase_gateway(device, world, cluster, tmp, endorse)
            finally:
                cluster.halt_all()
        finally:
            gc.unfreeze()
        host_check("gateway", armed=True)
        print(f"raft, endorse and gateway: "
              f"{time.perf_counter() - t_cell:.1f} s")
        nodes = phase_nodes(device, tmp)
        host_check("nodes", armed=True)
        harness = phase_netharness(tmp)
        host_check("netharness", armed=True)
        lnt = phase_lint(device, world, blocks, expect, conflicts, harness,
                         tmp)
        host_check("lint", armed=True)
    b1 = next(row for row in rows if row["name"] == B1_NAME)
    for label, run in (("validator", val), ("commit", com),
                       ("commit_sharded", shc), ("smallbank", sb),
                       ("bootstrap", snp), ("order", order),
                       ("raft", raft), ("endorse", endorse),
                       ("gateway", gwy)):
        b1[f"launches_{label}"] = run["launches"][B1_NAME]
        busy = b1[f"launches_{label}"] * b1["ms"]
        wall = run["wall_s"] * 1e3
        print(f"{label}: device busy (B1) ~{busy:.1f} ms of the {wall:.1f} "
              f"ms wall ({busy / wall:.1%}; launches x B1's ms at 8000 "
              "lanes)")
    b1["launches_smallbank_sharded"] = sb["launches_sharded"][B1_NAME]
    # counted in the peer processes, from their traces
    b1["launches_nodes"] = nodes["launches"]
    b1["launches_nodes_tools"] = nodes["tools"]["launches"]
    # counted in the lockwatch-armed process, from its traces
    b1["launches_lockwatch"] = lnt["launches"]
    cus = phase_custody(device, errs)
    host_check("custody")
    b2 = next(row for row in rows if row["name"] == B2_NAME)
    b2["launches_raft"] = raft["launches"][B2_NAME]
    b2["launches_endorse"] = endorse["launches"][B2_NAME]
    for row in (b1, b2):
        row["launches_fetch"] = fet["launches"][row["name"]]
        row["launches_custody"] = cus["launches"][row["name"]]
        row["launches_custody_cli"] = cus["cli"]["launches"][row["name"]]
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
    rows[-1]["launches_idemixgen"] = msp["launches_idemixgen"]
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
