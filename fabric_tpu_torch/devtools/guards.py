"""Reviewed guarded-by declarations for the port's fabriclint racecheck rule.

The port's copy of the JAX package's ``fabric_tpu/devtools/guards.py``:
every entry of the reference, under the port's qnames.  The TPU CSP's
coalescing lane state is ``CUDACSP``'s (``csp/cuda/provider.py``), whose
lock keeps the reference's role string ``csp.tpu.pend``; the plain
``threading`` pseudo-roles name the port's members.  Every reference
entry has its port field, so none is dropped, and the port adds none.

Each entry pins a shared field to the lock ROLE that must be held at
every access reachable from a thread entry point.  Declarations beat
majority inference: they are the reviewed concurrency contract for the
hot structures (the commit pipeline, the snapshot manager, the card
CSP's coalescing lane state, gossip membership), so a refactor that
quietly drops the lock around one access fails the lint gate even if
it also shifts the statistical majority.

Role spellings
--------------
* a ``lockwatch`` role string (``named_lock("kvledger.commit_lock")``)
  for locks created through the lockwatch seam — the runtime
  ``lockwatch.guarded(obj, field, by=role)`` assertions use the same
  strings, so the static map and the dynamic cross-check can never
  drift apart;
* the member's own qname (``fabric_tpu_torch.csp.cuda.provider.CUDACSP.
  _ewma_lock``) as a pseudo-role for plain ``threading`` primitives.

Fields NOT listed here still get a guard when a strict majority of
their access sites hold one lock (see ``dataflow.Project._racecheck``);
this table exists for the structures where "majority" is not a strong
enough word for the invariant.

The racecheck engine also models happens-before edges (thread
start/join, Event set->wait, Queue put->get, workpool submit->result):
a field whose every access is publication-ordered needs NO entry here
(it resolves as ``hb-publish`` in the guard map), and an entry whose
every access becomes HB-proven — with at least one access genuinely
thread-reachable — is flagged STALE so this table only shrinks.
Declare a guard when the invariant is the reviewed contract (locks);
let publication idioms be proven, not declared.  Events and accesses
are ordered by CFG dominance/reachability, and the lockset consulted at
each access is the flow-sensitive must-hold meet over paths.
"""

from __future__ import annotations

DECLARED_GUARDS: dict[str, str] = {
    # -- commit pipeline (group commit) -----------------------------------
    # the open CommitGroup and the durability watermark only move under
    # the commit lock; a thread reading them lock-free would see a
    # half-flushed group boundary
    "fabric_tpu_torch.ledger.kvledger.KVLedger._active_group":
        "kvledger.commit_lock",
    "fabric_tpu_torch.ledger.kvledger.KVLedger._durable_height":
        "kvledger.commit_lock",
    "fabric_tpu_torch.ledger.kvledger.KVLedger._durable_hash":
        "kvledger.commit_lock",
    # -- sharded statedb ---------------------------------------------------
    # the two-phase flush epoch only advances under the flush lock; a
    # concurrent flush reading it lock-free could stage two batches
    # under the same epoch and make recovery ambiguous
    "fabric_tpu_torch.ledger.kvstore.ShardedKVStore._epoch":
        "kvstore.shard_flush",
    # -- snapshot manager ---------------------------------------------------
    "fabric_tpu_torch.ledger.snapshot.SnapshotManager._pending":
        "snapshot.manager",
    "fabric_tpu_torch.ledger.snapshot.SnapshotManager._inflight":
        "snapshot.idle",
    "fabric_tpu_torch.ledger.snapshot.SnapshotManager._spawn_seq":
        "snapshot.idle",
    "fabric_tpu_torch.ledger.snapshot.SnapshotManager._ack_seq":
        "snapshot.idle",
    # -- card CSP coalescing lane state -------------------------------------
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._pend_batches": "csp.tpu.pend",
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._pend_lanes": "csp.tpu.pend",
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._flushed": "csp.tpu.pend",
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._inflight": "csp.tpu.pend",
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._gen": "csp.tpu.pend",
    "fabric_tpu_torch.csp.cuda.provider.CUDACSP._lane_wall_ewma":
        "fabric_tpu_torch.csp.cuda.provider.CUDACSP._ewma_lock",
    # process-wide measured host verify rate (module global)
    "fabric_tpu_torch.csp.cuda.provider._host_rate_ewma":
        "fabric_tpu_torch.csp.cuda.provider._host_rate_lock",
    # -- shared host work pool (parallel collect/prepare) -------------------
    # the lazily-created process-wide executor singleton: creation and
    # teardown race between first users and shutdown callers
    "fabric_tpu_torch.common.workpool._pool":
        "fabric_tpu_torch.common.workpool._pool_lock",
    # -- gossip membership --------------------------------------------------
    "fabric_tpu_torch.gossip.discovery.DiscoveryCore._peers":
        "gossip.discovery.members",
    "fabric_tpu_torch.gossip.discovery.DiscoveryCore._tick":
        "gossip.discovery.members",
    "fabric_tpu_torch.gossip.discovery.DiscoveryCore._seq":
        "gossip.discovery.members",
    # -- netscope telemetry collector ---------------------------------------
    # the scraper thread ingests rounds while the harness thread reads
    # series/marks events/writes artifacts; every shared structure
    # moves under one state lock
    "fabric_tpu_torch.devtools.netscope.Netscope._series": "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._health": "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._events": "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._trace_events":
        "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._trace_cursor":
        "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._stalls": "netscope.state",
    "fabric_tpu_torch.devtools.netscope.Netscope._height_window":
        "netscope.state",
    # -- profscope profiling plane ------------------------------------------
    # the sampler service thread folds sweeps into the aggregates while
    # feed points (lockwatch contention, workpool chunks) write from
    # arbitrary threads and export() snapshots from the harness thread;
    # everything shared moves under the profiler's own plain lock (a
    # plain primitive on purpose: a watched lock here would recurse
    # through the very note_lock_wait hook it feeds)
    "fabric_tpu_torch.common.profile.Profiler._stacks":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._spans":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._locks":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._chunks":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._samples":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._dropped":
        "fabric_tpu_torch.common.profile.Profiler._lock",
    "fabric_tpu_torch.common.profile.Profiler._t0":
        "fabric_tpu_torch.common.profile.Profiler._lock",
}

__all__ = ["DECLARED_GUARDS"]
