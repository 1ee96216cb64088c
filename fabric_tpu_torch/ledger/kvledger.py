"""The peer ledger: block store, state DB, history DB and private-data
store behind one commit (the port's copy of `fabric_tpu/ledger/kvledger.py`).

Reference: core/ledger/kvledger/kv_ledger.go:447-530 CommitLegacy
(validate and prepare, block store, state DB, history DB), the provider in
kv_ledger_provider.go, and recovery on open (the state and history DBs
replay the blocks newer than their savepoints).

A commit group buffers every KV write of up to `depth` blocks in one
WriteBatchCollector and lands them as one block-file fdatasync, then one
sqlite transaction; a failure rolls the group back to the durable height.
The ledger hands out transaction simulators and query executors, defines
rich-query indexes, and exports, verifies and imports snapshots
(`ledger/snapshot.py`).

The seams are the JAX package's: each commit stage (``mvcc``,
``block_append``, ``pvt``, ``state``, ``history``) runs under a stage span
with a ``block`` attribute and ends at a ``commit.stage`` fault point; a
group flush runs ``fsync`` and ``kv_txn`` spans charged to the group's
last block; `metrics` (a `common.metrics.CommitMetrics`) and
`ledger_metrics` (a `common.metrics.LedgerMetrics`) get the stage
durations, the blocks per sync and the height gauges; the commit lock is
the ``kvledger.commit_lock`` role of `lockwatch.named_rlock`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.devtools import faultline
from fabric_tpu_torch.devtools.lockwatch import guarded, named_rlock
from fabric_tpu_torch.ledger import snapshot as snap
from fabric_tpu_torch.ledger.blkstorage import BlockStore, BlockStoreError
from fabric_tpu_torch.ledger.confighistory import ConfigHistoryMgr
from fabric_tpu_torch.ledger.history import HistoryDB
from fabric_tpu_torch.ledger.kvstore import (
    KVStore,
    NamedDB,
    WriteBatchCollector,
    knob,
    open_store_root,
    wipe_prefix,
)
from fabric_tpu_torch.ledger.pvtdatastorage import PvtDataStore
from fabric_tpu_torch.ledger.statedb import Height, VersionedDB, VersionedValue
from fabric_tpu_torch.ledger.txmgmt import (
    VALID,
    MVCCValidator,
    TxSimulator,
    decode_metadata,
    hash_ns,
    key_hash,
    parse_rwset,
    pvt_ns,
)
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import rwset as rw
from fabric_tpu_torch.protos.wire import DecodeError


@dataclasses.dataclass
class CommitAssist:
    """What the validator already learned of a block, so that the commit
    does not derive it again: each transaction's marshaled rwset, its
    decoded RwsetFootprint (MVCC and history read it), its txid (the block
    index), the envelopes' bytes (the block store splices them), and the
    block's trace root, so that the commit stages join its trace."""

    rwsets: list  # marshaled TxReadWriteSet | None, per transaction
    footprints: list  # RwsetFootprint | None, per transaction
    txids: list  # str | None, per transaction
    env_bytes: list | None = None
    trace_ctx: tracing.SpanContext | None = None


@dataclasses.dataclass
class CommitGroup:
    """An open group commit: the collector that buffers every KV write of
    its blocks for one transaction, a state view over it (block k+1's
    MVCC reads block k's writes), and the block files to sync at the
    flush.  Made by KVLedger.begin_commit_group, reused after each
    flush."""

    collector: WriteBatchCollector
    state: VersionedDB
    mvcc: MVCCValidator
    blocks: int = 0
    dirty_files: set = dataclasses.field(default_factory=set)
    # the buffered blocks' numbers, for the snapshot trigger at the flush
    snap_notify: list = dataclasses.field(default_factory=list)
    # a buffered block has a pending snapshot request: the streaming
    # committer flushes there, so that the export is at that height
    boundary_hint: bool = False


def extract_rwsets(block: cb.Block) -> list[bytes | None]:
    """Each transaction's marshaled TxReadWriteSet (None where it is no
    endorser transaction or does not parse)."""
    out: list[bytes | None] = []
    for raw_env in block.data.data:
        raw = None
        try:
            env = cb.Envelope.decode(raw_env)
            payload = cb.Payload.decode(env.payload)
            chdr = cb.ChannelHeader.decode(payload.header.channel_header)
            if chdr.type == cb.ENDORSER_TRANSACTION:
                raw = protoutil.get_action_from_envelope(env)[1].results
        except (DecodeError, IndexError):
            raw = None
        out.append(raw)
    return out


def _history_writes(rwsets: list, flags: list[int],
                    footprints: list | None = None):
    """Each valid transaction's public (ns, key) writes for the history
    index, read off the validator's footprints where they came along."""
    writes_per_tx: list[list[tuple[str, str]]] = [[] for _ in flags]
    for tx_num, raw in enumerate(rwsets):
        if flags[tx_num] != VALID or raw is None:
            continue
        fp = footprints[tx_num] if footprints is not None else None
        try:
            parsed = fp.parsed if fp is not None else parse_rwset(raw)
        except DecodeError:
            continue  # MVCC flagged it already
        for ns, kvrw, _colls in parsed:
            writes_per_tx[tx_num].extend((ns, w.key) for w in kvrw.writes)
    return writes_per_tx


def _recovery_group_size() -> int:
    """Blocks replayed per KV transaction on recovery
    (FABRIC_TPU_RECOVERY_GROUP, default 32, at least 1)."""
    raw = knob("FABRIC_TPU_RECOVERY_GROUP").strip()
    if not raw:
        return 32
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError(
            f"FABRIC_TPU_RECOVERY_GROUP={raw!r} is not an integer "
            "group size"
        ) from None


class KVLedger:
    """One channel's ledger (reference ledger.PeerLedger): the block
    store, state DB, history DB and private-data store, committed
    together."""

    def __init__(self, ledger_id: str, block_store: BlockStore, kv: KVStore,
                 metrics=None, ledger_metrics=None):
        self.ledger_id = ledger_id
        self._kv = kv
        self._blocks = block_store
        self._state = VersionedDB(kv, f"statedb/{ledger_id}")
        self._history = HistoryDB(kv, f"historydb/{ledger_id}")
        self.pvt_store = PvtDataStore(kv, ledger_id)
        self.config_history = ConfigHistoryMgr(kv, ledger_id)
        # the SnapshotManager, wired by the provider (it needs the ledger);
        # each group flush tells it the blocks made durable
        self.snapshots: snap.SnapshotManager | None = None
        # cumulative seconds per commit stage: mvcc (and its mvcc_preload,
        # mvcc_check, mvcc_prepare), block_append, pvt, state, history,
        # fsync, kv_txn; `metrics` (CommitMetrics) also gets each one
        self.commit_stage_seconds: dict[str, float] = {}
        self._metrics = metrics
        # LedgerMetrics: height and durable height gauges, block and
        # transaction counters
        self._lmetrics = ledger_metrics
        # serializes commits against a snapshot export (an RLock: the
        # commit-time trigger exports while the committer holds it)
        self.commit_lock = named_rlock("kvledger.commit_lock")
        # the group holding unflushed blocks, if any: a commit through
        # another group is refused while it is open
        self._active_group: CommitGroup | None = None
        self._recover()
        # the height and hash as of the last flush: block files synced and
        # the KV transaction committed up to here
        self._durable_height = self._blocks.height
        self._durable_hash = self._blocks.last_block_hash
        self._publish_heights()

    def _publish_heights(self) -> None:
        lm = self._lmetrics
        if lm is not None:
            lm.height.With("channel", self.ledger_id).set(self._blocks.height)
            lm.durable_height.With("channel", self.ledger_id).set(
                self._durable_height)

    # -- recovery (reference recoverDBs) --------------------------------------

    def set_btl_policy(self, btl_policy) -> None:
        """The private data's blocks-to-live, (ns, coll) -> blocks (0:
        forever), from the channel's collections (a node sets it once the
        ledger is open)."""
        self.pvt_store._btl = btl_policy or (lambda ns, coll: 0)

    def _recover(self) -> None:
        """Replay the blocks newer than the state savepoint through a
        collector, one KV transaction per FABRIC_TPU_RECOVERY_GROUP blocks;
        the savepoint rides each flush, so a crash mid-replay resumes from
        the last one."""
        height = self._blocks.height
        sp = self._state.savepoint()
        first = 0 if sp is None else sp.block_num + 1
        if first >= height:
            return
        group_size = _recovery_group_size()
        collector = WriteBatchCollector(self._kv)
        state = self._state.rebased(collector)
        mvcc = MVCCValidator(state)
        buffered = 0
        for num in range(first, height):
            self._apply_state_updates(
                self._blocks.get_block_by_number(num),
                self.pvt_store.get_pvt_data_by_block(num),
                mvcc=mvcc, state=state, into=collector)
            buffered += 1
            if buffered >= group_size:
                collector.flush()
                state.invalidate_caches()
                buffered = 0
        if buffered:
            collector.flush()
        self._state.invalidate_caches()

    def _apply_state_updates(self, block: cb.Block, pvt_data, *, mvcc, state,
                             into) -> None:
        """Replay one block's state, history and lost private data.  The
        recorded flags are trusted: only VALID transactions write."""
        flags = list(protoutil.tx_filter(block))
        rwsets = extract_rwsets(block)
        batch = mvcc.validate_and_prepare(block.header.number, rwsets, flags,
                                          pvt_data)
        # cleartext endorsed but not stored went down with an unflushed
        # group: record it missing for the reconciler
        missing = self._lost_pvt(rwsets, flags, pvt_data or {})
        if missing:
            self.pvt_store.commit(block.header.number, {}, missing,
                                  into=into)
        state.apply_updates(batch, Height(block.header.number, len(flags)))
        self._history.commit(block.header.number,
                             _history_writes(rwsets, flags), into=into)

    @staticmethod
    def _lost_pvt(rwsets, flags, pvt_data) -> list[tuple[int, str, str]]:
        """[(tx, ns, coll)] where the rwset endorsed a private rwset (a
        non-empty pvt_rwset_hash) and no cleartext is stored."""
        out: list[tuple[int, str, str]] = []
        for tx_num, raw in enumerate(rwsets):
            if flags[tx_num] != VALID or raw is None or pvt_data.get(tx_num):
                continue
            try:
                txrw = rw.TxReadWriteSet.decode(raw)
            except DecodeError:
                continue
            for nsrw in txrw.ns_rwset:
                for ch in nsrw.collection_hashed_rwset:
                    if ch.pvt_rwset_hash:
                        out.append((tx_num, nsrw.namespace,
                                    ch.collection_name))
        return out

    # -- commit (reference kv_ledger.go:447 CommitLegacy) ---------------------

    def begin_commit_group(self) -> CommitGroup:
        """A group whose blocks buffer every KV write in one collector and
        skip their own syncs until `commit_group_flush`."""
        collector = WriteBatchCollector(self._kv)
        view = self._state.rebased(collector)
        return CommitGroup(collector=collector, state=view,
                           mvcc=MVCCValidator(view))

    def commit(self, block: cb.Block, pvt_data: dict[int, bytes] | None = None,
               missing_pvt: list[tuple[int, str, str]] | None = None,
               rwsets: list | None = None, assist: CommitAssist | None = None,
               group: CommitGroup | None = None) -> None:
        """MVCC-validate (adding the MVCC codes to the TRANSACTIONS_FILTER
        the validator wrote), then store the block and its private data
        and apply state and history.  pvt_data maps a transaction to its
        marshaled TxPvtReadWriteSet; missing_pvt records the collections
        this peer was eligible for and did not receive.  `rwsets` or a full
        `assist` spare the commit its own walk of the envelopes.

        Without `group` the block is flushed at once (one fdatasync, one KV
        transaction); with it, the block becomes durable and visible at
        the group's next `commit_group_flush`."""
        if self.snapshots is not None:
            # a background export pinned to the last flush's height takes
            # the commit lock before state moves on
            self.snapshots.wait_generation_turn()
        with self.commit_lock:
            g = group if group is not None else self.begin_commit_group()
            if self._active_group is not None and g is not self._active_group:
                # that group's index and checkpoint live in its collector
                raise BlockStoreError(
                    "another commit group holds unflushed blocks for "
                    f"ledger {self.ledger_id!r}")
            try:
                self._commit_into(block, pvt_data, missing_pvt, rwsets,
                                  assist, g)
            except BaseException as exc:
                # the block store advanced and its index is stranded in the
                # collector: unwind the whole group (never acknowledged).
                # A simulated process death (faultline's FaultCrash) skips
                # the unwind: reopen must run the real recovery
                if not faultline.is_crash(exc):
                    self._rollback_group(g)
                raise
            if group is None:
                self._flush_group(g)

    def commit_group_flush(self, group: CommitGroup) -> None:
        """Land an open group: fdatasync its block files first, then
        commit its one KV transaction, as a single block's commit does;
        then hand the durable blocks to the snapshot trigger."""
        if self.snapshots is not None:
            self.snapshots.wait_generation_turn()
        with self.commit_lock:
            self._flush_group(group)

    def _commit_into(self, block, pvt_data, missing_pvt, rwsets, assist,
                     group: CommitGroup) -> None:
        t = time.perf_counter
        flags = list(protoutil.tx_filter(block))
        footprints = txids = env_bytes = None
        if assist is not None and len(assist.rwsets) == len(flags):
            rwsets = assist.rwsets
            footprints = assist.footprints
            txids = assist.txids
            env_bytes = assist.env_bytes
        if rwsets is None or len(rwsets) != len(flags):
            rwsets = extract_rwsets(block)
        num = block.header.number
        t0 = t()
        # each stage's fault point is inside its span, so an injected
        # trip annotates the stage it landed in
        with tracing.span("mvcc", cat="stage", block=num):
            batch = group.mvcc.validate_and_prepare(
                num, rwsets, flags, pvt_data, footprints=footprints)
            protoutil.set_tx_filter(block, flags)
            faultline.point("commit.stage", stage="mvcc", block=num)
        t1 = t()
        with tracing.span("block_append", cat="stage", block=num):
            file_idx = self._blocks.add_block(block, txids=txids,
                                              env_bytes=env_bytes,
                                              into=group.collector,
                                              sync=False)
            if file_idx is not None:
                group.dirty_files.add(file_idx)
            faultline.point("commit.stage", stage="block_append", block=num)
        t2 = t()
        # private data and state share the transaction (with the
        # savepoint): recovery never sees one ahead of the other
        with tracing.span("pvt", cat="stage", block=num):
            self.pvt_store.commit(num, pvt_data or {}, missing_pvt,
                                  into=group.collector)
            faultline.point("commit.stage", stage="pvt", block=num)
        t3 = t()
        with tracing.span("state", cat="stage", block=num):
            group.state.apply_updates(batch, Height(num, len(flags)))
            faultline.point("commit.stage", stage="state", block=num)
        t4 = t()
        with tracing.span("history", cat="stage", block=num):
            self._history.commit(
                num, _history_writes(rwsets, flags, footprints),
                into=group.collector)
            faultline.point("commit.stage", stage="history", block=num)
        t5 = t()
        group.blocks += 1
        group.snap_notify.append(num)
        self._active_group = group
        lm = self._lmetrics
        if lm is not None:
            lm.height.With("channel", self.ledger_id).set(self._blocks.height)
            lm.blocks_committed.With("channel", self.ledger_id).add()
            lm.transactions.With("channel", self.ledger_id).add(
                sum(1 for f in flags if f == 0))  # VALID
        if self.snapshots is not None and \
                self.snapshots.has_pending_request(num):
            group.boundary_hint = True
        sub = group.mvcc.last_stage_seconds
        self._observe_stages(
            mvcc=t1 - t0, block_append=t2 - t1, pvt=t3 - t2, state=t4 - t3,
            history=t5 - t4, mvcc_preload=sub.get("preload", 0.0),
            mvcc_check=sub.get("check", 0.0),
            mvcc_prepare=sub.get("prepare", 0.0))

    def _flush_group(self, group: CommitGroup) -> None:
        # the open group and the durable height move only under the lock
        guarded(self, "_active_group", by="kvledger.commit_lock")
        if group.blocks:
            # the flush's spans are charged to the group's last block
            boundary = group.snap_notify[-1] if group.snap_notify else None
            t0 = time.perf_counter()
            try:
                with tracing.span("fsync", cat="stage", block=boundary,
                                  blocks=group.blocks):
                    self._blocks.sync_files(group.dirty_files)
                    faultline.point("commit.stage", stage="fsync")
                t1 = time.perf_counter()
                with tracing.span("kv_txn", cat="stage", block=boundary,
                                  blocks=group.blocks):
                    group.collector.flush()
                    faultline.point("commit.stage", stage="kv_txn")
            except BaseException as exc:
                # the buffered index is gone, so the unindexed appends go
                # too; height and hash return to the durable ones.  A
                # simulated process death (faultline's FaultCrash) skips
                # the unwind: reopen must run the real recovery
                if not faultline.is_crash(exc):
                    self._rollback_group(group)
                raise
            t2 = time.perf_counter()
            self._observe_stages(fsync=t1 - t0, kv_txn=t2 - t1)
            # the sharded store's two-phase flush: its per-phase and
            # per-shard splits say where inside kv_txn the time went
            sub = getattr(self._kv, "last_stage_seconds", None)
            if sub:
                self._observe_stages(**{f"kv_{k}": v for k, v in sub.items()})
            if self._metrics is not None:
                self._metrics.blocks_per_sync.With(
                    "channel", self.ledger_id).observe(group.blocks)
            self._state.invalidate_caches()
            self._durable_height = self._blocks.height
            self._durable_hash = self._blocks.last_block_hash
            self._publish_heights()
        notify, group.snap_notify = group.snap_notify, []
        group.blocks = 0
        group.dirty_files.clear()
        group.boundary_hint = False
        if self._active_group is group:
            self._active_group = None
        if self.snapshots is not None:
            for num in notify:
                self.snapshots.on_block_committed(num)

    def _rollback_group(self, group: CommitGroup) -> None:
        """Drop a group's buffered writes and its unindexed appends."""
        group.collector.discard()
        self._blocks.truncate_to_checkpoint()
        group.blocks = 0
        group.dirty_files.clear()
        group.snap_notify.clear()
        group.boundary_hint = False
        group.state.invalidate_caches()
        if self._active_group is group:
            self._active_group = None
        self._publish_heights()

    def _observe_stages(self, **stages: float) -> None:
        acc = self.commit_stage_seconds
        for name, dt in stages.items():
            acc[name] = acc.get(name, 0.0) + dt
            if self._metrics is not None:
                self._metrics.stage_duration.With(
                    "channel", self.ledger_id, "stage", name).observe(dt)

    @property
    def durable_height(self) -> int:
        """The height as of the last flush."""
        return self._durable_height

    @property
    def durable_block_hash(self) -> bytes:
        return self._durable_hash

    def commit_old_pvt_data(self, block_num: int, tx_num: int,
                            pvt_bytes: bytes) -> None:
        """Apply private data the reconciler fetched for an old block
        (reference CommitPvtDataOfOldBlocks): store it, and update the
        private state of keys whose hashed version is still (block_num,
        tx_num); a newer version means the value is stale."""
        self.pvt_store.resolve_missing(block_num, tx_num, pvt_bytes)
        h = Height(block_num, tx_num)
        batch: dict[str, dict] = {}
        for nsp in rw.TxPvtReadWriteSet.decode(pvt_bytes).ns_pvt_rwset:
            for cp in nsp.collection_pvt_rwset:
                hns = hash_ns(nsp.namespace, cp.collection_name)
                pns = pvt_ns(nsp.namespace, cp.collection_name)
                for w in rw.KVRWSet.decode(cp.rwset).writes:
                    hkey = key_hash(w.key).hex()
                    if self._state.get_version(hns, hkey) != h:
                        continue  # overwritten since
                    batch.setdefault(pns, {})[w.key] = (
                        None if w.is_delete else VersionedValue(w.value, h))
        if batch:
            self._state.apply_updates(batch, None)

    # -- queries --------------------------------------------------------------

    @property
    def block_store(self) -> BlockStore:
        return self._blocks

    @property
    def state_db(self) -> VersionedDB:
        return self._state

    @property
    def height(self) -> int:
        return self._blocks.height

    def get_blockchain_info(self) -> dict:
        return self._blocks.info()

    def get_block_by_number(self, num: int) -> cb.Block | None:
        return self._blocks.get_block_by_number(num)

    def get_block_by_hash(self, h: bytes) -> cb.Block | None:
        return self._blocks.get_block_by_hash(h)

    def get_tx_by_id(self, txid: str) -> cb.Envelope | None:
        return self._blocks.get_tx_by_id(txid)

    def get_tx_validation_code(self, txid: str) -> int | None:
        return self._blocks.get_tx_validation_code(txid)

    def tx_id_exists(self, txid: str) -> bool:
        return bool(self._blocks.tx_ids_exist([txid]))

    def tx_ids_exist(self, txids) -> set[str]:
        """The duplicate-txid probe of a whole block, one index round
        trip."""
        return self._blocks.tx_ids_exist(txids)

    def may_have_state_metadata(self, ns: str) -> bool:
        """False guarantees that no key of `ns` (public or a hashed
        collection namespace) carries metadata."""
        return self._state.may_have_metadata(ns)

    def define_index(self, ns: str, field) -> None:
        """Create and backfill a rich-query index on a dotted JSON field
        of a namespace (or a compound one over a list of fields), the
        statecouchdb index definition (statecouchdb.go:53) that a
        chaincode's META-INF/statedb/indexes feed."""
        self._state.define_index(ns, field)

    def new_tx_simulator(self) -> TxSimulator:
        return TxSimulator(self._state)

    def new_query_executor(self) -> "QueryExecutor":
        """A read-only executor (reference ledger.QueryExecutor,
        core/ledger/ledger_interface.go:214)."""
        return QueryExecutor(self._state)

    def get_state(self, ns: str, key: str) -> bytes | None:
        return self.new_query_executor().get_state(ns, key)

    def get_state_multiple(self, ns: str, keys) -> list[bytes | None]:
        return self.new_query_executor().get_state_multiple(ns, keys)

    def get_state_range(self, ns: str, start: str, end: str):
        return self.new_query_executor().get_state_range(ns, start, end)

    def get_private_data(self, ns: str, coll: str, key: str) -> bytes | None:
        return self.new_query_executor().get_private_data(ns, coll, key)

    def get_private_data_hash(self, ns: str, coll: str,
                              key: str) -> bytes | None:
        return self.new_query_executor().get_private_data_hash(ns, coll, key)

    def get_state_metadata(self, ns: str, key: str) -> dict[str, bytes]:
        """A key's decoded metadata entries; `ns` may be a hashed
        collection namespace."""
        return self.new_query_executor().get_state_metadata(ns, key)

    def get_history_for_key(self, ns: str, key: str) -> list[tuple[int, int]]:
        return self._history.get_history_for_key(ns, key)


class QueryExecutor:
    """Read-only state access for system chaincodes and endorser queries
    (reference QueryExecutor, ledger_interface.go:214).  Records no
    reads: it is never part of a transaction."""

    def __init__(self, state: VersionedDB):
        self._state = state

    def get_state(self, ns: str, key: str) -> bytes | None:
        vv = self._state.get_state(ns, key)
        return vv.value if vv else None

    def get_state_multiple(self, ns: str, keys) -> list[bytes | None]:
        return [vv.value if vv else None
                for vv in self._state.get_state_multiple(ns, keys)]

    def get_state_range(self, ns: str, start: str, end: str):
        for key, vv in self._state.get_state_range(ns, start, end):
            yield key, vv.value

    def get_private_data(self, ns: str, coll: str, key: str) -> bytes | None:
        vv = self._state.get_state(pvt_ns(ns, coll), key)
        return vv.value if vv else None

    def get_private_data_hash(self, ns: str, coll: str,
                              key: str) -> bytes | None:
        vv = self._state.get_state(hash_ns(ns, coll), key_hash(key).hex())
        return vv.value if vv else None

    def get_state_metadata(self, ns: str, key: str) -> dict[str, bytes]:
        """A key's decoded metadata entries, as the simulator's
        get_state_metadata; `ns` may be a hashed collection namespace."""
        if not self._state.may_have_metadata(ns):
            return {}
        vv = self._state.get_state(ns, key)
        return decode_metadata(vv.metadata) if vv else {}

    def done(self) -> None:
        pass


class LedgerProvider:
    """Creates and opens the channels' ledgers under one root (reference
    kv_ledger_provider.go and ledgermgmt): one sqlite file
    `<root>/index.sqlite` for every channel's KV data (with
    `state_NN.sqlite` shard files under FABRIC_TPU_STORE_SHARDS > 1),
    block files under `<root>/<channel>/chains`, snapshots under
    `snapshots_dir` (default `<root>/snapshots`); `root_dir=None` keeps
    everything in memory.
    `csp` hashes the snapshots' files (`CUDACSP.hash_batch` on the card;
    the host's hashlib when None)."""

    def __init__(self, root_dir: str | None = None, csp=None,
                 snapshots_dir: str | None = None, commit_metrics=None,
                 ledger_metrics=None):
        self._root = root_dir
        self._csp = csp
        # each ledger's CommitMetrics and LedgerMetrics
        self._commit_metrics = commit_metrics
        self._ledger_metrics = ledger_metrics
        if snapshots_dir is None and root_dir is not None:
            snapshots_dir = os.path.join(root_dir, "snapshots")
        self._snapshots_dir = snapshots_dir
        if root_dir is not None:
            os.makedirs(root_dir, exist_ok=True)
        # one sqlite file by default; FABRIC_TPU_STORE_SHARDS > 1 (or a
        # sharded layout on disk) mounts the namespace-sharded store with
        # its two-phase flush behind the same KVStore SPI
        self._kv = open_store_root(root_dir)
        self._ledgers: dict[str, KVLedger] = {}

    def create(self, genesis_block: cb.Block) -> KVLedger:
        """The ledger of the channel the genesis block names, with the
        genesis block committed."""
        env = protoutil.extract_envelope(genesis_block, 0)
        payload = cb.Payload.decode(env.payload)
        chdr = cb.ChannelHeader.decode(payload.header.channel_header)
        ledger = self.open(chdr.channel_id)
        if ledger.height == 0:
            ledger.commit(genesis_block)
        return ledger

    def _block_dir(self, ledger_id: str) -> str | None:
        return (None if self._root is None
                else os.path.join(self._root, ledger_id, "chains"))

    def _half_import(self, ledger_id: str) -> bool:
        """A crashed join from a snapshot leaves the stores with part of
        it; such a channel is refused, not served."""
        return (snap.import_marker(self._kv, ledger_id)
                == snap.IMPORT_IN_PROGRESS)

    def _add(self, ledger_id: str, store: BlockStore) -> KVLedger:
        ledger = KVLedger(ledger_id, store, self._kv,
                          metrics=self._commit_metrics,
                          ledger_metrics=self._ledger_metrics)
        ledger.snapshots = snap.SnapshotManager(
            ledger, self._snapshots_dir, self._kv, csp=self._csp)
        self._ledgers[ledger_id] = ledger
        return ledger

    def open(self, ledger_id: str) -> KVLedger:
        if ledger_id in self._ledgers:
            return self._ledgers[ledger_id]
        if self._half_import(ledger_id):
            raise snap.SnapshotError(
                f"channel {ledger_id!r} has a half-finished snapshot "
                "import (the importing process crashed); run "
                "discard_failed_import() and re-join from the snapshot")
        return self._add(ledger_id, BlockStore(self._block_dir(ledger_id),
                                               self._kv, name=ledger_id))

    def create_from_snapshot(self, snapshot_dir: str) -> KVLedger:
        """A channel's ledger with no blocks, from a verified snapshot
        (reference kv_ledger_provider.go CreateFromSnapshot): the block
        store resumes at the snapshot's height and hash, the state DB
        holds the snapshot's state with its savepoint there.  Every
        file's digest is computed again through the provider's CSP first,
        and a tampered snapshot is refused."""
        meta = snap.verify_snapshot(snapshot_dir, csp=self._csp)
        ledger_id = meta["channel_id"]
        if ledger_id in self._ledgers:
            raise snap.SnapshotError(f"ledger {ledger_id!r} already exists")
        if self._half_import(ledger_id):
            raise snap.SnapshotError(
                f"channel {ledger_id!r} has a half-finished snapshot "
                "import; run discard_failed_import() before re-joining")
        store = BlockStore(self._block_dir(ledger_id), self._kv,
                           name=ledger_id)
        if store.height:
            raise snap.SnapshotError(
                f"channel {ledger_id!r} already has {store.height} blocks")
        snap.import_snapshot(meta, snapshot_dir, store, self._kv, ledger_id)
        return self._add(ledger_id, store)

    # every namespace of a channel on the shared KV store, which a discard
    # must clear, or a retried import lands on residue (bookkeeping is two
    # levels deep: bookkeeping/<lid>/<category>)
    _CHANNEL_NAMESPACES = (
        "blkindex/{lid}", "statedb/{lid}", "historydb/{lid}",
        "pvtdata/{lid}", "confighistory/{lid}", "transient/{lid}",
        "bookkeeping/{lid}/", "snapimport/{lid}",
    )

    def discard_failed_import(self, ledger_id: str) -> int:
        """Clear what a crashed snapshot import left, so that the channel
        can join again.  Refused unless the channel's import marker is
        IMPORT_IN_PROGRESS: this is no channel delete.  Clears every
        namespace of the channel on the KV store (the marker last, so
        that a crash midway leaves the channel refused and the discard
        can run again) and its block directory.  Returns the KV keys
        deleted."""
        if not self._half_import(ledger_id):
            raise snap.SnapshotError(
                f"channel {ledger_id!r} has no half-finished snapshot "
                "import to discard")
        deleted = 0
        marker_prefix = f"snapimport/{ledger_id}".encode() + NamedDB._SEP
        for ns in self._CHANNEL_NAMESPACES:
            name = ns.format(lid=ledger_id)
            # bookkeeping/<lid>/ spans its categories: its name is the
            # prefix itself
            prefix = (name.encode() if name.endswith("/")
                      else name.encode() + NamedDB._SEP)
            if prefix == marker_prefix:
                continue  # the marker goes last, below
            deleted += wipe_prefix(self._kv, prefix)
        if self._root is not None:
            chain_dir = os.path.join(self._root, ledger_id)
            if os.path.isdir(chain_dir):
                shutil.rmtree(chain_dir)
        NamedDB(self._kv, f"snapimport/{ledger_id}").delete(b"state")
        return deleted

    @property
    def kv(self) -> KVStore:
        return self._kv

    @property
    def snapshots_root(self) -> str | None:
        """The completed / in_progress snapshot tree of this provider's
        ledgers."""
        return self._snapshots_dir

    def list(self) -> list[str]:
        return sorted(self._ledgers)

    def close(self) -> None:
        for led in self._ledgers.values():
            if led.snapshots is not None:
                led.snapshots.close()
            led.block_store.close()
        self._kv.close()


__all__ = ["CommitAssist", "CommitGroup", "KVLedger", "LedgerProvider",
           "QueryExecutor", "extract_rwsets"]
