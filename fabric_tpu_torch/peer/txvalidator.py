"""Block validation with one batched signature verify per block (the port's
copy of `fabric_tpu/peer/txvalidator.py`).

Three phases, as in the reference:

  1. **Collect** (host): the C++ walk of every envelope (`collect.cc`:
     syntactic checks, offsets, the payload and endorsement digests),
     then per transaction the creator's identity, the duplicate-txid
     window and the endorsement policies' *preparation*; a lane the walk
     does not declare well formed re-runs the Python collect, which sets
     its flag (so the Python path decides every malformed envelope).
  2. **Verify** (device): one `CSP.verify_batch_async` over every creator
     and endorsement signature of the block (B1 on the card through
     `CUDACSP`).
  3. **Finish** (host): creator mask -> BAD_CREATOR_SIGNATURE; policy
     closures over the mask -> ENDORSEMENT_POLICY_FAILURE; the flags go
     into the block's TRANSACTIONS_FILTER.

With a collect width chosen (`collect_width`, or FABRIC_TPU_COLLECT_POOL),
the rwset decode of the walk's well-formed lanes fans out over the
process workpool in deterministic chunks before the per-transaction loop;
the flags are the same at every width.  There is no Python fallback for
the C++ walk: where the port's library cannot build, `validate` raises.

The seams are the JAX package's: while tracing is armed each block opens
a detached root span ``block`` (cat ``pipeline``) whose ``collect``,
``verify_wait`` and ``policy`` stage spans carry a ``block`` attribute,
and whose context rides `CommitAssist.trace_ctx` to the committer's
thread; ``collect.tx`` is the collect's fault point; `metrics` (a
`common.metrics.ValidateMetrics`) gets the stage durations.

The ledger is duck-typed: `tx_id_exists(txid)`, optionally
`tx_ids_exist(txids) -> set`, `get_state_metadata(ns, key) -> dict` and
optionally `may_have_state_metadata(ns) -> bool`.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from fabric_tpu_torch import native, protoutil
from fabric_tpu_torch.common import tracing, workpool
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.devtools import faultline, knob_registry
from fabric_tpu_torch.ledger.kvledger import CommitAssist
from fabric_tpu_torch.peer.validation_plugins import (
    IllegalWritesetError,
    PluginRegistry,
    PolicyProvider,
    ValidationContext,
    parse_footprint,
)
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import peer as V
from fabric_tpu_torch.protoutil import SignedData

# a block of fewer transactions collects serially whatever the width
_PARALLEL_MIN_TXS = 32


class _ItemSink:
    """The block's verify items, with identical (key, digest, signature)
    triples collapsed to one lane (an implicit-meta policy prepares every
    sub-policy over the same endorsements)."""

    def __init__(self, dedup: bool = True):
        self.items: list = []
        self._index: dict = {}
        self._dedup = dedup

    def add(self, item) -> int:
        if not self._dedup:
            self.items.append(item)
            return len(self.items) - 1
        k = (item.key.x, item.key.y, item.digest, item.signature)
        i = self._index.get(k)
        if i is None:
            i = len(self.items)
            self._index[k] = i
            self.items.append(item)
        return i

    def add_many(self, items) -> list[int]:
        return [self.add(it) for it in items]


@dataclasses.dataclass
class _TxWork:
    """A transaction's deferred crypto: its creator's item index and a
    pending per written namespace, with the keys it touches."""

    creator_item: int | None = None
    pendings: list = dataclasses.field(default_factory=list)
    # [(PendingValidation, [item index, ...])]
    touched_keys: frozenset = frozenset()  # {(ns_or_hashns, key)}
    rwset: bytes | None = None
    footprint: object | None = None
    txid: str | None = None
    meta_keys: frozenset = frozenset()
    # keys whose VALIDATION_PARAMETER this transaction rewrites: once it
    # is VALID, later transactions of the block touching them fail


@dataclasses.dataclass
class _ParsedTx:
    """The Python collect's result for one transaction.  `pre_flag` fires
    before the creator item joins the batch, `mid_flag` after it but before
    the duplicate-txid stage, `post_flag` after the txid registered."""

    hdr_txid: str | None = None
    pre_flag: int | None = None
    creator_item: object | None = None
    mid_flag: int | None = None
    txid: str | None = None
    post_flag: int = V.VALID
    signed: list = dataclasses.field(default_factory=list)
    cc_id: str = ""
    rwset: bytes = b""
    footprint: object | None = None


class TxValidator:
    """Validates blocks and writes their TRANSACTIONS_FILTER.

    Endorsement is checked through the plugin registry once per written
    namespace; the builtin plugin does chaincode-, collection- and
    key-level endorsement.  A transaction touching a key whose
    VALIDATION_PARAMETER an earlier VALID transaction of the block
    rewrote fails (ENDORSEMENT_POLICY_FAILURE)."""

    def __init__(self, channel_id: str, ledger, bundle, csp,
                 definition_provider=None,
                 plugin_registry: PluginRegistry | None = None,
                 faithful: bool = False, collect_pool=None,
                 collect_width: int | None = None, metrics=None):
        """`faithful=True` keeps the reference's cost model: no item
        dedup, no endorsement plans, no per-block creator memo, and a
        serial collect.  The flags are the same.

        `collect_width` > 1 fans the rwset decode of the collect out over
        `collect_pool` (default: the process workpool) in that many
        chunks; None reads FABRIC_TPU_COLLECT_POOL, 0 keeps it serial.
        Unlike MVCC's, the collect's width has no auto default: what is
        left per transaction after the C++ walk holds the GIL, and the
        JAX package measured its default fan-out a loss there.

        `metrics` (a common.metrics.ValidateMetrics) adds per-stage
        collect/verify_wait/policy histograms; the cumulative splits are
        always kept in `validate_stage_seconds`."""
        self.channel_id = channel_id
        self._ledger = ledger
        self._bundle = bundle
        self._csp = csp
        self._definitions = definition_provider
        self._faithful = faithful
        self._ns_meta = (None if faithful
                         else getattr(ledger, "may_have_state_metadata", None))
        self._ns_meta_block = None
        self._registry = plugin_registry or PluginRegistry(plans=not faithful)
        self._policy_provider = PolicyProvider(
            bundle.policy_manager, bundle.msp_manager, definition_provider)
        if faithful:
            self._collect_width = 0
        elif collect_width is not None:
            self._collect_width = max(0, collect_width)
        elif knob_registry.raw("FABRIC_TPU_COLLECT_POOL").strip():
            self._collect_width = workpool.stage_width(
                "FABRIC_TPU_COLLECT_POOL")
        else:
            self._collect_width = 0
        self._collect_pool = collect_pool
        # blocks whose collect fanned out
        self.parallel_collect_blocks = 0
        # cumulative seconds per stage: host collect, waiting for the
        # device verify, host policy finish
        self.validate_stage_seconds: dict[str, float] = {}
        self._metrics = metrics

    def _committed_metadata(self, ns: str, key: str) -> dict[str, bytes]:
        return self._ledger.get_state_metadata(ns, key)

    def _plugin_for(self, namespace: str):
        name = "vscc"
        if self._definitions is not None:
            info = self._definitions.validation_info(namespace)
            if info is not None:
                name = info[0] or "vscc"
        return self._registry.plugin(name)

    # -- phase 1 ----------------------------------------------------------

    def _creator_identity(self, creator_bytes: bytes, memo: dict):
        """The creator's identity if it deserializes and is valid on the
        channel, else None; memoized per block (not in faithful mode)."""
        if not self._faithful and creator_bytes in memo:
            return memo[creator_bytes]
        try:
            ident = self._bundle.msp_manager.deserialize_identity(creator_bytes)
            self._bundle.msp_manager.validate(ident)
        except Exception:
            ident = None
        memo[creator_bytes] = ident
        return ident

    def _collect_tx(self, env_bytes: bytes, seen_txids: set, sink: _ItemSink,
                    work: _TxWork, memo: dict) -> int:
        """The Python collect of one transaction: parse, then integrate."""
        return self._integrate_tx(
            self._parse_tx(env_bytes, memo, dup_check=lambda t: (
                t in seen_txids or self._ledger.tx_id_exists(t))),
            seen_txids, sink, work)

    def _parse_tx(self, env_bytes: bytes, memo: dict, dup_check) -> _ParsedTx:
        p = _ParsedTx()
        faultline.point("collect.tx")
        try:
            env = cb.Envelope.decode(env_bytes)
            if not env.payload:
                p.pre_flag = V.NIL_ENVELOPE
                return p
            payload = cb.Payload.decode(env.payload)
            chdr = cb.ChannelHeader.decode(payload.header.channel_header)
            shdr = cb.SignatureHeader.decode(payload.header.signature_header)
        except Exception:
            p.pre_flag = V.BAD_PAYLOAD
            return p
        p.hdr_txid = chdr.tx_id or None
        if not shdr.creator or not shdr.nonce:
            p.pre_flag = V.BAD_COMMON_HEADER
            return p
        if chdr.channel_id != self.channel_id or chdr.epoch != 0:
            p.pre_flag = V.BAD_CHANNEL_HEADER
            return p

        creator = self._creator_identity(shdr.creator, memo)
        if creator is None:
            p.pre_flag = V.BAD_CREATOR_SIGNATURE
            return p
        p.creator_item = creator.verification_item(env.payload, env.signature)

        if chdr.type == cb.CONFIG:
            p.mid_flag = V.VALID  # the config engine applies it
            return p
        if chdr.type != cb.ENDORSER_TRANSACTION:
            p.mid_flag = V.UNKNOWN_TX_TYPE
            return p
        if not chdr.tx_id or not protoutil.check_tx_id(
                chdr.tx_id, shdr.nonce, shdr.creator):
            p.mid_flag = V.BAD_PROPOSAL_TXID
            return p
        p.txid = chdr.tx_id
        if dup_check(chdr.tx_id):
            p.post_flag = V.DUPLICATE_TXID
            return p

        try:
            tx = V.Transaction.decode(payload.data)
            if not tx.actions:
                p.post_flag = V.NIL_TXACTION
                return p
            cap = V.ChaincodeActionPayload.decode(tx.actions[0].payload)
            prp_bytes = cap.action.proposal_response_payload
            prp = V.ProposalResponsePayload.decode(prp_bytes)
            action = V.ChaincodeAction.decode(prp.extension)
        except Exception:
            p.post_flag = V.BAD_PAYLOAD
            return p
        # endorsers signed over this exact proposal (GetProposalHash2: the
        # committed payload bytes as they are)
        want = protoutil.proposal_hash2(payload.header.channel_header,
                                        payload.header.signature_header,
                                        cap.chaincode_proposal_payload)
        if prp.proposal_hash != want:
            p.post_flag = V.BAD_RESPONSE_PAYLOAD
            return p
        if not cap.action.endorsements:
            p.post_flag = V.ENDORSEMENT_POLICY_FAILURE
            return p
        try:
            hdr_ext = V.ChaincodeHeaderExtension.decode(chdr.extension)
        except Exception:
            p.post_flag = V.BAD_HEADER_EXTENSION
            return p
        cc_id = hdr_ext.chaincode_id.name
        if not cc_id or action.chaincode_id.name != cc_id:
            p.post_flag = V.INVALID_CHAINCODE
            return p
        if action.events:
            try:
                ev = V.ChaincodeEvent.decode(action.events)
            except Exception:
                p.post_flag = V.INVALID_OTHER_REASON
                return p
            if ev.chaincode_id != cc_id:
                p.post_flag = V.INVALID_OTHER_REASON
                return p

        # each endorsement signs prp_bytes || endorser: one hash_batch call
        msgs = [prp_bytes + e.endorser for e in cap.action.endorsements]
        digests = self._csp.hash_batch(msgs)
        p.signed = [SignedData(m, e.endorser, e.signature, digest=d)
                    for m, e, d in zip(msgs, cap.action.endorsements, digests)]
        p.cc_id = cc_id
        p.rwset = action.results
        try:
            p.footprint = parse_footprint(p.rwset)
        except IllegalWritesetError:
            p.post_flag = V.ILLEGAL_WRITESET
        except Exception:
            p.post_flag = V.BAD_RWSET
        return p

    def _integrate_tx(self, p: _ParsedTx, seen_txids: set, sink: _ItemSink,
                      work: _TxWork) -> int:
        """Sink indexes, the duplicate-txid window and policy prepare, in
        transaction order."""
        work.txid = p.hdr_txid
        if p.pre_flag is not None:
            return p.pre_flag
        work.creator_item = sink.add(p.creator_item)
        if p.mid_flag is not None:
            return p.mid_flag
        # the txid registers even when a later stage fails
        if p.post_flag == V.DUPLICATE_TXID:
            return V.DUPLICATE_TXID
        seen_txids.add(p.txid)
        if p.post_flag != V.VALID:
            return p.post_flag
        return self._prepare_namespaces(work, p.signed, p.cc_id, p.rwset,
                                        sink, footprint=p.footprint)

    # -- the three phases -------------------------------------------------

    def validate(self, block) -> list[int]:
        """Flags of every transaction of `block` (a `Block` or its bytes);
        a `Block` gets them in its TRANSACTIONS_FILTER."""
        block, flags, works, collect, bspan = self._start_block(block, set())
        return self._finish_block(block, flags, works, collect, bspan)

    def validate_pipeline(self, blocks, depth: int = 2, release=None,
                          rwsets_out=None):
        """Yields each block's flags in order, keeping up to `depth` blocks
        in flight, so that block k+1's host collect overlaps block k's
        device verify.  Duplicate txids are caught against the ledger and
        every block in flight.  By default a block's txids leave the window
        once its flags are finished; a caller that commits later
        (`Committer.store_stream`) passes `release`, which receives for
        each yielded block a callable that closes the block's window, to
        be called once the commit has landed and the ledger's txid index
        takes over.  The callable may run on another thread: it queues the
        txids, and they leave the window before the next block's collect
        (which probes the ledger once, at its start), never during one.
        `rwsets_out` receives one `CommitAssist` per block (rwsets,
        footprints, txids, envelope bytes) for the committer.  Key-level
        policy reads for block k+1 see the state before block k (use
        depth=1 for strict adjacency)."""
        q: collections.deque = collections.deque()
        seen_txids: set[str] = set()
        released: collections.deque = collections.deque()

        def finish(started):
            block, flags, works, collect, bspan, txids = started
            flags = self._finish_block(block, flags, works, collect, bspan)
            if rwsets_out is not None:
                # trace_ctx carries the block's trace root onto the
                # committer's thread
                rwsets_out(CommitAssist(
                    rwsets=[w.rwset for w in works],
                    footprints=[w.footprint for w in works],
                    txids=[w.txid for w in works],
                    env_bytes=block.data.data,
                    trace_ctx=bspan.ctx))
            if release is None:
                seen_txids.difference_update(txids)
            else:
                release(lambda: released.append(txids))
            return flags

        for block in blocks:
            while released:
                seen_txids.difference_update(released.popleft())
            before = set(seen_txids)
            started = self._start_block(block, seen_txids)
            q.append(started + (seen_txids - before,))
            if len(q) >= depth:
                yield finish(q.popleft())
        while q:
            yield finish(q.popleft())

    def _collect_fanout(self, n: int) -> int:
        """The chunk count of a block's parallel collect; 0 keeps it
        serial, as does a small block (the chunks would cost more than
        they save)."""
        width = self._collect_width
        if width <= 1 or n < _PARALLEL_MIN_TXS:
            return 0
        return min(width, n)

    def _start_block(self, block, seen_txids: set):
        """Phases 1 and 2: collect every transaction, dispatch the verify."""
        t0 = time.perf_counter()
        if not isinstance(block, cb.Block):
            block = cb.Block.decode(block)
        num = block.header.number
        # a detached per-block root: blocks overlap in the pipeline, so
        # its children (collect here, verify_wait and policy in
        # _finish_block, the commit stages on the committer's thread)
        # attach to it explicitly
        bspan = tracing.begin("block", detach=True, cat="pipeline",
                              block=num)
        try:
            with tracing.attached(bspan.ctx), tracing.span(
                    "collect", cat="stage", block=num):
                flags, works, collect = self._collect_block(block,
                                                            seen_txids)
        except BaseException:
            # a detached root is off the stack repair: end it here
            bspan.annotate(aborted=True)
            bspan.end()
            raise
        self._observe_stage("collect", time.perf_counter() - t0)
        return block, flags, works, collect, bspan

    def _collect_block(self, block, seen_txids: set):
        envs = list(block.data.data)
        n = len(envs)
        flags = [V.NOT_VALIDATED] * n
        works = [_TxWork() for _ in range(n)]
        sink = _ItemSink(dedup=not self._faithful)
        memo: dict = {}
        self._policy_provider.begin_block()
        raw_meta = self._ns_meta
        if raw_meta is not None:
            meta_memo: dict = {}

            def ns_meta(ns, _memo=meta_memo, _raw=raw_meta):
                v = _memo.get(ns)
                if v is None:
                    v = _memo[ns] = _raw(ns)
                return v

            self._ns_meta_block = ns_meta
        else:
            self._ns_meta_block = None
        self._collect_native(envs, seen_txids, sink, works, flags, memo)
        collect = (self._csp.verify_batch_async(sink.items) if sink.items
                   else (lambda: []))
        return flags, works, collect

    def _collect_native(self, data, seen_txids, sink: _ItemSink, works, flags,
                        memo: dict) -> None:
        """One C++ pass over the block's envelopes, then identity and
        policy work per transaction.  Every lane the walk does not declare
        fully well formed (status < 0) re-runs the Python collect, so the
        Python path sets the flags of malformed envelopes."""
        lens = np.array([len(d) for d in data], np.int64)
        offs = np.concatenate((np.zeros(1, np.int64), np.cumsum(lens)))
        buf = b"".join(data)
        co = native.collect_block(buf, offs, self.channel_id.encode())
        digs = co["payload_digest"].tobytes()
        edigs = co["e_digest"].tobytes()
        status_l = co["status"].tolist()
        txid_off_l = co["txid_off"].tolist()
        txid_len_l = co["txid_len"].tolist()
        if hasattr(self._ledger, "tx_ids_exist"):
            # one ledger probe for the block's duplicate-txid check
            probe = {buf[txid_off_l[i]:txid_off_l[i] + txid_len_l[i]].decode()
                     for i in range(len(data)) if txid_len_l[i]}
            ledger_dups = self._ledger.tx_ids_exist(probe)
            txid_known = ledger_dups.__contains__
        else:
            txid_known = self._ledger.tx_id_exists
        ident_intern: dict = {}  # endorser slice -> one shared bytes object
        creator_off_l = co["creator_off"].tolist()
        creator_len_l = co["creator_len"].tolist()
        sig_off_l = co["sig_off"].tolist()
        sig_len_l = co["sig_len"].tolist()
        rwset_off_l = co["rwset_off"].tolist()
        rwset_len_l = co["rwset_len"].tolist()
        ccid_off_l = co["ccid_off"].tolist()
        ccid_len_l = co["ccid_len"].tolist()
        endo_start_l = co["endo_start"].tolist()
        endo_count_l = co["endo_count"].tolist()
        ee_off = co["e_endorser_off"].tolist()
        ee_len = co["e_endorser_len"].tolist()
        es_off = co["e_sig_off"].tolist()
        es_len = co["e_sig_len"].tolist()

        # the rwset decode of the endorser lanes the walk validated, fanned
        # out before the loop below, which then runs as it would serially;
        # a decode that fails carries its flag in place of the footprint,
        # applied where the inline decode would have failed
        prefetched: list | None = None
        width = self._collect_fanout(len(data))
        if width:
            def _prefetch(off, lanes):
                out = []
                for i in lanes:
                    faultline.point("collect.tx")
                    try:
                        fp = parse_footprint(
                            buf[rwset_off_l[i]:rwset_off_l[i]
                                + rwset_len_l[i]])
                    except IllegalWritesetError:
                        fp = V.ILLEGAL_WRITESET
                    except Exception:
                        fp = V.BAD_RWSET
                    out.append(fp)
                return out

            # endorser lanes (not CONFIG) that the duplicate check keeps: a
            # duplicate's rwset is never decoded.  A lane left out here
            # that turns out clean decodes inline; the flags never depend
            # on what was prefetched.
            lanes = []
            for i in range(len(data)):
                if status_l[i] < 0 or status_l[i] == 1:
                    continue
                if txid_len_l[i]:
                    try:
                        t = buf[txid_off_l[i]:txid_off_l[i]
                                + txid_len_l[i]].decode()
                    except UnicodeDecodeError:
                        continue  # the loop collects this lane in Python
                    if t in seen_txids or txid_known(t):
                        continue
                lanes.append(i)
            got = workpool.run_chunked(
                self._collect_pool or workpool.default_pool(), _prefetch,
                lanes, width)
            prefetched = [None] * len(data)
            for i, fp in zip(lanes, got):
                prefetched[i] = fp
            self.parallel_collect_blocks += 1

        for i in range(len(data)):
            st = status_l[i]
            if st < 0:  # the Python collect decides every such lane
                flags[i] = self._collect_tx(data[i], seen_txids, sink,
                                            works[i], memo)
                continue
            co_, cl = creator_off_l[i], creator_len_l[i]
            creator = self._creator_identity(buf[co_:co_ + cl], memo)
            if creator is None:
                flags[i] = V.BAD_CREATOR_SIGNATURE
                continue
            w = works[i]
            so, sl = sig_off_l[i], sig_len_l[i]
            w.creator_item = sink.add(VerifyBatchItem(
                creator.public_key, digs[32 * i:32 * i + 32],
                buf[so:so + sl]))
            if st == 1:  # CONFIG: the creator's signature only
                flags[i] = V.VALID
                continue
            try:
                to, tl = txid_off_l[i], txid_len_l[i]
                txid = buf[to:to + tl].decode()
                cc_id = buf[ccid_off_l[i]:ccid_off_l[i]
                            + ccid_len_l[i]].decode()
            except UnicodeDecodeError:
                flags[i] = self._collect_tx(data[i], seen_txids, sink,
                                            works[i], memo)
                continue
            w.txid = txid
            if txid in seen_txids or txid_known(txid):
                flags[i] = V.DUPLICATE_TXID
                continue
            seen_txids.add(txid)
            ro, rl = rwset_off_l[i], rwset_len_l[i]
            es, ec = endo_start_l[i], endo_count_l[i]
            signed = []
            for k in range(es, es + ec):
                ident = buf[ee_off[k]:ee_off[k] + ee_len[k]]
                signed.append(SignedData(
                    b"", ident_intern.setdefault(ident, ident),
                    buf[es_off[k]:es_off[k] + es_len[k]],
                    digest=edigs[32 * k:32 * k + 32]))
            fp = prefetched[i] if prefetched is not None else None
            if isinstance(fp, int):
                flags[i] = fp  # the prefetched decode failed
                continue
            flags[i] = self._prepare_namespaces(
                w, signed, cc_id, buf[ro:ro + rl], sink, footprint=fp)

    def _prepare_namespaces(self, w, signed, cc_id, rwset_bytes,
                            sink: _ItemSink, footprint=None) -> int:
        """The rwset footprint and one plugin prepare per written
        namespace."""
        if footprint is None:
            try:
                footprint = parse_footprint(rwset_bytes)
            except IllegalWritesetError:
                return V.ILLEGAL_WRITESET
            except Exception:
                return V.BAD_RWSET
        namespaces = [cc_id] + [ns for ns, entry in footprint.per_ns.items()
                                if entry["writes"] and ns != cc_id]
        for ns in namespaces:
            ctx = ValidationContext(
                channel_id=self.channel_id, namespace=ns, tx_pos=-1,
                endorsements=signed, rwset_bytes=rwset_bytes,
                policy_provider=self._policy_provider,
                state_metadata=self._committed_metadata,
                footprint=footprint, ns_has_metadata=self._ns_meta_block)
            try:
                pending = self._plugin_for(ns).prepare(ctx)
            except Exception:
                return V.INVALID_OTHER_REASON
            w.pendings.append((pending, sink.add_many(pending.items)))
        w.touched_keys = footprint.touched
        w.rwset = rwset_bytes
        w.footprint = footprint
        w.meta_keys = frozenset(footprint.meta_writes)
        return V.VALID

    def _observe_stage(self, stage: str, dt: float) -> None:
        acc = self.validate_stage_seconds
        acc[stage] = acc.get(stage, 0.0) + dt
        if self._metrics is not None:
            self._metrics.stage_duration.With(
                "channel", self.channel_id, "stage", stage).observe(dt)

    def _finish_block(self, block, flags, works, collect,
                      bspan) -> list[int]:
        """Phase 3, in transaction order.  Policies read the committed
        (pre-block) metadata; a transaction touching a key whose
        VALIDATION_PARAMETER an earlier VALID one rewrote fails.  The
        block's root span ends here, also when verify or policy raise."""
        try:
            return self._finish_block_traced(block, flags, works, collect,
                                             bspan.ctx)
        except BaseException:
            bspan.annotate(aborted=True)
            raise
        finally:
            bspan.end()

    def _finish_block_traced(self, block, flags, works, collect,
                             ctx) -> list[int]:
        n = len(flags)
        num = block.header.number
        t0 = time.perf_counter()
        with tracing.attached(ctx), tracing.span(
                "verify_wait", cat="stage", block=num):
            mask = collect()
        t1 = time.perf_counter()
        self._observe_stage("verify_wait", t1 - t0)
        updated: set[tuple[str, str]] = set()
        with tracing.attached(ctx), tracing.span(
                "policy", cat="stage", block=num):
            for i in range(n):
                if flags[i] != V.VALID:
                    continue
                w = works[i]
                if w.creator_item is not None and not mask[w.creator_item]:
                    flags[i] = V.BAD_CREATOR_SIGNATURE
                    continue
                if w.touched_keys & updated:
                    flags[i] = V.ENDORSEMENT_POLICY_FAILURE
                    continue
                if not all(p.finish([mask[j] for j in idxs])
                           for p, idxs in w.pendings):
                    flags[i] = V.ENDORSEMENT_POLICY_FAILURE
                    continue
                updated.update(w.meta_keys)
            protoutil.set_tx_filter(block, bytes(flags))
        self._observe_stage("policy", time.perf_counter() - t1)
        return flags


__all__ = ["TxValidator"]
