"""Private-data gossip: distribute, fetch, coordinate the commit (the
port's copy of `fabric_tpu/gossip/privdata.py`; reference
gossip/privdata).

  PrivDataDistributor — the endorsement-time push of cleartext
                        collection rwsets to eligible peers
  PrivDataHandler     — pushes into the transient store, pull requests
                        served (to eligible requesters only), fetches
  PrivDataCoordinator — a gossip peer's commit: validate, assemble the
                        private data (transient store, then pull),
                        commit, purge
  Reconciler          — the later fetch of data missed at commit

All of it rides the gossip comm with PrivateDataMessage,
PrivateDataRequest and PrivateDataResponse.
"""

from __future__ import annotations

import threading
import time

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.ledger.kvledger import extract_rwsets
from fabric_tpu_torch.ledger.txmgmt import VALID
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import gossip as gpb
from fabric_tpu_torch.protos import rwset as rw


def _collection_rwsets(pvt_bytes: bytes):
    """(ns, coll, raw KVRWSet) triples of a TxPvtReadWriteSet."""
    txpvt = rw.TxPvtReadWriteSet.decode(pvt_bytes)
    for nsp in txpvt.ns_pvt_rwset:
        for cp in nsp.collection_pvt_rwset:
            yield nsp.namespace, cp.collection_name, cp.rwset


def assemble_tx_pvt(colls: dict[tuple[str, str], bytes]) -> bytes | None:
    """{(ns, coll): raw} -> a serialized TxPvtReadWriteSet, namespaces
    and collections sorted."""
    if not colls:
        return None
    by_ns: dict[str, dict[str, bytes]] = {}
    for (ns, coll), raw in colls.items():
        by_ns.setdefault(ns, {})[coll] = raw
    return rw.TxPvtReadWriteSet(
        data_model=rw.TxReadWriteSet.KV,
        ns_pvt_rwset=[rw.NsPvtReadWriteSet(
            namespace=ns,
            collection_pvt_rwset=[rw.CollectionPvtReadWriteSet(
                collection_name=coll, rwset=by_ns[ns][coll])
                for coll in sorted(by_ns[ns])])
            for ns in sorted(by_ns)]).encode()


def block_pvt_requirements(block: cb.Block):
    """Each transaction's private-data requirements from its hashed
    rwsets: {tx_num: (txid, {(ns, coll): expected hash})}."""
    out: dict[int, tuple[str, dict[tuple[str, str], bytes]]] = {}
    for tx_num, raw in enumerate(extract_rwsets(block)):
        if raw is None:
            continue
        try:
            env = protoutil.extract_envelope(block, tx_num)
            txid = protoutil.channel_header(env).tx_id
            txrw = rw.TxReadWriteSet.decode(raw)
        except Exception:
            continue
        needed = {(nsrw.namespace, ch.collection_name): ch.pvt_rwset_hash
                  for nsrw in txrw.ns_rwset
                  for ch in nsrw.collection_hashed_rwset}
        if needed:
            out[tx_num] = (txid, needed)
    return out


class PrivDataDistributor:
    """The endorsement-time push: each collection's cleartext rwset to
    up to maximum_peer_count eligible peers."""

    def __init__(self, comm, collection_store, membership):
        """membership() -> [(endpoint, serialized identity)]."""
        self._comm = comm
        self._collections = collection_store
        self._membership = membership

    def distribute(self, channel: str, txid: str, block_seq: int,
                   pvt_bytes: bytes) -> dict[tuple[str, str], int]:
        """{(ns, coll): peers sent}; raises when a collection's
        required_peer_count cannot be met."""
        sent: dict[tuple[str, str], int] = {}
        for ns, coll, raw in _collection_rwsets(pvt_bytes):
            conf = self._collections.collection(ns, coll)
            eligible = [ep for ep, ident in self._membership()
                        if conf.is_member(ident)]
            targets = eligible[:max(conf.maximum_peer_count, 0)]
            if len(targets) < conf.required_peer_count:
                raise RuntimeError(
                    f"collection {ns}/{coll}: only {len(targets)} eligible "
                    f"peers, need {conf.required_peer_count}")
            msg = gpb.GossipMessage(
                channel=channel.encode(),
                private_data=gpb.PrivateDataMessage(
                    channel=channel, tx_id=txid, namespace=ns,
                    collection=coll, block_seq=block_seq, rwset=raw))
            for ep in targets:
                self._comm.send(ep, msg)
            sent[(ns, coll)] = len(targets)
        return sent


class PrivDataHandler:
    """Takes pushes into the transient store and serves pull requests
    from the local stores."""

    def __init__(self, comm, transient_store, pvtdata_store,
                 collection_store, ledger_height, channel: str | None = None):
        """`channel`: when set, pushes and requests of other channels are
        ignored (a node mounts one handler a channel on a shared comm)."""
        self._comm = comm
        self._transient = transient_store
        self._pvtstore = pvtdata_store
        self._collections = collection_store
        self._height = ledger_height  # () -> int
        self._channel = channel
        self._pending: list[tuple[dict, threading.Event, set]] = []
        self._lock = threading.Lock()
        comm.subscribe(self._on_message)

    # -- inbound -----------------------------------------------------------

    def _on_message(self, rm) -> None:
        msg = rm.msg
        which = msg.which("content")
        if self._channel is not None:
            if which == "private_data":
                ch = msg.private_data.channel
            elif which == "private_req":
                ch = msg.private_req.channel
            elif which == "private_res":
                # a response carries the channel on the outer message
                ch = msg.channel.decode("utf-8", "replace")
            else:
                ch = None
            if ch is not None and ch != self._channel:
                return
        if which == "private_data":
            pd = msg.private_data
            self._transient.persist(
                pd.tx_id, pd.block_seq,
                assemble_tx_pvt({(pd.namespace, pd.collection): pd.rwset}))
        elif which == "private_req":
            self._serve(rm)
        elif which == "private_res":
            self._absorb_response(msg.private_res)

    def _serve(self, rm) -> None:
        """Serve a pull request, only for the collections the requester
        is eligible for."""
        req = rm.msg.private_req
        requester = self._comm.identity_of(rm.sender_pki)
        elements = []
        for dig in req.digests:
            if requester is None or not self._collections.is_eligible(
                    dig.namespace, dig.collection, requester):
                continue
            raw = self._lookup(dig.tx_id, dig.namespace, dig.collection,
                               req.block_seq)
            if raw is None:
                continue
            elements.append(gpb.PrivateDataMessage(
                channel=req.channel, tx_id=dig.tx_id,
                namespace=dig.namespace, collection=dig.collection,
                block_seq=req.block_seq, rwset=raw))
        rm.respond(gpb.GossipMessage(
            channel=req.channel.encode(),
            private_res=gpb.PrivateDataResponse(elements=elements)))

    def _lookup(self, txid: str, ns: str, coll: str, block_seq: int):
        for _, pvt_bytes in self._transient.get_tx_pvt_rwsets(txid):
            for n, c, raw in _collection_rwsets(pvt_bytes):
                if (n, c) == (ns, coll):
                    return raw
        # committed data: the block's stored private data
        for raw_tx in self._pvtstore.get_pvt_data_by_block(block_seq).values():
            for n, c, raw in _collection_rwsets(raw_tx):
                if (n, c) == (ns, coll):
                    return raw
        return None

    def _absorb_response(self, res) -> None:
        with self._lock:
            for el in res.elements:
                key = (el.tx_id, el.namespace, el.collection)
                for results, event, wanted in self._pending:
                    if key in wanted and key not in results:
                        results[key] = el.rwset
                        if set(results) >= wanted:
                            event.set()

    # -- outbound fetch ----------------------------------------------------

    def fetch(self, channel: str, block_seq: int,
              digests: list[tuple[str, str, str]], endpoints: list[str],
              timeout_s: float = 2.0) -> dict[tuple[str, str, str], bytes]:
        """Ask peers in turn for [(txid, ns, coll)]; what arrived in
        time."""
        if not digests or not endpoints:
            return {}
        req = gpb.PrivateDataRequest(
            channel=channel, block_seq=block_seq,
            digests=[gpb.PrivateDigest(tx_id=t, namespace=n, collection=c)
                     for t, n, c in digests])
        results: dict[tuple[str, str, str], bytes] = {}
        event = threading.Event()
        entry = (results, event, set(digests))
        with self._lock:
            self._pending.append(entry)
        try:
            msg = gpb.GossipMessage(channel=channel.encode(),
                                    private_req=req)
            deadline = time.monotonic() + timeout_s
            for ep in endpoints:
                self._comm.send(ep, msg)
                if event.wait(min(0.5, max(0.0,
                                           deadline - time.monotonic()))):
                    break
                if time.monotonic() >= deadline:
                    break
            return dict(results)
        finally:
            with self._lock:
                self._pending.remove(entry)


class PrivDataCoordinator:
    """A gossip peer's commit (reference coordinator.go StoreBlock):
    validate, assemble the private data, commit, purge."""

    def __init__(self, validator, ledger, transient_store, collection_store,
                 self_identity: bytes, fetcher: PrivDataHandler | None = None,
                 fetch_endpoints=None, transient_block_retention: int = 1000):
        self._validator = validator
        self._ledger = ledger
        self._transient = transient_store
        self._collections = collection_store
        self._self_identity = self_identity
        self._fetcher = fetcher
        self._fetch_endpoints = fetch_endpoints or (lambda: [])
        self._retention = transient_block_retention
        self._listeners: list = []
        self._lock = threading.Lock()

    def add_commit_listener(self, fn) -> None:
        """fn(block, flags) after each commit."""
        self._listeners.append(fn)

    def set_fetcher(self, fetcher, fetch_endpoints) -> None:
        """Bind the gossip pull path after the coordinator is made."""
        self._fetcher = fetcher
        self._fetch_endpoints = fetch_endpoints

    @property
    def height(self) -> int:
        return self._ledger.height

    def get_block_by_number(self, num: int):
        """The committed-block reader of state transfer."""
        return self._ledger.get_block_by_number(num)

    def store_block(self, block) -> list[int]:
        self._validator.validate(block)
        flags = list(protoutil.tx_filter(block))
        reqs = block_pvt_requirements(block)
        to_fetch: dict[int, list[tuple[str, str, str]]] = {}
        collected: dict[int, dict[tuple[str, str], bytes]] = {}
        txids: list[str] = []
        for tx_num, (txid, needed) in reqs.items():
            if flags[tx_num] != VALID:
                continue
            txids.append(txid)
            colls: dict[tuple[str, str], bytes] = {}
            for (ns, coll), expected in needed.items():
                if not self._collections.is_eligible(ns, coll,
                                                     self._self_identity):
                    continue  # not ours, so not missing either
                raw = self._from_transient(txid, ns, coll, expected)
                if raw is not None:
                    colls[(ns, coll)] = raw
                else:
                    to_fetch.setdefault(tx_num, []).append((txid, ns, coll))
            collected[tx_num] = colls

        if to_fetch and self._fetcher is not None:
            fetched = self._fetcher.fetch(
                self._validator.channel_id, block.header.number,
                [d for ds in to_fetch.values() for d in ds],
                self._fetch_endpoints())
            for tx_num, ds in to_fetch.items():
                _, needed = reqs[tx_num]
                for txid_, ns, coll in ds:
                    raw = fetched.get((txid_, ns, coll))
                    if raw is not None and self._hash_ok(raw,
                                                         needed[(ns, coll)]):
                        collected[tx_num][(ns, coll)] = raw

        pvt_data: dict[int, bytes] = {}
        missing: list[tuple[int, str, str]] = []
        for tx_num, (txid, needed) in reqs.items():
            if flags[tx_num] != VALID:
                continue
            colls = collected.get(tx_num, {})
            for (ns, coll) in needed:
                if (ns, coll) not in colls and self._collections.is_eligible(
                        ns, coll, self._self_identity):
                    missing.append((tx_num, ns, coll))
            assembled = assemble_tx_pvt(colls)
            if assembled is not None:
                pvt_data[tx_num] = assembled

        with self._lock:
            # the ledger persists the block, its private data and the
            # missing records together
            self._ledger.commit(block, pvt_data, missing)
        self._transient.purge_by_txids(txids)
        if block.header.number % self._retention == 0:
            self._transient.purge_below_height(
                max(0, block.header.number - self._retention))
        final_flags = list(protoutil.tx_filter(block))
        for fn in self._listeners:
            fn(block, final_flags)
        return final_flags

    def _from_transient(self, txid, ns, coll, expected_hash):
        for _, pvt_bytes in self._transient.get_tx_pvt_rwsets(txid):
            for n, c, raw in _collection_rwsets(pvt_bytes):
                if (n, c) == (ns, coll) and self._hash_ok(raw, expected_hash):
                    return raw
        return None

    @staticmethod
    def _hash_ok(raw: bytes, expected: bytes) -> bool:
        # no endorsed hash, no endorsed cleartext: the supply is refused
        return bool(expected) and _sha256(raw) == expected


class Reconciler:
    """The later repair of missing private data: the ledger's missing
    list, pulled from peers, checked against the block's endorsed hashes,
    committed as old-block private data."""

    def __init__(self, ledger, fetcher: PrivDataHandler, channel: str,
                 fetch_endpoints, batch_size: int = 10):
        self._ledger = ledger
        self._fetcher = fetcher
        self._channel = channel
        self._endpoints = fetch_endpoints
        self._batch = batch_size

    def reconcile_once(self) -> int:
        """The (block, tx, ns, coll) entries repaired."""
        work = self._ledger.pvt_store.get_missing(max_blocks=self._batch)
        repaired = 0
        by_block: dict[int, list[tuple[int, str, str]]] = {}
        for block_num, tx, ns, coll in work:
            by_block.setdefault(block_num, []).append((tx, ns, coll))
        for block_num, entries in by_block.items():
            block = self._ledger.get_block_by_number(block_num)
            if block is None:
                continue
            reqs = block_pvt_requirements(block)
            digests = []
            expected: dict[tuple[int, str, str], tuple[str, bytes]] = {}
            for tx, ns, coll in entries:
                if tx not in reqs:
                    continue
                txid, needed = reqs[tx]
                exp = needed.get((ns, coll))
                if not exp:
                    continue
                digests.append((txid, ns, coll))
                expected[(tx, ns, coll)] = (txid, exp)
            if not digests:
                continue
            fetched = self._fetcher.fetch(self._channel, block_num, digests,
                                          self._endpoints())
            for (tx, ns, coll), (txid, exp) in expected.items():
                raw = fetched.get((txid, ns, coll))
                if raw is None or _sha256(raw) != exp:
                    continue  # absent or forged: still missing
                self._ledger.commit_old_pvt_data(
                    block_num, tx, assemble_tx_pvt({(ns, coll): raw}))
                repaired += 1
        return repaired


__all__ = [
    "PrivDataDistributor",
    "PrivDataHandler",
    "PrivDataCoordinator",
    "Reconciler",
    "assemble_tx_pvt",
    "block_pvt_requirements",
]
