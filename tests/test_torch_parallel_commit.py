"""The port's parallel commit stages against serial and against the JAX
package's.

- MVCC: seeded blocks over several namespaces (reads at committed, stale
  and absent versions, range queries, deletes, metadata writes, private
  collections with genuine and forged cleartext, and a crafted namespace
  that collides with another's derived one) go through the port's and the
  JAX package's `MVCCValidator` at widths 0, 1, 2 and 4: flags and update
  batches (their namespace order too) must be equal to the serial port's
  and to JAX's, exactly.
- Collect: the port's `TxValidator` at collect widths 0, 2 and 4 gives the
  serial flags and the JAX validator's; the width fans out only where it
  was chosen (the argument or FABRIC_TPU_COLLECT_POOL), never in faithful
  mode.
- A small SmallBank stream (100 accounts, 3 blocks of 40 payments, real
  signatures, `chip_smoke.smallbank_blocks`): the port's simulator writes
  the JAX simulator's bytes, and the stream through the port's
  `Committer` on `CUDACSP(device="cpu")` (its host verify: B1's plain
  version runs in `test_torch_committer.py`) and through the JAX
  `Committer` on `SWCSP` gives identical flags, KV pairs and block
  files.
"""

import random
from pathlib import Path

import pytest

import chip_smoke
from fabric_tpu.common import workpool as jax_workpool
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.ledger.rwset import rwset_pb2
from fabric_tpu.protos.ledger.rwset.kvrwset import kv_rwset_pb2
from fabric_tpu_torch import protoutil as port_pu
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger import txmgmt as port_tx
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
NAMESPACES = ["cc", "dd", "ee", "ff"]
COLL = "coll"
KEYS = [f"k{i}" for i in range(8)]
WIDTHS = (0, 1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _shut_the_port_pool():
    yield
    workpool.shutdown()


# -- MVCC ------------------------------------------------------------------------


def _version(rng, block, committed):
    r = rng.random()
    if r < 0.6:
        return committed
    if r < 0.8:
        return None
    return (max(0, block - 1), rng.randrange(4))


def _set_version(msg, v) -> None:
    if v is not None:
        msg.version.block_num, msg.version.tx_num = v


def _ns_rwset(rng, ns, block, committed, pvt_txs) -> rwset_pb2.NsReadWriteSet:
    kv = kv_rwset_pb2.KVRWSet()
    for _ in range(rng.randrange(3)):
        k = rng.choice(KEYS)
        _set_version(kv.reads.add(key=k),
                     _version(rng, block, committed.get((ns, k))))
    if rng.random() < 0.2:
        lo, hi = sorted(rng.sample(KEYS + [""], 2))
        rq = kv.range_queries_info.add(start_key=lo, end_key=hi,
                                       itr_exhausted=True)
        for k in KEYS:
            if lo <= k and (not hi or k < hi) and (ns, k) in committed \
                    and rng.random() < 0.9:
                _set_version(rq.raw_reads.kv_reads.add(key=k),
                             committed[(ns, k)])
    for _ in range(rng.randrange(1, 5)):
        kv.writes.add(key=rng.choice(KEYS), is_delete=rng.random() < 0.15,
                      value=bytes([rng.randrange(256)]))
    if rng.random() < 0.2:
        mw = kv.metadata_writes.add(key=rng.choice(KEYS))
        mw.entries.add(name="VALIDATION_PARAMETER",
                       value=bytes([rng.randrange(256)]))
    out = rwset_pb2.NsReadWriteSet(namespace=ns, rwset=kv.SerializeToString())
    if rng.random() < 0.3:
        h, pkv = kv_rwset_pb2.HashedRWSet(), kv_rwset_pb2.KVRWSet()
        for _ in range(rng.randrange(1, 3)):
            k = rng.choice(KEYS)
            hk = jax_tx.key_hash(k)
            if rng.random() < 0.5:
                _set_version(h.hashed_reads.add(key_hash=hk), _version(
                    rng, block,
                    committed.get((jax_tx.hash_ns(ns, COLL), hk.hex()))))
            dele = rng.random() < 0.2
            value = bytes([rng.randrange(256)])
            h.hashed_writes.add(key_hash=hk, is_delete=dele,
                                value_hash=jax_tx.value_hash(value))
            pkv.writes.add(key=k, is_delete=dele, value=value)
        if rng.random() < 0.3:
            mw = h.metadata_writes.add(
                key_hash=jax_tx.key_hash(rng.choice(KEYS)))
            mw.entries.add(name="x", value=b"y")
        raw_pkv = pkv.SerializeToString()
        forged = rng.random() < 0.2
        out.collection_hashed_rwset.add(
            collection_name=COLL, hashed_rwset=h.SerializeToString(),
            pvt_rwset_hash=jax_tx.value_hash(b"x" if forged else raw_pkv))
        if rng.random() < 0.8:
            pvt_txs.append((ns, raw_pkv))
    return out


def _block_rwsets(rng, block, committed, n_txs, collide):
    rwsets, pvt = [], {}
    for tx in range(n_txs):
        pvt_txs: list = []
        names = rng.sample(NAMESPACES, rng.randrange(1, 3))
        if collide and rng.random() < 0.1:
            # a top-level namespace equal to cc's derived hash namespace
            names.append(jax_tx.hash_ns("cc", COLL))
        txrw = rwset_pb2.TxReadWriteSet(ns_rwset=[
            _ns_rwset(rng, ns, block, committed, pvt_txs) for ns in names])
        rwsets.append(txrw.SerializeToString())
        if pvt_txs:
            txpvt = rwset_pb2.TxPvtReadWriteSet()
            for ns, raw in pvt_txs:
                nsp = txpvt.ns_pvt_rwset.add(namespace=ns)
                nsp.collection_pvt_rwset.add(collection_name=COLL, rwset=raw)
            pvt[tx] = txpvt.SerializeToString()
    rwsets[rng.randrange(n_txs)] = None
    return rwsets, pvt


def _batch(batch) -> list:
    return [(ns, [(k, None if v is None else
                   (v.value, v.version.pack(), v.metadata))
                  for k, v in kvs.items()]) for ns, kvs in batch.items()]


@pytest.mark.parametrize("seed", range(4))
def test_mvcc_at_every_width_equals_serial_and_the_reference(seed):
    rng = random.Random(seed)
    jstore, pstore = jax_kv.MemKVStore(), port_kv.MemKVStore()
    jdb = jax_sdb.VersionedDB(jstore, "statedb/ch")
    pdb = port_sdb.VersionedDB(pstore, "statedb/ch")
    committed: dict = {}
    fanned = {w: 0 for w in WIDTHS}
    with workpool.scoped_pool(4) as ppool, \
            jax_workpool.scoped_pool(4) as jpool:
        port_mvcc = {w: port_tx.MVCCValidator(pdb, ppool, fanout=w)
                     for w in WIDTHS}
        jax_mvcc = {w: jax_tx.MVCCValidator(jdb, jpool, fanout=w)
                    for w in WIDTHS}
        for block in range(1, 7):
            rwsets, pvt = _block_rwsets(rng, block, committed, 24,
                                        collide=seed == 3)
            flags_in = [0 if rng.random() < 0.9 else 10 for _ in rwsets]
            serial_flags = list(flags_in)
            serial = port_mvcc[0].validate_and_prepare(block, rwsets,
                                                       serial_flags, pvt)
            for w in WIDTHS:
                pf, jf = list(flags_in), list(flags_in)
                pb_ = port_mvcc[w].validate_and_prepare(block, rwsets, pf, pvt)
                jb = jax_mvcc[w].validate_and_prepare(block, rwsets, jf, pvt)
                assert pf == jf == serial_flags
                assert _batch(pb_) == _batch(jb) == _batch(serial)
            for w in WIDTHS:
                fanned[w] = port_mvcc[w].parallel_prepare_blocks
                assert fanned[w] == jax_mvcc[w].parallel_prepare_blocks
            pdb.apply_updates(serial, port_sdb.Height(block, len(rwsets)))
            jdb.apply_updates(jb, jax_sdb.Height(block, len(rwsets)))
            assert list(pstore.iterate()) == list(jstore.iterate())
            for ns, kvs in serial.items():
                for k, v in kvs.items():
                    if v is None:
                        committed.pop((ns, k), None)
                    else:
                        committed[(ns, k)] = (block, v.version.tx_num)
    assert fanned[0] == fanned[1] == 0
    assert fanned[2] > 0 and fanned[4] > 0


def test_mvcc_width_follows_the_knob(monkeypatch):
    db = port_sdb.VersionedDB(port_kv.MemKVStore())
    monkeypatch.setenv("FABRIC_TPU_MVCC_POOL", "off")
    assert port_tx.MVCCValidator(db).fanout == 0
    monkeypatch.setenv("FABRIC_TPU_MVCC_POOL", "3")
    assert port_tx.MVCCValidator(db).fanout == 3
    monkeypatch.setenv("FABRIC_TPU_MVCC_POOL", "wide")
    with pytest.raises(ValueError, match="not an integer fan-out width"):
        port_tx.MVCCValidator(db)
    monkeypatch.delenv("FABRIC_TPU_MVCC_POOL")
    assert port_tx.MVCCValidator(db).fanout == \
        jax_workpool.stage_width("FABRIC_TPU_MVCC_POOL") == \
        workpool.stage_width("FABRIC_TPU_MVCC_POOL")


def test_run_chunked_merges_in_input_order_and_raises_in_chunk_order():
    items = list(range(37))
    with workpool.scoped_pool(3) as pool:
        for width in (0, 1, 2, 5, 64):
            got = workpool.run_chunked(
                pool, lambda off, chunk: [(off, x * x) for x in chunk],
                items, width)
            assert [x for _, x in got] == [x * x for x in items]
            assert got == jax_workpool.run_chunked(
                pool, lambda off, chunk: [(off, x * x) for x in chunk],
                items, width)

        def boom(off, chunk):
            if off:
                raise RuntimeError(f"chunk {off}")
            return chunk

        with pytest.raises(RuntimeError, match="chunk 13"):
            workpool.run_chunked(pool, boom, items, 3)
    workpool.reset_stats()
    workpool.run_chunked(workpool.default_pool(), lambda o, c: c, items, 4)
    assert workpool.stats() == {"chunks": 4, "max_in_flight": 4}
    assert workpool.run_chunked(None, lambda o, c: c, [], 4) == []


# -- collect ---------------------------------------------------------------------


class World:
    def __init__(self):
        self.world = chip_smoke.validator_world(13)
        self.blocks, self.expect, _ = chip_smoke.validator_blocks(
            self.world, 3, 40, self.world.genesis_hash)
        self.port_bundle = port_bundle_from_genesis(self.world.genesis)
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.world.genesis), SWCSP())


@pytest.fixture(scope="module")
def world():
    return World()


def _host_csp():
    return CUDACSP(device="cpu", min_device_batch=1 << 30)


def test_parallel_collect_flags_equal_serial_and_the_reference(world):
    want = [[world.expect.get((b, i), 0) for i in range(40)]
            for b in range(3)]
    jv = JaxValidator(CH, chip_smoke.EmptyLedger(), world.jax_bundle, SWCSP())
    assert [jv.validate(common_pb2.Block.FromString(b))
            for b in world.blocks] == want
    with workpool.scoped_pool(4) as pool:
        for width in (0, 2, 4):
            v = TxValidator(CH, chip_smoke.EmptyLedger(), world.port_bundle,
                            _host_csp(), collect_pool=pool,
                            collect_width=width)
            assert list(v.validate_pipeline(world.blocks, depth=2)) == want
            assert v.parallel_collect_blocks == (3 if width else 0)


def test_collect_fans_out_only_at_a_chosen_width(world, monkeypatch):
    def blocks_fanned(**kw):
        v = TxValidator(CH, chip_smoke.EmptyLedger(), world.port_bundle,
                        _host_csp(), **kw)
        v.validate(world.blocks[0])
        return v.parallel_collect_blocks

    monkeypatch.delenv("FABRIC_TPU_COLLECT_POOL", raising=False)
    assert blocks_fanned() == 0  # the auto width: the native walk stays serial
    assert blocks_fanned(faithful=True, collect_width=4) == 0
    monkeypatch.setenv("FABRIC_TPU_COLLECT_POOL", "2")
    assert blocks_fanned() == 1
    monkeypatch.setenv("FABRIC_TPU_COLLECT_POOL", "0")
    assert blocks_fanned() == 0


# -- SmallBank -------------------------------------------------------------------


def _results_of(raw_env: bytes) -> bytes:
    env = cb.Envelope.decode(raw_env)
    return port_pu.get_action_from_envelope(env)[1].results


def test_a_smallbank_stream_commits_as_the_reference(world, tmp_path):
    w = chip_smoke.validator_world(21)
    sizes = {"n_accounts": 100, "n_txs": 40, "n_blocks": 3}
    seed_blk, blocks, payments, build_flags = chip_smoke.smallbank_blocks(
        w, w.genesis_hash, **sizes)
    # the JAX simulator, one block behind on a JAX build ledger, writes
    # the bytes the port's wrote into every transaction
    jp = JaxProvider(None)
    jl = jp.create(common_pb2.Block.FromString(w.genesis))
    jl.commit(common_pb2.Block.FromString(seed_blk))
    for raw, pays in zip(blocks, payments):
        for env, (src, dst) in zip(cb.Block.decode(raw).data.data, pays):
            s = jl.new_tx_simulator()
            a = int(s.get_state("checking", src))
            b = int(s.get_state("checking", dst))
            s.get_state("savings", src)
            s.set_state("checking", src, b"%d" % (a - 1))
            s.set_state("checking", dst, b"%d" % (b + 1))
            assert _results_of(env) == s.get_tx_simulation_results()
        jl.commit(common_pb2.Block.FromString(raw))
    jp.close()

    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jprov = JaxProvider(str(jroot))
    jled = jprov.create(common_pb2.Block.FromString(w.genesis))
    jcom = JaxCommitter(JaxValidator(CH, jled, bundle_from_genesis(
        common_pb2.Block.FromString(w.genesis), SWCSP()), SWCSP()), jled)
    pprov = LedgerProvider(str(proot))
    pled = pprov.create(cb.Block.decode(w.genesis))
    pcom = Committer(TxValidator(CH, pled, port_bundle_from_genesis(
        w.genesis), _host_csp()), pled)
    assert jcom.store_block(common_pb2.Block.FromString(seed_blk)) == \
        pcom.store_block(seed_blk) == [0]
    jflags = list(jcom.store_stream(
        [common_pb2.Block.FromString(b) for b in blocks], depth=6))
    pflags = list(pcom.store_stream(blocks, depth=6))
    assert pflags == jflags == build_flags
    assert {f for b in pflags for f in b} == {0, 11}
    assert list(pprov.kv.iterate()) == list(jprov.kv.iterate())
    chains = [Path(r) / CH / "chains" for r in (jroot, proot)]
    assert [{p.name: p.read_bytes() for p in c.iterdir()} for c in chains][0] \
        == {p.name: p.read_bytes() for p in chains[1].iterdir()}
    balances = chip_smoke.smallbank_replay(payments, pflags, 100)
    assert {a: int(pled.get_state("checking", a)) for a in balances} == \
        balances
    jprov.close()
    pprov.close()
