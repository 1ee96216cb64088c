"""The port's commit path against the JAX package's, end to end.

A few blocks of 10 transactions from the port's CA world (chip_smoke's
5-org channel, MAJORITY endorsement), with the validator's planted faults
in block 3, MVCC conflicts in block 4 and a txid of block 4 repeated in
block 6, go through the JAX `Committer` (the JAX `TxValidator` on `SWCSP`,
blocks decoded by `common_pb2.Block.FromString`) and through the port's
(`CUDACSP(device="cpu")`: B1's plain version at depth 6, the host
verify elsewhere), each into its own on-disk ledger.  Flags, the
TRANSACTIONS_FILTER of every committed block, every KV pair of the store
and the block files' bytes must be equal, exactly, for `store_stream` at
depths 1, 3 and 6 and for `store_block`, and again after a reopen.
"""

import os
import sys
from pathlib import Path

import pytest

import chip_smoke
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch import protoutil as port_pu
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.ledger import kvstore
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
N_BLOCKS = 6
N_TXS = 10


class World:
    def __init__(self):
        self.world = chip_smoke.validator_world(9)
        self.genesis = self.world.genesis
        self.blocks, self.expect, self.conflicts = chip_smoke.validator_blocks(
            self.world, N_BLOCKS, N_TXS, self.world.genesis_hash, mvcc=True)
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.genesis), SWCSP())
        self.port_bundle = port_bundle_from_genesis(self.genesis)

    def expected_flags(self):
        want = {**self.expect, **self.conflicts}
        return [[want.get((b, i), 0) for i in range(N_TXS)]
                for b in range(N_BLOCKS)]


@pytest.fixture(scope="module")
def world():
    return World()


def _jax_side(w, root):
    provider = JaxProvider(str(root))
    ledger = provider.create(common_pb2.Block.FromString(w.genesis))
    validator = JaxValidator(CH, ledger, w.jax_bundle, SWCSP())
    return provider, ledger, JaxCommitter(validator, ledger)


def _port_side(w, root, plain_b1=False):
    """The port's ledger and committer.  Its CSP verifies on the host
    (hostref) below `min_device_batch`; `plain_b1` keeps the default, so
    the blocks' flushes run B1's plain version (~1 s a launch here)."""
    provider = LedgerProvider(str(root))
    ledger = provider.create(cb.Block.decode(w.genesis))
    csp = (CUDACSP(device="cpu") if plain_b1
           else CUDACSP(device="cpu", min_device_batch=1 << 30))
    validator = TxValidator(CH, ledger, w.port_bundle, csp)
    return provider, ledger, Committer(validator, ledger)


def _run(committer, blocks, depth):
    if depth is None:
        return [committer.store_block(b) for b in blocks]
    return list(committer.store_stream(blocks, depth=depth))


def _files(root) -> dict:
    chains = Path(root) / CH / "chains"
    return {p.name: p.read_bytes() for p in sorted(chains.iterdir())}


def _same_ledgers(jax_root, jax_provider, jax_ledger, port_root,
                  port_provider, port_ledger):
    assert port_ledger.height == jax_ledger.height == N_BLOCKS + 1
    assert port_ledger.durable_height == jax_ledger.durable_height
    assert port_ledger.durable_block_hash == jax_ledger.durable_block_hash
    assert list(port_provider.kv.iterate()) == list(jax_provider.kv.iterate())
    assert _files(port_root) == _files(jax_root)
    for n in range(N_BLOCKS + 1):
        jb = jax_ledger.get_block_by_number(n)
        pb_ = port_ledger.get_block_by_number(n)
        assert pb_.encode() == jb.SerializeToString()


@pytest.mark.parametrize("depth", [None, 1, 3, 6],
                         ids=["store_block", "depth1", "depth3", "depth6"])
def test_committed_ledgers_equal_the_reference(world, tmp_path, depth):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jp, jl, jc = _jax_side(world, jroot)
    pp, pl, pc = _port_side(world, proot, plain_b1=depth == 6)
    jflags = _run(jc, [common_pb2.Block.FromString(b) for b in world.blocks],
                  depth)
    pflags = _run(pc, world.blocks, depth)
    assert pflags == jflags == world.expected_flags()
    for n in range(1, N_BLOCKS + 1):
        assert (pl.get_block_by_number(n).metadata.metadata[2]
                == bytes(jl.get_block_by_number(n).metadata.metadata[2])
                == bytes(pflags[n - 1]))
    _same_ledgers(jroot, jp, jl, proot, pp, pl)
    hist = [(chip_smoke.MVCC_BLOCK, 1), (chip_smoke.DUP_BLOCK, 2)]
    assert pl.get_history_for_key(chip_smoke.VALIDATOR_CC,
                                  chip_smoke.HIST_KEY) == hist
    assert jl.get_history_for_key(chip_smoke.VALIDATOR_CC,
                                  chip_smoke.HIST_KEY) == hist
    assert pl.get_state(chip_smoke.VALIDATOR_CC, "k0-7") == b"v7"
    txid = pl.get_block_by_number(2).data.data[0]
    assert pl.get_tx_validation_code(
        cb.ChannelHeader.decode(cb.Payload.decode(cb.Envelope.decode(
            txid).payload).header.channel_header).tx_id) == 0
    # reopen both, each on its own directory, then the port on the JAX one
    jp.close()
    pp.close()
    jp2 = JaxProvider(str(jroot))
    pp2 = LedgerProvider(str(proot))
    _same_ledgers(jroot, jp2, jp2.open(CH), proot, pp2, pp2.open(CH))
    jp2.close()
    pp2.close()
    cross = LedgerProvider(str(jroot))
    led = cross.open(CH)
    assert led.height == N_BLOCKS + 1
    assert led.get_state(chip_smoke.VALIDATOR_CC, chip_smoke.HIST_KEY) == \
        b"h%d" % (chip_smoke.DUP_BLOCK - 1)
    cross.close()


def test_a_lost_kv_transaction_replays_as_the_reference(world, tmp_path):
    """Both ledgers, their KV transaction of the last group lost (the KV
    store copied before the flush), reopen to the same height and store."""
    roots = {}
    for side, make in (("jax", _jax_side), ("port", _port_side)):
        root = tmp_path / side
        provider, ledger, committer = make(world, root)
        blocks = world.blocks if side == "port" else [
            common_pb2.Block.FromString(b) for b in world.blocks]
        _run(committer, blocks[:4], 1)
        provider.close()
        saved = (root / "index.sqlite").read_bytes()
        wal = root / "index.sqlite-wal"
        saved_wal = wal.read_bytes() if wal.exists() else None
        provider, ledger, committer = make(world, root)
        _run(committer, blocks[4:], 2)
        provider.close()
        # the block files keep every record; the KV store loses the rest
        (root / "index.sqlite").write_bytes(saved)
        if saved_wal is None:
            wal.unlink(missing_ok=True)
        else:
            wal.write_bytes(saved_wal)
        (root / "index.sqlite-shm").unlink(missing_ok=True)
        roots[side] = root
    jp, pp = JaxProvider(str(roots["jax"])), LedgerProvider(str(roots["port"]))
    _same_ledgers(roots["jax"], jp, jp.open(CH), roots["port"], pp,
                  pp.open(CH))
    jp.close()
    pp.close()


def test_a_raising_listener_reaches_the_consumer(world, tmp_path):
    heights = {}
    for side, make in (("jax", _jax_side), ("port", _port_side)):
        provider, ledger, committer = make(world, tmp_path / side)

        def listener(block, flags):
            if block.header.number == 2:
                raise RuntimeError("listener failed")

        committer.add_commit_listener(listener)
        blocks = world.blocks if side == "port" else [
            common_pb2.Block.FromString(b) for b in world.blocks]
        got = []
        with pytest.raises(RuntimeError, match="listener failed"):
            for flags in committer.store_stream(blocks, depth=1):
                got.append(flags)
        heights[side] = (ledger.height, len(got))
        provider.close()
    # block 2 was durable when its listener raised; nothing after it
    assert heights["port"] == heights["jax"] == (3, 1)


def test_a_failed_group_rolls_back_to_the_durable_height(world, tmp_path):
    provider, ledger, committer = _port_side(world, tmp_path / "port")
    files_before = _files(tmp_path / "port")
    kv = provider.kv
    write_batch = kv.write_batch

    def failing(puts, deletes=()):
        raise OSError("disk full")

    kv.write_batch = failing
    with pytest.raises(OSError, match="disk full"):
        list(committer.store_stream(world.blocks, depth=3))
    assert ledger.height == ledger.durable_height == committer.height == 1
    assert ledger.get_block_by_number(1) is None
    assert _files(tmp_path / "port") == {
        name: data for name, data in files_before.items()}
    # the same blocks commit once the store works again
    kv.write_batch = write_batch
    assert list(committer.store_stream(world.blocks, depth=3)) == \
        world.expected_flags()
    assert ledger.height == N_BLOCKS + 1
    provider.close()


def test_the_sharded_store_and_a_missing_sqlite3_raise(tmp_path, monkeypatch):
    """The sharded store opens (a shard file on disk, or the knob above
    1); a knob that is not an integer and a missing sqlite3 raise."""
    root = tmp_path / "sharded"
    root.mkdir()
    (root / "state_00.sqlite").write_bytes(b"")
    provider = LedgerProvider(str(root))
    assert isinstance(provider.kv, kvstore.ShardedKVStore)
    assert provider.kv.shards == 2  # the knob's 1, raised to the minimum
    provider.close()
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "2")
    provider = LedgerProvider(str(tmp_path / "fresh"))
    assert isinstance(provider.kv, kvstore.ShardedKVStore)
    assert provider.kv.shards == 2
    provider.close()
    assert sorted(p.name for p in (tmp_path / "fresh").glob("*.sqlite")) == \
        ["index.sqlite", "state_00.sqlite", "state_01.sqlite"]
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "two")
    with pytest.raises(ValueError, match="not an integer shard count"):
        LedgerProvider(str(tmp_path / "fresh"))
    monkeypatch.setenv("FABRIC_TPU_STORE_SHARDS", "1")
    LedgerProvider(str(tmp_path / "single")).close()
    monkeypatch.setitem(sys.modules, "sqlite3", None)
    with pytest.raises(ImportError):
        LedgerProvider(str(tmp_path / "nosqlite"))
    assert not os.path.exists(tmp_path / "nosqlite" / "index.sqlite")
    with pytest.raises(KeyError):
        kvstore.knob("FABRIC_TPU_NOT_A_SETTING")


def test_txids_repeated_depth_blocks_later_are_caught_while_commits_land(
        world, tmp_path):
    """Every block repeats, last, a committed transaction of the block
    `depth` before it: that block's commit and the release of its txids
    land while the repeating block collects.  Under a short switch
    interval each repeat is DUPLICATE_TXID, whether its first copy is
    committed yet or still in flight."""
    w = world.world
    n_blocks, depth, prev = 24, 3, w.genesis_hash
    blocks, envs = [], []
    for b in range(n_blocks):
        envs.append([chip_smoke.endorsed_tx(w, 100 + b, i, 3)
                     for i in range(3)])
        data = list(envs[b]) + ([envs[b - depth][1]] if b >= depth else [])
        blk = port_pu.new_block(1 + b, prev)
        blk.data = cb.BlockData(data=data)
        blk.header.data_hash = port_pu.block_data_hash(blk.data)
        prev = port_pu.block_header_hash(blk.header)
        blocks.append(blk.encode())
    provider = LedgerProvider(str(tmp_path / "port"))
    ledger = provider.create(cb.Block.decode(w.genesis))
    committer = Committer(TxValidator(
        CH, ledger, world.port_bundle,
        CUDACSP(device="cpu", min_device_batch=1 << 30)), ledger)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        flags = list(committer.store_stream(blocks, depth=depth))
    finally:
        sys.setswitchinterval(interval)
    assert flags == [[0] * 3] * depth + [[0] * 3 + [9]] * (n_blocks - depth)
    assert ledger.height == n_blocks + 1
    provider.close()


def _txid(env: bytes) -> str:
    payload = cb.Payload.decode(cb.Envelope.decode(env).payload)
    return cb.ChannelHeader.decode(payload.header.channel_header).tx_id


class ReleasingLedger(chip_smoke.EmptyLedger):
    """A ledger whose commits land between a block's one batched txid
    probe and its window check: `tx_ids_exist` answers from the txids
    committed so far, then lands every commit handed to `stage` (their
    txids become known, and their release callables run), as a committer
    thread finishing during a collect would."""

    def __init__(self, txids_of: list):
        self.txids_of = txids_of
        self.committed: set = set()
        self.pending: list = []

    def stage(self, release) -> None:
        self.pending.append((self.txids_of[len(self.pending)], release))

    def tx_id_exists(self, txid: str) -> bool:
        return txid in self.committed

    def tx_ids_exist(self, txids) -> set:
        answer = {t for t in txids if t in self.committed}
        for txids, release in self.pending:
            if not txids <= self.committed:
                self.committed |= txids
                release()
        return answer


def test_txid_window_release_racing_the_probe_diverges_from_the_reference(
        world):
    """24 blocks at depth 3, each repeating a transaction of the block 3
    before it, with every release landing right after the repeating
    block's ledger probe.  The JAX package's window drops the txids at
    once (`seen_txids.difference_update` on the releasing thread), so the
    repeat meets neither the probe nor the window and is VALID (0): its
    txid would be committed twice.  The port queues the release until the
    next block's collect, so every repeat is DUPLICATE_TXID (9).  A
    recorded fault of the reference (ROADMAP, Queue C)."""
    w = world.world
    n_blocks, depth, prev = 24, 3, w.genesis_hash
    blocks, envs, txids_of = [], [], []
    for b in range(n_blocks):
        envs.append([chip_smoke.endorsed_tx(w, 200 + b, i, 3)
                     for i in range(3)])
        data = list(envs[b]) + ([envs[b - depth][1]] if b >= depth else [])
        blk = port_pu.new_block(1 + b, prev)
        blk.data = cb.BlockData(data=data)
        blk.header.data_hash = port_pu.block_data_hash(blk.data)
        prev = port_pu.block_header_hash(blk.header)
        blocks.append(blk.encode())
        txids_of.append({_txid(e) for e in data})
    jax_ledger = ReleasingLedger(txids_of)
    jax = JaxValidator(CH, jax_ledger, world.jax_bundle, SWCSP())
    jax_flags = [list(f) for f in jax.validate_pipeline(
        [common_pb2.Block.FromString(b) for b in blocks], depth=depth,
        release=jax_ledger.stage)]
    port_ledger = ReleasingLedger(txids_of)
    port = TxValidator(CH, port_ledger, world.port_bundle,
                       CUDACSP(device="cpu", min_device_batch=1 << 30))
    port_flags = [list(f) for f in port.validate_pipeline(
        [cb.Block.decode(b) for b in blocks], depth=depth,
        release=port_ledger.stage)]
    first = [[0] * 3] * depth
    assert jax_flags == first + [[0] * 4] * (n_blocks - depth)
    assert port_flags == first + [[0] * 3 + [9]] * (n_blocks - depth)
