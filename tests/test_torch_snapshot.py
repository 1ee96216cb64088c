"""The port's snapshots against the JAX package's.

One chain (chip_smoke's 5-org channel, 8 blocks of 10 transactions with
the validator's and MVCC's plants, a txid of block 2 repeated in block 8)
is committed by the JAX `Committer` (on `SWCSP`) and by the port's (on
`CUDACSP(device="cpu")`), each ledger also holding rich-query indexes,
documents, a private collection's hashed and cleartext namespaces and a
config-history entry.  Then:

- the two exports of the chain, on demand and requested ahead of a
  streamed commit, are byte-identical file for file, metadata and digests
  included;
- the JAX export imports into the port and the port's into JAX; both
  bootstrapped ledgers take the blocks after the snapshot with the
  original's flags (the repeated txid DUPLICATE_TXID), and their stores
  and block files are equal to each other, their state to the original's;
- a tampered file, a dropped digest, another format version and a
  half-finished import are refused with the JAX package's messages, and
  `discard_failed_import` clears what the JAX one clears.
"""

import json
import os
import shutil
from pathlib import Path

import pytest

import chip_smoke
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger import snapshot as jax_snap
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.ledger import blkstorage as port_blk
from fabric_tpu_torch.ledger import confighistory as port_ch
from fabric_tpu_torch.ledger import snapshot as port_snap
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger.kvledger import LedgerProvider
from fabric_tpu_torch.peer.committer import Committer
from fabric_tpu_torch.peer.txvalidator import TxValidator
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
N_BLOCKS = 8
N_TXS = 10
SNAP = chip_smoke.SNAP_BLOCK


@pytest.fixture(scope="module", autouse=True)
def _shut_the_port_pool():
    yield
    workpool.shutdown()


class Chain:
    def __init__(self):
        self.world = chip_smoke.validator_world(17)
        self.genesis = self.world.genesis
        self.blocks, self.expect, self.conflicts = chip_smoke.validator_blocks(
            self.world, N_BLOCKS, N_TXS, self.world.genesis_hash, mvcc=True)
        self.jax_bundle = bundle_from_genesis(
            common_pb2.Block.FromString(self.genesis), SWCSP())
        self.port_bundle = port_bundle_from_genesis(self.genesis)

    def flags(self):
        want = {**self.expect, **self.conflicts}
        return [[want.get((b, i), 0) for i in range(N_TXS)]
                for b in range(N_BLOCKS)]


@pytest.fixture(scope="module")
def chain():
    return Chain()


def _port_csp():
    return CUDACSP(device="cpu", min_device_batch=1 << 30)


def _extras(ledger, mod) -> None:
    """Indexes, documents, a collection's hashed and cleartext namespaces
    and a config-history entry, as the snapshot must carry them (the
    cleartext excepted)."""
    ledger.define_index("docs", "color")
    ledger.define_index("docs", ["color", "size"])
    vv = mod.VersionedValue
    h = mod.Height(1, 0)
    hns, pns = jax_tx.hash_ns("benchcc", "c"), jax_tx.pvt_ns("benchcc", "c")
    ledger.state_db.apply_updates({
        "docs": {f"d{i}": vv(json.dumps({"color": c, "size": i}).encode(), h)
                 for i, c in enumerate(["red", "blue", "red"])},
        hns: {jax_tx.key_hash("p").hex(): vv(jax_tx.value_hash(b"s"), h,
                                             jax_tx.encode_metadata({"a": b""}))},
        pns: {"p": vv(b"s", h), "q\x00pvt\x00z": vv(b"look-alike", h)},
    }, None)
    ledger.config_history.handle_commit(1, {"benchcc": b"collections"})


def _sides(chain, root, extras=True):
    jp = JaxProvider(str(root / "jax"), csp=SWCSP())
    jl = jp.create(common_pb2.Block.FromString(chain.genesis))
    pp = LedgerProvider(str(root / "port"), csp=_port_csp())
    pl = pp.create(cb.Block.decode(chain.genesis))
    if extras:
        _extras(jl, jax_sdb)
        _extras(pl, port_sdb)
    jc = JaxCommitter(JaxValidator(CH, jl, chain.jax_bundle, SWCSP()), jl)
    pc = Committer(TxValidator(CH, pl, chain.port_bundle, _port_csp()), pl)
    return (jp, jl, jc), (pp, pl, pc)


def _jax_blocks(blocks):
    return [common_pb2.Block.FromString(b) for b in blocks]


def _dir(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def _snapshot_of_both(chain, root, requested: bool):
    (jp, jl, jc), (pp, pl, pc) = _sides(chain, root)
    if requested:
        assert jl.snapshots.submit_request(SNAP) == \
            pl.snapshots.submit_request(SNAP) == {
                "block_number": SNAP, "snapshot_dir": None}
    jflags = list(jc.store_stream(_jax_blocks(chain.blocks), depth=3))
    pflags = list(pc.store_stream(chain.blocks, depth=3))
    assert pflags == jflags == chain.flags()
    if requested:
        assert jl.snapshots.wait_idle() and pl.snapshots.wait_idle()
        jdir = jax_snap.completed_snapshot_dir(jp.snapshots_root, CH, SNAP)
        pdir = port_snap.completed_snapshot_dir(pp.snapshots_root, CH, SNAP)
    else:
        jdir = jl.snapshots.submit_request(0)["snapshot_dir"]
        pdir = pl.snapshots.submit_request(0)["snapshot_dir"]
    return (jp, jl, jdir), (pp, pl, pdir)


@pytest.mark.parametrize("requested", [False, True],
                         ids=["on_demand", "requested"])
def test_exports_equal_the_reference_file_for_file(chain, tmp_path,
                                                   requested):
    (jp, jl, jdir), (pp, pl, pdir) = _snapshot_of_both(chain, tmp_path,
                                                       requested)
    assert os.path.relpath(pdir, tmp_path / "port") == \
        os.path.relpath(jdir, tmp_path / "jax")
    files = _dir(pdir)
    assert files == _dir(jdir)
    assert sorted(files) == sorted(port_snap.DATA_FILES
                                   + (port_snap.METADATA_FILE,))
    meta = port_snap.load_metadata(pdir)
    assert meta == jax_snap.load_metadata(jdir)
    assert meta["last_block_number"] == (SNAP if requested else N_BLOCKS)
    assert meta["index_defs"] == {"docs": ["color", "color\x1fsize"]}
    assert port_snap.verify_snapshot(pdir, csp=_port_csp()) == meta
    # cleartext private data stays out; its look-alike public key rides
    public = dict(port_snap.read_records(
        os.path.join(pdir, port_snap.PUBLIC_STATE_FILE)))
    assert not any(b"\x00pvt\x00c\x00p" in k for k in public)
    assert any(b"look-alike" in v for v in public.values())
    assert port_snap.list_completed(pp.snapshots_root, CH) == \
        jax_snap.list_completed(jp.snapshots_root, CH)
    # the frames of a served snapshot, and their receipt
    frames = list(port_snap.stream_snapshot_dir(pdir))
    assert frames == list(jax_snap.stream_snapshot_dir(jdir))
    got = port_snap.receive_snapshot_stream(iter(frames), str(tmp_path / "r"))
    assert _dir(got) == files
    if requested:  # one more, on demand, at the last block
        assert _dir(pl.snapshots.generate()) == _dir(jl.snapshots.generate())
    with pytest.raises(port_snap.SnapshotExistsError):
        pl.snapshots.generate()
    with pytest.raises(jax_snap.SnapshotExistsError):
        jl.snapshots.generate()
    jp.close()
    pp.close()


def test_each_package_imports_the_others_export(chain, tmp_path):
    (jp, jl, jdir), (pp, pl, pdir) = _snapshot_of_both(
        chain, tmp_path / "src", requested=True)
    orig_state = list(pl.state_db.export_records())
    assert orig_state == list(jl.state_db.export_records())
    orig_txids = list(pl.block_store.export_txids())
    jp.close()
    pp.close()
    # the port from the JAX export, JAX from the port's
    port_boot = LedgerProvider(str(tmp_path / "port"), csp=_port_csp())
    pl = port_boot.create_from_snapshot(jdir)
    jax_boot = JaxProvider(str(tmp_path / "jax"), csp=SWCSP())
    jl = jax_boot.create_from_snapshot(pdir)
    for led in (pl, jl):
        assert led.height == SNAP + 1
        assert led.block_store.bootstrap_height == SNAP + 1
        assert led.get_block_by_number(SNAP) is None
    assert pl.durable_block_hash == jl.durable_block_hash == \
        pl.block_store.bootstrap_hash
    assert port_blk.read_bootstrap_height(port_boot.kv, CH) == SNAP + 1
    assert list(port_boot.kv.iterate()) == list(jax_boot.kv.iterate())
    assert pl.pvt_store.bootstrap_height == jl.pvt_store.bootstrap_height
    assert pl.config_history.retriever().most_recent_below("benchcc", 5) \
        == jl.config_history.retriever().most_recent_below("benchcc", 5)
    after = chain.blocks[SNAP:]
    pc = Committer(TxValidator(CH, pl, chain.port_bundle, _port_csp()), pl)
    jc = JaxCommitter(JaxValidator(CH, jl, chain.jax_bundle, SWCSP()), jl)
    pflags = list(pc.store_stream(after, depth=3))
    jflags = list(jc.store_stream(_jax_blocks(after), depth=3))
    assert pflags == jflags == chain.flags()[SNAP:]
    dup = pflags[chip_smoke.SNAP_DUP_BLOCK - SNAP - 1][chip_smoke.SNAP_DUP_TX]
    assert dup == 9  # DUPLICATE_TXID: a txid from before the snapshot
    assert list(port_boot.kv.iterate()) == list(jax_boot.kv.iterate())
    assert _dir(tmp_path / "port" / CH / "chains") == \
        _dir(tmp_path / "jax" / CH / "chains")
    assert list(pl.state_db.export_records()) == list(
        jl.state_db.export_records())
    assert set(pl.block_store.export_txids()) >= set(orig_txids)
    # the indexes came along: a rich query over them answers the same
    q = '{"selector": {"color": "red", "size": {"$gte": 0}}}'
    sims = [pl.new_tx_simulator(), jl.new_tx_simulator()]
    assert sims[0].get_query_result("docs", q) == \
        sims[1].get_query_result("docs", q) != []
    assert sims[0].get_tx_simulation_results() == \
        sims[1].get_tx_simulation_results()
    with pytest.raises(port_snap.SnapshotError, match="already exists"):
        port_boot.create_from_snapshot(jdir)
    port_boot.close()
    jax_boot.close()


def _refusals(snapshot_dir, pkg_snap, csp):
    try:
        pkg_snap.verify_snapshot(snapshot_dir, csp=csp)
    except pkg_snap.SnapshotError as e:
        return type(e).__name__, str(e)
    return None


def test_tampered_snapshots_are_refused_as_the_reference(chain, tmp_path):
    (jp, jl, jdir), (pp, pl, pdir) = _snapshot_of_both(
        chain, tmp_path / "src", requested=False)
    jp.close()
    pp.close()
    cases = []
    for name in port_snap.DATA_FILES:
        d = tmp_path / f"flip-{name}"
        shutil.copytree(pdir, d)
        raw = bytearray((d / name).read_bytes())
        if raw:
            raw[len(raw) // 2] ^= 1
        else:
            raw = bytearray(b"\x00")
        (d / name).write_bytes(bytes(raw))
        cases.append(d)
    d = tmp_path / "dropped"
    shutil.copytree(pdir, d)
    meta = json.loads((d / port_snap.METADATA_FILE).read_text())
    del meta["files"][port_snap.TXIDS_FILE]
    (d / port_snap.METADATA_FILE).write_text(json.dumps(meta))
    cases.append(d)
    d = tmp_path / "version"
    shutil.copytree(pdir, d)
    meta["version"] = 2
    (d / port_snap.METADATA_FILE).write_text(json.dumps(meta))
    cases.append(d)
    d = tmp_path / "missing"
    shutil.copytree(pdir, d)
    (d / port_snap.CONFIG_HISTORY_FILE).unlink()
    cases.append(d)
    cases.append(tmp_path / "nothing")
    for d in cases:
        got = _refusals(str(d), port_snap, _port_csp())
        assert got is not None and got == _refusals(str(d), jax_snap,
                                                    SWCSP()), d.name
    with pytest.raises(port_snap.SnapshotError, match="tampered"):
        LedgerProvider(str(tmp_path / "join")).create_from_snapshot(
            str(cases[0]))


def test_a_half_finished_import_is_refused_and_discarded_as_the_reference(
        chain, tmp_path, monkeypatch):
    (jp, jl, jdir), (pp, pl, pdir) = _snapshot_of_both(
        chain, tmp_path / "src", requested=False)
    jp.close()
    pp.close()

    def crash(self, entries):
        raise OSError("the importing process died")

    from fabric_tpu.ledger import confighistory as jax_ch

    monkeypatch.setattr(port_ch.ConfigHistoryMgr, "import_entries", crash)
    monkeypatch.setattr(jax_ch.ConfigHistoryMgr, "import_entries", crash)
    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    makers = {"port": lambda: LedgerProvider(str(roots["port"])),
              "jax": lambda: JaxProvider(str(roots["jax"]))}
    errors, deleted = {}, {}
    for side in ("port", "jax"):
        prov = makers[side]()
        with pytest.raises(OSError, match="died"):
            prov.create_from_snapshot(pdir if side == "port" else jdir)
        prov.close()
    monkeypatch.undo()
    for side, snap_mod in (("port", port_snap), ("jax", jax_snap)):
        prov = makers[side]()
        with pytest.raises(snap_mod.SnapshotError) as e:
            prov.open(CH)
        errors[side] = [str(e.value)]
        with pytest.raises(snap_mod.SnapshotError) as e:
            prov.create_from_snapshot(pdir)
        errors[side].append(str(e.value))
        deleted[side] = prov.discard_failed_import(CH)
        assert not (roots[side] / CH).exists()
        with pytest.raises(snap_mod.SnapshotError) as e:
            prov.discard_failed_import(CH)
        errors[side].append(str(e.value))
        led = prov.create_from_snapshot(pdir)
        assert led.height == N_BLOCKS + 1
        prov.close()
    assert errors["port"] == errors["jax"]
    assert deleted["port"] == deleted["jax"] > 0
    assert "half-finished" in errors["port"][0]


def test_snapshot_requests_are_kept_as_the_reference(chain, tmp_path):
    (jp, jl, jc), (pp, pl, pc) = _sides(chain, tmp_path, extras=False)
    jc.store_block(common_pb2.Block.FromString(chain.blocks[0]))
    pc.store_block(chain.blocks[0])
    for call in (lambda s: s.submit_request(5), lambda s: s.submit_request(7),
                 lambda s: s.cancel_request(7), lambda s: s.list_pending(),
                 lambda s: s.submit_request(5), lambda s: s.cancel_request(9),
                 lambda s: s.submit_request(1)):
        got = []
        for s, root in ((pl.snapshots, pp.snapshots_root),
                        (jl.snapshots, jp.snapshots_root)):
            try:
                res = call(s)
            except Exception as e:  # the two packages' refusals compared
                got.append((type(e).__name__, str(e)))
                continue
            if isinstance(res, dict) and res["snapshot_dir"]:
                res["snapshot_dir"] = os.path.relpath(res["snapshot_dir"],
                                                      root)
            got.append(("ok", res))
        assert got[0] == got[1]
    assert pl.snapshots.has_pending_request(5)
    jp.close()
    pp.close()
    # requests survive a restart
    again = LedgerProvider(str(tmp_path / "port"))
    assert again.open(CH).snapshots.list_pending() == [5]
    assert again.list() == [CH]
    again.close()
