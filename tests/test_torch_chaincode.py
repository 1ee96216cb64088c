"""The port's chaincode runtime against the JAX package's.

- The same chaincode (gets, puts, deletes, ranges paged through
  QUERY_STATE_NEXT and closed early with QUERY_STATE_CLOSE, a call to a
  second chaincode, an event, private writes, a failure) through each
  package's `InProcStream` over equal seeded states: equal responses,
  events, read-write sets and private read-write sets, byte for byte.
- Each package's shim (`shim_main`) talks to the other's
  `TCPChaincodeListener` with its launch credential; a forged one is
  refused by both.
- `_lifecycle`: install, approve, check readiness, commit and the queries
  give equal state writes and responses; each package's
  `DefinitionProvider` reads the other's committed definition to the
  same `validation_info` and collections.
- `privdata` and `statebased`: equal collection and policy bytes and
  verdicts; `qscc` and `cscc`: equal answers.
"""

import io
import json
import tarfile
import time
import types

import pytest

import chip_smoke
from fabric_tpu.chaincode import lifecycle as jax_lc
from fabric_tpu.chaincode import scc as jax_scc
from fabric_tpu.chaincode import shim as jax_shim
from fabric_tpu.chaincode import statebased as jax_sb
from fabric_tpu.chaincode import support as jax_support
from fabric_tpu.common import privdata as jax_pd
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu.ledger.blkstorage import BlockStore as JaxStore
from fabric_tpu.protos.common import common_pb2
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.chaincode import lifecycle as port_lc
from fabric_tpu_torch.chaincode import scc as port_scc
from fabric_tpu_torch.chaincode import shim as port_shim
from fabric_tpu_torch.chaincode import statebased as port_sb
from fabric_tpu_torch.chaincode import support as port_support
from fabric_tpu_torch.common import privdata as port_pd
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger import txmgmt as port_tx
from fabric_tpu_torch.ledger.blkstorage import BlockStore as PortStore
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import lifecycle as lc
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protos import rwset as rw

NS = "kvcc"
COLL = "coll"
N_KEYS = 230  # three pages of a range


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


PKG = {
    "jax": types.SimpleNamespace(
        shim=jax_shim, support=jax_support, lc=jax_lc, scc=jax_scc,
        kv=jax_kv, sdb=jax_sdb, tx=jax_tx, pd=jax_pd, sb=jax_sb,
        Store=JaxStore, block=common_pb2.Block.FromString),
    "port": types.SimpleNamespace(
        shim=port_shim, support=port_support, lc=port_lc, scc=port_scc,
        kv=port_kv, sdb=port_sdb, tx=port_tx, pd=port_pd, sb=port_sb,
        Store=PortStore, block=cb.Block.decode),
}


def _enc(m) -> bytes:
    return m.SerializeToString() if hasattr(m, "SerializeToString") \
        else m.encode()


def chaincode(pkg: str):
    """The test chaincode on the package's shim."""
    shim = PKG[pkg].shim
    M_close = pb.ChaincodeMessage.QUERY_STATE_CLOSE
    M_range = pb.ChaincodeMessage.GET_STATE_BY_RANGE

    class KV(shim.Chaincode):
        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            p = [x.decode() for x in params]
            if fn == "put":
                stub.put_state(p[0], params[1])
                return shim.success()
            if fn == "get":
                return shim.success(stub.get_state(p[0]))
            if fn == "del":
                stub.del_state(p[0])
                return shim.success(b"deleted")
            if fn == "range":
                rows = [f"{k}={v.decode()}"
                        for k, v in stub.get_state_by_range(p[0], p[1])]
                return shim.success(",".join(rows).encode(),
                                    message=str(len(rows)))
            if fn == "range_close":
                # the first page, then close the iterator early
                first = stub._call(M_range, pb.GetStateByRange(
                    start_key=p[0], end_key=p[1]).encode())
                qr = pb.QueryResponse.decode(first.payload)
                stub._call(M_close, pb.QueryStateClose(id=qr.id).encode())
                return shim.success(b"%d:%d" % (len(qr.results),
                                                qr.has_more))
            if fn == "call":
                return stub.invoke_chaincode(p[0], list(params[1:]))
            if fn == "event":
                stub.put_state("evented", b"1")
                stub.set_event("my-event", params[0])
                return shim.success()
            if fn == "pvt":
                stub.put_state(p[0], params[1], collection=COLL)
                got = stub.get_state(p[0], collection=COLL)
                return shim.success(got)
            if fn == "meta":
                stub.set_state_validation_parameter(p[0], params[1])
                return shim.success(stub.get_state_validation_parameter(
                    p[0]))
            if fn == "boom":
                raise RuntimeError("chaincode exploded")
            if fn == "fail":
                return shim.error("refused", status=500)
            return shim.error(f"unknown function {fn!r}")

    return KV()


def _seed(pkg: str):
    p = PKG[pkg]
    db = p.sdb.VersionedDB(p.kv.MemKVStore(), "statedb/ch")
    batch = {NS: {f"k{i:03d}": p.sdb.VersionedValue(
        b"v%d" % i, p.sdb.Height(1, i), b"") for i in range(N_KEYS)}}
    batch["callee"] = {"c0": p.sdb.VersionedValue(b"callee-value",
                                                  p.sdb.Height(1, 0), b"")}
    db.apply_updates(batch, p.sdb.Height(1, N_KEYS))
    return db


CALLS = [
    [b"get", b"k007"], [b"get", b"absent"], [b"put", b"new", b"nv"],
    [b"del", b"k001"], [b"range", b"k000", b"k999"],
    [b"range", b"k100", b"k105"], [b"range_close", b"k000", b"k999"],
    [b"call", b"callee", b"get", b"c0"], [b"event", b"payload"],
    [b"pvt", b"secret", b"s3cr3t"], [b"meta", b"k002", b"policy"],
    [b"fail"],
]


def _run_calls(pkg: str):
    p = PKG[pkg]
    support = p.support.ChaincodeSupport(invoke_timeout_s=10.0)
    streams = [p.support.InProcStream(support, chaincode(pkg), name)
               for name in (NS, "callee")]
    for s, name in zip(streams, (NS, "callee")):
        s.start()
        s.wait_registered(support, name)
    db = _seed(pkg)
    out = []
    try:
        for k, args in enumerate(CALLS):
            sim = p.tx.TxSimulator(db)
            resp, event = support.execute(NS, "ch", f"tx{k}", sim, args)
            pvt = sim.get_pvt_simulation_results()
            out.append((_enc(resp), event, sim.get_tx_simulation_results(),
                        pvt))
        sim = p.tx.TxSimulator(db)
        with pytest.raises(p.support.ChaincodeExecuteError,
                           match="exploded"):
            support.execute(NS, "ch", "txboom", sim, [b"boom"])
        with pytest.raises(p.support.ChaincodeExecuteError,
                           match="not registered"):
            support.execute("ghost", "ch", "txghost", sim, [b"get"])
    finally:
        for s in streams:
            s.stop()
    return out


def test_inproc_chaincode_gives_equal_rwsets_and_responses():
    got = {pkg: _run_calls(pkg) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    resps = [pb.Response.decode(r[0]) for r in got["port"]]
    assert all(r.status == 200 for r in resps[:-1])
    assert resps[-1].status == 500
    assert resps[4].message == str(N_KEYS)  # a simulator a call: all keys
    assert resps[6].payload == b"100:1"
    assert resps[7].payload == b"callee-value"
    assert got["port"][8][1] and got["port"][9][3]


def _package(label: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        meta = json.dumps({"label": label, "type": "python"}).encode()
        info = tarfile.TarInfo("metadata.json")
        info.size = len(meta)
        info.mtime = 0
        tf.addfile(info, io.BytesIO(meta))
    return buf.getvalue()


@pytest.mark.parametrize("shim_pkg,listener_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_shims_and_listeners_cross_the_packages(shim_pkg, listener_pkg):
    ps, pl = PKG[shim_pkg], PKG[listener_pkg]
    support = pl.support.ChaincodeSupport(invoke_timeout_s=10.0)
    listener = pl.support.TCPChaincodeListener(support)
    host, port = listener.addr
    token = support.issue_launch_token(NS)

    def serve(credential):
        try:
            ps.shim.shim_main(chaincode(shim_pkg), NS, f"{host}:{port}",
                              credential)
        except OSError:
            pass  # the listener reset the connection

    # a forged credential: the listener closes the connection
    rogue = port_lw.spawn_thread(target=serve, args=("forged",),
                                 name="rogue-shim", kind="worker")
    rogue.start()
    rogue.join(10)
    assert not rogue.is_alive() and not support.registered(NS)
    t = port_lw.spawn_thread(target=serve, args=(token,), name="shim",
                             kind="worker")
    t.start()
    try:
        deadline = time.monotonic() + 10
        while not support.registered(NS) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert support.registered(NS)
        db = _seed(listener_pkg)
        got = []
        for k, args in enumerate(CALLS[:7]):
            sim = pl.tx.TxSimulator(db)
            resp, event = support.execute(NS, "ch", f"tx{k}", sim, args)
            got.append((_enc(resp), event,
                        sim.get_tx_simulation_results()))
    finally:
        listener.close()
        t.join(10)
    assert not t.is_alive()
    want = [r[:3] for r in _run_calls(listener_pkg)[:7]]
    assert got == want


# -- _lifecycle ------------------------------------------------------------------------


def _proposal_for(mspid: str) -> bytes:
    from fabric_tpu_torch.protos import msp as mb

    sid = mb.SerializedIdentity(mspid=mspid, id_bytes=b"cert").encode()
    hdr = cb.Header(signature_header=cb.SignatureHeader(creator=sid).encode())
    prop = pb.Proposal(header=hdr.encode())
    return pb.SignedProposal(proposal_bytes=prop.encode()).encode()


class _Lifecycle:
    def __init__(self, pkg: str, root):
        self.p = p = PKG[pkg]
        self.support = p.support.ChaincodeSupport(invoke_timeout_s=10.0)
        scc = p.lc.LifecycleSCC(p.lc.PackageStore(str(root)),
                                org_lister=lambda: ["Org1MSP", "Org2MSP",
                                                    "Org3MSP"])
        self.stream = p.support.InProcStream(self.support, scc,
                                             p.lc.NAMESPACE)
        self.stream.start()
        self.stream.wait_registered(self.support, p.lc.NAMESPACE)
        self.store = p.kv.MemKVStore()
        self.db = p.sdb.VersionedDB(self.store, "statedb/ch")
        self.n = 0

    def call(self, fn: str, arg: bytes, mspid="Org1MSP"):
        """One call; its writes committed at the next height."""
        p = self.p
        self.n += 1
        sim = p.tx.TxSimulator(self.db)
        resp, event = self.support.execute(
            p.lc.NAMESPACE, "ch", f"tx{self.n}", sim, [fn.encode(), arg],
            signed_proposal_bytes=_proposal_for(mspid))
        results = sim.get_tx_simulation_results()
        batch = {}
        for ns in rw.TxReadWriteSet.decode(results).ns_rwset:
            for w in rw.KVRWSet.decode(ns.rwset).writes:
                batch.setdefault(ns.namespace, {})[w.key] = (
                    None if w.is_delete else p.sdb.VersionedValue(
                        w.value, p.sdb.Height(self.n, 0), b""))
        if batch:
            self.db.apply_updates(batch, p.sdb.Height(self.n, 0))
        return resp, event, results


def _definition(seq=1, param=b"policy", collections=b""):
    return lc.ChaincodeDefinition(sequence=seq, name="mycc", version="1.0",
                                  validation_parameter=param,
                                  collections=collections).encode()


def _lifecycle_script():
    coll = port_pd.collection_package(port_pd.static_collection(
        COLL, ["Org1MSP", "Org2MSP"], block_to_live=5)).encode()
    d = _definition(collections=coll)
    approve = lc.ApproveChaincodeDefinitionForMyOrgArgs(
        definition=lc.ChaincodeDefinition.decode(d)).encode()
    check = lc.CheckCommitReadinessArgs(
        definition=lc.ChaincodeDefinition.decode(d)).encode()
    commit = lc.CommitChaincodeDefinitionArgs(
        definition=lc.ChaincodeDefinition.decode(d)).encode()
    other = lc.ApproveChaincodeDefinitionForMyOrgArgs(
        definition=lc.ChaincodeDefinition.decode(_definition(
            param=b"other", collections=coll))).encode()
    return [
        ("InstallChaincode", lc.InstallChaincodeArgs(
            chaincode_install_package=_package("mycc_1.0")).encode(),
         "Org1MSP"),
        ("QueryInstalledChaincodes", b"", "Org1MSP"),
        ("ApproveChaincodeDefinitionForMyOrg", approve, "Org1MSP"),
        ("CheckCommitReadiness", check, "Org1MSP"),
        ("CommitChaincodeDefinition", commit, "Org1MSP"),
        ("ApproveChaincodeDefinitionForMyOrg", other, "Org3MSP"),
        ("ApproveChaincodeDefinitionForMyOrg", approve, "Org2MSP"),
        ("CheckCommitReadiness", check, "Org1MSP"),
        ("CommitChaincodeDefinition", commit, "Org2MSP"),
        ("QueryChaincodeDefinition", lc.QueryChaincodeDefinitionArgs(
            name="mycc").encode(), "Org1MSP"),
        ("QueryChaincodeDefinitions", b"", "Org1MSP"),
        ("ApproveChaincodeDefinitionForMyOrg",
         lc.ApproveChaincodeDefinitionForMyOrgArgs(
             definition=lc.ChaincodeDefinition.decode(
                 _definition(seq=3))).encode(), "Org1MSP"),
        ("NoSuchFunction", b"", "Org1MSP"),
    ]


def _decoded(fn: str, payload: bytes):
    """A response payload with its maps decoded (upb writes a map's
    entries in its own order)."""
    cls = {"CheckCommitReadiness": lc.CheckCommitReadinessResult,
           "QueryChaincodeDefinition": lc.QueryChaincodeDefinitionResult
           }.get(fn)
    if cls is None:
        return payload
    m = cls.decode(payload)
    return (m.encode(deterministic=True), sorted(m.approvals.items()))


def test_lifecycle_gives_equal_state_writes_and_answers(tmp_path):
    out, lcs = {}, {}
    script = _lifecycle_script()
    for pkg in ("jax", "port"):
        life = lcs[pkg] = _Lifecycle(pkg, tmp_path / pkg)
        rows = []
        for fn, arg, mspid in script:
            resp, event, results = life.call(fn, arg, mspid)
            r = pb.Response.decode(_enc(resp))
            rows.append((r.status, r.message, _decoded(fn, r.payload),
                         event, results))
        out[pkg] = rows
        life.stream.stop()
    assert out["port"] == out["jax"]
    statuses = [r[0] for r in out["port"]]
    assert statuses == [200, 200, 200, 200, 500, 200, 200, 200, 200, 200,
                        200, 500, 500]
    ready = lc.CheckCommitReadinessResult.decode(out["port"][7][2][0])
    assert dict(ready.approvals) == {"Org1MSP": True, "Org2MSP": True,
                                     "Org3MSP": False}
    # each package's DefinitionProvider over the other's state
    for writer, reader in (("jax", "port"), ("port", "jax")):
        pr = PKG[reader]
        store = pr.kv.MemKVStore()
        store.write_batch(dict(lcs[writer].store.iterate()))
        db = pr.sdb.VersionedDB(store, "statedb/ch")
        ledger = types.SimpleNamespace(
            new_query_executor=lambda db=db, pr=pr: pr.tx.TxSimulator(db))
        dp = pr.lc.DefinitionProvider(ledger)
        assert dp.validation_info("mycc") == ("vscc", b"policy")
        assert dp.definition("ghost") is None
        sc = dp.collection_config("mycc", COLL)
        assert _enc(sc) == port_pd.static_collection(
            COLL, ["Org1MSP", "Org2MSP"], block_to_live=5
        ).static_collection_config.encode()
        assert dp.collection_config("mycc", "nope") is None


# -- privdata and statebased --------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    w = chip_smoke.validator_world(41)
    return types.SimpleNamespace(
        w=w, jax=jax_bundle(common_pb2.Block.FromString(w.genesis), SWCSP()),
        port=port_bundle(cb.Block.decode(w.genesis)))


def test_collections_and_policies_are_equal(world):
    orgs = ["Org1MSP", "Org3MSP"]
    for kw in ({}, {"required_peer_count": 1, "maximum_peer_count": 3,
                    "block_to_live": 9, "member_only_read": False}):
        confs = {}
        for pkg in ("jax", "port"):
            pd = PKG[pkg].pd
            ep = None
            if pkg == "jax":
                from fabric_tpu.policies.signature_policy import (
                    signed_by_any_member,
                )
                ep = signed_by_any_member(["Org2MSP"])
            else:
                from fabric_tpu_torch.policies.signature_policy import (
                    signed_by_any_member,
                )
                ep = signed_by_any_member(["Org2MSP"])
            confs[pkg] = _enc(pd.collection_package(
                pd.static_collection(COLL, orgs, **kw),
                pd.static_collection("c2", ["Org2MSP"],
                                     endorsement_policy=ep)))
        assert confs["port"] == confs["jax"]
    verdicts = {}
    for pkg in ("jax", "port"):
        pd = PKG[pkg].pd
        mm = getattr(world, pkg).msp_manager
        store = pd.CollectionStore(mm)
        store.set_collections("mycc", confs[pkg])
        coll = store.collection("mycc", COLL)
        ids = [world.w.client.serialize()] + [p.serialize()
                                              for p in world.w.peers]
        verdicts[pkg] = (
            coll.member_orgs(), coll.block_to_live, coll.required_peer_count,
            coll.maximum_peer_count, coll.member_only_read,
            coll.member_only_write, [coll.is_member(i) for i in ids],
            coll.is_member(b"garbage"),
            [c.name for c in store.collections_of("mycc")],
            store.btl_policy()("mycc", COLL), store.btl_policy()("x", "y"),
            store.is_eligible("mycc", "c2", ids[2]),
            store.is_eligible("mycc", "none", ids[2]))
        with pytest.raises(pd.NoSuchCollectionError):
            store.collection("mycc", "none")
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][6] == [True, True, False, True, False, False]


def test_key_endorsement_policies_are_equal():
    out = {}
    for pkg in ("jax", "port"):
        sb = PKG[pkg].sb
        pol = sb.KeyEndorsementPolicy()
        empty = pol.policy()
        pol.add_orgs(sb.ROLE_PEER, "Org3MSP", "Org1MSP")
        pol.add_orgs(sb.ROLE_MEMBER, "Org2MSP")
        two = pol.policy()
        pol.del_orgs("Org3MSP", "nobody")
        again = sb.KeyEndorsementPolicy(pol.policy())
        out[pkg] = (empty, two, pol.policy(), again.list_orgs(),
                    again.policy())
    assert out["port"] == out["jax"]


# -- qscc and cscc ------------------------------------------------------------------------


def test_qscc_and_cscc_answer_alike(world):
    blocks, _, _ = chip_smoke.validator_blocks(world.w, 2, 7, world.w
                                               .genesis_hash, plant=False)
    txid = cb.ChannelHeader.decode(cb.Payload.decode(cb.Envelope.decode(
        cb.Block.decode(blocks[1]).data.data[3]).payload).header
        .channel_header).tx_id
    hash1 = pu.block_header_hash(cb.Block.decode(blocks[0]).header)
    queries = [
        ("GetChainInfo", []), ("GetBlockByNumber", [b"1"]),
        ("GetBlockByNumber", [b"9"]), ("GetBlockByNumber", [b"x"]),
        ("GetBlockByHash", [hash1]), ("GetBlockByHash", [b"\x00" * 32]),
        ("GetTransactionByID", [txid.encode()]),
        ("GetTransactionByID", [b"nope"]), ("GetBlockByTxID",
                                            [txid.encode()]),
        ("Nope", []),
    ]
    out = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        store = p.Store(None, name="peer")
        for raw in [world.w.genesis] + blocks:
            store.add_block(p.block(raw))
        ledger = types.SimpleNamespace(block_store=store)
        support = p.support.ChaincodeSupport(invoke_timeout_s=10.0)
        streams = [
            p.support.InProcStream(support, p.scc.QSCC(
                lambda ch: ledger if ch == "ch" else None), "qscc"),
            p.support.InProcStream(support, p.scc.CSCC(
                lambda: ["ch", "other"],
                lambda ch: store.get_block_by_number(0) if ch == "ch"
                else None, joiner=None), "cscc")]
        for s, name in zip(streams, ("qscc", "cscc")):
            s.start()
            s.wait_registered(support, name)
        rows = []
        try:
            sim = None
            for k, (fn, args) in enumerate(
                    [(f, [b"ch"] + a) for f, a in queries]
                    + [("GetChainInfo", [b"ghost"]), ("GetChainInfo", [])]):
                resp, _ = support.execute("qscc", "ch", f"q{k}", sim,
                                          [fn.encode()] + args)
                rows.append(_enc(resp))
            for k, args in enumerate([[b"GetChannels"],
                                      [b"GetConfigBlock", b"ch"],
                                      [b"GetConfigBlock", b"x"],
                                      [b"JoinChain", b""], [b"Nope"]]):
                resp, _ = support.execute("cscc", "ch", f"c{k}", sim, args)
                rows.append(_enc(resp))
        finally:
            for s in streams:
                s.stop()
        out[pkg] = rows
    assert out["port"] == out["jax"]
    info = cb.BlockchainInfo.decode(pb.Response.decode(out["port"][0])
                                    .payload)
    assert info.height == 3
