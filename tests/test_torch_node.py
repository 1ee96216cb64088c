"""The port's node daemons (`node.orderer_node`, `node.peer_node`) against
the JAX package's, in process, over loopback RPC.

The material comes from the port's cryptogen and configtxgen (an orderer
org and Org1; a solo channel cutting blocks of 4).  Each package runs an
`OrdererNode` and a `PeerNode` (the port's on `CUDACSP(device="cpu")`,
the JAX package's on `SWCSP`), joined to the same genesis block and sent
the same signed proposals: the endorsers' answers (status, message,
payload and the signed proposal-response payload), the broadcast
statuses, the flags, heights, state and RPC answers are equal (data, not
signatures).  A port peer delivering from the JAX orderer node commits
the same.  The three reference faults the nodes carry are pinned in both
packages (ROADMAP Queue C): a restarted orderer node resumes with the
genesis config; a `_lifecycle` approval through a peer node cannot name
its org; an etcdraft orderer node behind the compaction point stays
behind.
"""

import json
import os
import threading
import time
import types

import pytest

import chip_smoke
from fabric_tpu.chaincode import shim as jax_shim
from fabric_tpu.cmd.common import load_signer as jax_load_signer
from fabric_tpu.common.configtx import compute_update as jax_compute
from fabric_tpu.csp import SWCSP
from fabric_tpu.node.orderer_node import OrdererNode as JaxOrderer
from fabric_tpu.node.peer_node import PeerNode as JaxPeer
from fabric_tpu.orderer.multichannel import ChannelStepRouter as JaxRouter
from fabric_tpu.orderer.raft import InProcTransport as JaxInProc
from fabric_tpu.protos.common import configtx_pb2
from fabric_tpu.protos.orderer import configuration_pb2 as jax_ocp
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.chaincode import shim as port_shim
from fabric_tpu_torch.cmd import configtxgen, cryptogen
from fabric_tpu_torch.cmd.common import load_signer as port_load_signer
from fabric_tpu_torch.comm import RPCClient
from fabric_tpu_torch.comm.rpc import RPCError
from fabric_tpu_torch.common import configtx_builder as ctx
from fabric_tpu_torch.common import deliver, workpool
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.msp.config import load_msp_dir
from fabric_tpu_torch.node.orderer_node import OrdererNode as PortOrderer
from fabric_tpu_torch.node.peer_node import PeerNode as PortPeer
from fabric_tpu_torch.orderer.multichannel import (
    ChannelStepRouter as PortRouter,
)
from fabric_tpu_torch.orderer.raft import InProcTransport as PortInProc
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import lifecycle as lc
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb

CH = "nodech"
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


def _kv(shim):
    class KV(shim.Chaincode):
        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            if fn == "rw":
                got = stub.get_state(params[0].decode())
                stub.put_state(params[1].decode(), params[2])
                return shim.success(got or b"")
            if fn == "range":
                return shim.success(json.dumps(
                    {k: v.decode()
                     for k, v in stub.get_state_by_range("", "")},
                    sort_keys=True).encode())
            if fn == "fail":
                return shim.error("refused by the chaincode", status=500)
            return shim.error(f"unknown function {fn!r}")
    return KV


PKG = {
    "jax": types.SimpleNamespace(
        Orderer=JaxOrderer, Peer=JaxPeer, csp=SWCSP, KV=_kv(jax_shim),
        load_signer=jax_load_signer, Router=JaxRouter, InProc=JaxInProc),
    "port": types.SimpleNamespace(
        Orderer=PortOrderer, Peer=PortPeer,
        csp=lambda: CUDACSP(device="cpu"), KV=_kv(port_shim),
        load_signer=port_load_signer, Router=PortRouter, InProc=PortInProc),
}


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """The material of an orderer org and Org1 from the port's cryptogen,
    a solo genesis block from its configtxgen, and each identity loaded
    by both packages."""
    root = str(tmp_path_factory.mktemp("nodenet"))
    with open(os.path.join(root, "crypto-config.yaml"), "w") as f:
        f.write(chip_smoke.nodes_crypto_config(1))
    with open(os.path.join(root, "configtx.yaml"), "w") as f:
        f.write("Organizations:\n"
                "  - Name: OrdererOrg\n    ID: OrdererMSP\n    MSPDir: "
                "crypto-config/ordererOrganizations/example.com/msp\n"
                "  - Name: Org1\n    ID: Org1MSP\n    MSPDir: "
                "crypto-config/peerOrganizations/org1.example.com/msp\n"
                "Profiles:\n  Solo:\n    Orderer:\n      OrdererType: solo\n"
                "      BatchTimeout: 60s\n"
                f"      BatchSize: {{MaxMessageCount: {BATCH}}}\n"
                "      Organizations: [OrdererOrg]\n"
                "    Application:\n      Organizations: [Org1]\n")
    cc = os.path.join(root, "crypto-config")
    assert cryptogen.main(["generate", "--config",
                           os.path.join(root, "crypto-config.yaml"),
                           "--output", cc]) == 0
    block = os.path.join(root, "ch.block")
    assert configtxgen.main(["-profile", "Solo", "-channelID", CH,
                             "-outputBlock", block, "-configPath", root]) == 0
    with open(block, "rb") as f:
        genesis = f.read()
    ordo = os.path.join(cc, "ordererOrganizations", "example.com")
    org1 = os.path.join(cc, "peerOrganizations", "org1.example.com")

    def ident(msp_dir, mspid):
        return types.SimpleNamespace(**{
            name: p.load_signer(msp_dir, mspid) for name, p in PKG.items()})

    return types.SimpleNamespace(
        root=root, genesis=genesis, cc=cc, ordo=ordo, org1=org1,
        orderer=ident(os.path.join(ordo, "orderers", "orderer.example.com",
                                   "msp"), "OrdererMSP"),
        oadmin=ident(os.path.join(ordo, "users", "Admin@example.com", "msp"),
                     "OrdererMSP"),
        peer=ident(os.path.join(org1, "peers", "peer0.org1.example.com",
                                "msp"), "Org1MSP"),
        admin=ident(os.path.join(org1, "users", "Admin@org1.example.com",
                                 "msp"), "Org1MSP"),
        client=port_load_signer(os.path.join(
            org1, "users", "User1@org1.example.com", "msp"), "Org1MSP"))


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _block(pkg, raw):
    if pkg == "jax":
        from fabric_tpu.protos.common import common_pb2

        return common_pb2.Block.FromString(raw)
    return cb.Block.decode(raw)


def _orderer(pkg, net, root, **kw):
    p = PKG[pkg]
    node = p.Orderer(str(root), p.csp(), signer=getattr(net.orderer, pkg),
                     genesis_blocks=[_block(pkg, net.genesis)], **kw)
    node.start()
    return node


def _peer(pkg, net, root, orderer_addr, **kw):
    p = PKG[pkg]
    node = p.Peer(str(root), p.csp(), getattr(net.peer, pkg),
                  orderer_endpoints=[orderer_addr],
                  chaincodes={"kv": p.KV()}, **kw)
    node.start()
    return node


def _call(node, method, body=b""):
    return RPCClient(*node.addr, timeout=30).call(method, body)


def _proposal(signer, cc, args, nonce, channel=CH, tamper=False):
    prop, txid = pu.create_chaincode_proposal(signer.serialize(), channel,
                                              cc, args, nonce=nonce,
                                              timestamp=1_760_000_000)
    raw = prop.encode()
    sig = signer.sign(b"tampered" if tamper else raw)
    return prop, txid, pb.SignedProposal(proposal_bytes=raw,
                                         signature=sig).encode()


# proposal k: its args (a read and a write; index 5 reads index 4's
# write, in the same block), a tampered signature at 1, a refusal at 3
PROPOSALS = [
    ([b"rw", b"r-%d" % k, b"w-%d" % k, b"v%d" % k] if k != 5
     else [b"rw", b"w-4", b"w-5", b"v5"]) if k != 3 else [b"fail"]
    for k in range(10)
]


def _endorse(node, sp):
    """(status, message, payload, signed proposal-response payload), or
    the RPC error."""
    try:
        resp = pb.ProposalResponse.decode(
            _call(node, "endorser.ProcessProposal", sp))
    except RPCError as exc:
        return ("refused", str(exc)[:40]), None
    return (resp.response.status, resp.response.message,
            bytes(resp.response.payload), bytes(resp.payload)), resp


def _flags(node, client, height, start=1):
    env = deliver.make_seek_info_envelope(CH, start, height - 1,
                                          signer=client)
    out = []
    for frame in RPCClient(*node.addr, timeout=30).stream(
            "deliver.Deliver", env.encode()):
        resp = ob.DeliverResponse.decode(frame)
        if resp.which("Type") == "block":
            blk = resp.block
            txids = [cb.ChannelHeader.decode(cb.Payload.decode(
                cb.Envelope.decode(d).payload).header.channel_header).tx_id
                for d in blk.data.data]
            out.append((blk.header.number, txids, list(pu.tx_filter(blk))))
    return out


def _filtered(node, client, height):
    env = deliver.make_seek_info_envelope(CH, 1, height - 1, signer=client)
    out = []
    for frame in RPCClient(*node.addr, timeout=30).stream(
            "deliver.DeliverFiltered", env.encode()):
        resp = pb.DeliverResponse.decode(frame)
        if resp.which("Type") == "filtered_block":
            fb = resp.filtered_block
            out.append([(t.txid, t.tx_validation_code)
                        for t in fb.filtered_transactions])
    return out


def _discover(node, client):
    """The peer's discovery answers over `discovery.Process`: its peers
    (identity, height, chaincodes) and `kv`'s endorsement layouts."""
    from fabric_tpu_torch.discovery import DiscoveryClient
    from fabric_tpu_torch.protos import discovery as dpb

    dc = DiscoveryClient(client, lambda req: dpb.Response.decode(
        _call(node, "discovery.Process", req.encode())))
    desc = dc.endorsers(CH, "kv")
    return ([(p.identity, p.ledger_height, list(p.chaincodes))
             for p in dc.peers(CH)], desc.chaincode,
            [dict(lay.quantities_by_group) for lay in desc.layouts],
            {g: [p.identity for p in peers.peers]
             for g, peers in desc.endorsers_by_groups.items()})


def _query(node, client, nonce, args, cc="kv", channel=CH):
    _, _, sp = _proposal(client, cc, args, nonce, channel=channel)
    return _endorse(node, sp)[0]


def test_nodes_endorse_order_and_commit_as_the_reference(net, tmp_path):
    got = {}
    nodes = []
    try:
        for pkg in ("jax", "port"):
            o = _orderer(pkg, net, tmp_path / f"{pkg}-orderer")
            p = _peer(pkg, net, tmp_path / f"{pkg}-peer", o.addr)
            nodes += [p, o]
            assert _call(p, "admin.JoinChannel", net.genesis) == CH.encode()
            assert _call(p, "admin.JoinChannel", net.genesis) == CH.encode()
            answers, envs = [], []
            for k, args in enumerate(PROPOSALS):
                prop, _, sp = _proposal(net.client, "kv", args,
                                        b"n%023d" % k, tamper=k == 1)
                ans, resp = _endorse(p, sp)
                answers.append(ans)
                if ans[0] == 200:
                    envs.append(pu.create_signed_tx(prop, net.client,
                                                    [resp]).encode())
            statuses = [ob.BroadcastResponse.decode(
                _call(o, "ab.Broadcast", raw)).status for raw in envs]
            assert _wait(lambda: int(_call(p, "admin.Height",
                                           CH.encode())) == 3)
            got[pkg] = {
                "answers": answers, "statuses": statuses,
                "flags": _flags(p, net.client, 3),
                "filtered": _filtered(p, net.client, 3),
                "height": _call(p, "admin.Height", CH.encode()),
                "channels": pb.ChannelQueryResponse.decode(
                    _call(p, "admin.Channels")).encode(),
                "orderer_channels": pb.ChannelQueryResponse.decode(
                    _call(o, "participation.List")).encode(),
                "state": _query(p, net.client, b"q" * 24, [b"range"]),
                "info": _query(p, net.client, b"i" * 24,
                               [b"GetChainInfo", CH.encode()], cc="qscc"),
                "installed": _query(p, net.admin.port, b"l" * 24,
                                    [b"getinstalledchaincodes"], cc="lscc",
                                    channel=""),
                "needs_channel": _query(p, net.admin.port, b"m" * 24,
                                        [b"getchaincodes"], cc="lscc",
                                        channel=""),
                "discovery": _discover(p, net.client),
            }
        # a port peer on the JAX orderer node commits the same blocks
        jax_orderer = nodes[1]
        follower = _peer("port", net, tmp_path / "port-follower",
                         jax_orderer.addr)
        nodes.append(follower)
        _call(follower, "admin.JoinChannel", net.genesis)
        assert _wait(lambda: int(_call(follower, "admin.Height",
                                       CH.encode())) == 3)
        followed = (_flags(follower, net.client, 3),
                    _query(follower, net.client, b"q" * 24, [b"range"]))
    finally:
        # the orderers first: their deliver streams end, so the peers'
        # deliver clients stop at once
        for n in sorted(nodes, key=lambda n: not hasattr(n, "registrar")):
            n.stop()
    jax, port = got["jax"], got["port"]
    for key in jax:
        if key == "info":
            # GetChainInfo carries the block hashes: the orderers' own
            # signatures make them differ; the heights are equal
            assert cb.BlockchainInfo.decode(port[key][2]).height == \
                cb.BlockchainInfo.decode(jax[key][2]).height == 3
            continue
        assert port[key] == jax[key], key
    assert [a[0] for a in port["answers"]].count(200) == 8
    assert port["answers"][1][0] == "refused"
    assert port["answers"][3][0] == 500
    assert port["statuses"] == [cb.SUCCESS] * 8
    flags = [f for _, _, block in port["flags"] for f in block]
    assert flags.count(pb.MVCC_READ_CONFLICT) == 1
    assert flags.count(pb.VALID) == 7
    assert len(json.loads(port["state"][2])) == 7
    assert followed == (jax["flags"], jax["state"])
    peers, cc, layouts, groups = port["discovery"]
    assert cc == "kv" and len(peers) == 1 and peers[0][1] == 3
    assert layouts == [{"G0": 1}] and list(groups) == ["G0"]


def test_a_lifecycle_approval_through_a_peer_node_cannot_name_its_org(
        net, tmp_path):
    """The reference fault: the node's chaincode adapter hands the runtime
    no signed proposal (JAX node/peer_node.py:449-455), so `_lifecycle`
    cannot read the approving org from the creator."""
    args = lc.ApproveChaincodeDefinitionForMyOrgArgs(
        definition=lc.ChaincodeDefinition(sequence=1, name="kv",
                                          version="1.0")).encode()
    got = {}
    for pkg in ("jax", "port"):
        o = _orderer(pkg, net, tmp_path / f"{pkg}-o")
        p = _peer(pkg, net, tmp_path / f"{pkg}-p", o.addr)
        try:
            _call(p, "admin.JoinChannel", net.genesis)
            got[pkg] = _query(p, net.admin.port, b"a" * 24, [
                b"ApproveChaincodeDefinitionForMyOrg", args],
                cc="_lifecycle")
        finally:
            o.stop()
            p.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 500
    assert "cannot determine approving org" in got["port"][1]


def _config_update(net, cfg_raw: bytes) -> bytes:
    """A CONFIG_UPDATE changing the BatchTimeout, signed by the orderer
    org's admin (the envelope is built once, fed to both packages)."""
    cur = configtx_pb2.Config.FromString(cfg_raw)
    new = configtx_pb2.Config()
    new.CopyFrom(cur)
    og = new.channel_group.groups["Orderer"]
    og.values["BatchTimeout"].value = jax_ocp.BatchTimeout(
        timeout="59s").SerializeToString()
    upd = jax_compute(CH, cur, new).SerializeToString()
    admin = net.oadmin.port
    shdr = pu.make_signature_header(admin.serialize(), b"u" * 24).encode()
    ue = cb.ConfigUpdateEnvelope(config_update=upd, signatures=[
        cb.ConfigSignature(signature_header=shdr,
                           signature=admin.sign(shdr + upd))])
    payload = pu.make_payload_bytes(
        pu.make_channel_header(cb.CONFIG_UPDATE, CH, timestamp=9),
        pu.make_signature_header(admin.serialize(), b"v" * 24), ue.encode())
    return pu.make_envelope(payload, admin).encode()


def _last_config(blk) -> int:
    meta = cb.Metadata.decode(blk.metadata.metadata[cb.SIGNATURES])
    return cb.OrdererBlockMetadata.decode(meta.value).last_config.index


def _envelope(signer, k: int) -> bytes:
    chdr = pu.make_channel_header(cb.ENDORSER_TRANSACTION, CH, timestamp=7,
                                  tx_id=f"tx-{k}")
    shdr = pu.make_signature_header(signer.serialize(), b"e%023d" % k)
    return pu.make_envelope(pu.make_payload_bytes(chdr, shdr, b"x%d" % k),
                            signer).encode()


def test_a_restarted_orderer_node_resumes_with_the_genesis_config(net,
                                                                  tmp_path):
    """The reference fault: an orderer node restarted on its root after a
    config block resumes with the genesis block's bundle (sequence 0) and
    writes last-config index 0 into the next block (JAX
    node/orderer_node.py:88-89 -> Registrar.startup)."""
    genesis_cfg = cb.ConfigEnvelope.decode(cb.Payload.decode(
        cb.Envelope.decode(cb.Block.decode(net.genesis).data.data[0])
        .payload).data).config.encode(deterministic=True)
    upd = _config_update(net, genesis_cfg)
    envs = [_envelope(net.client, k) for k in range(BATCH)]
    got = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        o = _orderer(pkg, net, root)
        try:
            status = ob.BroadcastResponse.decode(
                _call(o, "ab.Broadcast", upd)).status
            store = o.registrar.get_chain(CH).store
            assert _wait(lambda: store.height == 2)
            assert _wait(lambda: o.registrar.get_chain(CH).bundle.config
                         .sequence == 1)
        finally:
            o.stop()
        again = _orderer(pkg, net, root)
        try:
            cs = again.registrar.get_chain(CH)
            seq = cs.bundle.config.sequence
            st = [ob.BroadcastResponse.decode(
                _call(again, "ab.Broadcast", raw)).status for raw in envs]
            assert _wait(lambda: cs.store.height == 3)
            blocks = [cb.Block.decode(raw) for raw in (
                (b.SerializeToString() if pkg == "jax" else b.encode())
                for b in (cs.store.get_block_by_number(n) for n in (1, 2)))]
            got[pkg] = (status, seq, st, [_last_config(b) for b in blocks],
                        [list(b.data.data) for b in blocks[1:]])
        finally:
            again.stop()
    assert got["port"] == got["jax"]
    status, seq, st, last, data = got["port"]
    assert status == cb.SUCCESS and st == [cb.SUCCESS] * BATCH
    assert seq == 0  # the genesis bundle
    assert last == [1, 0]  # the resumed writer: last config 0
    assert data == [envs]


def _raft_genesis(net) -> bytes:
    """An etcdraft channel of three consenters (the chain-level pin's
    inputs: a snapshot after every block, a tick of 10 ms, blocks of 2)."""
    meta = ob.ConfigMetadata(
        consenters=[ob.Consenter(id=i, host="127.0.0.1", port=7050 + i)
                    for i in (1, 2, 3)],
        options=ob.Options(tick_interval_ms=10, election_tick=10,
                           heartbeat_tick=1, max_inflight_blocks=5,
                           snapshot_interval_size=1))
    org1 = ctx.org_group("Org1MSP", load_msp_dir(
        os.path.join(net.org1, "msp"), "Org1MSP"))
    oorg = ctx.org_group("OrdererMSP", load_msp_dir(
        os.path.join(net.ordo, "msp"), "OrdererMSP"))
    group = ctx.channel_group(
        ctx.application_group({"Org1": org1}),
        ctx.orderer_group({"OrdererOrg": oorg}, consensus_type="etcdraft",
                          consensus_metadata=meta.encode(),
                          max_message_count=2, batch_timeout="200ms"))
    return ctx.genesis_block(CH, group, nonce=b"g" * 24,
                             timestamp=1_760_000_000).encode()


def test_an_etcdraft_orderer_node_behind_the_compaction_point_stays_behind(
        net, tmp_path):
    """The reference fault at the node: no caller passes a raft
    `block_puller`, so node 3, halted after block 1 while the others
    order blocks 2-4 and compact, installs their snapshot on restart and
    writes no block (the chain-level pin
    `test_a_node_behind_the_compaction_point_stays_behind`, at three
    orderer nodes)."""
    genesis = _raft_genesis(net)
    out = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        transport = p.InProc()

        def start(nid):
            router = p.Router(transport)
            node = p.Orderer(str(tmp_path / pkg / f"o{nid}"), p.csp(),
                             signer=getattr(net.orderer, pkg),
                             genesis_blocks=[_block(pkg, genesis)],
                             node_id=nid, transport=router)
            router.register(nid, None)
            node.start()
            return node

        nodes = {nid: start(nid) for nid in (1, 2, 3)}
        try:
            def chain(nid):
                return nodes[nid].registrar.get_chain(CH)

            def leader(among=(1, 2, 3)):
                assert _wait(lambda: any(chain(n).chain.is_leader
                                         for n in among))
                return next(n for n in among if chain(n).chain.is_leader)

            def order(nid, k):
                status = ob.BroadcastResponse.decode(_call(
                    nodes[nid], "ab.Broadcast",
                    _envelope(net.client, k))).status
                assert status == cb.SUCCESS

            lead = leader()
            order(lead, 0)
            order(lead, 1)
            assert _wait(lambda: all(chain(n).store.height == 2
                                     for n in nodes))
            nodes[3].stop()
            transport.unregister(3)
            lead = leader((1, 2))
            for k in range(2, 8):
                order(lead, k)
            assert _wait(lambda: all(chain(n).store.height >= 4
                                     for n in (1, 2)))
            h3 = 2
            nodes[3] = start(3)
            c3 = chain(3).chain
            assert _wait(lambda: c3.node.commit >= chain(lead).chain.node
                         .log.snap_index)
            order(lead, 8)
            order(lead, 9)
            assert _wait(lambda: all(chain(n).store.height >= 5
                                     for n in (1, 2)))
            time.sleep(0.2)
            out[pkg] = (h3, chain(3).store.height, chain(1).store.height)
        finally:
            for node in nodes.values():
                node.stop()
    assert out["port"] == out["jax"]
    h3, after, others = out["port"]
    assert after == h3 < others


def _materialize_race(mod, creds) -> list[str]:
    """Two threads materialize one credentials object in the interleaving
    a node's start-up can take: both find no directory; the first
    creates and fills its own, and just before it returns the second
    installs a new, empty one.  The errors each thread's context load
    raised."""
    real_tmp, real_chmod = mod.tempfile.TemporaryDirectory, mod.os.chmod
    both_in = threading.Barrier(2, timeout=1)
    second_go, second_in, first_out = (threading.Event() for _ in range(3))

    class Tmp(real_tmp):
        def __init__(self, *a, **kw):
            try:
                both_in.wait()  # both threads found no directory
            except threading.BrokenBarrierError:
                pass  # the port's lock: the second never gets here
            if threading.current_thread().name == "second":
                second_go.wait(1)
            super().__init__(*a, **kw)

    def chmod(path, mode):
        real_chmod(path, mode)
        who = threading.current_thread().name
        if who == "first" and mode == 0o600:  # its files are written
            second_go.set()
            second_in.wait(1)
        elif who == "second" and mode == 0o700:  # its empty directory
            second_in.set()
            first_out.wait(1)

    errors = []

    def run(fn):
        try:
            fn()
        except OSError as exc:
            errors.append(type(exc).__name__)
        finally:
            if threading.current_thread().name == "first":
                first_out.set()

    mod.tempfile.TemporaryDirectory = Tmp
    mod.os.chmod = chmod
    try:
        ts = [threading.Thread(target=run, args=(fn,), name=name)
              for name, fn in (("first", creds.server_context),
                               ("second", creds.client_context))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        mod.tempfile.TemporaryDirectory = real_tmp
        mod.os.chmod = real_chmod
    return errors


def test_tls_files_are_written_once_under_a_start_up_race():
    """A fault of the reference the port does not adopt: a node's deliver
    thread (a client context) and its server (a server context) can
    materialize one credentials object at once, and the reference's
    `TLSCredentials._materialize` then hands the first a directory the
    second has just made and not yet filled (FileNotFoundError; seen at a
    peer's restart).  The port writes the files once, under a lock."""
    from fabric_tpu.comm import tls as jax_tls
    from fabric_tpu_torch.comm import tls as port_tls
    from fabric_tpu_torch.common.crypto import CA

    ca = CA("tlsca.race.example.com", "race")
    pair = ca.issue("node", sans=["127.0.0.1"], server=True)
    got = {}
    for name, mod in (("jax", jax_tls), ("port", port_tls)):
        creds = mod.TLSCredentials(cert_pem=pair.cert_pem,
                                   key_pem=pair.key_pem,
                                   ca_pems=[ca.cert_pem])
        got[name] = _materialize_race(mod, creds)
    assert got == {"jax": ["FileNotFoundError"], "port": []}


def test_the_ports_orderer_node_serves_the_broadcast_stream(net, tmp_path):
    """A deliberate divergence: the port's orderer node serves
    `ab.BroadcastStream` (each frame an envelope, an ack each, through the
    channel's filters), which the port's gateway submits over; the JAX
    package's orderer node serves no such method."""
    envs = [_envelope(net.client, k) for k in range(BATCH)]
    bad = cb.Envelope.decode(_envelope(net.client, 99))
    bad.signature = net.client.sign(b"not the payload")
    bad = bad.encode()
    got = {}
    for pkg in ("jax", "port"):
        o = _orderer(pkg, net, tmp_path / pkg)
        try:
            stream = RPCClient(*o.addr, timeout=30).duplex(
                "ab.BroadcastStream")
            try:
                stream.send(bad)
                first = stream.recv()  # an ack, or the server's refusal
                for raw in envs:
                    stream.send(raw)
                acks = [ob.BroadcastResponse.decode(raw).status for raw in
                        [first, *(stream.recv() for _ in range(BATCH))]]
                stream.finish()
                assert stream.recv() is None
                store = o.registrar.get_chain(CH).store
                assert _wait(lambda: store.height == 2)
                got[pkg] = acks
            except RPCError as exc:
                got[pkg] = str(exc)
            finally:
                stream.close()
        finally:
            o.stop()
    assert got["port"] == [cb.FORBIDDEN] + [cb.SUCCESS] * BATCH
    assert got["jax"] == "no method ab.BroadcastStream"


def _rw(sim, args):
    """A plain-callable chaincode: read args[0], write args[1] = args[2]."""
    got = sim.get_state("kv", args[0].decode())
    sim.set_state("kv", args[1].decode(), args[2])
    return 200, "", got or b""


def test_the_dev_node_orders_and_commits_as_the_reference(net, tmp_path,
                                                          monkeypatch):
    """The single-process dev node (solo orderer into a committing peer),
    on each package's default CSP from its factory (the port's is CUDACSP,
    here asked for the CPU through the config's environment layer): the
    same flags and state for the same proposals (index 2 reads index 1's
    write in the same block: an MVCC conflict)."""
    from fabric_tpu.csp import factory as jax_factory
    from fabric_tpu.node.devnode import DevNode as JaxDev
    from fabric_tpu_torch.common import hashing as port_hashing
    from fabric_tpu_torch.csp import factory as port_factory
    from fabric_tpu_torch.node.devnode import DevNode as PortDev

    monkeypatch.setenv("CORE_BCCSP_TPU_DEVICE", "cpu")
    args = [[b"r0", b"w0", b"v0"], [b"r1", b"w1", b"v1"],
            [b"w1", b"w2", b"v2"], [b"r3", b"w3", b"v3"]]
    got = {}
    for pkg, Dev, fac in (("jax", JaxDev, jax_factory),
                          ("port", PortDev, port_factory)):
        saved = fac._default
        fac._default = None
        dev = Dev(_block(pkg, net.genesis), root_dir=str(tmp_path / pkg),
                  peer_signer=getattr(net.peer, pkg),
                  chaincodes={"kv": _rw})
        try:
            assert type(dev.csp).__name__ == (
                "SWCSP" if pkg == "jax" else "CUDACSP")
            assert pkg == "jax" or dev.csp.device.type == "cpu"
            answers = []
            for k, a in enumerate(args):
                prop, _, sp = _proposal(net.client, "kv", a,
                                        b"d%023d" % k)
                sp_obj = (pb.SignedProposal.decode(sp) if pkg == "port"
                          else _jax_signed(sp))
                resp = dev.endorser.process_proposal(sp_obj)
                raw = (resp.encode() if pkg == "port"
                       else resp.SerializeToString())
                resp = pb.ProposalResponse.decode(raw)
                answers.append((resp.response.status, bytes(resp.payload)))
                env = pu.create_signed_tx(prop, net.client, [resp])
                dev.broadcast(cb.Envelope.decode(env.encode())
                              if pkg == "port" else _jax_env(env.encode()))
            num, flags = dev.wait_commit(timeout=30)
            state = sorted((k, bytes(getattr(v, "value", v))) for k, v in
                           dev.ledger.get_state_range("kv", "", ""))
            got[pkg] = (answers, num, list(flags), state)
        finally:
            dev.shutdown()
            fac._default = saved
            if pkg == "port":
                port_hashing.set_hash_backend(None)
            else:
                from fabric_tpu.common import hashing as jax_hashing

                jax_hashing.set_hash_backend(None)
    assert got["port"] == got["jax"]
    answers, num, flags, state = got["port"]
    assert num == 1 and flags == [pb.VALID, pb.VALID,
                                  pb.MVCC_READ_CONFLICT, pb.VALID]
    assert [k for k, _ in state] == ["w0", "w1", "w3"]


def _jax_signed(raw):
    from fabric_tpu.protos.peer import proposal_pb2

    return proposal_pb2.SignedProposal.FromString(raw)


def _jax_env(raw):
    from fabric_tpu.protos.common import common_pb2

    return common_pb2.Envelope.FromString(raw)


def test_an_orderer_node_onboards_a_channel_as_the_reference(net, tmp_path):
    """`participation.Onboard`: a second orderer node pulls the channel
    from the first over `ab.Deliver`, checks it against the genesis block
    it holds, and joins at the first's height; a trust anchor that is not
    the remote's genesis is refused."""
    envs = [_envelope(net.client, k) for k in range(BATCH)]
    other = cb.Block.decode(net.genesis)
    other.header.data_hash = b"\x00" * 32  # not the channel's genesis
    got = {}
    for pkg in ("jax", "port"):
        a = _orderer(pkg, net, tmp_path / pkg / "a")
        p = PKG[pkg]
        b = p.Orderer(str(tmp_path / pkg / "b"), p.csp(),
                      signer=getattr(net.orderer, pkg))
        b.start()
        try:
            for raw in envs:
                _call(a, "ab.Broadcast", raw)
            assert _wait(lambda: a.registrar.get_chain(CH).store.height
                         == 2)
            answers = []
            for anchor in (other.encode(), net.genesis):
                body = json.dumps({"channel": CH,
                                   "from": f"127.0.0.1:{a.addr[1]}",
                                   "genesis": anchor.hex()}).encode()
                try:
                    answers.append(json.loads(
                        _call(b, "participation.Onboard", body)))
                except RPCError as exc:
                    answers.append(str(exc))
            store = b.registrar.get_chain(CH).store
            blk = store.get_block_by_number(1)
            raw = blk.SerializeToString() if pkg == "jax" else blk.encode()
            got[pkg] = (answers, store.height,
                        list(cb.Block.decode(raw).data.data))
        finally:
            a.stop()
            b.stop()
    assert got["port"] == got["jax"]
    answers, height, data = got["port"]
    assert answers == ["remote genesis differs from the trust anchor",
                       {"channel": CH, "height": 2}]
    assert height == 2 and data == envs


def test_peer_nodes_with_gossip_commit_the_same_blocks(net, tmp_path):
    """`PeerNode.enable_gossip`: two peer nodes of Org1, the second
    bootstrapped on the first, both with the orderer as a deliver
    endpoint; the elected leader pulls from the orderer, the other takes
    the blocks by gossip; both commit the same flags, in both packages."""
    got = {}
    for pkg in ("jax", "port"):
        o = _orderer(pkg, net, tmp_path / pkg / "o")
        a = _peer(pkg, net, tmp_path / pkg / "a", o.addr)
        b = _peer(pkg, net, tmp_path / pkg / "b", o.addr)
        try:
            a.enable_gossip(("127.0.0.1", 0), [], tick_interval_s=0.05,
                            reconcile_interval_s=0)
            b.enable_gossip(("127.0.0.1", 0), [a.gossip_comm.endpoint],
                            tick_interval_s=0.05, reconcile_interval_s=0)
            for p in (a, b):
                _call(p, "admin.JoinChannel", net.genesis)
            envs = []
            for k in range(BATCH):
                prop, _, sp = _proposal(net.client, "kv",
                                        [b"rw", b"r%d" % k, b"g%d" % k,
                                         b"v"], b"g%023d" % k)
                _, resp = _endorse(a, sp)
                envs.append(pu.create_signed_tx(prop, net.client,
                                                [resp]).encode())
            for raw in envs:
                _call(o, "ab.Broadcast", raw)
            assert _wait(lambda: all(int(_call(p, "admin.Height",
                                               CH.encode())) == 2
                                     for p in (a, b)), timeout=60)
            got[pkg] = [_flags(p, net.client, 2) for p in (a, b)]
        finally:
            o.stop()
            a.stop()
            b.stop()
    assert got["port"][0] == got["port"][1]
    assert [f for _, _, f in got["port"][0]] == [[pb.VALID] * BATCH]
    assert [[(n, f) for n, _, f in v] for v in got["port"]] == \
        [[(n, f) for n, _, f in v] for v in got["jax"]]


def test_a_peer_node_joins_by_a_fetched_snapshot(net, tmp_path):
    """The snapshot calls of a peer node: a snapshot of the last block now
    (`admin.SnapshotSubmit`), fetched by a second node's operator over
    `admin.SnapshotFetch`, joined by `admin.JoinBySnapshot`; the second
    peer then commits the next block from the orderer with the first's
    flags and state, in both packages."""
    from fabric_tpu_torch.ledger.snapshot import fetch_snapshot

    def envs(first):
        out = []
        for k in range(first, first + BATCH):
            prop, _, sp = _proposal(net.client, "kv",
                                    [b"rw", b"r%d" % k, b"s%d" % k, b"v"],
                                    b"s%023d" % k)
            _, resp = _endorse(a, sp)
            out.append(pu.create_signed_tx(prop, net.client,
                                           [resp]).encode())
        return out

    got = {}
    for pkg in ("jax", "port"):
        o = _orderer(pkg, net, tmp_path / pkg / "o")
        a = _peer(pkg, net, tmp_path / pkg / "a", o.addr)
        b = _peer(pkg, net, tmp_path / pkg / "b", o.addr)
        try:
            _call(a, "admin.JoinChannel", net.genesis)
            for raw in envs(0):
                _call(o, "ab.Broadcast", raw)
            assert _wait(lambda: a.channels[CH].ledger.height == 2)
            res = json.loads(_call(a, "admin.SnapshotSubmit", json.dumps(
                {"channel": CH, "block_number": 0}).encode()))
            dest = fetch_snapshot(RPCClient(*a.addr, timeout=30), CH, 1,
                                  str(tmp_path / pkg / "fetched"))
            joined = _call(b, "admin.JoinBySnapshot", dest.encode())
            assert int(_call(b, "admin.Height", CH.encode())) == 2
            for raw in envs(BATCH):
                _call(o, "ab.Broadcast", raw)
            assert _wait(lambda: all(int(_call(p, "admin.Height",
                                               CH.encode())) == 3
                                     for p in (a, b)))
            got[pkg] = (sorted(res), joined,
                        [_flags(p, net.client, 3, start=2)[0][2]
                         for p in (a, b)],
                        [_query(p, net.client, b"q" * 24, [b"range"])[2]
                         for p in (a, b)])
        finally:
            o.stop()
            a.stop()
            b.stop()
    assert got["port"] == got["jax"]
    keys, joined, flags, states = got["port"]
    assert keys == ["block_number", "snapshot_dir"] and joined == CH.encode()
    assert flags == [[pb.VALID] * BATCH] * 2 and states[0] == states[1]
    assert len(json.loads(states[0])) == 2 * BATCH
