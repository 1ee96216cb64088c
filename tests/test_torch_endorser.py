"""The port's endorser and ACLs against the JAX package's, and the
execute-order-validate slice as a whole.

- The same SignedProposal bytes go to both packages' `Endorser`s over
  equal states (a shim chaincode through each package's
  `ChaincodeSupport`): equal ProposalResponsePayloads, responses and
  endorsers; each package's endorsement signature verifies under the
  other's check; the refusals raise the same error class.
- `ACLProvider` gives the same verdicts over the whole resource catalog
  and the SCC function catalog, for an admin, a member and an outsider,
  with and without an override.
- The slice: 8 proposals with planted faults (a bad creator signature, a
  creator outside /Channel/Application/Writers, a chaincode status of
  500, a transaction with two endorsements, a read of a key an earlier
  transaction of the block writes) go through each package's three
  endorsers, its 3-node raft cluster, a deliver client, `TxValidator` and
  `Committer` at three peers: equal refusals, flags, TRANSACTIONS_FILTERs
  and KV pairs.
"""

import itertools
import time
import types

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.chaincode import shim as jax_shim
from fabric_tpu.chaincode import support as jax_support
from fabric_tpu.common import deliver as jax_deliver
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.csp import SWCSP
from fabric_tpu.ledger import kvstore as jax_kv
from fabric_tpu.ledger import statedb as jax_sdb
from fabric_tpu.ledger import txmgmt as jax_tx
from fabric_tpu.ledger.kvledger import LedgerProvider as JaxProvider
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.orderer import raft as jax_raft
from fabric_tpu.orderer.broadcast import BroadcastHandler as JaxHandler
from fabric_tpu.orderer.multichannel import ChannelStepRouter as JaxRouter
from fabric_tpu.orderer.multichannel import Registrar as JaxRegistrar
from fabric_tpu.peer import aclmgmt as jax_acl
from fabric_tpu.peer import endorser as jax_endorser
from fabric_tpu.peer.committer import Committer as JaxCommitter
from fabric_tpu.peer.deliverclient import DeliverClient as JaxClient
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.peer import proposal_pb2
from fabric_tpu import protoutil as jax_pu
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.chaincode import shim as port_shim
from fabric_tpu_torch.chaincode import support as port_support
from fabric_tpu_torch.common import deliver as port_deliver
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.crypto import key_pem
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.ledger import kvstore as port_kv
from fabric_tpu_torch.ledger import statedb as port_sdb
from fabric_tpu_torch.ledger import txmgmt as port_tx
from fabric_tpu_torch.ledger.kvledger import LedgerProvider as PortProvider
from fabric_tpu_torch.orderer import raft as port_raft
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler as PortHandler
from fabric_tpu_torch.orderer.multichannel import (
    ChannelStepRouter as PortRouter,
)
from fabric_tpu_torch.orderer.multichannel import Registrar as PortRegistrar
from fabric_tpu_torch.peer import aclmgmt as port_acl
from fabric_tpu_torch.peer import endorser as port_endorser
from fabric_tpu_torch.peer.committer import Committer as PortCommitter
from fabric_tpu_torch.peer.deliverclient import DeliverClient as PortClient
from fabric_tpu_torch.peer.txvalidator import TxValidator as PortValidator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb

CH = chip_smoke.VALIDATOR_CHANNEL
CC = chip_smoke.VALIDATOR_CC


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
        shim=jax_shim, support=jax_support, kv=jax_kv, sdb=jax_sdb,
        tx=jax_tx, endorser=jax_endorser, acl=jax_acl, raft=jax_raft,
        Registrar=JaxRegistrar, Router=JaxRouter, Handler=JaxHandler,
        Provider=JaxProvider, Client=JaxClient, Validator=JaxValidator,
        Committer=JaxCommitter, deliver=jax_deliver, csp=SWCSP,
        verify_csp=SWCSP, block=common_pb2.Block.FromString,
        sp=proposal_pb2.SignedProposal.FromString,
        signed_data=jax_pu.SignedData,
        signed_tx=jax_pu.create_signed_tx),
    "port": types.SimpleNamespace(
        shim=port_shim, support=port_support, kv=port_kv, sdb=port_sdb,
        tx=port_tx, endorser=port_endorser, acl=port_acl, raft=port_raft,
        Registrar=PortRegistrar, Router=PortRouter, Handler=PortHandler,
        Provider=PortProvider, Client=PortClient, Validator=PortValidator,
        Committer=PortCommitter, deliver=port_deliver, csp=HostCSP,
        verify_csp=lambda: CUDACSP(device="cpu"), block=cb.Block.decode,
        sp=pb.SignedProposal.decode, signed_data=pu.SignedData,
        signed_tx=pu.create_signed_tx),
}


def _enc(m) -> bytes:
    return m.SerializeToString() if hasattr(m, "SerializeToString") \
        else m.encode()


def _both(signer):
    """A port signing identity and the JAX one of the same key and
    certificate."""
    return types.SimpleNamespace(
        port=signer,
        jax=JaxSigner.from_pem(signer.mspid, signer.cert.pem(),
                               key_pem(signer._key), SWCSP()))


class World:
    def __init__(self):
        self.w = chip_smoke.validator_world(43)
        self.client = _both(self.w.client)
        self.peers = [_both(p) for p in self.w.peers]
        self.outsider = _both(chip_smoke.orderer_identity(
            self.w, "outsider", ou="client"))
        self.orderer = _both(chip_smoke.orderer_identity(self.w))
        self.bundle = {
            "jax": jax_bundle(common_pb2.Block.FromString(self.w.genesis),
                              SWCSP()),
            "port": port_bundle(cb.Block.decode(self.w.genesis))}


@pytest.fixture(scope="module")
def world():
    return World()


def benchcc(pkg: str):
    """The slice's chaincode: a read and a write, as the headline's
    transactions."""
    shim = PKG[pkg].shim

    class Bench(shim.Chaincode):
        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            if fn == "rw":
                got = stub.get_state(params[0].decode())
                stub.put_state(params[1].decode(), params[2])
                return shim.success(got)
            if fn == "fail":
                return shim.error("refused by the chaincode", status=500)
            return shim.error(f"unknown function {fn!r}")

    return Bench()


class Peer:
    """An endorsing peer of one package: a chaincode support with
    `benchcc` over an in-process stream, and an Endorser."""

    def __init__(self, pkg, world, k, ledger):
        p = self.p = PKG[pkg]
        self.support = p.support.ChaincodeSupport(invoke_timeout_s=10.0)
        self.stream = p.support.InProcStream(self.support, benchcc(pkg), CC)
        self.stream.start()
        self.stream.wait_registered(self.support, CC)
        seq = itertools.count()

        def run(sim, args):
            resp, _ = self.support.execute(CC, "", f"{CC}-{next(seq)}",
                                           sim, args)
            return resp.status, resp.message, resp.payload

        self.endorser = p.endorser.Endorser(
            CH, ledger, world.bundle[pkg], getattr(world.peers[k], pkg),
            {CC: run}, p.csp())

    def stop(self):
        self.stream.stop()


def _seeded_ledger(pkg):
    p = PKG[pkg]
    db = p.sdb.VersionedDB(p.kv.MemKVStore(), "statedb/ch")
    db.apply_updates({CC: {f"seed-{i}": p.sdb.VersionedValue(
        b"s%d" % i, p.sdb.Height(1, i), b"") for i in range(4)}},
        p.sdb.Height(1, 4))
    return types.SimpleNamespace(new_tx_simulator=lambda: p.tx.TxSimulator(db))


def _proposal(world, args, signer=None, cc=CC, channel=CH, nonce=None,
              tamper=False, tx_id=None):
    """A signed proposal's bytes (the port's builder; both packages read
    the same bytes)."""
    signer = signer or world.w.client
    prop, _ = pu.create_chaincode_proposal(
        signer.serialize(), channel, cc, args,
        nonce=nonce or world.w.rng.bytes(24), timestamp=chip_smoke
        .VALIDATOR_TS)
    if tx_id is not None:
        hdr = cb.Header.decode(prop.header)
        chdr = cb.ChannelHeader.decode(hdr.channel_header)
        chdr.tx_id = tx_id
        hdr.channel_header = chdr.encode()
        prop.header = hdr.encode()
    raw = prop.encode()
    sig = signer.sign(b"not the proposal" if tamper else raw)
    return pb.SignedProposal(proposal_bytes=raw, signature=sig).encode()


@pytest.fixture(scope="module")
def peers(world):
    out = {pkg: Peer(pkg, world, 0, _seeded_ledger(pkg))
           for pkg in ("jax", "port")}
    yield out
    for p in out.values():
        p.stop()


CASES = {
    "read_and_write": [b"rw", b"seed-1", b"k-1", b"v1"],
    "read_absent": [b"rw", b"absent", b"k-2", b"v2"],
    "status_500": [b"fail"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_endorsers_give_equal_payloads_and_cross_verify(world, peers, case):
    raw = _proposal(world, CASES[case])
    resp = {pkg: peers[pkg].endorser.process_proposal(PKG[pkg].sp(raw))
            for pkg in ("jax", "port")}
    got = {pkg: (resp[pkg].version, _enc(resp[pkg].response),
                 bytes(resp[pkg].payload),
                 bytes(resp[pkg].endorsement.endorser))
           for pkg in resp}
    assert got["port"] == got["jax"]
    if case == "status_500":
        assert pb.Response.decode(got["port"][1]).status == 500
        assert not got["port"][2] and not got["port"][3]
        return
    for signer, checker in (("jax", "port"), ("port", "jax")):
        e = resp[signer].endorsement
        ident = world.bundle[checker].msp_manager.deserialize_identity(
            bytes(e.endorser))
        msg = bytes(resp[signer].payload) + bytes(e.endorser)
        if checker == "jax":
            assert ident.verify(msg, bytes(e.signature))
            assert not ident.verify(msg + b"x", bytes(e.signature))
        else:
            items = [ident.verification_item(msg, bytes(e.signature)),
                     ident.verification_item(msg + b"x", bytes(e.signature))]
            assert HostCSP().verify_batch(items) == [True, False]


def _foreign(w):
    """An identity that names Org1MSP, certified by a CA of no org of the
    channel."""
    ca = chip_smoke.CA("ca.rogue.example.com", "RogueMSP",
                       rng=np.random.default_rng(53))
    pair = ca.issue("client", ous=["client"])
    return chip_smoke.SigningIdentity("Org1MSP", pair.cert, pair.key, w.rng)


def _refusals(world):
    w = world.w
    return {
        "bad_creator_signature": _proposal(world, CASES["read_and_write"],
                                           tamper=True),
        "wrong_channel": _proposal(world, CASES["read_and_write"],
                                   channel="otherchannel"),
        "txid_not_bound": _proposal(world, CASES["read_and_write"],
                                    tx_id="00" * 32),
        "creator_not_on_the_channel": _proposal(
            world, CASES["read_and_write"],
            signer=_foreign(w)),
        "creator_outside_writers": _proposal(world, CASES["read_and_write"],
                                             signer=world.outsider.port),
        "uncatalogued_scc_function": _proposal(world, [b"NoSuch", b"ch"],
                                               cc="qscc"),
        "chaincode_not_installed": _proposal(world, [b"x"], cc="ghostcc"),
    }


@pytest.mark.parametrize("case", ["bad_creator_signature", "wrong_channel",
                                  "txid_not_bound",
                                  "creator_not_on_the_channel",
                                  "creator_outside_writers",
                                  "uncatalogued_scc_function",
                                  "chaincode_not_installed"])
def test_refusals_raise_the_same_error(world, peers, case):
    raw = _refusals(world)[case]
    errs = {}
    for pkg in ("jax", "port"):
        with pytest.raises(PKG[pkg].endorser.EndorserError) as exc:
            peers[pkg].endorser.process_proposal(PKG[pkg].sp(raw))
        errs[pkg] = (type(exc.value).__name__, str(exc.value))
    assert errs["port"][0] == errs["jax"][0]
    if case != "creator_not_on_the_channel":  # its text is the MSP's own
        assert errs["port"][1] == errs["jax"][1]
    acl = case in ("creator_outside_writers", "uncatalogued_scc_function")
    assert (errs["port"][0] == "ACLDeniedError") == acl


# -- the ACL catalog ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def acl_world():
    """One application org (its Admins policy is a MAJORITY of one) and the
    orderer org: an admin, a member and an outsider of the application."""
    rng = np.random.default_rng(47)
    ca = chip_smoke.CA("ca.org1msp.example.com", "Org1MSP", rng=rng)
    oca = chip_smoke.CA("ca.orderermsp.example.com", "OrdererMSP", rng=rng)
    ctx = chip_smoke.ctx
    app = ctx.application_group({"Org1": ctx.org_group(
        "Org1MSP", chip_smoke.msp_config_from_ca(ca, "Org1MSP"))})
    ordg = ctx.orderer_group({"O": ctx.org_group(
        "OrdererMSP", chip_smoke.msp_config_from_ca(oca, "OrdererMSP"))})
    genesis = ctx.genesis_block("aclch", ctx.channel_group(app, ordg),
                                nonce=rng.bytes(24), timestamp=7).encode()

    def signer(c, mspid, name, ou):
        pair = c.issue(name, ous=[ou])
        return chip_smoke.SigningIdentity(mspid, pair.cert, pair.key, rng)

    ids = {"admin": signer(ca, "Org1MSP", "admin", "admin"),
           "member": signer(ca, "Org1MSP", "client", "client"),
           "outsider": signer(oca, "OrdererMSP", "client", "client")}
    return types.SimpleNamespace(
        ids=ids,
        bundle={"jax": jax_bundle(common_pb2.Block.FromString(genesis),
                                  SWCSP()),
                "port": port_bundle(cb.Block.decode(genesis))})


@pytest.mark.parametrize("overrides", [None, {"peer/Propose": "Admins",
                                              "qscc/GetChainInfo":
                                              "/Channel/Application/Admins"}])
def test_acl_verdicts_over_the_catalog(acl_world, overrides):
    resources = sorted(port_acl.DEFAULT_POLICIES)
    assert resources == sorted(jax_acl.DEFAULT_POLICIES)
    assert port_acl.SCC_FUNCTION_RESOURCES == jax_acl.SCC_FUNCTION_RESOURCES
    verdicts = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        provider = p.acl.ACLProvider(overrides, csp=p.csp())
        pm = acl_world.bundle[pkg].policy_manager
        rows = []
        for who, ident in sorted(acl_world.ids.items()):
            data = b"signed by " + who.encode()
            sd = p.signed_data(data, ident.serialize(), ident.sign(data))
            for res in resources:
                try:
                    provider.check_acl(res, pm, sd)
                    rows.append((who, res, True))
                except p.acl.ACLError:
                    rows.append((who, res, False))
        for (cc, fn) in sorted(port_acl.SCC_FUNCTION_RESOURCES) + [
                ("qscc", "Nope"), ("lscc", "deploy"), ("mycc", "any")]:
            try:
                rows.append((cc, fn, p.acl.resource_for_chaincode(cc, fn)))
            except p.acl.ACLError as exc:
                rows.append((cc, fn, str(exc)))
        verdicts[pkg] = rows
    assert verdicts["port"] == verdicts["jax"]
    passed = {(w, r) for w, r, ok in verdicts["port"][:3 * len(resources)]
              if ok}
    assert ("admin", "cscc/JoinChain") in passed
    assert ("member", "cscc/JoinChain") not in passed
    assert ("member", "event/Block") in passed
    assert not any(w == "outsider" for w, _ in passed)
    assert (("member", "peer/Propose") in passed) == (overrides is None)


class _CountingCSP:
    """HostCSP, counting the lanes it is asked to verify."""

    def __init__(self):
        self.inner = HostCSP()
        self.lanes = 0

    def verify_batch(self, items):
        self.lanes += len(items)
        return self.inner.verify_batch(items)


@pytest.mark.parametrize("path", ["/Channel/Writers",
                                  "/Channel/Application/Writers",
                                  "/Channel/Application/Admins"])
def test_implicit_meta_verifies_each_distinct_signature_once(world, path):
    """An implicit-meta policy's sub-policies name the same signature: the
    port verifies it once, with the reference's verdicts."""
    cases = []
    for who in (world.client, world.peers[2], world.outsider):
        data = b"signed data of " + who.port.mspid.encode()
        good = who.port.sign(data)
        cases += [(who, data, good), (who, data, good[:-1] + bytes(
            [good[-1] ^ 1])), (who, b"other data", good)]
    got, want = [], []
    for who, data, sig in cases:
        csp = _CountingCSP()
        pol = world.bundle["port"].policy_manager.get_policy(path)
        got.append(pol.evaluate_signed_data(
            [pu.SignedData(data, who.port.serialize(), sig)], csp))
        assert csp.lanes == 1
        jpol = world.bundle["jax"].policy_manager.get_policy(path)
        want.append(jpol.evaluate_signed_data(
            [jax_pu.SignedData(data, who.jax.serialize(), sig)], SWCSP()))
    assert got == want
    assert any(got) == (path != "/Channel/Application/Admins")


# -- the slice as a whole ----------------------------------------------------------------


def _raft_genesis(world) -> bytes:
    meta = ob.ConfigMetadata(
        consenters=[ob.Consenter(id=i, host="127.0.0.1", port=7050 + i)
                    for i in (1, 2, 3)],
        options=ob.Options(tick_interval_ms=10, election_tick=10,
                           heartbeat_tick=1, max_inflight_blocks=5,
                           snapshot_interval_size=16 << 20))
    return chip_smoke.order_genesis(
        world.w, max_message_count=3, preferred_max_bytes=1 << 20,
        absolute_max_bytes=1 << 20, batch_timeout="1s",
        consensus_type="etcdraft", consensus_metadata=meta.encode())


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _slice(pkg, world, tmp, genesis_raw, plan):
    """Endorse `plan`'s proposals at three peers, broadcast the endorsed
    transactions to a raft follower, deliver the blocks to each peer and
    commit them; returns (refusals, flags a peer, filters a peer, KV pairs
    a peer)."""
    p = PKG[pkg]
    genesis = p.block(genesis_raw)
    transport = p.raft.InProcTransport()
    regs = {}
    for nid in (1, 2, 3):
        router = p.Router(transport)
        regs[nid] = p.Registrar(f"{tmp}/o{nid}", p.csp(),
                                signer=getattr(world.orderer, pkg),
                                node_id=nid, transport=router)
        router.register(nid, None)
        regs[nid].startup([genesis])
    providers = [p.Provider(f"{tmp}/peer{k}") for k in range(3)]
    ledgers = [prov.create(genesis) for prov in providers]
    peers = [Peer(pkg, world, k, ledgers[k]) for k in range(3)]
    try:
        chains = {n: r.get_chain(CH) for n, r in regs.items()}
        assert _wait(lambda: any(c.chain.is_leader for c in chains.values()))
        follower = next(n for n, c in chains.items() if not c.chain.is_leader)
        handler = p.Handler(regs[follower])
        refusals, statuses = [], []
        for k, (raw, endorsers) in enumerate(plan):
            sp = p.sp(raw)
            resps = []
            try:
                for j in endorsers:
                    resps.append(peers[j].endorser.process_proposal(sp))
            except p.endorser.EndorserError as exc:
                refusals.append((k, type(exc).__name__))
                continue
            if resps[0].response.status >= 400:
                refusals.append((k, resps[0].response.status))
                continue
            prop = (proposal_pb2.Proposal.FromString(sp.proposal_bytes)
                    if pkg == "jax" else pb.Proposal.decode(sp.proposal_bytes))
            env = p.signed_tx(prop, getattr(world.client, pkg), resps)
            statuses.append(handler.process_message(env))
        n_env = len(statuses)
        n_blocks = -(-n_env // 3)
        assert _wait(lambda: all(c.store.height == 1 + n_blocks
                                 for c in chains.values()))
        out_flags, out_filters, out_pairs = [], [], []
        for k in range(3):
            svc = p.deliver.DeliverService(regs[1 + k].get_chain, p.csp())
            got = []

            def connect(start, svc=svc):
                env = p.deliver.make_seek_info_envelope(
                    CH, start, "newest", signer=getattr(world.client, pkg),
                    behavior=ob.SeekInfo.FAIL_IF_NOT_READY)
                for kind, blk in svc.deliver(env):
                    if kind == "block":
                        yield blk

            client = p.Client(CH, [connect], lambda: 1 + len(got),
                              lambda seq, raw: got.append(raw),
                              bundle=world.bundle[pkg], csp=p.csp())
            client.start()
            assert _wait(lambda: len(got) == n_blocks)
            client.stop()
            blocks = [p.block(b) for b in got] if pkg == "jax" else got
            committer = p.Committer(p.Validator(
                CH, ledgers[k], world.bundle[pkg], p.verify_csp()),
                ledgers[k])
            out_flags.append([list(f) for f in committer.store_stream(
                blocks, depth=2)])
            out_filters.append([bytes(ledgers[k].get_block_by_number(n)
                                      .metadata.metadata[
                                          cb.TRANSACTIONS_FILTER])
                                for n in range(1, 1 + n_blocks)])
            out_pairs.append(list(ledgers[k].get_state_range(CC, "", "")))
        assert statuses == [cb.SUCCESS] * n_env
    finally:
        for peer in peers:
            peer.stop()
        for r in regs.values():
            r.halt_all()
        for prov in providers:
            prov.close()
    return refusals, out_flags, out_filters, out_pairs


def test_the_endorse_order_validate_slice_as_the_reference(world, tmp_path):
    all3 = (0, 1, 2)

    def rw(i, read):
        return [b"rw", read.encode(), b"key-%d" % i, b"value-%d" % i]

    plan = [
        (_proposal(world, rw(0, "r-0")), all3),
        (_proposal(world, rw(1, "r-1"), tamper=True), all3),
        (_proposal(world, rw(2, "r-2"), signer=world.outsider.port), all3),
        (_proposal(world, rw(3, "r-3")), all3),
        (_proposal(world, rw(4, "key-3")), all3),  # read after key-3's write
        (_proposal(world, [b"fail"]), all3),
        (_proposal(world, rw(6, "r-6")), (0, 1)),  # two endorsements
        (_proposal(world, rw(7, "r-7")), all3),
    ]
    genesis = _raft_genesis(world)
    got = {pkg: _slice(pkg, world, str(tmp_path / pkg), genesis, plan)
           for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0] == [
        (1, "EndorserError"), (2, "ACLDeniedError"), (5, 500)]
    assert got["port"][1:] == got["jax"][1:]
    flags, filters, pairs = got["port"][1:]
    want = [[pb.VALID, pb.VALID, pb.MVCC_READ_CONFLICT],
            [pb.ENDORSEMENT_POLICY_FAILURE, pb.VALID]]
    assert flags == [want] * 3
    assert filters == [[bytes(f) for f in want]] * 3
    assert pairs[0] == pairs[1] == pairs[2]
    assert [k for k, _ in pairs[0]] == ["key-0", "key-3", "key-7"]
