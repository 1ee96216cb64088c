"""The port's service discovery against the JAX package's.

- `satisfaction_sets` of nested n-of-m policies (written in the policy
  DSL, the same envelope bytes to both packages) are equal.
- `compute_descriptor` over the 5-org world's peers, with and without a
  collection filter, gives descriptors that decode equal (their maps
  encode in each package's own order), and refuses an unsatisfiable
  policy in both.
- `DiscoveryService.process` answers the config, members and endorsers
  queries, a local-peers query, an unknown channel, a refused ACL and a
  bad signature alike (answers compared decoded), each package's client
  asking its own service and the other package's.
- `select_endorsers` picks the same peers under the same rng.
"""

import random

import pytest

import chip_smoke
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.csp import SWCSP
from fabric_tpu.discovery import client as jax_client
from fabric_tpu.discovery import endorsement as jax_endorsement
from fabric_tpu.discovery import inquire as jax_inquire
from fabric_tpu.discovery import service as jax_service
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.protos.common import common_pb2, policies_pb2
from fabric_tpu.protos.discovery import protocol_pb2 as jdpb
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.crypto import key_pem
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.discovery import client as port_client
from fabric_tpu_torch.discovery import endorsement as port_endorsement
from fabric_tpu_torch.discovery import inquire as port_inquire
from fabric_tpu_torch.discovery import service as port_service
from fabric_tpu_torch.policies import policydsl
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import discovery as pdpb

CH = chip_smoke.VALIDATOR_CHANNEL

POLICIES = [
    "OR('Org1MSP.peer', 'Org2MSP.peer')",
    "AND('Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
    "OutOf(3, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer', "
    "'Org4MSP.peer', 'Org5MSP.peer')",
    "OutOf(2, 'Org1MSP.peer', OR('Org2MSP.peer', 'Org3MSP.peer'), "
    "AND('Org4MSP.peer', 'Org5MSP.peer'))",
    "AND(OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer'), OutOf(2, "
    "'Org3MSP.peer', 'Org4MSP.peer', 'Org1MSP.peer'))",
    "OutOf(2, 'Org1MSP.peer', 'Org1MSP.peer', 'Org2MSP.member')",
    # past the DSL's own check: 4 of 3
    "OutOf(3, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer') as 4",
]


def _envelopes(src: str):
    src, _, n = src.partition(" as ")
    env = policydsl.from_string(src)
    if n:
        env.rule = cb.SignaturePolicy(n_out_of=cb.NOutOf(
            n=int(n), rules=list(env.rule.n_out_of.rules)))
    raw = env.encode()
    return (policies_pb2.SignaturePolicyEnvelope.FromString(raw),
            cb.SignaturePolicyEnvelope.decode(raw))


@pytest.mark.parametrize("src", POLICIES)
def test_satisfaction_sets_as_the_reference(src):
    jenv, penv = _envelopes(src)
    got = port_inquire.satisfaction_sets(penv)
    assert got == jax_inquire.satisfaction_sets(jenv)
    assert bool(got) == (not src.endswith(" as 4"))


class World:
    def __init__(self):
        w = self.w = chip_smoke.validator_world(71)
        self.jax_bundle = jax_bundle(common_pb2.Block.FromString(w.genesis),
                                     SWCSP())
        self.port_bundle = port_bundle(cb.Block.decode(w.genesis))
        # the five peers, Org5's without the chaincode
        self.peers = [dict(endpoint=f"peer0.org{k + 1}:7051",
                           identity=p.serialize(), mspid=p.mspid,
                           ledger_height=10 + k % 3,
                           chaincodes=(("benchcc",) if k < 4 else ()))
                      for k, p in enumerate(w.peers)]
        self.outsider = chip_smoke.orderer_identity(w, "outsider",
                                                    ou="client")
        cfg = self.port_bundle.config.channel_group.groups["Application"]
        self.msps = {name: g.values["MSP"].value
                     for name, g in cfg.groups.items()}


@pytest.fixture(scope="module")
def world():
    return World()


def _peer_infos(world, pkg):
    mod = jax_endorsement if pkg == "jax" else port_endorsement
    return [mod.PeerInfo(**p) for p in world.peers]


def _mm(world, pkg):
    return (world.jax_bundle if pkg == "jax" else world.port_bundle
            ).msp_manager


def _as_jax(msg):
    """A port message read back by the JAX package's schema."""
    return getattr(jdpb, type(msg).__name__).FromString(msg.encode())


@pytest.mark.parametrize("src", POLICIES[:5])
@pytest.mark.parametrize("with_filter", [False, True],
                         ids=["all", "benchcc_installed"])
def test_descriptors_as_the_reference(world, src, with_filter):
    jenv, penv = _envelopes(src)
    filt = (lambda p: "benchcc" in p.chaincodes) if with_filter else None
    want = jax_endorsement.compute_descriptor(
        "benchcc", jenv, _peer_infos(world, "jax"), _mm(world, "jax"),
        collection_filter=filt)
    got = port_endorsement.compute_descriptor(
        "benchcc", penv, _peer_infos(world, "port"), _mm(world, "port"),
        collection_filter=filt)
    assert _as_jax(got) == want
    assert [dict(layout.quantities_by_group) for layout in got.layouts] \
        == [dict(layout.quantities_by_group) for layout in want.layouts]
    if with_filter:
        endpoints = {p.endpoint for g in got.endorsers_by_groups.values()
                     for p in g.peers}
        assert "peer0.org5:7051" not in endpoints


def test_an_unsatisfiable_policy_raises_in_both(world):
    jenv, penv = _envelopes("AND('Org4MSP.peer', 'Org5MSP.peer')")
    only4 = lambda p: "benchcc" in p.chaincodes
    with pytest.raises(ValueError) as jexc:
        jax_endorsement.compute_descriptor(
            "benchcc", jenv, _peer_infos(world, "jax"), _mm(world, "jax"),
            collection_filter=only4)
    with pytest.raises(ValueError) as pexc:
        port_endorsement.compute_descriptor(
            "benchcc", penv, _peer_infos(world, "port"), _mm(world, "port"),
            collection_filter=only4)
    assert str(pexc.value) == str(jexc.value)


ENDORSE_POLICY = chip_smoke.ENDORSE_POLICY


def _service(world, pkg):
    if pkg == "jax":
        mod, bundle, csp = jax_service, world.jax_bundle, SWCSP()
        env = _envelopes(ENDORSE_POLICY)[0]
    else:
        mod, bundle, csp = port_service, world.port_bundle, HostCSP()
        env = _envelopes(ENDORSE_POLICY)[1]
    writers = bundle.policy_manager.get_policy("/Channel/Application/Writers")

    def acl_check(channel, sd):
        if not writers.evaluate_signed_data([sd], csp):
            raise PermissionError(f"{channel}: not a writer")

    support = mod.DiscoverySupport(
        channels=lambda: [CH],
        bundle=lambda ch: bundle,
        peers=lambda ch: _peer_infos(world, pkg),
        msp_configs=lambda ch: world.msps,
        orderer_endpoints=lambda ch: {"OrdererMSP": [("127.0.0.1", 7050),
                                                     ("127.0.0.1", 7051)]},
        chaincode_policy=lambda ch, cc: env if cc == "benchcc" else None,
        collection_filter=lambda ch, cc, colls: (
            lambda p: "benchcc" in p.chaincodes),
        acl_check=acl_check)
    return mod.DiscoveryService(support, csp)


def _signer(world, pkg, port_signer):
    if pkg == "port":
        return port_signer
    return JaxSigner.from_pem(port_signer.mspid, port_signer.cert.pem(),
                              key_pem(port_signer._key), SWCSP())


def _requests(world, pkg):
    """{case: a signed request of the client package}."""
    q = pdpb.Query
    queries = {
        "config": q(channel=CH, config_query=pdpb.ConfigQuery()),
        "members": q(channel=CH, peer_query=pdpb.PeerMembershipQuery()),
        "endorsers": q(channel=CH, cc_query=pdpb.ChaincodeQuery(interests=[
            pdpb.ChaincodeInterest(chaincodes=[pdpb.ChaincodeCall(
                name="benchcc")])])),
        "endorsers_with_collection": q(channel=CH, cc_query=(
            pdpb.ChaincodeQuery(interests=[pdpb.ChaincodeInterest(
                chaincodes=[pdpb.ChaincodeCall(
                    name="benchcc", collection_names=["c1"])])]))),
        "no_policy": q(channel=CH, cc_query=pdpb.ChaincodeQuery(interests=[
            pdpb.ChaincodeInterest(chaincodes=[pdpb.ChaincodeCall(
                name="ghostcc")])])),
        "local_peers": q(local_peers=pdpb.LocalPeerQuery()),
        "unknown_channel": q(channel="nochannel",
                             config_query=pdpb.ConfigQuery()),
        "no_query": q(channel=CH),
    }
    out = {}
    for case, query in queries.items():
        for who in ("client", "outsider", "tampered"):
            signer = world.outsider if who == "outsider" else world.w.client
            s = _signer(world, pkg, signer)
            payload = pdpb.Request(
                authentication=pdpb.AuthInfo(
                    client_identity=signer.serialize()),
                queries=[query]).encode()
            sig = s.sign(b"other bytes" if who == "tampered" else payload)
            out[case, who] = pdpb.SignedRequest(payload=payload,
                                                signature=sig).encode()
    out["malformed", "client"] = pdpb.SignedRequest(
        payload=b"\xff\xff").encode()
    return out


@pytest.fixture(scope="module")
def services(world):
    return {pkg: _service(world, pkg) for pkg in ("jax", "port")}


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_service_answers_as_the_reference(world, services, client_pkg):
    reqs = _requests(world, client_pkg)
    answers = {}
    for key, raw in reqs.items():
        want = services["jax"].process(jdpb.SignedRequest.FromString(raw))
        got = services["port"].process(pdpb.SignedRequest.decode(raw))
        assert _as_jax(got) == want, key
        answers[key] = got.results[0]
    kinds = {k: r.which("result") for k, r in answers.items()}
    assert kinds["config", "client"] == "config_result"
    assert kinds["members", "client"] == "members"
    assert kinds["endorsers", "client"] == "cc_query_res"
    assert kinds["local_peers", "outsider"] == "members"
    for case in ("config", "members", "endorsers"):
        for who in ("outsider", "tampered"):
            assert kinds[case, who] == "error"
            assert answers[case, who].error.content.startswith(
                "access denied")
    assert answers["malformed", "client"].error.content == \
        "malformed request"
    assert kinds["no_query", "client"] == "error"
    desc = answers["endorsers", "client"].cc_query_res.content[0]
    assert len(desc.layouts) == 10  # 3 of 5
    desc = answers["endorsers_with_collection", "client"] \
        .cc_query_res.content[0]
    assert len(desc.layouts) == 4  # 3 of Org1-4


def test_clients_and_select_endorsers_as_the_reference(world, services):
    jc = jax_client.DiscoveryClient(
        _signer(world, "jax", world.w.client),
        lambda sreq: services["jax"].process(sreq))
    pc = port_client.DiscoveryClient(
        world.w.client,
        lambda sreq: pdpb.Response.decode(services["jax"].process(
            jdpb.SignedRequest.FromString(sreq.encode())
        ).SerializeToString()))
    assert _as_jax(pc.config(CH)) == jc.config(CH)
    # the orgs in each package's map order
    assert sorted((_as_jax(p) for p in pc.peers(CH)),
                  key=lambda p: p.endpoint) == sorted(
        jc.peers(CH), key=lambda p: p.endpoint)
    jd = jc.endorsers(CH, "benchcc", ["c1"])
    pd_ = pc.endorsers(CH, "benchcc", ["c1"])
    assert _as_jax(pd_) == jd
    jr, pr = random.Random(5), random.Random(5)
    for _ in range(30):
        want = [p.endpoint for p in jax_client.select_endorsers(jd, jr)]
        got = [p.endpoint for p in port_client.select_endorsers(pd_, pr)]
        assert got == want and len(got) == 3
    with pytest.raises(RuntimeError) as jexc:
        jc.endorsers(CH, "ghostcc")
    with pytest.raises(RuntimeError) as pexc:
        pc.endorsers(CH, "ghostcc")
    assert str(pexc.value) == str(jexc.value)
