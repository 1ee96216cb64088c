"""The port's TxValidator against the JAX package's, flag for flag.

The JAX package builds the world (three orgs, MAJORITY endorsement) and
the blocks; the port gets only bytes: the genesis block and each block.
The port validates through `CUDACSP(device="cpu")` (B1's plain version,
or the host below 16 lanes) and the JAX package through `SWCSP`.  Flags
and the TRANSACTIONS_FILTER bytes must be equal, exactly, for `validate`
and `validate_pipeline` at depth 1 and 3, on crafted blocks that set every
flag the path can set and on seeded mutations of envelopes.
"""

import random

import pytest

from orgfix import make_org

from fabric_tpu import protoutil
from fabric_tpu.common import configtx_builder as ctx
from fabric_tpu.common.channelconfig import bundle_from_genesis
from fabric_tpu.ledger.txmgmt import VALIDATION_PARAMETER
from fabric_tpu.msp import msp_config_from_ca
from fabric_tpu.peer.txvalidator import TxValidator as JaxValidator
from fabric_tpu.policies import from_string
from fabric_tpu.protos.common import common_pb2
from fabric_tpu.protos.ledger.rwset import rwset_pb2
from fabric_tpu.protos.ledger.rwset.kvrwset import kv_rwset_pb2
from fabric_tpu.protos.peer import (
    chaincode_event_pb2,
    chaincode_pb2,
    collection_pb2,
    proposal_pb2,
    transaction_pb2,
)
from fabric_tpu_torch import native
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle_from_genesis,
)
from fabric_tpu_torch.csp.cuda.provider import CUDACSP
from fabric_tpu_torch.peer.txvalidator import TxValidator as PortValidator
from fabric_tpu_torch.protos import common as port_common
from fabric_tpu_torch.protos import peer as port_peer

V = transaction_pb2
CH = "valch"
CC = "vcc"


class Ledger:
    """The validator's view of a ledger: committed txids and key
    metadata (each side gets its own instance)."""

    def __init__(self, txids=(), metadata=None):
        self.txids = set(txids)
        self.metadata = dict(metadata or {})

    def tx_id_exists(self, txid):
        return txid in self.txids

    def tx_ids_exist(self, txids):
        return {t for t in txids if t in self.txids}

    def get_state_metadata(self, ns, key):
        return dict(self.metadata.get((ns, key), {}))

    def may_have_state_metadata(self, ns):
        return any(n == ns for n, _ in self.metadata)


class World:
    def __init__(self):
        self.orgs = [make_org(f"Org{i + 1}MSP") for i in range(3)]
        app = ctx.application_group({
            f"Org{i + 1}": ctx.org_group(o.mspid, msp_config_from_ca(o.ca, o.mspid))
            for i, o in enumerate(self.orgs)})
        oorg = make_org("OrdererMSP")
        ordg = ctx.orderer_group({"O": ctx.org_group(
            "OrdererMSP", msp_config_from_ca(oorg.ca, "OrdererMSP"))})
        self.genesis = ctx.genesis_block(CH, ctx.channel_group(app, ordg))
        self.csp = self.orgs[0].csp
        self.bundle = bundle_from_genesis(self.genesis, self.csp)
        self.port_bundle = port_bundle_from_genesis(
            self.genesis.SerializeToString())
        self.client = self.orgs[0].signer("client", role_ou="client")
        self.peers = [o.signer("peer0", role_ou="peer") for o in self.orgs]
        self.n = 0

    def rwset(self, writes=(), meta_writes=(), namespaces=None) -> bytes:
        kv = kv_rwset_pb2.KVRWSet(
            writes=[kv_rwset_pb2.KVWrite(key=k, value=b"v") for k in writes],
            metadata_writes=[kv_rwset_pb2.KVMetadataWrite(
                key=k, entries=[kv_rwset_pb2.KVMetadataEntry(
                    name=VALIDATION_PARAMETER, value=v)])
                for k, v in meta_writes])
        return rwset_pb2.TxReadWriteSet(ns_rwset=[
            rwset_pb2.NsReadWriteSet(namespace=ns, rwset=kv.SerializeToString())
            for ns in (namespaces or [CC])]).SerializeToString()

    def tx(self, endorsers=(0, 1), results=None, events=b"", cc=CC,
           action_cc=None, bad_creator=False, bad_endorsements=()) -> bytes:
        self.n += 1
        prop, _ = protoutil.create_chaincode_proposal(
            self.client.serialize(), CH, cc, [b"k%d" % self.n, b"v"])
        if results is None:
            results = self.rwset(writes=[f"k{self.n}"])
        resps = []
        for j in endorsers:
            resp = protoutil.create_proposal_response(
                prop, results, events, proposal_pb2.Response(status=200),
                chaincode_pb2.ChaincodeID(name=action_cc or cc), self.peers[j])
            if j in bad_endorsements:
                resp.endorsement.signature = self.peers[j].sign(b"other")
            resps.append(resp)
        env = protoutil.create_signed_tx(prop, self.client, resps)
        if bad_creator:
            env.signature = self.client.sign(b"other")
        return env.SerializeToString()

    def config_tx(self) -> bytes:
        chdr = protoutil.make_channel_header(common_pb2.CONFIG, CH)
        shdr = protoutil.make_signature_header(self.client.serialize(),
                                               protoutil.random_nonce())
        payload = protoutil.make_payload_bytes(chdr, shdr, b"config")
        return protoutil.make_envelope(payload, self.client).SerializeToString()


@pytest.fixture(scope="module")
def world():
    return World()


def _block(envs, num=1) -> bytes:
    blk = common_pb2.Block()
    blk.header.number = num
    blk.data.data.extend(envs)
    blk.header.data_hash = protoutil.block_data_hash(blk.data)
    protoutil.init_block_metadata(blk)
    return blk.SerializeToString()


class Definitions:
    """Committed chaincode definitions: per namespace (plugin name,
    ApplicationPolicy bytes), per (namespace, collection) a
    StaticCollectionConfig's bytes, read with `decode`."""

    def __init__(self, info, colls, decode):
        self.info = info
        self.colls = colls
        self.decode = decode

    def validation_info(self, ns):
        return self.info.get(ns)

    def collection_config(self, ns, coll):
        raw = self.colls.get((ns, coll))
        return None if raw is None else self.decode(raw)


def _both(world, blocks, ledger=(), metadata=None, depth=None,
          min_device_batch=16, faithful=False, definitions=None):
    """Flags and TRANSACTIONS_FILTERs of both validators; `depth` None is
    `validate` block by block.  `definitions` is (info, colls)."""
    jax_defs = port_defs = None
    if definitions is not None:
        jax_defs = Definitions(*definitions,
                               collection_pb2.StaticCollectionConfig.FromString)
        port_defs = Definitions(*definitions,
                                port_peer.StaticCollectionConfig.decode)
    jax_v = JaxValidator(CH, Ledger(ledger, metadata), world.bundle, world.csp,
                         definition_provider=jax_defs, faithful=faithful)
    port_v = PortValidator(CH, Ledger(ledger, metadata), world.port_bundle,
                           CUDACSP(device="cpu",
                                   min_device_batch=min_device_batch),
                           definition_provider=port_defs, faithful=faithful)
    jax_blocks = [common_pb2.Block.FromString(b) for b in blocks]
    port_blocks = [port_common.Block.decode(b) for b in blocks]
    if depth is None:
        jf = [jax_v.validate(b) for b in jax_blocks]
        pf = [port_v.validate(b) for b in port_blocks]
    else:
        jf = list(jax_v.validate_pipeline(jax_blocks, depth=depth))
        pf = list(port_v.validate_pipeline(port_blocks, depth=depth))
    assert pf == jf
    for jb, pb in zip(jax_blocks, port_blocks):
        assert pb.metadata.metadata[2] == jb.metadata.metadata[2]
        assert pb.metadata.metadata[2] == bytes(jf[jax_blocks.index(jb)])
    return jf


def _crafted(world):
    """(envelope, expected flag) for every flag of the path."""
    ok = world.tx()
    out = [
        (ok, V.VALID),
        (world.tx(endorsers=(0, 1, 2), bad_endorsements=(2,)), V.VALID),
        (b"", V.NIL_ENVELOPE),
        (common_pb2.Envelope(signature=b"s").SerializeToString(),
         V.NIL_ENVELOPE),
        (b"\x0a\x03abc", V.BAD_PAYLOAD),
        (common_pb2.Envelope(payload=b"\x0a\x05ab").SerializeToString(),
         V.BAD_PAYLOAD),
        (world.tx(bad_creator=True), V.BAD_CREATOR_SIGNATURE),
        (ok, V.DUPLICATE_TXID),
        (world.tx(endorsers=(0,)), V.ENDORSEMENT_POLICY_FAILURE),
        (world.tx(endorsers=(0, 1), bad_endorsements=(1,)),
         V.ENDORSEMENT_POLICY_FAILURE),
        (world.tx(results=world.rwset(writes=["a"], namespaces=[CC, CC])),
         V.ILLEGAL_WRITESET),
        (world.tx(results=b"\x0a\x09garbage"), V.BAD_RWSET),
        (world.tx(events=chaincode_event_pb2.ChaincodeEvent(
            chaincode_id="other").SerializeToString()),
         V.INVALID_OTHER_REASON),
        (world.tx(action_cc="othercc"), V.INVALID_CHAINCODE),
        (world.config_tx(), V.VALID),
    ]
    return out


@pytest.mark.parametrize("depth", [None, 1, 3], ids=["validate", "depth1",
                                                     "depth3"])
def test_crafted_blocks_set_every_flag_as_the_reference(world, depth):
    crafted = _crafted(world)
    envs = [e for e, _ in crafted]
    # a second block repeats two txids of the first (in flight at depth 3)
    second = [world.tx(), envs[0], envs[1]]
    third = [world.tx(endorsers=(0, 1, 2)) for _ in range(5)]
    flags = _both(world, [_block(envs, 1), _block(second, 2),
                          _block(third, 3)], depth=depth)
    assert flags[0] == [f for _, f in crafted]
    assert flags[2] == [V.VALID] * 5
    if depth is None or depth == 1:
        # validated one after another, no block is in flight with the first
        assert flags[1] == [V.VALID, V.VALID, V.VALID]
    else:
        assert flags[1] == [V.VALID, V.DUPLICATE_TXID, V.DUPLICATE_TXID]


def test_ledger_double_with_a_committed_txid_and_a_key_level_policy(world):
    committed = world.tx()
    committed_txid = common_pb2.ChannelHeader.FromString(
        common_pb2.Payload.FromString(common_pb2.Envelope.FromString(
            committed).payload).header.channel_header).tx_id
    org3_peer = from_string("'Org3MSP.peer'").SerializeToString()
    metadata = {(CC, "sbe-key"): {VALIDATION_PARAMETER: org3_peer}}
    sbe = world.rwset(writes=["sbe-key"])
    envs = [
        committed,
        world.tx(results=sbe),  # Org1 and Org2: not Org3's peer
        world.tx(endorsers=(2,), results=sbe),  # Org3 alone satisfies it
        world.tx(endorsers=(0, 1), results=world.rwset(
            writes=["other"], meta_writes=[("other", org3_peer)])),
        world.tx(endorsers=(0, 1), results=world.rwset(
            meta_writes=[("other", org3_peer)])),
    ]
    for depth in (None, 3):
        flags = _both(world, [_block(envs)], ledger=[committed_txid],
                      metadata=metadata, depth=depth)
        assert flags[0] == [V.DUPLICATE_TXID, V.ENDORSEMENT_POLICY_FAILURE,
                            V.VALID, V.VALID, V.ENDORSEMENT_POLICY_FAILURE]


def _app_policy(dsl=None, ref=None) -> bytes:
    if dsl is not None:
        return collection_pb2.ApplicationPolicy(
            signature_policy=from_string(dsl)).SerializeToString()
    return collection_pb2.ApplicationPolicy(
        channel_config_policy_reference=ref).SerializeToString()


def test_chaincode_and_collection_level_policies_as_the_reference(world):
    """Chaincode-level validation parameters (an inline policy and a
    channel-policy reference), a collection's endorsement policy, an
    unparsable parameter and an unknown plugin."""
    info = {
        CC: ("vscc", _app_policy("'Org3MSP.peer'")),
        "refcc": ("", _app_policy(ref="/Channel/Application/Org1/Endorsement")),
        "junkcc": ("vscc", b"\x0a\x05ab"),
        "plugcc": ("no-such-plugin", b""),
    }
    colls = {(CC, "coll1"): collection_pb2.StaticCollectionConfig(
        name="coll1", endorsement_policy=collection_pb2.ApplicationPolicy(
            signature_policy=from_string("'Org1MSP.peer'"))).SerializeToString()}

    def coll_rwset(coll):
        hashed = kv_rwset_pb2.HashedRWSet(hashed_writes=[
            kv_rwset_pb2.KVWriteHash(key_hash=b"\x01" * 32,
                                     value_hash=b"\x02" * 32)])
        return rwset_pb2.TxReadWriteSet(ns_rwset=[rwset_pb2.NsReadWriteSet(
            namespace=CC, rwset=kv_rwset_pb2.KVRWSet().SerializeToString(),
            collection_hashed_rwset=[rwset_pb2.CollectionHashedReadWriteSet(
                collection_name=coll,
                hashed_rwset=hashed.SerializeToString())])]).SerializeToString()

    envs = [
        (world.tx(endorsers=(0, 1)), V.ENDORSEMENT_POLICY_FAILURE),
        (world.tx(endorsers=(2,)), V.VALID),
        (world.tx(endorsers=(0,), cc="refcc",
                  results=world.rwset(writes=["r"], namespaces=["refcc"])),
         V.VALID),
        (world.tx(endorsers=(1,), cc="refcc",
                  results=world.rwset(writes=["r"], namespaces=["refcc"])),
         V.ENDORSEMENT_POLICY_FAILURE),
        (world.tx(endorsers=(0, 1, 2), cc="junkcc",
                  results=world.rwset(writes=["j"], namespaces=["junkcc"])),
         V.VALID),  # no usable parameter: the channel's MAJORITY
        (world.tx(endorsers=(0,), cc="plugcc",
                  results=world.rwset(writes=["p"], namespaces=["plugcc"])),
         V.INVALID_OTHER_REASON),
        (world.tx(endorsers=(0,), results=coll_rwset("coll1")), V.VALID),
        (world.tx(endorsers=(1,), results=coll_rwset("coll1")),
         V.ENDORSEMENT_POLICY_FAILURE),
        (world.tx(endorsers=(2,), results=coll_rwset("coll2")), V.VALID),
    ]
    flags = _both(world, [_block([e for e, _ in envs])],
                  definitions=(info, colls))
    assert flags[0] == [f for _, f in envs]


def test_faithful_mode_sets_the_same_flags(world):
    crafted = _crafted(world)
    flags = _both(world, [_block([e for e, _ in crafted])], faithful=True)
    assert flags[0] == [f for _, f in crafted]


def _byte_mutants(rng: random.Random, base: bytes, n: int) -> list[bytes]:
    out = []
    for _ in range(n):
        kind = rng.randrange(4)
        b = bytearray(base)
        if kind == 0:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif kind == 1:
            b = b[:rng.randrange(len(b))]
        elif kind == 2:
            i = rng.randrange(len(b) + 1)
            b[i:i] = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 9)))
        else:
            i = rng.randrange(len(b) - 1)
            j = rng.randrange(i + 1, min(len(b), i + 64))
            b = b[:j] + b[i:j] + b[j:]
        out.append(bytes(b))
    return out


def _wire_mutants(rng: random.Random, base: bytes, n: int) -> list[bytes]:
    out = []
    for _ in range(n):
        env = common_pb2.Envelope.FromString(base)
        p = common_pb2.Payload.FromString(env.payload)
        target = rng.randrange(6)
        junk = bytes(rng.randrange(256) for _ in range(rng.randrange(24)))
        if target == 0:
            env.payload = junk
        elif target == 1:
            env.signature = junk
        elif target == 2:
            p.header.channel_header = junk
        elif target == 3:
            p.header.signature_header = junk
        elif target == 4:
            p.data = junk
        else:
            tx = transaction_pb2.Transaction.FromString(p.data)
            tx.actions[0].payload = junk
            p.data = tx.SerializeToString()
        if target >= 2:
            env.payload = p.SerializeToString()
        out.append(env.SerializeToString())
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_fuzzed_envelopes_flag_as_the_reference(world, seed):
    rng = random.Random(3000 + seed)
    base = world.tx()
    batch = [world.tx()] + _byte_mutants(rng, base, 40) + \
        _wire_mutants(rng, base, 16)
    rng.shuffle(batch)
    flags = _both(world, [_block(batch)], min_device_batch=1 << 30)
    assert flags[0].count(V.VALID) >= 1
    assert len(set(flags[0])) >= 4


def test_validator_raises_when_the_native_library_cannot_build(world,
                                                               monkeypatch):
    def fail():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    v = PortValidator(CH, Ledger(), world.port_bundle,
                      CUDACSP(device="cpu"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        v.validate(_block([world.tx()]))
