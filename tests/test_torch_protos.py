"""The port's wire codec (`fabric_tpu_torch/protos`) against protobuf.

For every schema of the port: its fields match the `_pb2` descriptor; a
seeded `_pb2` message's bytes decode in the port and encode back byte for
byte; and the port's encoding of the same message parses in `_pb2` to an
equal message.  A malformed corpus (hand-made cases of every decoder rule,
every truncation and seeded byte mutations of valid messages) raises in
the port exactly where `FromString` raises, and what both accept encodes
to the same message.
"""

import random

import pytest

from google.protobuf import timestamp_pb2
from google.protobuf.descriptor import FieldDescriptor as FD

from fabric_tpu.protos.common import (
    common_pb2,
    configtx_pb2,
    configuration_pb2,
    ledger_pb2,
    policies_pb2,
)
from fabric_tpu.protos.ledger.rwset import rwset_pb2
from fabric_tpu.protos.ledger.rwset.kvrwset import kv_rwset_pb2
from fabric_tpu.protos.discovery import protocol_pb2 as discovery_pb2
from fabric_tpu.protos.gossip import message_pb2 as gossip_pb2
from fabric_tpu.protos.msp import identities_pb2, msp_config_pb2, msp_principal_pb2
from fabric_tpu.protos.orderer import ab_pb2
from fabric_tpu.protos.orderer import configuration_pb2 as orderer_pb2
from fabric_tpu.protos.orderer import raft_pb2
from fabric_tpu.protos.peer import configuration_pb2 as peer_config_pb2
from fabric_tpu.protos.peer import (
    chaincode_event_pb2,
    chaincode_pb2,
    chaincode_shim_pb2,
    collection_pb2,
    events_pb2,
    lifecycle_pb2,
    proposal_pb2,
    proposal_response_pb2,
    query_pb2,
    transaction_pb2,
)
from fabric_tpu_torch.protos import (
    common,
    discovery,
    gossip,
    lifecycle,
    msp,
    orderer,
    peer,
    rwset,
    wire,
)

_PB2 = {
    common: (common_pb2, configtx_pb2, configuration_pb2, policies_pb2,
             msp_principal_pb2, timestamp_pb2, ledger_pb2),
    msp: (identities_pb2, msp_config_pb2),
    peer: (chaincode_pb2, chaincode_event_pb2, proposal_pb2,
           proposal_response_pb2, transaction_pb2, collection_pb2,
           chaincode_shim_pb2, events_pb2, peer_config_pb2, query_pb2),
    rwset: (rwset_pb2, kv_rwset_pb2),
    orderer: (orderer_pb2, raft_pb2, ab_pb2),
    lifecycle: (lifecycle_pb2,),
    gossip: (gossip_pb2,),
    discovery: (discovery_pb2,),
}


def _classes(pb2) -> dict:
    """A `_pb2` module's message classes by name, those nested one level
    in another message too (unless a top-level one has the name)."""
    out = {}
    for name, desc in pb2.DESCRIPTOR.message_types_by_name.items():
        outer = getattr(pb2, name)
        for nested in desc.nested_types:
            if not nested.GetOptions().map_entry:
                out.setdefault(nested.name, getattr(outer, nested.name))
    for name in pb2.DESCRIPTOR.message_types_by_name:
        out[name] = getattr(pb2, name)
    return out


def _pairs():
    out = []
    for module, pb2s in _PB2.items():
        for name, cls in vars(module).items():
            if not (isinstance(cls, type) and issubclass(cls, wire.Message)
                    and cls.__module__ == module.__name__):
                continue
            if name == "NOutOf":
                out.append((cls, policies_pb2.SignaturePolicy.NOutOf))
                continue
            found = [_classes(m)[name] for m in pb2s if name in _classes(m)]
            assert len(found) == 1, (module.__name__, name)
            out.append((cls, found[0]))
    return out


PAIRS = _pairs()
IDS = [f"{p.__module__.rsplit('.', 1)[1]}.{p.__name__}" for p, _ in PAIRS]

_KIND = {
    FD.TYPE_INT32: wire.INT32, FD.TYPE_INT64: wire.INT64,
    FD.TYPE_UINT32: wire.UINT32, FD.TYPE_UINT64: wire.UINT64,
    FD.TYPE_BOOL: wire.BOOL, FD.TYPE_ENUM: wire.ENUM,
    FD.TYPE_STRING: wire.STRING, FD.TYPE_BYTES: wire.BYTES,
    FD.TYPE_MESSAGE: wire.MESSAGE,
}


def _is_map(f) -> bool:
    return f.message_type is not None and f.message_type.GetOptions().map_entry


def _has_map(desc, seen=None) -> bool:
    seen = set() if seen is None else seen
    if desc.full_name in seen:
        return False
    seen.add(desc.full_name)
    return any(_is_map(f) or (f.message_type is not None
                              and _has_map(f.message_type, seen))
               for f in desc.fields)


def _rand_scalar(rng: random.Random, f):
    t = f.type
    if t == FD.TYPE_INT32:
        return rng.choice([0, 1, -1, rng.randrange(-2**31, 2**31)])
    if t == FD.TYPE_INT64:
        return rng.choice([0, -1, rng.randrange(-2**63, 2**63)])
    if t == FD.TYPE_UINT32:
        return rng.choice([0, 1, rng.randrange(2**32)])
    if t == FD.TYPE_UINT64:
        return rng.choice([0, 300, rng.randrange(2**64)])
    if t == FD.TYPE_BOOL:
        return rng.random() < 0.5
    if t == FD.TYPE_ENUM:
        return rng.choice([v.number for v in f.enum_type.values])
    if t == FD.TYPE_STRING:
        return "".join(rng.choice("abé中\U0001f600")
                       for _ in range(rng.randrange(6)))
    return bytes(rng.randrange(256) for _ in range(rng.randrange(8)))


def _fill(msg, rng: random.Random, depth: int = 0):
    """Random values in a random subset of the fields (one member per
    oneof, nesting to depth 3)."""
    oneofs_done = set()
    for f in msg.DESCRIPTOR.fields:
        if rng.random() < 0.3:
            continue
        if f.containing_oneof is not None:
            if f.containing_oneof.name in oneofs_done:
                continue
            oneofs_done.add(f.containing_oneof.name)
        if f.type == FD.TYPE_MESSAGE and depth >= 3:
            continue
        field = getattr(msg, f.name)
        if _is_map(f):
            vf = f.message_type.fields_by_name["value"]
            for _ in range(rng.randrange(3)):
                key = _rand_scalar(rng, f.message_type.fields_by_name["key"])
                if vf.type == FD.TYPE_MESSAGE:
                    _fill(field[key], rng, depth + 1)
                else:
                    field[key] = _rand_scalar(rng, vf)
        elif f.is_repeated:
            for _ in range(rng.randrange(4)):
                if f.type == FD.TYPE_MESSAGE:
                    _fill(field.add(), rng, depth + 1)
                else:
                    field.append(_rand_scalar(rng, f))
        elif f.type == FD.TYPE_MESSAGE:
            field.SetInParent()
            _fill(field, rng, depth + 1)
        else:
            setattr(msg, f.name, _rand_scalar(rng, f))
    return msg


def _port_of(pb2_cls):
    for port_cls, cls in PAIRS:
        if cls.DESCRIPTOR.full_name == pb2_cls.DESCRIPTOR.full_name:
            return port_cls
    raise KeyError(pb2_cls.DESCRIPTOR.full_name)


def _to_port(msg, port_cls):
    """The port message with the same field values, built through its
    constructor (not its decoder)."""
    kw = {}
    for f in msg.DESCRIPTOR.fields:
        v = getattr(msg, f.name)
        if _is_map(f):
            vf = f.message_type.fields_by_name["value"]
            kw[f.name] = {
                k: (_to_port(x, _port_of(type(x))) if vf.message_type else x)
                for k, x in v.items()}
        elif f.is_repeated:
            kw[f.name] = [_to_port(x, _port_of(type(x))) if f.message_type
                          else x for x in v]
        elif f.message_type is not None:
            if msg.HasField(f.name):
                kw[f.name] = _to_port(v, _port_of(type(v)))
        elif f.has_presence:
            if msg.HasField(f.name):
                kw[f.name] = v
        else:
            kw[f.name] = v
    return port_cls(**kw)


@pytest.mark.parametrize("port_cls,pb2_cls", PAIRS, ids=IDS)
def test_schema_fields_match_the_pb2_descriptor(port_cls, pb2_cls):
    want = []
    for f in pb2_cls.DESCRIPTOR.fields:
        if _is_map(f):
            kf = f.message_type.fields_by_name["key"]
            vf = f.message_type.fields_by_name["value"]
            want.append((f.number, f.name, "map", _KIND[kf.type],
                         _KIND[vf.type]))
        else:
            want.append((f.number, f.name, f.is_repeated,
                         _KIND[f.type], f.containing_oneof is not None))
    got = []
    for f in port_cls._fields:
        if f.key is not None:
            got.append((f.num, f.name, "map", f.key, f.value))
        else:
            got.append((f.num, f.name, f.repeated, f.kind,
                        f.oneof is not None))
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("port_cls,pb2_cls", PAIRS, ids=IDS)
def test_seeded_messages_round_trip_byte_for_byte(port_cls, pb2_cls):
    rng = random.Random(f"round-trip:{pb2_cls.DESCRIPTOR.full_name}")
    for _ in range(12):
        msg = _fill(pb2_cls(), rng)
        raw = msg.SerializeToString()
        assert port_cls.decode(raw).encode() == raw
        built = _to_port(msg, port_cls).encode()
        assert pb2_cls.FromString(built) == msg
        if not _has_map(pb2_cls.DESCRIPTOR):
            assert built == raw


def test_defaults_presence_and_oneofs():
    env = common.Envelope()
    assert env.payload == b"" and not env.has("payload")
    assert common.Payload().header.channel_header == b""
    assert not common.Payload().has("header")
    pol = common.SignaturePolicy(signed_by=0)
    assert pol.which("Type") == "signed_by" and pol.encode() == b"\x08\x00"
    pol = common.SignaturePolicy.decode(b"\x08\x01\x12\x00")
    assert pol.which("Type") == "n_out_of" and "signed_by" not in pol.__dict__
    assert rwset.KVWrite(is_delete=False).encode() == b""
    with pytest.raises(TypeError):
        common.Envelope(payloads=b"")


# -- the malformed corpus ----------------------------------------------------

_HAND = [
    # (pb2 class, bytes): one case per decoder rule
    (common_pb2.Envelope, b"\x08\x05"),  # varint on a bytes field: unknown
    (common_pb2.Envelope, b"\x0d\x01\x02\x03\x04"),  # fixed32 on bytes
    (common_pb2.Envelope, b"\x09" + b"\x00" * 8),  # fixed64 on bytes
    (common_pb2.ChannelHeader, b"\x0a\x02ab"),  # length on an int field
    (common_pb2.Envelope, b"\x1b\x08\x01\x1c"),  # an unknown group
    (common_pb2.Envelope, b"\x0b\x08\x01\x0c"),  # a group on a known field
    (common_pb2.Envelope, b"\x1b\x23\x24\x1c"),  # nested groups
    (common_pb2.Envelope, b"\x0c"),  # end group alone
    (common_pb2.Envelope, b"\x1b\x08\x01"),  # unterminated group
    (common_pb2.Envelope, b"\x1b\x08\x01\x24"),  # mismatched end group
    (common_pb2.Envelope, b"\x1b\x23\x1c\x24"),  # interleaved groups
    (common_pb2.Envelope, b"\x1b\x00\x00\x1c"),  # field 0 inside a group
    (common_pb2.Envelope, b"\x1b\x0f\x1c"),  # wire type 7 inside a group
    (common_pb2.Payload, b"\x0a\x01\x0c"),  # end group in a submessage
    (common_pb2.Envelope, b"\x0e"),  # wire type 6
    (common_pb2.Envelope, b"\x0f"),  # wire type 7
    (common_pb2.Envelope, b"\x02\x00"),  # field 0
    (common_pb2.Envelope, b"\xf8\xff\xff\xff\x0f\x00"),  # field 2^29 - 1
    (common_pb2.Envelope, b"\x80\x80\x80\x80\x10\x00"),  # field 2^29
    (common_pb2.Envelope, b"\x8a\x80\x80\x80\x80\x80\x80\x80\x80\x00\x00"),
    (common_pb2.Envelope, b"\x8a\x80\x00\x00"),  # a 3-byte tag for field 1
    (common_pb2.ChannelHeader, b"\x08\xff"),  # truncated varint
    (common_pb2.Envelope, b"\x0a\x05ab"),  # truncated length
    (common_pb2.Envelope, b"\x1d\x01\x02"),  # truncated fixed32
    (common_pb2.Envelope, b"\x19\x01\x02"),  # truncated fixed64
    (common_pb2.ChannelHeader, b"\x08" + b"\xff" * 10 + b"\x01"),  # 11 bytes
    (common_pb2.ChannelHeader, b"\x08" + b"\xff" * 9 + b"\x01"),  # -1
    (common_pb2.ChannelHeader, b"\x08\xff\xff\xff\xff\x0f"),  # int32 -1
    (common_pb2.ChannelHeader, b"\x30" + b"\xff" * 9 + b"\x01"),  # 2^64 - 1
    (common_pb2.ChannelHeader, b"\x30" + b"\xff" * 9 + b"\x02"),  # overflow
    (common_pb2.ChannelHeader, b"\x30" + b"\xff" * 9 + b"\x80"),
    (common_pb2.Envelope, b"\x0a\x80\x80\x80\x80\x80\x80\x80\x80\x80\x00"),
    (common_pb2.Envelope, b"\x0a\xff\xff\xff\xff\x0f"),  # huge length
    (common_pb2.Envelope, b"\x0a" + b"\xff" * 9 + b"\x01"),  # negative
    (common_pb2.ChannelHeader, b"\x22\x02\xc3\x28"),  # bad UTF-8
    (common_pb2.ChannelHeader, b"\x22\x03\xed\xa0\x80"),  # a surrogate
    (common_pb2.ChannelHeader, b"\x22\x02\xc0\xaf"),  # overlong
    (common_pb2.ChannelHeader, b"\x22\x04\xf4\x90\x80\x80"),  # > U+10FFFF
    (common_pb2.ChannelHeader, b"\x08\x01\x08\x03"),  # last one wins
    (common_pb2.Envelope, b"\x0a\x01a\x18\x05\x12\x01b"),  # unknown kept
    (common_pb2.Envelope, b"\x18\x05\x0a\x01a"),
    (common_pb2.Payload, b"\x0a\x02\x0a\x00\x0a\x02\x12\x00"),  # merge
    (common_pb2.Payload, b"\x0a\x03\x0a\x01x\x0a\x03\x12\x01y"),
    (common_pb2.Block, b"\x12\x03\x0a\x01a\x12\x03\x0a\x01b"),
    (common_pb2.Payload, b"\x0a\x02\x08\xff"),  # a bad nested message
    (common_pb2.ChannelHeader, b"\x1a\x02\x08\x80"),  # a bad Timestamp
    (common_pb2.Payload, b"\x08\x01"),  # varint on a message field
    (common_pb2.BlockData, b"\x08\x01"),
    (kv_rwset_pb2.KVWrite, b"\x10\x02"),  # bool 2
    (kv_rwset_pb2.KVWrite, b"\x10" + b"\xff" * 9 + b"\x01"),
    (kv_rwset_pb2.KVWrite, b"\x10\x00\x0a\x00"),  # explicit defaults
    (policies_pb2.SignaturePolicy, b"\x08\x00"),
    (policies_pb2.SignaturePolicy, b"\x08\x01\x12\x00"),  # oneof switch
    (policies_pb2.SignaturePolicy, b"\x12\x00\x08\x01"),
    (orderer_pb2.BatchSize, b"\x08\xff\xff\xff\xff\x1f"),  # uint32 wraps
    (orderer_pb2.BatchSize, b"\x08" + b"\xff" * 9 + b"\x01"),
    (orderer_pb2.ConsensusType, b"\x18\x07"),  # open enum
    (orderer_pb2.ConsensusType, b"\x18" + b"\xff" * 9 + b"\x01"),
    (orderer_pb2.ConsensusType, b"\x08\x01"),  # varint on a string field
    (raft_pb2.SnapshotMeta, b"\x1a\x03\x01\x02\x03"),  # packed
    (raft_pb2.SnapshotMeta, b"\x18\x01\x18\x02"),  # unpacked
    (raft_pb2.SnapshotMeta, b"\x18\x05\x1a\x02\x01\x02\x18\x09"),  # mixed
    (raft_pb2.SnapshotMeta, b"\x1a\x00"),
    (raft_pb2.SnapshotMeta, b"\x1a\x02\x80"),  # truncated packed run
    (configtx_pb2.ConfigGroup, b"\x1a\x04\x12\x02\x08\x01"),  # no map key
    (configtx_pb2.ConfigGroup, b"\x1a\x03\x0a\x01k"),  # no map value
    (configtx_pb2.ConfigGroup, b"\x1a\x00"),  # an empty entry
    (configtx_pb2.ConfigGroup,  # a repeated key: last wins
     b"\x1a\x07\x0a\x01k\x12\x02\x08\x01\x1a\x07\x0a\x01k\x12\x02\x08\x02"),
    (configtx_pb2.ConfigGroup, b"\x1a\x05\x0a\x01k\x18\x01"),  # entry unknown
    (configtx_pb2.ConfigGroup, b"\x1a\x09\x0a\x01k\x12\x02\x08\x01\x18\x01"),
    (configtx_pb2.ConfigGroup, b"\x1a\x04\x08\x01\x12\x00"),  # key wrong type
    (configtx_pb2.ConfigGroup, b"\x1a\x05\x0a\x01k\x10\x01"),
    (configtx_pb2.ConfigGroup, b"\x1a\x05\x0a\x01k\x1b\x1c"),  # entry group
    (configtx_pb2.ConfigGroup, b"\x1a\x04\x0a\x02\xc3\x28"),  # bad key UTF-8
    (configtx_pb2.ConfigGroup, b"\x1a\x06\x0a\x01k\x12\x01\x08"),
    (configtx_pb2.ConfigGroup, b"\x1a\x07\x12\x02\x08\x01\x0a\x01k"),
    (configtx_pb2.ConfigGroup, b"\x1a\x0b\x0a\x01k\x12\x02\x08\x01\x12\x02\x08\x02"),
    (configtx_pb2.ConfigGroup, b"\x1a\x07\x0a\x01k\x12\x00\x12\x00"),
    (configtx_pb2.ConfigGroup, b"\x12\x0b\x0a\x01k\x12\x02\x1a\x00\x12\x02\x1a\x00"),
    (proposal_pb2.ChaincodeProposalPayload, b"\x12\x05\x0a\x01k\x12\x00"),
    (proposal_pb2.ChaincodeProposalPayload, b"\x12\x09\x0a\x01k\x12\x01a\x12\x01b"),
    (proposal_pb2.ChaincodeProposalPayload, b"\x12\x03\x0a\x01k\x12\x00"),
]


def _outcome(pb2_cls, raw: bytes):
    """(pb2's canonical re-encoding or None, the port's or None)."""
    try:
        want = pb2_cls.FromString(raw).SerializeToString(deterministic=True)
    except Exception:
        want = None
    try:
        port = _port_of(pb2_cls).decode(raw).encode()
    except wire.DecodeError:
        return want, None
    # canonical form through pb2, so map order does not count
    return want, pb2_cls.FromString(port).SerializeToString(deterministic=True)


def test_hand_corpus_raises_exactly_where_protobuf_raises():
    for pb2_cls, raw in _HAND:
        want, got = _outcome(pb2_cls, raw)
        assert (want is None) == (got is None), (pb2_cls.__name__, raw)
        assert want == got, (pb2_cls.__name__, raw)
    # the corpus has both outcomes
    assert sum(_outcome(c, r)[0] is None for c, r in _HAND) >= 20


def _mutants(rng: random.Random, base: bytes, n: int):
    for _ in range(n):
        b = bytearray(base)
        kind = rng.randrange(4)
        if kind == 0 and b:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif kind == 1 and b:
            i = rng.randrange(len(b))
            b[i] = rng.randrange(256)
        elif kind == 2:
            i = rng.randrange(len(b) + 1)
            b[i:i] = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 5)))
        elif len(b) >= 2:
            i = rng.randrange(len(b) - 1)
            del b[i:rng.randrange(i + 1, len(b))]
        yield bytes(b)


_MUTATED = (common_pb2.Envelope, common_pb2.Payload, common_pb2.ChannelHeader,
            common_pb2.Block, configtx_pb2.ConfigGroup,
            policies_pb2.SignaturePolicyEnvelope, transaction_pb2.Transaction,
            transaction_pb2.ChaincodeActionPayload, proposal_pb2.ChaincodeAction,
            proposal_pb2.ChaincodeProposalPayload, rwset_pb2.TxReadWriteSet,
            kv_rwset_pb2.KVRWSet, kv_rwset_pb2.HashedRWSet,
            msp_config_pb2.FabricMSPConfig, raft_pb2.SnapshotMeta,
            gossip_pb2.GossipMessage, gossip_pb2.ConnEstablish,
            discovery_pb2.Request, discovery_pb2.QueryResult)


@pytest.mark.parametrize("pb2_cls", _MUTATED,
                         ids=[c.DESCRIPTOR.full_name for c in _MUTATED])
def test_truncations_and_mutations_match_protobuf(pb2_cls):
    rng = random.Random(f"mutate:{pb2_cls.DESCRIPTOR.full_name}")
    raised = accepted = 0
    for _ in range(4):
        base = _fill(pb2_cls(), rng).SerializeToString()
        cases = [base[:k] for k in range(len(base))]
        cases += list(_mutants(rng, base, 150))
        for raw in cases:
            want, got = _outcome(pb2_cls, raw)
            assert want == got, (pb2_cls.__name__, raw.hex())
            raised += want is None
            accepted += want is not None
    assert raised and accepted
