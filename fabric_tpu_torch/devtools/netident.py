"""netident — the netharness's stdlib-only network identity plane (the
port's copy of `fabric_tpu/devtools/netident.py`: every node derives the
same bytes as the reference's from the channel id alone).

The multi-process network harness (``devtools/netharness.py`` +
``devtools/netnode.py``) must run in minimal containers WITHOUT the
``cryptography`` package, the same constraint tests/test_parallel_commit
and tests/gossip_worker already live under.  This module packages that
established fake-world pattern once, for every netharness consumer:

- a deterministic hash-derived key/signature scheme (``key_of`` /
  ``sign_as``) driving the REAL TxValidator through ``FakeBundle`` /
  ``FakeCSP`` — signatures verify iff they were produced by
  ``sign_as`` for the claimed identity, so the endorsement-policy and
  creator-signature lanes stay live;
- an HMAC-style gossip MessageCryptoService (``NetMCS``) keyed by a
  shared network secret, the multi-process analogue of the
  ``gossip_worker.ToyMCS`` pattern;
- deterministic genesis-block and endorser-envelope builders
  (``make_genesis`` / ``make_tx``) so every node of a topology derives
  the byte-identical chain anchor from the channel id alone.

This plane fakes IDENTITY only.  Everything else in a netharness
topology — raft ordering, TCP transports, gossip dissemination, the
commit pipeline, ledger recovery — is the production code.
"""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.csp.api import VerifyBatchItem
from fabric_tpu_torch.gossip.comm import MessageCryptoService
from fabric_tpu_torch.ledger.kvstore import MemKVStore
from fabric_tpu_torch.ledger.statedb import VersionedDB
from fabric_tpu_torch.ledger.txmgmt import TxSimulator
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import peer as pb


# -- hash-derived keys & signatures -------------------------------------------


class FakeKey:
    """Hash-derived public key carrying the .x/.y ints the validator's
    _ItemSink dedup key and the device marshaling layer expect."""

    __slots__ = ("x", "y")

    def __init__(self, x: int, y: int):
        self.x = x
        self.y = y

    def __eq__(self, other):
        return (self.x, self.y) == (other.x, other.y)

    def __hash__(self):
        return hash((self.x, self.y))


def key_of(ident_bytes: bytes) -> FakeKey:
    h = sha256(b"key:" + ident_bytes)
    return FakeKey(
        int.from_bytes(h[:16], "big"), int.from_bytes(h[16:], "big")
    )


def sign_as(ident_bytes: bytes, digest: bytes) -> bytes:
    k = key_of(ident_bytes)
    return sha256(b"sig:%d:%d:" % (k.x, k.y) + digest)


def _sig_ok(key: FakeKey, digest: bytes, sig: bytes) -> bool:
    return bytes(sig) == sha256(
        b"sig:%d:%d:" % (key.x, key.y) + bytes(digest)
    )


class FakeIdentity:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.public_key = key_of(raw)

    def verification_item(self, msg: bytes, sig: bytes) -> VerifyBatchItem:
        return VerifyBatchItem(self.public_key, sha256(msg), sig)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return _sig_ok(self.public_key, sha256(msg), sig)


class FakeMSPManager:
    def deserialize_identity(self, raw: bytes) -> FakeIdentity:
        if bytes(raw).startswith(b"badid"):
            raise ValueError("unknown identity")
        return FakeIdentity(bytes(raw))

    def validate(self, ident: FakeIdentity) -> None:
        pass


class _FakePending:
    def __init__(self, items: list, k: int):
        self.items = items
        self._k = k

    def finish(self, mask) -> bool:
        return sum(bool(m) for m in mask) >= self._k


class FakePolicy:
    """k-of-n policy speaking BOTH policy interfaces the stack uses:
    the validator's two-phase prepare/finish batch protocol and the
    deliver service's evaluate_signed_data."""

    def __init__(self, k: int):
        self._k = k

    def prepare(self, signed) -> _FakePending:
        items = [
            VerifyBatchItem(
                key_of(bytes(sd.identity)),
                sd.digest if sd.digest is not None else sha256(sd.data),
                sd.signature,
            )
            for sd in signed
        ]
        return _FakePending(items, self._k)

    def evaluate_signed_data(self, signed, csp) -> bool:
        ok = 0
        for sd in signed:
            if not sd.identity:
                continue  # netharness deliver clients sign with no creator
            if _sig_ok(
                key_of(bytes(sd.identity)), sha256(sd.data), sd.signature
            ):
                ok += 1
        # deliver access is gated at 1-of-any (the reference's Readers
        # policy role); endorsement keeps the k-of-n bar via prepare()
        return ok >= 1


class FakePolicyManager:
    def __init__(self, k: int = 2):
        self._policy = FakePolicy(k)

    def get_policy(self, name: str) -> FakePolicy:
        return self._policy


class _FakeConfig:
    sequence = 0


class FakeBundle:
    """The minimal channel-config surface TxValidator + DeliverService
    consult: policy manager, MSP manager, and a config sequence."""

    def __init__(self, k: int = 2):
        self.policy_manager = FakePolicyManager(k)
        self.msp_manager = FakeMSPManager()
        self.config = _FakeConfig()


class FakeCSP:
    """Deterministic verify/hash backend: a signature is valid iff it is
    sign_as(identity, digest) for the item's hash-derived key."""

    def hash_batch(self, msgs):
        return [sha256(m) for m in msgs]

    def _mask(self, items):
        return [
            _sig_ok(it.key, it.digest, it.signature) for it in items
        ]

    def verify_batch_async(self, items):
        mask = self._mask(list(items))
        return lambda: mask

    def verify_batch(self, items):
        return self.verify_batch_async(items)()


# -- gossip crypto service ----------------------------------------------------


class NetMCS(MessageCryptoService):
    """Shared-secret gossip MCS: every node of one network signs with
    sign_as(secret || identity) — forged messages from outside the
    topology fail verification, and each node keeps a distinct pki id
    (its identity bytes are its node name)."""

    def __init__(self, secret: bytes):
        self._secret = bytes(secret)

    def sign(self, payload: bytes) -> bytes:
        return sha256(self._secret + b":" + payload)

    def verify(self, identity: bytes, signature: bytes,
               payload: bytes) -> bool:
        return bytes(signature) == sha256(self._secret + b":" + payload)


# -- deterministic chain anchors & transactions -------------------------------


def make_genesis(channel_id: str) -> cb.Block:
    """The topology's byte-deterministic block 0: a CONFIG-typed
    envelope carrying the channel id, so every orderer and peer derives
    the identical chain anchor from the channel id alone (no shared
    disk, no coordination)."""
    chdr = protoutil.make_channel_header(
        cb.CONFIG, channel_id=channel_id, timestamp=0,
    )
    shdr = protoutil.make_signature_header(b"netharness", b"genesis-nonce")
    payload = cb.Payload(
        header=cb.Header(channel_header=chdr.encode(),
                         signature_header=shdr.encode()),
        data=b"netharness-genesis",
    )
    env = cb.Envelope(payload=payload.encode())
    blk = protoutil.new_block(0, b"")
    blk.data = cb.BlockData(data=[env.encode()])
    blk.header.data_hash = protoutil.block_data_hash(blk.data)
    protoutil.set_tx_filter(blk, bytearray(1))
    return blk


def org_endorsers(orgs: int) -> list[bytes]:
    return [b"end:org%d" % i for i in range(1, max(orgs, 1) + 1)]


def make_tx(channel_id: str, key: str, value: bytes,
            orgs: int = 3, cc: str = "netcc",
            creator: bytes | None = None) -> bytes:
    """One fully well-formed, policy-satisfying endorser envelope over
    the fake plane: endorsed by every org's endorser (2-of-n policy),
    deterministic txid from the write key."""
    sim = TxSimulator(VersionedDB(MemKVStore()))
    sim.set_state(cc, key, value)
    rwset = sim.get_tx_simulation_results()
    creator = creator or b"cre:net-client"
    nonce = sha256(b"nonce:" + channel_id.encode() + b":" + key.encode())
    txid = protoutil.compute_tx_id(nonce, creator)
    ext = pb.ChaincodeHeaderExtension(chaincode_id=pb.ChaincodeID(name=cc))
    chdr = protoutil.make_channel_header(
        cb.ENDORSER_TRANSACTION, channel_id, tx_id=txid,
        extension=ext.encode(), timestamp=0,
    )
    shdr = protoutil.make_signature_header(creator, nonce)
    chdr_b = chdr.encode()
    shdr_b = shdr.encode()
    ccpp_b = pb.ChaincodeProposalPayload(
        input=b"input:" + key.encode()
    ).encode()
    action = pb.ChaincodeAction(results=rwset,
                                chaincode_id=pb.ChaincodeID(name=cc))
    prp = pb.ProposalResponsePayload(
        proposal_hash=protoutil.proposal_hash2(chdr_b, shdr_b, ccpp_b),
        extension=action.encode(),
    )
    prp_b = prp.encode()
    endos = [
        pb.Endorsement(
            endorser=eb, signature=sign_as(eb, sha256(prp_b + eb))
        )
        for eb in org_endorsers(orgs)[:3] or [b"end:org1"]
    ]
    cap = pb.ChaincodeActionPayload(
        chaincode_proposal_payload=ccpp_b,
        action=pb.ChaincodeEndorsedAction(
            proposal_response_payload=prp_b, endorsements=endos
        ),
    )
    tx = pb.Transaction(
        actions=[pb.TransactionAction(payload=cap.encode())]
    )
    payload_b = cb.Payload(
        header=cb.Header(channel_header=chdr_b, signature_header=shdr_b),
        data=tx.encode(),
    ).encode()
    return cb.Envelope(
        payload=payload_b, signature=sign_as(creator, sha256(payload_b))
    ).encode()


__all__ = [
    "FakeKey", "FakeIdentity", "FakeMSPManager", "FakePolicy",
    "FakePolicyManager", "FakeBundle", "FakeCSP", "NetMCS",
    "key_of", "sign_as", "make_genesis", "make_tx", "org_endorsers",
]
