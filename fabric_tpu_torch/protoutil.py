"""Construction and extraction of Fabric's wire messages (the port's copy
of `fabric_tpu/protoutil/`: `common.py`, `txs.py`, `blocks.py`), on the
port's codec (`fabric_tpu_torch.protos`)."""

from __future__ import annotations

import dataclasses
import os
import time
import typing

from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import peer as pb


class SignedData(typing.NamedTuple):
    """A (message, identity, signature) triple for policy evaluation and
    batch verification.  `digest`, when set, is the SHA-256 of `data`,
    which may then be b"": nothing after policy prepare reads it."""

    data: bytes
    identity: bytes  # a marshaled SerializedIdentity
    signature: bytes
    digest: bytes | None = None


# -- envelopes and headers (reference protoutil/commonutils.go) -------------


def random_nonce(n: int = 24) -> bytes:
    return os.urandom(n)


def compute_tx_id(nonce: bytes, creator: bytes) -> str:
    """TxID = hex(SHA-256(nonce || creator))."""
    return sha256(nonce + creator).hex()


def check_tx_id(txid: str, nonce: bytes, creator: bytes) -> bool:
    return txid == compute_tx_id(nonce, creator)


def make_channel_header(header_type: int, channel_id: str, tx_id: str = "",
                        epoch: int = 0, extension: bytes = b"",
                        version: int = 0,
                        timestamp: float | None = None) -> cb.ChannelHeader:
    ts = time.time() if timestamp is None else timestamp
    return cb.ChannelHeader(
        type=header_type, version=version, channel_id=channel_id,
        tx_id=tx_id, epoch=epoch, extension=extension,
        timestamp=cb.Timestamp(seconds=int(ts)),
    )


def make_signature_header(creator: bytes, nonce: bytes) -> cb.SignatureHeader:
    return cb.SignatureHeader(creator=creator, nonce=nonce)


def make_payload_bytes(channel_header: cb.ChannelHeader,
                       signature_header: cb.SignatureHeader,
                       data: bytes) -> bytes:
    return cb.Payload(
        header=cb.Header(channel_header=channel_header.encode(),
                         signature_header=signature_header.encode()),
        data=data,
    ).encode()


def make_envelope(payload_bytes: bytes, signer=None) -> cb.Envelope:
    """The payload wrapped in an envelope, signed by `signer` (anything
    with `sign(msg) -> bytes`) when given."""
    sig = signer.sign(payload_bytes) if signer is not None else b""
    return cb.Envelope(payload=payload_bytes, signature=sig)


def channel_header(env: cb.Envelope) -> cb.ChannelHeader:
    """The ChannelHeader of an envelope's payload."""
    payload = cb.Payload.decode(env.payload)
    return cb.ChannelHeader.decode(payload.header.channel_header)


# -- proposals and transactions (reference protoutil/proputils.go, txutils.go)


def create_chaincode_proposal(creator: bytes, channel_id: str,
                              chaincode_name: str, args: list[bytes],
                              transient: dict[str, bytes] | None = None,
                              nonce: bytes | None = None,
                              timestamp: float | None = None,
                              ) -> tuple[pb.Proposal, str]:
    """An ENDORSER_TRANSACTION proposal; returns (proposal, tx_id)."""
    nonce = nonce if nonce is not None else random_nonce()
    tx_id = compute_tx_id(nonce, creator)
    ext = pb.ChaincodeHeaderExtension(
        chaincode_id=pb.ChaincodeID(name=chaincode_name))
    chdr = make_channel_header(cb.ENDORSER_TRANSACTION, channel_id,
                               tx_id=tx_id, extension=ext.encode(),
                               timestamp=timestamp)
    shdr = make_signature_header(creator, nonce)
    cis = pb.ChaincodeInvocationSpec(chaincode_spec=pb.ChaincodeSpec(
        type=pb.ChaincodeSpec.GOLANG,
        chaincode_id=pb.ChaincodeID(name=chaincode_name),
        input=pb.ChaincodeInput(args=args),
    ))
    ccpp = pb.ChaincodeProposalPayload(input=cis.encode())
    if transient:
        ccpp.TransientMap = dict(transient)
    prop = pb.Proposal(
        header=cb.Header(channel_header=chdr.encode(),
                         signature_header=shdr.encode()).encode(),
        payload=ccpp.encode(),
    )
    return prop, tx_id


def _without_transient(ccpp_bytes: bytes) -> bytes:
    ccpp = pb.ChaincodeProposalPayload.decode(ccpp_bytes)
    ccpp.__dict__.pop("TransientMap", None)
    return ccpp.encode()


def proposal_hash(chdr_bytes: bytes, shdr_bytes: bytes,
                  ccpp_bytes: bytes) -> bytes:
    """GetProposalHash1: the payload's TransientMap does not count."""
    return sha256(chdr_bytes + shdr_bytes + _without_transient(ccpp_bytes))


def proposal_hash2(chdr_bytes: bytes, shdr_bytes: bytes,
                   ccpp_bytes: bytes) -> bytes:
    """GetProposalHash2, the validator's: the committed payload bytes as
    they are, never parsed."""
    return sha256(chdr_bytes + shdr_bytes + ccpp_bytes)


def create_proposal_response(prop: pb.Proposal, results: bytes, events: bytes,
                             response: pb.Response, chaincode_id: pb.ChaincodeID,
                             endorser_signer) -> pb.ProposalResponse:
    """Sign a simulation's results as an endorser."""
    hdr = cb.Header.decode(prop.header)
    p_hash = proposal_hash(hdr.channel_header, hdr.signature_header,
                           prop.payload)
    action = pb.ChaincodeAction(results=results, events=events,
                                response=response, chaincode_id=chaincode_id)
    prp = pb.ProposalResponsePayload(proposal_hash=p_hash,
                                     extension=action.encode()).encode()
    endorser = endorser_signer.serialize()
    return pb.ProposalResponse(
        version=1, response=response, payload=prp,
        endorsement=pb.Endorsement(endorser=endorser,
                                   signature=endorser_signer.sign(prp + endorser)),
    )


def create_signed_tx(prop: pb.Proposal, signer,
                     responses: list[pb.ProposalResponse]) -> cb.Envelope:
    """The endorsed transaction's envelope: every response must carry the
    same payload, the signer must be the proposal's creator, and the
    transient data is stripped."""
    if not responses:
        raise ValueError("at least one proposal response is required")
    hdr = cb.Header.decode(prop.header)
    shdr = cb.SignatureHeader.decode(hdr.signature_header)
    if shdr.creator != signer.serialize():
        raise ValueError("signer must match proposal creator")
    payload0 = responses[0].payload
    endorsements = []
    for r in responses:
        if r.response.status < 200 or r.response.status >= 400:
            raise ValueError(
                f"proposal response was not successful: {r.response.status}")
        if r.payload != payload0:
            raise ValueError("proposal responses do not match")
        endorsements.append(r.endorsement)
    cap = pb.ChaincodeActionPayload(
        chaincode_proposal_payload=_without_transient(prop.payload),
        action=pb.ChaincodeEndorsedAction(proposal_response_payload=payload0,
                                          endorsements=endorsements),
    )
    tx = pb.Transaction(actions=[pb.TransactionAction(
        header=hdr.signature_header, payload=cap.encode())])
    payload = cb.Payload(header=hdr, data=tx.encode()).encode()
    return cb.Envelope(payload=payload, signature=signer.sign(payload))


@dataclasses.dataclass
class UnpackedProposal:
    proposal: pb.Proposal
    channel_header: cb.ChannelHeader
    signature_header: cb.SignatureHeader
    chaincode_name: str
    input: pb.ChaincodeInput


def unpack_proposal(signed: pb.SignedProposal) -> UnpackedProposal:
    """The endorser's unpacking and structural checks (reference
    core/endorser/msgvalidation.go UnpackProposal)."""
    prop = pb.Proposal.decode(signed.proposal_bytes)
    hdr = cb.Header.decode(prop.header)
    chdr = cb.ChannelHeader.decode(hdr.channel_header)
    shdr = cb.SignatureHeader.decode(hdr.signature_header)
    ext = pb.ChaincodeHeaderExtension.decode(chdr.extension)
    if not ext.chaincode_id.name:
        raise ValueError("ChaincodeHeaderExtension.chaincode_id.name is empty")
    ccpp = pb.ChaincodeProposalPayload.decode(prop.payload)
    cis = pb.ChaincodeInvocationSpec.decode(ccpp.input)
    return UnpackedProposal(proposal=prop, channel_header=chdr,
                            signature_header=shdr,
                            chaincode_name=ext.chaincode_id.name,
                            input=cis.chaincode_spec.input)


def get_action_from_envelope(env: cb.Envelope
                             ) -> tuple[pb.ChaincodeActionPayload,
                                        pb.ChaincodeAction]:
    """The (ChaincodeActionPayload, ChaincodeAction) of action 0."""
    payload = cb.Payload.decode(env.payload)
    tx = pb.Transaction.decode(payload.data)
    cap = pb.ChaincodeActionPayload.decode(tx.actions[0].payload)
    prp = pb.ProposalResponsePayload.decode(
        cap.action.proposal_response_payload)
    return cap, pb.ChaincodeAction.decode(prp.extension)


# -- blocks (reference protoutil/blockutils.go) -------------------------------


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_integer(v: int) -> bytes:
    if v == 0:
        body = b"\x00"
    else:
        # one spare byte keeps the sign bit clear; drop it when unneeded
        body = v.to_bytes((v.bit_length() + 8) // 8, "big")
        if len(body) > 1 and body[0] == 0 and body[1] < 0x80:
            body = body[1:]
    return b"\x02" + _der_len(len(body)) + body


def _der_octets(b: bytes) -> bytes:
    return b"\x04" + _der_len(len(b)) + b


def block_header_bytes(header: cb.BlockHeader) -> bytes:
    """ASN.1 DER of SEQUENCE { number INTEGER, previous_hash OCTET STRING,
    data_hash OCTET STRING }: what the header hash covers, the same in
    every implementation."""
    body = (_der_integer(header.number) + _der_octets(header.previous_hash)
            + _der_octets(header.data_hash))
    return b"\x30" + _der_len(len(body)) + body


def block_header_hash(header: cb.BlockHeader) -> bytes:
    return sha256(block_header_bytes(header))


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def serialize_block(block: cb.Block, env_bytes=None) -> bytes:
    """`block.encode()`, spliced: the envelopes sit verbatim inside
    BlockData, so the data field is framed around them and not encoded
    again.  `env_bytes` may pass the envelopes' bytes already in hand."""
    parts: list = []
    if block.has("header"):
        hb = block.header.encode()
        parts += [b"\x0a", _varint(len(hb)), hb]
    if block.has("data"):
        if env_bytes is None:
            env_bytes = block.data.data
        dparts: list = []
        ap = dparts.append
        for env in env_bytes:
            ap(b"\x0a")
            ap(_varint(len(env)))
            ap(env)
        db = b"".join(dparts)
        parts += [b"\x12", _varint(len(db)), db]
    if block.has("metadata"):
        mb = block.metadata.encode()
        parts += [b"\x1a", _varint(len(mb)), mb]
    return b"".join(parts)


def block_data_hash(data: cb.BlockData) -> bytes:
    return sha256(b"".join(data.data))


def init_block_metadata(block: cb.Block) -> None:
    """Give the block its five metadata slots (at least)."""
    meta = list(block.metadata.metadata)
    meta += [b""] * (cb.COMMIT_HASH + 1 - len(meta))
    block.metadata = cb.BlockMetadata(metadata=meta)


def new_block(seq: int, previous_hash: bytes) -> cb.Block:
    blk = cb.Block(header=cb.BlockHeader(number=seq,
                                         previous_hash=previous_hash),
                   data=cb.BlockData(data=[]))
    init_block_metadata(blk)
    return blk


def extract_envelope(block: cb.Block, idx: int) -> cb.Envelope:
    return cb.Envelope.decode(block.data.data[idx])


def tx_filter(block: cb.Block) -> bytearray:
    """The validation code of every transaction (the metadata's
    TRANSACTIONS_FILTER); all VALID when the filter's length is not the
    block's transaction count.  Gives the block its metadata slots."""
    init_block_metadata(block)
    raw = block.metadata.metadata[cb.TRANSACTIONS_FILTER]
    if len(raw) != len(block.data.data):
        return bytearray(len(block.data.data))
    return bytearray(raw)


def set_tx_filter(block: cb.Block, flags) -> None:
    init_block_metadata(block)
    block.metadata.metadata[cb.TRANSACTIONS_FILTER] = bytes(flags)


__all__ = [
    "SignedData", "random_nonce", "compute_tx_id", "check_tx_id",
    "make_channel_header", "make_signature_header", "make_payload_bytes",
    "make_envelope", "channel_header",
    "create_chaincode_proposal", "proposal_hash", "proposal_hash2",
    "create_proposal_response", "create_signed_tx",
    "get_action_from_envelope", "block_header_bytes", "block_header_hash",
    "serialize_block", "block_data_hash", "init_block_metadata", "new_block",
    "extract_envelope", "tx_filter", "set_tx_filter",
]
