"""Block assembly and signing on the orderer (the port's copy of
`fabric_tpu/orderer/blockwriter.py`; reference
orderer/common/multichannel/blockwriter.go).

`write_block` gives each block its SIGNATURES metadata: an
OrdererBlockMetadata with the last config block's number, signed by the
orderer's identity over the metadata value, the signature header and the
block header's DER.  `verify_block_signature` is the deliver client's
check of that signature against the channel's BlockValidation policy.
"""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.ledger.blkstorage import BlockStore
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protoutil import SignedData


class BlockWriter:
    def __init__(self, store: BlockStore, signer=None,
                 last_config_index: int = 0):
        self._store = store
        self._signer = signer  # a SigningIdentity, or None (unsigned)
        self._last_config_index = last_config_index

    @property
    def height(self) -> int:
        return self._store.height

    def last_block(self) -> cb.Block | None:
        h = self._store.height
        return self._store.get_block_by_number(h - 1) if h else None

    def create_next_block(self, env_bytes_batch: list[bytes]) -> cb.Block:
        if self._store.height == 0:
            prev_hash, number = b"", 0
        else:
            prev = self._store.get_block_by_number(self._store.height - 1)
            prev_hash = protoutil.block_header_hash(prev.header)
            number = prev.header.number + 1
        blk = protoutil.new_block(number, prev_hash)
        blk.data = cb.BlockData(data=list(env_bytes_batch))
        blk.header.data_hash = protoutil.block_data_hash(blk.data)
        return blk

    def write_block(self, blk: cb.Block, is_config: bool = False) -> None:
        if is_config:
            self._last_config_index = blk.header.number
        meta = cb.Metadata(value=cb.OrdererBlockMetadata(
            last_config=cb.LastConfig(index=self._last_config_index)
        ).encode())
        if self._signer is not None:
            shdr = protoutil.make_signature_header(
                self._signer.serialize(), protoutil.random_nonce()).encode()
            msg = meta.value + shdr + protoutil.block_header_bytes(blk.header)
            meta.signatures = [cb.MetadataSignature(
                signature_header=shdr, signature=self._signer.sign(msg))]
        protoutil.init_block_metadata(blk)
        blk.metadata.metadata[cb.SIGNATURES] = meta.encode()
        protoutil.set_tx_filter(blk, bytes(len(blk.data.data)))
        self._store.add_block(blk)


def verify_block_signature(blk: cb.Block, policy, csp) -> bool:
    """Whether the block's orderer signatures satisfy `policy` (the
    channel's /Channel/Orderer/BlockValidation)."""
    try:
        meta = cb.Metadata.decode(blk.metadata.metadata[cb.SIGNATURES])
    except Exception:
        return False
    if not meta.signatures:
        return False
    signed = []
    for ms in meta.signatures:
        shdr = cb.SignatureHeader.decode(ms.signature_header)
        msg = (meta.value + ms.signature_header
               + protoutil.block_header_bytes(blk.header))
        signed.append(SignedData(msg, shdr.creator, ms.signature))
    return policy.evaluate_signed_data(signed, csp)


__all__ = ["BlockWriter", "verify_block_signature"]
