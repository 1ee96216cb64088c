"""System chaincodes qscc (ledger queries) and cscc (channel config) (the
port's copy of `fabric_tpu/chaincode/scc.py`; reference core/scc/qscc
and core/scc/cscc).  They run through the same shim as user chaincodes
and read the peer's ledgers through the getters they are given."""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.chaincode.shim import Chaincode, error, success
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import peer as pb


class QSCC(Chaincode):
    def __init__(self, ledger_getter):
        """ledger_getter(channel_id) -> a ledger with `.block_store`."""
        self._ledger = ledger_getter

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if not params:
            return error("qscc: missing channel argument")
        channel_id = params[0].decode()
        ledger = self._ledger(channel_id)
        if ledger is None:
            return error(f"qscc: channel {channel_id!r} not found",
                         status=404)
        store = ledger.block_store
        try:
            if fn == "GetChainInfo":
                info = cb.BlockchainInfo(height=store.height)
                last = store.get_block_by_number(store.height - 1)
                if last is not None:
                    info.current_block_hash = protoutil.block_header_hash(
                        last.header)
                    info.previous_block_hash = bytes(
                        last.header.previous_hash)
                return success(info.encode())
            if fn == "GetBlockByNumber":
                blk = store.get_block_by_number(int(params[1]))
                if blk is None:
                    return error("block not found", status=404)
                return success(blk.encode())
            if fn == "GetBlockByHash":
                blk = store.get_block_by_hash(params[1])
                if blk is None:
                    return error("block not found", status=404)
                return success(blk.encode())
            if fn == "GetTransactionByID":
                env = store.get_tx_by_id(params[1].decode())
                if env is None:
                    return error("transaction not found", status=404)
                return success(env.encode())
            if fn == "GetBlockByTxID":
                loc = store.get_tx_loc(params[1].decode())
                if loc is None:
                    return error("transaction not found", status=404)
                return success(store.get_block_by_number(loc[0]).encode())
        except (ValueError, IndexError) as exc:
            return error(f"qscc: bad arguments: {exc}")
        return error(f"qscc: unknown function {fn!r}")


class CSCC(Chaincode):
    def __init__(self, channel_lister, config_block_getter, joiner=None):
        self._channels = channel_lister  # () -> list[str]
        self._config_block = config_block_getter  # (channel) -> Block | None
        self._join = joiner  # (genesis Block) -> None

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "GetChannels":
            return success(pb.ChannelQueryResponse(channels=[
                pb.ChannelInfo(channel_id=ch)
                for ch in self._channels()]).encode())
        if fn == "GetConfigBlock":
            blk = self._config_block(params[0].decode())
            if blk is None:
                return error("channel not found", status=404)
            return success(blk.encode())
        if fn == "JoinChain":
            if self._join is None:
                return error("join not supported on this node")
            self._join(cb.Block.decode(params[0]))
            return success()
        return error(f"cscc: unknown function {fn!r}")


__all__ = ["QSCC", "CSCC"]
