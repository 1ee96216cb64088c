"""The block-delivery service (the port's copy of
`fabric_tpu/common/deliver.py`; reference common/deliver).

`DeliverService.deliver(env)` reads a signed SeekInfo envelope, checks
the requester against the channel's Readers policy (again whenever the
channel's config sequence moves), and yields the blocks between the
requested positions, waiting for new ones unless the SeekInfo says
FAIL_IF_NOT_READY.  It is a generator of ("block", Block) and ("status",
code) events, so the same engine serves the orderer's Deliver, the
peer's DeliverFiltered (`filter_block`) and in-process readers.
"""

from __future__ import annotations

import threading

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.devtools.lockwatch import named_condition
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protoutil import SignedData


class BlockNotifier:
    """The height watcher deliver streams wait on for new blocks."""

    def __init__(self):
        self._cond = named_condition("deliver.height")

    def notify(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def wait(self, timeout: float = 1.0) -> None:
        with self._cond:
            self._cond.wait(timeout)


class DeliverService:
    def __init__(self, chain_getter, csp, policy_path="/Channel/Readers",
                 notifier: BlockNotifier | None = None):
        """chain_getter(channel_id) -> an object with `.store` (a
        BlockStore) and `.bundle` (the channel's Bundle), or None.
        `policy_path` is the policy that gates access: a path, or a
        callable(support) -> path."""
        self._get = chain_getter
        self._csp = csp
        self._policy_path = policy_path
        self.notifier = notifier or BlockNotifier()
        self._stopped = threading.Event()

    def stop(self) -> None:
        self._stopped.set()
        self.notifier.notify()

    def _check_access(self, env: cb.Envelope, support) -> bool:
        payload = cb.Payload.decode(env.payload)
        shdr = cb.SignatureHeader.decode(payload.header.signature_header)
        path = self._policy_path
        if callable(path):
            try:
                path = path(support)
            except Exception:
                return False
        policy = support.bundle.policy_manager.get_policy(path)
        if policy is None:
            return False  # no policy resolves: no access
        sd = [SignedData(env.payload, shdr.creator, env.signature)]
        return policy.evaluate_signed_data(sd, self._csp)

    @staticmethod
    def _position(pos: ob.SeekPosition, height: int) -> int | None:
        kind = pos.which("Type")
        if kind == "oldest":
            return 0
        if kind == "newest":
            return max(height - 1, 0)
        if kind == "specified":
            return pos.specified.number
        return None

    def deliver(self, env: cb.Envelope):
        """Yields ("block", Block) events, then one ("status", code)."""
        chdr = protoutil.channel_header(env)
        support = self._get(chdr.channel_id)
        if support is None:
            yield ("status", cb.NOT_FOUND)
            return
        if not self._check_access(env, support):
            yield ("status", cb.FORBIDDEN)
            return
        try:
            seek = ob.SeekInfo.decode(cb.Payload.decode(env.payload).data)
        except Exception:
            yield ("status", cb.BAD_REQUEST)
            return
        store = support.store
        start = self._position(seek.start, store.height)
        stop = self._position(seek.stop, store.height)
        if start is None or stop is None:
            yield ("status", cb.BAD_REQUEST)
            return
        if stop < start and seek.stop.which("Type") == "specified":
            yield ("status", cb.BAD_REQUEST)
            return
        num = start
        config_seq = support.bundle.config.sequence
        while num <= stop:
            if self._stopped.is_set():
                yield ("status", cb.SERVICE_UNAVAILABLE)
                return
            # the config moved: check the reader again
            if support.bundle.config.sequence != config_seq:
                config_seq = support.bundle.config.sequence
                if not self._check_access(env, support):
                    yield ("status", cb.FORBIDDEN)
                    return
            if num >= store.height:
                if seek.behavior == ob.SeekInfo.FAIL_IF_NOT_READY:
                    yield ("status", cb.NOT_FOUND)
                    return
                self.notifier.wait(0.25)
                continue
            blk = store.get_block_by_number(num)
            if blk is None:
                yield ("status", cb.NOT_FOUND)
                return
            yield ("block", blk)
            num += 1
        yield ("status", cb.SUCCESS)


def deliver_response_frames(service: DeliverService, env_bytes: bytes):
    """The RPC adapter: the request envelope's deliver events as encoded
    `orderer.DeliverResponse` frames."""
    env = cb.Envelope.decode(env_bytes)
    for kind, value in service.deliver(env):
        if kind == "block":
            yield ob.DeliverResponse(block=value).encode()
        else:
            yield ob.DeliverResponse(status=value).encode()


def filter_block(blk: cb.Block) -> pb.FilteredBlock:
    """A block's FilteredBlock: txid, header type, validation code and
    chaincode events (payloads stripped) of each transaction."""
    flags = list(protoutil.tx_filter(blk))
    out = pb.FilteredBlock(number=blk.header.number, filtered_transactions=[])
    for i, env_bytes in enumerate(blk.data.data):
        ftx = pb.FilteredTransaction()
        out.filtered_transactions.append(ftx)
        try:
            env = cb.Envelope.decode(env_bytes)
            payload = cb.Payload.decode(env.payload)
            chdr = cb.ChannelHeader.decode(payload.header.channel_header)
        except Exception:
            continue
        out.channel_id = chdr.channel_id
        ftx.txid = chdr.tx_id
        ftx.type = chdr.type
        if i < len(flags):
            ftx.tx_validation_code = flags[i]
        if chdr.type != cb.ENDORSER_TRANSACTION:
            continue
        try:
            tx = pb.Transaction.decode(payload.data)
        except Exception:
            continue
        actions = []
        for act in tx.actions:
            # a malformed action still gets its (eventless) entry
            fca = pb.FilteredChaincodeAction()
            actions.append(fca)
            try:
                cap = pb.ChaincodeActionPayload.decode(act.payload)
                prp = pb.ProposalResponsePayload.decode(
                    cap.action.proposal_response_payload)
                ca = pb.ChaincodeAction.decode(prp.extension)
                if ca.events:
                    ev = pb.ChaincodeEvent.decode(ca.events)
                    ev.payload = b""
                    fca.chaincode_event = ev
            except Exception:
                continue
        if actions:
            ftx.transaction_actions = pb.FilteredTransactionActions(
                chaincode_actions=actions)
    return out


def deliver_filtered_frames(service: DeliverService, env_bytes: bytes):
    """The filtered variant: encoded `peer.DeliverResponse` frames."""
    env = cb.Envelope.decode(env_bytes)
    for kind, value in service.deliver(env):
        if kind == "block":
            yield pb.DeliverResponse(filtered_block=filter_block(value)).encode()
        else:
            yield pb.DeliverResponse(status=value).encode()


def make_seek_info_envelope(channel_id: str, start, stop, signer=None,
                            behavior: int = ob.SeekInfo.BLOCK_UNTIL_READY
                            ) -> cb.Envelope:
    """The signed DELIVER_SEEK_INFO envelope a client sends; `start` and
    `stop` are "oldest", "newest" or a block number."""
    def position(val) -> ob.SeekPosition:
        if val == "oldest":
            return ob.SeekPosition(oldest=ob.SeekOldest())
        if val == "newest":
            return ob.SeekPosition(newest=ob.SeekNewest())
        return ob.SeekPosition(specified=ob.SeekSpecified(number=int(val)))

    seek = ob.SeekInfo(start=position(start), stop=position(stop),
                       behavior=behavior)
    chdr = protoutil.make_channel_header(cb.DELIVER_SEEK_INFO,
                                         channel_id=channel_id)
    creator = signer.serialize() if signer is not None else b""
    shdr = protoutil.make_signature_header(creator, protoutil.random_nonce())
    raw = protoutil.make_payload_bytes(chdr, shdr, seek.encode())
    return protoutil.make_envelope(raw, signer)


__all__ = ["DeliverService", "BlockNotifier", "deliver_response_frames",
           "filter_block", "deliver_filtered_frames", "make_seek_info_envelope"]
