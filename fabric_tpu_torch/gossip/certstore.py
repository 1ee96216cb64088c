"""Certstore: identity dissemination over the pull protocol (the port's
copy of `fabric_tpu/gossip/certstore.py`; reference
gossip/gossip/certstore.go).

A pull engine (hello, digest, request, update; PULL_IDENTITY_MSG) whose
items are self-signed PeerIdentity messages: each peer signs its own
once, and receivers forward the original signed envelope, so any peer
can verify where it came from.  Verified identities land in the
IdentityMapper and in the comm layer's identity table.
"""

from __future__ import annotations

import random
import threading

from fabric_tpu_torch.protos import gossip as gpb


class CertStore:
    def __init__(self, comm, mapper, membership, rng=None):
        self._comm = comm
        self._mapper = mapper
        self._membership = membership
        self._rng = rng or random.Random()
        self._nonce = 0
        self._pending: dict[int, str] = {}
        self._lock = threading.Lock()
        # pki hex -> serialized SignedGossipMessage, signed by its owner
        self._signed: dict[str, bytes] = {}
        self._add_own_identity()
        if hasattr(mapper, "add_purge_listener"):
            # identities the mapper expired are no longer offered
            mapper.add_purge_listener(self._evict)
        comm.subscribe(self._handle)

    def _evict(self, pki: bytes) -> None:
        if pki == self._comm.pki_id:
            return  # our own identity is always offered
        with self._lock:
            self._signed.pop(pki.hex(), None)

    def _add_own_identity(self) -> None:
        m = gpb.GossipMessage(
            tag=gpb.GossipMessage.EMPTY,
            peer_identity=gpb.PeerIdentity(pki_id=self._comm.pki_id,
                                           cert=self._comm.identity))
        self._signed[self._comm.pki_id.hex()] = self._comm.wrap(m).encode()

    # -- pull round --------------------------------------------------------

    def tick(self) -> None:
        peers = list(self._membership())
        if not peers:
            return
        target = self._rng.choice(peers)
        self._nonce += 1
        hello = gpb.GossipMessage(hello=gpb.GossipHello(
            nonce=self._nonce, msg_type=gpb.PULL_IDENTITY_MSG))
        with self._lock:
            self._pending[self._nonce] = target
            while len(self._pending) > 32:
                del self._pending[min(self._pending)]
        self._comm.send(target, hello)

    def known_pkis(self) -> list[str]:
        with self._lock:
            return sorted(self._signed)

    # -- inbound -----------------------------------------------------------

    def _handle(self, rm) -> None:
        msg = rm.msg
        kind = msg.which("content")
        if kind == "hello" and msg.hello.msg_type == gpb.PULL_IDENTITY_MSG:
            self._respond(rm, gpb.GossipMessage(data_dig=gpb.DataDigest(
                nonce=msg.hello.nonce, msg_type=gpb.PULL_IDENTITY_MSG,
                digests=[h.encode() for h in self.known_pkis()])))
        elif (kind == "data_dig"
              and msg.data_dig.msg_type == gpb.PULL_IDENTITY_MSG):
            with self._lock:
                target = self._pending.pop(msg.data_dig.nonce, None)
                have = set(self._signed)
            if target is None:
                return
            want = [d for d in msg.data_dig.digests
                    if d.decode() not in have]
            if not want:
                return
            self._comm.send(target, gpb.GossipMessage(data_req=gpb.DataRequest(
                nonce=msg.data_dig.nonce, msg_type=gpb.PULL_IDENTITY_MSG,
                digests=want)))
        elif (kind == "data_req"
              and msg.data_req.msg_type == gpb.PULL_IDENTITY_MSG):
            data = []
            with self._lock:
                for d in msg.data_req.digests:
                    raw = self._signed.get(d.decode())
                    if raw is not None:
                        data.append(gpb.SignedGossipMessage.decode(raw))
            self._respond(rm, gpb.GossipMessage(data_update=gpb.DataUpdate(
                nonce=msg.data_req.nonce, msg_type=gpb.PULL_IDENTITY_MSG,
                data=data)))
        elif (kind == "data_update"
              and msg.data_update.msg_type == gpb.PULL_IDENTITY_MSG):
            for signed in msg.data_update.data:
                self._learn(signed)

    def _learn(self, signed: gpb.SignedGossipMessage) -> None:
        """Admit a pulled identity: its pki-id derives from its cert, and
        the envelope verifies under that identity (self-signed)."""
        try:
            inner = gpb.GossipMessage.decode(signed.payload)
            if inner.which("content") != "peer_identity":
                return
            ident = inner.peer_identity.cert
            pki = inner.peer_identity.pki_id
            if self._comm.mcs.get_pki_id(ident) != pki:
                return
            if not self._comm.mcs.verify(ident, signed.signature,
                                         signed.payload):
                return
            self._mapper.put(ident)  # raises when expired
        except Exception:
            return
        with self._lock:
            self._signed.setdefault(pki.hex(), signed.encode())
        self._comm.learn_identity(ident)

    def _respond(self, rm, msg: gpb.GossipMessage) -> None:
        ep = self._endpoint_for(rm.sender_pki)
        if ep:
            self._comm.send(ep, msg)
        else:
            try:
                rm.respond(msg)
            except Exception:
                pass

    endpoint_lookup = None

    def _endpoint_for(self, pki_id: bytes):
        if self.endpoint_lookup is not None:
            return self.endpoint_lookup(pki_id)
        return None


__all__ = ["CertStore"]
