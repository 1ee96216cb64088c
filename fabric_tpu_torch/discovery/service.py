"""The discovery service (the port's copy of
`fabric_tpu/discovery/service.py`; reference discovery/service.go).

A SignedRequest's caller is authenticated (an identity valid on the
channel, through the channel's ACL check), then each query is answered:

- ConfigQuery: the channel's MSP configs and orderer endpoints
- PeerMembershipQuery: the live peers by org
- ChaincodeQuery: an endorsement descriptor for each call of an interest
- LocalPeerQuery: the membership without a channel

Authentication verdicts are memoized by (channel, identity, signature,
payload) in a small cache.
"""

from __future__ import annotations

import threading

from fabric_tpu_torch.common.hashing import sha256 as _sha256
from fabric_tpu_torch.discovery.endorsement import (
    PeerInfo,
    _peer,
    compute_descriptor,
)
from fabric_tpu_torch.protos import discovery as dpb
from fabric_tpu_torch.protos.wire import DecodeError
from fabric_tpu_torch.protoutil import SignedData


class DiscoveryError(Exception):
    pass


class DiscoverySupport:
    """What the service needs of the peer, as callables:

    - channels() -> list[str]
    - bundle(channel) -> a channelconfig Bundle (msp_manager)
    - peers(channel) -> list[PeerInfo]
    - msp_configs(channel) -> {mspid: serialized MSPConfig}
    - orderer_endpoints(channel) -> {mspid: [(host, port)]}
    - chaincode_policy(channel, cc_name) -> SignaturePolicyEnvelope | None
    - collection_filter(channel, cc, collections) -> (PeerInfo) -> bool
    - acl_check(channel, signed_data), raising on denial
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


class DiscoveryService:
    def __init__(self, support: DiscoverySupport, csp,
                 auth_cache_size: int = 1000):
        self._support = support
        self._csp = csp
        self._auth_cache: dict[bytes, bool] = {}
        self._lock = threading.Lock()
        self._cache_size = auth_cache_size

    # -- authentication ----------------------------------------------------

    def _authenticate(self, signed: dpb.SignedRequest, req: dpb.Request,
                      channel: str) -> None:
        ident_bytes = req.authentication.client_identity
        if not ident_bytes:
            raise DiscoveryError("access denied: no client identity")
        key = _sha256(channel.encode() + b"\x00" + ident_bytes + b"\x00"
                      + signed.signature + signed.payload)
        with self._lock:
            cached = self._auth_cache.get(key)
        if cached is True:
            return
        if cached is False:
            raise DiscoveryError("access denied")
        ok = False
        try:
            bundle = self._support.bundle(channel)
            ident = bundle.msp_manager.deserialize_identity(ident_bytes)
            bundle.msp_manager.validate(ident)
            self._support.acl_check(channel, SignedData(
                data=signed.payload, identity=ident_bytes,
                signature=signed.signature))
            ok = True
        except Exception as exc:
            raise DiscoveryError(f"access denied: {exc}") from exc
        finally:
            with self._lock:
                if len(self._auth_cache) >= self._cache_size:
                    self._auth_cache.clear()
                self._auth_cache[key] = ok

    # -- processing --------------------------------------------------------

    def process(self, signed: dpb.SignedRequest) -> dpb.Response:
        try:
            req = dpb.Request.decode(signed.payload)
        except DecodeError:
            return dpb.Response(results=[dpb.QueryResult(
                error=dpb.Error(content="malformed request"))])
        results = []
        for q in req.queries:
            out = dpb.QueryResult()
            try:
                which = q.which("query")
                if which in ("config_query", "peer_query", "cc_query"):
                    if q.channel not in self._support.channels():
                        raise DiscoveryError(
                            f"access denied: unknown channel {q.channel!r}")
                    self._authenticate(signed, req, q.channel)
                if which == "config_query":
                    field, value = "config_result", self._config(q.channel)
                elif which == "peer_query":
                    field, value = "members", self._members(q.channel)
                elif which == "cc_query":
                    field, value = "cc_query_res", self._endorsers(
                        q.channel, q.cc_query)
                elif which == "local_peers":
                    field, value = "members", self._members("")
                else:
                    raise DiscoveryError("unknown query type")
                # an answer with nothing in it leaves the result unset,
                # as the reference's does
                if value.encode():
                    out = dpb.QueryResult(**{field: value})
            except Exception as exc:
                out = dpb.QueryResult(error=dpb.Error(content=str(exc)))
            results.append(out)
        return dpb.Response(results=results)

    def _config(self, channel: str) -> dpb.ConfigResult:
        return dpb.ConfigResult(
            msps=dict(self._support.msp_configs(channel)),
            orderers={mspid: dpb.Endpoints(endpoint=[
                dpb.Endpoint(host=h, port=p) for h, p in eps])
                for mspid, eps in
                self._support.orderer_endpoints(channel).items()})

    def _members(self, channel: str) -> dpb.PeerMembershipResult:
        by_org: dict[str, list] = {}
        for p in self._support.peers(channel):
            by_org.setdefault(p.mspid, []).append(_peer(p))
        return dpb.PeerMembershipResult(peers_by_org={
            org: dpb.Peers(peers=peers) for org, peers in by_org.items()})

    def _endorsers(self, channel: str, cc_query) -> dpb.ChaincodeQueryResult:
        bundle = self._support.bundle(channel)
        peers = self._support.peers(channel)
        content = []
        for interest in cc_query.interests:
            if not interest.chaincodes:
                raise DiscoveryError("empty chaincode interest")
            # a descriptor for each call of the interest
            for call in interest.chaincodes:
                pol = self._support.chaincode_policy(channel, call.name)
                if pol is None:
                    raise DiscoveryError(
                        f"no endorsement policy for {call.name!r}")
                cfilter = None
                if call.collection_names:
                    cfilter = self._support.collection_filter(
                        channel, call.name, list(call.collection_names))
                content.append(compute_descriptor(
                    call.name, pol, peers, bundle.msp_manager,
                    collection_filter=cfilter))
        return dpb.ChaincodeQueryResult(content=content)


__all__ = ["DiscoveryService", "DiscoverySupport", "DiscoveryError",
           "PeerInfo"]
