"""The discovery client (the port's copy of
`fabric_tpu/discovery/client.py`; reference discovery/client): signed
requests built, responses read, endorsers picked from a descriptor."""

from __future__ import annotations

import random

from fabric_tpu_torch.protos import discovery as dpb


class DiscoveryClient:
    def __init__(self, signer, send):
        """signer: `serialize()` and `sign(bytes)`; send:
        (SignedRequest) -> Response, in process or over a transport."""
        self._signer = signer
        self._send = send

    def _request(self, queries: list) -> dpb.SignedRequest:
        payload = dpb.Request(
            authentication=dpb.AuthInfo(
                client_identity=self._signer.serialize()),
            queries=queries).encode()
        return dpb.SignedRequest(payload=payload,
                                 signature=self._signer.sign(payload))

    def config(self, channel: str) -> dpb.ConfigResult:
        return self._one(dpb.Query(channel=channel,
                                   config_query=dpb.ConfigQuery())
                         ).config_result

    def peers(self, channel: str) -> list:
        r = self._one(dpb.Query(channel=channel,
                                peer_query=dpb.PeerMembershipQuery()))
        return [p for org in r.members.peers_by_org.values()
                for p in org.peers]

    def endorsers(self, channel: str, chaincode: str,
                  collections: list | None = None
                  ) -> dpb.EndorsementDescriptor:
        q = dpb.Query(channel=channel, cc_query=dpb.ChaincodeQuery(
            interests=[dpb.ChaincodeInterest(chaincodes=[dpb.ChaincodeCall(
                name=chaincode, collection_names=list(collections or []))])]))
        return self._one(q).cc_query_res.content[0]

    def _one(self, q: dpb.Query) -> dpb.QueryResult:
        r = self._send(self._request([q])).results[0]
        if r.which("result") == "error":
            raise RuntimeError(r.error.content)
        return r


def select_endorsers(desc: dpb.EndorsementDescriptor,
                     rng: random.Random | None = None) -> list:
    """Endorsers for one layout drawn from `rng`: in each group (by
    name), the highest ledger heights first."""
    rng = rng or random.Random()
    layout = desc.layouts[rng.randrange(len(desc.layouts))]
    chosen = []
    for group, quantity in sorted(layout.quantities_by_group.items()):
        peers = sorted(desc.endorsers_by_groups[group].peers,
                       key=lambda p: -p.ledger_height)
        if len(peers) < quantity:
            raise RuntimeError(f"group {group}: not enough peers")
        chosen.extend(peers[:quantity])
    return chosen


__all__ = ["DiscoveryClient", "select_endorsers"]
