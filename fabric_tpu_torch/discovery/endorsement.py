"""Endorsement descriptors (the port's copy of
`fabric_tpu/discovery/endorsement.py`; reference
discovery/endorsement/endorsement.go).

Peers are grouped by the policy's principals (group Gk: the peers whose
identity satisfies principal k); each satisfaction set whose groups have
enough peers becomes a layout, how many endorsements it needs of each
group.  A call that touches collections first keeps the peers that the
collection filter admits.
"""

from __future__ import annotations

import dataclasses

from fabric_tpu_torch.discovery.inquire import satisfaction_sets
from fabric_tpu_torch.protos import discovery as dpb


@dataclasses.dataclass
class PeerInfo:
    endpoint: str
    identity: bytes  # a serialized identity
    mspid: str
    ledger_height: int = 0
    chaincodes: tuple[str, ...] = ()


def _peers_for_principal(principal, peers, deserializer):
    """The peers whose identity satisfies the principal."""
    out = []
    for p in peers:
        try:
            ident = deserializer.deserialize_identity(p.identity)
            deserializer.satisfies_principal(ident, principal)
        except Exception:
            continue
        out.append(p)
    return out


def _peer(p: PeerInfo) -> dpb.Peer:
    return dpb.Peer(identity=p.identity, endpoint=p.endpoint,
                    ledger_height=p.ledger_height,
                    chaincodes=list(p.chaincodes))


def compute_descriptor(chaincode: str, policy_envelope, peers: list,
                       deserializer, collection_filter=None
                       ) -> dpb.EndorsementDescriptor:
    """The EndorsementDescriptor (groups and layouts); ValueError when
    no layout is satisfiable by the peers given.
    collection_filter: (PeerInfo) -> bool, applied first."""
    if collection_filter is not None:
        peers = [p for p in peers if collection_filter(p)]
    principals = list(policy_envelope.identities)
    sets = satisfaction_sets(policy_envelope)
    if not sets:
        raise ValueError(f"policy of {chaincode} has no satisfaction sets")
    group_peers = {k: _peers_for_principal(principals[k], peers,
                                           deserializer)
                   for k in range(len(principals))}
    layouts = []
    used_groups: set[int] = set()
    for s in sets:
        quantities: dict[int, int] = {}
        for idx in s:
            quantities[idx] = quantities.get(idx, 0) + 1
        # feasible only if each group has enough peers
        if any(len(group_peers.get(idx, [])) < q
               for idx, q in quantities.items()):
            continue
        layouts.append(dpb.Layout(quantities_by_group={
            f"G{idx}": q for idx, q in quantities.items()}))
        used_groups.update(quantities)
    if not layouts:
        raise ValueError(
            f"no endorsement layout of {chaincode} is satisfiable by the "
            "current membership")
    return dpb.EndorsementDescriptor(
        chaincode=chaincode,
        endorsers_by_groups={
            f"G{idx}": dpb.Peers(peers=[_peer(p) for p in group_peers[idx]])
            for idx in sorted(used_groups)},
        layouts=layouts)


__all__ = ["PeerInfo", "compute_descriptor"]
