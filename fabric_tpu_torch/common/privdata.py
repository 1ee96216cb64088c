"""Collection access policies (the port's copy of
`fabric_tpu/common/privdata.py`; reference core/common/privdata/).

`SimpleCollection` reads a `StaticCollectionConfig` and answers
`is_member(serialized_identity)` (does the identity satisfy a principal
of the member-orgs policy: read access and distribution) and the peer
counts and block-to-live; `CollectionStore` holds the collections of
committed chaincode definitions, `LedgerBackedCollectionStore` reads them
from the committed definitions at each lookup.  Membership is decided
on the principals directly, as the JAX package does, not by a policy
evaluation over a self-signed probe as the reference does (the same
outcome).
"""

from __future__ import annotations

from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import peer as pb


class NoSuchCollectionError(Exception):
    pass


class SimpleCollection:
    def __init__(self, conf: pb.StaticCollectionConfig, deserializer):
        self._conf = conf
        self._deserializer = deserializer
        pol = conf.member_orgs_policy
        if pol.which("payload") != "signature_policy":
            raise ValueError(
                f"collection {conf.name!r}: missing member_orgs_policy")
        self._envelope = pol.signature_policy

    @property
    def name(self) -> str:
        return self._conf.name

    @property
    def required_peer_count(self) -> int:
        return self._conf.required_peer_count

    @property
    def maximum_peer_count(self) -> int:
        return self._conf.maximum_peer_count

    @property
    def block_to_live(self) -> int:
        return self._conf.block_to_live

    @property
    def member_only_read(self) -> bool:
        return self._conf.member_only_read

    @property
    def member_only_write(self) -> bool:
        return self._conf.member_only_write

    def member_orgs(self) -> list[str]:
        """The MSP ids that the member policy's role principals name."""
        return [cb.MSPRole.decode(p.principal).msp_identifier
                for p in self._envelope.identities
                if p.principal_classification == cb.MSPPrincipal.ROLE]

    def is_member(self, serialized_identity: bytes) -> bool:
        """Whether the identity satisfies a principal of the member-orgs
        policy (reference AccessFilter)."""
        try:
            ident = self._deserializer.deserialize_identity(
                serialized_identity)
        except Exception:
            return False
        for principal in self._envelope.identities:
            try:
                self._deserializer.satisfies_principal(ident, principal)
                return True
            except Exception:
                continue
        return False


class CollectionStore:
    """A channel's collections, by chaincode (reference
    core/common/privdata/store.go)."""

    def __init__(self, deserializer):
        self._deserializer = deserializer
        self._packages: dict[str, pb.CollectionConfigPackage] = {}

    def set_collections(self, chaincode: str, package_bytes: bytes) -> None:
        """Install or refresh a chaincode's CollectionConfigPackage (at a
        lifecycle commit); empty bytes remove it."""
        if not package_bytes:
            self._packages.pop(chaincode, None)
            return
        self._packages[chaincode] = pb.CollectionConfigPackage.decode(
            package_bytes)

    def collection(self, chaincode: str, name: str) -> SimpleCollection:
        pkg = self._packages.get(chaincode)
        if pkg is not None:
            for conf in pkg.config:
                if (conf.which("payload") == "static_collection_config"
                        and conf.static_collection_config.name == name):
                    return SimpleCollection(conf.static_collection_config,
                                            self._deserializer)
        raise NoSuchCollectionError(f"{chaincode}/{name}")

    def collections_of(self, chaincode: str) -> list[SimpleCollection]:
        pkg = self._packages.get(chaincode)
        if pkg is None:
            return []
        return [SimpleCollection(c.static_collection_config,
                                 self._deserializer)
                for c in pkg.config
                if c.which("payload") == "static_collection_config"]

    def btl_policy(self):
        """(ns, coll) -> blocks to live, for the private data store."""

        def btl(ns: str, coll: str) -> int:
            try:
                return self.collection(ns, coll).block_to_live
            except NoSuchCollectionError:
                return 0

        return btl

    def is_eligible(self, chaincode: str, coll: str,
                    serialized_identity: bytes) -> bool:
        try:
            return self.collection(chaincode, coll).is_member(
                serialized_identity)
        except NoSuchCollectionError:
            return False


class LedgerBackedCollectionStore(CollectionStore):
    """Collections read from the committed lifecycle definitions at each
    lookup, so an upgrade shows at once."""

    def __init__(self, definition_provider, deserializer):
        """`definition_provider`: anything with
        `collection_config(name, collection)` (chaincode.lifecycle's
        DefinitionProvider or a test's stand-in)."""
        super().__init__(deserializer)
        self._definitions = definition_provider

    def collection(self, chaincode: str, name: str) -> SimpleCollection:
        sc = (self._definitions.collection_config(chaincode, name)
              if self._definitions is not None else None)
        if sc is None:
            raise NoSuchCollectionError(f"{chaincode}/{name}")
        return SimpleCollection(sc, self._deserializer)

    def collections_of(self, chaincode: str) -> list[SimpleCollection]:
        getter = getattr(self._definitions, "definition", None)
        d = getter(chaincode) if getter is not None else None
        if d is None or not d.collections:
            return []
        self.set_collections(chaincode, bytes(d.collections))
        return super().collections_of(chaincode)


def static_collection(name: str, member_mspids: list[str],
                      required_peer_count: int = 0,
                      maximum_peer_count: int = 1, block_to_live: int = 0,
                      member_only_read: bool = True,
                      member_only_write: bool = True,
                      endorsement_policy=None) -> pb.CollectionConfig:
    """A collection's config; `endorsement_policy`, a
    SignaturePolicyEnvelope, gates writes to its keys."""
    from fabric_tpu_torch.policies.signature_policy import (
        signed_by_any_member,
    )

    sc = pb.StaticCollectionConfig(
        name=name,
        member_orgs_policy=pb.CollectionPolicyConfig(
            signature_policy=signed_by_any_member(member_mspids)),
        required_peer_count=required_peer_count,
        maximum_peer_count=maximum_peer_count, block_to_live=block_to_live,
        member_only_read=member_only_read,
        member_only_write=member_only_write)
    if endorsement_policy is not None:
        sc.endorsement_policy = pb.ApplicationPolicy(
            signature_policy=endorsement_policy)
    return pb.CollectionConfig(static_collection_config=sc)


def collection_package(*configs: pb.CollectionConfig
                       ) -> pb.CollectionConfigPackage:
    return pb.CollectionConfigPackage(config=list(configs))


__all__ = [
    "CollectionStore",
    "LedgerBackedCollectionStore",
    "SimpleCollection",
    "NoSuchCollectionError",
    "static_collection",
    "collection_package",
]
