"""Key-level endorsement policies for chaincode authors (the port's copy
of `fabric_tpu/chaincode/statebased.py`; reference chaincode shim
`pkg/statebased` KeyEndorsementPolicy): an N-of-N SignaturePolicyEnvelope
over org principals, attached to a key with
`stub.set_state_validation_parameter(key, policy_bytes)`."""

from __future__ import annotations

from fabric_tpu_torch.protos import common as cb

ROLE_MEMBER = cb.MSPRole.MEMBER
ROLE_PEER = cb.MSPRole.PEER


class KeyEndorsementPolicy:
    """AddOrgs / DelOrgs / ListOrgs / Policy of the reference."""

    def __init__(self, policy_bytes: bytes = b""):
        self._orgs: dict[str, int] = {}
        if policy_bytes:
            env = cb.SignaturePolicyEnvelope.decode(policy_bytes)
            for p in env.identities:
                role = cb.MSPRole.decode(p.principal)
                self._orgs[role.msp_identifier] = role.role

    def add_orgs(self, role: int, *mspids: str) -> None:
        for mspid in mspids:
            self._orgs[mspid] = role

    def del_orgs(self, *mspids: str) -> None:
        for mspid in mspids:
            self._orgs.pop(mspid, None)

    def list_orgs(self) -> list[str]:
        return sorted(self._orgs)

    def policy(self) -> bytes:
        """The marshaled SignaturePolicyEnvelope that requires a signature
        of every listed org."""
        orgs = sorted(self._orgs)
        return cb.SignaturePolicyEnvelope(
            version=0,
            rule=cb.SignaturePolicy(n_out_of=cb.NOutOf(
                n=len(orgs),
                rules=[cb.SignaturePolicy(signed_by=i)
                       for i in range(len(orgs))])),
            identities=[cb.MSPPrincipal(
                principal_classification=cb.MSPPrincipal.ROLE,
                principal=cb.MSPRole(msp_identifier=mspid,
                                     role=self._orgs[mspid]).encode())
                for mspid in orgs]).encode()


__all__ = ["KeyEndorsementPolicy", "ROLE_MEMBER", "ROLE_PEER"]
