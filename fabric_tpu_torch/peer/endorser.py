"""Endorsement: simulate a proposal and sign the result (the port's copy
of `fabric_tpu/peer/endorser.py`; reference core/endorser/endorser.go
ProcessProposal, preProcess, SimulateProposal, and the builtin
endorsement plugin).

The creator's signature is verified through the endorser's CSP as a
one-lane `verify_batch` of `creator.verification_item(...)`; under the
CSP's `min_device_batch` that lane takes its host route.  Proposals are
not batched, as the reference does not batch them.
"""

from __future__ import annotations

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.peer import aclmgmt
from fabric_tpu_torch.protos import peer as pb
from fabric_tpu_torch.protoutil import SignedData


class EndorserError(Exception):
    pass


class ACLDeniedError(EndorserError):
    pass


class Endorser:
    def __init__(self, channel_id: str, ledger, bundle, signer,
                 chaincodes: dict, csp,
                 acl_provider: aclmgmt.ACLProvider | None = None,
                 pvt_handoff=None):
        """`chaincodes`: name -> fn(tx_simulator, args: list[bytes]) ->
        (status, message, payload).

        `acl_provider` is by default one over the channel config's ACLs
        (`bundle.acls`): the check runs before simulation, as the
        reference peer's (per-function resources for the system
        chaincodes, `aclmgmt.SCC_FUNCTION_RESOURCES`).

        `pvt_handoff(txid, pvt_bytes)` receives the cleartext private
        results before the endorsement returns (a transient store and
        gossip); its failure fails the endorsement.  Without it the
        cleartext is dropped; the response carries the hashes either
        way."""
        self.channel_id = channel_id
        self._ledger = ledger
        self._bundle = bundle
        self._signer = signer
        self._chaincodes = chaincodes
        self._csp = csp
        self._acl = acl_provider or aclmgmt.ACLProvider(
            getattr(bundle, "acls", None), csp=csp)
        self._pvt_handoff = pvt_handoff

    def _check_acl(self, up, signed: pb.SignedProposal) -> None:
        """peer/Propose for an application chaincode; the catalogued
        resource of the function for a system chaincode."""
        fn = (up.input.args[0].decode("utf-8", "replace")
              if up.input.args else "")
        try:
            resource = aclmgmt.resource_for_chaincode(up.chaincode_name, fn)
        except aclmgmt.ACLError as exc:  # an uncatalogued SCC function
            raise ACLDeniedError(str(exc)) from exc
        sd = SignedData(signed.proposal_bytes, up.signature_header.creator,
                        signed.signature)
        try:
            self._acl.check_acl(resource, self._bundle.policy_manager, sd)
        except aclmgmt.ACLError as exc:
            raise ACLDeniedError(str(exc)) from exc

    def _check_creator(self, up, signed: pb.SignedProposal) -> None:
        """The proposal's structure, its txid and its creator."""
        if up.channel_header.channel_id != self.channel_id:
            raise EndorserError("wrong channel")
        if not protoutil.check_tx_id(up.channel_header.tx_id,
                                     up.signature_header.nonce,
                                     up.signature_header.creator):
            raise EndorserError("tx id does not bind to nonce+creator")
        try:
            creator = self._bundle.msp_manager.deserialize_identity(
                up.signature_header.creator)
            self._bundle.msp_manager.validate(creator)
        except Exception as exc:
            raise EndorserError(f"creator identity invalid: {exc}") from exc
        item = creator.verification_item(signed.proposal_bytes,
                                         signed.signature)
        if not self._csp.verify_batch([item])[0]:
            raise EndorserError("invalid creator signature on proposal")

    def process_proposal(self, signed: pb.SignedProposal
                         ) -> pb.ProposalResponse:
        up = protoutil.unpack_proposal(signed)
        self._check_creator(up, signed)
        self._check_acl(up, signed)
        return self.endorse(up)

    def endorse(self, up: protoutil.UnpackedProposal) -> pb.ProposalResponse:
        """Simulate a checked proposal and sign its results."""
        cc = self._chaincodes.get(up.chaincode_name)
        if cc is None:
            raise EndorserError(
                f"chaincode {up.chaincode_name!r} not installed")
        sim = self._ledger.new_tx_simulator()
        status, message, payload = cc(sim, list(up.input.args))
        if status >= 400:
            # a failed simulation: no endorsement, the error response
            return pb.ProposalResponse(response=pb.Response(
                status=status, message=message))
        results = sim.get_tx_simulation_results()
        # the cleartext private writes leave before the endorsement does;
        # only their hashes ride the response
        pvt = (sim.get_pvt_simulation_results()
               if hasattr(sim, "get_pvt_simulation_results") else None)
        if pvt is not None and self._pvt_handoff is not None:
            try:
                self._pvt_handoff(up.channel_header.tx_id, pvt)
            except Exception as exc:
                raise EndorserError(
                    f"private data distribution failed: {exc}") from exc
        return protoutil.create_proposal_response(
            up.proposal, results=results, events=b"",
            response=pb.Response(status=status, message=message,
                                 payload=payload),
            chaincode_id=pb.ChaincodeID(name=up.chaincode_name),
            endorser_signer=self._signer)


__all__ = ["Endorser", "EndorserError", "ACLDeniedError"]
