"""Signature-policy compilation and evaluation (the port's copy of
`fabric_tpu/policies/signature_policy.py`; reference cauthdsl).

`prepare(signed_data)` deserializes and dedups the identities and returns
the verify items without verifying; the caller batches items of many
policies into one verify; `PendingEvaluation.finish(mask)` runs the
compiled closure over the identities whose signatures verified, one
signature satisfying at most one leaf.  `evaluate_signed_data` is the
one-shot path: its own verify of its own items."""

from __future__ import annotations

import dataclasses

from fabric_tpu_torch.csp.api import P256_GX, P256_GY, P256PublicKey, \
    VerifyBatchItem
from fabric_tpu_torch.protos import common as cb


class PolicyError(Exception):
    pass


def _compile(policy: cb.SignaturePolicy, identities, deserializer):
    """SignaturePolicy tree -> closure(valid_identities, used) -> bool."""
    which = policy.which("Type")
    if which == "signed_by":
        idx = policy.signed_by
        if idx < 0 or idx >= len(identities):
            raise PolicyError(f"identity index {idx} out of range")
        principal = identities[idx]

        def signed_by(valid, used):
            for pos, ident in enumerate(valid):
                if used[pos] or ident is None:
                    continue
                try:
                    deserializer.satisfies_principal(ident, principal)
                except Exception:
                    # fabriclint: allow[exception-discipline] principal
                    # mismatch is the expected per-lane outcome, not an error
                    continue
                used[pos] = True
                return True
            return False

        return signed_by
    if which == "n_out_of":
        n = policy.n_out_of.n
        subs = [_compile(r, identities, deserializer)
                for r in policy.n_out_of.rules]

        def n_out_of(valid, used):
            verified = 0
            for sub in subs:
                trial = list(used)
                if sub(valid, trial):
                    verified += 1
                    used[:] = trial
            return verified >= n

        return n_out_of
    raise PolicyError(f"unknown signature policy type {which!r}")


@dataclasses.dataclass
class PendingEvaluation:
    """Feed `items` to a batch verify, then `finish(mask)`."""

    items: list
    _closure: object
    _identities: list  # deserialized identity per item (None if bad)

    def finish(self, mask) -> bool:
        if len(mask) != len(self.items):
            raise PolicyError("mask length mismatch")
        valid = [ident if ok and ident is not None else None
                 for ident, ok in zip(self._identities, mask)]
        return self._closure(valid, [False] * len(valid))


# an item that never verifies (malformed DER): the lane of an identity
# that does not deserialize keeps its place in the batch
_DUMMY = VerifyBatchItem(P256PublicKey(P256_GX, P256_GY), b"\x00" * 32,
                         b"\x30\x00")


class SignaturePolicy:
    """A compiled SignaturePolicyEnvelope bound to a deserializer."""

    def __init__(self, envelope: cb.SignaturePolicyEnvelope, deserializer):
        if envelope.version != 0:
            raise PolicyError(f"unsupported policy version {envelope.version}")
        self._envelope = envelope
        self._deserializer = deserializer
        self._closure = _compile(envelope.rule, list(envelope.identities),
                                 deserializer)

    def prepare(self, signed_data) -> PendingEvaluation:
        """Deserialize and dedup identities (repeated identity bytes count
        once, one item); verify nothing."""
        seen: dict[bytes, int] = {}
        items, idents = [], []
        for sd in signed_data:
            if sd.identity in seen:
                continue
            seen[sd.identity] = len(items)
            try:
                ident = self._deserializer.deserialize_identity(sd.identity)
            except Exception:
                ident = None  # gets the never-verifying item
            idents.append(ident)
            if ident is None:
                items.append(_DUMMY)
            elif sd.digest is not None:
                items.append(VerifyBatchItem(ident.public_key, sd.digest,
                                             sd.signature))
            else:
                items.append(ident.verification_item(sd.data, sd.signature))
        return PendingEvaluation(items, self._closure, idents)

    def evaluate_signed_data(self, signed_data, csp) -> bool:
        """prepare, one `csp.verify_batch`, finish."""
        pending = self.prepare(signed_data)
        return pending.finish(csp.verify_batch(pending.items))


def signed_by_any_member(mspids) -> cb.SignaturePolicyEnvelope:
    """A 1-of-N member policy over the MSPs (reference policydsl
    SignedByAnyMember)."""
    return cb.SignaturePolicyEnvelope(
        version=0,
        rule=cb.SignaturePolicy(n_out_of=cb.NOutOf(n=1, rules=[
            cb.SignaturePolicy(signed_by=i) for i in range(len(mspids))])),
        identities=[cb.MSPPrincipal(
            principal_classification=cb.MSPPrincipal.ROLE,
            principal=cb.MSPRole(msp_identifier=mspid,
                                 role=cb.MSPRole.MEMBER).encode())
            for mspid in mspids])


__all__ = ["PolicyError", "PendingEvaluation", "SignaturePolicy",
           "signed_by_any_member"]
