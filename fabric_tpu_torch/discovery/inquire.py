"""Signature-policy introspection: the principal combinations that
satisfy a policy (the port's copy of `fabric_tpu/discovery/inquire.py`;
reference common/policies/inquire).

A satisfaction set is a multiset of principal indices into
`envelope.identities`; the policy passes when, for some set, each listed
principal signs.  The walk of the NOutOf tree combines the children's
sets, capped against combinatorial blowup.
"""

from __future__ import annotations

import itertools

from fabric_tpu_torch.protos import common as cb

MAX_SETS = 1024


def satisfaction_sets(envelope: cb.SignaturePolicyEnvelope
                      ) -> list[tuple[int, ...]]:
    """Every principal-index combination that satisfies the policy, each
    sorted, without repeats, in order, at most MAX_SETS."""
    uniq = sorted({tuple(sorted(s)) for s in _walk(envelope.rule)})
    return uniq[:MAX_SETS]


def _walk(rule: cb.SignaturePolicy) -> list[tuple[int, ...]]:
    which = rule.which("Type")
    if which == "signed_by":
        return [(rule.signed_by,)]
    if which != "n_out_of":
        return []
    n = rule.n_out_of.n
    children = [_walk(r) for r in rule.n_out_of.rules]
    if n <= 0:
        return [()]
    if n > len(children):
        return []
    out: list[tuple[int, ...]] = []
    for combo in itertools.combinations(range(len(children)), n):
        # the product of the chosen children's sets
        for pick in itertools.product(*(children[i] for i in combo)):
            out.append(tuple(idx for s in pick for idx in s))
            if len(out) >= MAX_SETS * 4:
                return out
    return out


__all__ = ["satisfaction_sets", "MAX_SETS"]
