"""Hierarchical policy manager and implicit meta policies (the port's copy
of `fabric_tpu/policies/manager.py`; reference common/policies): a policy
namespace addressed by path (`/Channel/Application/Endorsement`), where
ANY/ALL/MAJORITY combine the same-named policy of each sub-group.  Every
policy speaks the prepare/finish protocol, and evaluates one-shot through
`evaluate_signed_data(signed_data, csp)`."""

from __future__ import annotations

from fabric_tpu_torch.common.hashing import sha256
from fabric_tpu_torch.policies.signature_policy import (
    PendingEvaluation,
    PolicyError,
    SignaturePolicy,
)
from fabric_tpu_torch.protos import common as cb

CHANNEL_READERS = "Readers"
CHANNEL_WRITERS = "Writers"
CHANNEL_ADMINS = "Admins"
BLOCK_VALIDATION = "BlockValidation"


class _MetaPending:
    def __init__(self, pendings: list[PendingEvaluation], threshold: int):
        self._pendings = pendings
        self._threshold = threshold
        self.items = [it for p in pendings for it in p.items]

    def finish(self, mask) -> bool:
        if len(mask) != len(self.items):
            raise PolicyError("mask length mismatch")
        satisfied = 0
        off = 0
        for p in self._pendings:
            n = len(p.items)
            if p.finish(mask[off:off + n]):
                satisfied += 1
            off += n
        return satisfied >= self._threshold


class ImplicitMetaPolicy:
    """ANY/ALL/MAJORITY of the same-named policy across sub-managers."""

    def __init__(self, sub_policies: list, rule: int):
        self._subs = sub_policies
        R = cb.ImplicitMetaPolicy
        if rule == R.ANY:
            self._threshold = min(1, len(sub_policies))
        elif rule == R.ALL:
            self._threshold = len(sub_policies)
        elif rule == R.MAJORITY:
            self._threshold = len(sub_policies) // 2 + 1
        else:
            raise PolicyError(f"unknown implicit meta rule {rule}")

    def prepare(self, signed_data):
        # every sub-policy reads the same messages: hash each once
        signed_data = [sd if sd.digest is not None
                       else sd._replace(digest=sha256(sd.data))
                       for sd in signed_data]
        return _MetaPending([p.prepare(signed_data) for p in self._subs],
                            self._threshold)

    def evaluate_signed_data(self, signed_data, csp) -> bool:
        """One `csp.verify_batch` of the sub-policies' distinct lanes: each
        sub-policy names the same signatures (six lanes of one signature
        under /Channel/Writers), and equal lanes have equal verdicts."""
        pending = self.prepare(signed_data)
        lanes = [(it.key.x, it.key.y, it.digest, it.signature)
                 for it in pending.items]
        first = dict(zip(lanes, pending.items))
        verdict = dict(zip(first, csp.verify_batch(list(first.values()))))
        return pending.finish([verdict[lane] for lane in lanes])


class RejectPolicy:
    """Stands for an absent or unparsable policy: always rejects, and
    `reason` says why."""

    def __init__(self, name: str, reason: str = ""):
        self.name = name
        self.reason = reason or f"policy {name!r} is not defined"

    def prepare(self, signed_data):
        return _MetaPending([], 1)

    def evaluate_signed_data(self, signed_data, csp) -> bool:
        return False


class Manager:
    """A node of the policy namespace tree."""

    def __init__(self, path: str, policies: dict, sub_managers: dict):
        self.path = path
        self._policies = policies
        self._subs = sub_managers

    def manager(self, relpath: list[str]) -> "Manager | None":
        m = self
        for seg in relpath:
            m = m._subs.get(seg)
            if m is None:
                return None
        return m

    def get_policy(self, name: str):
        """Relative names ("Writers"), absolute paths
        ("/Channel/Application/Writers") and slashed relative paths."""
        if name.startswith("/"):
            segs = [s for s in name.split("/") if s]
            m = self
            if segs and segs[0] == "Channel" and self.path in ("Channel", ""):
                segs = segs[1:]
            for seg in segs[:-1]:
                m = m._subs.get(seg)
                if m is None:
                    return RejectPolicy(name)
            if not segs:
                return RejectPolicy(name)
            return m._policies.get(segs[-1], RejectPolicy(name))
        if "/" in name:
            segs = [s for s in name.split("/") if s]
            m = self.manager(segs[:-1])
            if m is None:
                return RejectPolicy(name)
            return m._policies.get(segs[-1], RejectPolicy(name))
        return self._policies.get(name, RejectPolicy(name))


def manager_from_config_group(path: str, group: cb.ConfigGroup,
                              deserializer) -> Manager:
    """The manager tree of a channel config group."""
    subs = {
        name: manager_from_config_group(f"{path}/{name}" if path else name,
                                        g, deserializer)
        for name, g in group.groups.items()
    }
    policies: dict[str, object] = {}
    metas: list[tuple[str, cb.ImplicitMetaPolicy]] = []
    for name, cfg_policy in group.policies.items():
        pol = cfg_policy.policy
        if pol.type == cb.Policy.SIGNATURE:
            try:
                env = cb.SignaturePolicyEnvelope.decode(pol.value)
                policies[name] = SignaturePolicy(env, deserializer)
            except Exception as exc:
                policies[name] = RejectPolicy(
                    name, reason=f"unparsable SIGNATURE policy: {exc}")
        elif pol.type == cb.Policy.IMPLICIT_META:
            metas.append((name, cb.ImplicitMetaPolicy.decode(pol.value)))
        else:
            policies[name] = RejectPolicy(
                name, reason=f"unsupported policy type {pol.type}")
    for name, meta in metas:
        sub_pols = []
        for sm in subs.values():
            p = sm._policies.get(meta.sub_policy)
            if p is not None and not isinstance(p, RejectPolicy):
                sub_pols.append(p)
        if sub_pols:
            policies[name] = ImplicitMetaPolicy(sub_pols, meta.rule)
        else:
            policies[name] = RejectPolicy(
                name, reason=f"implicit meta policy over {meta.sub_policy!r} "
                             f"resolved zero sub-policies")
    return Manager(path, policies, subs)


__all__ = ["Manager", "ImplicitMetaPolicy", "RejectPolicy",
           "manager_from_config_group", "CHANNEL_READERS", "CHANNEL_WRITERS",
           "CHANNEL_ADMINS", "BLOCK_VALIDATION"]
