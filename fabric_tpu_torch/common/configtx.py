"""The config-transaction engine (the port's copy of
`fabric_tpu/common/configtx.py`; reference common/configtx validator.go,
update.go, compare.go, and configtxlator's compute-update).

The channel config is a versioned tree (ConfigGroup / ConfigValue /
ConfigPolicy, each with a version and a mod_policy).  A ConfigUpdate
carries a read set and a write set:

- every element of the read set must exist at exactly the stated
  version;
- an element of the write set at its current version is carried through
  unchanged; one bumped by exactly one is a modification, allowed when the
  update's signatures satisfy its current mod_policy (a new element: the
  enclosing group's); a group bumped by one also drops the members its
  write set leaves out;
- the proposed config is the current tree with the write set applied, at
  sequence + 1.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protoutil import SignedData


class ConfigtxError(Exception):
    pass


def _copy(msg):
    return type(msg).decode(msg.encode())


def _map(msg, name: str) -> dict:
    """The map field `name` of `msg`, stored so that it can be written."""
    if name not in msg.__dict__:
        setattr(msg, name, {})
    return getattr(msg, name)


def _values_equal(a: cb.ConfigValue, b: cb.ConfigValue) -> bool:
    return a.value == b.value and a.mod_policy == b.mod_policy


def _policies_equal(a: cb.ConfigPolicy, b: cb.ConfigPolicy) -> bool:
    return a.policy.encode() == b.policy.encode() \
        and a.mod_policy == b.mod_policy


class ConfigtxValidator:
    """One channel's config state machine (reference ValidatorImpl)."""

    def __init__(self, channel_id: str, config: cb.Config,
                 policy_manager=None, csp=None):
        if not channel_id:
            raise ConfigtxError("empty channel id")
        self.channel_id = channel_id
        self.config = config
        self._pm = policy_manager
        self._csp = csp

    @property
    def sequence(self) -> int:
        return self.config.sequence

    def propose_config_update(self, update_env: cb.ConfigUpdateEnvelope
                              ) -> cb.ConfigEnvelope:
        """Validate a signed update against the current config; returns
        the resulting ConfigEnvelope."""
        update = cb.ConfigUpdate.decode(update_env.config_update)
        if update.channel_id != self.channel_id:
            raise ConfigtxError(
                f"update for channel {update.channel_id!r}, "
                f"validator is {self.channel_id!r}")
        current = self.config.channel_group
        self._verify_read_set(current, update.read_set, path="Channel")
        signed_data = self._signed_data(update_env)
        new_group = _copy(current)
        self._apply_write_set(new_group, current, update.write_set,
                              signed_data, path="Channel",
                              parent_mod_policy=current.mod_policy)
        return cb.ConfigEnvelope(config=cb.Config(
            sequence=self.config.sequence + 1, channel_group=new_group))

    def commit(self, env: cb.ConfigEnvelope) -> None:
        """Adopt a validated config (after ordering)."""
        if env.config.sequence != self.config.sequence + 1:
            raise ConfigtxError(
                f"out-of-order config sequence {env.config.sequence}")
        self.config = env.config

    # -- read set ----------------------------------------------------------

    def _verify_read_set(self, current, read_set, path: str) -> None:
        if read_set.version != current.version:
            raise ConfigtxError(f"read_set {path}: version {read_set.version}"
                                f" != current {current.version}")
        for name, g in read_set.groups.items():
            if name not in current.groups:
                raise ConfigtxError(f"read_set group {path}/{name} not found")
            self._verify_read_set(current.groups[name], g, f"{path}/{name}")
        for kind, members in (("value", "values"), ("policy", "policies")):
            cur = getattr(current, members)
            for name, el in getattr(read_set, members).items():
                if name not in cur:
                    raise ConfigtxError(
                        f"read_set {kind} {path}/{name} not found")
                if cur[name].version != el.version:
                    raise ConfigtxError(
                        f"read_set {kind} {path}/{name}: stale version")

    # -- write set ---------------------------------------------------------

    def _check_policy(self, mod_policy: str, path: str, signed_data) -> None:
        if self._pm is None:
            return  # no policy manager: policy gating off (tools, tests)
        if not mod_policy:
            raise ConfigtxError(f"{path}: empty mod_policy rejects changes")
        pol = self._pm.get_policy(
            mod_policy if mod_policy.startswith("/")
            else self._relative(path, mod_policy))
        if not pol.evaluate_signed_data(signed_data, self._csp):
            raise ConfigtxError(
                f"{path}: mod_policy {mod_policy!r} not satisfied")

    @staticmethod
    def _relative(path: str, mod_policy: str) -> str:
        # a mod_policy name resolves in the element's enclosing group; path
        # is "Channel[/seg...]" and the manager tree is rooted at Channel
        segs = path.split("/")[1:]
        return "/".join(segs[:-1] + [mod_policy]) if segs else mod_policy

    def _apply_write_set(self, target, current, write, signed_data,
                         path: str, parent_mod_policy: str) -> None:
        """Apply `write` over `target` (a copy of `current`), holding the
        version arithmetic and the mod policies."""
        if write.version == current.version + 1:
            # the group itself changes (membership, mod_policy)
            self._check_policy(current.mod_policy or parent_mod_policy, path,
                               signed_data)
            target.version = write.version
            target.mod_policy = write.mod_policy or current.mod_policy
            # a member the write set leaves out is removed
            for members in ("groups", "values", "policies"):
                kept = getattr(write, members)
                tmap = _map(target, members)
                for name in [n for n in tmap if n not in kept]:
                    del tmap[name]
        elif write.version != current.version:
            raise ConfigtxError(
                f"write_set {path}: version {write.version} not in "
                f"{{{current.version}, {current.version + 1}}}")
        enclosing = current.mod_policy or parent_mod_policy
        for kind, members, equal in (("value", "values", _values_equal),
                                     ("policy", "policies", _policies_equal)):
            cur_map = getattr(current, members)
            for name, w in getattr(write, members).items():
                cur = cur_map.get(name)
                p = f"{path}/{name}"
                if cur is None:
                    if w.version != 0:
                        raise ConfigtxError(f"new {kind} {p} must be version 0")
                    self._check_policy(enclosing, p, signed_data)
                    _map(target, members)[name] = _copy(w)
                elif w.version == cur.version:
                    if not equal(w, cur):
                        raise ConfigtxError(
                            f"{kind} {p} changed without version bump")
                elif w.version == cur.version + 1:
                    self._check_policy(cur.mod_policy, p, signed_data)
                    _map(target, members)[name] = _copy(w)
                else:
                    raise ConfigtxError(f"{kind} {p}: bad version {w.version}")
        for name, wg in write.groups.items():
            cur = current.groups.get(name)
            p = f"{path}/{name}"
            if cur is None:
                if wg.version != 0:
                    raise ConfigtxError(f"new group {p} must be version 0")
                self._check_policy(enclosing, p, signed_data)
                _map(target, "groups")[name] = _copy(wg)
            else:
                self._apply_write_set(target.groups[name], cur, wg,
                                      signed_data, p, enclosing)

    # -- signatures --------------------------------------------------------

    @staticmethod
    def _signed_data(update_env: cb.ConfigUpdateEnvelope) -> list[SignedData]:
        out = []
        for cs in update_env.signatures:
            shdr = cb.SignatureHeader.decode(cs.signature_header)
            out.append(SignedData(
                data=cs.signature_header + update_env.config_update,
                identity=shdr.creator, signature=cs.signature))
        return out


# ---------------------------------------------------------------------------
# The delta (configtxlator's compute-update).
# ---------------------------------------------------------------------------


def compute_update(channel_id: str, original: cb.Config,
                   updated: cb.Config) -> cb.ConfigUpdate:
    """The least ConfigUpdate that turns `original` into `updated`."""
    read, write, changed = _compute_group_delta(original.channel_group,
                                                updated.channel_group)
    if not changed:
        raise ConfigtxError("no differences between original and updated")
    return cb.ConfigUpdate(channel_id=channel_id, read_set=read,
                           write_set=write)


def _at_version(el, version: int):
    out = _copy(el)
    out.version = version
    return out


def _compute_group_delta(orig: cb.ConfigGroup, new: cb.ConfigGroup):
    """Returns (read group, write group, changed)."""
    read = cb.ConfigGroup(version=orig.version)
    write = cb.ConfigGroup(version=orig.version, mod_policy=orig.mod_policy)
    wvalues, wpolicies = _map(write, "values"), _map(write, "policies")
    wgroups, rgroups = _map(write, "groups"), _map(read, "groups")
    members_changed = (set(orig.groups) != set(new.groups)
                       or set(orig.values) != set(new.values)
                       or set(orig.policies) != set(new.policies)
                       or orig.mod_policy != new.mod_policy)
    changed = members_changed
    for omap, nmap, wmap, equal in (
            (orig.values, new.values, wvalues, _values_equal),
            (orig.policies, new.policies, wpolicies, _policies_equal)):
        for name, o in omap.items():
            n = nmap.get(name)
            if n is None:
                changed = True
            elif not equal(o, n):
                changed = True
                wmap[name] = _at_version(n, o.version + 1)
        for name, n in nmap.items():
            if name not in omap:
                changed = True
                wmap[name] = _at_version(n, 0)
            elif equal(omap[name], n):
                # unchanged: carried in the write set at its version
                wmap[name] = _at_version(n, omap[name].version)
    for name, og in orig.groups.items():
        ng = new.groups.get(name)
        if ng is None:
            changed = True
            continue
        _, sub_write, sub_changed = _compute_group_delta(og, ng)
        if sub_changed:
            changed = True
            wgroups[name] = sub_write
            # the read set names the group at its current version
            rgroups[name] = cb.ConfigGroup(version=og.version)
        else:
            wgroups[name] = cb.ConfigGroup(version=og.version)
    for name, ng in new.groups.items():
        if name not in orig.groups:
            changed = True
            wgroups[name] = _at_version(ng, 0)
    if members_changed:
        write.version = orig.version + 1
        write.mod_policy = new.mod_policy or orig.mod_policy
        # unchanged members stay, so that the removal rule spares them
        for name, ov in orig.values.items():
            if name in new.values and name not in wvalues:
                wvalues[name] = _at_version(new.values[name], ov.version)
    return read, write, changed


__all__ = ["ConfigtxValidator", "ConfigtxError", "compute_update"]
