"""The port's channel config layer against the JAX package's.

The same inputs go through `fabric_tpu.common.configtx` /
`capabilities` / `channelconfig` / `configtx_builder` and through their
copies in `fabric_tpu_torch.common`:

- `ConfigtxValidator.propose_config_update` on the reference's cases
  (`tests/test_configtx.py`) and on updates signed by real identities and
  judged by each package's policy manager: the same resulting Config
  (its key-sorted encoding, byte for byte) or the same error class and
  message;
- `compute_update` gives the same update, which both validators accept;
- the capability registries give the same verdicts;
- a genesis block's Bundle gives the same orderer config, application
  config and ACLs, and the builders write the same groups.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.common import capabilities as jcap
from fabric_tpu.common import configtx_builder as jctx
from fabric_tpu.common.channelconfig import Bundle as JaxBundle
from fabric_tpu.common.channelconfig import bundle_from_genesis as jax_bundle
from fabric_tpu.common.configtx import ConfigtxError as JaxConfigtxError
from fabric_tpu.common.configtx import ConfigtxValidator as JaxValidator
from fabric_tpu.common.configtx import compute_update as jax_compute
from fabric_tpu.csp import SWCSP
from fabric_tpu.protos.common import common_pb2, configtx_pb2
from fabric_tpu.protos.msp import msp_config_pb2
from fabric_tpu.protos.peer import configuration_pb2 as peer_config_pb2
from fabric_tpu_torch import protoutil as port_pu
from fabric_tpu_torch.common import capabilities as pcap
from fabric_tpu_torch.common import configtx_builder as pctx
from fabric_tpu_torch.common.channelconfig import Bundle as PortBundle
from fabric_tpu_torch.common.channelconfig import (
    bundle_from_genesis as port_bundle,
)
from fabric_tpu_torch.common.configtx import ConfigtxError as PortConfigtxError
from fabric_tpu_torch.common.configtx import ConfigtxValidator as PortValidator
from fabric_tpu_torch.common.configtx import compute_update as port_compute
from fabric_tpu_torch.common.crypto import CA
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.msp.config import msp_config_from_ca
from fabric_tpu_torch.protos import common as cb

CH = "ch"


# -- the reference's cases ------------------------------------------------------


def _base_config() -> configtx_pb2.Config:
    cfg = configtx_pb2.Config(sequence=3)
    ch = cfg.channel_group
    ch.mod_policy = "Admins"
    app = ch.groups["Application"]
    app.mod_policy = "Admins"
    app.version = 1
    v = app.values["BatchSize"]
    v.value = b"100"
    v.version = 2
    v.mod_policy = "Admins"
    p = app.policies["Writers"]
    p.policy.type = 1
    p.mod_policy = "Admins"
    return cfg


class _AllowPolicy:
    def __init__(self, allow):
        self.allow = allow

    def evaluate_signed_data(self, signed_data, csp):
        return self.allow


class _PM:
    def __init__(self, allow=True):
        self.policy = _AllowPolicy(allow)
        self.requested = []

    def get_policy(self, name):
        self.requested.append(name)
        return self.policy


def _value_update(value: bytes, version: int, read_version=None):
    upd = configtx_pb2.ConfigUpdate(channel_id=CH)
    if read_version is not None:
        upd.read_set.groups["Application"].version = read_version
    w = upd.write_set.groups["Application"]
    w.version = 1
    nv = w.values["BatchSize"]
    nv.value = value
    nv.version = version
    nv.mod_policy = "Admins"
    return upd


def _new_value_update():
    upd = configtx_pb2.ConfigUpdate(channel_id=CH)
    w = upd.write_set.groups["Application"]
    w.version = 2  # membership change: BatchSize and Writers kept
    w.mod_policy = "Admins"
    for name in ("BatchSize",):
        w.values[name].CopyFrom(_base_config().channel_group
                                .groups["Application"].values[name])
    w.policies["Writers"].CopyFrom(_base_config().channel_group
                                   .groups["Application"].policies["Writers"])
    w.values["Extra"].value = b"new"
    w.values["Extra"].mod_policy = "Admins"
    return upd


def _removal_update():
    upd = configtx_pb2.ConfigUpdate(channel_id=CH)
    w = upd.write_set.groups["Application"]
    w.version = 2  # BatchSize left out: removed
    w.mod_policy = "Admins"
    w.policies["Writers"].CopyFrom(_base_config().channel_group
                                   .groups["Application"].policies["Writers"])
    return upd


def _new_group_update(version: int):
    upd = configtx_pb2.ConfigUpdate(channel_id=CH)
    g = upd.write_set.groups["Orderer"]
    g.version = version
    g.mod_policy = "Admins"
    g.values["BatchTimeout"].value = b"2s"
    upd.write_set.groups["Application"].version = 1
    return upd


def _group_jump_update():
    upd = _value_update(b"200", 3, read_version=1)
    upd.write_set.groups["Application"].version = 3
    return upd


CASES = {
    "happy_path": (_value_update(b"200", 3, read_version=1), True),
    "stale_read_set": (_value_update(b"200", 3, read_version=7), True),
    "wrong_channel": (configtx_pb2.ConfigUpdate(channel_id="other"), True),
    "mod_policy_denial": (_value_update(b"999", 3), False),
    "no_version_bump": (_value_update(b"changed-silently", 2), True),
    "skipped_version": (_value_update(b"x", 5), True),
    "new_value": (_new_value_update(), True),
    "removed_value": (_removal_update(), True),
    "new_group": (_new_group_update(0), True),
    "new_group_not_at_zero": (_new_group_update(1), True),
    "group_version_jump": (_group_jump_update(), True),
}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the class and message are compared
        return type(e).__name__, str(e)


def _propose(pkg, cfg_bytes, update_bytes, pm, csp=None, signatures=()):
    if pkg == "jax":
        val = JaxValidator(CH, configtx_pb2.Config.FromString(cfg_bytes),
                           policy_manager=pm, csp=csp)
        env = configtx_pb2.ConfigUpdateEnvelope(config_update=update_bytes)
        for hdr, sig in signatures:
            env.signatures.add(signature_header=hdr, signature=sig)
        kind, got = _outcome(lambda: val.propose_config_update(env))
        if kind == "ok":
            got = got.config.SerializeToString(deterministic=True)
        return kind, got, val
    val = PortValidator(CH, cb.Config.decode(cfg_bytes), policy_manager=pm,
                        csp=csp)
    env = cb.ConfigUpdateEnvelope(
        config_update=update_bytes,
        signatures=[cb.ConfigSignature(signature_header=h, signature=s)
                    for h, s in signatures])
    kind, got = _outcome(lambda: val.propose_config_update(env))
    if kind == "ok":
        got = got.config.encode(deterministic=True)
    return kind, got, val


@pytest.mark.parametrize("case", sorted(CASES))
def test_propose_config_update_as_the_reference(case):
    upd, allow = CASES[case]
    base = _base_config().SerializeToString()
    raw = upd.SerializeToString()
    jpm, ppm = _PM(allow), _PM(allow)
    jkind, jgot, _ = _propose("jax", base, raw, jpm)
    pkind, pgot, _ = _propose("port", base, raw, ppm)
    assert (pkind, pgot) == (jkind, jgot)
    assert ppm.requested == jpm.requested
    if jkind == "ok":  # the port decodes the reference's result the same
        assert cb.Config.decode(jgot).encode(deterministic=True) == jgot
    expected = {"happy_path": "ok", "new_value": "ok", "removed_value": "ok",
                "new_group": "ok"}.get(case, "ConfigtxError")
    assert jkind == expected


def test_commit_and_out_of_order_commit_as_the_reference():
    base = _base_config().SerializeToString()
    raw = CASES["happy_path"][0].SerializeToString()
    jkind, jcfg, jval = _propose("jax", base, raw, _PM())
    pkind, pcfg, pval = _propose("port", base, raw, _PM())
    jval.commit(configtx_pb2.ConfigEnvelope(
        config=configtx_pb2.Config.FromString(jcfg)))
    pval.commit(cb.ConfigEnvelope(config=cb.Config.decode(pcfg)))
    assert jval.sequence == pval.sequence == 4
    stale = configtx_pb2.ConfigEnvelope()
    stale.config.sequence = 99
    with pytest.raises(JaxConfigtxError, match="out-of-order"):
        jval.commit(stale)
    with pytest.raises(PortConfigtxError, match="out-of-order"):
        pval.commit(cb.ConfigEnvelope.decode(stale.SerializeToString()))
    with pytest.raises(PortConfigtxError, match="empty channel id"):
        PortValidator("", cb.Config())


def _updated(mutate) -> tuple[bytes, bytes]:
    original = _base_config()
    updated = configtx_pb2.Config()
    updated.CopyFrom(original)
    mutate(updated)
    return original.SerializeToString(), updated.SerializeToString()


def _set_batch(c):
    c.channel_group.groups["Application"].values["BatchSize"].value = b"512"


def _add_group(c):
    g = c.channel_group.groups["Orderer"]
    g.mod_policy = "Admins"
    g.values["BatchTimeout"].value = b"1s"


def _drop_value(c):
    del c.channel_group.groups["Application"].values["BatchSize"]


def _new_policy(c):
    p = c.channel_group.groups["Application"].policies["Readers"]
    p.policy.type = 3
    p.policy.value = b"\x0a\x07Readers"
    p.mod_policy = "Admins"


def _mod_policy(c):
    c.channel_group.groups["Application"].mod_policy = "Writers"


def _same(c):
    pass


@pytest.mark.parametrize("mutate", [_set_batch, _add_group, _drop_value,
                                    _new_policy, _mod_policy, _same],
                         ids=lambda f: f.__name__.strip("_"))
def test_compute_update_round_trips_as_the_reference(mutate):
    orig, new = _updated(mutate)
    jkind, jupd = _outcome(lambda: jax_compute(
        CH, configtx_pb2.Config.FromString(orig),
        configtx_pb2.Config.FromString(new)))
    pkind, pupd = _outcome(lambda: port_compute(
        CH, cb.Config.decode(orig), cb.Config.decode(new)))
    if jkind != "ok":
        assert (pkind, pupd) == (jkind, jupd) == (
            "ConfigtxError", "no differences between original and updated")
        return
    jraw = jupd.SerializeToString(deterministic=True)
    assert pkind == "ok" and pupd.encode(deterministic=True) == jraw
    # both validators take the update to the updated config
    jkind, jcfg, _ = _propose("jax", orig, jupd.SerializeToString(), _PM())
    pkind, pcfg, _ = _propose("port", orig, pupd.encode(), _PM())
    assert jkind == pkind == "ok" and pcfg == jcfg
    want = configtx_pb2.Config.FromString(new)
    want.sequence += 1
    got = configtx_pb2.Config.FromString(jcfg)
    assert got.channel_group.groups["Application"].values.keys() == \
        want.channel_group.groups["Application"].values.keys()


# -- mod policies judged by real identities ------------------------------------


@pytest.fixture(scope="module")
def world():
    return chip_smoke.validator_world(21)


def _signed_batch_update(world, signers, timeout: str):
    """An update of /Channel/Orderer/BatchTimeout signed by `signers`."""
    jcfg = jax_bundle(common_pb2.Block.FromString(world.genesis),
                      SWCSP()).config
    new = configtx_pb2.Config()
    new.CopyFrom(jcfg)
    from fabric_tpu.protos.orderer import configuration_pb2 as ocp

    new.channel_group.groups["Orderer"].values[
        jctx.BATCH_TIMEOUT_KEY].value = ocp.BatchTimeout(
        timeout=timeout).SerializeToString()
    upd = jax_compute(world_channel(), jcfg, new).SerializeToString()
    sigs = []
    for s in signers:
        hdr = port_pu.make_signature_header(s.serialize(), b"n" * 24).encode()
        sigs.append((hdr, s.sign(hdr + upd)))
    return jcfg.SerializeToString(), upd, sigs


def world_channel() -> str:
    return chip_smoke.VALIDATOR_CHANNEL


@pytest.mark.parametrize("who", ["orderer_admin", "client", "nobody"])
def test_mod_policy_with_signatures_as_the_reference(world, who):
    signers = {"orderer_admin": [chip_smoke.orderer_identity(
        world, "oadmin", "admin")], "client": [world.client],
        "nobody": []}[who]
    cfg, upd, sigs = _signed_batch_update(world, signers, "250ms")
    jb = jax_bundle(common_pb2.Block.FromString(world.genesis), SWCSP())
    pb_ = port_bundle(world.genesis)
    outs = []
    for pkg, bundle, csp, Val in (("jax", jb, SWCSP(), JaxValidator),
                                  ("port", pb_, HostCSP(), PortValidator)):
        if pkg == "jax":
            val = Val(world_channel(), configtx_pb2.Config.FromString(cfg),
                      policy_manager=bundle.policy_manager, csp=csp)
            env = configtx_pb2.ConfigUpdateEnvelope(config_update=upd)
            for h, s in sigs:
                env.signatures.add(signature_header=h, signature=s)
            kind, got = _outcome(lambda: val.propose_config_update(env))
            got = (got.config.SerializeToString(deterministic=True)
                   if kind == "ok" else got)
        else:
            val = Val(world_channel(), cb.Config.decode(cfg),
                      policy_manager=bundle.policy_manager, csp=csp)
            env = cb.ConfigUpdateEnvelope(config_update=upd, signatures=[
                cb.ConfigSignature(signature_header=h, signature=s)
                for h, s in sigs])
            kind, got = _outcome(lambda: val.propose_config_update(env))
            got = got.config.encode(deterministic=True) if kind == "ok" \
                else got
        outs.append((kind, got))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("ok" if who == "orderer_admin" else "ConfigtxError")


# -- capabilities ---------------------------------------------------------------

CAPS = [[], ["V2_0"], ["V1_3"], ["V1_4_2"], ["V1_1", "V1_2"], ["V9_9"],
        ["V2_0", "V1_4_3"], ["V1_4_3"]]


@pytest.mark.parametrize("names", CAPS, ids=lambda n: "+".join(n) or "none")
def test_capability_verdicts_as_the_reference(names):
    raw = jcap.capabilities_value(names).SerializeToString()
    assert pcap.capabilities_value(names).encode(deterministic=True) == \
        jcap.capabilities_value(names).SerializeToString(deterministic=True)
    jcaps, pcaps = jcap.parse_capabilities(raw), pcap.parse_capabilities(raw)
    assert pcaps == jcaps
    for kind, props in (("Channel", ("consensus_type_migration",)),
                        ("Application", ("lifecycle_v20",
                                         "key_level_endorsement",
                                         "private_channel_data",
                                         "storage_pvt_data_experimental")),
                        ("Orderer", ("use_channel_creation_policy_as_admins",))):
        j = getattr(jcap, f"{kind}Capabilities")(jcaps)
        p = getattr(pcap, f"{kind}Capabilities")(pcaps)
        assert _outcome(j.supported) == _outcome(p.supported)
        assert p.required() == j.required()
        for prop in props:
            assert getattr(p, prop) == getattr(j, prop)


# -- the bundle and the builders ------------------------------------------------


def _groups(seed: int = 5):
    """The same org, application and orderer groups from both builders."""
    rng = np.random.default_rng(seed)
    cas = [CA(f"ca.org{i}", f"Org{i}MSP", rng=rng) for i in (1, 2)]
    oca = CA("ca.orderer", "OrdererMSP", rng=rng)
    confs = {f"Org{i}MSP": msp_config_from_ca(ca, f"Org{i}MSP")
             for i, ca in zip((1, 2), cas)}
    confs["OrdererMSP"] = msp_config_from_ca(oca, "OrdererMSP")
    acls = {"peer/Propose": "/Channel/Application/Writers",
            "event/Block": "/Channel/Application/Readers"}
    batch = dict(consensus_type="kafka", consensus_metadata=b"meta",
                 max_message_count=7, absolute_max_bytes=99_999,
                 preferred_max_bytes=4096, batch_timeout="250ms")
    out = {}
    for pkg, ctx in (("jax", jctx), ("port", pctx)):
        def conf(mspid):
            c = confs[mspid]
            return (msp_config_pb2.MSPConfig.FromString(c.encode())
                    if pkg == "jax" else c)

        app = ctx.application_group(
            {f"Org{i}": ctx.org_group(f"Org{i}MSP", conf(f"Org{i}MSP"),
                                      anchor=[("peer0", 7051)])
             for i in (1, 2)}, acls=acls)
        ordg = ctx.orderer_group(
            {"O": ctx.org_group("OrdererMSP", conf("OrdererMSP"))}, **batch)
        out[pkg] = (app, ordg, ctx.orderer_group(
            {"O": ctx.org_group("OrdererMSP", conf("OrdererMSP"))}),
            ctx.channel_group(app, ordg, orderer_addresses=["o1:7050",
                                                            "o2:7050"]))
    return out


def _det(msg) -> bytes:
    return (msg.SerializeToString(deterministic=True)
            if hasattr(msg, "SerializeToString")
            else msg.encode(deterministic=True))


def _without_acls(raw: bytes) -> tuple[bytes, dict]:
    """A group's key-sorted encoding with its application's ACLs value
    taken out, and that value decoded (protobuf writes a map in an order
    of its own, so the value's bytes differ from package to package)."""
    g = configtx_pb2.ConfigGroup.FromString(raw)
    app = g.groups["Application"] if "Application" in g.groups else g
    acls = peer_config_pb2.ACLs.FromString(app.values[jctx.ACLS_KEY].value)
    del app.values[jctx.ACLS_KEY]
    return (g.SerializeToString(deterministic=True),
            {k: v.policy_ref for k, v in acls.acls.items()})


def test_builders_write_the_same_groups():
    out = _groups()
    for k, (j, p) in enumerate(zip(out["jax"], out["port"])):
        if k in (0, 3):  # the application group, alone and in the channel
            got, want = _without_acls(_det(p)), _without_acls(_det(j))
            assert got == want and len(got[1]) == 2
        else:
            assert _det(p) == _det(j)
    # the anchor peers given to org_group are written nowhere, in both
    # packages (ROADMAP Queue C)
    for pkg in ("jax", "port"):
        orgs = out[pkg][0].groups
        assert len(orgs) == 2
        assert all("AnchorPeers" not in g.values and len(g.values) == 1
                   for g in orgs.values())


def test_bundle_configs_as_the_reference():
    out = _groups()
    chan = out["port"][3]
    genesis = pctx.genesis_block("bch", chan, nonce=b"x" * 24, timestamp=7)
    raw = genesis.encode()
    jb = jax_bundle(common_pb2.Block.FromString(raw), SWCSP())
    pb_ = port_bundle(raw, HostCSP())
    assert dataclasses.asdict(pb_.orderer_config) == \
        dataclasses.asdict(jb.orderer_config)
    assert pb_.orderer_config.consensus_type == "kafka"
    assert pb_.orderer_config.batch_timeout_s == 0.25
    assert dataclasses.asdict(pb_.application_config) == \
        dataclasses.asdict(jb.application_config)
    assert pb_.acls == jb.acls and len(pb_.acls) == 2
    assert pb_.channel_id == jb.channel_id == "bch"
    # no orderer and no application group
    bare = cb.Config(sequence=4, channel_group=pctx.channel_group(None, None))
    jbare = JaxBundle("bch", configtx_pb2.Config.FromString(bare.encode()))
    pbare = PortBundle("bch", bare)
    assert pbare.orderer_config is jbare.orderer_config is None
    assert pbare.application_config is jbare.application_config is None
    assert pbare.acls == jbare.acls == {}


def test_default_orderer_group_is_unchanged_by_the_new_arguments(world):
    """The default orderer group is byte-equal to one given the defaults
    by name, and the world's genesis bundle reads them back."""
    out = _groups()
    explicit = out["port"][2]
    again = pctx.orderer_group(explicit.groups, consensus_type="solo",
                               consensus_metadata=b"", max_message_count=500,
                               absolute_max_bytes=10 * 1024 * 1024,
                               preferred_max_bytes=2 * 1024 * 1024,
                               batch_timeout="2s")
    assert again.encode() == explicit.encode()
    oc = port_bundle(world.genesis).orderer_config
    assert (oc.consensus_type, oc.max_message_count, oc.batch_timeout_s) == \
        ("solo", 500, 2.0)
