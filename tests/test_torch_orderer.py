"""The port's ordering service against the JAX package's.

The same envelopes, made from a seed (chip_smoke's 5-org channel: its
blocks with the validator's planted faults, and crafted refusals), go
through the JAX `Registrar` / `BroadcastHandler` (on `SWCSP`) and through
the port's (on `HostCSP`), each with its own orderer identity certified
by the same CA (one key, one certificate):

- solo and kafka: the same broadcast statuses, block data, headers
  (number, previous hash, data hash), last-config index and kafka offset
  metadata; each package's block signatures verify under the other's
  `verify_block_signature`;
- the maintenance filter's rules, and a migration solo -> kafka through
  maintenance mode: the same verdicts and blocks (a config block's
  orderer-made envelope compared by its config and its last update: its
  nonce, timestamp and signature are the orderer's own);
- the follower and inactive chains, and `demote_evicted`;
- a restart: each package's Registrar resumes on the other's root at its
  height, with the genesis bundle and last-config index 0, as the
  reference does (ROADMAP Queue C);
- a single-node etcdraft channel orders the same blocks in both.
"""

import dataclasses
import time
import types

import pytest

import chip_smoke
from fabric_tpu.common.configtx import compute_update as jax_compute
from fabric_tpu.csp import SWCSP
from fabric_tpu.msp import SigningIdentity as JaxSigner
from fabric_tpu.orderer import follower as jax_follower
from fabric_tpu.orderer import msgprocessor as jax_mp
from fabric_tpu.orderer.blockwriter import (
    verify_block_signature as jax_verify,
)
from fabric_tpu.orderer.broadcast import BroadcastHandler as JaxHandler
from fabric_tpu.orderer.kafka import InProcBroker as JaxBroker
from fabric_tpu.orderer.kafka import KafkaChain as JaxKafka
from fabric_tpu.orderer.multichannel import Registrar as JaxRegistrar
from fabric_tpu.protos.common import common_pb2, configtx_pb2
from fabric_tpu.protos.orderer import configuration_pb2 as jax_ocp
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.common import workpool
from fabric_tpu_torch.csp.hostref import HostCSP
from fabric_tpu_torch.devtools import lockwatch as port_lw
from fabric_tpu_torch.msp.identity import SigningIdentity as PortSigner
from fabric_tpu_torch.orderer import follower as port_follower
from fabric_tpu_torch.orderer import msgprocessor as port_mp
from fabric_tpu_torch.orderer.blockwriter import (
    verify_block_signature as port_verify,
)
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler as PortHandler
from fabric_tpu_torch.orderer.kafka import InProcBroker as PortBroker
from fabric_tpu_torch.orderer.kafka import KafkaChain as PortKafka
from fabric_tpu_torch.orderer.multichannel import Registrar as PortRegistrar
from fabric_tpu_torch.protos import common as cb

CH = chip_smoke.VALIDATOR_CHANNEL
MAX_COUNT = 11  # 22 admitted envelopes: two blocks, no timer cut
LONG_TIMEOUT = "60s"


@pytest.fixture(scope="module", autouse=True)
def _port_watch_gate():
    """The port's lockwatch ledgers are empty and its workers drained at
    the end of this file."""
    yield
    workpool.shutdown()
    assert not port_lw.drain_threads(timeout=15.0)
    assert not port_lw.violations and not port_lw.thread_violations


class World:
    def __init__(self):
        self.w = chip_smoke.validator_world(31)
        self.orderer = self.pair("orderer0", "orderer")
        self.admin = self.pair("oadmin", "admin")
        blocks, _, _ = chip_smoke.validator_blocks(self.w, 3, 8, b"")
        self.envs = [e for raw in blocks
                     for e in cb.Block.decode(raw).data.data]

    def pair(self, name, ou):
        """The same identity for both packages."""
        pair = self.w.orderer_ca.issue(name, ous=[ou])
        return types.SimpleNamespace(
            port=PortSigner("OrdererMSP", pair.cert, pair.key, self.w.rng),
            jax=JaxSigner.from_pem("OrdererMSP", pair.cert_pem, pair.key_pem,
                                   SWCSP()))

    def genesis(self, consensus="solo", max_count=MAX_COUNT,
                timeout=LONG_TIMEOUT, absolute=6000) -> bytes:
        return chip_smoke.order_genesis(
            self.w, max_message_count=max_count, preferred_max_bytes=1 << 20,
            absolute_max_bytes=absolute, batch_timeout=timeout,
            consensus_type=consensus)


@pytest.fixture(scope="module")
def world():
    return World()


PKG = {
    "jax": types.SimpleNamespace(
        Registrar=JaxRegistrar, Handler=JaxHandler, Broker=JaxBroker,
        Kafka=JaxKafka, csp=SWCSP, env=common_pb2.Envelope.FromString,
        block=common_pb2.Block.FromString, verify=jax_verify,
        encode=lambda m: m.SerializeToString(), mp=jax_mp,
        follower=jax_follower),
    "port": types.SimpleNamespace(
        Registrar=PortRegistrar, Handler=PortHandler, Broker=PortBroker,
        Kafka=PortKafka, csp=HostCSP, env=cb.Envelope.decode,
        block=cb.Block.decode, verify=port_verify,
        encode=lambda m: m.encode(), mp=port_mp, follower=port_follower),
}


def _registrar(pkg, root, genesis: bytes, signer, broker=None):
    p = PKG[pkg]
    reg = p.Registrar(str(root), p.csp(), signer=getattr(signer, pkg),
                      consenter_overrides={"broker": broker or p.Broker()})
    reg.startup([p.block(genesis)])
    return reg


def _wait_height(reg, height: int, timeout: float = 30.0) -> int:
    cs = reg.get_chain(CH)
    deadline = time.monotonic() + timeout
    while cs.store.height < height and time.monotonic() < deadline:
        time.sleep(0.01)
    return cs.store.height


def _crafted(world) -> list[bytes]:
    """Refusals the planted block does not hold: another channel, an
    envelope over AbsoluteMaxBytes, a raw CONFIG, a CONFIG_UPDATE whose
    data is no ConfigUpdateEnvelope, a creator that is no identity."""
    client = world.w.client

    def env(htype, channel, data, signer=client, creator=None, pad=b""):
        chdr = pu.make_channel_header(htype, channel, timestamp=7)
        shdr = pu.make_signature_header(
            signer.serialize() if creator is None else creator, b"n" * 24)
        raw = pu.make_payload_bytes(chdr, shdr, data)
        return cb.Envelope(payload=raw,
                           signature=signer.sign(raw) + pad).encode()

    return [env(cb.ENDORSER_TRANSACTION, "nochannel", b"x"),
            env(cb.ENDORSER_TRANSACTION, CH, b"x", pad=b"\x00" * 7000),
            env(cb.CONFIG, CH, b"x"),
            env(cb.CONFIG_UPDATE, CH, b"\xff\xff"),
            env(cb.ENDORSER_TRANSACTION, CH, b"x", creator=b"not an id")]


def _stream(world) -> list[bytes]:
    crafted = _crafted(world)
    out = list(world.envs)
    for k, raw in enumerate(crafted):
        out.insert(3 + 4 * k, raw)
    return out


def _broadcast(pkg, reg, envs) -> list[int]:
    h = PKG[pkg].Handler(reg)
    return [h.process_message(PKG[pkg].env(raw)) for raw in envs]


def _last_config(pkg, blk) -> int:
    raw = blk.metadata.metadata[0]
    if pkg == "jax":
        meta = common_pb2.Metadata.FromString(raw)
        return common_pb2.OrdererBlockMetadata.FromString(
            meta.value).last_config.index
    return cb.OrdererBlockMetadata.decode(
        cb.Metadata.decode(raw).value).last_config.index


def _view(pkg, reg, start: int = 1) -> list[tuple]:
    """(number, previous hash, data hash, data, last config, ORDERER
    metadata) of each block from `start`."""
    store = reg.get_chain(CH).store
    out = []
    for n in range(start, store.height):
        blk = store.get_block_by_number(n)
        out.append((blk.header.number, bytes(blk.header.previous_hash),
                    bytes(blk.header.data_hash),
                    [bytes(d) for d in blk.data.data],
                    _last_config(pkg, blk), bytes(blk.metadata.metadata[3])))
    return out


def _policy(pkg, reg):
    return reg.get_chain(CH).bundle.policy_manager.get_policy(
        "/Channel/Orderer/BlockValidation")


@pytest.mark.parametrize("consensus", ["solo", "kafka"])
def test_orderers_cut_and_sign_the_same_blocks(world, tmp_path, consensus):
    genesis = world.genesis(consensus)
    envs = _stream(world)
    regs, statuses, views = {}, {}, {}
    try:
        for pkg in ("jax", "port"):
            regs[pkg] = _registrar(pkg, tmp_path / pkg, genesis,
                                   world.orderer)
            statuses[pkg] = _broadcast(pkg, regs[pkg], envs)
            assert _wait_height(regs[pkg], 3) == 3
            views[pkg] = _view(pkg, regs[pkg])
        assert statuses["port"] == statuses["jax"]
        refused = sorted((i, s) for i, s in enumerate(statuses["jax"])
                         if s != cb.SUCCESS)
        assert [s for _, s in refused].count(cb.FORBIDDEN) == 4
        assert [s for _, s in refused].count(cb.BAD_REQUEST) == 2
        assert [s for _, s in refused].count(cb.NOT_FOUND) == 1
        assert views["port"] == views["jax"]
        assert [len(v[3]) for v in views["port"]] == [MAX_COUNT, MAX_COUNT]
        # each package's signatures verify under the other's check
        for signer, checker in (("jax", "port"), ("port", "jax")):
            store = regs[signer].get_chain(CH).store
            for n in (1, 2):
                blk = PKG[checker].block(
                    PKG[signer].encode(store.get_block_by_number(n)))
                assert PKG[checker].verify(
                    blk, _policy(checker, regs[checker]),
                    PKG[checker].csp())
            # a flipped signature byte fails both checks
            blk = store.get_block_by_number(1)
            raw = bytearray(PKG[signer].encode(blk))
            meta = cb.Metadata.decode(cb.Block.decode(bytes(raw))
                                      .metadata.metadata[0])
            sig = bytearray(meta.signatures[0].signature)
            sig[-1] ^= 1
            meta.signatures[0].signature = bytes(sig)
            bad = cb.Block.decode(bytes(raw))
            bad.metadata.metadata[0] = meta.encode()
            for pkg in ("jax", "port"):
                assert not PKG[pkg].verify(
                    PKG[pkg].block(bad.encode()), _policy(pkg, regs[pkg]),
                    PKG[pkg].csp())
    finally:
        for reg in regs.values():
            reg.halt_all()


def test_etcdraft_channel_raises_the_named_error(world, tmp_path):
    """Once a pin of the port's missing raft consenter, now a parity test
    on the same inputs (its name kept): an etcdraft channel with no
    consenter metadata runs one raft node (id 1) in both packages, which
    cut the same blocks of the admitted envelopes."""
    genesis = world.genesis("etcdraft")
    views = {}
    for pkg in ("jax", "port"):
        p = PKG[pkg]
        reg = p.Registrar(str(tmp_path / pkg), p.csp(),
                          signer=getattr(world.orderer, pkg))
        try:
            reg.startup([p.block(genesis)])
            chain = reg.get_chain(CH).chain
            assert type(chain).__name__ == "RaftChain"
            deadline = time.monotonic() + 10
            while not chain.is_leader and time.monotonic() < deadline:
                time.sleep(0.01)
            assert chain.is_leader
            for raw in world.envs[:2 * MAX_COUNT]:
                chain.order(p.env(raw))
            assert _wait_height(reg, 3) == 3
            views[pkg] = _view(pkg, reg)
        finally:
            reg.halt_all()
    assert views["port"] == views["jax"]
    assert [v[3] for v in views["port"]] == [
        world.envs[:MAX_COUNT], world.envs[MAX_COUNT:2 * MAX_COUNT]]


# -- a restart over the other package's root -------------------------------------


def _update_env(world, current_cfg_bytes: bytes, mutate) -> bytes:
    """A CONFIG_UPDATE envelope (built and signed once, fed to both
    packages) that applies `mutate` to the current config, signed by the
    orderer org's admin."""
    cur = configtx_pb2.Config.FromString(current_cfg_bytes)
    new = configtx_pb2.Config()
    new.CopyFrom(cur)
    mutate(new)
    upd = jax_compute(CH, cur, new).SerializeToString()
    admin = world.admin.port
    shdr = pu.make_signature_header(admin.serialize(), b"u" * 24).encode()
    ue = cb.ConfigUpdateEnvelope(config_update=upd, signatures=[
        cb.ConfigSignature(signature_header=shdr,
                           signature=admin.sign(shdr + upd))])
    payload = pu.make_payload_bytes(
        pu.make_channel_header(cb.CONFIG_UPDATE, CH, timestamp=9),
        pu.make_signature_header(admin.serialize(), b"v" * 24), ue.encode())
    return pu.make_envelope(payload, admin).encode()


def _config_bytes(pkg, reg) -> bytes:
    cfg = reg.get_chain(CH).bundle.config
    return (cfg.SerializeToString(deterministic=True) if pkg == "jax"
            else cfg.encode(deterministic=True))


def _set_consensus(cfg, ctype=None, state=None, timeout=None):
    og = cfg.channel_group.groups["Orderer"]
    ct = jax_ocp.ConsensusType.FromString(og.values["ConsensusType"].value)
    if ctype is not None:
        ct.type = ctype
    if state is not None:
        ct.state = state
    og.values["ConsensusType"].value = ct.SerializeToString()
    if timeout is not None:
        og.values["BatchTimeout"].value = jax_ocp.BatchTimeout(
            timeout=timeout).SerializeToString()


def _config_view(view) -> list[tuple]:
    """A block view with each CONFIG envelope reduced to its config's
    key-sorted encoding and its last update, and without the hashes (the
    orderer's own envelope, its nonce, timestamp and signature, differs
    from package to package, and so does every later block's previous
    hash)."""
    out = []
    for num, _prev, _dhash, data, last, orderer_meta in view:
        env = cb.Envelope.decode(data[0])
        payload = cb.Payload.decode(env.payload)
        if cb.ChannelHeader.decode(payload.header.channel_header).type \
                == cb.CONFIG:
            cfg = cb.ConfigEnvelope.decode(payload.data)
            data = [cfg.config.encode(deterministic=True),
                    cfg.last_update.encode()]
        out.append((num, data, last, orderer_meta))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_registrar_resumes_on_the_other_packages_root(world, tmp_path,
                                                      writer, reader):
    """The writer orders two blocks and a config block (BatchTimeout
    changed) and halts; the reader's Registrar opens the same root with
    the genesis block, resumes at its height, and cuts the next block on
    the writer's last header.  Both packages resume with the genesis
    bundle (sequence 0) and write last-config index 0 after the config
    block: the reference's restart, pinned."""
    genesis = world.genesis()
    root = tmp_path / "root"
    envs = world.envs[:MAX_COUNT]
    reg = _registrar(writer, root, genesis, world.orderer)
    try:
        st = _broadcast(writer, reg, world.envs)
        assert st.count(cb.SUCCESS) == 22 and _wait_height(reg, 3) == 3
        upd = _update_env(world, _config_bytes(writer, reg),
                          lambda c: _set_consensus(c, timeout="59s"))
        assert _broadcast(writer, reg, [upd]) == [cb.SUCCESS]
        assert _wait_height(reg, 4) == 4
        # the registrar swaps the bundle on the chain's thread after the
        # block's write, so the new sequence may lag the height
        deadline = time.monotonic() + 10
        while reg.get_chain(CH).bundle.config.sequence != 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert reg.get_chain(CH).bundle.config.sequence == 1
        last = PKG[writer].encode(reg.get_chain(CH).store
                                  .get_block_by_number(3))
    finally:
        reg.halt_all()
    again = _registrar(reader, root, genesis, world.orderer)
    try:
        cs = again.get_chain(CH)
        assert cs.store.height == 4
        assert cs.bundle.config.sequence == 0  # the genesis bundle
        assert PKG[reader].encode(cs.store.get_block_by_number(3)) == last
        assert _broadcast(reader, again, envs) == \
            [cb.SUCCESS] * MAX_COUNT
        assert _wait_height(again, 5) == 5
        view = _view(reader, again, start=3)
        head = cb.Block.decode(last).header
        assert view[1][0] == 4 and view[1][1] == pu.block_header_hash(head)
        assert view[0][4] == 3  # the config block names itself
        assert view[1][4] == 0  # the resumed writer: last config 0
        assert PKG[reader].verify(
            PKG[reader].block(PKG[reader].encode(
                cs.store.get_block_by_number(4))),
            _policy(reader, again), PKG[reader].csp())
    finally:
        again.halt_all()


# -- maintenance mode and migration ------------------------------------------------


def _maintenance_verdicts(pkg, reg) -> list[str]:
    """The reference's test_maintenance_filter_unit_rules matrix on one
    package's processor."""
    cs = reg.get_chain(CH)
    proc = cs.processor
    mp = PKG[pkg].mp
    cur = _config_bytes(pkg, reg)

    def cfg_with(ctype=None, state=None, drop_orderer=False, taint=False):
        c = configtx_pb2.Config.FromString(cur)
        c.sequence += 1
        if drop_orderer:
            del c.channel_group.groups["Orderer"]
        else:
            _set_consensus(c, ctype=ctype, state=state)
        if taint:
            c.channel_group.groups["Application"].version += 1
        raw = c.SerializeToString()
        return (configtx_pb2.Config.FromString(raw) if pkg == "jax"
                else cb.Config.decode(raw))

    def verdict(cfg):
        try:
            proc._maintenance_filter(cfg)
            return "ok"
        except mp.MsgProcessorError as e:
            return f"refused: {e}"

    out = [verdict(cfg_with(ctype="kafka")),
           verdict(cfg_with(state=mp.STATE_MAINTENANCE)),
           verdict(cfg_with(drop_orderer=True))]
    oc = cs.bundle.orderer_config
    cs.bundle.orderer_config = dataclasses.replace(
        oc, consensus_state=mp.STATE_MAINTENANCE)
    try:
        out += [verdict(cfg_with(ctype="kafka", state=mp.STATE_MAINTENANCE)),
                verdict(cfg_with(ctype="kafka", state=mp.STATE_NORMAL)),
                verdict(cfg_with(ctype="kafka", state=mp.STATE_MAINTENANCE,
                                 taint=True)),
                verdict(cfg_with(state=mp.STATE_MAINTENANCE))]
    finally:
        cs.bundle.orderer_config = oc
    return out


def test_maintenance_filter_rules_as_the_reference(world, tmp_path):
    genesis = world.genesis(max_count=1)
    got = {}
    for pkg in ("jax", "port"):
        reg = _registrar(pkg, tmp_path / pkg, genesis, world.orderer)
        try:
            got[pkg] = _maintenance_verdicts(pkg, reg)
        finally:
            reg.halt_all()
    assert got["port"] == got["jax"]
    assert [v == "ok" for v in got["port"]] == [False, True, False, True,
                                                False, False, True]


def test_consensus_migration_through_maintenance_mode(world, tmp_path):
    """Both packages take the same config updates and client envelopes:
    a type change refused outside maintenance; maintenance entered;
    clients refused in it, and an exit that changes the type; the type
    changed to kafka inside it (the registrar swaps the consenter);
    maintenance left; a client envelope ordered by kafka."""
    genesis = world.genesis(max_count=1)
    client = world.envs[0]
    regs, statuses = {}, {"jax": [], "port": []}
    M, N = jax_mp.STATE_MAINTENANCE, jax_mp.STATE_NORMAL
    steps = [(dict(ctype="kafka"), 1), (dict(state=M), 2), ("client", 2),
             (dict(ctype="kafka", state=N), 2), (dict(ctype="kafka"), 3),
             (dict(state=N), 4), ("client", 5)]
    try:
        for pkg in ("jax", "port"):
            regs[pkg] = _registrar(pkg, tmp_path / pkg, genesis,
                                   world.orderer)
        for step, height in steps:
            # a registrar swaps its bundle after the config block's write,
            # on the chain's thread: wait out that swap, not only the height
            deadline = time.monotonic() + 10
            while True:
                cur = {pkg: _config_bytes(pkg, regs[pkg]) for pkg in regs}
                if cur["port"] == cur["jax"] or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            assert cur["port"] == cur["jax"]
            if step == "client":
                raw = client
            else:
                raw = _update_env(world, cur["jax"],
                                  lambda c, s=step: _set_consensus(c, **s))
            for pkg in ("jax", "port"):
                statuses[pkg] += _broadcast(pkg, regs[pkg], [raw])
                assert _wait_height(regs[pkg], height) == height
            if height == 3 and step != "client":
                for pkg in ("jax", "port"):
                    deadline = time.monotonic() + 10
                    while not isinstance(regs[pkg].get_chain(CH).chain,
                                         PKG[pkg].Kafka) \
                            and time.monotonic() < deadline:
                        time.sleep(0.02)
                    assert isinstance(regs[pkg].get_chain(CH).chain,
                                      PKG[pkg].Kafka)
        assert statuses["port"] == statuses["jax"] == [
            cb.FORBIDDEN, cb.SUCCESS, cb.FORBIDDEN, cb.FORBIDDEN,
            cb.SUCCESS, cb.SUCCESS, cb.SUCCESS]
        views = {pkg: _config_view(_view(pkg, regs[pkg])) for pkg in regs}
        assert views["port"] == views["jax"]
        assert [v[2] for v in views["port"]] == [1, 2, 3, 3]
        for pkg in regs:
            assert not regs[pkg].get_chain(CH).processor.in_maintenance()
    finally:
        for reg in regs.values():
            reg.halt_all()


# -- the follower and inactive chains ----------------------------------------------


def _follow(pkg, blocks: list[bytes], join_at: int):
    """A FollowerChain over `blocks` (pulled by height; the first pull of
    block 2 fails) that joins at the config block `join_at`; returns
    (the numbers written, joined, its height, wait_ready's error)."""
    f = PKG[pkg].follower
    written, failed = [], []

    def puller(height):
        if height == 2 and not failed:
            failed.append(height)
            raise OSError("transient")
        raw = blocks[height] if height < len(blocks) else None
        return None if raw is None else PKG[pkg].block(raw)

    chain = f.FollowerChain(
        CH, 1, puller, lambda blk: written.append(blk.header.number),
        lambda blk: blk.header.number == join_at, poll_interval_s=0.01)
    chain.start()
    chain.joined.wait(10)
    chain.halt()
    with pytest.raises(f.NotServicedError) as err:
        chain.wait_ready()
    return written, chain.joined.is_set(), chain.height, str(err.value)


def test_follower_and_inactive_chains_as_the_reference(world, tmp_path):
    genesis = world.genesis(max_count=1)
    reg = _registrar("port", tmp_path / "src", genesis, world.orderer)
    try:
        h = PKG["port"].Handler(reg)
        raw = _update_env(world, _config_bytes("port", reg),
                          lambda c: _set_consensus(c, timeout="58s"))
        for env in (world.envs[0], raw, world.envs[2]):
            assert h.process_message(cb.Envelope.decode(env)) == cb.SUCCESS
        assert _wait_height(reg, 4) == 4
        store = reg.get_chain(CH).store
        blocks = [store.get_block_by_number(n).encode() for n in range(4)]
    finally:
        reg.halt_all()
    got = {pkg: _follow(pkg, blocks, join_at=2) for pkg in PKG}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ([1, 2], True, 3)
    for pkg in PKG:
        f = PKG[pkg].follower
        chain = f.InactiveChain(CH)
        for call in (chain.wait_ready, lambda: chain.order(None),
                     lambda: chain.configure(None)):
            with pytest.raises(f.NotServicedError, match="not serviced"):
                call()


@pytest.mark.parametrize("puller", [False, True])
def test_demote_evicted_as_the_reference(world, tmp_path, puller):
    """demote_evicted swaps the consenter for a FollowerChain (a puller
    configured) or an InactiveChain; a broadcast then raises the chain's
    NotServicedError out of process_message, in both packages."""
    genesis = world.genesis(max_count=1)
    kinds = {}
    for pkg in PKG:
        p = PKG[pkg]
        over = {"broker": p.Broker()}
        if puller:
            over["follower_puller"] = lambda height: None
        reg = p.Registrar(str(tmp_path / pkg), p.csp(),
                          signer=getattr(world.orderer, pkg),
                          consenter_overrides=over)
        reg.startup([p.block(genesis)])
        try:
            reg.demote_evicted(CH)
            chain = reg.get_chain(CH).chain
            kinds[pkg] = type(chain).__name__
            with pytest.raises(p.follower.NotServicedError):
                p.Handler(reg).process_message(p.env(world.envs[0]))
        finally:
            reg.halt_all()
        reg.demote_evicted(CH)  # refused after halt_all: no new chain
        assert type(reg.get_chain(CH).chain).__name__ == kinds[pkg]
    assert kinds["port"] == kinds["jax"] == (
        "FollowerChain" if puller else "InactiveChain")
