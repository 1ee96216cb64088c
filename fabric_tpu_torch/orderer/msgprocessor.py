"""Broadcast-side message processing: classification and the filters
(the port's copy of `fabric_tpu/orderer/msgprocessor.py`; reference
orderer/common/msgprocessor).

A normal message passes the size filter (AbsoluteMaxBytes), the channel
check, the expiration filter (the creator's certificate, in UTC) and the
signature filter (/Channel/Writers, or /Channel/Orderer/Writers while the
channel is in maintenance).  A config update passes the same filters,
then the configtx engine and the maintenance filter (the consensus type
changes only inside maintenance, never on entry or exit, and nothing
outside the Orderer group changes during it), and comes back as a CONFIG
envelope signed by the orderer for the consenter's `configure`.
"""

from __future__ import annotations

import datetime
import enum
import functools
import os

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.msp import x509
from fabric_tpu_torch.protos import common as cb
from fabric_tpu_torch.protos import msp as mb
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protoutil import SignedData

STATE_NORMAL = ob.ConsensusType.STATE_NORMAL
STATE_MAINTENANCE = ob.ConsensusType.STATE_MAINTENANCE


@functools.lru_cache(maxsize=4096)
def _not_valid_after(creator: bytes) -> datetime.datetime | None:
    """The creator certificate's expiry, or None where the creator is no
    certificate (the signature filter refuses what does not deserialize);
    parsed once a creator, where the reference's C parser runs for every
    message."""
    try:
        sid = mb.SerializedIdentity.decode(creator)
        certs = x509.load_pem_certificates(sid.id_bytes)
    except Exception:
        return None
    return certs[0].not_valid_after if certs else None


class Classification(enum.Enum):
    NORMAL = 0
    CONFIG_UPDATE = 1
    CONFIG = 2


class MsgProcessorError(Exception):
    pass


def _headers(env: cb.Envelope) -> tuple[cb.ChannelHeader, cb.SignatureHeader]:
    payload = cb.Payload.decode(env.payload)
    return (cb.ChannelHeader.decode(payload.header.channel_header),
            cb.SignatureHeader.decode(payload.header.signature_header))


class StandardChannelProcessor:
    def __init__(self, channel_id: str, bundle, csp, signer=None):
        self.channel_id = channel_id
        self._bundle = bundle
        self._csp = csp
        self._signer = signer  # the orderer's identity, signs CONFIG envelopes

    @property
    def bundle(self):
        return self._bundle

    def update_bundle(self, bundle) -> None:
        """Adopt the resources of a committed config block."""
        self._bundle = bundle

    def in_maintenance(self) -> bool:
        oc = self._bundle.orderer_config
        return oc is not None and oc.consensus_state == STATE_MAINTENANCE

    def classify(self, env: cb.Envelope,
                 chdr: cb.ChannelHeader | None = None) -> Classification:
        """`chdr`: the envelope's channel header, when the caller has it."""
        chdr = chdr or protoutil.channel_header(env)
        if chdr.type == cb.CONFIG_UPDATE:
            return Classification.CONFIG_UPDATE
        if chdr.type == cb.CONFIG:
            return Classification.CONFIG
        return Classification.NORMAL

    def process_normal_msg(self, env: cb.Envelope, headers=None) -> int:
        """Raises MsgProcessorError on a refusal; returns the config
        sequence the message was checked against.  `headers`: the
        envelope's (channel header, signature header), when the caller
        has them."""
        self._size_filter(env)
        chdr, shdr = headers or _headers(env)
        if chdr.channel_id != self.channel_id:
            raise MsgProcessorError(
                f"message is for channel {chdr.channel_id!r}, this is "
                f"{self.channel_id!r}")
        self._expiration_filter(shdr.creator)
        self._sig_filter(env, shdr)
        return self._bundle.config.sequence

    def _size_filter(self, env: cb.Envelope) -> None:
        oc = self._bundle.orderer_config
        size = len(env.encode())
        if oc and size > oc.absolute_max_bytes:
            raise MsgProcessorError(f"message size {size} exceeds absolute "
                                    f"maximum {oc.absolute_max_bytes}")

    @staticmethod
    def _expiration_filter(creator: bytes) -> None:
        not_after = _not_valid_after(creator)
        if not_after is not None and not_after < datetime.datetime.now(
                datetime.timezone.utc):
            raise MsgProcessorError("creator certificate has expired")

    def _sig_filter(self, env: cb.Envelope, shdr: cb.SignatureHeader) -> None:
        # in maintenance only the orderer's writers may submit
        name = ("/Channel/Orderer/Writers" if self.in_maintenance()
                else "/Channel/Writers")
        policy = self._bundle.policy_manager.get_policy(name)
        sd = [SignedData(env.payload, shdr.creator, env.signature)]
        if not policy.evaluate_signed_data(sd, self._csp):
            raise MsgProcessorError(
                f"message did not satisfy the {name} policy")

    # -- config updates ----------------------------------------------------

    def process_config_update_msg(self, env: cb.Envelope):
        """A CONFIG_UPDATE through the filters, the configtx engine and
        the maintenance filter; returns (the orderer-signed CONFIG
        envelope, the config sequence) for the consenter's `configure`."""
        from fabric_tpu_torch.common.configtx import ConfigtxValidator

        self._size_filter(env)
        chdr, shdr = _headers(env)
        if chdr.channel_id != self.channel_id:
            raise MsgProcessorError(
                f"config update for channel {chdr.channel_id!r}, this is "
                f"{self.channel_id!r}")
        self._expiration_filter(shdr.creator)
        self._sig_filter(env, shdr)
        try:
            update_env = cb.ConfigUpdateEnvelope.decode(
                cb.Payload.decode(env.payload).data)
        except Exception as exc:
            raise MsgProcessorError(f"bad config update: {exc}") from exc
        validator = ConfigtxValidator(
            self.channel_id, self._bundle.config,
            policy_manager=self._bundle.policy_manager, csp=self._csp)
        try:
            cfg_env = validator.propose_config_update(update_env)
        except Exception as exc:
            raise MsgProcessorError(str(exc)) from exc
        self._maintenance_filter(cfg_env.config)
        cfg_env.last_update = env
        if self._signer is None:
            # a CONFIG envelope without a creator would commit as invalid
            raise MsgProcessorError(
                "node has no signing identity to wrap CONFIG envelopes")
        payload_bytes = protoutil.make_payload_bytes(
            protoutil.make_channel_header(cb.CONFIG,
                                          channel_id=self.channel_id),
            protoutil.make_signature_header(self._signer.serialize(),
                                            os.urandom(24)),
            cfg_env.encode())
        new_env = protoutil.make_envelope(payload_bytes, signer=self._signer)
        return new_env, self._bundle.config.sequence

    def _maintenance_filter(self, new_config: cb.Config) -> None:
        """The consensus type may change only while the channel is, and
        stays, in STATE_MAINTENANCE; entering or leaving maintenance
        keeps the type; in maintenance nothing outside the Orderer group
        changes (groups compared by their key-sorted encoding)."""
        from fabric_tpu_torch.common.channelconfig import Bundle

        cur = self._bundle.orderer_config
        if cur is None:
            return
        nxt = Bundle(self.channel_id, cb.Config.decode(new_config.encode()),
                     self._csp).orderer_config
        if nxt is None:
            raise MsgProcessorError("config update removes the Orderer group")
        if cur.consensus_state == STATE_NORMAL:
            if nxt.consensus_type != cur.consensus_type:
                raise MsgProcessorError(
                    "attempted to change consensus type from "
                    f"{cur.consensus_type!r} to {nxt.consensus_type!r} "
                    "outside of maintenance mode")
            return
        if nxt.consensus_state == STATE_NORMAL \
                and nxt.consensus_type != cur.consensus_type:
            raise MsgProcessorError(
                "attempted to change consensus type and exit maintenance "
                "mode in the same update")
        outside = []
        for group in (self._bundle.config.channel_group,
                      new_config.channel_group):
            g = cb.ConfigGroup.decode(group.encode())
            if "Orderer" in g.groups:
                del g.groups["Orderer"]
            outside.append(g.encode(deterministic=True))
        if outside[0] != outside[1]:
            raise MsgProcessorError(
                "config changes outside the Orderer group are not permitted "
                "while the channel is in maintenance mode")


__all__ = ["StandardChannelProcessor", "MsgProcessorError", "Classification",
           "STATE_NORMAL", "STATE_MAINTENANCE"]
