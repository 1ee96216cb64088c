"""Shared CLI plumbing (the port's copy of `fabric_tpu/cmd/common.py`;
reference cmd/common + internal/peer/common): MSP-folder signer loading,
endpoint parsing, TLS flags, proposal and transaction helpers."""

from __future__ import annotations

import argparse
import os

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.comm import RPCClient
from fabric_tpu_torch.msp.identity import SigningIdentity
from fabric_tpu_torch.protos import orderer as ob
from fabric_tpu_torch.protos import peer as pb


def parse_endpoint(s: str, default_host: str = "127.0.0.1") -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or default_host, int(port))


def tls_parent() -> argparse.ArgumentParser:
    """Parent parser contributing the TLS flags every network-touching
    subcommand shares (reference peer CLI --tls/--cafile/--certfile/
    --keyfile; here a cryptogen-layout tls dir + extra roots)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument(
        "--tls-dir", default=None,
        help="dir with {server|client}.{crt,key} + ca.crt (cryptogen tls/)",
    )
    p.add_argument(
        "--tls-root", action="append", default=[],
        help="extra trusted TLS root CA PEM file (repeatable; other orgs)",
    )
    return p


def tls_from_args(args):
    """TLSCredentials from --tls-dir/--tls-root, or None (plaintext)."""
    d = getattr(args, "tls_dir", None)
    if not d:
        return None
    from fabric_tpu_torch.comm.tls import credentials_from_files

    stem = "server" if os.path.exists(os.path.join(d, "server.crt")) else "client"
    return credentials_from_files(
        os.path.join(d, f"{stem}.crt"),
        os.path.join(d, f"{stem}.key"),
        [os.path.join(d, "ca.crt")] + list(getattr(args, "tls_root", []) or []),
    )


def load_signer(msp_dir: str, mspid: str) -> SigningIdentity:
    """The signing identity of an MSP directory's signcerts + keystore
    (reference msp/configbuilder.go GetLocalMspConfig); it signs through
    the port's `hostref`."""

    def first(sub):
        d = os.path.join(msp_dir, sub)
        names = sorted(os.listdir(d))
        with open(os.path.join(d, names[0]), "rb") as f:
            return f.read()

    return SigningIdentity.from_pem(mspid, first("signcerts"),
                                    first("keystore"))


def endorse(
    peer_endpoints: list[tuple[str, int]],
    signer: SigningIdentity,
    channel_id: str,
    cc_name: str,
    args: list[bytes],
    tls=None,
):
    """Send a signed proposal to each peer; returns (proposal, responses)."""
    prop, _txid = protoutil.create_chaincode_proposal(
        signer.serialize(), channel_id, cc_name, args
    )
    raw = prop.encode()
    signed = pb.SignedProposal(proposal_bytes=raw, signature=signer.sign(raw))
    responses = []
    for ep in peer_endpoints:
        out = RPCClient(*ep, tls=tls).call(
            "endorser.ProcessProposal", signed.encode()
        )
        responses.append(pb.ProposalResponse.decode(out))
    return prop, responses


def submit(
    orderer_endpoint: tuple[str, int],
    signer: SigningIdentity,
    prop,
    responses,
    tls=None,
) -> int:
    """Assemble the signed transaction and broadcast it; returns status."""
    env = protoutil.create_signed_tx(prop, signer, responses)
    raw = RPCClient(*orderer_endpoint, tls=tls).call(
        "ab.Broadcast", env.encode()
    )
    return ob.BroadcastResponse.decode(raw).status


__all__ = ["parse_endpoint", "load_signer", "endorse", "submit",
           "tls_parent", "tls_from_args"]
