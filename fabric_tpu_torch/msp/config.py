"""MSP configuration from an in-memory CA (the port's copy of
`fabric_tpu/msp/config.py`'s `msp_config_from_ca`)."""

from __future__ import annotations

from fabric_tpu_torch.protos import msp as mb


def msp_config_from_ca(ca, mspid: str, intermediates: list | None = None,
                       crls: list[bytes] | None = None) -> mb.MSPConfig:
    """An X.509 MSP with NodeOUs (client, peer, admin and orderer OUs)
    rooted at `ca` (anything with `cert_pem`: the port's
    `common.crypto.CA`), its intermediates and CRLs."""
    fconf = mb.FabricMSPConfig(
        name=mspid,
        root_certs=[ca.cert_pem],
        intermediate_certs=[ic.cert_pem for ic in intermediates or []],
        revocation_list=crls or [],
        crypto_config=mb.FabricCryptoConfig(
            signature_hash_family="SHA2",
            identity_identifier_hash_function="SHA256"),
        fabric_node_ous=mb.FabricNodeOUs(enable=True, **{
            f"{role}_ou_identifier": mb.FabricOUIdentifier(
                organizational_unit_identifier=role)
            for role in ("client", "peer", "admin", "orderer")}),
    )
    return mb.MSPConfig(type=0, config=fconf.encode())


__all__ = ["msp_config_from_ca"]
