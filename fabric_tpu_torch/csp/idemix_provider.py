"""Idemix CSP of the port: presentation signatures over BN254, with the
batched verify's Schnorr recomputation on the CUDA card.

Counterpart of `fabric_tpu/csp/idemix_provider.py` (reference
bccsp/idemix/bccsp.go and its handlers): issuer and user key generation,
credential request/issue/verify, presentation sign/verify (single and
batched), nym sign/verify and the revocation authority's CRI, as
explicit methods over `fabric_tpu_torch.idemix`.  The revocation
authority signs with the port's P-384 (`csp/hostref384.py`).

`verify_batch` picks the device path by batch size, as the reference
provider does, but the device is fixed at construction: `device="cuda"`
(the default) raises there on a host without a card, and `device="cpu"`
runs the kernel's plain PyTorch version (for tests).  A runtime fault of
the device path is counted (`degraded_stats`): on a card it raises, on
the CPU the host answers, logged; a build failure raises.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import torch

from fabric_tpu_torch.idemix import bn254 as bn
from fabric_tpu_torch.idemix import nymsignature, revocation, signature
from fabric_tpu_torch.idemix.credential import (
    CredRequest,
    Credential,
    new_cred_request,
    new_credential,
)
from fabric_tpu_torch.idemix.issuer import IssuerKey, IssuerPublicKey


@dataclasses.dataclass(frozen=True)
class IdemixVerifyItem:
    """One (signature, message) pair for batched presentation verify."""

    sig: signature.Signature
    msg: bytes


class IdemixCSP:
    """Stateless provider; keys are passed explicitly."""

    # Batches at or above this size take the device path: the smallest
    # size at which the card's time beat the host's by more than 10% in
    # every sweep of `chip_smoke.phase_crossover` (1-256 signatures, both
    # paths on the C++ library) on an NVIDIA H100 80GB HBM3 at a 700.00 W
    # power limit (PERF.md).  One rep a size, card first: 1 signature took
    # 23 ms on the card and 18 ms on the host, 2 took 19 ms each way, 3
    # took 25 and 31 ms.  The median of 5 reps in turns through warmed
    # providers, two runs: 2 took 27.2 against 30.1 ms and 24.0 against
    # 25.9 ms (the card 7.5-9.7% faster, the reps overlapping); 3 took
    # 27.7 against 36.1 ms and 28.7 against 35.1 ms (18.2-23.2% faster).
    DEVICE_CROSSOVER = 3

    def __init__(self, rng=None, device="cuda", use_device: bool | None = None,
                 device_crossover: int | None = None):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "IdemixCSP: no CUDA device is available (pass "
                    "device='cpu' to run the plain version)"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"IdemixCSP: unsupported device {dev}")
        self.device = dev
        self._rng = rng
        # None selects per batch by size; True/False force a path
        self._use_device = use_device
        self._crossover = (
            device_crossover
            if device_crossover is not None
            else self.DEVICE_CROSSOVER
        )
        self._stats_lock = threading.Lock()
        self._host_lanes = 0
        self._device_failures = 0

    def degraded_stats(self) -> dict:
        """Runtime faults of the device path (`device_failures`), and the
        signatures the host answered after them on the CPU
        (`host_lanes`)."""
        with self._stats_lock:
            return {"host_lanes": self._host_lanes,
                    "device_failures": self._device_failures}

    def _note_device_fault(self, n: int) -> None:
        with self._stats_lock:
            self._host_lanes += n
            self._device_failures += 1

    # -- key generation ------------------------------------------------------

    def issuer_key_gen(self, attr_names: list[str]) -> IssuerKey:
        return IssuerKey.generate(attr_names, rng=self._rng)

    def user_secret_key_gen(self) -> int:
        return bn.rand_zr(self._rng)

    def make_nym(self, sk: int, ipk: IssuerPublicKey):
        return signature.make_nym(sk, ipk, rng=self._rng)

    # -- credentials ---------------------------------------------------------

    def cred_request(
        self, sk: int, nonce: bytes, ipk: IssuerPublicKey
    ) -> CredRequest:
        return new_cred_request(sk, nonce, ipk, rng=self._rng)

    def cred_request_verify(
        self, req: CredRequest, ipk: IssuerPublicKey
    ) -> bool:
        try:
            req.check(ipk)
            return True
        except ValueError:
            return False

    def cred_issue(
        self, issuer: IssuerKey, req: CredRequest, attrs: list[int]
    ) -> Credential:
        return new_credential(issuer, req, attrs, rng=self._rng)

    def cred_verify(
        self, cred: Credential, sk: int, ipk: IssuerPublicKey
    ) -> bool:
        try:
            cred.ver(sk, ipk)
            return True
        except ValueError:
            return False

    # -- presentation signatures ----------------------------------------------

    def sign(
        self,
        cred: Credential,
        sk: int,
        ipk: IssuerPublicKey,
        msg: bytes,
        disclosure: list[bool] | None = None,
        nym=None,
        r_nym: int | None = None,
    ) -> signature.Signature:
        return signature.new_signature(
            cred, sk, ipk, msg, disclosure=disclosure, nym=nym, r_nym=r_nym,
            rng=self._rng,
        )

    def verify(
        self, sig: signature.Signature, ipk: IssuerPublicKey, msg: bytes
    ) -> bool:
        return signature.verify(sig, ipk, msg)

    def verify_batch(
        self, items: Sequence[IdemixVerifyItem], ipk: IssuerPublicKey
    ) -> list[bool]:
        """Per-item mask, two pairings for the whole batch."""
        use_device = self._use_device
        if use_device is None:
            use_device = len(items) >= self._crossover
        sigs = [i.sig for i in items]
        msgs = [i.msg for i in items]
        if use_device:
            return signature.verify_batch_device(
                sigs, ipk, msgs, rng=self._rng, device=self.device,
                on_device_fault=self._note_device_fault,
            )
        return signature.verify_batch(sigs, ipk, msgs, rng=self._rng)

    # -- nym signatures -------------------------------------------------------

    def nym_sign(
        self, sk: int, nym, r_nym: int, ipk: IssuerPublicKey, msg: bytes
    ) -> nymsignature.NymSignature:
        return nymsignature.new_nym_signature(
            sk, nym, r_nym, ipk, msg, rng=self._rng
        )

    def nym_verify(
        self, sig: nymsignature.NymSignature, nym, ipk: IssuerPublicKey,
        msg: bytes,
    ) -> bool:
        return nymsignature.verify_nym(sig, nym, ipk, msg)

    # -- revocation -----------------------------------------------------------

    def revocation_key_gen(self):
        return revocation.generate_long_term_revocation_key(self._rng)

    def create_cri(self, ra_key, epoch: int):
        return revocation.create_cri(ra_key, epoch, rng=self._rng)

    def verify_cri(self, ra_pub, cri) -> bool:
        return revocation.verify_epoch_pk(ra_pub, cri)


__all__ = ["IdemixCSP", "IdemixVerifyItem"]
