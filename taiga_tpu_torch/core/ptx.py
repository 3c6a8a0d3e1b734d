"""Partial-transaction proofs: the compliance verifying info.

Port of ComplianceVerifyingInfo from taiga_tpu/core/ptx.py (:25-73), the
compliance proof + its public inputs (shielded_ptx.rs:44-50), proved on the
device. The rest of the JAX package's ptx.py (the resource-logic verifying
info set, the shielded and transparent partial transactions) comes with a
later slice.
"""

from __future__ import annotations

import secrets

from .compliance import ComplianceInfo, CompliancePublicInputs
from .error import ProofError
from .proving import Proof, compliance_k


class ComplianceVerifyingInfo:
    """Compliance proof + its 9 public inputs (shielded_ptx.rs:44-50)."""

    __slots__ = ("compliance_proof", "compliance_instance")

    def __init__(self, proof: Proof, instance: CompliancePublicInputs):
        self.compliance_proof = proof
        self.compliance_instance = instance

    @classmethod
    def create(cls, info: ComplianceInfo, *, device="cuda",
               randbits=secrets.randbits) -> "ComplianceVerifyingInfo":
        instance, circuit = info.build()
        proof = Proof.create(circuit, instance.to_instance(), compliance_k(), device=device,
                             randbits=randbits)
        return cls(proof, instance)

    @classmethod
    def create_batch(cls, infos, *, device="cuda",
                     randbits=secrets.randbits) -> list["ComplianceVerifyingInfo"]:
        """Prove many compliance units in one lockstep batch on `device`
        (plonk.prover.create_proofs_batch); a batch of one equals create's
        proof."""
        from ..circuits.compliance import ComplianceCircuit
        from ..ops.limbs import resolve_device
        from ..plonk.prover import create_proofs_batch
        from .proving import get_proving_key

        resolve_device(device)  # before the keygen
        built = [info.build() for info in infos]
        pk = get_proving_key(ComplianceCircuit, compliance_k())
        proofs = create_proofs_batch(pk, [c for _, c in built],
                                     [i.to_instance() for i, _ in built],
                                     device=device, randbits=randbits)
        return [cls(Proof(p), inst) for p, (inst, _) in zip(proofs, built)]

    def verify(self) -> bool:
        """Raises ProofError on an invalid proof; returns True on success."""
        from ..circuits.compliance import ComplianceCircuit

        if not self.compliance_proof.verify(
            ComplianceCircuit, self.compliance_instance.to_instance(), compliance_k()
        ):
            raise ProofError("compliance proof failed")
        return True
