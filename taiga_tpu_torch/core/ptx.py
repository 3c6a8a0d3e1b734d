"""Partial transactions: shielded (ZK-proved) and transparent (mock-checked).

Port of taiga_tpu/core/ptx.py; mirrors taiga_halo2/src/shielded_ptx.rs and
transparent_ptx.rs. A partial transaction couples N compliance units (input
resource -> output resource) with per-resource application logic proofs, plus
the consistency checks tying resource-logic public inputs to the compliance
instances (self-resource ids and the shared depth-4 resource Merkle root).
Proofs and mock checks run on a torch device ("cuda" unless the caller
passes "cpu"); every proof of a shielded partial transaction draws from one
`randbits`, in the reference's order.
"""

from __future__ import annotations

import secrets

from ..crypto.fields import Fp, Fq
from ..ops.limbs import resolve_device
from .compliance import ComplianceInfo, CompliancePublicInputs
from .error import (
    InconsistentResourceMerkleRoot,
    InconsistentSelfResourceID,
    ProofError,
)
from .executable import Executable
from .proving import Proof, ResourceLogicVerifyingInfo, compliance_k


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


class ResourceLogicVerifyingInfoSet:
    """App logic + <=2 dynamic logics (shielded_ptx.rs:57-62, 353-412)."""

    __slots__ = ("app_resource_logic_verifying_info", "app_dynamic_resource_logic_verifying_info")

    def __init__(self, app: ResourceLogicVerifyingInfo, dynamic: list[ResourceLogicVerifyingInfo]):
        self.app_resource_logic_verifying_info = app
        self.app_dynamic_resource_logic_verifying_info = list(dynamic)

    def verify(self) -> bool:
        """Raises ProofError on failure; True on success."""
        self.app_resource_logic_verifying_info.verify()
        for info in self.app_dynamic_resource_logic_verifying_info:
            info.verify()
        return True

    def get_resource_merkle_roots(self) -> list[Fp]:
        roots = [
            info.get_resource_merkle_root()
            for info in self.app_dynamic_resource_logic_verifying_info
        ]
        roots.append(self.app_resource_logic_verifying_info.get_resource_merkle_root())
        return roots

    def get_self_resource_id(self) -> Fp:
        return self.app_resource_logic_verifying_info.get_self_resource_id()


class ShieldedPartialTransaction(Executable):
    def __init__(self, compliances, inputs, outputs, binding_sig_r: Fq | None, hints: bytes = b""):
        self.compliances: list[ComplianceVerifyingInfo] = compliances
        self.inputs: list[ResourceLogicVerifyingInfoSet] = inputs
        self.outputs: list[ResourceLogicVerifyingInfoSet] = outputs
        self.binding_sig_r = binding_sig_r
        self.hints = hints

    # --- constructors (shielded_ptx.rs:65-134) ------------------------
    @classmethod
    def from_bytecode(cls, compliances, input_resource_app, output_resource_app, hints=b"",
                      *, device="cuda", randbits=secrets.randbits):
        """Proves on `device`, in the reference's order: each input's
        application bytecode, each output's, then each compliance unit."""
        resolve_device(device)  # before any keygen
        inputs = [bc.generate_proofs(device=device, randbits=randbits)
                  for bc in input_resource_app]
        outputs = [bc.generate_proofs(device=device, randbits=randbits)
                   for bc in output_resource_app]
        rcv_sum = Fq.zero()
        c_infos = []
        for info in compliances:
            rcv_sum = rcv_sum + info.get_rcv()
            c_infos.append(ComplianceVerifyingInfo.create(info, device=device,
                                                          randbits=randbits))
        return cls(c_infos, inputs, outputs, rcv_sum, hints)

    @classmethod
    def build(cls, compliance_pairs, input_resource_logics, output_resource_logics, hints=b"",
              *, device="cuda", randbits=secrets.randbits):
        """From ResourceLogics objects (resource.rs:451-491), on `device`.
        The compliance proofs are one lockstep batch
        (ComplianceVerifyingInfo.create_batch), proved first; then every
        resource-logic proof, flattened set by set (the app logic, then its
        dynamic logics) through prove_resource_logics_batch (the reference
        proves serially, shielded_ptx.rs:98-134)."""
        from .proving import prove_resource_logics_batch

        resolve_device(device)  # before any keygen
        rcv_sum = Fq.zero()
        for info in compliance_pairs:
            rcv_sum = rcv_sum + info.get_rcv()
        c_infos = ComplianceVerifyingInfo.create_batch(list(compliance_pairs), device=device,
                                                       randbits=randbits)
        # flatten every logic circuit, batch-prove, reassemble the sets
        sets = list(input_resource_logics) + list(output_resource_logics)
        flat = []
        spans = []
        for rl in sets:
            start = len(flat)
            flat.append(rl.application_resource_logic)
            flat.extend(rl.dynamic_resource_logics)
            spans.append((start, len(flat)))
        infos = prove_resource_logics_batch(flat, device=device, randbits=randbits)
        built_sets = [
            ResourceLogicVerifyingInfoSet(infos[a], infos[a + 1 : b])
            for a, b in spans
        ]
        n_in = len(input_resource_logics)
        return cls(c_infos, built_sets[:n_in], built_sets[n_in:], rcv_sum, hints)

    # --- checks (shielded_ptx.rs:137-217) -----------------------------
    def verify_proof(self) -> bool:
        """Raises ProofError on failure; True on success."""
        for info in self.compliances:
            info.verify()
        for info in self.inputs:
            info.verify()
        for info in self.outputs:
            info.verify()
        return True

    def _check_resource_merkle_roots(self):
        root = self.get_resource_merkle_root()
        for info_set in self.inputs + self.outputs:
            for r in info_set.get_resource_merkle_roots():
                if r != root:
                    raise InconsistentResourceMerkleRoot()

    def _check_nullifiers(self):
        nfs = self.get_nullifiers()
        for info_set, nf in zip(self.inputs, nfs):
            sid = info_set.get_self_resource_id()
            for dyn in info_set.app_dynamic_resource_logic_verifying_info:
                if dyn.get_self_resource_id() != sid:
                    raise InconsistentSelfResourceID()
            if sid != nf.inner():
                raise InconsistentSelfResourceID()

    def _check_resource_commitments(self):
        cms = self.get_output_cms()
        for info_set, cm in zip(self.outputs, cms):
            sid = info_set.get_self_resource_id()
            for dyn in info_set.app_dynamic_resource_logic_verifying_info:
                if dyn.get_self_resource_id() != sid:
                    raise InconsistentSelfResourceID()
            if sid != cm.inner():
                raise InconsistentSelfResourceID()

    def get_binding_sig_r(self) -> Fq | None:
        return self.binding_sig_r

    def clean_private_info(self):
        self.binding_sig_r = None
        self.hints = b""

    # --- Executable ---------------------------------------------------
    def execute(self):
        self.verify_proof()
        self._check_nullifiers()
        self._check_resource_commitments()
        self._check_resource_merkle_roots()

    def get_nullifiers(self):
        return [c.compliance_instance.nf for c in self.compliances]

    def get_output_cms(self):
        return [c.compliance_instance.cm for c in self.compliances]

    def get_delta_commitments(self):
        return [c.compliance_instance.delta for c in self.compliances]

    def get_anchors(self):
        return [c.compliance_instance.anchor for c in self.compliances]


class TransparentPartialTransaction(Executable):
    """No ZK: every resource logic is checked via the MockProver-equivalent
    constraint evaluator, on `device`; deltas use rcv = 0
    (transparent_ptx.rs)."""

    def __init__(self, compliances, input_resource_app, output_resource_app, hints: bytes = b"",
                 *, device="cuda"):
        resolve_device(device)
        self.compliances: list[ComplianceInfo] = compliances
        self.input_resource_app = input_resource_app
        self.output_resource_app = output_resource_app
        self.hints = hints
        self.device = device

    def execute(self):
        nfs = self.get_nullifiers()
        cms = self.get_output_cms()
        root = self.get_resource_merkle_root()
        for app, nf in zip(self.input_resource_app, nfs):
            if app.verify_transparently(root, device=self.device) != nf.inner():
                raise InconsistentSelfResourceID()
        for app, cm in zip(self.output_resource_app, cms):
            if app.verify_transparently(root, device=self.device) != cm.inner():
                raise InconsistentSelfResourceID()

    def get_nullifiers(self):
        return [c.get_input_resource_nullifier() for c in self.compliances]

    def get_output_cms(self):
        return [c.get_output_resource_cm() for c in self.compliances]

    def get_delta_commitments(self):
        return [c.get_delta_commitment(Fq.zero()) for c in self.compliances]

    def get_anchors(self):
        # transparent anchors are untrusted: recompute
        return [c.calculate_root() for c in self.compliances]
