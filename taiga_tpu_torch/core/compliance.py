"""Compliance (Action) info and public inputs.

Mirrors taiga_halo2/src/compliance.rs: ComplianceInfo couples
one input resource (with its Merkle membership) to one output resource whose
nonce is set to the input's nullifier; build() derives the 9 public inputs and
the circuit witness.
"""

from __future__ import annotations

from ..crypto.fields import Fp, Fq
from .constants import (
    PRF_EXPAND_INPUT_RESOURCE_LOGIC_CM_R,
    PRF_EXPAND_OUTPUT_RESOURCE_LOGIC_CM_R,
)
from .delta import DeltaCommitment
from .merkle import Anchor, MerklePath
from .nullifier import Nullifier
from .resource import RandomSeed, Resource, ResourceCommitment
from .rl_commitment import ResourceLogicCommitment


class CompliancePublicInputs:
    """anchor, nf, cm, delta, input/output RL commitments (compliance.rs:28-45)."""

    def __init__(self, anchor, nf, cm, delta, input_rl_cm, output_rl_cm):
        self.anchor: Anchor = anchor
        self.nf: Nullifier = nf
        self.cm: ResourceCommitment = cm
        self.delta: DeltaCommitment = delta
        self.input_resource_logic_commitment: ResourceLogicCommitment = input_rl_cm
        self.output_resource_logic_commitment: ResourceLogicCommitment = output_rl_cm

    def to_instance(self) -> list[Fp]:
        """9 instance scalars in the fixed row order (compliance.rs:62-78)."""
        in_cm = self.input_resource_logic_commitment.to_public_inputs()
        out_cm = self.output_resource_logic_commitment.to_public_inputs()
        return [
            self.nf.inner(),
            self.anchor.inner(),
            self.cm.inner(),
            self.delta.get_x(),
            self.delta.get_y(),
            in_cm[0],
            in_cm[1],
            out_cm[0],
            out_cm[1],
        ]

    def serialize(self) -> bytes:
        return (
            self.anchor.to_bytes()
            + self.nf.to_bytes()
            + self.cm.to_bytes()
            + self.delta.to_bytes()
            + self.input_resource_logic_commitment.to_bytes()
            + self.output_resource_logic_commitment.to_bytes()
        )

    @classmethod
    def deserialize(cls, data: bytes) -> "CompliancePublicInputs":
        assert len(data) == 192
        anchor = Anchor.from_bytes(data[0:32])
        nf = Nullifier.from_bytes(data[32:64])
        cm = ResourceCommitment.from_bytes(data[64:96])
        delta = DeltaCommitment.from_bytes(data[96:128])
        if anchor is None or nf is None or cm is None or delta is None:
            raise ValueError("invalid compliance public inputs")
        return cls(
            anchor,
            nf,
            cm,
            delta,
            ResourceLogicCommitment.from_bytes(data[128:160]),
            ResourceLogicCommitment.from_bytes(data[160:192]),
        )


class ComplianceInfo:
    def __init__(
        self,
        input_resource: Resource,
        input_merkle_path: MerklePath,
        custom_anchor: Anchor | None,
        output_resource: Resource,
        rseed: RandomSeed | None = None,
    ):
        """Sets output_resource.nonce = input nullifier (compliance.rs:128-153).
        The dummy/ephemeral input may pass a custom anchor with a random path."""
        self.input_resource = input_resource
        self.input_merkle_path = input_merkle_path
        self.input_anchor = (
            custom_anchor
            if custom_anchor is not None
            else input_resource.calculate_root(input_merkle_path)
        )
        output_resource.set_nonce(input_resource)
        self.output_resource = output_resource
        self.rseed = rseed if rseed is not None else RandomSeed.random()

    def get_rcv(self) -> Fq:
        return self.rseed.get_rcv()

    def get_input_resource_logic_com_r(self) -> Fp:
        return self.rseed.get_resource_logic_cm_r(PRF_EXPAND_INPUT_RESOURCE_LOGIC_CM_R)

    def get_output_resource_logic_com_r(self) -> Fp:
        return self.rseed.get_resource_logic_cm_r(PRF_EXPAND_OUTPUT_RESOURCE_LOGIC_CM_R)

    def calculate_root(self) -> Anchor:
        """Transparent path: recompute the root, the anchor is untrusted."""
        return self.input_resource.calculate_root(self.input_merkle_path)

    def get_delta_commitment(self, blind_r: Fq) -> DeltaCommitment:
        return DeltaCommitment.commit(self.input_resource, self.output_resource, blind_r)

    def get_input_resource_nullifier(self) -> Nullifier:
        return self.input_resource.get_nf()

    def get_output_resource_cm(self) -> ResourceCommitment:
        return self.output_resource.commitment()

    def build(self):
        """-> (CompliancePublicInputs, ComplianceCircuit)."""
        from ..circuits.compliance import ComplianceCircuit

        nf = self.get_input_resource_nullifier()
        assert nf == self.output_resource.nonce, (
            "the nf of the input resource must equal the nonce of the output resource"
        )
        cm = self.get_output_resource_cm()
        rcv = self.get_rcv()
        delta = self.get_delta_commitment(rcv)
        input_rl_cm = ResourceLogicCommitment.commit(
            self.input_resource.get_logic(), self.get_input_resource_logic_com_r()
        )
        output_rl_cm = ResourceLogicCommitment.commit(
            self.output_resource.get_logic(), self.get_output_resource_logic_com_r()
        )
        public = CompliancePublicInputs(
            self.input_anchor, nf, cm, delta, input_rl_cm, output_rl_cm
        )
        return public, ComplianceCircuit(self)

    # --- circuit witness accessors -----------------------------------
    def rl_commitment_public_inputs(self) -> list[Fp]:
        return (
            ResourceLogicCommitment.commit(
                self.input_resource.get_logic(), self.get_input_resource_logic_com_r()
            ).to_public_inputs()
            + ResourceLogicCommitment.commit(
                self.output_resource.get_logic(), self.get_output_resource_logic_com_r()
            ).to_public_inputs()
        )

    @classmethod
    def random(cls, rng=None):
        """A random statement. Every draw comes from `rng` (a random.Random)
        when one is given, so a seeded rng gives a reproducible statement;
        without one the draws come from the OS."""
        from .constants import TAIGA_COMMITMENT_TREE_DEPTH

        return cls(
            Resource.random(rng),
            MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH),
            None,
            Resource.random(rng),
            rseed=RandomSeed.random(rng),
        )
