"""Or-relation intent resource logic.

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
or_relation_intent.rs: an ephemeral intent resource whose label encodes two
acceptable (token, quantity) conditions plus the receiver; consuming the
intent requires creating a desired output resource matching condition 1 OR
condition 2 (the extended-or-relation gadget).
"""

from __future__ import annotations

import io

from ..circuits import gadgets as G
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.resource_logic import ResourceLogicCircuit, load_resource_gadget
from ..core.nullifier import Nullifier, NullifierKeyContainer
from ..core.resource import Resource
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.fields import Fp
from ..crypto.poseidon import poseidon_hash_n
from .token import Token, compressed_token_vk


def encode_or_relation_label(
    token_1: Token, token_2: Token, receiver_npk: Fp, receiver_value: Fp
) -> Fp:
    """Poseidon-7 over the two conditions + token vk + receiver
    (or_relation_intent.rs:62-80)."""
    return poseidon_hash_n(
        [
            token_1.encode_name(),
            token_1.encode_quantity(),
            token_2.encode_name(),
            token_2.encode_quantity(),
            compressed_token_vk(),
            receiver_npk,
            receiver_value,
        ]
    )


def create_intent_resource(
    rng, token_1: Token, token_2: Token, receiver_npk: Fp, receiver_value: Fp, nk: Fp
) -> Resource:
    """The ephemeral intent resource (or_relation_intent.rs e2e usage)."""
    label = encode_or_relation_label(token_1, token_2, receiver_npk, receiver_value)
    return Resource.new_input_resource(
        compressed_or_relation_intent_vk(),
        label,
        Fp.zero(),
        1,
        nk,
        Nullifier.random(rng),
        True,
        Fp.random(rng),
    )


@register_resource_logic("OrRelationIntent")
class OrRelationIntentResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        desired_resource: ResourceExistenceWitness | None = None,
        token_1: Token | None = None,
        token_2: Token | None = None,
        receiver_npk: Fp | None = None,
        receiver_value: Fp | None = None,
    ):
        super().__init__(self_resource)
        self.desired_resource = desired_resource
        self.token_1 = token_1 or Token("token1", 1)
        self.token_2 = token_2 or Token("token2", 2)
        self.receiver_npk = receiver_npk or Fp.zero()
        self.receiver_value = receiver_value or Fp.zero()

    def custom_constraints(self, b, basic):
        known = self.self_resource is not None
        # the intent resource is ephemeral
        G.assert_equal_constant(b, basic.is_ephemeral, 1)

        # load the desired resource (dummy when the intent is an output)
        desired = load_resource_gadget(b, self.desired_resource)

        # same resource tree when consuming
        G.conditional_equal(b, basic.is_input, basic.root, desired.root)

        token_vk = G.witness_cell(b, compressed_token_vk().v if known else None)
        p1 = G.witness_cell(b, self.token_1.encode_name().v if known else None)
        q1 = G.witness_cell(b, self.token_1.encode_quantity().v if known else None)
        p2 = G.witness_cell(b, self.token_2.encode_name().v if known else None)
        q2 = G.witness_cell(b, self.token_2.encode_quantity().v if known else None)
        npk = G.witness_cell(b, self.receiver_npk.v if known else None)
        value = G.witness_cell(b, self.receiver_value.v if known else None)

        encoded = G.poseidon_hash_n_gadget(b, [p1, q1, p2, q2, token_vk, npk, value])
        G.assert_equal(b, encoded, basic.label)

        # desired output resource checks (gated on consuming the intent)
        G.conditional_equal(b, basic.is_input, token_vk, desired.logic)
        G.conditional_equal(b, basic.is_input, npk, desired.npk)
        G.conditional_equal(b, basic.is_input, value, desired.value)
        # the desired resource must be an output
        zero = G.constant_cell(b, 0)
        G.conditional_equal(b, basic.is_input, zero, desired.is_input)
        # (label, quantity) matches condition 1 OR condition 2
        G.extended_or_relation(
            b, basic.is_input, (p1, q1), (p2, q2), (desired.label, desired.quantity)
        )

    # --- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        return (
            self.self_resource.serialize()
            + self.desired_resource.serialize()
            + self.token_1.serialize()
            + self.token_2.serialize()
            + self.receiver_npk.to_repr()
            + self.receiver_value.to_repr()
        )

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        d = ResourceExistenceWitness.deserialize(r.read(334))
        t1 = Token.deserialize(r)
        t2 = Token.deserialize(r)
        npk = Fp.from_repr(r.read(32))
        value = Fp.from_repr(r.read(32))
        if npk is None or value is None:
            raise ValueError("invalid or-relation intent encoding")
        return cls(w, d, t1, t2, npk, value)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("OrRelationIntent", self.to_bytes())


def compressed_or_relation_intent_vk() -> Fp:
    return OrRelationIntentResourceLogicCircuit.compressed_vk()
