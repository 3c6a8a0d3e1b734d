"""Partial-fulfillment intent resource logic (limit-order swap with change).

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
partial_fulfillment_intent{.rs,/swap.rs,/label.rs}: Alice sells `sell` for
`buy` at the implied price; a solver may fill completely or partially — a
partial fill creates an offer resource plus a returned (change) resource, and
the circuit enforces the cross-multiplied price equation
bought_q * actual_sold_q == sold_q * actual_bought_q.
"""

from __future__ import annotations

import io

from ..circuits import gadgets as G
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.resource_logic import ResourceLogicCircuit, load_resource_gadget
from ..core.resource import Resource
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.fields import Fp
from ..crypto.poseidon import poseidon_hash_n
from .token import Token, TokenAuthorization, TokenResource, compressed_token_vk


class Swap:
    """sell (an input token resource), buy (a token ask), auth
    (swap.rs:19-41)."""

    __slots__ = ("sell", "buy", "auth")

    def __init__(self, sell: TokenResource, buy: Token, auth: TokenAuthorization):
        self.sell = sell
        self.buy = buy
        self.auth = auth

    @classmethod
    def random(cls, rng, sell: Token, buy: Token, auth: TokenAuthorization):
        assert buy.quantity % sell.quantity == 0
        nk = Fp.random(rng)
        sell_resource = sell.create_random_input_token_resource(rng, nk, auth)
        return cls(sell_resource, buy, auth)

    def fill(self, rng, offer: Token) -> tuple[Resource, Resource]:
        """Complete or partial fill -> (offer resource, returned resource)
        (swap.rs:46-79)."""
        assert offer.name == self.buy.name
        ratio = self.buy.quantity // self.sell.resource.quantity
        assert offer.quantity % ratio == 0
        offer_resource = offer.create_random_output_token_resource(
            rng, self.sell.resource.nk_container.get_npk(), self.auth
        )
        if offer.quantity < self.buy.quantity:
            filled = offer.quantity // ratio
            returned_token = Token(
                self.sell.token_name.inner(), self.sell.resource.quantity - filled
            )
            returned = returned_token.create_random_output_token_resource(
                rng, self.sell.resource.nk_container.get_npk(), self.auth
            ).resource
        else:
            returned = Resource.random_padding_resource(rng)
        return offer_resource.resource, returned

    def encode_label(self) -> Fp:
        """Poseidon-7 (swap.rs:81-93)."""
        return poseidon_hash_n(
            [
                self.sell.encode_name(),
                self.sell.encode_quantity(),
                self.buy.encode_name(),
                self.buy.encode_quantity(),
                compressed_token_vk(),
                self.sell.resource.get_npk(),
                self.sell.resource.value,
            ]
        )

    def create_intent_resource(self, rng) -> Resource:
        """Ephemeral intent resource consuming authority = seller's nk
        (swap.rs:95-108)."""
        return Resource.new_input_resource(
            compressed_partial_fulfillment_intent_vk(),
            self.encode_label(),
            Fp.zero(),
            1,
            self.sell.resource.nk_container.get_nk(),
            self.sell.resource.get_nf(),
            True,
            Fp.random(rng),
        )

    def serialize(self) -> bytes:
        nb = self.sell.token_name.inner().encode()
        return (
            len(nb).to_bytes(4, "little")
            + nb
            + self.sell.resource.serialize()
            + self.buy.serialize()
            + self.auth.pk.to_bytes()
            + self.auth.vk.to_repr()
        )

    @classmethod
    def deserialize(cls, r: io.BytesIO) -> "Swap":
        from ..core.resource import Resource as Res
        from .token import TokenName
        from ..crypto.curves import PallasPoint

        n = int.from_bytes(r.read(4), "little")
        name = TokenName(r.read(n).decode())
        res = Res.deserialize(r)
        buy = Token.deserialize(r)
        pk = PallasPoint.from_bytes(r.read(32))
        vk = Fp.from_repr(r.read(32))
        if pk is None or vk is None:
            raise ValueError("invalid swap encoding")
        return cls(TokenResource(name, res), buy, TokenAuthorization(pk, vk))


@register_resource_logic("PartialFulfillmentIntent")
class PartialFulfillmentIntentResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        sell_resource: ResourceExistenceWitness | None = None,
        offer_resource: ResourceExistenceWitness | None = None,
        returned_resource: ResourceExistenceWitness | None = None,
        swap: Swap | None = None,
    ):
        super().__init__(self_resource)
        self.sell_resource = sell_resource
        self.offer_resource = offer_resource
        self.returned_resource = returned_resource
        self.swap = swap

    def custom_constraints(self, b, basic):
        known = self.swap is not None
        swap = self.swap
        one = G.constant_cell(b, 1)

        sell = load_resource_gadget(b, self.sell_resource)
        offer = load_resource_gadget(b, self.offer_resource)
        returned = load_resource_gadget(b, self.returned_resource)

        # consuming the intent: offer must sit in the same resource tree
        G.conditional_equal(b, basic.is_input, basic.root, offer.root)

        # witness the label fields (label.rs assign_label)
        token_vk = G.witness_cell(b, compressed_token_vk().v if known else None)
        sold_name = G.witness_cell(b, swap.sell.encode_name().v if known else None)
        sold_q = G.witness_cell(b, swap.sell.encode_quantity().v if known else None)
        bought_name = G.witness_cell(b, swap.buy.encode_name().v if known else None)
        bought_q = G.witness_cell(b, swap.buy.encode_quantity().v if known else None)
        receiver_npk = G.witness_cell(b, swap.sell.resource.get_npk().v if known else None)
        receiver_value = G.witness_cell(b, swap.sell.resource.value.v if known else None)

        encoded = G.poseidon_hash_n_gadget(
            b,
            [sold_name, sold_q, bought_name, bought_q, token_vk, receiver_npk, receiver_value],
        )
        G.assert_equal(b, encoded, basic.label)

        # intent creation checks (label.rs intent_resource_creation_check):
        # gated on the intent being an OUTPUT
        is_output = G.sub_cells(b, basic.is_input, one)  # -(1 - is_input)
        G.conditional_equal(b, is_output, token_vk, sell.logic)
        G.conditional_equal(b, is_output, sold_name, sell.label)
        G.conditional_equal(b, is_output, sold_q, sell.quantity)

        # intent consumption checks (label.rs intent_resource_consumption_check)
        G.conditional_equal(b, basic.is_input, token_vk, offer.logic)
        G.conditional_equal(b, basic.is_input, bought_name, offer.label)
        G.conditional_equal(b, basic.is_input, receiver_npk, offer.npk)
        G.conditional_equal(b, basic.is_input, receiver_value, offer.value)

        # partial fulfillment checks (label.rs partial_fulfillment_check):
        # gate = is_input * (bought_q - actual_bought_q); non-zero only for a
        # partial fill of a consumed intent
        short = G.sub_cells(b, bought_q, offer.quantity)
        is_partial = G.mul_cells(b, basic.is_input, short)
        G.conditional_equal(b, is_partial, basic.root, returned.root)
        G.conditional_equal(b, is_partial, token_vk, returned.logic)
        G.conditional_equal(b, is_partial, sold_name, returned.label)
        G.conditional_equal(b, is_partial, receiver_npk, returned.npk)
        G.conditional_equal(b, is_partial, receiver_value, returned.value)
        # cross-multiplied price equation
        actual_sold = G.sub_cells(b, sold_q, returned.quantity)
        lhs = G.mul_cells(b, bought_q, actual_sold)
        rhs = G.mul_cells(b, sold_q, offer.quantity)
        G.conditional_equal(b, is_partial, lhs, rhs)

    # --- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        return (
            self.self_resource.serialize()
            + self.sell_resource.serialize()
            + self.offer_resource.serialize()
            + self.returned_resource.serialize()
            + self.swap.serialize()
        )

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        sell = ResourceExistenceWitness.deserialize(r.read(334))
        offer = ResourceExistenceWitness.deserialize(r.read(334))
        ret = ResourceExistenceWitness.deserialize(r.read(334))
        swap = Swap.deserialize(r)
        return cls(w, sell, offer, ret, swap)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("PartialFulfillmentIntent", self.to_bytes())


def compressed_partial_fulfillment_intent_vk() -> Fp:
    return PartialFulfillmentIntentResourceLogicCircuit.compressed_vk()
