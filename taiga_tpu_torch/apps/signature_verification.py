"""Schnorr signature-verification resource logic (token sender auth).

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
signature_verification.rs: the message is the ptx resource-tree root; sign
computes s = z + H(R||P||m)*sk over Pallas with H = mod_r_p(Poseidon-5); the
circuit checks [s]G == R + [H(R||P||m)]P in-circuit and that the self
resource's value encodes (pk, auth_vk, receiver_vk).
"""

from __future__ import annotations

import io
import secrets

from ..circuits import gadgets as G
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.ec_gadgets import (
    blind_base,
    constant_point,
    decompose_canonical_255,
    ec_add_gadget,
    ec_scalar_mul_gadget,
    witness_point,
)
from ..circuits.resource_logic import ResourceLogicCircuit
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq, mod_r_p
from ..crypto.poseidon import poseidon_hash_n


class SchnorrSignature:
    """pk, (R, s) (signature_verification.rs:47-87)."""

    __slots__ = ("pk", "r", "s")

    def __init__(self, pk: PallasPoint, r: PallasPoint, s: Fq):
        self.pk = pk
        self.r = r
        self.s = s

    @classmethod
    def sign(cls, sk: Fq, message: list[Fp], rng=None) -> "SchnorrSignature":
        g = PallasPoint.generator()
        pk = g * sk.v
        z = Fq(secrets.randbits(384) % Fq.MODULUS) if rng is None else Fq.random(rng)
        r = g * z.v
        assert len(message) == 1
        h = mod_r_p(
            poseidon_hash_n([r.x, r.y, pk.x, pk.y, message[0]])
        )
        s = z + h * sk
        return cls(pk, r, s)

    def verify(self, message: list[Fp]) -> bool:
        g = PallasPoint.generator()
        h = mod_r_p(poseidon_hash_n([self.r.x, self.r.y, self.pk.x, self.pk.y, message[0]]))
        return g * self.s.v == self.r + self.pk * h.v

    def serialize(self) -> bytes:
        return self.pk.to_bytes() + self.r.to_bytes() + self.s.to_bytes()

    @classmethod
    def deserialize(cls, r: io.BytesIO) -> "SchnorrSignature":
        pk = PallasPoint.from_bytes(r.read(32))
        rr = PallasPoint.from_bytes(r.read(32))
        s = Fq.from_repr(r.read(32))
        if pk is None or rr is None or s is None:
            raise ValueError("invalid schnorr signature encoding")
        return cls(pk, rr, s)


@register_resource_logic("SignatureVerification")
class SignatureVerificationResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        resource_logic_vk: Fp | None = None,
        signature: SchnorrSignature | None = None,
        receiver_resource_logic_vk: Fp | None = None,
    ):
        super().__init__(self_resource)
        self.resource_logic_vk = resource_logic_vk or Fp.zero()
        self.signature = signature
        self.receiver_resource_logic_vk = receiver_resource_logic_vk or Fp.zero()

    @classmethod
    def from_sk_and_sign(
        cls,
        self_resource: ResourceExistenceWitness,
        resource_logic_vk: Fp,
        sk: Fq,
        receiver_resource_logic_vk: Fp,
        rng=None,
    ):
        message = [self_resource.get_root()]
        sig = SchnorrSignature.sign(sk, message, rng)
        return cls(self_resource, resource_logic_vk, sig, receiver_resource_logic_vk)

    # --- constraints ---------------------------------------------------
    def custom_constraints(self, b, basic):
        sig = self.signature
        one = G.constant_cell(b, 1)
        pk = witness_point(b, None if sig is None else sig.pk)

        auth_vk = G.witness_cell(b, None if sig is None else self.resource_logic_vk.v)
        recv_vk = G.witness_cell(
            b, None if sig is None else self.receiver_resource_logic_vk.v
        )

        # value encoding: Poseidon(pk.x, pk.y, auth_vk, receiver_vk)
        encoded = G.poseidon_hash_n_gadget(b, [pk.x, pk.y, auth_vk, recv_vk])
        G.assert_equal(b, encoded, basic.value)

        r = witness_point(b, None if sig is None else sig.r)
        # s as free witness bits (the signature itself is the witness)
        sv = None if sig is None else sig.s.v
        s_bits = []
        for i in range(255):
            bit = G.witness_cell(b, None if sv is None else (sv >> i) & 1)
            G.is_bool(b, bit)
            s_bits.append(bit)

        gen = constant_point(b, PallasPoint.generator())
        s_g = ec_scalar_mul_gadget(b, gen, s_bits, blind_base(b"schnorr-sg"))

        # h = Poseidon(r.x, r.y, pk.x, pk.y, root), canonical scalar bits
        h = G.poseidon_hash_n_gadget(b, [r.x, r.y, pk.x, pk.y, basic.root])
        h_bits = decompose_canonical_255(b, h, one)
        h_p = ec_scalar_mul_gadget(b, pk, h_bits, blind_base(b"schnorr-hp"))
        rhs = ec_add_gadget(b, r, h_p)
        G.assert_equal(b, s_g.x, rhs.x)
        G.assert_equal(b, s_g.y, rhs.y)

    # --- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        return (
            self.self_resource.serialize()
            + self.resource_logic_vk.to_repr()
            + self.signature.serialize()
            + self.receiver_resource_logic_vk.to_repr()
        )

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        vk = Fp.from_repr(r.read(32))
        sig = SchnorrSignature.deserialize(r)
        rvk = Fp.from_repr(r.read(32))
        return cls(w, vk, sig, rvk)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("SignatureVerification", self.to_bytes())


def compressed_token_auth_vk() -> Fp:
    """COMPRESSED_TOKEN_AUTH_VK (signature_verification.rs:39-43)."""
    return SignatureVerificationResourceLogicCircuit.compressed_vk()
