"""Receiver resource logic: proves correct encryption of the output resource.

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
receiver_resource_logic.rs: checks the resource value encodes
(rcv_pk, auth_vk, receiver_vk), encrypts the 8 resource fields to rcv_pk with
the in-circuit DH + Poseidon sponge (circuits/encryption.py), and publicizes
the 14 ciphertext elements at public inputs 8..21 so the receiver can decrypt
from the transaction alone.
"""

from __future__ import annotations

import io

from ..circuits import gadgets as G
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.ec_gadgets import witness_point
from ..circuits.encryption import resource_encryption_gadget
from ..circuits.resource_logic import ResourceLogicCircuit
from ..core.constants import (
    RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PUBLIC_INPUT_BEGIN_IDX as ENC_IDX,
)
from ..core.encryption import ResourceCiphertext, ResourcePlaintext, SecretKey
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, mod_r_p


@register_resource_logic("Receiver")
class ReceiverResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        resource_logic_vk: Fp | None = None,
        encrypt_nonce: Fp | None = None,
        sk: Fp | None = None,
        rcv_pk: PallasPoint | None = None,
        auth_resource_logic_vk: Fp | None = None,
    ):
        super().__init__(self_resource)
        self.resource_logic_vk = resource_logic_vk or Fp.zero()
        self.encrypt_nonce = encrypt_nonce or Fp.zero()
        self.sk = sk
        self.rcv_pk = rcv_pk or PallasPoint.generator()
        self.auth_resource_logic_vk = auth_resource_logic_vk or Fp.zero()

    # --- host-side ciphertext (public inputs 8..21) -------------------
    def _message_fields(self) -> list[Fp]:
        res = self.self_resource.get_resource()
        return [
            res.get_logic(),
            res.get_label(),
            res.value,
            Fp(res.quantity),
            res.nonce.inner(),
            res.get_npk(),
            Fp(1 if res.is_ephemeral else 0),
            res.rseed,
        ]

    def custom_public_inputs(self) -> list[Fp]:
        pad = self._padding_seed.get_random_padding(2)  # custom idx 6,7
        plaintext = ResourcePlaintext.padding(self._message_fields())
        key = SecretKey.from_dh_exchange(self.rcv_pk, mod_r_p(self.sk))
        cipher = ResourceCiphertext.encrypt(plaintext, key, self.encrypt_nonce)
        pk = PallasPoint.generator() * mod_r_p(self.sk).v
        return pad + cipher.inner() + [pk.x, pk.y]

    # --- constraints ---------------------------------------------------
    def custom_constraints(self, b, basic):
        known = self.sk is not None
        one = G.constant_cell(b, 1)
        nonce = G.witness_cell(b, self.encrypt_nonce.v if known else None)
        sk = G.witness_cell(b, self.sk.v if known else None)
        rcv_pk = witness_point(b, self.rcv_pk if known else None)

        auth_vk = G.witness_cell(b, self.auth_resource_logic_vk.v if known else None)
        recv_vk = G.witness_cell(b, self.resource_logic_vk.v if known else None)
        encoded = G.poseidon_hash_n_gadget(b, [rcv_pk.x, rcv_pk.y, auth_vk, recv_vk])
        G.assert_equal(b, encoded, basic.value)

        message = [
            basic.logic,
            basic.label,
            basic.value,
            basic.quantity,
            basic.nonce,
            basic.npk,
            basic.is_ephemeral,
            basic.rseed,
        ]
        cipher = resource_encryption_gadget(b, nonce, sk, rcv_pk, message, one)
        self._cipher_cells = cipher

    def bound_public_cells(self, b, basic) -> dict:
        return {ENC_IDX + i: c for i, c in enumerate(self._cipher_cells)}

    # --- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        return (
            self.self_resource.serialize()
            + self.resource_logic_vk.to_repr()
            + self.encrypt_nonce.to_repr()
            + self.sk.to_repr()
            + self.rcv_pk.to_bytes()
            + self.auth_resource_logic_vk.to_repr()
        )

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        vk = Fp.from_repr(r.read(32))
        nonce = Fp.from_repr(r.read(32))
        sk = Fp.from_repr(r.read(32))
        pk = PallasPoint.from_bytes(r.read(32))
        avk = Fp.from_repr(r.read(32))
        if None in (vk, nonce, sk, pk, avk):
            raise ValueError("invalid receiver circuit encoding")
        return cls(w, vk, nonce, sk, pk, avk)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("Receiver", self.to_bytes())


def compressed_receiver_vk() -> Fp:
    """COMPRESSED_RECEIVER_VK (receiver_resource_logic.rs:39-43)."""
    return ReceiverResourceLogicCircuit.compressed_vk()
