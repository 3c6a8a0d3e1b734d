"""The fungible-token application resource logic.

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
token.rs: a token resource's label is the encoded token name, its value is
Poseidon(auth_pk.x, auth_pk.y, auth_vk, receiver_vk); the logic constrains
both encodings and is_ephemeral = 0, and commits (in-circuit Blake2s) the
sender-auth logic (for inputs) or the receiver logic (for outputs) as the
first dynamic resource logic.
"""

from __future__ import annotations

import io

from ..circuits import gadgets as G
from ..circuits.blake2s import resource_logic_commitment_gadget
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.resource_logic import ResourceLogicCircuit
from ..core.constants import PRF_EXPAND_DYNAMIC_RESOURCE_LOGIC_1_CM_R
from ..core.nullifier import Nullifier, NullifierKeyContainer
from ..core.resource import RandomSeed, Resource
from ..core.resource_tree import ResourceExistenceWitness
from ..core.rl_commitment import ResourceLogicCommitment
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq
from ..crypto.poseidon import poseidon_hash_n


class TokenName:
    """<32-byte ASCII name encoded as a field element (token.rs:55-69)."""

    __slots__ = ("name",)

    def __init__(self, name: str = ""):
        assert len(name) < 32
        self.name = name

    def encode(self) -> Fp:
        raw = self.name.encode().ljust(32, b"\0")
        v = Fp.from_repr(raw)
        assert v is not None
        return v

    def inner(self) -> str:
        return self.name

    def __eq__(self, o):
        return isinstance(o, TokenName) and o.name == self.name


class Token:
    """(name, quantity) (token.rs:71-100)."""

    __slots__ = ("name", "quantity")

    def __init__(self, name: str, quantity: int):
        self.name = TokenName(name)
        self.quantity = quantity

    def encode_name(self) -> Fp:
        return self.name.encode()

    def encode_quantity(self) -> Fp:
        return Fp(self.quantity)

    def create_random_input_token_resource(self, rng, nk: Fp, auth: "TokenAuthorization"):
        resource = Resource.new_input_resource(
            compressed_token_vk(),
            self.encode_name(),
            auth.to_value(),
            self.quantity,
            nk,
            Nullifier.random(rng),
            False,
            Fp.random(rng),
        )
        return TokenResource(self.name, resource)

    def create_random_output_token_resource(self, rng, npk: Fp, auth: "TokenAuthorization"):
        resource = Resource.new_output_resource(
            compressed_token_vk(),
            self.encode_name(),
            auth.to_value(),
            self.quantity,
            npk,
            False,
            Fp.random(rng),
        )
        return TokenResource(self.name, resource)

    def serialize(self) -> bytes:
        nb = self.name.name.encode()
        return len(nb).to_bytes(4, "little") + nb + self.quantity.to_bytes(8, "little")

    @classmethod
    def deserialize(cls, r: io.BytesIO) -> "Token":
        n = int.from_bytes(r.read(4), "little")
        name = r.read(n).decode()
        q = int.from_bytes(r.read(8), "little")
        return cls(name, q)


class TokenAuthorization:
    """(pk, auth vk) — how the token may be consumed/created (token.rs:262-274)."""

    __slots__ = ("pk", "vk")

    def __init__(self, pk: PallasPoint | None = None, vk: Fp | None = None):
        self.pk = pk if pk is not None else PallasPoint.generator()
        if vk is None:
            from .signature_verification import compressed_token_auth_vk

            vk = compressed_token_auth_vk()
        self.vk = vk

    @classmethod
    def random(cls, rng=None):
        from .signature_verification import compressed_token_auth_vk

        sk = Fq.random(rng)
        pk = PallasPoint.generator() * sk.v
        return cls(pk, compressed_token_auth_vk()), sk

    def to_value(self) -> Fp:
        """value = Poseidon(pk.x, pk.y, auth_vk, receiver_vk) (token.rs:348-357)."""
        from .receiver import compressed_receiver_vk

        return poseidon_hash_n([self.pk.x, self.pk.y, self.vk, compressed_receiver_vk()])


class TokenResource:
    """(token name, resource) (token.rs:152-165)."""

    __slots__ = ("token_name", "resource")

    def __init__(self, token_name: TokenName, resource: Resource):
        self.token_name = token_name
        self.resource = resource

    def encode_name(self) -> Fp:
        return self.token_name.encode()

    def encode_quantity(self) -> Fp:
        return Fp(self.resource.quantity)

    def get_npk(self) -> Fp:
        return self.resource.get_npk()

    def generate_input_token_resource_logics(
        self, rng, auth: TokenAuthorization, auth_sk: Fq, merkle_path
    ):
        """-> ResourceLogics: token app logic + sender-auth dynamic logic
        (token.rs:183-212)."""
        from ..core.resource_logics import ResourceLogics
        from .receiver import compressed_receiver_vk
        from .signature_verification import SignatureVerificationResourceLogicCircuit

        self_resource = ResourceExistenceWitness(self.resource, merkle_path)
        token_logic = TokenResourceLogicCircuit(
            self_resource, self.token_name, auth, compressed_receiver_vk(),
            RandomSeed.random(rng),
        )
        auth_logic = SignatureVerificationResourceLogicCircuit.from_sk_and_sign(
            self_resource, auth.vk, auth_sk, compressed_receiver_vk(), rng
        )
        return ResourceLogics(token_logic, [auth_logic])

    def generate_output_token_resource_logics(
        self, rng, auth: TokenAuthorization, merkle_path
    ):
        """-> ResourceLogics: token app logic + receiver dynamic logic
        (token.rs:214-245)."""
        from ..core.resource_logics import ResourceLogics
        from .receiver import ReceiverResourceLogicCircuit, compressed_receiver_vk
        from .signature_verification import compressed_token_auth_vk

        self_resource = ResourceExistenceWitness(self.resource, merkle_path)
        token_logic = TokenResourceLogicCircuit(
            self_resource, self.token_name, auth, compressed_receiver_vk(),
            RandomSeed.random(rng),
        )
        receiver_logic = ReceiverResourceLogicCircuit(
            self_resource,
            compressed_receiver_vk(),
            Fp.random(rng),
            Fp.random(rng),
            auth.pk,
            compressed_token_auth_vk(),
        )
        return ResourceLogics(token_logic, [receiver_logic])


@register_resource_logic("Token")
class TokenResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        token_name: TokenName | None = None,
        auth: TokenAuthorization | None = None,
        receiver_resource_logic_vk: Fp | None = None,
        rseed: RandomSeed | None = None,
    ):
        super().__init__(self_resource)
        self.token_name = token_name or TokenName("Token_name")
        self.auth = auth
        self.receiver_resource_logic_vk = receiver_resource_logic_vk or Fp.zero()
        self.rseed = rseed

    def _dynamic_vk(self) -> Fp:
        return (
            self.auth.vk
            if self.self_resource.is_input()
            else self.receiver_resource_logic_vk
        )

    def _cm_r(self) -> Fp:
        return self.rseed.get_resource_logic_cm_r(PRF_EXPAND_DYNAMIC_RESOURCE_LOGIC_1_CM_R)

    def dynamic_rl_commitments(self):
        first = ResourceLogicCommitment.commit(self._dynamic_vk(), self._cm_r())
        return first.to_public_inputs() + ResourceLogicCommitment.default().to_public_inputs()

    # --- constraints ---------------------------------------------------
    def custom_constraints(self, b, basic):
        known = self.auth is not None
        one = G.constant_cell(b, 1)
        # label == encoded token name
        prop = G.witness_cell(b, self.token_name.encode().v if known else None)
        G.assert_equal(b, prop, basic.label)

        # value encoding
        from ..circuits.ec_gadgets import witness_point

        pk = witness_point(b, self.auth.pk if known else None)
        auth_vk = G.witness_cell(b, self.auth.vk.v if known else None)
        recv_vk = G.witness_cell(
            b, self.receiver_resource_logic_vk.v if known else None
        )
        encoded = G.poseidon_hash_n_gadget(b, [pk.x, pk.y, auth_vk, recv_vk])
        G.assert_equal(b, encoded, basic.value)

        # not ephemeral
        G.assert_equal_constant(b, basic.is_ephemeral, 0)

        # first dynamic RL commitment: select(is_input, auth_vk, receiver_vk)
        dyn_vk = G.select_cell(b, basic.is_input, auth_vk, recv_vk)
        cm_r = G.witness_cell(b, self._cm_r().v if known else None)
        lo, hi = resource_logic_commitment_gadget(b, dyn_vk, cm_r, one)
        self._dyn_cm_cells = (lo, hi)

    def bound_public_cells(self, b, basic) -> dict:
        lo, hi = self._dyn_cm_cells
        return {2: lo, 3: hi}

    # --- serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        nb = self.token_name.name.encode()
        return (
            self.self_resource.serialize()
            + len(nb).to_bytes(4, "little")
            + nb
            + self.auth.pk.to_bytes()
            + self.auth.vk.to_repr()
            + self.receiver_resource_logic_vk.to_repr()
            + self.rseed.seed
        )

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        n = int.from_bytes(r.read(4), "little")
        name = TokenName(r.read(n).decode())
        pk = PallasPoint.from_bytes(r.read(32))
        vk = Fp.from_repr(r.read(32))
        rvk = Fp.from_repr(r.read(32))
        rseed = RandomSeed.from_bytes(r.read(32))
        if pk is None or vk is None or rvk is None:
            raise ValueError("invalid token circuit encoding")
        return cls(w, name, TokenAuthorization(pk, vk), rvk, rseed)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("Token", self.to_bytes())


def compressed_token_vk() -> Fp:
    """COMPRESSED_TOKEN_VK (token.rs:49-53)."""
    return TokenResourceLogicCircuit.compressed_vk()
