"""Resource (UTXO-style note) data model.

Mirrors taiga_halo2/src/resource.rs:
  * Resource{kind(logic,label), value, quantity, nk_container, nonce,
    is_ephemeral, rseed}
  * commitment = Poseidon-8(logic, label, value, npk, nonce, psi,
      is_ephemeral * 2^128 + quantity, rcm)                (resource.rs:217-235)
  * psi  = Poseidon(PRF_personalization_field, 0, rseed, nonce)
  * rcm  = Poseidon(PRF_personalization_field, 1, rseed, nonce)
  * kind point = poseidon_to_curve([logic, label])          (resource.rs:389-392)
  * RandomSeed -> Blake2b-expanded padding / rcv / rl_cm_r  (resource.rs:402-449)
  * borsh layout 202 bytes                                  (resource.rs:296-379)
"""

from __future__ import annotations

import hashlib
import io
import secrets

from ..crypto.curves import PallasPoint, iso_map, map_to_curve_simple_swu
from ..crypto.fields import Fp, Fq
from ..crypto.poseidon import poseidon_hash_n
from .constants import (
    POSEIDON_TO_CURVE_INPUT_LEN,
    POSEIDON_TO_FIELD_U_0_POSTFIX,
    POSEIDON_TO_FIELD_U_1_POSTFIX,
    PRF_EXPAND_PERSONALIZATION,
    PRF_EXPAND_PSI,
    PRF_EXPAND_PUBLIC_INPUT_PADDING,
    PRF_EXPAND_RCM,
    PRF_EXPAND_VCM_R,
    prf_expand_personalization_to_field,
)
from .merkle import Anchor, MerklePath, Node
from .nullifier import Nullifier, NullifierKeyContainer


def poseidon_to_curve(message: list[Fp], total_len: int = POSEIDON_TO_CURVE_INPUT_LEN) -> PallasPoint:
    """Poseidon-based hash-to-curve (reference utils.rs:50-68).

    u_i = Poseidon_L(message || postfix_i); SWU each u_i onto Iso-Pallas, add
    on the iso curve, then apply the 3-isogeny map.
    """
    u0_in = message + POSEIDON_TO_FIELD_U_0_POSTFIX
    u1_in = message + POSEIDON_TO_FIELD_U_1_POSTFIX
    assert len(u0_in) == total_len and len(u1_in) == total_len
    u0 = poseidon_hash_n(u0_in)
    u1 = poseidon_hash_n(u1_in)
    q0 = map_to_curve_simple_swu(u0)
    q1 = map_to_curve_simple_swu(u1)
    return iso_map(q0 + q1)


class ResourceCommitment:
    __slots__ = ("value",)

    def __init__(self, value: Fp):
        self.value = value

    def inner(self) -> Fp:
        return self.value

    def to_bytes(self) -> bytes:
        return self.value.to_repr()

    @classmethod
    def from_bytes(cls, b: bytes):
        v = Fp.from_repr(b)
        return None if v is None else cls(v)

    def __eq__(self, o):
        return isinstance(o, ResourceCommitment) and o.value == self.value

    def __hash__(self):
        return hash(("ResourceCommitment", self.value.v))

    def __repr__(self):
        return f"ResourceCommitment({self.value!r})"


class ResourceKind:
    __slots__ = ("logic", "label")

    def __init__(self, logic: Fp, label: Fp):
        self.logic = logic
        self.label = label

    def derive_kind(self) -> PallasPoint:
        return poseidon_to_curve([self.logic, self.label])

    def __eq__(self, o):
        return isinstance(o, ResourceKind) and o.logic == self.logic and o.label == self.label

    def __repr__(self):
        return f"ResourceKind(logic={self.logic!r}, label={self.label!r})"


class RandomSeed:
    """32 random bytes expanded via Blake2b-512 with person=Taiga_ExpandSeed."""

    __slots__ = ("seed",)

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.seed = seed

    @classmethod
    def random(cls, rng=None):
        return cls(secrets.token_bytes(32) if rng is None else rng.randbytes(32))

    @classmethod
    def from_bytes(cls, b: bytes):
        return cls(b)

    def _expand(self, prefix: bytes) -> bytes:
        h = hashlib.blake2b(digest_size=64, person=PRF_EXPAND_PERSONALIZATION)
        h.update(prefix)
        h.update(self.seed)
        return h.digest()

    def get_random_padding(self, padding_len: int) -> list[Fp]:
        return [
            Fp.from_uniform_bytes(self._expand(bytes([PRF_EXPAND_PUBLIC_INPUT_PADDING, i])))
            for i in range(padding_len)
        ]

    def get_rcv(self) -> Fq:
        """Delta-commitment blinding scalar. Documented deviation from the
        reference (resource.rs:423-427 reduces mod q): we reduce the expanded
        bytes into [0, p) with p = Fp.MODULUS < q, so the scalar is exactly
        representable as the base-field witness cell the compliance circuit
        decomposes canonically (circuits/compliance.py delta gadget). The
        statistical distance from uniform mod q is (q-p)/q < 2^-126."""
        v = Fp.from_uniform_bytes(self._expand(bytes([PRF_EXPAND_VCM_R])))
        return Fq(v.v)

    def get_resource_logic_cm_r(self, tag: int) -> Fp:
        return Fp.from_uniform_bytes(self._expand(bytes([tag])))


class Resource:
    __slots__ = ("kind", "value", "quantity", "nk_container", "nonce", "is_ephemeral", "rseed")

    def __init__(
        self,
        kind: ResourceKind,
        value: Fp,
        quantity: int,
        nk_container: NullifierKeyContainer,
        nonce: Nullifier,
        is_ephemeral: bool,
        rseed: Fp,
    ):
        assert 0 <= quantity < (1 << 64)
        self.kind = kind
        self.value = value
        self.quantity = quantity
        self.nk_container = nk_container
        self.nonce = nonce
        self.is_ephemeral = is_ephemeral
        self.rseed = rseed

    # --- constructors (resource.rs:128-215) ---------------------------
    @classmethod
    def new_input_resource(cls, logic, label, value, quantity, nk, nonce, is_ephemeral, rseed):
        return cls(
            ResourceKind(logic, label), value, quantity,
            NullifierKeyContainer.from_key(nk), nonce, is_ephemeral, rseed,
        )

    @classmethod
    def new_output_resource(cls, logic, label, value, quantity, npk, is_ephemeral, rseed):
        return cls(
            ResourceKind(logic, label), value, quantity,
            NullifierKeyContainer.from_npk(npk), Nullifier.default(), is_ephemeral, rseed,
        )

    @classmethod
    def random_padding_resource(cls, rng=None):
        # Padding resources carry the trivial resource logic (apps.trivial).
        from ..apps.trivial import compressed_trivial_resource_logic_vk

        return cls(
            ResourceKind(compressed_trivial_resource_logic_vk(), Fp.random(rng)),
            Fp.random(rng),
            0,
            NullifierKeyContainer.random_key(rng),
            Nullifier.random(rng),
            True,
            Fp.random(rng),
        )

    # --- derived values ----------------------------------------------
    def commitment(self) -> ResourceCommitment:
        e = Fp((1 << 128) if self.is_ephemeral else 0) + Fp(self.quantity)
        return ResourceCommitment(
            poseidon_hash_n(
                [
                    self.get_logic(),
                    self.get_label(),
                    self.value,
                    self.get_npk(),
                    self.nonce.inner(),
                    self.get_psi(),
                    e,
                    self.get_rcm(),
                ]
            )
        )

    def get_nf(self) -> Nullifier | None:
        return Nullifier.derive(self.nk_container, self.nonce.inner(), self.get_psi(), self.commitment())

    def get_nk(self) -> Fp | None:
        return self.nk_container.get_nk()

    def get_npk(self) -> Fp:
        return self.nk_container.get_npk()

    def get_kind(self) -> PallasPoint:
        return self.kind.derive_kind()

    def get_logic(self) -> Fp:
        return self.kind.logic

    def get_label(self) -> Fp:
        return self.kind.label

    def get_psi(self) -> Fp:
        return poseidon_hash_n(
            [prf_expand_personalization_to_field(), Fp(PRF_EXPAND_PSI), self.rseed, self.nonce.inner()]
        )

    def get_rcm(self) -> Fp:
        return poseidon_hash_n(
            [prf_expand_personalization_to_field(), Fp(PRF_EXPAND_RCM), self.rseed, self.nonce.inner()]
        )

    def calculate_root(self, path: MerklePath) -> Anchor:
        return path.root(Node(self.commitment().inner()))

    def set_nonce(self, input_resource: "Resource"):
        self.nonce = input_resource.get_nf()

    # --- serialization (borsh layout, resource.rs:296-379; 202 bytes) --
    def serialize(self) -> bytes:
        w = io.BytesIO()
        w.write(self.kind.logic.to_repr())
        w.write(self.kind.label.to_repr())
        w.write(self.value.to_repr())
        w.write(self.quantity.to_bytes(8, "little"))
        w.write(bytes([2 if self.nk_container.is_key() else 1]))
        w.write(self.nk_container.raw_inner().to_repr())
        w.write(self.nonce.to_bytes())
        w.write(bytes([1 if self.is_ephemeral else 0]))
        w.write(self.rseed.to_repr())
        out = w.getvalue()
        assert len(out) == 202
        return out

    @classmethod
    def deserialize(cls, data: bytes | io.BytesIO) -> "Resource":
        r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
        logic = _read_fp(r)
        label = _read_fp(r)
        value = _read_fp(r)
        quantity = int.from_bytes(r.read(8), "little")
        nk_type = r.read(1)[0]
        nk_val = _read_fp(r)
        nk = (
            NullifierKeyContainer.from_npk(nk_val)
            if nk_type == 0x01
            else NullifierKeyContainer.from_key(nk_val)
        )
        nonce = Nullifier(_read_fp(r))
        is_ephemeral = r.read(1)[0] == 0x01
        rseed = _read_fp(r)
        return cls(ResourceKind(logic, label), value, quantity, nk, nonce, is_ephemeral, rseed)

    @classmethod
    def random(cls, rng=None):
        q = secrets.randbits(64) if rng is None else rng.getrandbits(64)
        return cls(
            ResourceKind(Fp.random(rng), Fp.random(rng)),
            Fp.random(rng),
            q,
            NullifierKeyContainer.random_key(rng),
            Nullifier.random(rng),
            False,
            Fp.random(rng),
        )

    def __eq__(self, o):
        return (
            isinstance(o, Resource)
            and o.kind == self.kind
            and o.value == self.value
            and o.quantity == self.quantity
            and o.nk_container == self.nk_container
            and o.nonce == self.nonce
            and o.is_ephemeral == self.is_ephemeral
            and o.rseed == self.rseed
        )

    def __repr__(self):
        return (
            f"Resource(kind={self.kind!r}, quantity={self.quantity}, "
            f"ephemeral={self.is_ephemeral})"
        )


def _read_fp(r: io.BytesIO) -> Fp:
    v = Fp.from_repr(r.read(32))
    if v is None:
        raise ValueError("field element out of range")
    return v
