"""Resource-logic (validity-predicate) commitment.

Mirrors taiga_halo2/src/resource_logic_commitment.rs:
  cm = Blake2s-256(person="VPCommit", logic_vk_repr || rcm_repr)
exposed to circuits as two 128-bit field elements (little-endian halves).
"""

from __future__ import annotations

import hashlib

from ..crypto.fields import Fp
from .constants import RESOURCE_LOGIC_COMMITMENT_PERSONALIZATION


class ResourceLogicCommitment:
    __slots__ = ("digest",)

    def __init__(self, digest: bytes):
        assert len(digest) == 32
        self.digest = digest

    @classmethod
    def commit(cls, resource_logic: Fp, rcm: Fp) -> "ResourceLogicCommitment":
        h = hashlib.blake2s(
            digest_size=32, person=RESOURCE_LOGIC_COMMITMENT_PERSONALIZATION
        )
        h.update(resource_logic.to_repr())
        h.update(rcm.to_repr())
        return cls(h.digest())

    @classmethod
    def default(cls):
        return cls(bytes(32))

    def to_bytes(self) -> bytes:
        return self.digest

    @classmethod
    def from_bytes(cls, b: bytes):
        return cls(bytes(b))

    @classmethod
    def from_public_inputs(cls, public_inputs: list[Fp]):
        lo, hi = public_inputs
        return cls(lo.to_repr()[:16] + hi.to_repr()[:16])

    def to_public_inputs(self) -> list[Fp]:
        lo = Fp(int.from_bytes(self.digest[:16], "little"))
        hi = Fp(int.from_bytes(self.digest[16:], "little"))
        return [lo, hi]

    def __eq__(self, o):
        return isinstance(o, ResourceLogicCommitment) and o.digest == self.digest

    def __repr__(self):
        return f"ResourceLogicCommitment({self.digest.hex()})"
