"""Homomorphic delta (value) commitment.

Mirrors taiga_halo2/src/delta_commitment.rs:
  Delta = [q_in] Kind_in - [q_out] Kind_out + [rcv] R
where Kind = poseidon_to_curve(logic, label) and R is the Sinsemilla
"Taiga-NoteCommit-r" generator.
"""

from __future__ import annotations

from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq
from .constants import resource_commitment_r_generator
from .resource import Resource


class DeltaCommitment:
    __slots__ = ("point",)

    def __init__(self, point: PallasPoint):
        self.point = point

    @classmethod
    def commit(cls, input_resource: Resource, output_resource: Resource, blind_r: Fq):
        base_in = input_resource.get_kind()
        base_out = output_resource.get_kind()
        return cls(
            base_in * Fq(input_resource.quantity)
            - base_out * Fq(output_resource.quantity)
            + resource_commitment_r_generator() * blind_r
        )

    def get_x(self) -> Fp:
        return Fp.zero() if self.point.is_identity() else self.point.x

    def get_y(self) -> Fp:
        return Fp.zero() if self.point.is_identity() else self.point.y

    def inner(self) -> PallasPoint:
        return self.point

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    @classmethod
    def from_bytes(cls, b: bytes):
        p = PallasPoint.from_bytes(b)
        return None if p is None else cls(p)

    def __eq__(self, o):
        return isinstance(o, DeltaCommitment) and o.point == self.point
