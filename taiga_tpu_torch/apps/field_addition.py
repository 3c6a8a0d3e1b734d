"""Field-addition resource logic: minimal custom-public-input demo.

Mirrors taiga_halo2/src/circuit/resource_logic_examples/
field_addition.rs: witnesses a and b and publicizes c = a + b at the first
custom public input (index 6).
"""

from __future__ import annotations

import io

from ..circuits import gadgets as G
from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.resource_logic import ResourceLogicCircuit
from ..core.constants import RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_BEGIN_IDX
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.fields import Fp


@register_resource_logic("FieldAddition")
class FieldAdditionResourceLogicCircuit(ResourceLogicCircuit):
    def __init__(
        self,
        self_resource: ResourceExistenceWitness | None = None,
        a: Fp | None = None,
        b: Fp | None = None,
    ):
        super().__init__(self_resource)
        self.a = a or Fp.zero()
        self.b = b or Fp.zero()

    def custom_public_inputs(self) -> list[Fp]:
        pad = self._padding_seed.get_random_padding(16)
        return [self.a + self.b] + pad[1:]

    def custom_constraints(self, b, basic):
        known = self.self_resource is not None
        ca = G.witness_cell(b, self.a.v if known else None)
        cb = G.witness_cell(b, self.b.v if known else None)
        cc = G.add_cells(b, ca, cb)
        self._sum_cell = cc

    def bound_public_cells(self, b, basic) -> dict:
        return {RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_BEGIN_IDX: self._sum_cell}

    def to_bytes(self) -> bytes:
        return self.self_resource.serialize() + self.a.to_repr() + self.b.to_repr()

    @classmethod
    def from_bytes(cls, data: bytes):
        r = io.BytesIO(data)
        w = ResourceExistenceWitness.deserialize(r.read(334))
        a = Fp.from_repr(r.read(32))
        b = Fp.from_repr(r.read(32))
        if a is None or b is None:
            raise ValueError("invalid field addition encoding")
        return cls(w, a, b)

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("FieldAddition", self.to_bytes())
