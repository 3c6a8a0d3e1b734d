"""Trivial resource logic: the no-op validity predicate.

Mirrors taiga_halo2/src/circuit/resource_logic_examples.rs —
only the basic constraints (resource-tree membership + self-resource id); its
compressed VK identifies padding resources (resource.rs:198-215).
"""

from __future__ import annotations

from functools import lru_cache

from ..circuits.bytecode import ResourceLogicByteCode, register_resource_logic
from ..circuits.resource_logic import ResourceLogicCircuit
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.fields import Fp


@register_resource_logic("Trivial")
class TrivialResourceLogicCircuit(ResourceLogicCircuit):
    """No custom constraints."""

    @classmethod
    def from_resource_path(cls, resource, merkle_path):
        return cls(ResourceExistenceWitness(resource, merkle_path))

    def to_bytes(self) -> bytes:
        return self.self_resource.serialize()

    @classmethod
    def from_bytes(cls, data: bytes):
        return cls(ResourceExistenceWitness.deserialize(data))

    def to_bytecode(self) -> ResourceLogicByteCode:
        return ResourceLogicByteCode("Trivial", self.to_bytes())


@lru_cache(maxsize=None)
def compressed_trivial_resource_logic_vk() -> Fp:
    """COMPRESSED_TRIVIAL_RESOURCE_LOGIC_VK (resource_logic_examples.rs:41-64)."""
    return TrivialResourceLogicCircuit.compressed_vk()
