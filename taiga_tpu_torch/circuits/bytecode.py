"""Resource-logic bytecode: portable circuit dispatch.

Copy of taiga_tpu/circuits/bytecode.py without what the port does not have
yet: ApplicationByteCode (its proofs go to the partial transaction's
ResourceLogicVerifyingInfoSet) and the transparent checks (the mock
prover).

Mirrors taiga_halo2/src/circuit/resource_logic_bytecode.rs:
a ResourceLogicByteCode names a registered circuit representation plus its
serialized witness inputs; ApplicationByteCode couples the application logic
with up to MAX_DYNAMIC_RESOURCE_LOGIC_NUM dynamic logics. The registry maps
representation names to circuit classes (the reference enumerates them as an
enum; a JSON-able name registry is the extensible equivalent — the VampIR arm
is represented by the generic "bytecode circuit IR" entry, deferred per
SURVEY.md §7 non-goals).
"""

from __future__ import annotations

from ..core.error import InvalidResourceLogicRepresentation

_REGISTRY: dict[str, type] = {}

# The reference's full ResourceLogicRepresentation enum
# (resource_logic_bytecode.rs:33-46). Every name here is a DECLARED
# representation: it serializes and round-trips on the wire. Names that are
# declared but have no registered circuit (CascadeIntent — enum-only in the
# reference too; its match arms fall through to
# Err(InvalidResourceLogicRepresentation), resource_logic_bytecode.rs:116-117)
# raise InvalidResourceLogicRepresentation on decode, exactly like the
# reference's catch-all arm.
DECLARED_REPRESENTATIONS = (
    "vamp_ir",  # the reference's VampIR(Vec<u8>) arm; no circuit in the port yet
    "Trivial",
    "Token",
    "SignatureVerification",
    "Receiver",
    "PartialFulfillmentIntent",
    "OrRelationIntent",
    "CascadeIntent",
    "FieldAddition",
)


def register_resource_logic(name: str):
    """Class decorator: register a ResourceLogicCircuit subclass by name."""

    def deco(cls):
        _REGISTRY[name] = cls
        cls.REPRESENTATION = name
        return cls

    return deco


def circuit_class_by_name(name: str) -> type:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise InvalidResourceLogicRepresentation(name)
    return cls


def circuit_class_by_id(circuit_id: str) -> type:
    for cls in _REGISTRY.values():
        if cls.circuit_id() == circuit_id:
            return cls
    raise InvalidResourceLogicRepresentation(circuit_id)


def registered_names() -> list[str]:
    return sorted(_REGISTRY)


class ResourceLogicByteCode:
    """(representation name, serialized witness inputs)."""

    __slots__ = ("name", "inputs")

    def __init__(self, name: str, inputs: bytes):
        self.name = name
        self.inputs = inputs

    def decode(self):
        return circuit_class_by_name(self.name).from_bytes(self.inputs)

    def generate_proof(self):
        from ..core.proving import prove_resource_logic

        return prove_resource_logic(self.decode())
