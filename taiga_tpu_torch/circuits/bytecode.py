"""Resource-logic bytecode: portable circuit dispatch.

Port of taiga_tpu/circuits/bytecode.py: proofs and transparent checks run
on a torch device ("cuda" unless the caller passes "cpu").

Mirrors taiga_halo2/src/circuit/resource_logic_bytecode.rs:
a ResourceLogicByteCode names a registered circuit representation plus its
serialized witness inputs; ApplicationByteCode couples the application logic
with up to MAX_DYNAMIC_RESOURCE_LOGIC_NUM dynamic logics. The registry maps
representation names to circuit classes (the reference enumerates them as an
enum; a JSON-able name registry is the extensible equivalent). The modules
that register circuits (apps/ and circuits/vamp_ir.py) are imported on the
first lookup that misses, so every declared arm with a circuit decodes in
any process, whatever it imported first.
"""

from __future__ import annotations

import secrets

from ..core.constants import (
    MAX_DYNAMIC_RESOURCE_LOGIC_NUM,
    RESOURCE_LOGIC_CIRCUIT_RESOURCE_MERKLE_ROOT_IDX,
    RESOURCE_LOGIC_CIRCUIT_SELF_RESOURCE_ID_IDX,
)
from ..core.error import InconsistentResourceMerkleRoot, InvalidResourceLogicRepresentation
from ..crypto.fields import Fp

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
    "vamp_ir",  # the reference's VampIR(Vec<u8>) arm; registered in vamp_ir.py
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


def _load_registrations():
    """Import the modules whose classes register themselves: the apps and
    the Vamp-IR circuit."""
    from .. import apps  # noqa: F401
    from . import vamp_ir  # noqa: F401


def circuit_class_by_name(name: str) -> type:
    cls = _REGISTRY.get(name)
    if cls is None:
        _load_registrations()
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
    _load_registrations()
    return sorted(_REGISTRY)


class ResourceLogicByteCode:
    """(representation name, serialized witness inputs)."""

    __slots__ = ("name", "inputs")

    def __init__(self, name: str, inputs: bytes):
        self.name = name
        self.inputs = inputs

    def decode(self):
        return circuit_class_by_name(self.name).from_bytes(self.inputs)

    def generate_proof(self, *, device="cuda", randbits=secrets.randbits):
        from ..core.proving import prove_resource_logic
        from ..ops.limbs import resolve_device

        resolve_device(device)  # before the keygen
        return prove_resource_logic(self.decode(), device=device, randbits=randbits)

    def verify_transparently(self, compliance_resource_merkle_root: Fp, *, device="cuda") -> Fp:
        """MockProver check on `device` + root consistency; returns the self
        resource id (reference resource_logic_bytecode.rs:121-184)."""
        from ..core.proving import verify_resource_logic_transparently
        from ..ops.limbs import resolve_device

        resolve_device(device)  # before the keygens a decode may make
        public_inputs = verify_resource_logic_transparently(self.decode(), device=device)
        root = public_inputs[RESOURCE_LOGIC_CIRCUIT_RESOURCE_MERKLE_ROOT_IDX]
        if root != compliance_resource_merkle_root:
            raise InconsistentResourceMerkleRoot()
        return public_inputs[RESOURCE_LOGIC_CIRCUIT_SELF_RESOURCE_ID_IDX]


class ApplicationByteCode:
    __slots__ = ("app_resource_logic_bytecode", "dynamic_resource_logic_bytecode")

    def __init__(self, app: ResourceLogicByteCode, dynamic: list[ResourceLogicByteCode]):
        assert len(dynamic) <= MAX_DYNAMIC_RESOURCE_LOGIC_NUM
        self.app_resource_logic_bytecode = app
        self.dynamic_resource_logic_bytecode = list(dynamic)

    def generate_proofs(self, *, device="cuda", randbits=secrets.randbits):
        """The app logic's proof, then each dynamic logic's, on `device`."""
        from ..core.ptx import ResourceLogicVerifyingInfoSet

        app_info = self.app_resource_logic_bytecode.generate_proof(device=device,
                                                                  randbits=randbits)
        dyn_info = [bc.generate_proof(device=device, randbits=randbits)
                    for bc in self.dynamic_resource_logic_bytecode]
        return ResourceLogicVerifyingInfoSet(app_info, dyn_info)

    def verify_transparently(self, compliance_resource_merkle_root: Fp, *, device="cuda") -> Fp:
        """All logics must agree on the self resource id."""
        from ..core.error import InconsistentSelfResourceID

        app_id = self.app_resource_logic_bytecode.verify_transparently(
            compliance_resource_merkle_root, device=device
        )
        for bc in self.dynamic_resource_logic_bytecode:
            if bc.verify_transparently(compliance_resource_merkle_root, device=device) != app_id:
                raise InconsistentSelfResourceID()
        return app_id
