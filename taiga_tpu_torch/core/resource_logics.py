"""ResourceLogics: one application logic + up to 2 dynamic logics per resource.

Copy of taiga_tpu/core/resource_logics.py, whose build proves on a torch
device. Mirrors taiga_halo2/src/resource.rs:451-491 (kept in its own
module to avoid an import cycle with the circuit layer).
"""

from __future__ import annotations

import secrets

from .constants import MAX_DYNAMIC_RESOURCE_LOGIC_NUM
from .proving import prove_resource_logic
from .ptx import ResourceLogicVerifyingInfoSet


class ResourceLogics:
    def __init__(self, application_resource_logic, dynamic_resource_logics=None):
        dynamic_resource_logics = dynamic_resource_logics or []
        assert len(dynamic_resource_logics) <= MAX_DYNAMIC_RESOURCE_LOGIC_NUM
        self.application_resource_logic = application_resource_logic
        self.dynamic_resource_logics = list(dynamic_resource_logics)

    def build(self, *, device="cuda", randbits=secrets.randbits) -> ResourceLogicVerifyingInfoSet:
        """The app logic's proof, then each dynamic logic's, on `device`
        (prove_resource_logic checks the device before any keygen)."""
        app_info = prove_resource_logic(self.application_resource_logic, device=device,
                                        randbits=randbits)
        dyn_info = [prove_resource_logic(rl, device=device, randbits=randbits)
                    for rl in self.dynamic_resource_logics]
        return ResourceLogicVerifyingInfoSet(app_info, dyn_info)

    def to_application_bytecode(self):
        """-> ApplicationByteCode (for the transparent execution path)."""
        from ..circuits.bytecode import ApplicationByteCode

        return ApplicationByteCode(
            self.application_resource_logic.to_bytecode(),
            [rl.to_bytecode() for rl in self.dynamic_resource_logics],
        )

    @classmethod
    def create_padding_resource_resource_logics(cls, resource, merkle_path):
        from ..apps.trivial import TrivialResourceLogicCircuit

        return cls(TrivialResourceLogicCircuit.from_resource_path(resource, merkle_path))
