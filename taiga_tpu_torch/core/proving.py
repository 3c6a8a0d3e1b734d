"""Proof plumbing: proving-key cache, Proof wrapper, RL verifying info.

Port of taiga_tpu/core/proving.py's entry points for the prover on the
device. Every circuit class keygens once per (class, k) on the native
engine and is cached in memory (the reference re-keygens a proving key per
resource-logic proof, taiga_halo2 constant.rs:6146); there is no disk cache.
Every proof runs on `device`, "cuda" unless the caller passes "cpu"; there
is no host-prover dispatch: on the CPU the port runs its plain versions.

`Proof` wraps raw transcript bytes (reference src/proof.rs). Verifying info
structs bundle proof + public inputs per circuit, as in shielded_ptx.rs.
"""

from __future__ import annotations

import secrets
import threading

from ..crypto.fields import Fp
from ..ops.limbs import resolve_device
from .constants import (
    COMPLIANCE_CIRCUIT_PARAMS_SIZE,
    RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE,
    RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM,
    RESOURCE_LOGIC_CIRCUIT_RESOURCE_MERKLE_ROOT_IDX,
    RESOURCE_LOGIC_CIRCUIT_SELF_RESOURCE_ID_IDX,
)
from .error import ProofError


def compliance_k() -> int:
    return COMPLIANCE_CIRCUIT_PARAMS_SIZE


def resource_logic_k() -> int:
    return RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE


_PK_CACHE: dict = {}
_PK_LOCK = threading.Lock()


def get_proving_key(circuit_cls, k: int):
    """The proving key of a circuit class at domain 2^k: host keygen on the
    native engine, cached in memory per (class, k)."""
    key = (circuit_cls.__module__, circuit_cls.__qualname__, k)
    with _PK_LOCK:
        pk = _PK_CACHE.get(key)
        if pk is None:
            from ..plonk.keygen import keygen

            pk = _PK_CACHE[key] = keygen(circuit_cls(), k)
    return pk


class Proof:
    """Opaque proof bytes (reference src/proof.rs:20-64)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    @classmethod
    def create(cls, circuit, instance: list[Fp], k: int, *, device="cuda",
               randbits=secrets.randbits) -> "Proof":
        from ..plonk.prover import create_proof

        resolve_device(device)  # before the keygen: a missing card raises at once
        pk = get_proving_key(type(circuit), k)
        return cls(create_proof(pk, circuit, instance, device=device, randbits=randbits))

    def verify(self, circuit_cls, instance: list[Fp], k: int) -> bool:
        from ..plonk.verifier import verify_proof

        pk = get_proving_key(circuit_cls, k)
        return verify_proof(pk.vk, instance, self.data)

    def to_bytes(self) -> bytes:
        return self.data

    @classmethod
    def from_bytes(cls, b: bytes):
        return cls(b)


_VK_PARSE_CACHE: dict = {}


def _parse_vk(vk_bytes: bytes):
    """Deserialize (and cache) a carried verifying key."""
    import hashlib

    from ..plonk.keygen import VerifyingKey

    key = hashlib.blake2b(vk_bytes, digest_size=16).digest()
    vk = _VK_PARSE_CACHE.get(key)
    if vk is None:
        vk = VerifyingKey.from_bytes(vk_bytes)
        _VK_PARSE_CACHE[key] = vk
    return vk


class ResourceLogicVerifyingInfo:
    """{vk, proof, 22 public inputs} (reference
    resource_logic_circuit.rs:79-90). The verifying key travels WITH the
    proof and verification runs against the carried vk, through the port's
    verifier — third-party logics verify without any registry (the
    circuit_id tags the bytecode arm for diagnostics only)."""

    __slots__ = ("circuit_id", "proof", "public_inputs", "vk_bytes")

    def __init__(self, circuit_id: str, proof: Proof, public_inputs: list[Fp],
                 vk_bytes: bytes):
        self.circuit_id = circuit_id
        self.proof = proof
        self.public_inputs = public_inputs
        self.vk_bytes = vk_bytes

    def verify(self):
        from ..plonk.verifier import verify_proof

        try:
            vk = _parse_vk(self.vk_bytes)
        except (ValueError, IndexError) as e:
            raise ProofError(f"malformed resource logic vk: {e}") from e
        if len(self.public_inputs) != RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM:
            raise ProofError("bad resource logic public input count")
        if not verify_proof(vk, self.public_inputs, self.proof.data):
            raise ProofError(f"resource logic proof failed: {self.circuit_id}")
        return True

    def get_resource_merkle_root(self) -> Fp:
        return self.public_inputs[RESOURCE_LOGIC_CIRCUIT_RESOURCE_MERKLE_ROOT_IDX]

    def get_self_resource_id(self) -> Fp:
        return self.public_inputs[RESOURCE_LOGIC_CIRCUIT_SELF_RESOURCE_ID_IDX]


def prove_resource_logic(circuit, *, device="cuda",
                         randbits=secrets.randbits) -> ResourceLogicVerifyingInfo:
    """Prove one resource-logic circuit instance on `device`."""
    resolve_device(device)  # before the public inputs, which may need keygens
    instance = circuit.get_public_inputs()
    proof = Proof.create(circuit, instance, resource_logic_k(), device=device,
                         randbits=randbits)
    pk = get_proving_key(type(circuit), resource_logic_k())
    return ResourceLogicVerifyingInfo(type(circuit).circuit_id(), proof, instance,
                                      pk.vk.to_bytes())


def prove_resource_logics_batch(circuits, *, device="cuda",
                                randbits=secrets.randbits) -> list[ResourceLogicVerifyingInfo]:
    """Prove many resource-logic instances on `device`, in the reference's
    order (taiga_tpu/core/proving.py's device path), which is the order the
    proofs draw from `randbits` in: with one circuit or none, each alone;
    otherwise the circuits are grouped by class, in order of first
    appearance, each class with a single circuit is proved at once through
    prove_resource_logic, and then the groups of two or more go through the
    cross-batch pipeline (plonk.prover.create_proofs_pipelined), each
    group's multiopen and IPA tails under the next group's device stages.
    Returns one verifying info a circuit, in order."""
    from ..plonk.prover import create_proofs_pipelined

    resolve_device(device)  # before the keygens
    k = resource_logic_k()
    out: list = [None] * len(circuits)
    if len(circuits) <= 1:
        for i, c in enumerate(circuits):
            out[i] = prove_resource_logic(c, device=device, randbits=randbits)
        return out
    groups: dict[type, list[int]] = {}
    for i, c in enumerate(circuits):
        groups.setdefault(type(c), []).append(i)
    jobs, job_meta = [], []
    for cls, idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = prove_resource_logic(circuits[idxs[0]], device=device,
                                                randbits=randbits)
            continue
        pk = get_proving_key(cls, k)
        insts = [circuits[i].get_public_inputs() for i in idxs]
        jobs.append((pk, [circuits[i] for i in idxs], insts))
        job_meta.append((cls, pk, idxs, insts))
    for proofs, (cls, pk, idxs, insts) in zip(
            create_proofs_pipelined(jobs, device=device, randbits=randbits), job_meta):
        vkb = pk.vk.to_bytes()
        for i, inst, pf in zip(idxs, insts, proofs):
            out[i] = ResourceLogicVerifyingInfo(cls.circuit_id(), Proof(pf), inst, vkb)
    return out


def verify_resource_logic_transparently(circuit, *, device="cuda") -> list[Fp]:
    """MockProver-style transparent check on `device`; returns the public
    inputs (reference resource_logic_circuit.rs:597-606 macro)."""
    from ..plonk.mock import MockProver

    resolve_device(device)  # before the public inputs, which may need keygens
    instance = circuit.get_public_inputs()
    mp = MockProver.run(resource_logic_k(), circuit, instance, device=device)
    failures = mp.verify()
    if failures:
        raise ProofError("; ".join(failures))
    return instance
