"""Proof plumbing: proving-key cache, Proof wrapper, RL verifying info.

Port of taiga_tpu/core/proving.py's entry points for the prover on the
device. Every circuit class keygens once per (class, k) on the native
engine (the reference re-keygens a proving key per resource-logic proof,
taiga_halo2 constant.rs:6146); the key is cached in memory and pickled to
`.pk_cache_torch/` at the repo root, so a later process loads it instead.
The disk key names the class, k, a digest of every port source that shapes
a key (circuits/, plonk/, crypto/, apps/, core/constants.py and the native
engine, whose commitments a key holds) and a digest of the file that
defines the class. The device tables (plonk.prover.ProverPipeline) are not
part of the key. Every proof runs on `device`, "cuda" unless the caller
passes "cpu"; there is no host-prover dispatch: on the CPU the port runs
its plain versions.

`Proof` wraps raw transcript bytes (reference src/proof.rs). Verifying info
structs bundle proof + public inputs per circuit, as in shielded_ptx.rs.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import secrets
import sys
import threading
import warnings

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
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PK_DIR = os.path.join(os.path.dirname(_PKG_ROOT), ".pk_cache_torch")
_SRC_CLOSURE_DIGEST: str | None = None


def _closure_digest(root: str) -> str:
    """Digest of the sources under the package root `root` that can shape a
    proving key: the circuits and the gadget library, the plonk layout and
    keygen, the fields and curves, the apps, the shared constants, and the
    native engine that commits the fixed and permutation columns (its Python
    wrapper and its C++ source)."""
    paths = [os.path.join(root, "core", "constants.py")]
    for sub, ext in (("circuits", ".py"), ("plonk", ".py"), ("crypto", ".py"), ("apps", ".py"),
                     ("native", ".py"), (os.path.join("native", "src"), ".cpp")):
        d = os.path.join(root, sub)
        paths += [os.path.join(d, f) for f in os.listdir(d) if f.endswith(ext)]
    h = hashlib.blake2b(digest_size=16)
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(os.path.relpath(p, root).encode())
            h.update(f.read())
    return h.hexdigest()


def _source_closure_digest() -> str:
    """The port's _closure_digest, computed once a process."""
    global _SRC_CLOSURE_DIGEST
    if _SRC_CLOSURE_DIGEST is None:
        _SRC_CLOSURE_DIGEST = _closure_digest(_PKG_ROOT)
    return _SRC_CLOSURE_DIGEST


def _defining_file_digest(circuit_cls) -> str | None:
    """Digest of the file that defines the class, or None where the class
    has no source file."""
    path = getattr(sys.modules.get(circuit_cls.__module__), "__file__", None)
    if not path or not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        return hashlib.blake2b(f.read(), digest_size=16).hexdigest()


def pk_cache_path(circuit_cls, k: int) -> str | None:
    """The file in which the disk cache keeps the proving key of a circuit
    class at domain 2^k, or None where the class has no source file (its key
    is then kept in memory only). The file's name hashes the class's module
    and qualified name, k, the port's source closure and the defining file."""
    file_digest = _defining_file_digest(circuit_cls)
    if file_digest is None:
        return None
    key = (circuit_cls.__module__, circuit_cls.__qualname__, k, _source_closure_digest(),
           file_digest)
    h = hashlib.blake2b(repr(key).encode(), digest_size=16).hexdigest()
    return os.path.join(_PK_DIR, f"pk_{h}.pkl")


def _pk_load(path: str, k: int):
    """The key stored at path, or None if there is none or it does not load
    as a proving key at domain 2^k."""
    from ..plonk.keygen import ProvingKey

    try:
        with open(path, "rb") as f:
            pk = pickle.load(f)
    except Exception:  # noqa: BLE001 — missing, truncated or corrupt: regenerate
        return None
    return pk if isinstance(pk, ProvingKey) and pk.vk.k == k else None


def _pk_store(path: str, pk):
    """Write the key to a file of this process and thread, then move it into
    place: concurrent writers of one key each leave a whole file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(pk, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except (OSError, pickle.PicklingError, TypeError, AttributeError) as e:
        warnings.warn(f"proving key not stored in the disk cache: {e!r}")
        try:
            os.remove(tmp)
        except OSError:
            pass


def get_proving_key(circuit_cls, k: int):
    """The proving key of a circuit class at domain 2^k, from memory, else
    from the disk cache (pk_cache_path), else by host keygen on the native
    engine, then kept in both."""
    key = (circuit_cls.__module__, circuit_cls.__qualname__, k)
    with _PK_LOCK:
        pk = _PK_CACHE.get(key)
        if pk is None:
            path = pk_cache_path(circuit_cls, k)
            pk = None if path is None else _pk_load(path, k)
            if pk is None:
                from ..plonk.keygen import keygen

                pk = keygen(circuit_cls(), k)
                if path is not None:
                    _pk_store(path, pk)
            _PK_CACHE[key] = pk
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
