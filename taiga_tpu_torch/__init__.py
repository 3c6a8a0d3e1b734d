"""taiga_tpu_torch — the PyTorch/CUDA port of taiga_tpu.

A Halo2-style PLONK/IPA prover and verifier over the Pasta curves for
Taiga's shielded resource machine, with the proving math on an NVIDIA GPU:
plain PyTorch for the tensor code and hand-written CUDA kernels (csrc/) for
every kernel the JAX package wrote in Pallas. The package imports neither
JAX nor taiga_tpu; it keeps its own copy of the host layers it needs.

Layer map (the JAX package's layout and names):
  crypto/    Pasta fields & curves, Poseidon (host, copied)
  core/      resource data model and compliance info (host, copied)
  circuits/  compliance circuit and its gadgets (host, copied)
  native/    the C++ host engine (keygen commitments, the native IPA open,
             verification)
  ops/       limb arithmetic, NTT, fixed-base MSM, lookup sort, tape
             interpreter — each CUDA kernel beside its plain version
  plonk/     constraint system, keygen, prover, verifier

Entry points run on "cuda" unless the caller passes device="cpu"; asking for
"cuda" without a card raises.
"""

from __future__ import annotations

import secrets

__version__ = "0.1.0"

_PK_CACHE: dict = {}


def compliance_proving_key(k: int = 13):
    """The compliance circuit's proving key at domain 2^k (host keygen on the
    native engine, cached per k)."""
    pk = _PK_CACHE.get(k)
    if pk is None:
        from .circuits.compliance import ComplianceCircuit
        from .plonk.keygen import keygen

        pk = _PK_CACHE[k] = keygen(ComplianceCircuit(), k)
    return pk


def prove_compliance(rng, k: int = 13, device="cuda", randbits=secrets.randbits,
                     timer=None, ipa: str = "native"):
    """Prove one random compliance (Action) statement,
    ComplianceInfo.random(rng) for a random.Random `rng`, at domain 2^k on
    `device`. Every blind comes from `randbits`; `timer`
    (plonk.prover.StageTimer) records stage wall times; `ipa` is "native"
    (the C++ engine's IPA open) or "device" (the IPA open on `device`).
    Returns (vk, instance, proof bytes)."""
    from .core.compliance import ComplianceInfo
    from .plonk.prover import create_proof

    pis, circuit = ComplianceInfo.random(rng).build()
    instance = pis.to_instance()
    pk = compliance_proving_key(k)
    proof = create_proof(pk, circuit, instance, device=device, randbits=randbits,
                         timer=timer, ipa=ipa)
    return pk.vk, instance, proof
