"""taiga_tpu_torch — the PyTorch/CUDA port of taiga_tpu.

A Halo2-style PLONK/IPA prover and verifier over the Pasta curves for
Taiga's shielded resource machine, with the proving math on an NVIDIA GPU:
plain PyTorch for the tensor code and hand-written CUDA kernels (csrc/) for
every kernel the JAX package wrote in Pallas. The package imports neither
JAX nor taiga_tpu; it keeps its own copy of the host layers it needs.

Layer map (the JAX package's layout and names):
  crypto/    Pasta fields & curves, Poseidon, RedDSA (host, copied)
  core/      resource data model, compliance info, encryption, the
             transaction and its binding signature (host, copied); the
             proving entry points and partial transactions (proving.py,
             ptx.py)
  circuits/  compliance circuit, resource-logic framework and their gadgets
             (host, copied); the bytecode registry
  apps/      the seven example resource logics (host, copied)
  examples/  the three transaction flows, transparent or shielded
  native/    the C++ host engine (keygen commitments, the native IPA open,
             verification)
  ops/       limb arithmetic, NTT, fixed-base MSM, lookup sort, tape
             interpreter — each CUDA kernel beside its plain version
  plonk/     constraint system, keygen, prover (one proof, a lockstep
             batch, the cross-batch pipeline), verifier, mock prover

Entry points run on "cuda" unless the caller passes device="cpu"; asking for
"cuda" without a card raises.
"""

from __future__ import annotations

import secrets

__version__ = "0.1.0"


def compliance_proving_key(k: int = 13):
    """The compliance circuit's proving key at domain 2^k (host keygen on the
    native engine, cached per k: core.proving.get_proving_key)."""
    from .circuits.compliance import ComplianceCircuit
    from .core.proving import get_proving_key

    return get_proving_key(ComplianceCircuit, k)


def prove_compliance(rng, k: int = 13, device="cuda", randbits=secrets.randbits,
                     timer=None, ipa: str = "native"):
    """Prove one random compliance (Action) statement,
    ComplianceInfo.random(rng) for a random.Random `rng`, at domain 2^k on
    `device`. Every blind comes from `randbits`; `timer`
    (plonk.prover.StageTimer) records stage wall times; `ipa` is "native"
    (the C++ engine's IPA open) or "device" (the IPA open on `device`).
    Returns (vk, instance, proof bytes)."""
    from .core.compliance import ComplianceInfo
    from .ops.limbs import resolve_device
    from .plonk.prover import create_proof

    resolve_device(device)  # before the keygen
    pis, circuit = ComplianceInfo.random(rng).build()
    instance = pis.to_instance()
    pk = compliance_proving_key(k)
    proof = create_proof(pk, circuit, instance, device=device, randbits=randbits,
                         timer=timer, ipa=ipa)
    return pk.vk, instance, proof


def prove_compliance_batch(rngs, k: int = 13, device="cuda", randbits=secrets.randbits,
                           timer=None):
    """Prove one random compliance statement for each random.Random in
    `rngs` (ComplianceInfo.random(rng)) in one lockstep batch at domain 2^k
    on `device` (plonk.prover.create_proofs_batch). Every blind comes from
    `randbits`; `timer` records the batch's stage wall times. Returns (vk,
    instances, proofs); a batch of one equals prove_compliance's proof."""
    from .core.compliance import ComplianceInfo
    from .ops.limbs import resolve_device
    from .plonk.prover import create_proofs_batch

    resolve_device(device)  # before the keygen
    built = [ComplianceInfo.random(rng).build() for rng in rngs]
    instances = [pis.to_instance() for pis, _ in built]
    pk = compliance_proving_key(k)
    proofs = create_proofs_batch(pk, [c for _, c in built], instances, device=device,
                                 randbits=randbits, timer=timer)
    return pk.vk, instances, proofs
