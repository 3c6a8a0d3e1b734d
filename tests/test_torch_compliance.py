"""The port's compliance (Action) flow against the JAX package at the
production k = 13: the keygen arrays and verifying key, the statement's
public inputs and the synthesized advice columns and copy constraints are
equal, exactly. The `slow` tier proves at k = 13 on the CPU, through the
plain versions of the kernels, and compares the bytes with the JAX
package's host prover."""

import random

import numpy as np
import pytest

from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu.plonk.verifier import verify_proof as jverify
from taiga_tpu_torch.plonk import keygen as TK, verifier as TV
from taiga_tpu_torch.plonk.circuit import CircuitBuilder

CK = 13


def _jax_compliance_info(rng: random.Random):
    """The JAX package's ComplianceInfo built from the draws, in the order,
    that the port's ComplianceInfo.random(rng) takes them (the reference's
    random() takes some of them from the OS)."""
    from taiga_tpu.core import merkle, resource as res
    from taiga_tpu.core.compliance import ComplianceInfo
    from taiga_tpu.core.constants import TAIGA_COMMITMENT_TREE_DEPTH
    from taiga_tpu.core.nullifier import Nullifier, NullifierKeyContainer
    from taiga_tpu.crypto.fields import Fp

    def resource():
        q = rng.getrandbits(64)
        return res.Resource(res.ResourceKind(Fp.random(rng), Fp.random(rng)), Fp.random(rng),
                            q, NullifierKeyContainer.random_key(rng), Nullifier.random(rng),
                            False, Fp.random(rng))

    inp = resource()
    path = merkle.MerklePath([(merkle.Node(Fp.random(rng)),
                               merkle.LR.from_bool(bool(rng.getrandbits(1))))
                              for _ in range(TAIGA_COMMITMENT_TREE_DEPTH)])
    return ComplianceInfo(inp, path, None, resource(), rseed=res.RandomSeed(rng.randbytes(32)))


def _synthesize(circuit, builder_cls, k):
    cs, config = type(circuit).build_cs()
    builder = builder_cls(cs, k, "prove")
    circuit.synthesize(builder, config)
    return builder


def test_compliance_keygen_matches_reference():
    from taiga_tpu.circuits.compliance import ComplianceCircuit as JComplianceCircuit
    from taiga_tpu_torch.circuits.compliance import ComplianceCircuit

    jpk, tpk = jkeygen(JComplianceCircuit(), CK), TK.keygen(ComplianceCircuit(), CK)
    assert tpk.vk.to_bytes() == jpk.vk.to_bytes()
    np.testing.assert_array_equal(tpk.fixed_mont(), np.asarray(jpk.fixed_mont()).astype(np.int32))
    np.testing.assert_array_equal(tpk.sigma_mont(), np.asarray(jpk.sigma_mont()).astype(np.int32))


def test_compliance_witness_matches_reference():
    from taiga_tpu.plonk.circuit import CircuitBuilder as JCircuitBuilder
    from taiga_tpu_torch.core.compliance import ComplianceInfo

    jpis, jcirc = _jax_compliance_info(random.Random(5)).build()
    pis, circ = ComplianceInfo.random(random.Random(5)).build()
    assert [v.v for v in pis.to_instance()] == [v.v for v in jpis.to_instance()]
    got = _synthesize(circ, CircuitBuilder, CK)
    want = _synthesize(jcirc, JCircuitBuilder, CK)
    assert got.rows_used() == want.rows_used()
    assert len(got.advice) == len(want.advice)
    for i, (g, w) in enumerate(zip(got.advice, want.advice)):
        assert [int(v) for v in g] == [int(v) for v in w], f"advice column {i}"
    assert got.copies == want.copies


@pytest.mark.slow
def test_compliance_proof_on_cpu_equals_host_prover():
    """The full k = 13 proof through the plain versions, byte for byte
    against taiga_tpu.plonk.host_prover under the same seeds."""
    import secrets

    import taiga_tpu_torch as T
    from taiga_tpu.circuits.compliance import ComplianceCircuit as JComplianceCircuit
    from taiga_tpu.plonk.host_prover import create_proof_host

    vk, inst, proof = T.prove_compliance(random.Random(3), CK, device="cpu",
                                         randbits=random.Random(4).getrandbits)
    jpis, jcirc = _jax_compliance_info(random.Random(3)).build()
    jinst = jpis.to_instance()
    jpk = jkeygen(JComplianceCircuit(), CK)
    orig = secrets.randbits
    secrets.randbits = random.Random(4).getrandbits
    try:
        want = create_proof_host(jpk, jcirc, jinst)
    finally:
        secrets.randbits = orig
    assert [v.v for v in inst] == [v.v for v in jinst]
    assert proof == want
    assert TV.verify_proof(vk, inst, proof)
    assert jverify(jpk.vk, jinst, proof)
