"""The port's trivial resource logic (taiga_tpu_torch.apps.trivial, with
circuits/resource_logic.py, core/resource_tree.py and the SRS at k = 12)
against the JAX package, exact equality, on tools/prover_diff.py's
"trivial" statement: a random resource, the identity its nullifier, in a
resource tree of four leaves. The statement is carried across by the
witness's serialization, and the per-instance padding of public inputs
6..21 by its seed.

Tier 1 holds the public inputs, a synthesis of the circuit (the witness
columns in prove mode; the fixed columns and copies in keygen mode), the
keygen at the production k = 12 and the copied SRS. The `slow` tier holds
a seeded proof, byte for byte against create_proof_host: on the CPU a
proof at k = 12 runs its commitments through the plain versions for tens
of minutes."""

import random
import secrets

import numpy as np
import pytest
import torch

from taiga_tpu.apps.trivial import TrivialResourceLogicCircuit as JTrivial
from taiga_tpu.core.constants import RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE as JK
from taiga_tpu.core.resource import Resource as JResource
from taiga_tpu.core.resource_tree import (
    ResourceExistenceWitness as JWitness,
    ResourceMerkleTreeLeaves as JLeaves,
)
from taiga_tpu.crypto.fields import Fp as JFp
from taiga_tpu.plonk.circuit import CircuitBuilder as JBuilder
from taiga_tpu.plonk.host_prover import create_proof_host
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu.plonk.srs import get_params as jget_params
from taiga_tpu.plonk.verifier import verify_proof as jverify
from taiga_tpu_torch.apps.trivial import TrivialResourceLogicCircuit
from taiga_tpu_torch.circuits.bytecode import circuit_class_by_name
from taiga_tpu_torch.core.constants import RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE
from taiga_tpu_torch.core.proving import ResourceLogicVerifyingInfo, Proof
from taiga_tpu_torch.core.resource import RandomSeed
from taiga_tpu_torch.core.resource_tree import ResourceExistenceWitness, ResourceMerkleTreeLeaves
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.plonk import keygen as TK, prover as TP
from taiga_tpu_torch.plonk.circuit import CircuitBuilder
from taiga_tpu_torch.plonk.srs import get_params
from taiga_tpu_torch.plonk.verifier import verify_proof
from tools.prover_diff import proof_items

K = RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def statement():
    """tools/prover_diff.py::build("trivial")'s statement, without its
    keygen: the JAX package's circuit and the port's, carried across."""
    prng = random.Random(3)
    r = JResource.random(prng)
    ident = r.get_nf().inner()
    leaves = [ident] + [JFp.random(prng) for _ in range(3)]
    tree = JLeaves(leaves)
    jc = JTrivial(JWitness(r, tree.generate_path(ident)))
    tc = TrivialResourceLogicCircuit(ResourceExistenceWitness.deserialize(jc.self_resource.serialize()))
    tc._padding_seed = RandomSeed(jc._padding_seed.seed)
    return jc, tc, leaves


def test_resource_tree_matches_reference(statement):
    jc, tc, leaves = statement
    tree = ResourceMerkleTreeLeaves([Fp(v.v) for v in leaves])
    jtree = JLeaves(leaves)
    assert tree.root().v == jtree.root().v
    path = tree.generate_path(Fp(leaves[0].v))
    assert [(s.v, lr.is_left()) for s, lr in path] == \
        [(s.v, lr.is_left()) for s, lr in jtree.generate_path(leaves[0])]
    w = tc.self_resource
    assert w.get_root().v == jc.self_resource.get_root().v
    assert w.get_identity().v == jc.self_resource.get_identity().v
    assert w.serialize() == jc.self_resource.serialize()


def test_public_inputs_and_synthesis_match_reference(statement):
    """The 22 public inputs, the prove-mode witness columns and the
    keygen-mode fixed columns and copies of the trivial logic at k = 12."""
    jc, tc, _ = statement
    assert JK == K
    assert [v.v for v in tc.get_public_inputs()] == [v.v for v in jc.get_public_inputs()]
    for mode in ("prove", "keygen"):
        jcs, jconf = type(jc).build_cs()
        tcs, tconf = type(tc).build_cs()
        jb, tb = JBuilder(jcs, K, mode), CircuitBuilder(tcs, K, mode)
        (jc if mode == "prove" else JTrivial()).synthesize(jb, jconf)
        (tc if mode == "prove" else TrivialResourceLogicCircuit()).synthesize(tb, tconf)
        assert tb.rows_used() == jb.rows_used()
        assert tb.advice == jb.advice
        assert tb.fixed == jb.fixed
        assert tb.copies == jb.copies


def test_bytecode_registry_decodes_the_trivial_logic(statement):
    _, tc, _ = statement
    bc = tc.to_bytecode()
    assert circuit_class_by_name(bc.name) is TrivialResourceLogicCircuit
    assert bc.decode().self_resource.serialize() == tc.self_resource.serialize()


def test_copied_srs_equals_reference():
    """params/srs_12.npz is the JAX package's SRS (no first-use generation
    writes into the package)."""
    tp, jp = get_params(12), jget_params(12)
    assert tp.k == jp.k == 12
    assert [(p.x.v, p.y.v) for p in tp.g + [tp.w, tp.u]] == \
        [(p.x.v, p.y.v) for p in jp.g + [jp.w, jp.u]]


@pytest.fixture(scope="module")
def keys():
    return jkeygen(JTrivial(), K), TK.keygen(TrivialResourceLogicCircuit(), K)


def test_keygen_matches_reference(keys):
    """The k = 12 keygen (about 2 s on the native engine) equals the JAX
    package's."""
    jpk, tpk = keys
    assert tpk.vk.to_bytes() == jpk.vk.to_bytes()
    np.testing.assert_array_equal(tpk.fixed_mont(), np.asarray(jpk.fixed_mont()).astype(np.int32))
    np.testing.assert_array_equal(tpk.sigma_mont(), np.asarray(jpk.sigma_mont()).astype(np.int32))


@pytest.mark.slow
def test_seeded_proof_equals_host_prover(statement, keys):
    """A seeded proof through the plain versions equals create_proof_host
    byte for byte, verifies under both verifiers, and its verifying info
    verifies."""
    jc, tc, _ = statement
    jpk, tpk = keys
    jinst = jc.get_public_inputs()
    orig = secrets.randbits
    secrets.randbits = random.Random(20260819).getrandbits
    try:
        want = create_proof_host(jpk, jc, jinst)
    finally:
        secrets.randbits = orig
    inst = tc.get_public_inputs()
    got = TP.create_proof(tpk, tc, inst, device="cpu", randbits=random.Random(20260819).getrandbits)
    if got != want:
        first = next(lbl for (lbl, w), (_, g) in zip(proof_items(jpk, want), proof_items(jpk, got))
                     if w != g)
        pytest.fail(f"the proofs first differ at {first}")
    assert jverify(jpk.vk, jinst, got) and verify_proof(tpk.vk, inst, got)
    info = ResourceLogicVerifyingInfo(tc.circuit_id(), Proof(got), inst, tpk.vk.to_bytes())
    assert info.verify()
