"""The port's Vamp-IR resource logic (taiga_tpu_torch.circuits.vamp_ir)
against the JAX package, at K = 7 on the CPU: the port's counterparts of
tests/test_vamp_ir.py (parse, mock prover, bad and missing witnesses,
malformed source, the arithmetic subset, prove and verify, the bytecode
round trip), and exact equality with the JAX package on the compiled
module, the keygen's verifying key and a seeded proof (the method of
tools/prover_diff.py: both circuits carry one padding seed, the port draws
from a seeded randbits and create_proof_host from the same seed). The one
proof of the file (about 40 s through the plain versions on one thread)
serves the prove-and-verify test and the byte-for-byte one. Last, the
"vamp_ir" arm of the bytecode registry decodes in a fresh process that
imports only taiga_tpu_torch.service."""

import random
import secrets
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from taiga_tpu.circuits import vamp_ir as JV
from taiga_tpu.plonk.host_prover import create_proof_host
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu.plonk.verifier import verify_proof as jverify
from taiga_tpu_torch.circuits.bytecode import ResourceLogicByteCode, circuit_class_by_name
from taiga_tpu_torch.circuits.vamp_ir import (
    MissingAssignment,
    SourceParsingError,
    VampIRResourceLogicCircuit,
    compile_module,
)
from taiga_tpu_torch.core.resource import RandomSeed
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.plonk.keygen import keygen
from taiga_tpu_torch.plonk.mock import MockProver
from taiga_tpu_torch.plonk.prover import create_proof
from taiga_tpu_torch.plonk.verifier import verify_proof
from tools.prover_diff import proof_items

K = 7
ROOT = Path(__file__).resolve().parents[1]

PYTH = """
// declare R to be public
pub R;

// define the Pythagorean relation we are checking
def pyth a b c = {
  a^2 + b^2 = c^2
};

// appends constraint x^2 + y^2 = R^2 to the circuit
pyth x y R;
"""

ARITH = """
pub out;
def double x = 2 * x;
def dec x = x - 1;
out = double (dec a) + b / c;
"""

PYTH_WITNESS = {"x": 15, "y": 20, "R": 25}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mock(circuit) -> MockProver:
    return MockProver.run(K, circuit, circuit.get_public_inputs(), device="cpu")


def _rejected(circuit) -> bool:
    """A bad witness is rejected either fail-fast at synthesis (the builder
    asserts on violated copy constraints in prove mode) or by MockProver."""
    try:
        mp = _mock(circuit)
    except AssertionError:
        return True
    return mp.verify() != []


# --- the port's counterparts of tests/test_vamp_ir.py --------------------------


def test_parse_pyth_module():
    m = compile_module(PYTH)
    assert m.pubs == ["R"]
    assert sorted(m.variables) == ["R", "x", "y"]
    assert len(m.constraints) == 1
    assert m.eval_host(m.constraints[0][0], {"x": 3, "y": 4}) == 25
    assert m.eval_host(m.constraints[0][1], {"R": 5}) == 25


def test_pyth_mock_prover_ok_and_bad():
    cls = VampIRResourceLogicCircuit.for_source(PYTH)
    assert _mock(cls(PYTH_WITNESS)).verify() == []
    assert _rejected(cls({"x": 1, "y": 20, "R": 25}))


def test_missing_assignment_rejected():
    cls = VampIRResourceLogicCircuit.for_source(PYTH)
    with pytest.raises(MissingAssignment):
        cls({"x": 15, "y": 20})


def test_malformed_source_rejected():
    with pytest.raises(SourceParsingError):
        compile_module("def broken = ;")
    with pytest.raises(SourceParsingError):
        compile_module("undefined_fn x y;")


def test_arithmetic_subset():
    cls = VampIRResourceLogicCircuit.for_source(ARITH)
    # a=4, b=9, c=3 -> 2*(4-1) + 3 = 9
    assert _mock(cls({"a": 4, "b": 9, "c": 3, "out": 9})).verify() == []
    assert _rejected(cls({"a": 4, "b": 9, "c": 3, "out": 8}))
    # division by zero denominator is rejected at witness time
    with pytest.raises(Exception):
        _mock(cls({"a": 4, "b": 9, "c": 0, "out": 9}))


@pytest.fixture(scope="module")
def seeded():
    """The pyth logic at K = 7 in both packages: the keys, the circuits
    (one padding seed), and one seeded proof from each prover."""
    cls, jcls = (VampIRResourceLogicCircuit.for_source(PYTH), JV.VampIRResourceLogicCircuit.for_source(PYTH))
    pk, jpk = keygen(cls(), K), jkeygen(jcls(), K)
    jc = jcls(PYTH_WITNESS)
    c = cls(PYTH_WITNESS)
    c._padding_seed = RandomSeed(jc._padding_seed.seed)
    orig = secrets.randbits
    secrets.randbits = random.Random(20261017).getrandbits
    try:
        want = create_proof_host(jpk, jc, jc.get_public_inputs())
    finally:
        secrets.randbits = orig
    got = create_proof(pk, c, c.get_public_inputs(), device="cpu",
                       randbits=random.Random(20261017).getrandbits)
    return pk, jpk, c, jc, got, want


def test_pyth_real_prove_verify(seeded):
    pk, _, c, _, proof, _ = seeded
    inst = c.get_public_inputs()
    assert verify_proof(pk.vk, inst, proof)
    # tampered public input fails
    bad = list(inst)
    bad[0] = Fp(bad[0].v + 1)
    assert not verify_proof(pk.vk, bad, proof)


def test_bytecode_roundtrip():
    cls = VampIRResourceLogicCircuit.for_source(PYTH)
    circ = cls(PYTH_WITNESS)
    data = circ.to_bytes()
    back = VampIRResourceLogicCircuit.from_bytes(data)
    assert type(back).MODULE.digest == type(circ).MODULE.digest
    assert back.assignments == circ.assignments
    assert back.get_public_inputs()[0] == Fp(25)


# --- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("source", [PYTH, ARITH], ids=["pyth", "arithmetic"])
def test_compiled_module_matches_reference(source):
    """pubs, variables, the inlined constraint trees (the AST classes carry
    the JAX package's names and fields, so their reprs compare), the digest
    and the circuit id."""
    m, jm = compile_module(source), JV.compile_module(source)
    assert m.pubs == jm.pubs
    assert m.variables == jm.variables
    assert repr(m.constraints) == repr(jm.constraints)
    assert m.digest == jm.digest
    cls, jcls = VampIRResourceLogicCircuit.for_source(source), JV.VampIRResourceLogicCircuit.for_source(source)
    assert cls.circuit_id() == jcls.circuit_id() == f"taiga_tpu.rl.vamp_ir.{m.digest}"
    assert cls.__qualname__ == jcls.__qualname__


def test_keygen_matches_reference(seeded):
    pk, jpk, c, jc, _, _ = seeded
    assert pk.vk.to_bytes() == jpk.vk.to_bytes()
    assert [v.v for v in c.get_public_inputs()] == [v.v for v in jc.get_public_inputs()]


def test_seeded_proof_equals_host_prover(seeded):
    pk, jpk, c, jc, got, want = seeded
    if got != want:
        first = next(lbl for (lbl, w), (_, g) in zip(proof_items(jpk, want), proof_items(jpk, got))
                     if w != g)
        pytest.fail(f"the proofs first differ at {first}")
    assert jverify(jpk.vk, jc.get_public_inputs(), got)


def test_bytecode_decodes_in_the_port():
    circ = VampIRResourceLogicCircuit.for_source(PYTH)(PYTH_WITNESS)
    bc = ResourceLogicByteCode("vamp_ir", circ.to_bytes())
    back = bc.decode()
    assert type(back) is type(circ)
    assert back.assignments == circ.assignments
    assert circuit_class_by_name("vamp_ir") is VampIRResourceLogicCircuit


def test_vamp_ir_arm_decodes_in_a_fresh_service_process():
    """The JAX package registers the arm only where a caller imports its
    vamp_ir module; the port's registry imports it on a miss, so a service
    process (which imports nothing else) decodes the bytecode."""
    data = VampIRResourceLogicCircuit.for_source(PYTH)(PYTH_WITNESS).to_bytes()
    code = (
        "import sys\n"
        "import taiga_tpu_torch.service\n"
        "from taiga_tpu_torch.circuits.bytecode import ResourceLogicByteCode\n"
        "assert 'taiga_tpu_torch.circuits.vamp_ir' not in sys.modules\n"
        f"c = ResourceLogicByteCode('vamp_ir', {data!r}).decode()\n"
        "print(type(c).circuit_id(), c.get_public_inputs()[0].v)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert out == [VampIRResourceLogicCircuit.for_source(PYTH).circuit_id(), "25"]
