"""The port's application resource logics (taiga_tpu_torch.apps), its
MockProver (plonk/mock.py, over expression.eval_device) and its RedDSA
(crypto/reddsa.py) against the JAX package, exact equality.

Each statement is built on the port from a seeded rng, as
tests/test_apps.py builds it, and carried across by the circuit's
serialization (its bytecode inputs) and, for the per-instance padding of
public inputs 6..21, by its seed. Tier 1 holds, for each of the six logics,
the compressed verifying key (a keygen at k = 12 in each package), the 22
public inputs, a prove-mode synthesis (advice and fixed columns, copies),
and the port's MockProver accepting it on the CPU; then the MockProver's
failure lists, on a satisfied and on a broken witness, against
taiga_tpu.plonk.mock.MockProver.verify for the trivial and the token logic
(the reference compiles its gate checker once a class, about two minutes
on the CPU: tests/test_torch_tx.py holds the compliance circuit the same
way); and the binding signature's sign and verify under fixed nonce bytes.
"""

import random

import numpy as np
import pytest
import torch

from taiga_tpu.apps import (
    FieldAdditionResourceLogicCircuit as JFieldAddition,
    OrRelationIntentResourceLogicCircuit as JOrRelation,
    PartialFulfillmentIntentResourceLogicCircuit as JPartialFulfillment,
    ReceiverResourceLogicCircuit as JReceiver,
    SignatureVerificationResourceLogicCircuit as JSignatureVerification,
    TokenResourceLogicCircuit as JToken,
    TrivialResourceLogicCircuit as JTrivial,
)
from taiga_tpu.core.resource import RandomSeed as JRandomSeed
from taiga_tpu.crypto.curves import PallasPoint as JPallasPoint
from taiga_tpu.crypto.fields import Fq as JFq
from taiga_tpu.crypto.reddsa import (
    BindingSignature as JBindingSignature,
    BindingSigningKey as JBindingSigningKey,
)
from taiga_tpu.plonk.circuit import CircuitBuilder as JBuilder
from taiga_tpu.plonk.mock import MockProver as JMockProver
from taiga_tpu_torch.apps import (
    FieldAdditionResourceLogicCircuit,
    OrRelationIntentResourceLogicCircuit,
    PartialFulfillmentIntentResourceLogicCircuit,
    ReceiverResourceLogicCircuit,
    SignatureVerificationResourceLogicCircuit,
    Swap,
    Token,
    TokenAuthorization,
    TokenResourceLogicCircuit,
    TrivialResourceLogicCircuit,
)
from taiga_tpu_torch.apps.or_relation_intent import create_intent_resource
from taiga_tpu_torch.apps.receiver import compressed_receiver_vk
from taiga_tpu_torch.apps.signature_verification import compressed_token_auth_vk
from taiga_tpu_torch.apps.token import compressed_token_vk
from taiga_tpu_torch.circuits.bytecode import circuit_class_by_name
from taiga_tpu_torch.core.constants import RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE
from taiga_tpu_torch.core.resource import RandomSeed, Resource
from taiga_tpu_torch.core.resource_tree import ResourceExistenceWitness, ResourceMerkleTreeLeaves
from taiga_tpu_torch.crypto.curves import PallasPoint
from taiga_tpu_torch.crypto.fields import Fp, Fq
from taiga_tpu_torch.crypto.reddsa import BindingSignature, BindingSigningKey
from taiga_tpu_torch.plonk.circuit import CircuitBuilder
from taiga_tpu_torch.plonk.expression import ADVICE, Cell, eval_host
from taiga_tpu_torch.plonk.mock import MockProver

K = RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE
P = Fp.MODULUS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _witness(resource, is_input: bool, rng):
    """The resource in a resource tree of four leaves: its nullifier at
    leaf 0 (an input) or its commitment at leaf 1 (an output)."""
    ident = resource.get_nf().inner() if is_input else resource.commitment().inner()
    leaves = [ident if i == (0 if is_input else 1) else Fp.random(rng) for i in range(4)]
    return ResourceExistenceWitness(resource, ResourceMerkleTreeLeaves(leaves).generate_path(ident))


def build_logic(name: str, rng):
    """The port's circuit of logic `name` on a statement drawn from `rng`
    (tests/test_apps.py's statements)."""
    if name == "trivial":
        return TrivialResourceLogicCircuit(_witness(Resource.random(rng), True, rng))
    if name == "field_addition":
        return FieldAdditionResourceLogicCircuit(_witness(Resource.random(rng), True, rng),
                                                 Fp(3), Fp(39))
    auth, sk = TokenAuthorization.random(rng)
    if name in ("token", "signature_verification"):
        tr = Token("BTC", 5).create_random_input_token_resource(rng, Fp.random(rng), auth)
        w = _witness(tr.resource, True, rng)
        if name == "token":
            return TokenResourceLogicCircuit(w, tr.token_name, auth, compressed_receiver_vk(),
                                             RandomSeed.random(rng))
        return SignatureVerificationResourceLogicCircuit.from_sk_and_sign(
            w, auth.vk, sk, compressed_receiver_vk(), rng)
    if name == "receiver":
        tr = Token("DOGE", 7).create_random_output_token_resource(rng, Fp.random(rng), auth)
        return ReceiverResourceLogicCircuit(_witness(tr.resource, False, rng),
                                            compressed_receiver_vk(), Fp.random(rng),
                                            Fp.random(rng), auth.pk, compressed_token_auth_vk())
    if name == "or_relation_intent":
        t1, t2 = Token("DOLPHIN", 1), Token("Monkey", 2)
        receiver_npk, receiver_value = Fp.random(rng), auth.to_value()
        intent = create_intent_resource(rng, t1, t2, receiver_npk, receiver_value, Fp.random(rng))
        desired = Resource.new_output_resource(compressed_token_vk(), t2.encode_name(),
                                               receiver_value, 2, receiver_npk, False,
                                               Fp.random(rng))
        desired.set_nonce(intent)
        nf, cm = intent.get_nf().inner(), desired.commitment().inner()
        tree = ResourceMerkleTreeLeaves([nf, cm, Fp.random(rng), Fp.random(rng)])
        return OrRelationIntentResourceLogicCircuit(
            ResourceExistenceWitness(intent, tree.generate_path(nf)),
            ResourceExistenceWitness(desired, tree.generate_path(cm)),
            t1, t2, receiver_npk, receiver_value)
    assert name == "partial_fulfillment_intent"
    swap = Swap.random(rng, Token("BTC", 2), Token("ETH", 10), auth)
    intent = swap.create_intent_resource(rng)
    offer, returned = swap.fill(rng, Token("ETH", 5))
    offer.set_nonce(intent)
    returned.set_nonce(intent)
    nf, cm_offer, cm_ret = (intent.get_nf().inner(), offer.commitment().inner(),
                            returned.commitment().inner())
    tree = ResourceMerkleTreeLeaves([nf, cm_offer, Fp.random(rng), cm_ret])
    return PartialFulfillmentIntentResourceLogicCircuit(
        ResourceExistenceWitness(intent, tree.generate_path(nf)),
        ResourceExistenceWitness(swap.sell.resource, tree.generate_path(nf)),
        ResourceExistenceWitness(offer, tree.generate_path(cm_offer)),
        ResourceExistenceWitness(returned, tree.generate_path(cm_ret)),
        swap)


JCLASSES = {
    "trivial": JTrivial,
    "field_addition": JFieldAddition,
    "token": JToken,
    "signature_verification": JSignatureVerification,
    "receiver": JReceiver,
    "or_relation_intent": JOrRelation,
    "partial_fulfillment_intent": JPartialFulfillment,
}
APPS = ("field_addition", "signature_verification", "receiver", "token",
        "or_relation_intent", "partial_fulfillment_intent")


def to_reference(tc):
    """The JAX package's circuit of the port's `tc`: decoded from the same
    bytecode inputs, with the same padding seed."""
    bc = tc.to_bytecode()
    jc = {cls.REPRESENTATION: cls for cls in JCLASSES.values()}[bc.name].from_bytes(bc.inputs)
    jc._padding_seed = JRandomSeed(tc._padding_seed.seed)
    return jc


def test_eval_device_matches_reference():
    """expression.eval_device on random tables of 16 rows (rotations both
    ways, constants, a challenge, every node kind) equals the JAX package's
    eval_device (run eagerly) limb for limb; without the challenge, it
    equals eval_host's exact integers row by row."""
    import jax.numpy as jnp

    from taiga_tpu.ops import limbs as JL
    from taiga_tpu.plonk import expression as JE
    from taiga_tpu_torch.ops import limbs as L
    from taiga_tpu_torch.plonk import expression as E

    n, rng = 16, random.Random(0xE7A1)
    kinds = (E.FIXED, E.ADVICE, E.INSTANCE)
    vals = {kind: [[rng.randrange(P) for _ in range(n)] for _ in range(c)]
            for kind, c in zip(kinds, (3, 4, 1))}
    beta = rng.randrange(P)

    def build(X, challenge: bool):
        f, a = (lambda j, r=0: X.Cell(X.FIXED, j, r)), (lambda j, r=0: X.Cell(X.ADVICE, j, r))
        e = (f(0) * (a(1, 1) - a(2) * a(3, -1)) + X.Constant(5) * a(0)
             - X.Cell(X.INSTANCE, 0) * f(2, 2) - X.Constant(P - 1))
        return e + X.ChallengeVar("beta") * (a(3) + f(1, -3)) if challenge else e

    mont = [L.FP.array_to_mont([v for col in vals[k] for v in col]).reshape(-1, n, 16)
            for k in kinds]
    ts = E.TableSet(*(torch.as_tensor(m) for m in mont))
    jts = JE.TableSet(*(jnp.asarray(m.astype(np.uint32)) for m in mont))
    got = E.eval_device(build(E, True), ts, {"beta": torch.as_tensor(L.FP.to_mont_host(beta))})
    want = JE.eval_device(build(JE, True), jts, {"beta": jnp.asarray(JL.FP.to_mont_host(beta))})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    plain = L.FP.array_from_mont(E.eval_device(build(E, False), ts))
    assert plain == [E.eval_host(build(E, False), r, n, *(vals[k] for k in kinds))
                     for r in range(n)]


def synthesize(circuit, builder_cls, k):
    cs, config = type(circuit).build_cs()
    b = builder_cls(cs, k, "prove")
    circuit.synthesize(b, config)
    return b


@pytest.fixture(scope="module")
def logics():
    """name -> (port circuit, reference circuit), each from its own seed."""
    out = {}
    for i, name in enumerate(("trivial",) + APPS):
        tc = build_logic(name, random.Random(0xA995 + i))
        out[name] = (tc, to_reference(tc))
    return out


@pytest.mark.parametrize("name", APPS)
def test_app_matches_reference_and_mock_accepts(logics, name):
    """(i) the compressed verifying key, the public inputs and the
    prove-mode synthesis equal the JAX package's; the port's MockProver
    accepts the witness on the CPU; the bytecode decodes to the same
    statement (its padding seed aside, which the bytecode does not carry)."""
    tc, jc = logics[name]
    cls = type(tc)
    assert circuit_class_by_name(cls.REPRESENTATION) is cls
    assert cls.compressed_vk().v == JCLASSES[name].compressed_vk().v
    pub = [v.v for v in tc.get_public_inputs()]
    assert pub == [v.v for v in jc.get_public_inputs()]
    got, want = synthesize(tc, CircuitBuilder, K), synthesize(jc, JBuilder, K)
    assert got.rows_used() == want.rows_used()
    assert got.advice == want.advice
    assert got.fixed == want.fixed
    assert got.copies == want.copies
    assert MockProver.run(K, tc, tc.get_public_inputs(), device="cpu").verify() == []
    back = tc.to_bytecode().decode()
    back._padding_seed = tc._padding_seed
    assert [v.v for v in back.get_public_inputs()] == pub


def _advice_cells(expr, acc):
    if isinstance(expr, Cell):
        if expr.kind == ADVICE:
            acc.append((expr.index, expr.rotation))
    for child in (getattr(expr, "a", None), getattr(expr, "b", None)):
        if child is not None:
            _advice_cells(child, acc)
    return acc


def damage(mp):
    """Where to break a witness, found on the port's MockProver: the first
    advice cell of a copy and, where a lookup reads a nonzero input (the
    token and compliance circuits; the trivial logic has none), the advice
    cells that the first such lookup reads at its first such row. Returns
    the cells and whether a lookup was hit."""
    b = mp.builder
    (_, col, row), _ = next(c for c in b.copies if c[0][0] == ADVICE)
    cells = [(col, row)]
    for lk in b.cs.lookups:
        r = next((r for r in range(b.usable_rows)
                  if any(eval_host(inp, r, mp.n, b.fixed, b.advice, [mp.instance])
                         for inp, _ in lk.pairs)), None)
        if r is not None:
            cells += [(c, (r + rot) % mp.n) for inp, _ in lk.pairs
                      for c, rot in _advice_cells(inp, [])]
            return cells, True
    return cells, False


def break_witness(mp, cells):
    """The same damage to either package's MockProver: each advice cell of
    `cells` set to a value outside every table, and the first public input
    moved by one."""
    b = mp.builder
    for col, row in cells:
        b.advice[col][row] = (b.advice[col][row] + P - 2) % P
    mp.instance[0] = (mp.instance[0] + 1) % P


def failure_lists(tc, inst, jc, jinst, k: int, broken: bool):
    """The port's MockProver.verify on the CPU and the JAX package's, on one
    statement, and the kinds of failure the damage must show."""
    mp = MockProver.run(k, tc, inst, device="cpu")
    jmp = JMockProver.run(k, jc, jinst)
    kinds = []
    if broken:
        cells, lookup = damage(mp)
        break_witness(mp, cells)
        break_witness(jmp, cells)
        kinds = ["gate '", "copy mismatch"] + (["lookup '"] if lookup else [])
    return mp.verify(), jmp.verify(), kinds


@pytest.mark.parametrize("broken", [False, True], ids=["satisfied", "broken"])
@pytest.mark.parametrize("name", ["trivial", "token"])
def test_mock_failures_match_reference(logics, name, broken):
    """(ii) the failure lists equal the JAX package's, string for string,
    in order: empty on the satisfied witness; gate and copy failures on the
    broken one, and lookup failures where it reads a lookup."""
    tc, jc = logics[name]
    got, want, kinds = failure_lists(tc, tc.get_public_inputs(), jc, jc.get_public_inputs(), K,
                                     broken)
    assert got == want
    assert bool(got) == broken
    for kind in kinds:
        assert any(f.startswith(kind) for f in got), kind


def test_reddsa_matches_reference():
    """(iii) the binding signature under fixed nonce bytes equals the JAX
    package's, byte for byte, and both packages verify it; a changed
    message and a changed key are refused."""
    rng = random.Random(0x5EED)
    base, jbase = PallasPoint.generator() * 7, JPallasPoint.generator() * 7
    for _ in range(3):
        sk = Fq.random(rng)
        msg, t = rng.randbytes(32), rng.randbytes(80)
        key, jkey = BindingSigningKey(sk, base), JBindingSigningKey(JFq(sk.v), jbase)
        sig, jsig = key.sign(msg, rng_bytes=t), jkey.sign(msg, rng_bytes=t)
        assert sig.to_bytes() == jsig.to_bytes()
        assert key.get_vk().to_bytes() == jkey.get_vk().to_bytes()
        back = BindingSignature.from_bytes(jsig.to_bytes())
        assert key.get_vk().verify(base, msg, back)
        assert jkey.get_vk().verify(jbase, msg, JBindingSignature.from_bytes(sig.to_bytes()))
        assert not key.get_vk().verify(base, msg + b"\x00", back)
        other = BindingSigningKey(sk + Fq.one(), base).get_vk()
        assert not other.verify(base, msg, back)
