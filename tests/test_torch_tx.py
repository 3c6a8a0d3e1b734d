"""The port's transaction path (taiga_tpu_torch.core.ptx, core.transaction,
core.proving, examples) against the JAX package.

Tier 1, on the CPU: the MockProver's failure lists for the compliance
circuit at k = 13 against taiga_tpu.plonk.mock.MockProver.verify (the
reference compiles its gate checker for the class, about two minutes); one
transparent swap leg of the three-party swap, executed on the port, with
the JAX package's nullifiers, commitments, delta commitments and resource
Merkle root for the same statement, and refused when one of its logics is
tampered with; the order in which prove_resource_logics_batch proves, held
against the reference's device path with every prover call recorded
(nothing proves); and every new entry point raising without a card before
any keygen.

The `slow` tier proves one swap leg's shielded partial transaction on the
CPU through the plain versions (a compliance proof at k = 13 and four
resource-logic proofs at k = 12: tens of minutes) and holds its bytes
against create_proof_host on streams replayed in the order the port draws
them; and runs the three transparent example flows end to end.
"""

import random

import pytest
import torch

from taiga_tpu.circuits.bytecode import (
    ApplicationByteCode as JApplicationByteCode,
    ResourceLogicByteCode as JResourceLogicByteCode,
)
from taiga_tpu.core import (
    compliance as JC,
    merkle as JM,
    proving as JPR,
    resource as JR,
)
from taiga_tpu.core.ptx import TransparentPartialTransaction as JTransparentPartialTransaction
from taiga_tpu.crypto.fields import Fp as JFp
from taiga_tpu.plonk import prover as JP
from taiga_tpu_torch.apps import Token
from taiga_tpu_torch.circuits.bytecode import ApplicationByteCode
from taiga_tpu_torch.circuits.compliance import ComplianceCircuit
from taiga_tpu_torch.circuits.resource_logic import ResourceLogicCircuit
from taiga_tpu_torch.core import proving as PR
from taiga_tpu_torch.core.compliance import ComplianceInfo
from taiga_tpu_torch.core.error import InconsistentResourceMerkleRoot, InconsistentSelfResourceID
from taiga_tpu_torch.core.nullifier import NullifierKeyContainer
from taiga_tpu_torch.core.ptx import ShieldedPartialTransaction, TransparentPartialTransaction
from taiga_tpu_torch.core.resource_logics import ResourceLogics
from taiga_tpu_torch.crypto.curves import PallasPoint
from taiga_tpu_torch.crypto.fields import Fq
from taiga_tpu_torch.examples import tx_examples as X
from taiga_tpu_torch.plonk import prover as TP
from taiga_tpu_torch.plonk.mock import MockProver
from tests.test_torch_apps import build_logic, failure_lists
from tests.test_torch_compliance import _jax_compliance_info

CK = 13


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("broken", [False, True], ids=["satisfied", "broken"])
def test_compliance_mock_failures_match_reference(broken):
    """(ii) the compliance circuit at k = 13: the port's failure lists equal
    the JAX package's, on a satisfied witness (none) and on a broken one."""
    pis, circuit = ComplianceInfo.random(random.Random(5)).build()
    jpis, jcircuit = _jax_compliance_info(random.Random(5)).build()
    got, want, kinds = failure_lists(circuit, pis.to_instance(), jcircuit, jpis.to_instance(), CK,
                                     broken)
    assert got == want
    assert bool(got) == broken
    assert not broken or "lookup '" in kinds
    for kind in kinds:
        assert any(f.startswith(kind) for f in got), kind


def swap_leg(rng, mode="transparent", **kw):
    """One party's leg of the three-party swap (5 BTC for 10 ETH), as
    create_token_swap_transaction builds it."""
    auth_sk = Fq.random(rng)
    nk = NullifierKeyContainer.random_key(rng)
    return X.create_token_swap_ptx(rng, Token("btc", 5), auth_sk, nk.get_nk(), Token("eth", 10),
                                   PallasPoint.generator() * auth_sk.v, nk.get_npk(), mode, **kw)


def jax_compliance(info: ComplianceInfo):
    """The JAX package's ComplianceInfo of the same statement."""
    path = JM.MerklePath([(JM.Node(JFp(n.inner().v)), JM.LR[lr.name])
                          for n, lr in info.input_merkle_path.path])
    return JC.ComplianceInfo(JR.Resource.deserialize(info.input_resource.serialize()), path,
                             JM.Anchor(JFp(info.input_anchor.inner().v)),
                             JR.Resource.deserialize(info.output_resource.serialize()),
                             rseed=JR.RandomSeed(info.rseed.seed))


def jax_app(app: ApplicationByteCode):
    def one(bc):
        return JResourceLogicByteCode(bc.name, bc.inputs)

    return JApplicationByteCode(one(app.app_resource_logic_bytecode),
                                [one(bc) for bc in app.dynamic_resource_logic_bytecode])


@pytest.fixture(scope="module")
def leg():
    return swap_leg(random.Random(0x7E6), device="cpu")


def test_transparent_swap_leg_matches_reference(leg):
    """(iv) the leg executes on the port (its four logics mock-checked on
    the CPU); the JAX package's transparent partial transaction of the same
    statement has the same nullifier, commitment, delta commitment, anchor
    and resource Merkle root."""
    jleg = JTransparentPartialTransaction([jax_compliance(c) for c in leg.compliances],
                                          [jax_app(a) for a in leg.input_resource_app],
                                          [jax_app(a) for a in leg.output_resource_app])
    leg.execute()
    assert [n.inner().v for n in leg.get_nullifiers()] == [n.inner().v for n in jleg.get_nullifiers()]
    assert [c.inner().v for c in leg.get_output_cms()] == [c.inner().v for c in jleg.get_output_cms()]
    assert [d.to_bytes() for d in leg.get_delta_commitments()] == \
        [d.to_bytes() for d in jleg.get_delta_commitments()]
    assert [a.to_bytes() for a in leg.get_anchors()] == [a.to_bytes() for a in jleg.get_anchors()]
    assert leg.get_resource_merkle_root().v == jleg.get_resource_merkle_root().v


def _with(leg, inputs=None, outputs=None):
    return TransparentPartialTransaction(leg.compliances, inputs or leg.input_resource_app,
                                         outputs or leg.output_resource_app, device="cpu")


def test_tampered_transparent_leg_is_refused(leg):
    """(iv) refused: the input's logics bound to the output resource; the
    sender's authorization logic taken from another leg (its own resource
    tree); and a forged Schnorr signature, whose synthesis fails, as the
    JAX package's does (circuit.py's copy check at synthesis)."""
    with pytest.raises(InconsistentSelfResourceID):
        _with(leg, inputs=leg.output_resource_app).execute()
    app = leg.input_resource_app[0]
    other = swap_leg(random.Random(0x7E7), device="cpu").input_resource_app[0]
    moved = ApplicationByteCode(app.app_resource_logic_bytecode,
                                other.dynamic_resource_logic_bytecode)
    with pytest.raises(InconsistentResourceMerkleRoot):
        _with(leg, inputs=[moved]).execute()
    (auth,) = app.dynamic_resource_logic_bytecode
    forged = auth.decode()
    forged.signature.s = forged.signature.s + Fq.one()
    bad = ApplicationByteCode(app.app_resource_logic_bytecode, [forged.to_bytecode()])
    with pytest.raises(AssertionError, match="copy constraint violated at synthesis"):
        _with(leg, inputs=[bad]).execute()


# --- (v) the order of prove_resource_logics_batch ----------------------------


def _fake_class(name: str):
    class Logic:
        def __init__(self, i):
            self.i = i

        @staticmethod
        def circuit_id():
            return name

        def get_public_inputs(self):
            return [self.i]

    Logic.__name__ = name
    return Logic


class _Key:
    """A stand-in proving key: no keygen runs."""

    def __init__(self, cls):
        self.cls = cls
        self.vk = self

    def to_bytes(self):
        return self.cls.circuit_id().encode()


def _recorders(calls, randbits=None):
    """prove_resource_logic, create_proofs_pipelined and get_proving_key
    stand-ins that record each prover call as ("one", i) or ("pipeline",
    [[i, ...] a job]) and give each circuit the proof b"proof i"."""

    def prove_one(circuit, **kw):
        assert kw.get("randbits") is randbits
        calls.append(("one", circuit.i))
        return (circuit.circuit_id(), circuit.i)

    def pipelined(jobs, **kw):
        assert kw.get("randbits") is randbits
        calls.append(("pipeline", [[c.i for c in cs] for _, cs, _ in jobs]))
        return [[b"proof %d" % c.i for c in cs] for _, cs, _ in jobs]

    return prove_one, pipelined, _Key


A, B, C = (_fake_class(n) for n in "ABC")
ORDERS = {"AAB": [A, A, B], "ABAC": [A, B, A, C], "AB": [A, B], "A": [A], "AABB": [A, A, B, B]}


def _summary(out):
    return [o if isinstance(o, tuple) else (o.circuit_id, o.proof.data, o.public_inputs)
            for o in out]


@pytest.mark.parametrize("order", list(ORDERS))
def test_batch_order_follows_reference(order, monkeypatch):
    """(v) the port proves the circuits of [A, A, B] (and [A, B, A, C],
    [A, B], [A], [A, A, B, B]) in the order of the reference's device path:
    each single-circuit class at once, in order of first appearance, then
    one pipeline over the groups of two or more; every call draws from the
    caller's randbits, and each circuit gets its own verifying info."""
    classes = ORDERS[order]
    want, got = [], []
    prove_one, pipelined, key = _recorders(want)
    monkeypatch.setattr(JP, "_use_host_prover", lambda: False)
    monkeypatch.setattr(JP, "create_proofs_pipelined", pipelined)
    monkeypatch.setattr(JPR, "prove_resource_logic", prove_one)
    monkeypatch.setattr(JPR, "get_proving_key", lambda cls, k: key(cls))
    jout = JPR.prove_resource_logics_batch([cls(i) for i, cls in enumerate(classes)])

    rb = random.Random(1).getrandbits
    prove_one, pipelined, key = _recorders(got, rb)
    monkeypatch.setattr(TP, "create_proofs_pipelined", pipelined)
    monkeypatch.setattr(PR, "prove_resource_logic", prove_one)
    monkeypatch.setattr(PR, "get_proving_key", lambda cls, k: key(cls))
    out = PR.prove_resource_logics_batch([cls(i) for i, cls in enumerate(classes)],
                                         device="cpu", randbits=rb)
    assert got == want
    assert _summary(out) == _summary(jout)
    if order == "AAB":
        assert got == [("one", 2), ("pipeline", [[0, 1]])]


# --- (vi) no card --------------------------------------------------------------


def test_new_entry_points_without_a_card_raise(leg, monkeypatch):
    """(vi) each new entry point defaults to "cuda" and, without a card,
    raises before it synthesizes, keygens or proves anything."""
    trivial = build_logic("trivial", random.Random(1))
    bc = trivial.to_bytecode()
    app = ApplicationByteCode(bc, [])
    rl = ResourceLogics(trivial)
    info = ComplianceInfo.random(random.Random(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_keygen(*a, **kw):
        raise AssertionError("a keygen or a synthesis ran")

    monkeypatch.setattr(PR, "get_proving_key", no_keygen)
    monkeypatch.setattr(ResourceLogicCircuit, "synthesize", no_keygen)
    monkeypatch.setattr(ComplianceCircuit, "synthesize", no_keygen)
    root = leg.get_resource_merkle_root()
    calls = [
        lambda: MockProver.run(12, trivial, trivial.get_public_inputs()),
        lambda: PR.verify_resource_logic_transparently(trivial),
        lambda: PR.prove_resource_logic(trivial),
        lambda: bc.generate_proof(),
        lambda: bc.verify_transparently(root),
        lambda: app.generate_proofs(),
        lambda: app.verify_transparently(root),
        lambda: rl.build(),
        lambda: ShieldedPartialTransaction.build([info], [rl], [rl]),
        lambda: ShieldedPartialTransaction.from_bytecode([info], [app], [app]),
        lambda: TransparentPartialTransaction(leg.compliances, leg.input_resource_app,
                                              leg.output_resource_app),
        lambda: X.create_token_swap_transaction(random.Random(1)),
        lambda: X.create_token_swap_intent_transaction(random.Random(1)),
        lambda: X.create_partial_fulfillment_transaction(random.Random(1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- slow: a shielded swap leg, and the three transparent flows --------------


@pytest.mark.slow
def test_shielded_swap_leg_equals_host_proofs():
    """One swap leg's ShieldedPartialTransaction.build on the CPU, through
    the plain versions, on one replayed stream: the compliance proof (a
    lockstep batch of one) first, then the logics [token, signature
    verification, token, receiver] in the reference's device-path order
    (the single-circuit classes, then the two token circuits as one batch,
    their draws interleaved segment by segment). Each proof equals
    create_proof_host's on its own stream; the partial transaction executes
    (its proofs verify; its nullifier and commitment are the transparent
    leg's). A leg alone is not balanced, so no Transaction is sealed."""
    from taiga_tpu.circuits.compliance import ComplianceCircuit as JComplianceCircuit
    from tests.test_torch_apps import to_reference
    from tests.test_torch_batch import _host_proof, _interleave, _Replay, _segments, _stream

    leg = swap_leg(random.Random(0x5E6), device="cpu")
    (info,), (in_app,), (out_app,) = leg.compliances, leg.input_resource_app, leg.output_resource_app

    def logics(app):
        return ResourceLogics(app.app_resource_logic_bytecode.decode(),
                              [bc.decode() for bc in app.dynamic_resource_logic_bytecode])

    in_rl, out_rl = logics(in_app), logics(out_app)
    token_in, (auth,) = in_rl.application_resource_logic, in_rl.dynamic_resource_logics
    token_out, (receiver,) = out_rl.application_resource_logic, out_rl.dynamic_resource_logics
    rk = PR.resource_logic_k()
    cpk = PR.get_proving_key(ComplianceCircuit, CK)
    tpk, apk, rpk = (PR.get_proving_key(type(c), rk) for c in (token_in, auth, receiver))
    s_c, s_a, s_r, s_t0, s_t1 = (_stream(seed, sum(_segments(pk))) for seed, pk in
                                 ((11, cpk), (12, apk), (13, rpk), (14, tpk), (15, tpk)))
    rb = _Replay(s_c + s_a + s_r + _interleave([s_t0, s_t1], _segments(tpk)))
    ptx = ShieldedPartialTransaction.build([info], [in_rl], [out_rl], device="cpu", randbits=rb)
    assert rb.used == len(rb.values)

    jpis, jcirc = jax_compliance(info).build()
    want = {"compliance": _host_proof(JPR.get_proving_key(JComplianceCircuit, CK), jcirc,
                                      jpis.to_instance(), s_c)}
    for name, circuit, stream in (("token in", token_in, s_t0), ("auth", auth, s_a),
                                  ("token out", token_out, s_t1), ("receiver", receiver, s_r)):
        jc = to_reference(circuit)
        want[name] = _host_proof(JPR.get_proving_key(type(jc), rk), jc, jc.get_public_inputs(),
                                 stream)
    (cvi,), (ins,), (outs,) = ptx.compliances, ptx.inputs, ptx.outputs
    got = {"compliance": cvi.compliance_proof.data,
           "token in": ins.app_resource_logic_verifying_info.proof.data,
           "auth": ins.app_dynamic_resource_logic_verifying_info[0].proof.data,
           "token out": outs.app_resource_logic_verifying_info.proof.data,
           "receiver": outs.app_dynamic_resource_logic_verifying_info[0].proof.data}
    assert [k for k in want if got[k] != want[k]] == []
    ptx.execute()
    assert [n.inner().v for n in ptx.get_nullifiers()] == [n.inner().v for n in leg.get_nullifiers()]
    assert [c.inner().v for c in ptx.get_output_cms()] == [c.inner().v for c in leg.get_output_cms()]


@pytest.mark.slow
@pytest.mark.parametrize("flow, n_nf", [
    (X.create_token_swap_transaction, 3),
    (X.create_token_swap_intent_transaction, 3),
    (X.create_partial_fulfillment_transaction, 4),
], ids=["three_party_swap", "intent_swap", "partial_fulfillment"])
def test_transparent_flow_end_to_end(flow, n_nf):
    """Each example flow in transparent mode on the CPU: every logic is
    mock-checked, the binding signature verifies."""
    result = flow(random.Random(0xE2E), mode="transparent", device="cpu").execute()
    assert len(result.nullifiers) == len(result.output_cms) == n_nf
