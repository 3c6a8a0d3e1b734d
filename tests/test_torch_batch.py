"""The port's lockstep batch and cross-batch pipeline
(taiga_tpu_torch.plonk.prover.create_proofs_batch / create_proofs_pipelined)
against the JAX package's host prover, on the CPU through the plain
versions. Every comparison is exact: proof bytes.

A batch draws its blinds stage by stage, and proof by proof within a stage;
its phase 2 (the multiopen's h blinds, then each proof's IPA open) is drawn
on the calling thread. So a batch of B proofs equals B single proofs when
its randbits replays their recorded streams interleaved segment by segment
(_segments), and the pipeline equals the batch called chunk by chunk.

Sizes: tests/test_lookup.py's ByteRangeCircuit (two lookups, one
theta-compressed) with a 16-entry table at k = 5 (NibbleRange), and
tests/test_plonk.py's FibCircuit at k = 5 (no lookups); the second
statement of a batch is the first's values reversed, which have the same
sum and so the same instance. The draw-order test also runs on
ByteRangeCircuit itself at k = 9, in the `slow` tier: a ByteRange proof at
k = 9 takes about 90 s on the CPU, a B = 2 batch about 190 s."""

import random
import secrets
import threading

import pytest
import torch

import taiga_tpu_torch as T
from taiga_tpu.crypto.fields import Fp as JFp
from taiga_tpu.plonk import verifier as JV
from taiga_tpu.plonk.circuit import Circuit as JCircuit
from taiga_tpu.plonk.host_prover import create_proof_host
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu_torch.core.compliance import ComplianceInfo
from taiga_tpu_torch.core.proving import prove_resource_logics_batch
from taiga_tpu_torch.core.ptx import ComplianceVerifyingInfo
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.parallel.dryrun import FibCircuit
from taiga_tpu_torch.plonk import keygen as TK, prover as TP, verifier as TV
from taiga_tpu_torch.plonk.circuit import Circuit
from taiga_tpu_torch.plonk.protocol import NUM_H_PIECES, num_chunks
from tests.test_lookup import INST, VALUES, ByteRangeCircuit as JByteRangeCircuit
from tests.test_plonk import FibCircuit as JFibCircuit, _expected_out
from tests.test_torch_prover import ByteRangeCircuit, _assert_same_proof

SEEDS = (20260819, 1717)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _range_circuit(base, table: int):
    """ByteRangeCircuit (tests/test_lookup.py) with a table of `table`
    entries, on either package's Circuit."""

    class RangeCircuit(base):
        NUM_FIXED = 4
        NUM_ADVICE = 3
        NUM_INSTANCE = 1
        NUM_VALUES = 8

        def __init__(self, values=None):
            self.values = values

        @classmethod
        def configure(cls, cs):
            q, t_v, t_lo, t_hi = (cs.fixed(i) for i in range(4))
            v, v2, s = (cs.advice(i) for i in range(3))
            cs.lookup("byte", [(q * v, t_v)])
            cs.lookup("double", [(q * v, t_lo), (q * v2, t_hi)])
            cs.create_gate("sum", q * (s.at(1) - s - v))
            return None

        def synthesize(self, builder, config):
            for i in range(table):
                builder.assign_fixed(1, i, i)
                builder.assign_fixed(2, i, i)
                builder.assign_fixed(3, i, (2 * i) % table)
            vals = self.values if self.values is not None else [None] * self.NUM_VALUES
            assert builder.alloc_rows(max(table, self.NUM_VALUES + 1)) == 0
            acc = 0 if self.values is not None else None
            first = s_cell = builder.assign_advice(2, 0, acc)
            for r, val in enumerate(vals):
                builder.assign_fixed(0, r, 1)
                builder.assign_advice(0, r, val)
                builder.assign_advice(1, r, None if val is None else (2 * val) % table)
                if acc is not None and val is not None:
                    acc += val
                s_cell = builder.assign_advice(2, r + 1, acc)
            builder.constrain_instance(first, 0)
            builder.constrain_instance(s_cell, 1)

    return RangeCircuit


JNibble, TNibble = _range_circuit(JCircuit, 16), _range_circuit(Circuit, 16)
NIBBLES = [0, 1, 7, 15, 8, 4, 4, 12]
NIB_INST = [0, sum(NIBBLES)]


FIB_INST = [3, 4, _expected_out(3, 4).v]


def _segments(pk) -> list[int]:
    """The draws of one proof, stage by stage, in the order a batch takes
    them: witness fillers, advice blinds, lookup rows, A' blinds, S'
    blinds, z rows, z blinds, lookup-z rows, lookup-z blinds, h blinds;
    then phase 2: the multiopen's h blind and the IPA open's draws."""
    vk = pk.vk
    n, u, k = vk.n, vk.usable_rows, vk.k
    a, nlk, nz = vk.cs.num_advice, len(vk.cs.lookups), num_chunks(vk.perm_cols)
    return [a * (n - u), a, 2 * nlk * (n - u), nlk, nlk, nz * (n - u - 1), nz,
            nlk * (n - u - 1), nlk, NUM_H_PIECES, 1, n + 2 * k]


def _stream(seed: int, count: int) -> list[int]:
    rng = random.Random(seed)
    return [rng.getrandbits(300) for _ in range(count)]


def _interleave(streams, segments) -> list[int]:
    out, offs = [], [0] * len(streams)
    for size in segments:
        for i, s in enumerate(streams):
            out += s[offs[i] : offs[i] + size]
            offs[i] += size
    assert offs == [len(s) for s in streams]
    return out


class _Replay:
    """randbits(300) over a recorded stream; records the threads it was
    called on and how much it gave."""

    def __init__(self, values):
        self.values, self.used, self.threads = values, 0, set()

    def __call__(self, nbits: int) -> int:
        assert nbits == 300
        self.threads.add(threading.get_ident())
        self.used += 1
        return self.values[self.used - 1]


def _host_proof(jpk, circuit, inst, values) -> bytes:
    """create_proof_host on a recorded stream, which it must use up."""
    rb = _Replay(values)
    orig = secrets.randbits
    secrets.randbits = rb
    try:
        proof = create_proof_host(jpk, circuit, inst)
    finally:
        secrets.randbits = orig
    assert rb.used == len(values)
    return proof


def _verifies(jpk, tpk, inst, proofs):
    """Each proof verifies under both packages' verify_proof, and all of
    them under both packages' BatchVerifier."""
    jinst = [JFp(v) for v in inst]
    tinst = [Fp(v) for v in inst]
    for p in proofs:
        assert TV.verify_proof(tpk.vk, tinst, p)
        assert JV.verify_proof(jpk.vk, jinst, p)
    for V, vk, ins in ((TV, tpk.vk, tinst), (JV, jpk.vk, jinst)):
        bv = V.BatchVerifier()
        for p in proofs:
            bv.add(vk, ins, p)
        assert bv.finalize()


@pytest.fixture(scope="module")
def nibble():
    """NibbleRange at k = 5: both packages' keys, the two seeds' streams and
    the host prover's proofs of NIBBLES and NIBBLES reversed on them."""
    jpk, tpk = jkeygen(JNibble(), 5), TK.keygen(TNibble(), 5)
    assert tpk.vk.to_bytes() == jpk.vk.to_bytes()
    streams = [_stream(s, sum(_segments(tpk))) for s in SEEDS]
    jinst = [JFp(v) for v in NIB_INST]
    host = [_host_proof(jpk, JNibble(vals), jinst, s)
            for vals, s in zip((NIBBLES, NIBBLES[::-1]), streams)]
    return jpk, tpk, streams, host


def _nib_circuits():
    return [TNibble(NIBBLES), TNibble(NIBBLES[::-1])], [[Fp(v) for v in NIB_INST]] * 2


def test_batch_of_one_equals_the_single_proof(nibble):
    """(a) a B = 1 batch equals create_proof_host and the port's
    create_proof under the same stream."""
    jpk, tpk, streams, host = nibble
    circuits, insts = _nib_circuits()
    got = TP.create_proofs_batch(tpk, circuits[:1], insts[:1], device="cpu",
                                 randbits=_Replay(streams[0]))
    _assert_same_proof(jpk, got[0], host[0])
    single = TP.create_proof(tpk, circuits[0], insts[0], device="cpu",
                             randbits=_Replay(streams[0]))
    assert single == host[0]


@pytest.mark.parametrize("circuit", [
    "nibble",
    pytest.param("byte", marks=pytest.mark.slow),  # a B = 2 batch at k = 9: ~190 s here
])
def test_batch_draws_in_the_reference_order(circuit):
    """(b) B = 2, NibbleRange at k = 5 and ByteRangeCircuit at k = 9: on
    the two single-proof streams interleaved segment by segment, each proof
    equals create_proof_host on its own stream, and they verify under both
    packages' verifiers."""
    if circuit == "byte":
        k, jcls, tcls, vals, inst = 9, JByteRangeCircuit, ByteRangeCircuit, VALUES, INST
    else:
        k, jcls, tcls, vals, inst = 5, JNibble, TNibble, NIBBLES, [JFp(v) for v in NIB_INST]
    jpk, tpk = jkeygen(jcls(), k), TK.keygen(tcls(), k)
    segs = _segments(tpk)
    streams = [_stream(s, sum(segs)) for s in SEEDS]
    host = [_host_proof(jpk, jcls(v), inst, s) for v, s in zip((vals, vals[::-1]), streams)]
    tinst = [Fp(v.v) for v in inst]
    rb = _Replay(_interleave(streams, segs))
    got = TP.create_proofs_batch(tpk, [tcls(vals), tcls(vals[::-1])], [tinst, tinst],
                                 device="cpu", randbits=rb)
    assert rb.used == len(rb.values)
    for g, h in zip(got, host):
        _assert_same_proof(jpk, g, h)
    _verifies(jpk, tpk, [v.v for v in inst], got)


def test_pipeline_of_batches_of_one_equals_the_single_proofs(nibble):
    """(c) create_proofs_pipelined with chunk=1 on the two streams one
    after the other: each proof equals its host proof, and every value
    was drawn on the calling thread."""
    jpk, tpk, streams, host = nibble
    circuits, insts = _nib_circuits()
    rb = _Replay(streams[0] + streams[1])
    (got,) = TP.create_proofs_pipelined([(tpk, circuits, insts)], chunk=1, device="cpu",
                                        randbits=rb)
    assert got == host
    assert rb.used == len(rb.values) and rb.threads == {threading.get_ident()}


def test_pipeline_of_two_keys_equals_the_batches_job_by_job(nibble):
    """(d) two keys, the second without lookups (its z commit has no lookup
    columns): pipelined jobs [(NibbleRange, 2), (Fib, 1)] with chunk 2
    equal create_proofs_batch called job by job on the same stream, in job
    order; the first job equals the host proofs on the interleaved streams,
    the Fib proof verifies under both packages."""
    jpk, tpk, streams, host = nibble
    jfib, tfib = jkeygen(JFibCircuit(), 5), TK.keygen(FibCircuit(), 5)
    assert tfib.vk.to_bytes() == jfib.vk.to_bytes()
    circuits, insts = _nib_circuits()
    fib_inst = [Fp(v) for v in FIB_INST]
    values = _interleave(streams, _segments(tpk)) + _stream(7, sum(_segments(tfib)))
    jobs = [(tpk, circuits, insts), (tfib, [FibCircuit(3, 4)], [fib_inst])]
    got = TP.create_proofs_pipelined(jobs, chunk=2, device="cpu", randbits=_Replay(values))
    rb = _Replay(values)
    want = [TP.create_proofs_batch(pk, cs, ins, device="cpu", randbits=rb) for pk, cs, ins in jobs]
    assert rb.used == len(values)
    assert got == want
    assert got[0] == host
    _verifies(jfib, tfib, FIB_INST, got[1])


def test_out_of_table_witness_in_a_batch_is_refused(nibble):
    """(e) a value outside the table in proof 1 of 2 fails the batch."""
    _, tpk, _, _ = nibble
    bad = [0, 1, 16, 3, 0, 0, 0, 0]
    circuits = [TNibble(NIBBLES), TNibble(bad)]
    insts = [[Fp(v) for v in NIB_INST], [Fp(0), Fp(sum(bad))]]
    with pytest.raises(ValueError, match=r"lookup failure.*\[1\]"):
        TP.create_proofs_batch(tpk, circuits, insts, device="cpu", randbits=_Replay(
            _stream(1, 2 * sum(_segments(tpk)))))


def test_entry_points_without_a_card_raise(nibble, monkeypatch):
    """(f) every batch entry point defaults to "cuda" and, without a card,
    raises before it proves (or keygens) anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tpk, _, _ = nibble
    circuits, insts = _nib_circuits()
    calls = [
        lambda: TP.create_proofs_batch(tpk, circuits, insts),
        lambda: TP.create_proofs_pipelined([(tpk, circuits, insts)]),
        lambda: T.prove_compliance_batch([random.Random(1)]),
        lambda: ComplianceVerifyingInfo.create_batch([ComplianceInfo.random(random.Random(1))]),
        lambda: prove_resource_logics_batch([object()]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class _SerialExecutor:
    """concurrent.futures.ThreadPoolExecutor's with/map, run in order on
    the calling thread."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, *iterables):
        return list(map(fn, *iterables))


@pytest.mark.slow
def test_batch_equals_the_jax_batch(monkeypatch):
    """B = 2 ByteRange proofs at k = 9 from the port's create_proofs_batch
    equal taiga_tpu.plonk.prover.create_proofs_batch under the same seeded
    secrets.randbits. The reference's native IPA tails draw from the shared
    generator on up to 4 threads at once, so their order is the threads';
    here its executor runs them in proof order, the port's order. Compiling
    the reference's batch programs takes minutes on the CPU."""
    import concurrent.futures

    from taiga_tpu.plonk import prover as JP

    monkeypatch.delenv("TAIGA_HOST_PROVER", raising=False)
    jpk, tpk = jkeygen(JByteRangeCircuit(), 9), TK.keygen(ByteRangeCircuit(), 9)
    with monkeypatch.context() as m:
        m.setattr(concurrent.futures, "ThreadPoolExecutor", _SerialExecutor)
        m.setattr(secrets, "randbits", random.Random(SEEDS[0]).getrandbits)
        want = JP.create_proofs_batch(jpk, [JByteRangeCircuit(VALUES),
                                            JByteRangeCircuit(VALUES[::-1])], [INST, INST])
    inst = [Fp(v.v) for v in INST]
    got = TP.create_proofs_batch(tpk, [ByteRangeCircuit(VALUES), ByteRangeCircuit(VALUES[::-1])],
                                 [inst, inst], device="cpu",
                                 randbits=random.Random(SEEDS[0]).getrandbits)
    for g, w in zip(got, want):
        _assert_same_proof(jpk, g, w)
