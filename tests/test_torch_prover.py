"""The port's prover as a whole (taiga_tpu_torch.plonk) against the JAX
package, on the CPU through the plain versions of the kernels, on
tests/test_lookup.py's ByteRangeCircuit (copied below onto the port's
Circuit) at k = 9: the port's keygen equals the JAX package's, and a proof
made with the key carried across (proving_key_from_arrays) and seeded blinds
is byte-identical to taiga_tpu.plonk.host_prover.create_proof_host under the
same seed, and verifies under both verifiers. The same proof with the
device IPA open (ipa="device", `slow`: ten minutes of plain-version MSMs and
folds on the CPU) is byte-identical too, and verifies through the device
MSM. Every comparison is exact."""

import random
import secrets

import numpy as np
import pytest
import torch

from taiga_tpu.plonk.host_prover import create_proof_host
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu.plonk.verifier import verify_proof as jverify
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.native import hostops as TH
from taiga_tpu_torch.plonk import keygen as TK, prover as TP, verifier as TV
from taiga_tpu_torch.plonk.circuit import Circuit, CircuitBuilder, ConstraintSystem
from tests.test_lookup import BAD, INST, VALUES, ByteRangeCircuit as JByteRangeCircuit
from tools.prover_diff import proof_items

K = 9
SEED = 20260819


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ByteRangeCircuit(Circuit):
    """tests/test_lookup.py's ByteRangeCircuit on the port's Circuit: each
    gated advice value is a byte (lookup into a fixed table), a second,
    theta-compressed lookup checks (v, 2v mod 256), and a gate keeps a
    running sum that the instance pins."""

    NUM_FIXED = 4
    NUM_ADVICE = 3
    NUM_INSTANCE = 1
    NUM_VALUES = 8

    def __init__(self, values=None):
        assert values is None or len(values) == self.NUM_VALUES
        self.values = values

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        q, t_byte, t_lo, t_hi = (cs.fixed(i) for i in range(4))
        v, v2, s = (cs.advice(i) for i in range(3))
        cs.lookup("byte", [(q * v, t_byte)])
        cs.lookup("double", [(q * v, t_lo), (q * v2, t_hi)])
        cs.create_gate("sum", q * (s.at(1) - s - v))
        return None

    def synthesize(self, builder: CircuitBuilder, config):
        for i in range(256):
            builder.assign_fixed(1, i, i)
            builder.assign_fixed(2, i, i)
            builder.assign_fixed(3, i, (2 * i) % 256)
        vals = self.values if self.values is not None else [None] * self.NUM_VALUES
        base = builder.alloc_rows(max(256, self.NUM_VALUES + 1))
        assert base == 0
        acc = 0 if self.values is not None else None
        first = builder.assign_advice(2, 0, acc)
        s_cell = first
        for r, val in enumerate(vals):
            builder.assign_fixed(0, r, 1)
            builder.assign_advice(0, r, val)
            builder.assign_advice(1, r, None if val is None else (2 * val) % 256)
            if acc is not None and val is not None:
                acc = (acc + val) % Fp.MODULUS
            s_cell = builder.assign_advice(2, r + 1, acc)
        builder.constrain_instance(first, 0)
        builder.constrain_instance(s_cell, 1)


def _seeded(seed: int):
    return random.Random(seed).getrandbits


def _assert_same_keys(jpk, tpk):
    assert tpk.vk.to_bytes() == jpk.vk.to_bytes()
    np.testing.assert_array_equal(tpk.fixed_mont(), np.asarray(jpk.fixed_mont()).astype(np.int32))
    np.testing.assert_array_equal(tpk.sigma_mont(), np.asarray(jpk.sigma_mont()).astype(np.int32))


@pytest.fixture(scope="module")
def keys():
    """The JAX package's key and the port's copy of it, carried across."""
    jpk = jkeygen(JByteRangeCircuit(), K)
    _, config = ByteRangeCircuit.build_cs()
    tpk = TK.proving_key_from_arrays(jpk.vk.to_bytes(), jpk.fixed_mont(), jpk.sigma_mont(),
                                     config)
    return jpk, tpk


def test_port_keygen_matches_reference(keys):
    jpk, _ = keys
    _assert_same_keys(jpk, TK.keygen(ByteRangeCircuit(), K))


def test_key_arrays_are_checked_against_the_key(keys):
    jpk, _ = keys
    with pytest.raises(ValueError, match="sigma"):
        TK.proving_key_from_arrays(jpk.vk.to_bytes(), jpk.fixed_mont(),
                                   np.asarray(jpk.sigma_mont())[1:])


@pytest.fixture(scope="module")
def host_proof(keys):
    jpk, _ = keys
    orig = secrets.randbits
    secrets.randbits = _seeded(SEED)
    try:
        return create_proof_host(jpk, JByteRangeCircuit(VALUES), INST)
    finally:
        secrets.randbits = orig


def _assert_same_proof(jpk, got, want):
    if got != want:
        first = next(label for (label, w), (_, g) in
                     zip(proof_items(jpk, want), proof_items(jpk, got)) if w != g)
        pytest.fail(f"the proofs first differ at {first} ({len(got)} vs {len(want)} bytes)")


def test_seeded_proof_equals_host_prover(keys, host_proof):
    jpk, tpk = keys
    inst = [Fp(v.v) for v in INST]
    got = TP.create_proof(tpk, ByteRangeCircuit(VALUES), inst, device="cpu",
                          randbits=_seeded(SEED))
    _assert_same_proof(jpk, got, host_proof)
    assert TV.verify_proof(tpk.vk, inst, got)
    assert jverify(jpk.vk, INST, got)
    assert not TV.verify_proof(tpk.vk, [inst[0], inst[1] + Fp(1)], got)


@pytest.mark.slow
def test_device_ipa_proof_equals_host_prover(keys, host_proof, monkeypatch):
    """ipa="device": the IPA open runs on the proof's device (K5 folds,
    general MSMs), never on the native engine, and gives the same bytes as
    the host prover and as the port's native IPA open; it verifies under
    both verifiers and through the device MSM. The device MSM's final
    check refuses the proof with a0 changed (the IPA's last but one scalar:
    only that check reads it); a changed instance is refused before it, by
    the vanishing identity."""
    jpk, tpk = keys
    inst = [Fp(v.v) for v in INST]

    def no_engine():
        raise AssertionError("the device IPA asked for the native engine")

    with monkeypatch.context() as m:
        m.setattr(TH, "available", no_engine)
        got = TP.create_proof(tpk, ByteRangeCircuit(VALUES), inst, device="cpu",
                              randbits=_seeded(SEED), ipa="device")
    _assert_same_proof(jpk, got, host_proof)
    assert TV.verify_proof(tpk.vk, inst, got)
    assert jverify(jpk.vk, INST, got)
    assert TV.verify_proof(tpk.vk, inst, got, msm_device="cpu")
    tampered = bytearray(got)
    tampered[-64] ^= 1  # a0, still canonical
    assert not TV.verify_proof(tpk.vk, inst, bytes(tampered), msm_device="cpu")
    assert not TV.verify_proof(tpk.vk, [inst[0], inst[1] + Fp(1)], got, msm_device="cpu")


def test_unknown_ipa_open_is_refused(keys):
    _, tpk = keys
    with pytest.raises(ValueError, match="ipa"):
        TP.create_proof(tpk, ByteRangeCircuit(VALUES), [Fp(v.v) for v in INST], device="cpu",
                        ipa="host")


def test_out_of_table_witness_is_refused(keys):
    _, tpk = keys
    inst = [Fp(0), Fp(sum(BAD))]
    with pytest.raises(ValueError, match="lookup failure"):
        TP.create_proof(tpk, ByteRangeCircuit(BAD), inst, device="cpu", randbits=_seeded(1))


def test_cuda_without_a_card_raises(keys, monkeypatch):
    """The default device is "cuda": without a card the prover refuses
    rather than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tpk = keys
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.create_proof(tpk, ByteRangeCircuit(VALUES), [Fp(v.v) for v in INST])
