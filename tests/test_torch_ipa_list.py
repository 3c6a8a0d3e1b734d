"""The port's list-based IPA open (taiga_tpu_torch.plonk.ipa.ipa_open) and
its all-device multiopen (plonk.prover.multiopen_open_device), on the CPU
through the plain versions (K5 for the generator folds; K2, K3's chained
rounds and ec_horner for the MSMs).

The opens write transcripts; equal bytes under one seeded `randbits` is
the exact comparison: the list-based open of tests/test_torch_ipa.py's
k = 5 polynomial equals its native open (which that file holds equal to
the device open and to the JAX package's device open), verifies, and is
refused with a0 changed. The MSMs run at window c = 4 here, as in
tests/test_torch_ipa.py (the transcript does not depend on c). A k = 5
FibCircuit proof whose multiopen is multiopen_open_device equals the JAX
package's host prover on the same stream of blinds, as the hybrid
multiopen's proofs do (tests/test_torch_batch.py); create_proof's
device-IPA proof of the same statement is compared with it in the `slow`
tier (a second k = 5 proof with a device open, about 40 s here)."""

import functools
from unittest import mock

import pytest
import torch

from taiga_tpu_torch.ops import msm as TM
from taiga_tpu_torch.plonk import ipa as TI, keygen as TK, prover as TP, verifier as TV
from taiga_tpu_torch.plonk.srs import get_params
from taiga_tpu_torch.plonk.transcript import ProofWriter
from taiga_tpu.plonk.keygen import keygen as jkeygen
from tests.test_plonk import FibCircuit as JFibCircuit
from taiga_tpu_torch.parallel.dryrun import FibCircuit
from tests.test_torch_batch import FIB_INST, _host_proof, _Replay, _segments, _stream
from tests.test_torch_ipa import LABEL, SEED, _opening, _seeded, _verify

K, C = 5, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(c: int):
    return (mock.patch.object(TM, "msm", functools.partial(TM.msm, c=c)),
            mock.patch.object(TM, "msm_multi", functools.partial(TM.msm_multi, c=c)))


@functools.lru_cache(maxsize=None)
def _list_open(k: int, c: int) -> bytes:
    op = _opening(k)
    tr = ProofWriter(LABEL)
    m1, m2 = _window(c)
    with m1, m2:
        TI.ipa_open(get_params(k), op["coeffs"], op["blind"], op["x"], tr, _seeded(SEED),
                    device="cpu")
    return tr.bytes()


def test_list_open_equals_native_open():
    assert _list_open(K, C) == _opening(K)["proof"]


@pytest.mark.parametrize("tamper", ["none", "a0"])
def test_list_open_verifies(tamper):
    proof = bytearray(_list_open(K, C))
    if tamper == "a0":
        proof[-64] ^= 1
    assert _verify(_opening(K), bytes(proof), None) == (tamper == "none")


def test_list_open_checks_its_length():
    op = _opening(K)
    with pytest.raises(ValueError, match="coefficients"):
        TI.ipa_open(get_params(K), op["coeffs"][:-1], op["blind"], op["x"], ProofWriter(LABEL),
                    _seeded(SEED), device="cpu")


@functools.lru_cache(maxsize=None)
def _fib_key():
    return TK.keygen(FibCircuit(), K)


def _values():
    return _stream(SEED, sum(_segments(_fib_key())))


@functools.lru_cache(maxsize=None)
def _fib_proof(ipa: str) -> bytes:
    """The seeded FibCircuit proof: its multiopen through
    multiopen_open_device (ipa "all-device"), or create_proof's."""
    m1, m2 = _window(C)
    rb = _Replay(_values())
    with m1, m2:
        if ipa == "all-device":
            st = TP._batch_phase1(_fib_key(), [FibCircuit(3, 4)], [FIB_INST], device="cpu",
                                  rand=TP._Rand(rb), batch=False)
            TP.multiopen_open_device(st.pipe, st.all_coeffs_b[0], st.entries_b[0], st.trs[0],
                                     rb)
            proof = st.trs[0].bytes()
        else:
            proof = TP.create_proof(_fib_key(), FibCircuit(3, 4), FIB_INST, device="cpu",
                                    randbits=rb, ipa=ipa)
    assert rb.used == len(rb.values)
    return proof


def test_device_multiopen_equals_reference():
    proof = _fib_proof("all-device")
    jpk = jkeygen(JFibCircuit(), K)
    assert proof == _host_proof(jpk, JFibCircuit(3, 4), FIB_INST, _values())
    assert TV.verify_proof(_fib_key().vk, FIB_INST, proof)


@pytest.mark.slow
def test_device_multiopen_equals_hybrid_device_ipa():
    assert _fib_proof("all-device") == _fib_proof("device")


def test_create_proof_refuses_an_unknown_ipa():
    with pytest.raises(ValueError, match="ipa must be one of"):
        TP.create_proof(_fib_key(), FibCircuit(3, 4), FIB_INST, device="cpu", ipa="host")
