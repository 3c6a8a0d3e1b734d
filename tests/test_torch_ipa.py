"""The port's IPA (taiga_tpu_torch.plonk.ipa): the device open against the
native open and the JAX package's device open, and the verifier's
device-MSM branch.

The opens write transcripts; equal bytes under one seeded `randbits` is the
exact comparison. The device open runs every MSM and fold through the plain
versions of K2/K3/K5 here: at k = 5 with its MSMs at window c = 4 in tier
1, and at k = 9 with the prover's c = 8 (about ten minutes of CPU) in the
`slow` tier. The verifier's device branch (one MSM over the SRS) runs
at k = 9 in tier 1."""

import functools
import random
import secrets
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.plonk import ipa as JI
from taiga_tpu.plonk.srs import get_params as j_get_params
from taiga_tpu.plonk.transcript import ProofWriter as JProofWriter
from taiga_tpu_torch.native import hostops as TH
from taiga_tpu_torch.ops import limbs as TL, msm as TM
from taiga_tpu_torch.plonk import ipa as TI
from taiga_tpu_torch.plonk.msm_claim import MSMClaim
from taiga_tpu_torch.plonk.native_open import _msm_point, ipa_open_native
from taiga_tpu_torch.plonk.srs import get_params
from taiga_tpu_torch.plonk.transcript import ProofReader, ProofWriter


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 9
P = TL.FP.modulus
LABEL = b"taiga-tpu-ipa-test"
SEED = 20261016


def _seeded(seed: int):
    return random.Random(seed).getrandbits


@functools.lru_cache(maxsize=None)
def _opening(k: int):
    """A random polynomial of 2^k coefficients, its commitment, point and
    value, and its native opening under the seeded randbits."""
    rnd = random.Random(7)
    coeffs = [rnd.getrandbits(250) % P for _ in range(1 << k)]
    x = rnd.getrandbits(250) % P
    blind = rnd.getrandbits(250) % P
    v = 0
    for c in reversed(coeffs):
        v = (v * x + c) % P
    mont = TL.FP.array_to_mont(coeffs)
    tr = ProofWriter(LABEL)
    ipa_open_native(get_params(k), TL.packed_to_u64(TL.pack_limbs(torch.as_tensor(mont))),
                    blind, x, tr, _seeded(SEED))
    commit = _msm_point(k, TH.ints_to_u64(coeffs), blind)
    return dict(k=k, coeffs=coeffs, mont=mont, x=x, blind=blind, v=v, commit=commit,
                proof=tr.bytes())


@pytest.fixture(scope="module")
def opening():
    return _opening(K)


def _verify(op, proof, msm_device, value=None):
    return TI.ipa_verify(get_params(op["k"]), [(op["commit"], 1)], op["x"],
                         op["v"] if value is None else value,
                         ProofReader(proof, LABEL), msm_device=msm_device)


def test_native_verifier_accepts_the_opening(opening):
    assert _verify(opening, opening["proof"], None)
    assert not _verify(opening, opening["proof"], None, value=(opening["v"] + 1) % P)


@pytest.mark.parametrize("tamper", ["none", "a0"])
def test_device_msm_verifier(opening, tamper):
    """The device branch (host point arithmetic, <s, G> as one MSM on the
    given device) accepts the opening and refuses it with a0 changed."""
    proof = bytearray(opening["proof"])
    if tamper == "a0":
        proof[-64] ^= 1  # a0, the second-to-last scalar, still canonical
    assert _verify(opening, bytes(proof), "cpu") == (tamper == "none")
    assert _verify(opening, bytes(proof), None) == (tamper == "none")


def test_device_msm_verifier_takes_no_claim(opening):
    with pytest.raises(TypeError, match="claim"):
        TI.ipa_verify(get_params(K), [(opening["commit"], 1)], opening["x"], opening["v"],
                      ProofReader(opening["proof"], LABEL), claim=MSMClaim(K), msm_device="cpu")


@functools.lru_cache(maxsize=None)
def _device_open(k: int, c: int) -> bytes:
    """The device open of _opening(k) with its MSMs at window c. The
    transcript does not depend on c. At c = 8, the prover's window, the
    plain versions' bucket sums span 2 x 32 x 8 x 256 lanes whatever k is,
    some fifty seconds an MSM here; c = 4 takes a sixteenth of them."""
    op = _opening(k)
    tr = ProofWriter(LABEL)
    with mock.patch.object(TM, "msm", functools.partial(TM.msm, c=c)), \
            mock.patch.object(TM, "msm_multi", functools.partial(TM.msm_multi, c=c)):
        TI.ipa_open_device(get_params(k), torch.as_tensor(op["mont"]), op["blind"], op["x"],
                           tr, _seeded(SEED))
    return tr.bytes()


OPEN_CASES = [pytest.param(5, 4, id="k5-c4"),
              pytest.param(9, TM.WINDOW_BITS, id="k9-c8", marks=pytest.mark.slow)]


@pytest.mark.parametrize("k,c", OPEN_CASES)
def test_device_open_equals_native_open(k, c):
    op = _opening(k)
    assert _device_open(k, c) == op["proof"]
    assert _verify(op, _device_open(k, c), None)


@pytest.mark.parametrize("k,c", OPEN_CASES)
def test_device_open_equals_reference_device_open(k, c):
    """The JAX package's ipa_open_device, with secrets.randbits seeded (the
    method of tools/prover_diff.py), writes the same bytes."""
    op = _opening(k)
    orig = secrets.randbits
    secrets.randbits = _seeded(SEED)
    try:
        tr = JProofWriter(LABEL)
        JI.ipa_open_device(j_get_params(k), jnp.asarray(op["mont"].astype(np.uint32)),
                           op["blind"], op["x"], tr)
    finally:
        secrets.randbits = orig
    assert tr.bytes() == _device_open(k, c)
