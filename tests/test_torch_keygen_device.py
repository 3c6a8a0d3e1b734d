"""The device branch of the port's keygen commitments
(plonk/keygen.py::commit_columns): a key's fixed and sigma columns
through the port's iNTT and msm_multi, here on the CPU through the plain
versions, give the commitments of the host engine's keygen, and a
verifying key on them equals the host's and the JAX package's byte for
byte. Sizes:
tests/test_lookup.py's ByteRangeCircuit with a 16-entry table
(tests/test_torch_batch.py) and FibCircuit at k = 5, the MSMs at window
c = 4 (the points do not depend on c; the plain bucket sums at the
prover's c = 8 take minutes)."""

import functools
import random
from unittest import mock

import numpy as np
import pytest
import torch

from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu_torch.ops import limbs as TL, msm as TM
from taiga_tpu_torch.parallel.dryrun import FibCircuit
from taiga_tpu_torch.plonk import keygen as TK
from taiga_tpu_torch.plonk.srs import get_params
from tests.test_plonk import FibCircuit as JFibCircuit
from tests.test_torch_batch import JNibble, TNibble

K = 5
CIRCUITS = {"nibble": (TNibble, JNibble), "fib": (FibCircuit, JFibCircuit)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _c4():
    return mock.patch.object(TM, "msm_multi", functools.partial(TM.msm_multi, c=4))


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_device_keygen_equals_host_and_reference(name):
    tcls, jcls = CIRCUITS[name]
    pk = TK.keygen(tcls(), K)
    with _c4():
        got = TK.commit_columns(K, np.concatenate([pk.fixed_mont(), pk.sigma_mont()]), "cpu")
    vk, nf = pk.vk, len(pk.vk.fixed_commitments)
    assert got == vk.fixed_commitments + vk.sigma_commitments
    dev_vk = TK.VerifyingKey(K, vk.cs, vk.perm_cols, got[:nf], got[nf:], vk.omega)
    assert dev_vk.to_bytes() == vk.to_bytes() == jkeygen(jcls(), K).vk.to_bytes()


def test_commit_column_device_equals_host():
    rng = random.Random(9)
    col = [rng.getrandbits(250) for _ in range(1 << K)]
    blind = rng.getrandbits(250)
    with _c4():
        (got,) = TK.commit_columns(K, TL.FP.array_to_mont(col)[None], "cpu")
    assert got + get_params(K).w * blind == TK.commit_column(K, col, blind)


def test_device_keygen_without_a_card_raises_before_work():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TK.commit_columns(K, np.zeros((1, 1 << K, 16), np.int32), "cuda")
