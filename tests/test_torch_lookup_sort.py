"""The port's lookup permutation (taiga_tpu_torch.ops.lookup_sort
.permute_pairs_device: LSD passes of a stable sort in place of a multi-key
sort) against the JAX package's, bit for bit, the `ok` flag of a failing
lookup included: the permuted columns are committed, so any difference would
change the proof.

Inputs: the compressed columns of tests/test_lookup.py's ByteRangeCircuit
(byte lookup and theta-compressed pair lookup, passing and failing) and
random 254-bit columns with repeats."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import limbs as JL, lookup_sort as JLS
from taiga_tpu_torch.ops import lookup_sort as TLS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 9
N = 1 << K
U = N - 8 - 1  # usable rows (BLINDING_ROWS = 8)
P = JL.FP.modulus
VALUES = [0, 1, 7, 255, 128, 42, 42, 200]
BAD = [0, 1, 300, 255, 0, 0, 0, 0]


def _byte_range_columns(values, theta):
    """(A, S) for the 'byte' and 'double' lookups: A = q*v (and
    theta*(q*v) + q*v2), S = the fixed table (and theta*t_lo + t_hi)."""
    v = values + [0] * (N - len(values))
    v2 = [(2 * x) % 256 if i < len(values) else 0 for i, x in enumerate(v)]
    t = list(range(256)) + [0] * (N - 256)
    t2 = [(2 * i) % 256 if i < 256 else 0 for i in range(N)]
    a = [v, [(theta * x + y) % P for x, y in zip(v, v2)]]
    s = [t, [(theta * x + y) % P for x, y in zip(t, t2)]]
    return a, s


def _random_columns(seed, fail: bool):
    rng = random.Random(seed)
    s = [rng.getrandbits(254) for _ in range(N)]
    a = [rng.choice(s[:U]) for _ in range(N)]
    if fail:
        a[17] = (s[0] + 1) % P
    return [a], [s]


def _mont(cols):
    return np.stack([JL.FP.array_to_mont([x % P for x in c]) for c in cols]).astype(np.int64)


def _compare(a_cols, s_cols):
    a, s = _mont(a_cols), _mont(s_cols)
    want = JLS.permute_pairs_device(jnp.asarray(a.astype(np.uint32)),
                                    jnp.asarray(s.astype(np.uint32)), U)
    got = TLS.permute_pairs_device(torch.as_tensor(a.astype(np.int32)),
                                   torch.as_tensor(s.astype(np.int32)), U)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    return got[2].numpy()


@pytest.mark.parametrize("values,ok", [(VALUES, True), (BAD, False)], ids=["pass", "fail"])
def test_byte_range_lookup_columns(values, ok):
    a, s = _byte_range_columns(values, theta=0x1234567890ABCDEF)
    flags = _compare(a, s)
    assert flags.tolist() == [ok, ok]


@pytest.mark.parametrize("fail", [False, True], ids=["pass", "fail"])
def test_random_wide_columns(fail):
    flags = _compare(*_random_columns(5, fail))
    assert flags.tolist() == [not fail]
