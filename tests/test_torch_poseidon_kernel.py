"""The port's batched Poseidon (taiga_tpu_torch.ops.poseidon_kernel) on
the CPU, where permute_batch and hash_n_batch run the plain versions of
csrc/poseidon.cu's two kernels, against the host sponge
(taiga_tpu.crypto.poseidon) at every length and tree size, and against the
JAX package's compiled program (taiga_tpu.ops.poseidon_kernel) at one shape
of permute_batch and at lengths 2 and 8 of hash_n_batch: each further XLA
shape costs a compile of 5-13 s, so lengths 1-8 against the compiled
program are in the `slow` tier. The sparse form's constants
(sparse_params) are held against the dense permutation on the host."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.crypto import poseidon as JH
from taiga_tpu.crypto.fields import Fp as JFp
from taiga_tpu.ops import poseidon_kernel as JPK
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.ops import limbs as TL, poseidon_kernel as PK

N = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elems(rng, count: int) -> list[int]:
    """Random field elements, with 0 and p - 1 first."""
    p = TL.FP.modulus
    return ([0, p - 1] + [rng.randrange(p) for _ in range(count)])[:count]


def _mont(vals, shape):
    return TL.FP.array_to_mont(vals).reshape(shape + (16,))


def test_permute_batch_matches_host_and_reference():
    rng = random.Random(1)
    vals = _elems(rng, N * 3)
    x = _mont(vals, (N, 3))
    got = PK.permute_batch(torch.as_tensor(x))
    want = [v for i in range(N) for v in JH.permute_ints(vals[3 * i : 3 * i + 3])]
    assert TL.FP.array_from_mont(got.reshape(-1, 16)) == want
    ref = JPK.permute_batch(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


def test_sparse_constants_reproduce_dense_permutation():
    """The kernel's arithmetic on host ints (permute_sparse_ints: the
    sparse form's constants, from sparse_params) equals the JAX package's
    dense permutation on 64 seeded states and the edge states."""
    rng = random.Random(64)
    p = TL.FP.modulus
    states = [[rng.randrange(p) for _ in range(3)] for _ in range(64)]
    states += [[0, 0, 0], [p - 1] * 3, [0, p - 1, 1]]
    for s in states:
        assert PK.permute_sparse_ints(s) == JH.permute_ints(s)


def test_sparse_params_factor_the_partial_rounds():
    """Each partial round's matrix is its sparse factor times the next
    round's D = diag(1, N11..22): the factors multiply back to the MDS
    chain, and every w, b and constant is a canonical element."""
    p = TL.FP.modulus
    sp = PK.sparse_params()
    a = sp["a"]
    assert a == JH.MDS[0][0] and len(sp["partial"]) == JH.PARTIAL_ROUNDS
    assert all(0 <= v < p for row in sp["partial"] for v in row)
    # the last partial round: S D = MDS, D = diag(1, MDS11..22)
    k, b1, b2, w1, w2 = sp["partial"][-1]
    m = JH.MDS
    d = [[1, 0, 0], [0, m[1][1], m[1][2]], [0, m[2][1], m[2][2]]]
    S = [[a, b1, b2], [w1 * a % p, 1, 0], [w2 * a % p, 0, 1]]
    assert PK._matmul(S, d, p) == [[v % p for v in row] for row in m]


def test_permute_plain_equals_reference():
    """The plain version (the sparse rounds, limb-major) against the JAX
    package's compiled permute_batch on seeded numpy states."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 16, size=(N, 3, 16), dtype=np.int32)
    x[..., 15] &= 0x3FFF  # canonical: below 2^254 < p
    x[0] = 0
    got = PK.permute_plain(torch.as_tensor(x))
    ref = JPK.permute_batch(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


def test_permute_batch_checks_its_input():
    with pytest.raises(ValueError, match="state"):
        PK.permute_batch(torch.zeros((N, 2, 16), dtype=torch.int32))


@pytest.mark.parametrize("length", range(1, 9))
def test_hash_n_batch_matches_host(length):
    rng = random.Random(100 + length)
    msgs = [_elems(rng, length) for _ in range(N)]
    got = PK.hash_n_batch(torch.as_tensor(_mont(sum(msgs, []), (N, length))), length)
    want = [JH.poseidon_hash_n([JFp(v) for v in m]).v for m in msgs]
    assert [f.v for f in PK.mont_to_fps(got)] == want


def test_hash_n_batch_8_equals_reference():
    rng = random.Random(8)
    msgs = _mont(_elems(rng, N * 8), (N, 8))
    got = PK.hash_n_batch(torch.as_tensor(msgs), 8)
    ref = JPK.hash_n_batch(jnp.asarray(msgs.astype(np.uint32)), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


def test_hash_n_plain_2_equals_reference():
    rng = random.Random(2)
    msgs = _mont(_elems(rng, N * 2), (N, 2))
    got = PK.hash_n_plain(torch.as_tensor(msgs), 2)
    ref = JPK.hash_n_batch(jnp.asarray(msgs.astype(np.uint32)), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


@pytest.mark.slow
@pytest.mark.parametrize("length", range(1, 9))
def test_hash_n_plain_equals_reference(length):
    rng = random.Random(200 + length)
    msgs = _mont(_elems(rng, N * length), (N, length))
    got = PK.hash_n_plain(torch.as_tensor(msgs), length)
    ref = JPK.hash_n_batch(jnp.asarray(msgs.astype(np.uint32)), length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


def test_merkle_level_reads_pairs_in_place():
    """merkle_level hashes the (2M, 16) nodes read as (M, 2, 16) pairs: the
    old pairing of nodes[0::2] with nodes[1::2], limb for limb."""
    rng = random.Random(5)
    nodes = torch.as_tensor(_mont(_elems(rng, 2 * N), (2 * N,)))
    want = PK.hash_n_plain(torch.stack([nodes[0::2], nodes[1::2]], dim=1), 2)
    assert torch.equal(PK.merkle_level(nodes), want)
    with pytest.raises(ValueError, match="2M"):
        PK.merkle_level(nodes[:3])


def test_hash2_and_merkle_level():
    rng = random.Random(2)
    left, right = (PK.fps_to_mont([Fp(v) for v in _elems(rng, N)]) for _ in range(2))
    got = PK.hash2_batch(torch.as_tensor(left), torch.as_tensor(right))
    want = [JH.poseidon_hash(JFp(a.v), JFp(b.v)).v
            for a, b in zip(PK.mont_to_fps(left), PK.mont_to_fps(right))]
    assert [f.v for f in PK.mont_to_fps(got)] == want
    nodes = torch.as_tensor(np.stack([left, right], 1).reshape(2 * N, 16))
    assert torch.equal(PK.merkle_level(nodes), got)


@pytest.mark.parametrize("depth", [4, 5, 6])
def test_merkle_root_matches_host(depth):
    rng = random.Random(depth)
    leaves = [Fp(v) for v in _elems(rng, 1 << depth)]
    root = PK.merkle_root(torch.as_tensor(PK.fps_to_mont(leaves)))
    level = [JFp(f.v) for f in leaves]
    while len(level) > 1:
        level = [JH.poseidon_hash(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    assert PK.mont_to_fps(root[None])[0].v == level[0].v


def test_merkle_root_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        PK.merkle_root(torch.zeros((6, 16), dtype=torch.int32))


def test_fps_round_trip():
    vals = [Fp(v) for v in _elems(random.Random(3), 5)]
    assert PK.mont_to_fps(torch.as_tensor(PK.fps_to_mont(vals))) == vals
