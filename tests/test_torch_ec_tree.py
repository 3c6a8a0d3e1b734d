"""ec_add_tree (K6 chained: each column's halving tree in one launch;
taiga_tpu_torch.ops.ff_kernels.ec_add_tree_lm) through its plain version on
the CPU. On both fields, at C in {1, 2, 3} columns of n in {1, 2, 8, 64}
points, with an identity, an equal pair (the doubling) and a pair P, -P at
the first level: limb for limb against the step-by-step loop of K6 over
half-column copies that parallel/sharded.py::_local_msm_bitserial ran
before, and against the JAX package's host group law
(taiga_tpu.crypto.curves). At one small shape, limb for limb against the
JAX reference's tree (taiga_tpu.ops.ec.ec_add halving, as
taiga_tpu/parallel/sharded.py:84-89): Jacobian coordinates are not
canonical, so only the reference's pairing gives its bits."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.crypto.curves import PallasPoint, VestaPoint
from taiga_tpu.ops import ec as JE, limbs as JL
from taiga_tpu_torch.ops import ff_kernels as FK, limbs as TL

CURVES = {"fp": PallasPoint, "fq": VestaPoint}
JAX_SPECS = {"fp": JL.FP, "fq": JL.FQ}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _columns(field: str, C: int, n: int, seed: int):
    """C columns of n host points and their Jacobian limb-major (16, C n)
    Montgomery coordinates with random Z (the identity as (0, 1, 0)). The
    tree's first level adds lane i and lane i + n / 2; in column 0, i = 0
    meets the identity, i = 1 an equal point (another Z: the doubling) and
    i = 2 its negation, as far as n allows."""
    rng = random.Random(seed)
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    pts = [curve.random(rng) for _ in range(C * n)]
    h = n // 2
    if h >= 1:
        pts[0] = curve.identity()
    if h >= 2:
        pts[1 + h] = pts[1]
    if h >= 3:
        pts[2 + h] = -pts[2]
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt.infinity:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            z = rng.randrange(1, p)
            xs.append(pt.x.v * z * z % p)
            ys.append(pt.y.v * pow(z, 3, p) % p)
            zs.append(z)
    return pts, tuple(torch.as_tensor(np.ascontiguousarray(spec.array_to_mont(v).T))
                      for v in (xs, ys, zs))


def _k6_loop(x, y, z, C: int, field: str):
    """The halving tree as _local_msm_bitserial ran it before ec_add_tree:
    a K6 launch a level over contiguous copies of the half-columns."""
    n = x.shape[1] // C
    acc = [v.reshape(16, C, n) for v in (x, y, z)]
    while n > 1:
        h = n // 2
        out = FK.ec_add_lm(*(v[:, :, :h].reshape(16, C * h).contiguous() for v in acc),
                           *(v[:, :, h:].reshape(16, C * h).contiguous() for v in acc), field)
        acc, n = [v.reshape(16, C, h) for v in out], h
    return tuple(v[:, :, 0] for v in acc)


def _host(field: str, lm):
    curve, spec = CURVES[field], TL.FIELDS[field]
    p, F = spec.modulus, curve.FIELD
    out = []
    for x, y, z in zip(*(spec.array_from_mont(np.ascontiguousarray(v.T)) for v in lm)):
        if z == 0:
            out.append(curve.identity())
        else:
            zi = pow(z, -1, p)
            out.append(curve(F(x * zi * zi % p), F(y * pow(zi, 3, p) % p)))
    return out


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("n", [1, 2, 8, 64])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_tree_plain_equals_k6_loop_and_host(field, C, n):
    pts, (x, y, z) = _columns(field, C, n, seed=1000 * C + n)
    got = FK.ec_add_tree_lm(x, y, z, C, field)
    want = _k6_loop(x, y, z, C, field)
    for g, w in zip(got, want):
        assert g.shape == (16, C)
        assert torch.equal(g, w)
    sums = [sum(pts[c * n + 1:(c + 1) * n], pts[c * n]) for c in range(C)]
    assert _host(field, got) == sums


def test_tree_equals_reference_tree():
    """C = 2 columns of n = 8 on Fq against the JAX package's halving tree
    over taiga_tpu.ops.ec.ec_add, limb for limb."""
    C, n, field = 2, 8, "fq"
    _, (x, y, z) = _columns(field, C, n, seed=7)

    @jax.jit  # one compile for the tree, not one a level and operation
    def tree(acc):
        while acc[0].shape[1] > 1:
            h = acc[0].shape[1] // 2
            acc = JE.ec_add(tuple(a[:, :h] for a in acc), tuple(a[:, h:] for a in acc),
                            JAX_SPECS[field])
        return acc

    acc = tree(tuple(jnp.asarray(v.numpy().T.reshape(C, n, 16).astype(np.uint32))
                     for v in (x, y, z)))
    got = FK.ec_add_tree_lm(x, y, z, C, field)
    for g, a in zip(got, acc):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(a[:, 0]).astype(np.int32))


def test_tree_checks_its_columns():
    x = torch.zeros((16, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        FK.ec_add_tree_lm(x, x, x, 2, "fq")
    with pytest.raises(ValueError, match="power of two"):
        FK.ec_add_tree_lm(x, x, x, 5, "fq")
