"""The port's polynomial primitives (taiga_tpu_torch.ops.poly) against the
JAX package's taiga_tpu.ops.poly, exact equality, on seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import poly as JP
from taiga_tpu_torch.ops import poly as TP


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    return x


def _both(jfn, tfn, *xs):
    want = np.asarray(jfn(*(jnp.asarray(x.astype(np.uint32)) for x in xs)))
    got = tfn(*(torch.as_tensor(x.astype(np.int32)) for x in xs)).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def test_scans():
    a = _vals((37, 3), 1)
    _both(JP.mont_cumprod, TP.mont_cumprod, a)
    _both(JP.mod_cumsum, TP.mod_cumsum, a)


def test_powers_and_sums():
    x = _vals((), 2)
    _both(lambda v: JP.powers(v, 50), lambda v: TP.powers(v, 50), x)
    a = _vals((5, 33), 3)
    _both(lambda v: JP.tree_sum(v, 1), lambda v: TP.tree_sum(v, 1), a)
    _both(lambda v: JP.tree_sum(v, 0), lambda v: TP.tree_sum(v, 0), a)
    b = _vals((5, 33), 4)
    _both(JP.mont_dot, TP.mont_dot, a, b)


def test_evaluation_division_and_combination():
    coeffs = _vals((3, 64), 5)
    pts = _vals((2,), 6)
    _both(JP.eval_polys_at_points, TP.eval_polys_at_points, coeffs, pts)
    pt, pt_inv = _vals((), 7), _vals((), 8)
    _both(JP.synthetic_div, TP.synthetic_div, coeffs, pt, pt_inv)
    w = _vals((3,), 9)
    _both(JP.mont_linear_combo, TP.mont_linear_combo, coeffs, w)
