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


def test_batched_forms_equal_one_proof_at_a_time():
    """The batch prover's forms: a leading axis of proofs, each stack with
    its own points and weights, gives what each proof gives alone."""
    t = lambda x: torch.as_tensor(x.astype(np.int32))
    coeffs, pts, inv, w = t(_vals((2, 3, 64), 10)), t(_vals((2, 2), 11)), \
        t(_vals((2, 3), 12)), t(_vals((2, 3), 13))
    got_ev = TP.eval_polys_at_points(coeffs, pts)
    got_sd = TP.synthetic_div(coeffs, pts[:, :1].expand(2, 3, 16), inv)
    got_lc = TP.mont_linear_combo(coeffs, w)
    for b in range(2):
        assert torch.equal(got_ev[b], TP.eval_polys_at_points(coeffs[b], pts[b]))
        assert torch.equal(got_lc[b], TP.mont_linear_combo(coeffs[b], w[b]))
        for c in range(3):
            assert torch.equal(got_sd[b, c], TP.synthetic_div(coeffs[b, c], pts[b, 0], inv[b, c]))
