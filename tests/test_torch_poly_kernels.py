"""K12-K14's wrappers, taiga_tpu_torch.ops.ff_kernels.eval_polys_lm,
linear_combo_lm and synthetic_div_lm, on the CPU, where each runs its plain
version (ops/poly.py::eval_polys_plain, linear_combo_plain,
synthetic_div_plain), against the JAX package's taiga_tpu.ops.poly
(eval_polys_at_points, mont_linear_combo, synthetic_div, jitted on the
CPU): n in {2, 37, 64}, C and Q of 1 and a few, a leading batch axis
against one stack at a time, shared and per-polynomial points (with a
point_inv that is not the point's inverse), and the values 0, R mod p and
p - 1 among the coefficients, points and weights (and a stack of p - 1
only at nine points, where K12's unreduced sums are largest); K13's
grouped call (mont_linear_combo_groups) against the reference multiopen's
agg_fn and f_fn; exact equality. Also the wrappers' refusals and the
source list. The kernels themselves are held against the plain versions
on the card (chip_smoke.py, phase_poly)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import limbs as JL, poly as JP
from taiga_tpu.plonk import hybrid_open as JH
from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK, limbs as TL, poly as TP

NS = (2, 37, 64)
B = 2  # the leading batch axis: stacks held one at a time against the reference


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(shape, seed):
    """Seeded canonical elements (< 2^254 < p) of shape (..., 16): the first
    elements 0, 1 (R mod p) and p - 1, and, where the leading axes hold
    three rows of shape[-1] elements or more, a last row of p - 1 and a row
    of 0 before it."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    flat = x.reshape(-1, 16)
    for i, v in enumerate((0, TL.FP.r, TL.FP.modulus - 1)[: flat.shape[0]]):
        flat[i] = TL.int_to_limbs(v)
    if len(shape) >= 2:
        rows = x.reshape(-1, shape[-1], 16)
        if rows.shape[0] >= 3:
            rows[-1] = TL.int_to_limbs(TL.FP.modulus - 1)
            rows[-2] = 0
    return x


def _t(x):
    return torch.as_tensor(x.astype(np.int32))


def _j(x):
    return jnp.asarray(x.astype(np.uint32))


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64), err_msg=what)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("C,Q", [(1, 1), (3, 2)])
def test_eval_polys_lm_matches_reference(n, C, Q):
    coeffs, points = _vals((B, C, n), 10 * n + C), _vals((B, Q), 20 * n + Q)
    got = FK.eval_polys_lm(_t(coeffs), _t(points))
    assert got.shape == (B, Q, C, 16)
    for b in range(B):
        _eq(got[b], JP.eval_polys_at_points(_j(coeffs[b]), _j(points[b])), f"stack {b}")
    # the public entry point routes to the wrapper
    assert torch.equal(TP.eval_polys_at_points(_t(coeffs[0]), _t(points[0])), got[0])


def test_eval_polys_lm_largest_sums_match_reference():
    """Every coefficient p - 1, at nine points with p - 1 among them: the
    products' unreduced sums are largest (on the card a lane sums eight of
    them before its one reduction)."""
    coeffs = np.broadcast_to(TL.int_to_limbs(TL.FP.modulus - 1), (2, 37, 16)).copy()
    points = _vals((9,), 9)
    got = FK.eval_polys_lm(_t(coeffs), _t(points))
    _eq(got, JP.eval_polys_at_points(_j(coeffs), _j(points)), "p - 1")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("C", [1, 3])
def test_linear_combo_lm_matches_reference(n, C):
    stack, weights = _vals((B, C, n), 30 * n + C), _vals((B, C), 40 * n + C)
    got = FK.linear_combo_lm(_t(stack), _t(weights))
    assert got.shape == (B, n, 16)
    for b in range(B):
        _eq(got[b], JP.mont_linear_combo(_j(stack[b]), _j(weights[b])), f"stack {b}")
    assert torch.equal(TP.mont_linear_combo(_t(stack[0]), _t(weights[0])), got[0])


GROUPS = (1, 8, 9, 17)  # K13's grouped call: groups across its runs of 8 terms


@pytest.mark.parametrize("addend", [False, True], ids=["no_addend", "addend"])
@pytest.mark.parametrize("top", [False, True], ids=["seeded", "p_minus_1"])
def test_linear_combo_groups_match_reference(addend, top):
    """K13's grouped call (its plain version on the CPU) against the
    reference multiopen's agg_fn (taiga_tpu/plonk/hybrid_open.py: the
    groups' columns gathered, each group's mont_linear_combo, jnp.stack),
    with L.add of an addend after it: groups of 1, 8, 9 and 17 terms over
    20 columns, some columns in several groups; every coefficient p - 1
    (the largest lazy sums on the card) or seeded values."""
    C, n = 20, 37
    rng = np.random.default_rng(5 + top + 2 * addend)
    cols = rng.integers(0, C, size=sum(GROUPS)).tolist()
    stack = (np.broadcast_to(TL.int_to_limbs(TL.FP.modulus - 1), (B, C, n, 16)).copy() if top
             else _vals((B, C, n), 80))
    weights, add = _vals((B, sum(GROUPS)), 81), _vals((B, len(GROUPS), n), 82)
    agg_fn, _, _ = JH._build_programs(GROUPS)
    got = TP.mont_linear_combo_groups(_t(stack), cols, GROUPS, _t(weights),
                                      _t(add) if addend else None)
    assert got.shape == (B, len(GROUPS), n, 16)
    for b in range(B):
        want = agg_fn(_j(stack[b]), jnp.asarray(np.asarray(cols, np.int32)), _j(weights[b]))
        if addend:
            want = JL.add(want, _j(add[b]), JL.FP)
        _eq(got[b], want, f"stack {b}")


def test_linear_combo_f_matches_reference():
    """The multiopen's f = h + sum_j w^(j+1) agg_j as K13's one group with h
    for its addend, against the reference's f_fn, with p - 1 among the
    aggregates, weights and h."""
    G, n = 6, 37
    agg, w, h = _vals((B, G, n), 90), _vals((B, G), 91), _vals((B, n), 92)
    _, _, f_fn = JH._build_programs((1,) * G)
    got = TP.mont_linear_combo_groups(_t(agg), None, (G,), _t(w), addend=_t(h)[:, None])
    assert got.shape == (B, 1, n, 16)
    for b in range(B):
        _eq(got[b, 0], f_fn(_j(h[b]), _j(agg[b]), _j(w[b])), f"proof {b}")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_poly"])
def test_synthetic_div_lm_matches_reference(n, shared):
    """The multiopen's form (one point and a point_inv a polynomial of a
    (B, G, n) stack) and one point shared by the stack; point_inv is drawn
    on its own, so it is not the point's inverse: the wrapper scales by the
    powers it is given."""
    G = 3
    coeffs = _vals((B, G, n), 50 * n)
    lead = () if shared else (B, G)
    point, point_inv = _vals(lead, 60 * n), _vals(lead, 70 * n + 1)
    got = FK.synthetic_div_lm(_t(coeffs), _t(point), _t(point_inv))
    assert got.shape == (B, G, n, 16)
    if shared:
        for b in range(B):
            _eq(got[b], JP.synthetic_div(_j(coeffs[b]), _j(point), _j(point_inv)), f"stack {b}")
    else:
        for b in range(B):
            for g in range(G):
                _eq(got[b, g], JP.synthetic_div(_j(coeffs[b, g]), _j(point[b, g]),
                                                _j(point_inv[b, g])), f"row ({b}, {g})")
    assert torch.equal(TP.synthetic_div(_t(coeffs), _t(point), _t(point_inv)), got)


def test_linear_combo_warps():
    """K13's warps a block: a group's terms over up to 8 warps while a call's
    blocks number at most two an SM (a proof's rows: 256 blocks of 32
    positions), else a warp a run of 8 terms (a batch's 2,048 blocks)."""
    assert FK.linear_combo_warps(256, 90) == 8 and FK.linear_combo_warps(256, 6) == 6
    assert FK.linear_combo_warps(2048, 90) == 8 and FK.linear_combo_warps(2048, 6) == 1
    assert FK.linear_combo_warps(2048, 17) == 3 and FK.linear_combo_warps(1, 1) == 1
    for blocks in (1, 264, 265, 5000):
        for widest in range(1, 200):
            w = FK.linear_combo_warps(blocks, widest)
            assert 1 <= w <= min(FK.COMBO_WARPS, widest)


def _refused(fn, *args):
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_wrappers_refuse_bad_dtypes_and_shapes():
    coeffs, points, w = _t(_vals((2, 8), 1)), _t(_vals((3,), 2)), _t(_vals((2,), 3))
    pt = _t(_vals((), 4))
    # dtypes
    _refused(FK.eval_polys_lm, coeffs.long(), points)
    _refused(FK.eval_polys_lm, coeffs, points.long())
    _refused(FK.linear_combo_lm, coeffs.to(torch.int16), w)
    _refused(FK.linear_combo_lm, coeffs, w.long())
    _refused(FK.synthetic_div_lm, coeffs.long(), pt, pt)
    _refused(FK.synthetic_div_lm, coeffs, pt.long(), pt)
    _refused(FK.synthetic_div_lm, coeffs, pt, pt.long())
    # shapes: limbs other than 16, too few axes, no coefficient, C disagreeing
    _refused(FK.eval_polys_lm, coeffs[..., :15], points)
    _refused(FK.eval_polys_lm, coeffs[0], points)
    _refused(FK.eval_polys_lm, coeffs, points[0])
    _refused(FK.eval_polys_lm, coeffs[:, :0], points)
    _refused(FK.linear_combo_lm, coeffs, w[:1])
    _refused(FK.linear_combo_lm, coeffs[:0], w[:0])
    _refused(FK.linear_combo_lm, coeffs[0], w)
    _refused(FK.synthetic_div_lm, coeffs[0, 0], pt, pt)
    _refused(FK.synthetic_div_lm, coeffs, pt[:15], pt)
    _refused(FK.synthetic_div_lm, coeffs, pt, pt[:8])
    # K13's groups: a column past the stack, sizes and columns or weights
    # disagreeing, an empty group, an addend of the wrong groups, cols
    # without sizes
    stack, w3 = _t(_vals((4, 8), 6)), _t(_vals((3,), 7))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1, 4], (1, 2))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1], (1, 2))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1, 2], (1, 1))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1, 2], (3, 0))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1, 2], (1, 2), _t(_vals((3, 8), 8)))
    _refused(FK.linear_combo_lm, stack, w3, "fp", [0, 1, 2])
    _refused(FK.linear_combo_lm, stack[:2], w3, "fp", None, (3,))


def test_lead_rows_reads_a_shared_row_in_place():
    """A shared point's powers (n, 16) broadcast to a (2, 3) stack: the
    kernels read them through a row stride of 0, no copy."""
    pw = _t(_vals((5,), 5)).clone()
    v = FK._lead_rows(pw, (2, 3), (5, 16))
    assert v.shape == (6, 5, 16) and v.stride()[0] == 0 and v.data_ptr() == pw.data_ptr()
    assert torch.equal(v[4], pw)


def test_poly_source_is_built():
    assert "poly" in CK.SOURCES
    assert os.path.exists(os.path.join(CK.CSRC, "poly.cu"))
    for fn in ("taiga_eval_polys", "taiga_linear_combo", "taiga_synthetic_div"):
        assert fn in CK._ARGTYPES["poly"]
