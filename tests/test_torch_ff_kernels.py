"""Plain versions of the port's field and point kernels (K1 mont_mul_lm, K2
ec_add_proj_lm, K3 ec_add_proj_sel_lm; taiga_tpu_torch.ops.ff_kernels)
against the JAX package's kernels of the same name, both fields, exact
equality. A wrapper takes its plain version only because its tensors lie on
the CPU; the CUDA kernels are held against these plain versions on the card
by chip_smoke.py.

The JAX side runs with jit disabled: the same kernel math, op by op, without
the half-minute XLA compile of the unrolled point formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.crypto.curves import PallasPoint, VestaPoint
from taiga_tpu.ops import ff_kernels as JFK
from taiga_tpu_torch.ops import ff_kernels as TFK
from taiga_tpu_torch.ops import limbs as TL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 64
CURVES = {"fp": PallasPoint, "fq": VestaPoint}


def _elems(rng, spec):
    x = rng.integers(0, 1 << 16, size=(16, B), dtype=np.int64)
    x[15] &= 0x3FFF
    for i, v in enumerate((0, 1, spec.modulus - 1, spec.r)):
        x[:, i] = TL.int_to_limbs(v)
    return x


def _points(rng, field):
    """Two (3, 16, B) projective point sets in Montgomery form: random
    multiples of the generator scaled by a random z, the identity (0:1:0)
    in lanes 0-2, P + P in lanes 3-4, P + (-P) in lanes 5-6."""
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    g = curve.generator()

    def rand_set():
        xs, ys, zs = [], [], []
        for _ in range(B):
            pt = g * int(rng.integers(1, 1 << 62))
            lam = int(rng.integers(1, 1 << 62))
            xs.append(pt.x.v * lam % p)
            ys.append(pt.y.v * lam % p)
            zs.append(lam)
        return [spec.array_to_mont(v).T.astype(np.int64) for v in (xs, ys, zs)]

    p1, p2 = rand_set(), rand_set()
    ident = [TL.int_to_limbs(0), spec.one_mont, TL.int_to_limbs(0)]
    for lane, sets in ((0, (p1,)), (1, (p2,)), (2, (p1, p2))):
        for s in sets:
            for c in range(3):
                s[c][:, lane] = ident[c]
    for c in range(3):
        p2[c][:, 3:7] = p1[c][:, 3:7]
    p2[1][:, 5:7] = spec.array_to_mont([(-v) % p for v in spec.array_from_mont(p1[1][:, 5:7].T)]).T
    return p1, p2


def _to_affine(field, x, y, z):
    curve, spec = CURVES[field], TL.FIELDS[field]
    F = curve.FIELD
    out = []
    for X, Y, Z in zip(*(spec.array_from_mont(v.T) for v in (x, y, z))):
        if Z == 0:
            out.append(curve.identity())
        else:
            zi = pow(Z, -1, F.MODULUS)
            out.append(curve(F(X * zi % F.MODULUS), F(Y * zi % F.MODULUS)))
    return out


def _jax(fn, *arrs, **kw):
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a.astype(np.uint32)) for a in arrs), **kw)
    return [np.asarray(o).astype(np.int64) for o in (out if isinstance(out, tuple) else (out,))]


def _torch(fn, *arrs, **kw):
    out = fn(*(torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)) for a in arrs), **kw)
    return [o.numpy().astype(np.int64) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_mont_mul_plain_matches_reference(field):
    rng = np.random.default_rng(11)
    spec = TL.FIELDS[field]
    a, b = _elems(rng, spec), _elems(rng, spec)
    b[:, :4] = a[:, [3, 2, 1, 0]]  # edge values against edge values
    got = _torch(TFK.mont_mul_lm, a, b, field=field)
    np.testing.assert_array_equal(got[0], _jax(JFK.mont_mul_lm, a, b, field=field)[0])


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_add_proj_plain_matches_reference(field):
    rng = np.random.default_rng(12)
    p1, p2 = _points(rng, field)
    got = _torch(TFK.ec_add_proj_lm, *p1, *p2, field=field)
    want = _jax(JFK.ec_add_proj_lm, *p1, *p2, field=field)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the sum is the group sum of the host curve arithmetic, lane by lane
    sums = [a + b for a, b in zip(_to_affine(field, *p1), _to_affine(field, *p2))]
    assert _to_affine(field, *got) == sums
    assert all(pt.is_identity() for pt in (sums[2], sums[5], sums[6]))


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_add_proj_sel_plain_matches_reference(field):
    rng = np.random.default_rng(13)
    p1, p2 = _points(rng, field)
    sel = rng.integers(0, 2, size=(1, B)).astype(np.int64)
    got = _torch(TFK.ec_add_proj_sel_lm, *p1, *p2, sel, field=field)
    want = _jax(JFK.ec_add_proj_sel_lm, *p1, *p2, sel, field=field)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keep = sel[0] == 0
    for g, a in zip(got, p1):
        np.testing.assert_array_equal(g[:, keep], a[:, keep])


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        TFK.mont_mul_lm(a.long(), a)
    with pytest.raises(ValueError):
        TFK.mont_mul_lm(a, torch.zeros((16, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        TFK.mont_mul_lm(a, torch.zeros((8, 16), dtype=torch.int32).T)
    with pytest.raises(ValueError):
        TFK.ec_add_proj_sel_lm(a, a, a, a, a, a, torch.zeros((2, 8), dtype=torch.int32))


def test_plain_versions_leave_cpu_results_unchanged():
    rng = np.random.default_rng(14)
    a, b = (torch.as_tensor(_elems(rng, TL.FQ).astype(np.int32)) for _ in range(2))
    want = TFK.mont_mul_lm(a, b)
    with TFK.plain_versions():
        assert torch.equal(TFK.mont_mul_lm(a, b), want)
    assert TFK.mont_mul_lm.launches == 0  # a CPU call never counts as a launch
