"""The port's group law (taiga_tpu_torch.ops.ec) against the JAX package's
(taiga_tpu.ops.ec) and the host curve classes, limb for limb, on the CPU,
where every helper runs the plain versions of its kernels (K6, K7, the
doubling).

Inputs are Jacobian rows with random Z, and edge lanes: the identity on
either side and both, P = Q (two representatives of one point) and P = -Q. The JAX package's helpers run
eagerly at one shape (8 lanes); its scalar ladder (255 steps of a compiled
loop) is compared in the `slow` tier only: the full ladder is held against
the host group law in tier 1."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import ec as JE, limbs as JL
from taiga_tpu_torch.crypto.curves import PallasPoint, VestaPoint
from taiga_tpu_torch.ops import ec as TE, ff_kernels as FK, limbs as TL

CURVES = {"fp": PallasPoint, "fq": VestaPoint}
JSPECS = {"fp": JL.FP, "fq": JL.FQ}
LANES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jacobian(points, zs, field: str) -> tuple:
    """Host points -> Jacobian Montgomery rows (X z^2, Y z^3, z); the
    identity as (0, 1, 0), as points_to_device writes it."""
    spec = TL.FIELDS[field]
    p = spec.modulus
    xs, ys, out_z = [], [], []
    for pt, z in zip(points, zs):
        if pt.is_identity():
            xs.append(0), ys.append(1), out_z.append(0)
        else:
            xs.append(pt.x.v * z * z % p)
            ys.append(pt.y.v * pow(z, 3, p) % p)
            out_z.append(z)
    return tuple(spec.array_to_mont(v) for v in (xs, ys, out_z))


def _edge_inputs(field: str, seed: int = 5):
    """Two (8, 16) x3 Jacobian points: lane 0 P + identity, 1 identity + Q,
    2 identity + identity, 3 P = Q (other Z), 4 P = -Q, 5-7 random."""
    rng = random.Random(seed)
    curve = CURVES[field]
    p = TL.FIELDS[field].modulus
    ps = [curve.random(rng) for _ in range(LANES)]
    qs = [curve.random(rng) for _ in range(LANES)]
    qs[0] = curve.identity()
    ps[1] = curve.identity()
    ps[2] = qs[2] = curve.identity()
    qs[3] = ps[3]
    qs[4] = -ps[4]
    zp = [rng.randrange(1, p) for _ in range(LANES)]
    zq = [rng.randrange(1, p) for _ in range(LANES)]
    return ps, qs, _jacobian(ps, zp, field), _jacobian(qs, zq, field)


def _t(rows):
    return tuple(torch.as_tensor(r) for r in rows)


def _j(rows):
    return tuple(jnp.asarray(r.astype(np.uint32)) for r in rows)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_add_double_select_neg_equal_reference(field):
    ps, qs, pr, qr = _edge_inputs(field)
    spec, jspec = TL.FIELDS[field], JSPECS[field]
    got = TE.ec_add(_t(pr), _t(qr), spec)
    _same(got, JE.ec_add(_j(pr), _j(qr), jspec))
    assert TE.points_from_device(got, CURVES[field]) == [a + b for a, b in zip(ps, qs)]
    dbl = TE.ec_double(_t(pr), spec)
    _same(dbl, JE.ec_double(_j(pr), jspec))
    assert TE.points_from_device(dbl, CURVES[field]) == [a + a for a in ps]
    cond = np.array([True, False] * (LANES // 2))
    _same(TE.ec_select(torch.as_tensor(cond), _t(pr), _t(qr)),
          JE.ec_select(jnp.asarray(cond), _j(pr), _j(qr)))
    _same(TE.ec_neg(_t(pr), spec), JE.ec_neg(_j(pr), jspec))
    _same(TE.ec_identity_like(_t(pr)), JE.ec_identity_like(_j(pr)))


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_add_broadcasts_and_keeps_batch_shape(field):
    """(2, 4) lanes against one point broadcast over them."""
    _, _, pr, qr = _edge_inputs(field)
    spec = TL.FIELDS[field]
    p = tuple(v.reshape(2, 4, 16) for v in _t(pr))
    q = tuple(v[5] for v in _t(qr))
    got = TE.ec_add(p, q, spec)
    assert got[0].shape == (2, 4, 16)
    want = TE.ec_add(_t(pr), tuple(v[5].expand(LANES, 16) for v in _t(qr)), spec)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(LANES, 16), w)


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_kernel_plain_versions_on_limb_major_input(field):
    """K6's, K7's and the doubling's plain versions on (16, B) transposes
    equal the row-major helpers (and so the reference)."""
    _, _, pr, qr = _edge_inputs(field)
    spec = TL.FIELDS[field]
    lm = [torch.as_tensor(np.ascontiguousarray(r.T)) for r in pr + qr]
    want = TE.ec_add(_t(pr), _t(qr), spec)
    for g, w in zip(FK.ec_add_plain(*lm, field=field), want):
        assert torch.equal(g.T, w)
    sel = torch.as_tensor([[1, 0, 1, 1, 0, 1, 0, 1]], dtype=torch.int32)
    for g, w, p1 in zip(FK.ec_add_select_plain(*lm, sel, field=field), want, _t(pr)):
        assert torch.equal(g.T, torch.where(sel[0, :, None] != 0, w, p1))
    for g, w in zip(FK.ec_double_plain(*lm[:3], field=field), TE.ec_double(_t(pr), spec)):
        assert torch.equal(g.T, w)
    none = torch.zeros_like(sel)
    for g, p1 in zip(FK.ec_add_select_plain(*lm, none, field=field), lm[:3]):
        assert torch.equal(g, p1)


def test_double_of_identity_is_not_k6_of_p_p():
    """The doubling keeps dbl-2009-l's limbs on an identity lane (Z3 = 0),
    where K6(P, P) returns P: the reason ec_double has its own kernel."""
    _, _, pr, _ = _edge_inputs("fq")
    spec = TL.FQ
    p = _t(pr)
    dbl = TE.ec_double(p, spec)
    k6 = TE.ec_add(p, p, spec)
    assert int(dbl[2][1].abs().sum()) == 0 and int(k6[2][1].abs().sum()) == 0
    assert not torch.equal(dbl[0][1], k6[0][1]) or not torch.equal(dbl[1][1], k6[1][1])
    _same(dbl, JE.ec_double(_j(pr), JL.FQ))


def _scalar_case(field: str):
    rng = random.Random(11)
    ps, _, pr, _ = _edge_inputs(field)
    s = (rng.getrandbits(255) | (1 << 254)) % CURVES[field].SCALAR.MODULUS
    return ps, pr, s


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_scalar_mul_shared_matches_host_group_law(field):
    """A full 255-bit ladder (K7 and the doubling each step) equals [s] P
    on the host for every lane, the identity lanes included."""
    ps, pr, s = _scalar_case(field)
    got = TE.ec_scalar_mul_shared(_t(pr), torch.as_tensor(TL.int_to_limbs(s)),
                                  TL.FIELDS[field])
    assert TE.points_from_device(got, CURVES[field]) == [pt * s for pt in ps]


@pytest.mark.slow
@pytest.mark.parametrize("field", ["fp", "fq"])
def test_scalar_mul_shared_equals_reference(field):
    """Limb for limb against the JAX package's compiled ladder."""
    _, pr, s = _scalar_case(field)
    got = TE.ec_scalar_mul_shared(_t(pr), TL.int_to_limbs(s), TL.FIELDS[field])
    want = JE.ec_scalar_mul_shared(_j(pr), jnp.asarray(JL.int_to_limbs(s)), JSPECS[field])
    _same(got, want)
