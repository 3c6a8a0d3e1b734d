"""ec_ladder (K7 chained with the doubling: the whole double-and-add ladder
in one launch; taiga_tpu_torch.ops.ff_kernels.ec_ladder_lm) through its
plain version on the CPU, held to its contract: per lane, acc = (0, 0, 0);
for bit i of the lane's scalar, LSB first, acc = bit ? acc + base : acc,
then, except after the last bit, base = 2 base.

Both bit modes, on both fields: one scalar shared by every lane, and one a
lane per column (C = 2 columns over n = 8 points), against the host group
law; the scalars 0, 1, q - 1, q (the last add meets the negation of the
sum) and 2^254, identity base lanes, fewer bits than 255; a lane whose bits
are all 0 is (0, 0, 0) limb for limb; ec_ladder_plain limb for limb against
the step-by-step loop of ec_add_select_plain and ec_double_plain that the
ladders ran before. The host group law is the JAX package's pure-Python
curves (taiga_tpu.crypto.curves): the same inputs through the reference's
own code, with no XLA compile. The `slow` case holds the bitserial MSM on the ladder
limb for limb against the JAX package's (taiga_tpu/parallel/sharded.py
_local_msm_bitserial, through sharded_msm_multi on a one-device CPU mesh):
an XLA compile of its 255-step loop."""

import random

import numpy as np
import pytest
import torch

from taiga_tpu.crypto.curves import PallasPoint, VestaPoint
from taiga_tpu_torch.ops import ec as TE, ff_kernels as FK, limbs as TL
from taiga_tpu_torch.parallel import sharded as SH

CURVES = {"fp": PallasPoint, "fq": VestaPoint}
N_POINTS, COLS = 8, 2
IDENTITY_LANE = 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(field: str, seed: int = 21):
    """N_POINTS of the JAX package's host points (one the identity) and
    their Jacobian limb-major (16, n) Montgomery coordinates with random Z;
    the identity as (0, 1, 0)."""
    rng = random.Random(seed)
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    pts = [curve.random(rng) for _ in range(N_POINTS)]
    pts[IDENTITY_LANE] = curve.identity()
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


def _host(field: str, lm):
    """Limb-major (16, B) Jacobian coordinates -> the JAX package's affine
    host points."""
    curve, spec = CURVES[field], TL.FIELDS[field]
    p, F = spec.modulus, curve.FIELD
    out = []
    for x, y, z in zip(*(spec.array_from_mont(v.T) for v in lm)):
        if z == 0:
            out.append(curve.identity())
        else:
            zi = pow(z, -1, p)
            out.append(curve(F(x * zi * zi % p), F(y * pow(zi, 3, p) % p)))
    return out


def _edge_scalars(field: str) -> list[int]:
    q = CURVES[field].SCALAR.MODULUS
    return [0, 1, q - 1, q, 1 << 254]


@pytest.mark.parametrize("case", range(5), ids=["0", "1", "q-1", "q", "2^254"])
@pytest.mark.parametrize("field", ["fp", "fq"])
def test_shared_scalar_matches_host_group_law(field, case):
    """One scalar for every lane (lane stride 0): [s] P on each lane, the
    identity lane included."""
    s = _edge_scalars(field)[case]
    pts, base = _points(field)
    got = FK.ec_ladder_lm(*base, torch.as_tensor(TL.int_to_limbs(s)), field=field)
    assert all(v.shape == (16, N_POINTS) for v in got)
    assert _host(field, got) == [pt * s for pt in pts]
    if s == 0:
        assert all(int(v.abs().sum()) == 0 for v in got)


def _lane_scalars(field: str, seed: int = 22) -> list[list[int]]:
    """(COLS, N_POINTS) scalars: the edge scalars in column 0, 0 on the
    identity point of column 1 and on one other lane, random elsewhere."""
    rng = random.Random(seed)
    sc = [[rng.getrandbits(255) for _ in range(N_POINTS)] for _ in range(COLS)]
    for i, s in enumerate(_edge_scalars(field)):
        sc[0][i] = s
    sc[1][IDENTITY_LANE] = 0
    sc[1][6] = 0
    return sc


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_per_lane_scalars_match_host_group_law(field):
    """One scalar a lane per column, (C, n, 16): lane c * n + j is
    [s_cj] P_j; a lane whose bits are all 0 is (0, 0, 0) limb for limb."""
    pts, base = _points(field)
    sc = _lane_scalars(field)
    sl = torch.as_tensor(np.stack([TL.ints_to_limbs(c) for c in sc]))
    got = FK.ec_ladder_lm(*base, sl, field=field)
    assert all(v.shape == (16, COLS * N_POINTS) for v in got)
    assert _host(field, got) == [pts[j] * sc[c][j] for c in range(COLS) for j in range(N_POINTS)]
    for c in range(COLS):
        for j in range(N_POINTS):
            if sc[c][j] == 0:
                assert all(int(v[:, c * N_POINTS + j].abs().sum()) == 0 for v in got)


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_fewer_bits_read_the_low_bits(field):
    """bits < 255: the ladder reads bits 0 .. bits-1 only, in both modes."""
    bits = 40
    pts, base = _points(field)
    sc = _lane_scalars(field)
    low = [[s % (1 << bits) for s in col] for col in sc]
    sl = torch.as_tensor(np.stack([TL.ints_to_limbs(c) for c in sc]))
    got = FK.ec_ladder_lm(*base, sl, bits, field)
    assert _host(field, got) == [pts[j] * low[c][j] for c in range(COLS) for j in range(N_POINTS)]
    s = sc[1][0]
    got = FK.ec_ladder_lm(*base, torch.as_tensor(TL.int_to_limbs(s)), bits, field)
    assert _host(field, got) == [pt * (s % (1 << bits)) for pt in pts]


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_plain_equals_step_by_step_loop(field):
    """ec_ladder_plain limb for limb against the loop it replaces: each
    step ec_add_select_plain (the lane's bit as sel) over the base repeated
    on every column, then ec_double_plain."""
    bits = 24
    _, base = _points(field)
    sc = _lane_scalars(field)
    sc[1][3] = (1 << bits) - 1  # every bit set
    sl = torch.as_tensor(np.stack([TL.ints_to_limbs(c) for c in sc]))
    limbs = sl.reshape(-1, 16)
    b = tuple(v.repeat(1, COLS) for v in base)
    acc = tuple(torch.zeros_like(v) for v in b)
    for i in range(bits):
        sel = ((limbs[:, i // 16] >> (i % 16)) & 1)[None].contiguous()
        acc = FK.ec_add_select_plain(*acc, *b, sel, field=field)
        if i + 1 < bits:
            b = FK.ec_double_plain(*b, field=field)
    for g, w in zip(FK.ec_ladder_plain(*base, sl, bits, field), acc):
        assert torch.equal(g, w)


def test_scalar_mul_shared_is_one_ladder():
    """ops/ec.py's ec_scalar_mul_shared is ec_ladder over the rows'
    transposes, with the scalar as numpy limbs or a tensor."""
    pts, base = _points("fq")
    rows = tuple(v.T.contiguous() for v in base)
    s = random.Random(23).getrandbits(32)
    want = FK.ec_ladder_lm(*base, torch.as_tensor(TL.int_to_limbs(s)), 32, "fq")
    for sl in (TL.int_to_limbs(s), torch.as_tensor(TL.int_to_limbs(s))):
        got = TE.ec_scalar_mul_shared(rows, sl, TL.FQ, bits=32)
        for g, w in zip(got, want):
            assert torch.equal(g, w.T)


def test_contract_is_checked():
    _, base = _points("fq")
    one = torch.as_tensor(TL.int_to_limbs(1))
    with pytest.raises(ValueError, match="scalars: shape"):
        FK.ec_ladder_lm(*base, one[:8], field="fq")
    with pytest.raises(ValueError, match="scalars: shape"):
        FK.ec_ladder_lm(*base, torch.zeros((2, N_POINTS + 1, 16), dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        FK.ec_ladder_lm(*base, one.to(torch.int64))
    with pytest.raises(ValueError, match="bits"):
        FK.ec_ladder_lm(*base, one, 257)
    got = FK.ec_ladder_lm(*base, one, 0)
    assert all(int(v.abs().sum()) == 0 for v in got)


@pytest.mark.slow
def test_bitserial_msm_equals_reference():
    """The port's _local_msm_bitserial (ec_ladder, then K6's halving tree)
    limb for limb against the JAX package's bitserial sharded_msm_multi on
    a one-device CPU mesh, whose fold of one partial is the partial."""
    import jax.numpy as jnp

    from taiga_tpu.parallel import sharded as JS

    _, base = _points("fq")
    sc = _lane_scalars("fq")
    sl = np.stack([TL.ints_to_limbs(c) for c in sc])
    rows = [np.ascontiguousarray(v.T.numpy()) for v in base]
    got = SH._local_msm_bitserial(*(torch.as_tensor(r) for r in rows), torch.as_tensor(sl), "fq")
    want = JS.sharded_msm_multi(JS.make_mesh(1), *(jnp.asarray(r.astype(np.uint32)) for r in rows),
                                jnp.asarray(sl.astype(np.uint32)), field="fq",
                                strategy="bitserial")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
