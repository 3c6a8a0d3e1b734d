"""Plain versions of the port's field and point kernels (K1 mont_mul_lm, K2
ec_add_proj_lm, K3 ec_add_proj_sel_lm, K5 ec_fold_shared_lm, K6 ec_add_lm,
K7 ec_add_select_lm; taiga_tpu_torch.ops.ff_kernels) against the JAX
package's kernels of the same name, both fields, exact equality; and K2
chained (ec_horner_lm) against the loop of K2 adds it replaces. A wrapper
takes its plain version only because its tensors lie on the CPU; the CUDA
kernels are held against these plain versions on the card by chip_smoke.py.

The JAX side runs with jit disabled: the same kernel math, op by op, without
the half-minute XLA compile of the unrolled point formula. The fold K5 is
held against the curve arithmetic here; against the JAX package's compiled
fold (_ec_fold_shared_jit, two minutes of XLA compile per field) in the
`slow` tier."""

import random

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


def _jacobian_points(rng, field):
    """Two (3, 16, B) Jacobian point sets in Montgomery form: random
    multiples of the generator as (X l^2, Y l^3, l), the identity (Z = 0)
    in lanes 0-2, P + P in lanes 3-4 (two representatives of one point),
    P + (-P) in lanes 5-6."""
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    g = curve.generator()
    base1 = [g * int(rng.integers(1, 1 << 62)) for _ in range(B)]
    base2 = [g * int(rng.integers(1, 1 << 62)) for _ in range(B)]
    base2[3:7] = base1[3:7]

    def rand_set(base):
        xs, ys, zs = [], [], []
        for pt in base:
            lam = int(rng.integers(1, 1 << 62))
            xs.append(pt.x.v * lam * lam % p)
            ys.append(pt.y.v * lam * lam * lam % p)
            zs.append(lam)
        return [spec.array_to_mont(v).T.astype(np.int64) for v in (xs, ys, zs)]

    p1, p2 = rand_set(base1), rand_set(base2)
    ident = [TL.int_to_limbs(0), spec.one_mont, TL.int_to_limbs(0)]
    for lane, sets in ((0, (p1,)), (1, (p2,)), (2, (p1, p2))):
        for s_ in sets:
            for c in range(3):
                s_[c][:, lane] = ident[c]
    p2[1][:, 5:7] = spec.array_to_mont([(-v) % p for v in spec.array_from_mont(p2[1][:, 5:7].T)]).T
    return p1, p2


def _jacobian_to_affine(field, x, y, z):
    curve, spec = CURVES[field], TL.FIELDS[field]
    F = curve.FIELD
    out = []
    for X, Y, Z in zip(*(spec.array_from_mont(v.T) for v in (x, y, z))):
        if Z == 0:
            out.append(curve.identity())
        else:
            zi = pow(Z, -1, F.MODULUS)
            out.append(curve(F(X * zi * zi % F.MODULUS), F(Y * zi ** 3 % F.MODULUS)))
    return out


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_add_plain_matches_reference(field):
    """K6 (Jacobian, both formulas then select) against the JAX package's
    ec_add_lm, and against the host group law lane by lane."""
    rng = np.random.default_rng(15)
    p1, p2 = _jacobian_points(rng, field)
    got = _torch(TFK.ec_add_lm, *p1, *p2, field=field)
    want = _jax(JFK.ec_add_lm, *p1, *p2, field=field)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sums = [a + b for a, b in zip(_jacobian_to_affine(field, *p1), _jacobian_to_affine(field, *p2))]
    assert _jacobian_to_affine(field, *got) == sums
    assert sums[3] == _jacobian_to_affine(field, *p1)[3].double()
    assert all(pt.is_identity() for pt in (sums[2], sums[5], sums[6]))


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_add_select_plain_matches_reference(field):
    rng = np.random.default_rng(16)
    p1, p2 = _jacobian_points(rng, field)
    sel = rng.integers(0, 2, size=(1, B)).astype(np.int64)
    sel[0, :7] = 1
    got = _torch(TFK.ec_add_select_lm, *p1, *p2, sel, field=field)
    want = _jax(JFK.ec_add_select_lm, *p1, *p2, sel, field=field)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keep = sel[0] == 0
    for g, a in zip(got, p1):
        np.testing.assert_array_equal(g[:, keep], a[:, keep])


FOLD_B = 5


def _fold_inputs(field, s_val, seed):
    """G_lo, G_hi as (3, 16, 5) projective Montgomery points: the identity
    in G_lo (lane 0), G_hi (1) and both (2); G_lo = -[s] G_hi in lane 3,
    whose fold is the identity; random points scaled by a random z in lane 4."""
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    rnd = random.Random(seed)
    g = curve.generator()
    hi = [g * rnd.getrandbits(64) for _ in range(FOLD_B)]
    lo = [g * rnd.getrandbits(64) for _ in range(FOLD_B)]
    lo[0] = hi[1] = lo[2] = hi[2] = curve.identity()
    lo[3] = -(hi[3] * s_val)

    def proj(pts):
        xs, ys, zs = [], [], []
        for pt in pts:
            lam = rnd.getrandbits(64) + 1
            xs.append(0 if pt.is_identity() else pt.x.v * lam % p)
            ys.append(lam if pt.is_identity() else pt.y.v * lam % p)
            zs.append(0 if pt.is_identity() else lam)
        return [spec.array_to_mont(v).T.astype(np.int64) for v in (xs, ys, zs)]

    return lo, hi, proj(lo), proj(hi)


def _fold_scalars(field, seed):
    q = CURVES[field].SCALAR.MODULUS
    return [0, 1, q - 1, random.Random(seed).getrandbits(255) % q]


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_fold_shared_plain_matches_curve_arithmetic(field):
    """K5: G_lo + [s] G_hi lane by lane, as group elements, for s = 0, 1,
    q - 1 and a random s, with identities and a lane that sums to the
    identity."""
    for i, s_val in enumerate(_fold_scalars(field, 17)):
        lo, hi, lo_d, hi_d = _fold_inputs(field, s_val, 100 + i)
        sl = TL.int_to_limbs(s_val)[None].astype(np.int64)
        got = _torch(TFK.ec_fold_shared_lm, *lo_d, *hi_d, sl, field=field)
        want = [a + b * s_val for a, b in zip(lo, hi)]
        assert _to_affine(field, *got) == want, f"s = {s_val}"
        assert want[3].is_identity()


@pytest.mark.slow
@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_fold_shared_plain_matches_reference(field):
    """K5 against the JAX package's fold body, called through
    _ec_fold_shared_jit so that its XLA body runs (ec_fold_shared_lm takes a
    host branch below 513 lanes), at B = 128, bit for bit."""
    rng = np.random.default_rng(18)
    p1, p2 = _points(rng, field)
    lo = [np.concatenate([v, v], axis=1) for v in p1]
    hi = [np.concatenate([v, v[:, ::-1]], axis=1) for v in p2]
    for s_val in _fold_scalars(field, 19):
        sl = TL.int_to_limbs(s_val)[None].astype(np.int64)
        got = _torch(TFK.ec_fold_shared_lm, *lo, *hi, sl, field=field)
        want = [np.asarray(o).astype(np.int64) for o in JFK._ec_fold_shared_jit(
            *(jnp.asarray(a.astype(np.uint32)) for a in lo + hi),
            jnp.asarray(sl.astype(np.uint32)), field=field)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"s = {s_val}")


def test_fold_wrapper_rejects_bad_scalar():
    a = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TFK.ec_fold_shared_lm(a, a, a, a, a, a, torch.zeros((16, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        TFK.ec_fold_shared_lm(a, a, a, a, a, a, torch.zeros((1, 16), dtype=torch.int64))


def _horner_loop(terms, doublings, field):
    """The loop of K2 adds that ec_horner replaces (the MSMs' Horners)."""
    acc = tuple(v[:, -1].contiguous() for v in terms)
    for w in range(terms[0].shape[1] - 2, -1, -1):
        for _ in range(doublings):
            acc = TFK.ec_add_proj_lm(*acc, *acc, field=field)
        acc = TFK.ec_add_proj_lm(*acc, *(v[:, w].contiguous() for v in terms), field=field)
    return acc


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("W,d,Lc", [(32, 8, 2), (8, 1, 8)], ids=["windows", "bits"])
def test_ec_horner_plain_equals_the_k2_loop(field, W, d, Lc):
    """The chained Horner at the MSMs' shapes (32 windows of 8 doublings,
    8 bits of 1), limb for limb, with identity terms: the most significant
    term of column 0 (the chain starts at the identity) and a middle term of
    the last column."""
    rng = np.random.default_rng(20 + W)
    p1, _ = _points(rng, field)  # 64 lanes: W * Lc of them
    terms = [v[:, : W * Lc].reshape(16, W, Lc) for v in p1]
    ident = [TL.int_to_limbs(0), TL.FIELDS[field].one_mont, TL.int_to_limbs(0)]
    for c in range(3):
        terms[c][:, W - 1, 0] = ident[c]
        terms[c][:, W // 2, Lc - 1] = ident[c]
    t = [torch.as_tensor(np.ascontiguousarray(v, dtype=np.int32)) for v in terms]
    got = TFK.ec_horner_lm(*t, d, field=field)
    want = _horner_loop(t, d, field)
    for g, w in zip(got, want):
        assert g.shape == (16, Lc) and g.is_contiguous()
        assert torch.equal(g, w)
    # the chain's sum, as a group element: sum_w [2^(d w)] term_w
    pts = list(zip(*(_to_affine(field, *(v[:, w] for v in terms)) for w in range(W))))
    sums = [sum((pt * (1 << (d * w)) for w, pt in enumerate(col)), CURVES[field].identity())
            for col in pts]
    assert _to_affine(field, *(g.numpy().astype(np.int64) for g in got)) == sums


def test_ec_horner_wrapper_rejects_bad_inputs():
    t = torch.zeros((16, 4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        TFK.ec_horner_lm(t.long(), t, t, 1)
    with pytest.raises(ValueError):  # not (16, W, L)
        TFK.ec_horner_lm(t[:, 0], t[:, 0], t[:, 0], 1)
    with pytest.raises(ValueError):  # shapes differ
        TFK.ec_horner_lm(t, t, t[:, :3].contiguous(), 1)
    with pytest.raises(ValueError):  # not contiguous
        nc = torch.zeros((16, 2, 4), dtype=torch.int32).transpose(1, 2)
        TFK.ec_horner_lm(nc, nc, nc, 1)
    with pytest.raises(ValueError):  # no term
        e = torch.zeros((16, 0, 2), dtype=torch.int32)
        TFK.ec_horner_lm(e, e, e, 1)
    with pytest.raises(ValueError):
        TFK.ec_horner_lm(t, t, t, -1)
    assert TFK.ec_horner_lm.launches == 0  # a CPU call never counts as a launch


def test_ec_seg_rounds_wrapper_rejects_bad_inputs():
    p = torch.zeros((16, 2, 256), dtype=torch.int32)
    keys = torch.zeros((2, 256), dtype=torch.int64)
    TFK.ec_seg_rounds_lm(p, p, p, keys, 7, tile=128)  # rows of 256 lanes, tiles of 128
    with pytest.raises(ValueError):  # int32 keys
        TFK.ec_seg_rounds_lm(p, p, p, keys.int(), 1)
    with pytest.raises(ValueError):  # keys of another shape
        TFK.ec_seg_rounds_lm(p, p, p, keys[:1], 1)
    with pytest.raises(ValueError):  # limbs not on the first axis
        q = torch.zeros((8, 2, 256), dtype=torch.int32)
        TFK.ec_seg_rounds_lm(q, q, q, keys, 1)
    with pytest.raises(ValueError):
        TFK.ec_seg_rounds_lm(p, p, p, keys, -1)
    for tile, rounds in ((96, 1), (256, 1), (128, 8), (-128, 1)):
        with pytest.raises(ValueError, match="tile"):  # not a power of two <= 128; 2^8 > 128
            TFK.ec_seg_rounds_lm(p, p, p, keys, rounds, tile=tile)
    with pytest.raises(ValueError, match="tile"):  # rows of 192 lanes: not a multiple of 128
        r = torch.zeros((16, 192), dtype=torch.int32)
        TFK.ec_seg_rounds_lm(r, r, r, torch.zeros(192, dtype=torch.int64), 1, tile=128)
    assert TFK.ec_seg_rounds_lm.launches == 0  # a CPU call never counts as a launch


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ec_dbl_proj_plain_equals_k2_doubling(field):
    """The kernels' P = Q form of the RCB add (ff_kernels._ec_dbl_proj_core,
    mirroring csrc/ec_group.cuh's ec_dbl_proj_group) equals K2's plain
    version ec_add_proj_plain(P, P) limb for limb: 256 seeded curve points
    scaled by a random z, the identity (0 : 1 : 0), (0 : 0 : 0), and 64
    random canonical triples off the curve (the two are the same
    polynomials). No Pasta point has y = 0: such a point has order 2, and
    both curves' orders are prime."""
    rng = np.random.default_rng(90 if field == "fp" else 91)
    curve, spec = CURVES[field], TL.FIELDS[field]
    p = spec.modulus
    g = curve.generator()
    cols = [[], [], []]
    for _ in range(256):
        pt = g * int(rng.integers(1, 1 << 62))
        lam = int(rng.integers(1, 1 << 62))
        for c, v in enumerate((pt.x.v * lam % p, pt.y.v * lam % p, lam)):
            cols[c].append(v)
    for c, v in enumerate((0, 1, 0)):  # the identity, as coordinates before Montgomery form
        cols[c].append(v)
    for c in range(3):
        cols[c].append(0)
    lm = [spec.array_to_mont(v).T.astype(np.int64) for v in cols]
    off = rng.integers(0, 1 << 16, size=(3, 16, 64), dtype=np.int64)
    off[:, 15] &= 0x3FFF
    pts = [torch.as_tensor(np.concatenate([a, o], 1).astype(np.int32)) for a, o in zip(lm, off)]
    assert torch.equal(pts[1][:, 256], torch.as_tensor(spec.one_mont.astype(np.int32)))
    got = TFK._ec_dbl_proj_core(*pts, field)
    want = TFK.ec_add_proj_plain(*pts, *pts, field=field)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    # as group elements: 2P on the sampled curve lanes, the identity stays
    doubled = _to_affine(field, *(v[:, :257].numpy().astype(np.int64) for v in got))
    assert doubled[:4] == [pt + pt for pt in _to_affine(field, *(v[:, :4].numpy()
                                                                 .astype(np.int64)
                                                                 for v in pts))]
    assert doubled[256].is_identity()


def _bucket_loop(bx, by, bz, c, field):
    """The bucket weighting ec_bucket_weights replaced in ops/msm.py's
    _bucket_sums: buckets (16, L 2^c) masked by each bit of the digit,
    the K2 roll-add tree over all 2^c lanes of every (bit, column) row,
    then ec_horner_plain over lane 0 of each row."""
    n = 1 << c
    Lc = bx.shape[1] // n
    one = TL.FIELDS[field].one_col("cpu")
    bits = torch.arange(c)
    keep = (((torch.arange(n)[None, :] >> bits[:, None]) & 1) > 0)  # (c, n)
    k = keep[:, None, :].expand(c, Lc, n).reshape(-1)
    t = [v.reshape(16, 1, Lc, n).expand(16, c, Lc, n).reshape(16, -1) for v in (bx, by, bz)]
    t = [torch.where(k, t[0], 0), torch.where(k, t[1], one), torch.where(k, t[2], 0)]
    sh3 = (16, c * Lc, n)
    for r in range(c):
        nxt = [torch.roll(v.reshape(sh3), -(1 << r), dims=-1).reshape(16, -1) for v in t]
        t = list(TFK.ec_add_proj_plain(*t, *nxt, field=field))
    sel = torch.arange(c * Lc) * n
    terms = [v.index_select(1, sel).reshape(16, c, Lc).contiguous() for v in t]
    return TFK.ec_horner_plain(*terms, 1, field)


@pytest.mark.parametrize("c", [2, 4, 8])
@pytest.mark.parametrize("Lc", [1, 3, 8])
def test_ec_bucket_weights_plain_equals_the_old_loop(c, Lc):
    """ec_bucket_weights_plain (each bit row's aligned tree, then the Horner
    over the bits) against the K2 roll-add tree and Horner it replaced in
    _bucket_sums, limb for limb, with empty buckets (the identity, as
    _bucket_sums masks a bucket no digit hit) and bucket 0 among them; and
    as group elements, sum_j j B_j, on the first column."""
    field = "fq" if (c + Lc) % 2 else "fp"
    rng = np.random.default_rng(100 + 10 * c + Lc)
    spec = TL.FIELDS[field]
    n = 1 << c
    p1, _ = _points(rng, field)  # 64 curve points: lanes drawn from them
    idx = rng.integers(3, B, size=Lc * n)
    pts = [v[:, idx].copy() for v in p1]
    empty = rng.random(Lc * n) < 0.25
    empty[::n] = True  # bucket 0: no weight, always empty in the MSMs
    for c_, v in enumerate((TL.int_to_limbs(0), spec.one_mont, TL.int_to_limbs(0))):
        pts[c_][:, empty] = np.asarray(v)[:, None]
    t = [torch.as_tensor(np.ascontiguousarray(v, dtype=np.int32)) for v in pts]
    got = TFK.ec_bucket_weights_lm(*t, c, field)
    want = _bucket_loop(*t, c, field)
    for g, w in zip(got, want):
        assert g.shape == (16, Lc) and torch.equal(g, w)
    col = _to_affine(field, *(v[:, :n] for v in pts))
    weighted = sum((pt * j for j, pt in enumerate(col)), CURVES[field].identity())
    assert _to_affine(field, *(g[:, :1].numpy().astype(np.int64) for g in got)) == [weighted]


def test_ec_bucket_weights_wrapper_rejects_bad_inputs():
    t = torch.zeros((16, 3 * 16), dtype=torch.int32)
    TFK.ec_bucket_weights_lm(t, t, t, 4)  # 3 columns of 16 buckets
    for c in (0, 9):
        with pytest.raises(ValueError, match="c ="):
            TFK.ec_bucket_weights_lm(t, t, t, c)
    with pytest.raises(ValueError, match="columns"):  # 48 lanes are not columns of 32
        TFK.ec_bucket_weights_lm(t, t, t, 5)
    with pytest.raises(TypeError):
        TFK.ec_bucket_weights_lm(t.long(), t, t, 4)
    with pytest.raises(ValueError):  # shapes differ
        TFK.ec_bucket_weights_lm(t, t, t[:, :32].contiguous(), 4)
    assert TFK.ec_bucket_weights_lm.launches == 0  # a CPU call never counts as a launch
