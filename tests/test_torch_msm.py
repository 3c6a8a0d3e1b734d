"""The port's MSMs (taiga_tpu_torch.ops.msm, through the plain versions of
K2/K3): the fixed-base path (the shifted SRS table and msm_fixed_multi) at
k = 9, and the general Pippenger (msm, msm_multi).

The reference for a commitment is the JAX package's own CPU commit path,
its native engine's Pippenger (taiga_tpu.native.hostops.msm, which
ProverPipeline.commit_coeff_rows takes on a CPU); the port's copy of that
engine and host curve arithmetic check it too. Window c = 8 (the prover's)
takes the segmented Hillis-Steele reduction at this size; c = 4 takes the
blocked reduction that c = 8 takes from k = 12 up. (The JAX package's
fixed-base path itself takes minutes of XLA compile on a CPU.)

The general MSM is held against the JAX package's host oracle msm_host as
group elements, and against the native engine at c = 8; bit for bit against
the JAX package's device MSMs (_msm_device, _msm_multi_device, whose XLA
compile takes minutes and many GB here) in the `slow` tier."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.crypto.curves import PallasPoint as JPallas, VestaPoint as JVesta
from taiga_tpu.native import FIELD_FQ as J_FQ, hostops as JH
from taiga_tpu.ops import msm as JM
from taiga_tpu.plonk.msm_claim import srs_host_rows as j_srs_rows
from taiga_tpu_torch.crypto.curves import PallasPoint, VestaPoint
from taiga_tpu_torch.plonk.ipa import _pad_pts_lm
from taiga_tpu_torch.native import FIELD_FQ, hostops as TH
from taiga_tpu_torch.ops import ec, ff_kernels as TFK, limbs as TL, msm as TM
from taiga_tpu_torch.plonk.msm_claim import srs_host_rows
from taiga_tpu_torch.plonk.srs import get_params, srs_device


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


@pytest.fixture(scope="module")
def srs():
    return tuple(torch.as_tensor(np.asarray(a, np.int32)) for a in srs_device(K))


@pytest.fixture(scope="module")
def tables(srs):
    return {c: TM.fixed_base_table(*srs, field="fq", c=c) for c in (8, 4)}


def _scalars(ncols, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << 16, size=(ncols, N, 16), dtype=np.int64)
    s[..., 15] &= 0x3FFF
    s[0, :3] = 0  # zero scalars share bucket 0 with nothing
    return s


def _native_commit(host, rows, field, plain):
    """One MSM per column on a native engine: affine (x, y) ints or None."""
    out = []
    for col in plain:
        x, y, inf = host.msm(field, rows, host.u16_to_u64(col.astype(np.uint32)))
        out.append(None if inf else (x, y))
    return out


def _affine(pts):
    return [None if p.is_identity() else (p.x.v, p.y.v) for p in pts]


@pytest.mark.parametrize("c,ncols", [(8, 3), (4, 1)], ids=["c8-hillis-steele", "c4-blocked"])
def test_msm_fixed_multi_matches_native_engines(tables, c, ncols):
    table = tables[c]
    assert table.shape == ((256 // c) * N, 16)
    s = _scalars(ncols, 50 + c)
    if ncols > 1:
        s[-1] = 0  # an all-zero column commits to the identity
    out = TM.msm_fixed_multi(table, torch.as_tensor(s.astype(np.int32)), field="fq", c=c)
    got = _affine(ec.points_from_device((out[:, 0], out[:, 1], out[:, 2]), VestaPoint))
    assert got == _native_commit(JH, j_srs_rows(K), J_FQ, s)
    assert got == _native_commit(TH, srs_host_rows(K), FIELD_FQ, s)
    if ncols > 1:
        assert got[-1] is None


def test_fixed_table_rows_are_shifted_generators(tables):
    """Row w*N + i holds the affine [2^(8w)] G_i as packed x | y words."""
    g = get_params(K).g
    table = tables[8]
    for w, i in ((0, 0), (1, 5), (17, 300), (31, N - 1)):
        row = table[w * N + i]
        x, y = (TL.FQ.array_from_mont(TL.unpack_limbs(row[h : h + 8])[None])[0] for h in (0, 8))
        want = g[i] * (1 << (8 * w))
        assert (x, y) == (want.x.v, want.y.v)


def test_fixed_table_asserts_finite_points(srs):
    x, y, z = (t.clone() for t in srs)
    z[3] = 0
    with pytest.raises(ValueError, match="finite"):
        TM.fixed_base_table(x, y, z, field="fq")


def test_point_codecs_round_trip():
    g = VestaPoint.generator()
    pts = [g, VestaPoint.identity(), g * 12345]
    xyz = ec.points_to_device(pts)
    back = ec.points_from_device(tuple(torch.as_tensor(v) for v in xyz), VestaPoint)
    assert back == pts


# --- the segmented rounds (K3 chained) ---------------------------------------

SEG_N, SEG_TILE, SEG_ROUNDS = 512, 128, 7


def _seg_inputs(field, seed):
    """Points (16, 512) x 3 (random elements, identities (0 : 1 : 0) at
    lanes 0-2 and 300-301) and keys: in lanes 0-255, runs that keep to their
    128-lane tile (block-local keys as _blocked_partials makes them, with
    single-lane runs at lanes 0, 127 and 128); in lanes 256-511, sorted runs
    that cross the tile edge at lane 384, with single-lane runs among them."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1 << 16, size=(3, 16, SEG_N), dtype=np.int64)
    pts[:, 15] &= 0x3FFF
    for lane in (0, 1, 2, 300, 301):
        pts[:, :, lane] = 0
        pts[1, :, lane] = TL.FIELDS[field].one_mont
    keys = np.zeros(SEG_N, np.int64)
    for blk in range(2):
        local = np.sort(rng.integers(1, 6, SEG_TILE))
        local[0], local[-1] = 0, 9
        keys[blk * SEG_TILE:(blk + 1) * SEG_TILE] = blk * 16 + local
    cuts = np.sort(rng.choice(np.arange(257, SEG_N), 12, replace=False))
    cuts = np.union1d(cuts, [300, 301, 302, 380])  # single-lane runs; a run over lane 384
    tail = np.zeros(SEG_N - 256, np.int64)
    for c in cuts:
        tail[c - 256:] += 1
    keys[256:] = 100 + tail
    return pts, keys


def _defined(keys, rounds, tile=0):
    """The lanes ec_seg_rounds defines: offset from the run's first lane a
    multiple of 2^rounds (a tile's first lane starts a run)."""
    return (TFK.seg_offsets(torch.as_tensor(keys), tile) % (1 << rounds) == 0).numpy()


def _j_seg_rounds(pts, keys, keys_tiled, field):
    """The JAX package's _seg_rounds over the keys and, in one call beside
    them on lanes of their own (keys shifted above), over the tiled keys."""
    both = np.concatenate([keys, keys_tiled + keys.max() + 1])
    with jax.disable_jit():
        out = JM._seg_rounds(*(jnp.asarray(np.concatenate([v, v], -1).astype(np.uint32))
                               for v in pts),
                             jnp.asarray(both.astype(np.int32)), 2 * SEG_N, SEG_ROUNDS, field)
    out = [np.asarray(w).astype(np.int64) for w in out]
    return [w[:, :SEG_N] for w in out], [w[:, SEG_N:] for w in out]


@pytest.mark.parametrize("field", ["fq", "fp"])
def test_seg_rounds_plain_match_reference(field):
    """ec_seg_rounds_plain against the JAX package's _seg_rounds (its
    non-Pallas path, eagerly), on every lane of both forms: a defined lane
    (offset from its run's first lane a multiple of 2^7) equals the
    reference; every other lane keeps its input. The tile form's reference
    is _seg_rounds over the keys cut at every tile edge."""
    pts, keys = _seg_inputs(field, 70 if field == "fq" else 71)
    tiles = np.arange(SEG_N) // SEG_TILE
    want, want_tiled = _j_seg_rounds(pts, keys, keys + tiles * (1 << 12), field)
    t = [torch.as_tensor(v.astype(np.int32)) for v in pts]
    kt = torch.as_tensor(keys)
    rounds = TFK.ec_seg_rounds_plain(*t, kt, SEG_ROUNDS, field)
    tiled = TFK.ec_seg_rounds_plain(*t, kt, SEG_ROUNDS, field, tile=SEG_TILE)
    for got, ref, tile in ((rounds, want, 0), (tiled, want_tiled, SEG_TILE)):
        d = _defined(keys, SEG_ROUNDS, tile)
        assert d.any() and not d.all()
        for g, w, p in zip(got, ref, pts):
            np.testing.assert_array_equal(g.numpy()[:, d], w[:, d])
            np.testing.assert_array_equal(g.numpy()[:, ~d], p[:, ~d])
    # the crossing run at lane 384 is cut by the tile edge in the tile form
    assert not np.array_equal(tiled[0].numpy()[:, 256:], want[0][:, 256:])
    # single-lane runs keep their point
    for lane in (0, 127, 128, 300, 301):
        for r, p in zip(rounds, t):
            np.testing.assert_array_equal(r[:, lane].numpy(), p[:, lane].numpy())


def _host_rcb(field):
    """K2's RCB add on host ints (Montgomery form, canonical): the
    oracle's own arithmetic, independent of the limb code."""
    spec = TL.FIELDS[field]
    p = spec.modulus
    rinv = pow(1 << 256, -1, p)

    def mm(a, b):
        return a * b * rinv % p

    def add(P, Q):
        (x1, y1, z1), (x2, y2, z2) = P, Q
        t0, t1, t2 = mm(x1, x2), mm(y1, y2), mm(z1, z2)
        t3 = (mm((x1 + y1) % p, (x2 + y2) % p) - t0 - t1) % p
        t4 = (mm((y1 + z1) % p, (y2 + z2) % p) - t1 - t2) % p
        yy = (mm((x1 + z1) % p, (x2 + z2) % p) - t0 - t2) % p
        t0, t2 = 3 * t0 % p, 15 * t2 % p
        zz, t1, yy = (t1 + t2) % p, (t1 - t2) % p, 15 * yy % p
        return ((mm(t3, t1) - mm(t4, yy)) % p, (mm(yy, t0) + mm(t1, zz)) % p,
                (mm(zz, t4) + mm(t0, t3)) % p)

    return add


def _seg_oracle(pts, keys, rounds, tile, field):
    """Each defined lane's aligned tree, step by step on host ints: the sum
    at lane i after r rounds is its sum after r - 1 rounds, plus lane
    i + 2^(r-1)'s where that lane is in i's run. Returns {(row, lane):
    (x, y, z)}."""
    add = _host_rcb(field)
    out = {}
    for row, k in enumerate(keys):
        n = len(k)
        end = np.empty(n, np.int64)  # one past each lane's run
        for i in range(n - 1, -1, -1):
            cut = i + 1 == n or k[i + 1] != k[i] or (tile and (i + 1) % tile == 0)
            end[i] = i + 1 if cut else end[i + 1]

        def tree(i, r, row=row, end=end):
            if r == 0:
                return tuple(sum(int(pts[c, j, row, i]) << (16 * j) for j in range(16))
                             for c in range(3))
            acc = tree(i, r - 1)
            j = i + (1 << (r - 1))
            return add(acc, tree(j, r - 1)) if j < end[i] else acc

        for i in np.nonzero(_defined(k[None], rounds, tile)[0])[0]:
            out[(row, int(i))] = tree(int(i), rounds)
    return out


SEG_ORACLE_N = 256


def _oracle_inputs(seed):
    """Points (3, 16, 2, 256): row 0 with sorted runs of 1-40 lanes that
    cross the 128-lane tile edges, single-lane runs among them; row 1 one
    run as long as the row."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1 << 16, size=(3, 16, 2, SEG_ORACLE_N), dtype=np.int64)
    pts[:, 15] &= 0x3FFF
    lens = []
    while sum(lens) < SEG_ORACLE_N:
        lens.append(int(rng.choice([1, 1, 2, 3, 7, 17, 40])))
    keys = np.zeros((2, SEG_ORACLE_N), np.int64)
    keys[0] = np.repeat(np.arange(len(lens)), lens)[:SEG_ORACLE_N]
    keys[0, 120:140] = keys[0, 120]  # a run over the tile edge at lane 128
    keys[0] = np.maximum.accumulate(keys[0])
    return pts, keys


@pytest.mark.parametrize("rounds", range(1, 8))
def test_seg_rounds_plain_match_step_oracle(rounds):
    """The aligned plain form against a step-by-step host oracle (the tree
    from each defined lane, on host ints), both forms: runs that cross
    tiles, single-lane runs, a run as long as the row; every other lane
    keeps its input."""
    field = "fq" if rounds % 2 else "fp"
    pts, keys = _oracle_inputs(80 + rounds)
    assert (np.diff(keys[0]) == 0).sum() > 0 and len(set(keys[1])) == 1
    t = [torch.as_tensor(v.astype(np.int32)) for v in pts]
    for tile in (0, SEG_TILE):
        got = TFK.ec_seg_rounds_plain(*t, torch.as_tensor(keys), rounds, field, tile)
        want = _seg_oracle(pts, keys, rounds, tile, field)
        d = _defined(keys, rounds, tile)
        assert len(want) == int(d.sum())
        for (row, i), pt in want.items():
            for c in range(3):
                limbs = got[c][:, row, i].numpy().astype(np.int64)
                assert sum(int(v) << (16 * j) for j, v in enumerate(limbs)) == pt[c]
        for g, p in zip(got, pts):
            np.testing.assert_array_equal(g.numpy()[:, ~d], p[:, ~d])


# --- the general Pippenger -------------------------------------------------

CURVES = {"fq": (VestaPoint, JVesta), "fp": (PallasPoint, JPallas)}


def _general_inputs(field, n, ncols, seed):
    """n random curve points (the JAX package's and the port's) and ncols
    scalar columns with 0 and 1 among them, as limbs."""
    rnd = random.Random(seed)
    tcurve, jcurve = CURVES[field]
    g = jcurve.generator()
    jpts = [g * (rnd.getrandbits(100) + 1) for _ in range(n)]
    tpts = [tcurve(tcurve.FIELD(p.x.v), tcurve.FIELD(p.y.v)) for p in jpts]
    cols = [[rnd.getrandbits(255) % jcurve.SCALAR.MODULUS for _ in range(n)] for _ in range(ncols)]
    cols[0][:2] = [0, 1]
    limbs = np.stack([TM.scalars_to_limbs(c) for c in cols])
    return jpts, tpts, cols, limbs


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _points_of(out, curve):
    return ec.points_from_device((out[:, 0], out[:, 1], out[:, 2]), curve)


def _j_host(jpts, col):
    j = JM.msm_host(jpts, col)
    return None if j.is_identity() else (j.x.v, j.y.v)


@pytest.mark.parametrize("field", ["fq", "fp"])
def test_msm_matches_host(field):
    jpts, tpts, cols, limbs = _general_inputs(field, 64, 1, 60)
    out = TM.msm(*(_t(v) for v in ec.points_to_device(tpts)), _t(limbs[0]), field=field, c=4)
    got = ec.points_from_device((out[0][None], out[1][None], out[2][None]), CURVES[field][0])
    assert _affine(got) == [_j_host(jpts, cols[0])]
    assert got[0] == TM.msm_host(tpts, cols[0])  # the port's own oracle agrees


def test_msm_multi_matches_per_column():
    """Three columns over one point set, a zero digit run in each, and an
    all-zero column."""
    jpts, tpts, cols, limbs = _general_inputs("fq", 64, 3, 61)
    limbs[2] = 0
    out = TM.msm_multi(*(_t(v) for v in ec.points_to_device(tpts)), _t(limbs), field="fq", c=4)
    want = [_j_host(jpts, c) for c in cols[:2]] + [None]
    assert _affine(_points_of(out, VestaPoint)) == want


def test_msm_multi_projective_with_identity_padding():
    """The device IPA's L/R form: limb-major projective points padded with
    identities (0 : 1 : 0) and zero scalars give the unpadded sums."""
    jpts, tpts, cols, limbs = _general_inputs("fq", 48, 2, 62)
    x, y, z = (_t(v).T.contiguous() for v in ec.points_to_device(tpts))
    padded = _pad_pts_lm((x, y, z), 16)
    assert padded[0].shape == (16, 64)
    scal = np.concatenate([limbs, np.zeros((2, 16, 16), limbs.dtype)], axis=1)
    out = TM.msm_multi(*padded, _t(scal), field="fq", c=4, in_form="projective")
    assert _affine(_points_of(out, VestaPoint)) == [_j_host(jpts, c) for c in cols]


def test_msm_horners_are_chained_launches(monkeypatch):
    """The general MSM weights every window's buckets in one
    ec_bucket_weights_lm call (each bit row's tree and the Horner over the
    bits), then runs its Horner over the windows as one ec_horner_lm call,
    and keeps its result."""
    calls = []
    horner, weights = TM.FK.ec_horner_lm, TM.FK.ec_bucket_weights_lm

    def spy(wx, wy, wz, doublings, field):
        calls.append(("horner", wx.shape[1], doublings, wx.shape[2]))
        return horner(wx, wy, wz, doublings, field)

    def spy_weights(bx, by, bz, c, field):
        calls.append(("weights", c, bx.shape[1] >> c))
        return weights(bx, by, bz, c, field)

    monkeypatch.setattr(TM.FK, "ec_horner_lm", spy)
    monkeypatch.setattr(TM.FK, "ec_bucket_weights_lm", spy_weights)
    jpts, tpts, cols, limbs = _general_inputs("fq", 16, 2, 66)
    pts = [_t(v) for v in ec.points_to_device(tpts)]
    out = TM.msm(*pts, _t(limbs[0]), field="fq", c=4)
    got = ec.points_from_device((out[0][None], out[1][None], out[2][None]), VestaPoint)
    assert _affine(got) == [_j_host(jpts, cols[0])]
    # 64 windows of 4 bits: the buckets of all windows' digits, then the windows
    assert calls == [("weights", 4, 64), ("horner", 64, 4, 1)]
    calls.clear()
    out = TM.msm_multi(*pts, _t(limbs), field="fq", c=4)
    assert _affine(_points_of(out, VestaPoint)) == [_j_host(jpts, c) for c in cols]
    assert calls == [("weights", 4, 128), ("horner", 64, 4, 2)]


def test_msms_read_only_defined_lanes(monkeypatch, tables):
    """Every lane that ec_seg_rounds leaves undefined (offset from its
    run's first lane not a multiple of 2^rounds) overwritten with random
    limbs: msm, msm_multi (their _compact and in-place rounds) and
    msm_fixed_multi (the Hillis-Steele and the blocked paths) give the same
    limbs, so no caller reads an undefined lane."""
    seg = TM.FK.ec_seg_rounds_lm
    rng = np.random.default_rng(67)
    poisoned = []

    def poison(x, y, z, keys, rounds, field="fq", tile=0):
        out = seg(x, y, z, keys, rounds, field, tile)
        bad = (TM.FK.seg_offsets(keys, tile) % (1 << rounds) != 0)[None]
        poisoned.append(int(bad.sum()))
        noise = [torch.as_tensor(rng.integers(0, 1 << 16, size=tuple(v.shape), dtype=np.int32))
                 for v in out]
        return tuple(torch.where(bad, n, v) for n, v in zip(noise, out))

    _, tpts, _, limbs = _general_inputs("fq", 64, 2, 68)
    pts = [_t(v) for v in ec.points_to_device(tpts)]
    s = _scalars(2, 69)
    runs = [lambda: TM.msm(*pts, _t(limbs[0]), field="fq", c=4),
            lambda: TM.msm_multi(*pts, _t(limbs), field="fq", c=4),
            lambda: TM.msm_fixed_multi(tables[8], torch.as_tensor(s.astype(np.int32)), "fq", 8),
            lambda: TM.msm_fixed_multi(tables[4], torch.as_tensor(s[:1].astype(np.int32)),
                                       "fq", 4)]
    want = [run() for run in runs]
    monkeypatch.setattr(TM.FK, "ec_seg_rounds_lm", poison)
    for run, w in zip(runs, want):
        poisoned.clear()
        assert torch.equal(run(), w)
        assert sum(poisoned) > 0  # the run had undefined lanes, all overwritten


def test_msm_all_zero_scalars():
    _, tpts, _, _ = _general_inputs("fq", 8, 1, 63)
    out = TM.msm(*(_t(v) for v in ec.points_to_device(tpts)), _t(np.zeros((8, 16))), field="fq")
    assert ec.points_from_device((out[0][None], out[1][None], out[2][None]),
                                 VestaPoint)[0].is_identity()


def test_msm_matches_native_engine_at_the_ipa_window(srs):
    """c = 8, the window of the device IPA, over the k = 9 SRS."""
    s = _scalars(1, 64)[0]
    out = TM.msm(*srs, torch.as_tensor(s.astype(np.int32)), field="fq")
    got = ec.points_from_device((out[0][None], out[1][None], out[2][None]), VestaPoint)
    assert _affine(got) == _native_commit(JH, j_srs_rows(K), J_FQ, s[None])


@pytest.mark.slow
@pytest.mark.parametrize("field", ["fq", "fp"])
def test_msm_bit_exact_with_reference(field):
    """msm and msm_multi (Jacobian input) against the JAX package's
    _msm_device / _msm_multi_device at c = 4, limb for limb."""
    _, tpts, _, limbs = _general_inputs(field, 64, 2, 64)
    dev_pts = ec.points_to_device(tpts)
    got = TM.msm(*(_t(v) for v in dev_pts), _t(limbs[0]), field=field, c=4).numpy()
    want = JM._msm_device(*(jnp.asarray(v.astype(np.uint32)) for v in dev_pts),
                          jnp.asarray(limbs[0].astype(np.uint32)), field=field, c=4)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int32))
    got = TM.msm_multi(*(_t(v) for v in dev_pts), _t(limbs), field=field, c=4).numpy()
    want = JM._msm_multi_device(*(jnp.asarray(v.astype(np.uint32)) for v in dev_pts),
                                jnp.asarray(limbs.astype(np.uint32)), field=field, c=4)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int32))


@pytest.mark.slow
def test_msm_multi_projective_bit_exact_with_reference():
    """The IPA's projective, identity-padded 2-column form against the JAX
    package's _msm_multi_device(in_form="projective"), limb for limb, at
    n = 256 with c = 4."""
    _, tpts, _, limbs = _general_inputs("fq", 192, 2, 65)
    x, y, z = (_t(v).T.contiguous() for v in ec.points_to_device(tpts))
    padded = _pad_pts_lm((x, y, z), 64)
    scal = np.concatenate([limbs, np.zeros((2, 64, 16), limbs.dtype)], axis=1)
    got = TM.msm_multi(*padded, _t(scal), field="fq", c=4, in_form="projective").numpy()
    want = JM._msm_multi_device(*(jnp.asarray(v.numpy().astype(np.uint32)) for v in padded),
                                jnp.asarray(scal.astype(np.uint32)), field="fq", c=4,
                                in_form="projective")
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int32))
