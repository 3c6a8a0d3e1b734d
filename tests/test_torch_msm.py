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
from taiga_tpu_torch.ops import ec, limbs as TL, msm as TM
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
