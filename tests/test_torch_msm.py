"""The port's fixed-base MSM (taiga_tpu_torch.ops.msm: the shifted SRS
table and msm_fixed_multi, through the plain versions of K2/K3) at k = 9.

The reference for a commitment is the JAX package's own CPU commit path,
its native engine's Pippenger (taiga_tpu.native.hostops.msm, which
ProverPipeline.commit_coeff_rows takes on a CPU); the port's copy of that
engine and host curve arithmetic check it too. Window c = 8 (the prover's)
takes the segmented Hillis-Steele reduction at this size; c = 4 takes the
blocked reduction that c = 8 takes from k = 12 up. (The JAX package's
fixed-base path itself takes minutes of XLA compile on a CPU.)"""

import numpy as np
import pytest
import torch

from taiga_tpu.native import FIELD_FQ as J_FQ, hostops as JH
from taiga_tpu.plonk.msm_claim import srs_host_rows as j_srs_rows
from taiga_tpu_torch.crypto.curves import VestaPoint
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
