"""K15-K17's wrappers on the CPU, where each runs its plain version, against
the JAX package, with exact equality:

  K15 ff_kernels.permute_pairs_lm (plain: ops/lookup_sort.py::
      permute_pairs_plain) against taiga_tpu.ops.lookup_sort.
      permute_pairs_device, every case a row of one batched call: passing
      and failing lookups (the ok flags included), heavy repeats,
      theta-compressed full 256-bit keys, an all-equal column, rows of 0
      and p - 1, at u = n - 9 (not a power of two); and at the kernel's
      tile edges (u = 1,023, 1,024, 1,025) with runs across an edge and a
      missing value in the last tile;
  K16 from_mont_lm (plain: ops/limbs.py's from_mont) against
      taiga_tpu.ops.limbs.from_mont on both fields, with 0, 1, R mod p and
      p - 1 and one or two leading batch axes;
  K17 msm_digits_lm (plain: ops/msm.py::msm_digits_plain) against the
      reference's _digits_all under vmap, keyed as msm_multi keys it
      (taiga_tpu/ops/msm.py:395-400) and packed as _msm_fixed_dev packs it
      (:657-673): the sorted keys and the order they give, since the
      reference packs in u32 where the key fits and the port in int64.

Also the wrappers' refusals and the source list. The kernels themselves are
held against the plain versions on the card (chip_smoke.py, phase_lookup)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import limbs as JL, lookup_sort as JLS, msm as JM
from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK, limbs as TL
from taiga_tpu_torch.ops import lookup_sort as TLS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 1 << 8
U = N - 9  # usable rows: n less the blinding rows and one, as the prover's u
P = JL.FP.modulus
THETA = 0x1234567890ABCDEF


def _lookup_rows():
    """{case: (A, S)} columns of N plain values each."""
    rng = random.Random(15)
    table = list(range(200)) + [0] * (N - 200)
    small = [rng.randrange(16) for _ in range(N)]  # range-check inputs: heavy repeats
    rows = {"byte pass": (small, table), "byte fail": (small[:30] + [250] + small[31:], table)}
    # theta compression: full 256-bit keys
    pair = [(THETA * x + 2 * x) % P for x in range(N)]
    rows["theta pass"] = ([pair[rng.randrange(150)] for _ in range(N)], pair)
    s = [rng.getrandbits(254) for _ in range(N)]
    a = [rng.choice(s[:40]) for _ in range(N)]
    rows["random repeats pass"] = (a, s)
    rows["random fail"] = (a[:7] + [(s[0] + 1) % P] + a[8:], s)
    rows["all equal"] = ([s[5]] * N, s)
    rows["all equal table"] = ([s[5]] * N, [s[5]] * N)
    edge = [0, P - 1] * (N // 2)
    rows["0 and p - 1"] = (edge, [P - 1, 0, 0, 1, P - 1] + s[5:])
    return rows


OK = {"byte pass": True, "byte fail": False, "theta pass": True, "random repeats pass": True,
      "random fail": False, "all equal": True, "all equal table": True, "0 and p - 1": True}


def _mont(cols):
    return np.stack([JL.FP.array_to_mont([x % P for x in c]) for c in cols]).astype(np.int64)


def test_permute_pairs_lm_matches_reference():
    rows = _lookup_rows()
    a = _mont([v[0] for v in rows.values()])
    s = _mont([v[1] for v in rows.values()])
    want = JLS.permute_pairs_device(jnp.asarray(a.astype(np.uint32)),
                                    jnp.asarray(s.astype(np.uint32)), U)
    ta, ts = torch.as_tensor(a.astype(np.int32)), torch.as_tensor(s.astype(np.int32))
    got = FK.permute_pairs_lm(ta, ts, U)
    for g, w, what in zip(got[:2], want[:2], ("A'", "S'")):
        assert g.shape == (len(rows), U, 16) and g.dtype == torch.int32, what
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64), err_msg=what)
    assert got[2].tolist() == np.asarray(want[2]).tolist() == list(OK.values())
    # the module's entry point routes to the wrapper
    for g, r in zip(got, TLS.permute_pairs_device(ta, ts, U)):
        assert torch.equal(g, r)


TILE = 1024  # K15's tile of positions (csrc/lookup_sort.cu kTile)


@pytest.mark.parametrize("u", [TILE - 1, TILE, TILE + 1])
def test_permute_pairs_lm_tile_edges(u):
    """K15's tile edges, u below one tile, one tile and one tile and one,
    in one batched call a u against the reference: a run of one value
    across the tile edge of sorted A and of sorted S (S's input order
    reversed below it), a failing lookup whose missing value is the
    largest, in the last tile, and random repeats."""
    rng = random.Random(u)
    n = TILE + 8
    d = sorted(rng.getrandbits(254) for _ in range(n))
    table = d[: TILE - 20][::-1] + [d[TILE - 20]] * 28
    run = [d[rng.randrange(TILE - 40)] for _ in range(TILE - 40)] + [d[TILE - 20]] * 48
    rng.shuffle(run)
    fail = list(run)
    fail[rng.randrange(TILE - 1)] = d[-1] + 1
    rows = [(run, table), (fail, table), ([table[rng.randrange(TILE - 1)] for _ in range(n)], table)]
    a, s = _mont([r[0] for r in rows]), _mont([r[1] for r in rows])
    want = JLS.permute_pairs_device(jnp.asarray(a.astype(np.uint32)),
                                    jnp.asarray(s.astype(np.uint32)), u)
    got = FK.permute_pairs_lm(torch.as_tensor(a.astype(np.int32)),
                              torch.as_tensor(s.astype(np.int32)), u)
    for g, w, what in zip(got[:2], want[:2], ("A'", "S'")):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64),
                                      err_msg=what)
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [True, False, True]


def _conv_vals(field: str, shape):
    spec = TL.FIELDS[field]
    rng = np.random.default_rng(16)
    x = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    flat = x.reshape(-1, 16)
    for i, v in enumerate((0, 1, spec.r, spec.modulus - 1)):
        flat[i] = TL.int_to_limbs(v)
    return x


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("shape", [(3, 5), (2, 3, 4)])
def test_from_mont_lm_matches_reference(field, shape):
    x = _conv_vals(field, shape)
    jspec = JL.FP if field == "fp" else JL.FQ
    want = jax.jit(lambda v: JL.from_mont(v, jspec))(jnp.asarray(x.astype(np.uint32)))
    got = FK.from_mont_lm(torch.as_tensor(x.astype(np.int32)), field)
    assert got.shape == shape + (16,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    # a single element, and a strided view
    assert torch.equal(FK.from_mont_lm(torch.as_tensor(x[1, 2].astype(np.int32)), field),
                       got[1, 2])
    view = torch.as_tensor(x.astype(np.int32)).transpose(0, 1)
    assert torch.equal(FK.from_mont_lm(view, field), got.transpose(0, 1))


def _scalars(C: int, n: int):
    rng = np.random.default_rng(17 + C)
    x = rng.integers(0, 1 << 16, size=(C, n, 16), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    x[0, 0] = 0
    x[-1, -1] = TL.int_to_limbs(TL.FQ.modulus - 1)
    return x


def _ref_fixed_keys(scalars, c: int):
    """taiga_tpu/ops/msm.py:657-673: the sorted composite keys d and the
    lane order they give, as the reference packs and sorts them."""
    ncols, n = scalars.shape[:2]
    W = 256 // c
    total = ncols * W * n
    digits = jax.vmap(lambda s: JM._digits_all(s, c))(scalars)  # (C, W, n)
    col_off = jnp.arange(ncols, dtype=jnp.int32)[:, None] * (1 << c)
    comp = (digits.reshape(ncols, W * n) + col_off).reshape(total)
    idx_bits = max(1, (total - 1).bit_length())
    key_bits = max(1, (ncols * (1 << c) - 1).bit_length())
    if idx_bits + key_bits <= 32:
        packed = jnp.sort((comp.astype(jnp.uint32) << idx_bits)
                          | jnp.arange(total, dtype=jnp.uint32))
        return (np.asarray(packed >> idx_bits).astype(np.int64),
                np.asarray(packed & jnp.uint32((1 << idx_bits) - 1)).astype(np.int64))
    order = jnp.argsort(comp)
    return np.asarray(jnp.take(comp, order)).astype(np.int64), np.asarray(order).astype(np.int64)


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_msm_digits_lm_matches_reference(c, C):
    n = 37
    x = _scalars(C, n)
    js = jnp.asarray(x.astype(np.uint32))
    ts = torch.as_tensor(x.astype(np.int32))
    # keyed, as msm_multi keys its windows (and msm, its C = 1)
    digits = np.asarray(jax.vmap(lambda s: JM._digits_all(s, c))(js)).astype(np.int64)
    want = np.swapaxes(digits, 0, 1) + (np.arange(C, dtype=np.int64)[:, None] << c)
    got = FK.msm_digits_lm(ts, c)
    assert got.shape == (256 // c, C, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # packed, as the fixed-base path keys one chunk
    total = C * (256 // c) * n
    idx_bits = max(1, (total - 1).bit_length())
    keys = torch.sort(FK.msm_digits_lm(ts, c, packed=True)).values
    d_want, order_want = _ref_fixed_keys(js, c)
    np.testing.assert_array_equal((keys >> idx_bits).numpy(), d_want)
    np.testing.assert_array_equal((keys & ((1 << idx_bits) - 1)).numpy(), order_want)


def test_wrappers_refuse_bad_inputs():
    a = torch.zeros((2, 16, 16), dtype=torch.int32)
    refused = [
        (TypeError, lambda: FK.permute_pairs_lm(a.long(), a, 7)),
        (ValueError, lambda: FK.permute_pairs_lm(a, a[:1], 7)),
        (ValueError, lambda: FK.permute_pairs_lm(a[0], a[0], 7)),
        (ValueError, lambda: FK.permute_pairs_lm(a, a, 0)),
        (ValueError, lambda: FK.permute_pairs_lm(a, a, 17)),
        (TypeError, lambda: FK.from_mont_lm(a.long())),
        (ValueError, lambda: FK.from_mont_lm(a[..., :8])),
        (TypeError, lambda: FK.msm_digits_lm(a.long(), 8)),
        (ValueError, lambda: FK.msm_digits_lm(a[0], 8)),
        (ValueError, lambda: FK.msm_digits_lm(a, 3)),
        # a packed key that would not fit an int64 (an expanded view: nothing allocated)
        (ValueError, lambda: FK.msm_digits_lm(torch.zeros((1, 1, 16), dtype=torch.int32).expand(
            1 << 16, 1 << 14, 16), 16, packed=True)),
    ]
    for exc, fn in refused:
        with pytest.raises(exc):
            fn()
    for name in ("lookup_sort", "convert"):
        assert name in CK.SOURCES
        assert CK._ARGTYPES[name]
