"""K11's wrapper, taiga_tpu_torch.ops.ff_kernels.ntt_lm, on the CPU, where
it runs its plain version (ops/ntt.py::ntt_plain), against the JAX
package's taiga_tpu.ops.ntt: the four transforms at k = 1, 2, 7 and 13,
both fields, a (2, 3, n, 16) batch and a transposed view, with the values
0, 1, R mod p and p - 1 among the inputs; rows of n / 8, n / 8 + 1 and 1
nonzero elements (`nonzero`) and the prover's to_ext against the
reference's transforms of the rows padded with zeros; exact equality.
Also the host side of the kernel: the compact twiddle table, the line
transforms' twiddles the kernel takes from it and the fused scales
against pow(), the moduli's words that the kernel's product assumes, the
radix the wrapper picks, and the wrapper's refusals. The kernel itself is held
against ntt_plain on the card (chip_smoke.py, phase_ntt)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import ntt as JN
from taiga_tpu_torch.ops import ff_kernels as FK, limbs as TL, ntt as TN
from taiga_tpu_torch.plonk.prover import ProverPipeline

TRANSFORMS = {"ntt": {}, "intt": {"inverse": True}, "coset_ntt": {"coset": 5},
              "coset_intt": {"inverse": True, "coset": 5}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain version runs many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(shape, field, seed):
    """Seeded canonical elements (< 2^254 < p) of shape (..., n, 16), the
    first row's first elements 0, 1, R mod p and p - 1."""
    spec = TL.FIELDS[field]
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    x[..., 15] &= 0x3FFF
    flat = x.reshape(-1, 16)
    for i, v in enumerate((0, 1, spec.r, spec.modulus - 1)[: flat.shape[0]]):
        flat[i] = TL.int_to_limbs(v)
    return x


def _check(x, k, field):
    xt = torch.as_tensor(x.astype(np.int32))
    xj = jnp.asarray(x.astype(np.uint32))
    for name, kw in TRANSFORMS.items():
        got = FK.ntt_lm(xt, k, field, **kw).numpy().astype(np.int64)
        want = np.asarray(getattr(JN, name)(xj, k, field)).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("k,cols", [(1, 2), (2, 2), (7, 2), (13, 1)])
def test_ntt_lm_matches_reference(k, cols, field):
    _check(_vals((cols, 1 << k, 16), field, 10 * k + cols), k, field)


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_ntt_lm_batch_shape(field):
    _check(_vals((2, 3, 1 << 7, 16), field, 3), 7, field)


def test_ntt_lm_transposed_view():
    """A moved axis, as ntt_mesh passes it: (n, 3, 16).transpose(0, 1)."""
    k, field = 7, "fq"
    x = _vals((1 << k, 3, 16), field, 5)
    xt = torch.as_tensor(x.astype(np.int32)).transpose(0, 1)
    assert not xt.is_contiguous()
    xj = jnp.asarray(np.ascontiguousarray(x.transpose(1, 0, 2)).astype(np.uint32))
    for name, kw in TRANSFORMS.items():
        got = FK.ntt_lm(xt, k, field, **kw)
        assert got.is_contiguous() and got.shape == xt.shape
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(getattr(JN, name)(xj, k, field)).astype(np.int64),
                                      err_msg=name)


def _padded(x, k):
    """x (..., m, 16) padded with zeros to (..., 2^k, 16), for the reference."""
    pad = np.zeros(x.shape[:-2] + ((1 << k) - x.shape[-2], 16), dtype=x.dtype)
    return np.concatenate([x, pad], axis=-2)


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("k", [4, 7])
def test_ntt_lm_nonzero_matches_reference(k, field):
    """Rows holding only their first `nonzero` elements: to_ext's n / 8 (the
    kernel's radix-4 path that skips the butterflies of two zeros), n / 8 +
    1 and 1, in all four transforms, against the reference's transforms of
    the padded rows."""
    n = 1 << k
    for nonzero in (n // 8, n // 8 + 1, 1):
        x = _vals((2, nonzero, 16), field, 7 * k + nonzero)
        xt = torch.as_tensor(x.astype(np.int32))
        xj = jnp.asarray(_padded(x, k).astype(np.uint32))
        for name, kw in TRANSFORMS.items():
            got = FK.ntt_lm(xt, k, field, nonzero=nonzero, **kw)
            assert got.shape == (2, n, 16)
            want = np.asarray(getattr(JN, name)(xj, k, field)).astype(np.int64)
            np.testing.assert_array_equal(got.numpy().astype(np.int64), want,
                                          err_msg=f"{name}, nonzero={nonzero}")


def test_to_ext_reads_the_padding_as_zeros():
    """ProverPipeline.to_ext passes its (..., n, 16) coefficients as they
    are, and gets the reference's coset NTT at 8n of the rows padded with
    zeros."""
    k = 4
    x = _vals((2, 3, 1 << k, 16), "fp", 11)
    got = ProverPipeline.to_ext(SimpleNamespace(k=k, n=1 << k), torch.as_tensor(x.astype(np.int32)))
    want = JN.coset_ntt(jnp.asarray(_padded(x, k + 3).astype(np.uint32)), k + 3, "fp")
    assert got.shape == (2, 3, 8 << k, 16)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def _unpack(words: np.ndarray) -> list[int]:
    """(N, 8) uint32 packed -> host ints (the raw 256-bit words)."""
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in words]


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("k", [1, 5, 13])
def test_twiddle_table_is_powers_of_omega(k, field):
    spec = TL.FIELDS[field]
    p, rinv = spec.modulus, pow(spec.r, -1, spec.modulus)
    omega, omega_inv = TN.domain_params(k, field)[:2]
    for inverse, w in ((False, omega), (True, omega_inv)):
        tab = TN.twiddle_table(k, field, inverse)
        assert tab.shape == (max((1 << k) // 2, 1), 8) and tab.dtype == np.uint32
        got = [v * rinv % p for v in _unpack(tab)]
        assert got == [pow(w, j, p) for j in range(tab.shape[0])]
    if k > 1:  # w^(n/2) = -1: the kernel negates the table for e >= n/2
        assert pow(omega, 1 << (k - 1), p) == p - 1


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("k", [3, 10, 13, 16, 18])
def test_line_twiddles_are_powers_of_the_line_root(k, field):
    """Each pass of the kernel loads its lines' twiddles w_m^e, e < m / 2,
    from the compact table at stride n / m (csrc/ntt.cu, k_ntt_pass): a
    line of m = 2^k for k <= 10, else of 2^ceil(k/2) and 2^floor(k/2)."""
    spec = TL.FIELDS[field]
    p, rinv = spec.modulus, pow(spec.r, -1, spec.modulus)
    omega = TN.domain_params(k, field)[0]
    tab = TN.twiddle_table(k, field, False)
    for m_log in ([k] if k <= FK.NTT_ONE_PASS_K else [(k + 1) // 2, k // 2]):
        w_m = pow(omega, 1 << (k - m_log), p)
        got = [v * rinv % p for v in _unpack(tab[[e << (k - m_log)
                                                  for e in range(1 << (m_log - 1))]])]
        assert got == [pow(w_m, e, p) for e in range(1 << (m_log - 1))]
        assert pow(w_m, 1 << (m_log - 1), p) == p - 1  # w_m is a primitive m-th root


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_moduli_fit_the_kernels_product(field):
    """K11's Montgomery product (fe_mul_pasta, csrc/field.cuh) writes the reduction row
    for p's 32-bit words: p0 = 1, p4 = p5 = p6 = 0, p7 = 2^30, and
    -p^-1 = 2^32 - 1 mod 2^32. Both Pasta moduli have that shape."""
    p = TL.FIELDS[field].modulus
    words = [(p >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    assert words[0] == 1 and words[4:7] == [0, 0, 0] and words[7] == 1 << 30
    assert -pow(p, -1, 1 << 32) % (1 << 32) == 0xFFFFFFFF


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_kernel_tables_fuse_the_scales(field):
    """The scale at load is the forward coset's g^i; the scale at store is
    the inverse's n^-1, or n^-1 g^-i with a coset; nothing else scales."""
    k, g = 5, 5
    spec = TL.FIELDS[field]
    p, n, rinv = spec.modulus, 1 << k, pow(spec.r, -1, spec.modulus)
    n_inv = pow(n, -1, p)

    def ints(t):
        return [v * rinv % p for v in _unpack(t.numpy().view(np.uint32))]

    for inverse in (False, True):
        for coset in (None, g):
            tw, pre, post = TN.kernel_tables(k, field, inverse, coset, "cpu")
            assert ints(tw) == [int(v) * rinv % p for v in _unpack(TN.twiddle_table(k, field,
                                                                                    inverse))]
            if inverse:
                assert pre is None
                want = [n_inv] if coset is None else [n_inv * pow(g, -i, p) % p
                                                      for i in range(n)]
                assert ints(post) == want
            else:
                assert post is None
                assert (pre is None) == (coset is None)
                if coset is not None:
                    assert ints(pre) == [pow(g, i, p) for i in range(n)]


@pytest.mark.parametrize("rows, k, nonzero, logr", [
    (12, 16, 1 << 13, 2),   # a proof's extension: n / 8 coefficients a row
    (96, 16, 1 << 13, 2),   # a batch of 8's
    (96, 16, 1 << 13 | 1, 1),  # one element more than n / 8: dense
    (1, 16, 1 << 13, 1),    # one padded row: too few threads
    (12, 13, 1 << 13, 1),   # a proof's iNTT: dense
    (96, 13, 1 << 13, 1),   # a batch's, as wide as a proof's extension
    (8, 16, 1 << 16, 1),    # a batch's coset iNTT
    (1 << 20, 2, 1, 1),     # k < 3: no padded first group
])
def test_ntt_radix_log_takes_radix_4_only_for_wide_padded_calls(rows, k, nonzero, logr):
    """K11's radix: 4 only where the rows are zero-padded to 8 times their
    length and the call keeps NTT_MIN_THREADS threads, else 2."""
    assert FK.ntt_radix_log(rows, k, nonzero) == logr


def test_ntt_lm_refuses_bad_operands():
    """dtype and shape are checked before the dispatch, on the CPU as on
    the card (the k range, 1 .. NTT_K_MAX, only where the kernel runs)."""
    k = 3
    x = torch.zeros((2, 1 << k, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        FK.ntt_lm(x.long(), k)
    with pytest.raises(ValueError):
        FK.ntt_lm(x, k + 1)  # n is not 2^k
    with pytest.raises(ValueError):
        FK.ntt_lm(x[..., :8], k)  # not 16 limbs
    with pytest.raises(ValueError):
        FK.ntt_lm(x[0, 0], k)  # no element axis
    with pytest.raises(ValueError):
        FK.ntt_lm(x, k, nonzero=4)  # the rows hold 8 elements, not 4
    for nonzero in (0, (1 << k) + 1):
        with pytest.raises(ValueError):
            FK.ntt_lm(x, k, nonzero=nonzero)
    assert FK.NTT_K_MAX == 18
