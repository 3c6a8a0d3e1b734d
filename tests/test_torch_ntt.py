"""The port's NTT (taiga_tpu_torch.ops.ntt: constant-geometry Pease NTT with
its final bit reversal, and the coset transforms) against the JAX package's
taiga_tpu.ops.ntt at k = 9..11, both fields, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import ntt as JN
from taiga_tpu_torch.ops import limbs as TL, ntt as TN


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(k, seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(batch, 1 << k, 16), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    return x


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("k", [9, 10, 11])
def test_ntt_family_matches_reference(k, field):
    x = _vals(k, 100 + k)
    xt = torch.as_tensor(x.astype(np.int32))
    xj = jnp.asarray(x.astype(np.uint32))
    for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
        got = getattr(TN, name)(xt, k, field).numpy().astype(np.int64)
        want = np.asarray(getattr(JN, name)(xj, k, field)).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)
    back = TN.intt(TN.ntt(xt, k, field), k, field)
    assert torch.equal(back, xt)


def test_ntt_evaluates_the_polynomial():
    """Forward NTT of coefficients = evaluations at omega^i (host check)."""
    k, spec = 9, TL.FP
    x = _vals(k, 7, batch=1)[0]
    ev = TN.ntt(torch.as_tensor(x.astype(np.int32)), k, "fp")
    coeffs = spec.array_from_mont(x)
    omega = TN.domain_params(k, "fp")[0]
    p = spec.modulus
    for i in (0, 1, 77, 511):
        pt = pow(omega, i, p)
        want = sum(c * pow(pt, j, p) for j, c in enumerate(coeffs)) % p
        assert spec.array_from_mont(ev[i : i + 1])[0] == want
