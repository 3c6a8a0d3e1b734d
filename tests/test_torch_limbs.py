"""The port's limb arithmetic (taiga_tpu_torch.ops.limbs) against the JAX
package's (taiga_tpu.ops.limbs) and against host field arithmetic, for both
Pasta fields. Inputs come from a seeded numpy generator; every comparison is
exact equality of the 16-bit limbs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.crypto.fields import Fp, Fq
from taiga_tpu.ops import limbs as JL
from taiga_tpu_torch.ops import limbs as TL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = [("fp", Fp, JL.FP, TL.FP), ("fq", Fq, JL.FQ, TL.FQ)]
N = 64


def _inputs(spec, seed):
    """(N, 16) canonical limbs: the edge values 0, 1, p-1 and R mod p, then
    seeded random elements below 2^254 < p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(N, 16), dtype=np.int64)
    x[:, 15] &= 0x3FFF
    for i, v in enumerate((0, 1, spec.modulus - 1, spec.r)):
        x[i] = TL.int_to_limbs(v)
    return x


def _ref(fn, *xs):
    return np.asarray(fn(*(jnp.asarray(x.astype(np.uint32)) for x in xs))).astype(np.int64)


def _port(fn, *xs):
    return fn(*(torch.as_tensor(x.astype(np.int32)) for x in xs)).numpy().astype(np.int64)


@pytest.mark.parametrize("field,F,jspec,tspec", FIELDS, ids=[f[0] for f in FIELDS])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_reference(field, F, jspec, tspec, op):
    a = _inputs(tspec, 1)
    b = np.roll(_inputs(tspec, 2), 1, axis=0)  # edges meet edges and randoms
    got = _port(lambda x, y: getattr(TL, op)(x, y, tspec), a, b)
    want = _ref(lambda x, y: getattr(JL, op)(x, y, jspec), a, b)
    np.testing.assert_array_equal(got, want)
    # and against host field arithmetic on the integer values
    p, rinv = tspec.modulus, pow(tspec.r, -1, tspec.modulus)
    for av, bv, gv in zip(TL.limbs_to_ints(a), TL.limbs_to_ints(b), TL.limbs_to_ints(got)):
        exp = {"add": (av + bv) % p, "sub": (av - bv) % p, "mont_mul": av * bv * rinv % p}[op]
        assert gv == exp


@pytest.mark.parametrize("field,F,jspec,tspec", FIELDS, ids=[f[0] for f in FIELDS])
def test_unary_ops_match_reference(field, F, jspec, tspec):
    a = _inputs(tspec, 3)
    for name, jfn, tfn in (
        ("neg", lambda x: JL.neg(x, jspec), lambda x: TL.neg(x, tspec)),
        ("to_mont", lambda x: JL.to_mont(x, jspec), lambda x: TL.to_mont(x, tspec)),
        ("from_mont", lambda x: JL.from_mont(x, jspec), lambda x: TL.from_mont(x, tspec)),
        ("square", lambda x: JL.mont_square(x, jspec), lambda x: TL.mont_square(x, tspec)),
        ("pow", lambda x: JL.mont_pow(x, 1000, jspec),
         lambda x: TL.mont_pow(x, 1000, tspec)),
    ):
        np.testing.assert_array_equal(_port(tfn, a), _ref(jfn, a), err_msg=name)
    np.testing.assert_array_equal(
        TL.is_zero(torch.as_tensor(a.astype(np.int32))).numpy(),
        np.asarray(JL.is_zero(jnp.asarray(a.astype(np.uint32)))))


@pytest.mark.parametrize("field,F,jspec,tspec", FIELDS, ids=[f[0] for f in FIELDS])
def test_mont_inv_matches_reference_and_fields(field, F, jspec, tspec):
    a = _inputs(tspec, 4)[:12]
    got = _port(lambda x: TL.mont_inv(x, tspec), a)
    np.testing.assert_array_equal(got, _ref(lambda x: JL.mont_inv(x, jspec), a))
    # Montgomery a*R -> a^-1 * R; 0 maps to 0
    for av, gv in zip(tspec.array_from_mont(a), tspec.array_from_mont(got)):
        assert gv == (pow(av, -1, F.MODULUS) if av else 0)


def test_broadcasting_and_layout():
    """A (16,) operand broadcasts against a batch, as in the reference."""
    a = _inputs(TL.FP, 5).reshape(4, 16, 16)
    b = _inputs(TL.FP, 6)[7]
    got = _port(lambda x, y: TL.mont_mul(x, y, TL.FP), a, b)
    want = _ref(lambda x, y: JL.mont_mul(x, y, JL.FP), a, b)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 16, 16)


def test_packing_and_host_conversions():
    a = _inputs(TL.FQ, 7)
    t = torch.as_tensor(a.astype(np.int32))
    packed = TL.pack_limbs(t)
    want = np.asarray(JL.pack_limbs(jnp.asarray(a.astype(np.uint32))))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)
    assert torch.equal(TL.unpack_limbs(packed), t)
    np.testing.assert_array_equal(TL.packed_to_u64(packed), JL.packed_to_u64(want))
    ints = TL.limbs_to_ints(t)
    assert ints == JL.limbs_to_ints(jnp.asarray(a.astype(np.uint32)))
    np.testing.assert_array_equal(TL.ints_to_limbs(ints), a)
    np.testing.assert_array_equal(TL.ints_to_packed(ints), JL.ints_to_packed(ints))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.resolve_device("cuda")
    assert TL.resolve_device("cpu").type == "cpu"
