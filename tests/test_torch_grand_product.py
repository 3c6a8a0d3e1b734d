"""The grand products' kernels (taiga_tpu_torch.ops.ff_kernels K8 mont_inv_lm,
K9 mont_cumprod_lm, K10 perm_terms_lm / lookup_terms_lm, csrc/grand_product.cu)
through their plain versions on the CPU, against the JAX package: K8 against
taiga_tpu.ops.limbs.mont_inv on both fields (and a Python-integer model of
the kernel's divsteps against pow() and mont_inv), K9 forward and reverse against
taiga_tpu.ops.poly.mont_cumprod (reverse: its result on the flipped rows),
K9's powers entry (powers_lm) against taiga_tpu.ops.poly.powers on both
fields, the host sizes of K9's launches and powers tables against the
arithmetic they stand for, and K10 with the finish as the prover runs them, z_values_batch and
lookup_z_values_batch against the JAX package's ProverPipeline.z_values and
lookup_z_values on seeded columns and blinding rows at k = 5, for a key of
seven permutation columns (two chunks, the last one short). Inputs come from
a seeded numpy generator; every comparison is exact equality of the limbs."""

import random
import secrets

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import limbs as JL, poly as JP
from taiga_tpu.plonk import prover as JPR
from taiga_tpu.plonk.circuit import Circuit as JCircuit
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L, poly as TP
from taiga_tpu_torch.plonk import keygen as TK, prover as TPR

K = 5
SEED = 20261018


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(shape, seed, spec=L.FP):
    """Canonical limbs (< 2^254 < p) of the given batch shape, with 0, 1 (R
    mod p, Montgomery one) and p - 1 in the first three elements."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    x[..., 15] &= 0x3FFF
    flat = x.reshape(-1, 16)
    for i, v in enumerate((0, spec.r, spec.modulus - 1)[: flat.shape[0]]):
        flat[i] = L.int_to_limbs(v)
    return x.astype(np.int32)


def _ref(fn, *xs):
    return np.asarray(fn(*(jnp.asarray(x.astype(np.uint32)) for x in xs))).astype(np.int32)


def _port(fn, *xs):
    return fn(*(torch.as_tensor(x) for x in xs)).numpy()


_jcumprod = jax.jit(JP.mont_cumprod, static_argnames="field")
_jinv = jax.jit(JL.mont_inv, static_argnums=1)


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_mont_inv_plain_matches_reference(field):
    spec = L.FIELDS[field]
    a = _vals((37,), 1, spec)
    jspec = JL.FP if field == "fp" else JL.FQ
    got = _port(lambda x: FK.mont_inv_lm(x, field), a)
    np.testing.assert_array_equal(got, _ref(lambda x: _jinv(x, jspec), a))
    assert not got[0].any()  # 0 maps to 0
    np.testing.assert_array_equal(got[1], spec.one_mont)  # 1 is its own inverse


# A model of K8's kernel (csrc/grand_product.cu k_mont_inv) in Python
# integers: the same 20 batches of 30 divsteps on the low words (uint32
# masks, int32 zeta), the same transition matrices applied to (f, g) and,
# with the kernel's choice of md and me, to (d, e) mod p; the values'
# nine 30-bit limbs as the kernel cuts them; the final product by R^3.
DIV_BATCHES, DIV_STEPS, LIMB30 = 20, 30, 30
M32, M30 = (1 << 32) - 1, (1 << 30) - 1


def _i32(w):
    return w - (1 << 32) if w >> 31 else w


def _divsteps_30(zeta, f, g):
    """The kernel's divsteps_30 on 32-bit words: the new zeta and the
    transition matrix (u, v, q, r) as signed values."""
    u, v, q, r = 1, 0, 0, 1
    for _ in range(DIV_STEPS):
        c1 = M32 if zeta < 0 else 0
        c2 = M32 if g & 1 else 0
        x, y, z = (((t ^ c1) - c1) & M32 for t in (f, u, v))
        g, q, r = (g + (x & c2)) & M32, (q + (y & c2)) & M32, (r + (z & c2)) & M32
        c3 = c1 & c2
        zeta = (zeta ^ _i32(c3)) - 1
        f, u, v = (f + (g & c3)) & M32, (u + (q & c3)) & M32, (v + (r & c3)) & M32
        g, u, v = g >> 1, (u << 1) & M32, (v << 1) & M32
    return zeta, tuple(map(_i32, (u, v, q, r)))


def _limbs30(x):
    """The kernel's cut of a 256-bit value into nine 30-bit limbs, and back
    (words 32j .. 32j + 31 from two limbs)."""
    limbs = [(x >> (LIMB30 * i)) & M30 for i in range(9)]
    words = [((limbs[32 * j // 30] >> (32 * j % 30)) | (limbs[32 * j // 30 + 1]
                                                       << (30 - 32 * j % 30))) & M32
             for j in range(8)]
    return limbs, sum(w << (32 * j) for j, w in enumerate(words))


def _inv_model(xr, p):
    """(x R)^-1 R^3 R^-1 mod p for a Montgomery input xr, and the divsteps
    after which g first reached 0 (None if it never did)."""
    limbs, back = _limbs30(xr)
    assert back == xr and sum(v << (30 * i) for i, v in enumerate(limbs)) == xr
    inv = 1  # taiga_set_field's p^-1 mod 2^32, Newton from one bit
    for _ in range(5):
        inv = inv * (2 - p * inv) & M32
    pinv30 = inv & M30
    assert p * pinv30 & M30 == 1
    f, g, d, e, zeta, done = p, xr, 0, 1, -1, (0 if xr == 0 else None)
    for b in range(DIV_BATCHES):
        zeta, (u, v, q, r) = _divsteps_30(zeta, f & M30, g & M30)
        assert -(1 << 30) <= min(u, v, q, r) and max(u, v, q, r) <= 1 << 30
        md = (u if d < 0 else 0) + (v if e < 0 else 0)
        me = (q if d < 0 else 0) + (r if e < 0 else 0)
        cd, ce = u * d + v * e, q * d + r * e
        md -= (pinv30 * (cd & M32) + md) & M30
        me -= (pinv30 * (ce & M32) + me) & M30
        assert (cd + p * md) & M30 == 0 and (ce + p * me) & M30 == 0
        d, e = (cd + p * md) >> 30, (ce + p * me) >> 30
        nf, ng = u * f + v * g, q * f + r * g
        assert nf & M30 == 0 and ng & M30 == 0
        f, g = nf >> 30, ng >> 30
        assert -2 * p < d < p and -2 * p < e < p
        if done is None and g == 0:
            done = DIV_STEPS * (b + 1)
    assert g == 0 and f in ((1, -1) if xr else (p,))
    if d < 0:  # normalize: add p if negative, negate when f < 0, add p again
        d += p
    if f < 0:
        d = -d
    if d < 0:
        d += p
    assert 0 <= d < p and (d * xr - (1 if xr else 0)) % p == 0
    R = 1 << 256
    return d * pow(R, 3, p) * pow(R, -1, p) % p, done


def _inv_inputs(p, seed):
    """0, 1, 2, p - 1, (p - 1) / 2, every power of two below p and seeded
    values."""
    rng = random.Random(seed)
    return ([0, 1, 2, p - 1, (p - 1) // 2] + [1 << k for k in range(p.bit_length() - 1)]
            + [rng.randrange(p) for _ in range(40)])


@pytest.mark.parametrize("field", ["fp", "fq"])
def test_mont_inv_divsteps_model(field):
    """K8's divsteps, modelled in Python integers, against pow(x, p - 2, p)
    and the JAX package's mont_inv on the edges, the powers of two and
    seeded values: g is 0 after the kernel's 600 divsteps on each, within
    the 590 its bound allows, and 0 maps to 0."""
    spec = L.FIELDS[field]
    p, R = spec.modulus, 1 << 256
    assert DIV_BATCHES * DIV_STEPS >= 590 and 1 << 254 < p < 1 << 255
    xs = _inv_inputs(p, SEED + (field == "fq"))
    most = 0
    got = []
    for x in xs:
        y, done = _inv_model(x * R % p, p)
        assert y == pow(x, p - 2, p) * R % p, x
        most = max(most, done)
        got.append(L.int_to_limbs(y))
    assert most <= 590
    jspec = JL.FP if field == "fp" else JL.FQ
    want = _ref(lambda a: _jinv(a, jspec),
                np.stack([L.int_to_limbs(x * R % p) for x in xs]).astype(np.int32))
    np.testing.assert_array_equal(np.stack(got).astype(np.int32), want)


@pytest.mark.parametrize("field,n", [("fp", 1), ("fp", 2), ("fp", 7), ("fp", 64), ("fq", 64)])
def test_mont_cumprod_plain_matches_reference(field, n):
    """K9 along the second-last axis of (R, n, 16), forward and reverse; the
    reference scans axis 0. Row 1 holds a zero, so its products from there
    on (forward) or up to it (reverse) are 0."""
    spec = L.FIELDS[field]
    a = _vals((3, n), 2 + n, spec)
    a[1, n // 2] = 0
    ref = lambda x: _jcumprod(x, field=field)
    fwd = _port(lambda x: FK.mont_cumprod_lm(x, field), a)
    np.testing.assert_array_equal(fwd, _ref(ref, a.transpose(1, 0, 2)).transpose(1, 0, 2))
    rev = _port(lambda x: FK.mont_cumprod_lm(x, field, reverse=True), a)
    want = _ref(ref, a[:, ::-1].transpose(1, 0, 2)).transpose(1, 0, 2)[:, ::-1]
    np.testing.assert_array_equal(rev, want)
    assert not fwd[1, n // 2:].any() and not rev[1, : n // 2 + 1].any()


def test_mont_cumprod_takes_powers_layout():
    """poly.powers scans an expanded (n - 1, Q, 16) view along axis 0 (K9 on
    its moved axis, stride 0 along the scan); the reference's powers of each
    point alone agree with it."""
    x = _vals((3,), 7)
    got = TP.powers(torch.as_tensor(x), 50).numpy()
    for q in range(3):
        np.testing.assert_array_equal(got[q], _ref(lambda v: JP.powers(v, 50), x[q]))
    tiled = np.broadcast_to(x, (49, 3, 16))
    np.testing.assert_array_equal(
        _port(lambda t: TP.mont_cumprod(t.expand(49, 3, 16)), x), _ref(_jcumprod, tiled))


_jpowers = jax.jit(JP.powers, static_argnames=("n", "field"))


@pytest.mark.parametrize("field", ["fp", "fq"])
@pytest.mark.parametrize("n", [1, 2, 50, 257])
def test_powers_lm_matches_reference(field, n):
    """K9's powers entry (its plain version on the CPU) against the
    reference's powers of each point, 0, 1 (R mod p) and p - 1 among them;
    n = 257 spans nine of its 32-entry big-table steps; the packed form is
    the same words."""
    spec = L.FIELDS[field]
    x = _vals((2, 3), 30 + n, spec)
    got = FK.powers_lm(torch.as_tensor(x), n, field)
    assert got.shape == (2, 3, n, 16)
    for b in range(2):
        for q in range(3):
            np.testing.assert_array_equal(
                got[b, q].numpy(), _ref(lambda v: _jpowers(v, n=n, field=field), x[b, q]))
    assert torch.equal(TP.powers(torch.as_tensor(x), n, field), got)
    packed = FK.powers_lm(torch.as_tensor(x), n, field, packed=True)
    words = got.numpy().astype(np.int64)
    want = (words[..., 0::2] | (words[..., 1::2] << 16)).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(packed.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 50, 127, 128, 129, 257, 8191, 8192, 8193, 16385])
def test_powers_tables_give_pow(n):
    """The kernel's tables for rows of n: T = 2^t the least power of two with
    T^2 >= n; small = x^0 .. x^T and big = x^0, x^T, .. built by the kernel's
    doubling (entry m + j = entry m times entry j); x^i = big[i >> t]
    small[i mod T] equals pow(x, i, p) at every i < n."""
    p = L.FP.modulus
    t = FK.powers_table_log(n)
    T = 1 << t
    assert T * T >= n and (t == 0 or (T // 2) ** 2 < n) and t <= FK.POWERS_MAX_LOG
    x = 0x1234567890ABCDEF1234567890ABCDEF % p + n
    small = [1, x] + [None] * (T - 1)
    m = 1
    while m < T:
        for j in range(1, m + 1):
            small[m + j] = small[m] * small[j] % p
        m *= 2
    nbig = -(-n // T)
    big = [1, small[T]][:nbig] + [None] * max(0, nbig - 2)
    m = 1
    while m + 1 < nbig:
        for j in range(1, m + 1):
            if m + j < nbig:
                big[m + j] = big[m] * big[j] % p
        m *= 2
    for i in range(n):
        assert big[i >> t] * small[i & (T - 1)] % p == pow(x, i, p), i


def test_k9_launch_sizes():
    """cumprod_launch: a cluster of blocks x CUMPROD_THREADS x per >= n, at
    most CUMPROD_MAX_BLOCKS blocks and CUMPROD_MAX_PER a thread, no block
    past the row's end, CUMPROD_PER a thread while a call's blocks number at
    most two an SM (a proof's 4 and 5 rows of 8,192: 16 blocks a row) and
    CUMPROD_MAX_PER beyond (a batch's 32 and 40: 8), more where the cluster
    is full, None past CUMPROD_ONE_LAUNCH_N; powers_per_thread: two blocks
    an SM, 1 to 8."""
    assert FK.cumprod_launch(8192, 4) == (16, 4) and FK.cumprod_launch(8192, 5) == (16, 4)
    assert FK.cumprod_launch(8192, 32) == (8, 8) and FK.cumprod_launch(8192, 40) == (8, 8)
    assert FK.cumprod_launch(8193) == (13, 5) and FK.cumprod_launch(8192, 16) == (16, 4)
    assert FK.cumprod_launch(1) == (1, 1) and FK.cumprod_launch(512) == (1, 4)
    assert FK.cumprod_launch(513) == (2, 3)
    assert FK.cumprod_launch(FK.CUMPROD_ONE_LAUNCH_N) == (16, 8)
    assert FK.cumprod_launch(FK.CUMPROD_ONE_LAUNCH_N + 1) is None
    for rows in (1, 8, 40, 600):
        for n in list(range(1, 3000, 3)) + [8191, 8192, 8193, 12000, 16383, 16384]:
            blocks, per = FK.cumprod_launch(n, rows)
            assert 1 <= blocks <= FK.CUMPROD_MAX_BLOCKS and 1 <= per <= FK.CUMPROD_MAX_PER
            assert blocks * FK.CUMPROD_THREADS * per >= n > (blocks - 1) * per * FK.CUMPROD_THREADS
            narrow = rows * -(-n // (FK.CUMPROD_THREADS * FK.CUMPROD_PER)) <= 2 * 132
            full = -(-n // (FK.CUMPROD_THREADS * FK.CUMPROD_MAX_BLOCKS))  # per in a full cluster
            assert per <= max(FK.CUMPROD_PER if narrow else FK.CUMPROD_MAX_PER, full)
    for rows, n, want in ((1, 8191, 1), (6, 8191, 2), (48, 8191, 8), (6, 8193, 2), (1, 1, 1)):
        assert FK.powers_per_thread(rows, n, 132) == want
        per = FK.powers_per_thread(rows, n, 132)
        assert per == 8 or -(-rows * n // (FK.CUMPROD_THREADS * per)) <= 2 * 132


def test_wrappers_on_the_cpu_launch_nothing():
    """On CPU tensors every wrapper runs its plain version: no launch is
    counted, and the shapes are checked first."""
    counters = (FK.mont_inv_lm, FK.mont_cumprod_lm, FK.perm_terms_lm, FK.lookup_terms_lm,
                FK.mont_mul_lm, FK.powers_lm)
    before = [f.launches for f in counters]
    a = torch.as_tensor(_vals((4, 8), 9))
    FK.mont_inv_lm(a[0])
    FK.mont_cumprod_lm(a, reverse=True)
    FK.lookup_terms_lm(a[None, None], a[None, None], a[None, None], a[None, None], a[0, :1],
                       a[1, :1])
    FK.perm_terms_lm(a[None], a, a[0], a[0, :1], a[1, :1], a[2, :4], 3)
    FK.mont_mul_rows(a, a[0])
    FK.powers_lm(a[0], 5)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="shape"):
        FK.mont_inv_lm(a)
    with pytest.raises(TypeError, match="dtype"):
        FK.mont_cumprod_lm(a.long())
    with pytest.raises(ValueError, match="shape"):
        FK.perm_terms_lm(a[None], a[:3], a[0], a[0, :1], a[1, :1], a[2, :4], 3)
    with pytest.raises(ValueError, match="n = 0"):
        FK.powers_lm(a[0], 0)
    with pytest.raises(TypeError, match="dtype"):
        FK.powers_lm(a[0].long(), 4)


def test_mont_mul_rows_matches_limbs():
    a, b = _vals((5, 6), 10), _vals((6,), 11)
    got = _port(lambda x, y: FK.mont_mul_rows(x, y), a, b)
    np.testing.assert_array_equal(got, _port(lambda x, y: L.mont_mul(x, y, L.FP), a, b))


class _CopyCircuit(JCircuit):
    """Six advice columns and the instance in one copy cycle (seven
    permutation columns: chunks of 4 and 3) and one lookup."""

    NUM_FIXED = 2
    NUM_ADVICE = 6
    NUM_INSTANCE = 1

    @classmethod
    def configure(cls, cs):
        q, table = cs.fixed(0), cs.fixed(1)
        cols = [cs.advice(i) for i in range(6)]
        cs.lookup("small", [(q * cols[0], table)])
        cs.create_gate("eq", q * (cols[0] - cols[1]))
        return None

    def synthesize(self, builder, config):
        row = builder.alloc_rows(2)
        for i in range(2):
            builder.assign_fixed(1, row + i, i)
        builder.assign_fixed(0, row, 1)
        cells = [builder.assign_advice(i, row, None) for i in range(6)]
        for c in cells[1:]:
            builder.copy(cells[0], c)
        builder.constrain_instance(cells[0], 0)


@pytest.fixture(scope="module")
def pipelines():
    jpk = jkeygen(_CopyCircuit(), K)
    assert len(jpk.vk.perm_cols) == 7
    tpk = TK.proving_key_from_arrays(jpk.vk.to_bytes(), jpk.fixed_mont(), jpk.sigma_mont())
    return JPR.ProverPipeline(jpk), TPR.ProverPipeline(tpk, "cpu")


def _draws(seed):
    return random.Random(seed).getrandbits


def test_z_values_batch_matches_reference(pipelines, monkeypatch):
    """Two proofs' permutation grand products (K10's permutation entry, K9,
    K8 and the finish through K1's plain version) against the reference's
    z_values of each proof in turn, drawing the same blinding rows."""
    jpipe, tpipe = pipelines
    B, n = 2, 1 << K
    cols = _vals((B, 7, n), 12)
    rng = random.Random(SEED)
    betas = [rng.randrange(JPR.P) for _ in range(B)]
    gammas = [rng.randrange(JPR.P) for _ in range(B)]
    monkeypatch.setattr(secrets, "randbits", _draws(SEED))
    want = [np.asarray(jpipe.z_values(jnp.asarray(cols[b].astype(np.uint32)), betas[b],
                                      gammas[b])) for b in range(B)]
    got = tpipe.z_values_batch(torch.as_tensor(cols), betas, gammas, TPR._Rand(_draws(SEED)))
    np.testing.assert_array_equal(got.numpy(), np.stack(want).astype(np.int32))


def test_lookup_z_values_batch_matches_reference(pipelines, monkeypatch):
    """Two proofs' lookup grand products of three lookups each (K10's lookup
    entry, K9, K8, the finish) against the reference's lookup_z_values."""
    jpipe, tpipe = pipelines
    B, nlk, n = 2, 3, 1 << K
    a, s, ap, sp = (_vals((B, nlk, n), 20 + i) for i in range(4))
    rng = random.Random(SEED + 1)
    betas = [rng.randrange(JPR.P) for _ in range(B)]
    gammas = [rng.randrange(JPR.P) for _ in range(B)]
    monkeypatch.setattr(secrets, "randbits", _draws(SEED + 1))
    j = lambda x: jnp.asarray(x.astype(np.uint32))
    want = [np.asarray(jpipe.lookup_z_values(j(a[b]), j(s[b]), j(ap[b]), j(sp[b]), betas[b],
                                             gammas[b])) for b in range(B)]
    t = torch.as_tensor
    got = tpipe.lookup_z_values_batch(t(a), t(s), t(ap), t(sp), betas, gammas,
                                      TPR._Rand(_draws(SEED + 1)))
    np.testing.assert_array_equal(got.numpy(), np.stack(want).astype(np.int32))
