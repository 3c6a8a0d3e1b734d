"""Vectorized 255-bit prime-field arithmetic on 16x16-bit limb tensors.

Port of taiga_tpu/ops/limbs.py to PyTorch. The module-boundary contract is
the reference's: an Fp/Fq element is 16 little-endian 16-bit limbs, in
Montgomery form with R = 2^256, shape (..., 16). The limbs are carried as
int32 (the values are below 2^16, so the bytes equal the reference's uint32
limbs): torch has only partial uint32 support on the CPU.

Inside, every op works LIMB-MAJOR on int32 tensors (16, ...): row i is limb i
for the whole batch, so each step of a carry chain is one vector op over a
contiguous row, and a chain of 0/1 carries (a sum or difference of
canonical limbs, within 17 bits) is resolved at once by carry-lookahead.
The Montgomery product accumulates its 16x16-bit products (< 2^32) in
float64, exact below 2^53, so it never needs the reference's lo/hi split.

No data-dependent control flow: conditional subtracts are borrow-select.
Bit-exact against `taiga_tpu_torch.crypto.fields` and `taiga_tpu.ops.limbs`
(tests/test_torch_limbs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import Fp, Fq

W = 16  # limb width in bits
NLIMBS = 16  # 256 bits total
MASK = (1 << W) - 1
DTYPE = torch.int32


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA request without a
    card raises: nothing carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return dev


# --- host conversions (numpy, int32 limbs) -----------------------------------


def int_to_limbs(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), dtype="<u2").astype(np.int32)


def limbs_to_int(l) -> int:
    l = np.asarray(l).reshape(NLIMBS)
    return int.from_bytes(l.astype("<u2").tobytes(), "little")


def ints_to_limbs(vs) -> np.ndarray:
    """[N ints] -> (N, 16) int32 (via a single bytes buffer; fast)."""
    buf = b"".join(v.to_bytes(32, "little") for v in vs)
    return np.frombuffer(buf, dtype="<u2").astype(np.int32).reshape(len(vs), NLIMBS)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def limbs_to_ints(a) -> list[int]:
    flat = _host(a).reshape(-1, NLIMBS).astype("<u2")
    buf = flat.tobytes()
    return [int.from_bytes(buf[i * 32 : (i + 1) * 32], "little") for i in range(flat.shape[0])]


# --- packed transfers ----------------------------------------------------------
# Two 16-bit limbs per 32-bit word: the packed (..., 8) little-endian byte
# stream IS the canonical 32-byte field encoding. Packed words are int32, so
# a word whose high limb is >= 0x8000 reads negative; the bits are the same.


def pack_limbs(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 16-bit limbs -> (..., 8) int32 packed."""
    return a[..., 0::2] | (a[..., 1::2] << W)


def unpack_limbs(p: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 packed -> (..., 16) int32 16-bit limbs."""
    lo = p & MASK
    hi = (p >> W) & MASK
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (NLIMBS,))


def ints_to_packed(vs) -> np.ndarray:
    """[N ints] -> (N, 8) uint32 packed (raw 32-byte LE view; no widening)."""
    buf = b"".join(v.to_bytes(32, "little") for v in vs)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vs), NLIMBS // 2).copy()


def packed_to_u64(p) -> np.ndarray:
    """Host (..., 8) 32-bit packed words -> (..., 4) u64 (pure byte view)."""
    p = np.ascontiguousarray(_host(p)).view("<u4")
    return p.view("<u8").reshape(p.shape[:-1] + (4,))


class FieldSpec:
    """Per-modulus precomputed constants for limb arithmetic."""

    def __init__(self, name: str, modulus: int):
        self.name = name
        self.modulus = modulus
        self.n_list = [(modulus >> (W * i)) & MASK for i in range(NLIMBS)]
        self.n_limbs = int_to_limbs(modulus)
        self.n0inv = (-pow(modulus, -1, 1 << W)) % (1 << W)  # -p^-1 mod 2^16
        self.r = (1 << (W * NLIMBS)) % modulus  # R mod p
        self.r2 = (self.r * self.r) % modulus  # R^2 mod p (to_mont factor)
        self.r2_limbs = int_to_limbs(self.r2)
        self.one_mont = int_to_limbs(self.r)  # 1 in Montgomery form
        self.one_plain = int_to_limbs(1)
        self.zero = np.zeros(NLIMBS, dtype=np.int32)
        self._cols: dict = {}

    def n_col(self, device, ndim: int, dtype=DTYPE) -> torch.Tensor:
        """The modulus limbs as a (16, 1, ..., 1) column of `dtype` on
        `device` (cached: a constant, never mutated)."""
        key = (str(device), ndim, dtype)
        t = self._cols.get(key)
        if t is None:
            t = torch.tensor(self.n_list, dtype=dtype, device=device)
            t = self._cols[key] = t.view((NLIMBS,) + (1,) * ndim)
        return t

    def one_col(self, device) -> torch.Tensor:
        """1 in Montgomery form as a (16, 1) int32 column on `device`: the Y
        of the projective identity (0 : 1 : 0). Cached, never mutated."""
        key = ("one", str(device))
        t = self._cols.get(key)
        if t is None:
            t = self._cols[key] = const(self.one_mont, device)[:, None].contiguous()
        return t

    # --- host-side conversion helpers (exactness oracle boundary) -----
    def to_mont_host(self, v: int) -> np.ndarray:
        return int_to_limbs((v * self.r) % self.modulus)

    def from_mont_host(self, limbs) -> int:
        rinv = pow(self.r, -1, self.modulus)
        return (limbs_to_int(limbs) * rinv) % self.modulus

    def array_to_mont(self, vs: list[int]) -> np.ndarray:
        return ints_to_limbs([(v * self.r) % self.modulus for v in vs])

    def array_from_mont(self, a) -> list[int]:
        rinv = pow(self.r, -1, self.modulus)
        return [(v * rinv) % self.modulus for v in limbs_to_ints(a)]


FP = FieldSpec("fp", Fp.MODULUS)
FQ = FieldSpec("fq", Fq.MODULUS)
FIELDS = {"fp": FP, "fq": FQ}


# ---------------------------------------------------------------------------
# limb-major int32 cores: x is (16, ...) with row i = limb i
# ---------------------------------------------------------------------------


def _carry(t: torch.Tensor):
    """Ripple-carry a loose nonnegative (K, ...) limb tensor into canonical
    16-bit limbs. Returns (canonical (K, ...), final carry (...))."""
    out = torch.empty_like(t)
    carry = torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        v = t[i] + carry
        out[i] = v & MASK
        carry = v >> W
    return out, carry


_LIMB_SHIFTS: dict = {}


def _lookahead(gen: torch.Tensor, prop: torch.Tensor):
    """Carries (or borrows) of a 16-limb chain from per-limb generate and
    propagate flags (bool (16, ...), never both set): returns the carry into
    each limb (int32 (16, ...)) and the carry out (int32 (...)). With the
    flags packed as bit masks G and P, the carries into the limbs are the
    carries of the integer sum (G | P) + G, read off as ((G | P) + G) ^ (G | P) ^ G.
    A handful of whole-tensor ops in place of a 16-step ripple of row ops."""
    key = (str(gen.device), gen.dim())
    sh = _LIMB_SHIFTS.get(key)
    if sh is None:
        sh = _LIMB_SHIFTS[key] = torch.arange(
            NLIMBS, dtype=DTYPE, device=gen.device).view((NLIMBS,) + (1,) * (gen.dim() - 1))
    g = (gen.to(DTYPE) << sh).sum(0, dtype=DTYPE)  # 16-bit masks: int32 holds the sums
    a = g | (prop.to(DTYPE) << sh).sum(0, dtype=DTYPE)
    c = (a + g) ^ a ^ g
    return (c.unsqueeze(0) >> sh) & 1, (c >> NLIMBS) & 1


def _carry01(s: torch.Tensor):
    """Canonical limbs and carry out of an int32 (16, ...) limb sum whose
    limbs are at most 2*MASK (every carry is 0 or 1)."""
    into, out = _lookahead(s > MASK, s == MASK)
    return (s + into) & MASK, out


def _borrow(d: torch.Tensor, sub: torch.Tensor):
    """(d - sub) as canonical limbs and the borrow out (0/1), for canonical
    int32 limb tensors (16, ...) d and `sub` (broadcastable to d)."""
    v = d - sub
    into, out = _lookahead(v < 0, v == 0)
    return (v - into) & MASK, out


def _reduce(a16: torch.Tensor, hi: torch.Tensor, spec: FieldSpec):
    """Conditional subtract: a16 + hi*2^256 reduced mod p, assuming < 2p."""
    d, borrow = _borrow(a16, spec.n_col(a16.device, a16.dim() - 1))
    ge = (borrow == 0) | (hi > 0)
    return torch.where(ge, d, a16)


def lm_add(a, b, spec: FieldSpec):
    """(a + b) mod p on limb-major int32 tensors."""
    s, carry = _carry01(a + b)
    return _reduce(s, carry, spec)


def lm_sub(a, b, spec: FieldSpec):
    """(a - b) mod p on limb-major int32 tensors."""
    a, b = torch.broadcast_tensors(a, b)
    diff, borrow = _borrow(a, b)
    fixed, _ = _carry01(diff + borrow * spec.n_col(a.device, a.dim() - 1))
    return fixed


def lm_mul(a, b, spec: FieldSpec):
    """Montgomery product a*b*R^-1 mod p on limb-major int32 tensors.

    Word-wise CIOS with 16-bit digits over a loose accumulator of 32 rows:
    iteration i adds a_i*b and m_i*p at offset i and moves row i's carry up,
    so no row is ever shifted. The result is (a*b + m*p) / R for the unique
    m = -a*b*p^-1 mod R, reduced once — the value every CIOS variant (16- or
    32-bit digits) computes, bit for bit.

    The accumulator is float64, whose integers are exact below 2^53: every
    row stays below 2^38 (at most 32 products below 2^32 plus a carry), and
    the carry out of row i is an exact division, as the row is then a
    multiple of 2^16. A float64 multiply-add is several times faster than an
    int64 product on a CPU."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    n_col = spec.n_col(a.device, len(shape), torch.float64)
    n0inv = spec.n0inv
    af, bf = a.to(torch.float64), b.to(torch.float64)
    t = torch.zeros((2 * NLIMBS,) + shape, dtype=torch.float64, device=a.device)
    for i in range(NLIMBS):
        ti = t[i : i + NLIMBS]
        ti.addcmul_(af[i], bf)
        m = ((t[i].to(torch.int64) & MASK) * n0inv) & MASK
        ti.addcmul_(m.to(torch.float64), n_col)
        t[i + 1] += t[i] * (1.0 / (1 << W))
    out, carry = _carry(t[NLIMBS:].to(torch.int64))
    return _reduce(out.to(DTYPE), carry.to(DTYPE), spec)


def to_lm(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 -> contiguous limb-major (16, ...) int32."""
    return a.movedim(-1, 0).contiguous()


def from_lm(x: torch.Tensor) -> torch.Tensor:
    """Limb-major (16, ...) int32 -> contiguous (..., 16) int32."""
    return x.movedim(0, -1).contiguous()


def const(vals, device) -> torch.Tensor:
    """Host limbs (..., 16) -> int32 tensor on `device`."""
    return torch.as_tensor(np.asarray(vals, dtype=np.int32), device=device)


def _lm_pair(a: torch.Tensor, b: torch.Tensor):
    """Two (..., 16) operands -> limb-major int32 views whose batch dims
    broadcast against each other (numpy rules on the batch shapes)."""
    nd = max(a.dim(), b.dim()) - 1
    xa, xb = to_lm(a), to_lm(b)
    xa = xa.view((NLIMBS,) + (1,) * (nd - a.dim() + 1) + tuple(xa.shape[1:]))
    xb = xb.view((NLIMBS,) + (1,) * (nd - b.dim() + 1) + tuple(xb.shape[1:]))
    return xa, xb


# ---------------------------------------------------------------------------
# (..., 16) int32 API
# ---------------------------------------------------------------------------


def add(a, b, spec: FieldSpec):
    """(a + b) mod p, canonical limbs in/out."""
    return from_lm(lm_add(*_lm_pair(a, b), spec))


def sub(a, b, spec: FieldSpec):
    """(a - b) mod p."""
    return from_lm(lm_sub(*_lm_pair(a, b), spec))


def neg(a, spec: FieldSpec):
    return sub(torch.zeros_like(a), a, spec)


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product: a*b*R^-1 mod p. Inputs/outputs canonical 16-bit limbs."""
    return from_lm(lm_mul(*_lm_pair(a, b), spec))


def mont_square(a, spec: FieldSpec):
    return mont_mul(a, a, spec)


def to_mont(a, spec: FieldSpec):
    return mont_mul(a, const(spec.r2_limbs, a.device), spec)


def from_mont(a, spec: FieldSpec):
    return mont_mul(a, const(spec.one_plain, a.device), spec)


def mont_pow(a, e: int, spec: FieldSpec):
    """a^e (a in Montgomery form), square-and-multiply with static exponent."""
    result = const(spec.one_mont, a.device).expand(a.shape).contiguous()
    base = a
    while e:
        if e & 1:
            result = mont_mul(result, base, spec)
        e >>= 1
        if e:
            base = mont_square(base, spec)
    return result


def mont_inv(a, spec: FieldSpec):
    """Batched inversion via Fermat (a^(p-2)), MSB-first square-and-multiply
    over the static exponent bits; a in Montgomery form (0 maps to 0)."""
    x = to_lm(a)
    e = spec.modulus - 2
    r = to_lm(const(spec.one_mont, a.device).expand(a.shape))
    for i in range(e.bit_length() - 1, -1, -1):
        r = lm_mul(r, r, spec)
        if (e >> i) & 1:
            r = lm_mul(r, x, spec)
    return from_lm(r)


def select(cond, a, b):
    """cond ? a : b over limb tensors; cond shape broadcastable to batch."""
    return torch.where(cond[..., None], a, b)


def is_zero(a):
    return torch.all(a == 0, dim=-1)
