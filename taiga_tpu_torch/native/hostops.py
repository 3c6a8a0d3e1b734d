"""Numpy-array bindings for the native host engine (src/pasta_host.cpp).

Field elements live in numpy arrays of shape (..., 4) uint64 little-endian
limbs, usually in Montgomery form (conversions at the edges). These back the
host prover pipeline (plonk/host_engine.py) and the fast verifier — the CPU
counterpart of ops/limbs.py's (..., 16) uint32 device convention.

Layout bridges:
  device (..., 16) uint32 16-bit limbs  <->  host (..., 4) uint64 limbs
via a pure view/cast round-trip (no per-element Python).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import FIELD_FP, FIELD_FQ, lib  # noqa: F401 (re-export field ids)

U64 = np.dtype("<u8")


def available() -> bool:
    return lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def u16_to_u64(a: np.ndarray) -> np.ndarray:
    """(..., 16) uint32 (16-bit limb values) -> (..., 4) uint64."""
    a = np.ascontiguousarray(a)
    return a.astype("<u2").view(U64).reshape(a.shape[:-1] + (4,))


def u64_to_u16(a: np.ndarray) -> np.ndarray:
    """(..., 4) uint64 -> (..., 16) uint32 16-bit limbs."""
    a = np.ascontiguousarray(a, dtype=U64)
    return a.view("<u2").astype(np.uint32).reshape(a.shape[:-1] + (16,))


def ints_to_u64(vs: list[int]) -> np.ndarray:
    buf = b"".join(v.to_bytes(32, "little") for v in vs)
    return np.frombuffer(buf, dtype=U64).reshape(len(vs), 4).copy()


def u64_to_ints(a: np.ndarray) -> list[int]:
    a = np.ascontiguousarray(a, dtype=U64).reshape(-1, 4)
    buf = a.tobytes()
    return [int.from_bytes(buf[32 * i : 32 * i + 32], "little") for i in range(a.shape[0])]


def _flat(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=U64).reshape(-1, 4)


def to_mont(field: int, a: np.ndarray) -> np.ndarray:
    f = _flat(a)
    out = np.empty_like(f)
    lib().taiga_vec_to_mont(field, _ptr(out), _ptr(f), f.shape[0])
    return out.reshape(a.shape)


def from_mont(field: int, a: np.ndarray) -> np.ndarray:
    f = _flat(a)
    out = np.empty_like(f)
    lib().taiga_vec_from_mont(field, _ptr(out), _ptr(f), f.shape[0])
    return out.reshape(a.shape)


def _binop(name: str, field: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fa = _flat(a)
    if b.ndim == 1 or (b.size == 4 and fa.shape[0] != 1):
        fb = _flat(b)
        stride = 0
    else:
        fb = _flat(np.broadcast_to(b, a.shape))
        stride = 1
    out = np.empty_like(fa)
    getattr(lib(), name)(field, _ptr(out), _ptr(fa), _ptr(fb), fa.shape[0], stride)
    return out.reshape(a.shape)


def vec_mul(field: int, a, b):
    """Montgomery product; b broadcasts when it is a single element (4,)."""
    return _binop("taiga_vec_mul", field, a, b)


def vec_add(field: int, a, b):
    return _binop("taiga_vec_add", field, a, b)


def vec_sub(field: int, a, b):
    return _binop("taiga_vec_sub", field, a, b)


def vec_neg(field: int, a):
    f = _flat(a)
    out = np.empty_like(f)
    lib().taiga_vec_neg(field, _ptr(out), _ptr(f), f.shape[0])
    return out.reshape(a.shape)


def vec_sum(field: int, a) -> np.ndarray:
    """Modular sum over all elements -> (4,)."""
    f = _flat(a)
    out = np.empty((1, 4), dtype=U64)
    lib().taiga_vec_sum(field, _ptr(out), _ptr(f), f.shape[0])
    return out[0]


def poly_divide(field: int, coeffs: np.ndarray, x_mont: np.ndarray) -> np.ndarray:
    """(A(X) - A(x)) / (X - x) for coeffs (n, 4) Montgomery; q_{n-1} = 0."""
    c = _flat(coeffs)
    x = _flat(x_mont)
    out = np.empty_like(c)
    lib().taiga_poly_divide(field, _ptr(out), _ptr(c), _ptr(x), c.shape[0])
    return out.reshape(coeffs.shape)


def ec_fold(field: int, lo9: np.ndarray, hi9: np.ndarray, scalar: int) -> np.ndarray:
    """out_i = lo_i + [scalar] hi_i over (n, 9) u64 affine plain rows.
    GLV-accelerated: the 255-bit scalar splits into two ~128-bit halves via
    the cube-root-of-unity endomorphism (crypto/curves.glv_split), and the
    native side runs a joint-wNAF shared double chain (taiga_ec_fold2)."""
    from ..crypto.curves import PallasPoint, VestaPoint, glv_constants, glv_split

    lo = np.ascontiguousarray(lo9, dtype=U64)
    hi = np.ascontiguousarray(hi9, dtype=U64)
    out = np.empty_like(lo)
    curve = PallasPoint if field == FIELD_FP else VestaPoint
    zeta, _, _ = glv_constants(curve)
    k1, k2 = glv_split(curve, scalar)
    lib().taiga_ec_fold2(
        field, _ptr(out), _ptr(lo), _ptr(hi),
        _ptr(ints_to_u64([abs(k1)])), 1 if k1 < 0 else 0,
        _ptr(ints_to_u64([abs(k2)])), 1 if k2 < 0 else 0,
        _ptr(ints_to_u64([zeta])), lo.shape[0],
    )
    return out


def cumprod(field: int, a: np.ndarray) -> np.ndarray:
    f = _flat(a)
    out = np.empty_like(f)
    lib().taiga_vec_cumprod(field, _ptr(out), _ptr(f), f.shape[0])
    return out.reshape(a.shape)


def batch_inv(field: int, a: np.ndarray) -> np.ndarray:
    f = _flat(a)
    out = np.empty_like(f)
    lib().taiga_vec_batch_inv(field, _ptr(out), _ptr(f), f.shape[0])
    return out.reshape(a.shape)


def powers(field: int, x_mont: np.ndarray, n: int) -> np.ndarray:
    """[1, x, ..., x^(n-1)] Montgomery, (n, 4)."""
    x = _flat(x_mont)
    out = np.empty((n, 4), dtype=U64)
    lib().taiga_vec_powers(field, _ptr(out), _ptr(x), n)
    return out


def inv_one(field: int, a_mont: np.ndarray) -> np.ndarray:
    a = _flat(a_mont)
    out = np.empty((1, 4), dtype=U64)
    lib().taiga_mont_inv_one(field, _ptr(out), _ptr(a))
    return out[0]


def ntt(field: int, data: np.ndarray, k: int, omega_plain: int,
        inverse: bool = False) -> np.ndarray:
    """Radix-2 NTT over rows: data (..., 2^k, 4) Montgomery in/out. Pass the
    INVERSE root as omega_plain together with inverse=True for an iNTT (the
    flag only adds the n^-1 scaling)."""
    n = 1 << k
    a = np.ascontiguousarray(data, dtype=U64).reshape(-1, n, 4).copy()
    om = ints_to_u64([omega_plain])
    lib().taiga_ntt(field, _ptr(a), a.shape[0], k, _ptr(om), 1 if inverse else 0)
    return a.reshape(data.shape)


def poly_eval_many(field: int, coeffs: np.ndarray, points: np.ndarray) -> np.ndarray:
    """coeffs (C, n, 4) x points (Q, 4), all Montgomery -> (Q, C, 4)."""
    c = np.ascontiguousarray(coeffs, dtype=U64)
    p = np.ascontiguousarray(points, dtype=U64)
    C, n = c.shape[0], c.shape[1]
    Q = p.shape[0]
    out = np.empty((Q, C, 4), dtype=U64)
    lib().taiga_poly_eval_many(field, _ptr(out), _ptr(c), _ptr(p), C, n, Q)
    return out


def msm(field: int, pts9: np.ndarray, scalars_plain: np.ndarray) -> tuple[int, int, bool]:
    """Pippenger MSM. pts9: (n, 9) uint64 plain-form affine rows
    (x limbs | y limbs | inf flag); scalars_plain: (n, 4) uint64 plain form.
    Returns the affine result as (x, y, inf) ints."""
    p = np.ascontiguousarray(pts9, dtype=U64)
    s = np.ascontiguousarray(scalars_plain, dtype=U64)
    out = np.zeros(9, dtype=U64)
    lib().taiga_ec_msm(field, _ptr(out), _ptr(p), _ptr(s), p.shape[0])
    raw = out.tobytes()
    return (
        int.from_bytes(raw[:32], "little"),
        int.from_bytes(raw[32:64], "little"),
        bool(out[8]),
    )


def msm_many(field: int, pts9: np.ndarray, scalars_plain: np.ndarray) -> np.ndarray:
    """C MSMs over the same base: pts9 (n, 9) u64, scalars (C, n, 4) plain
    -> (C, 9) u64 affine plain rows."""
    p = np.ascontiguousarray(pts9, dtype=U64)
    s = np.ascontiguousarray(scalars_plain, dtype=U64)
    C, n = s.shape[0], s.shape[1]
    out = np.zeros((C, 9), dtype=U64)
    lib().taiga_ec_msm_many(field, _ptr(out), _ptr(p), _ptr(s), C, n)
    return out


def tape_eval(field: int, code: np.ndarray, scalars_mont: np.ndarray,
              tables: list[np.ndarray], domain: int, num_regs: int,
              out_reg: int) -> np.ndarray:
    """Run a compiled constraint tape (plonk/tape.py) over the whole domain.
    tables[t] is a (cols_t, domain, 4) u64 Montgomery stack; returns the
    accumulator column (domain, 4) Montgomery."""
    c = np.ascontiguousarray(code, dtype=np.int32)
    s = np.ascontiguousarray(scalars_mont, dtype=U64) if scalars_mont.size \
        else np.zeros((1, 4), dtype=U64)
    tbls = [np.ascontiguousarray(t, dtype=U64) for t in tables]
    ptrs = (ctypes.c_void_p * len(tbls))(
        *[t.ctypes.data_as(ctypes.c_void_p) for t in tbls]
    )
    out = np.empty((domain, 4), dtype=U64)
    lib().taiga_tape_eval(
        field, _ptr(out), c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c.shape[0], _ptr(s), ptrs, domain, num_regs, out_reg,
    )
    return out


def points_to_rows(points) -> np.ndarray:
    """List of curve points (crypto.curves affine API) -> (n, 9) u64 rows."""
    buf = bytearray()
    for pt in points:
        if pt.is_identity():
            buf += b"\x00" * 64 + (1).to_bytes(8, "little")
        else:
            buf += pt.x.v.to_bytes(32, "little") + pt.y.v.to_bytes(32, "little")
            buf += (0).to_bytes(8, "little")
    return np.frombuffer(bytes(buf), dtype=U64).reshape(len(points), 9).copy()


def point_decompress_vesta(raws: list[bytes]):
    """Batch-decompress pasta-compressed Vesta points (32-byte encodings,
    y-parity in the top bit). Returns (xy (n, 8) u64 plain affine, ok (n,)
    uint8). Identity encodings are the CALLER's business (LazyPoint never
    holds one). ~66 Python Tonelli sqrts/proof collapse into one call."""
    n = len(raws)
    buf = np.frombuffer(b"".join(raws), dtype=np.uint8).reshape(n, 32).copy()
    signs = np.ascontiguousarray(buf[:, 31] >> 7)
    buf[:, 31] &= 0x7F
    xs = np.ascontiguousarray(buf).view(U64).reshape(n, 4)
    out = np.empty((n, 8), dtype=U64)
    ok = np.zeros(n, dtype=np.uint8)
    b_const = np.asarray([5, 0, 0, 0], dtype=U64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib().taiga_point_decompress(
        FIELD_FQ, _ptr(out), ok.ctypes.data_as(u8p), _ptr(xs),
        signs.ctypes.data_as(u8p), _ptr(b_const), n,
    )
    return out, ok
