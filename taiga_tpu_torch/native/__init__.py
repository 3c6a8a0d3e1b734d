"""ctypes bindings for the native host crypto engine (src/pasta_host.cpp).

Copy of taiga_tpu/native. The shared library is built on demand with the
system toolchain (g++) and cached next to the source (listed in .gitignore).
If no compiler is available `lib()` returns None; the port's keygen, IPA
open and IPA verify then raise (they have no other implementation).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "src", "pasta_host.cpp")
_SO = os.path.join(_DIR, "libpasta_host.so")

_lock = threading.Lock()
_lib = None
_tried = False

FIELD_FP = 0
FIELD_FQ = 1


def _build() -> bool:
    # -march=native: the CIOS inner loop picks up mulx/adcx carry chains
    # (~1.5-2x on mont_mul); the library is built on the machine it runs on,
    # so native codegen is always safe here. Each process builds into its own
    # file and renames it into place, so a process that loads the library
    # while another builds it (parallel test workers) never reads a partial one.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for flags in (["-O3", "-march=native", "-fopenmp"],
                  ["-O3", "-fopenmp"], ["-O3"]):
        try:
            subprocess.run(
                ["g++", *flags, "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=240,
            )
            os.replace(tmp, _SO)
            return True
        except Exception:
            continue
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def lib():
    """The loaded+initialized shared library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            so = ctypes.CDLL(_SO)
        except OSError:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        so.taiga_field_init.argtypes = [ctypes.c_int, u64p]
        so.taiga_mont_mul_batch.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_long]
        so.taiga_mod_add_batch.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_long]
        so.taiga_poseidon_init.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_int, ctypes.c_int]
        so.taiga_poseidon_permute_batch.argtypes = [ctypes.c_int, u64p, ctypes.c_long]
        so.taiga_poseidon_hash2_chain.argtypes = [
            ctypes.c_int, u64p, u64p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        so.taiga_ec_add.argtypes = [ctypes.c_int, u64p, u64p, u64p]
        so.taiga_ec_scalar_mul.argtypes = [ctypes.c_int, u64p, u64p, u64p]
        so.taiga_ec_msm.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_long]
        so.taiga_vec_to_mont.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_vec_from_mont.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        for nm in ("taiga_vec_mul", "taiga_vec_add", "taiga_vec_sub"):
            getattr(so, nm).argtypes = [
                ctypes.c_int, u64p, u64p, u64p, ctypes.c_long, ctypes.c_long,
            ]
        so.taiga_vec_neg.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_vec_sum.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_poly_divide.argtypes = [ctypes.c_int, u64p, u64p, u64p, ctypes.c_long]
        so.taiga_ec_fold.argtypes = [ctypes.c_int, u64p, u64p, u64p, u64p, ctypes.c_long]
        so.taiga_ec_fold2.argtypes = [
            ctypes.c_int, u64p, u64p, u64p,
            u64p, ctypes.c_int, u64p, ctypes.c_int, u64p, ctypes.c_long,
        ]
        so.taiga_vec_cumprod.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_vec_batch_inv.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_vec_powers.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_long]
        so.taiga_mont_inv_one.argtypes = [ctypes.c_int, u64p, u64p]
        so.taiga_ntt.argtypes = [
            ctypes.c_int, u64p, ctypes.c_long, ctypes.c_int, u64p, ctypes.c_int,
        ]
        so.taiga_poly_eval_many.argtypes = [
            ctypes.c_int, u64p, u64p, u64p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        so.taiga_ec_msm_many.argtypes = [
            ctypes.c_int, u64p, u64p, u64p, ctypes.c_long, ctypes.c_long,
        ]
        so.taiga_tape_eval.argtypes = [
            ctypes.c_int, u64p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            u64p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        so.taiga_point_decompress.argtypes = [
            ctypes.c_int, u64p, u8p, u64p, u8p, u64p, ctypes.c_long,
        ]
        _init_constants(so)
        _lib = so
        return _lib


def _ints_to_u64(vals: list[int]) -> "ctypes.Array":
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return (ctypes.c_uint64 * (4 * len(vals))).from_buffer_copy(buf)


def _u64_to_ints(arr, n: int) -> list[int]:
    raw = bytes(bytearray(arr))[: 32 * n]
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(n)]


def _init_constants(so):
    from ..crypto import poseidon as hp
    from ..crypto.fields import Fp, Fq

    for fid, field in ((FIELD_FP, Fp), (FIELD_FQ, Fq)):
        so.taiga_field_init(fid, _ints_to_u64([field.MODULUS]))
    # Poseidon parameters exist for Fp (the protocol hash field)
    mds_flat = [hp.MDS[i][j] for i in range(3) for j in range(3)]
    rc_flat = [hp.ROUND_CONSTANTS[r][i] for r in range(len(hp.ROUND_CONSTANTS)) for i in range(3)]
    so.taiga_poseidon_init(
        FIELD_FP, _ints_to_u64(mds_flat), _ints_to_u64(rc_flat),
        hp.FULL_ROUNDS, hp.PARTIAL_ROUNDS,
    )


def poseidon_permute_ints(state: list[int]) -> list[int] | None:
    """One Fp Poseidon permutation via the native engine (None if absent)."""
    so = lib()
    if so is None:
        return None
    arr = _ints_to_u64(state)
    so.taiga_poseidon_permute_batch(FIELD_FP, arr, 1)
    return _u64_to_ints(arr, 3)


def merkle_fold(leaf: int, siblings: list[int], is_left: list[bool]) -> int | None:
    """Poseidon-2 Merkle chain fold via the native engine (None if absent)."""
    so = lib()
    if so is None:
        return None
    out = _ints_to_u64([leaf])
    sib = _ints_to_u64(siblings)
    flags = (ctypes.c_uint8 * len(is_left))(*[1 if b else 0 for b in is_left])
    so.taiga_poseidon_hash2_chain(FIELD_FP, out, sib, flags, len(is_left))
    return _u64_to_ints(out, 1)[0]


# --- EC (affine plain-form x|y|inf tuples across the FFI) -------------------


def _pt_to_u64(pt: tuple[int, int, bool]):
    x, y, inf = pt
    buf = x.to_bytes(32, "little") + y.to_bytes(32, "little") \
        + (1 if inf else 0).to_bytes(8, "little")
    return (ctypes.c_uint64 * 9).from_buffer_copy(buf)


def _u64_to_pt(arr) -> tuple[int, int, bool]:
    raw = bytes(bytearray(arr))
    return (
        int.from_bytes(raw[:32], "little"),
        int.from_bytes(raw[32:64], "little"),
        bool(arr[8]),
    )


def ec_scalar_mul(field_id: int, pt: tuple[int, int, bool], scalar: int):
    """[scalar] pt on y^2 = x^3 + 5 over the given coordinate field; returns
    (x, y, inf) or None if the engine is unavailable."""
    so = lib()
    if so is None:
        return None
    out = (ctypes.c_uint64 * 9)()
    so.taiga_ec_scalar_mul(field_id, out, _pt_to_u64(pt),
                           _ints_to_u64([scalar]))
    return _u64_to_pt(out)


def ec_add(field_id: int, a: tuple[int, int, bool], b: tuple[int, int, bool]):
    so = lib()
    if so is None:
        return None
    out = (ctypes.c_uint64 * 9)()
    so.taiga_ec_add(field_id, out, _pt_to_u64(a), _pt_to_u64(b))
    return _u64_to_pt(out)


def ec_msm(field_id: int, pts: list[tuple[int, int, bool]], scalars: list[int]):
    """sum_i [scalars[i]] pts[i], or None if the engine is unavailable."""
    so = lib()
    if so is None:
        return None
    n = len(pts)
    buf = b"".join(
        x.to_bytes(32, "little") + y.to_bytes(32, "little")
        + (1 if inf else 0).to_bytes(8, "little")
        for x, y, inf in pts
    )
    parr = (ctypes.c_uint64 * (9 * n)).from_buffer_copy(buf)
    sarr = _ints_to_u64(scalars)
    out = (ctypes.c_uint64 * 9)()
    so.taiga_ec_msm(field_id, out, parr, sarr, n)
    return _u64_to_pt(out)
