"""Fused 255-bit field and curve kernels: hand-written CUDA for Hopper, each
beside its plain PyTorch version.

Port of taiga_tpu/ops/ff_kernels.py. Layout is the reference's limb-major
one: a batch of B field elements is a (16, B) int32 tensor (16-bit limbs,
Montgomery form), limbs on rows and the batch on the fast axis, so a CUDA
warp's lanes read neighbouring words.

  K1 mont_mul_lm        a*b*R^-1 mod p          csrc/mont_mul.cu
  K2 ec_add_proj_lm     complete projective add csrc/ec_add_proj.cu
  K3 ec_add_proj_sel_lm sel ? P1 + P2 : P1      csrc/ec_add_proj.cu
  (K4, the tape interpreter, is ops/tape_device.py + csrc/tape_eval.cu.)

Dispatch is by the tensors' device: on the CPU a wrapper runs the plain
version; on a CUDA tensor it launches its kernel or raises. `plain_versions()`
forces the plain versions on the card too — the twin run that holds a whole
proof made by the kernels against one made without them. Every wrapper
counts its kernel launches in `<wrapper>.launches`.

Field constants are keyed by the field's name ("fp" or "fq"); nothing is
inferred from n0inv, which both Pasta primes share.
"""

from __future__ import annotations

import contextlib

import torch

from . import cuda_kernels as CK
from . import limbs as L

NLIMBS = 16

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within this block every wrapper (K1-K4) runs its plain version, on
    any device. Used to hold the kernels' results against the plain path."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its CUDA kernel: the inputs lie on
    a CUDA device (all on the same one) and plain versions are not forced."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu" or _force_plain:
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check_lm(name: str, t: torch.Tensor, rows: int, B: int):
    if t.dtype != L.DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {L.DTYPE}")
    if t.shape != (rows, B):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(rows, B)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _spec(field: str) -> L.FieldSpec:
    return L.FIELDS[field]


# ---------------------------------------------------------------------------
# plain versions (limb-major int32 in and out)
# ---------------------------------------------------------------------------


def _mm_cios(a, b, field: str):
    """Montgomery product of limb-major int32 tensors (reference _mm_cios)."""
    return L.lm_mul(a, b, _spec(field))


def _madd(a, b, field: str):
    return L.lm_add(a, b, _spec(field))


def _msub(a, b, field: str):
    return L.lm_sub(a, b, _spec(field))


def _mul15(t, field: str):
    """15*t via 16t - t (4 doublings + a subtract) — b3 = 3b = 15 for both
    Pasta curves (b = 5)."""
    d = _madd(t, t, field)
    d = _madd(d, d, field)
    d = _madd(d, d, field)
    d = _madd(d, d, field)
    return _msub(d, t, field)


def _ec_add_proj_core(x1, y1, z1, x2, y2, z2, field: str):
    """Complete homogeneous-projective addition for a = 0, b3 = 15
    (Renes-Costello-Batina 2015, Algorithm 7). Handles identity (0:1:0) and
    doubling with NO case analysis — 12 muls + 2 cheap b3 scalings."""
    mm = lambda a, b: _mm_cios(a, b, field)
    add = lambda a, b: _madd(a, b, field)
    sub = lambda a, b: _msub(a, b, field)

    t0 = mm(x1, x2)
    t1 = mm(y1, y2)
    t2 = mm(z1, z2)
    t3 = mm(add(x1, y1), add(x2, y2))
    t3 = sub(t3, add(t0, t1))
    t4 = mm(add(y1, z1), add(y2, z2))
    t4 = sub(t4, add(t1, t2))
    x3 = mm(add(x1, z1), add(x2, z2))
    y3 = sub(x3, add(t0, t2))
    x3 = add(t0, t0)
    t0 = add(x3, t0)
    t2 = _mul15(t2, field)
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    y3 = _mul15(y3, field)
    x3 = sub(mm(t3, t1), mm(t4, y3))
    y3 = add(mm(y3, t0), mm(t1, z3))
    t0 = mm(t0, t3)
    z3 = add(mm(z3, t4), t0)
    return x3, y3, z3


def mont_mul_plain(a, b, field: str = "fq"):
    """Plain version of K1: (16, B) x (16, B) Montgomery product."""
    return _mm_cios(a, b, field)


def ec_add_proj_plain(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """Plain version of K2."""
    return _ec_add_proj_core(x1, y1, z1, x2, y2, z2, field)


def ec_add_proj_sel_plain(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """Plain version of K3: sel ? P1 + P2 : P1, lane-wise."""
    x3, y3, z3 = ec_add_proj_plain(x1, y1, z1, x2, y2, z2, field)
    m = sel[0] != 0
    return torch.where(m, x3, x1), torch.where(m, y3, y1), torch.where(m, z3, z1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def mont_mul_lm(a, b, field: str = "fq"):
    """K1: (16, B) x (16, B) Montgomery product."""
    B = a.shape[-1]
    check_lm("a", a, NLIMBS, B)
    check_lm("b", b, NLIMBS, B)
    if not use_kernel(a, b):
        return mont_mul_plain(a, b, field)
    out = torch.empty_like(a)
    so = CK.lib("mont_mul")
    CK.check(so.taiga_mont_mul(_ptr(a), _ptr(b), _ptr(out), B, CK.FIELD_IDS[field],
                               CK.stream_ptr(a.device)), "mont_mul")
    mont_mul_lm.launches += 1
    return out


def ec_add_proj_lm(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """K2: projective (RCB complete) addition over (16, B) limb-major points."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    if not use_kernel(*pts):
        return ec_add_proj_plain(*pts, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_add_proj(*map(_ptr, pts + outs), B, CK.FIELD_IDS[field],
                                  CK.stream_ptr(x1.device)), "ec_add_proj")
    ec_add_proj_lm.launches += 1
    return outs


def ec_add_proj_sel_lm(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """K3: projective add with lane select, sel ? P1 + P2 : P1. Points
    (16, B); sel (1, B) int32 (nonzero selects). Identity is (0 : 1 : 0)."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    check_lm("sel", sel, 1, B)
    if not use_kernel(*pts, sel):
        return ec_add_proj_sel_plain(*pts, sel, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_add_proj_sel(*map(_ptr, pts + (sel,) + outs), B,
                                      CK.FIELD_IDS[field], CK.stream_ptr(x1.device)),
             "ec_add_proj_sel")
    ec_add_proj_sel_lm.launches += 1
    return outs


mont_mul_lm.launches = 0
ec_add_proj_lm.launches = 0
ec_add_proj_sel_lm.launches = 0
