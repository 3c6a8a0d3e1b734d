"""Batched elliptic-curve arithmetic over the Pasta curves as limb tensors.

Port of taiga_tpu/ops/ec.py: the host <-> device codecs and the Jacobian
group law. Device points are Jacobian (X, Y, Z) triples of (..., 16) int32
Montgomery limbs (Z = 0 encodes the identity); Pallas coordinates lie in Fp,
Vesta's in Fq. Both are a = 0 curves, so one formula serves both with the
coordinate FieldSpec passed in.

The group law runs on the Jacobian kernels of ops/ff_kernels.py, on
limb-major (16, B) copies of the rows: ec_add is K6 (the complete add:
add and doubling both computed, then selected), ec_double the doubling
kernel (dbl-2009-l, no case analysis), and ec_scalar_mul_shared one
ec_ladder launch (K7 chained with the doubling: the whole double-and-add
ladder). On CPU tensors the wrappers run their plain versions, so the
results equal the reference's limb for limb (tests/test_torch_ec.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.curves import CurvePoint
from ..crypto.fields import Fp
from . import ff_kernels as FK
from . import limbs as L


def spec_for(curve: type[CurvePoint]) -> L.FieldSpec:
    return L.FP if curve.FIELD is Fp else L.FQ


def points_to_device(points: list[CurvePoint]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine host points -> Jacobian Montgomery limb arrays (z = 1 or 0)."""
    curve = type(points[0])
    spec = spec_for(curve)
    xs, ys, zs = [], [], []
    for pt in points:
        if pt.is_identity():
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt.x.v)
            ys.append(pt.y.v)
            zs.append(1)
    return (
        np.asarray(spec.array_to_mont(xs)),
        np.asarray(spec.array_to_mont(ys)),
        np.asarray(spec.array_to_mont(zs)),
    )


def points_from_device(xyz, curve: type[CurvePoint]) -> list[CurvePoint]:
    """Jacobian Montgomery limb arrays (numpy or tensors) -> affine host
    points (exact)."""
    spec = spec_for(curve)
    F = curve.FIELD
    x_i = spec.array_from_mont(xyz[0])
    y_i = spec.array_from_mont(xyz[1])
    z_i = spec.array_from_mont(xyz[2])
    out = []
    for xv, yv, zv in zip(x_i, y_i, z_i):
        if zv == 0:
            out.append(curve.identity())
        else:
            zinv = pow(zv, -1, F.MODULUS)
            zi2 = zinv * zinv % F.MODULUS
            out.append(
                curve(F(xv * zi2 % F.MODULUS), F(yv * zi2 % F.MODULUS * zinv % F.MODULUS))
            )
    return out


# --- group law --------------------------------------------------------------


def _to_lm(p):
    """Coordinates of (..., 16) rows -> their batch shape and (16, B)
    limb-major copies."""
    shape = tuple(p[0].shape[:-1])
    return shape, [v.reshape(-1, L.NLIMBS).T.contiguous() for v in p]


def _from_lm(shape, pts):
    return tuple(v.T.reshape(shape + (L.NLIMBS,)).contiguous() for v in pts)


def ec_double(p, spec: L.FieldSpec):
    """Jacobian doubling for a = 0 (dbl-2009-l). Identity-safe (Z3 = 2YZ = 0);
    also maps 2-torsion (Y = 0) to Z3 = 0 correctly."""
    shape, lm = _to_lm(p)
    return _from_lm(shape, FK.ec_double_lm(*lm, spec.name))


def ec_add(p, q, spec: L.FieldSpec):
    """Complete Jacobian addition (K6): the general add and the doubling are
    both computed and selected lane-wise. The two points' batch shapes
    broadcast."""
    shape, lm = _to_lm(torch.broadcast_tensors(*p, *q))
    return _from_lm(shape, FK.ec_add_lm(*lm, spec.name))


def ec_select(cond, p, q):
    """cond ? p : q lane-wise (cond: (...,) bool)."""
    return tuple(torch.where(cond[..., None], a, b) for a, b in zip(p, q))


def ec_scalar_mul_shared(p, scalar_limbs, spec: L.FieldSpec, bits: int = 255):
    """[s] P lane-wise where all lanes share ONE scalar (plain 16-bit limbs,
    shape (16,)). Double-and-add, LSB first, select on the shared bit — as
    the IPA generator fold uses it (G' = G_lo + [u^-1] G_hi). The whole
    ladder is one ec_ladder launch (K7 chained with the doubling); the
    reference's last doubling, whose result nothing reads, is left out."""
    shape, base = _to_lm(p)
    sl = torch.as_tensor(scalar_limbs, dtype=L.DTYPE, device=base[0].device)
    sl = sl.reshape(L.NLIMBS).contiguous()
    return _from_lm(shape, FK.ec_ladder_lm(*base, sl, bits, spec.name))


def ec_identity_like(p):
    return torch.zeros_like(p[0]), torch.zeros_like(p[1]), torch.zeros_like(p[2])


def ec_neg(p, spec: L.FieldSpec):
    x, y, z = p
    return x, L.neg(y, spec), z
