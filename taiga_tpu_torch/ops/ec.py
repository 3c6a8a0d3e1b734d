"""Host <-> device codecs for Pasta curve points as limb tensors.

Port of the codecs of taiga_tpu/ops/ec.py. Device points are Jacobian
(X, Y, Z) triples of (..., 16) int32 Montgomery limbs (Z = 0 encodes the
identity); Pallas coordinates lie in Fp, Vesta's in Fq. The group law on the
device is the projective kernel of ops/ff_kernels.py.
"""

from __future__ import annotations

import numpy as np

from ..crypto.curves import CurvePoint
from ..crypto.fields import Fp
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
