"""IPA structured reference string over Vesta.

Params(k): n = 2^k independent generators G_i plus the blinding generator W
and the inner-product generator U — all derived by hash-to-curve (no trusted
setup; nothing-up-my-sleeve, mirroring halo2's `Params::new`, cf. the embedded
`params/params_15` in the reference, taiga_halo2/src/constant.rs:128-139).

Generation is host-side and slow (~1 ms/point), so Params are cached to disk
(.npz of affine coordinates) and memory-cached per k.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..crypto.curves import VestaPoint, vesta_hash_to_curve
from ..crypto.fields import Fq

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "params")


class Params:
    def __init__(self, k: int, g: list[VestaPoint], w: VestaPoint, u: VestaPoint):
        self.k = k
        self.n = 1 << k
        self.g = g
        self.w = w
        self.u = u

    @classmethod
    def new(cls, k: int) -> "Params":
        g = [vesta_hash_to_curve("taiga-tpu-srs", b"G" + i.to_bytes(4, "little")) for i in range(1 << k)]
        w = vesta_hash_to_curve("taiga-tpu-srs", b"W")
        u = vesta_hash_to_curve("taiga-tpu-srs", b"U")
        return cls(k, g, w, u)

    # --- disk cache ---------------------------------------------------
    def save(self, path: str):
        xs = np.array([p.x.v.to_bytes(32, "little") for p in self.g + [self.w, self.u]])
        ys = np.array([p.y.v.to_bytes(32, "little") for p in self.g + [self.w, self.u]])
        np.savez_compressed(path, k=self.k, xs=xs, ys=ys)

    @classmethod
    def load(cls, path: str) -> "Params":
        data = np.load(path)
        k = int(data["k"])
        pts = [
            VestaPoint(Fq(int.from_bytes(bytes(x), "little")), Fq(int.from_bytes(bytes(y), "little")))
            for x, y in zip(data["xs"], data["ys"])
        ]
        for p in pts[:4]:
            assert p.is_on_curve()
        return cls(k, pts[:-2], pts[-2], pts[-1])


@lru_cache(maxsize=None)
def get_params(k: int) -> Params:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, f"srs_{k}.npz")
    if os.path.exists(path):
        return Params.load(path)
    params = Params.new(k)
    params.save(path)
    return params


@lru_cache(maxsize=None)
def srs_device(k: int):
    """SRS generators as device-ready Jacobian limb arrays (numpy, cached)."""
    from ..ops import ec

    return ec.points_to_device(get_params(k).g)
