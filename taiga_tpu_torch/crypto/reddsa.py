"""RedDSA (re-randomizable Schnorr, Zcash-style) over Pallas.

Used for the transaction binding signature with basepoint = the Sinsemilla
"Taiga-NoteCommit-r" generator and challenge personalization
"Taiga_RedPallasH" (reference: taiga_halo2/src/binding_signature.rs:23-33,
backed by the heliaxdev `reddsa` fork).

Scheme (cofactor 1 on Pallas):
  sk: Fq scalar; vk = [sk] B (B = basepoint), encoded compressed (32 B).
  sign(msg): T <- 80 random bytes
             r = H*(T || vk_bytes || msg)      (H* = Blake2b-512, person=
             R = [r] B                          "Taiga_RedPallasH", wide-reduced)
             c = H*(R_bytes || vk_bytes || msg)
             s = r + c * sk
             sig = R_bytes(32) || s_bytes(32 LE)
  verify:    c = H*(R_bytes || vk_bytes || msg); accept iff [s] B == R + [c] vk.
"""

from __future__ import annotations

import hashlib
import secrets

from .curves import PallasPoint
from .fields import Fq

H_STAR_PERSONALIZATION = b"Taiga_RedPallasH"


def h_star(data: bytes) -> Fq:
    d = hashlib.blake2b(data, digest_size=64, person=H_STAR_PERSONALIZATION).digest()
    return Fq.from_uniform_bytes(d)


class BindingSignature:
    __slots__ = ("r_bytes", "s")

    def __init__(self, r_bytes: bytes, s: Fq):
        assert len(r_bytes) == 32
        self.r_bytes = r_bytes
        self.s = s

    def to_bytes(self) -> bytes:
        return self.r_bytes + self.s.to_repr()

    @classmethod
    def from_bytes(cls, b: bytes):
        assert len(b) == 64
        s = Fq.from_repr(b[32:])
        if s is None:
            # keep raw; verification will fail
            s = Fq(int.from_bytes(b[32:], "little"))
        return cls(b[:32], s)


class BindingVerificationKey:
    __slots__ = ("point",)

    def __init__(self, point: PallasPoint):
        self.point = point

    @classmethod
    def from_point(cls, p: PallasPoint):
        return cls(p)

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    def verify(self, basepoint: PallasPoint, msg: bytes, sig: BindingSignature) -> bool:
        R = PallasPoint.from_bytes(sig.r_bytes)
        if R is None:
            return False
        c = h_star(sig.r_bytes + self.to_bytes() + msg)
        return basepoint * sig.s == R + self.point * c

    def __eq__(self, o):
        return isinstance(o, BindingVerificationKey) and self.point == o.point


class BindingSigningKey:
    __slots__ = ("sk", "basepoint")

    def __init__(self, sk: Fq, basepoint: PallasPoint):
        self.sk = sk
        self.basepoint = basepoint

    def get_vk(self) -> BindingVerificationKey:
        return BindingVerificationKey(self.basepoint * self.sk)

    def sign(self, msg: bytes, rng_bytes: bytes | None = None) -> BindingSignature:
        t = rng_bytes if rng_bytes is not None else secrets.token_bytes(80)
        assert len(t) == 80
        vk_bytes = self.get_vk().to_bytes()
        r = h_star(t + vk_bytes + msg)
        R = self.basepoint * r
        r_bytes = R.to_bytes()
        c = h_star(r_bytes + vk_bytes + msg)
        s = r + c * self.sk
        return BindingSignature(r_bytes, s)

    def to_bytes(self) -> bytes:
        return self.sk.to_repr()

    @classmethod
    def from_bytes(cls, b: bytes, basepoint: PallasPoint):
        sk = Fq.from_repr(b)
        if sk is None:
            raise ValueError("BindingSigningKey not in field")
        return cls(sk, basepoint)
