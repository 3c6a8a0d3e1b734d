"""Nullifier and nullifier-key container.

Mirrors taiga_halo2/src/nullifier.rs:
  nf  = Poseidon(nk, nonce, psi, cm)   (4-element ConstantLength hash)
  npk = Poseidon(nk, 0)                (PRF^nf with zero nonce)
"""

from __future__ import annotations

from ..crypto.fields import Fp
from ..crypto.poseidon import poseidon_hash_n, prf_nf


class Nullifier:
    __slots__ = ("value",)

    def __init__(self, value: Fp):
        self.value = value

    @classmethod
    def default(cls):
        return cls(Fp.one())

    @classmethod
    def derive(cls, nk_container, nonce: Fp, psi: Fp, cm) -> "Nullifier | None":
        nk = nk_container.get_nk()
        if nk is None:
            return None
        return cls(poseidon_hash_n([nk, nonce, psi, cm.inner()]))

    @classmethod
    def random(cls, rng=None):
        return cls(Fp.random(rng))

    def inner(self) -> Fp:
        return self.value

    def to_bytes(self) -> bytes:
        return self.value.to_repr()

    @classmethod
    def from_bytes(cls, b: bytes):
        v = Fp.from_repr(b)
        return None if v is None else cls(v)

    def __eq__(self, o):
        return isinstance(o, Nullifier) and o.value == self.value

    def __hash__(self):
        return hash(("Nullifier", self.value.v))

    def __repr__(self):
        return f"Nullifier({self.value!r})"


class NullifierKeyContainer:
    """Either the nullifier key itself or its commitment npk = Poseidon(nk, 0)."""

    __slots__ = ("_value", "_is_key")

    def __init__(self, value: Fp, is_key: bool):
        self._value = value
        self._is_key = is_key

    @classmethod
    def from_key(cls, key: Fp):
        return cls(key, True)

    @classmethod
    def from_npk(cls, npk: Fp):
        return cls(npk, False)

    @classmethod
    def random_key(cls, rng=None):
        return cls.from_key(Fp.random(rng))

    @classmethod
    def random_npk(cls, rng=None):
        return cls.from_npk(Fp.random(rng))

    @classmethod
    def default(cls):
        return cls.from_key(Fp.zero())

    def is_key(self) -> bool:
        return self._is_key

    def get_nk(self) -> Fp | None:
        return self._value if self._is_key else None

    def get_npk(self) -> Fp:
        if self._is_key:
            return prf_nf(self._value, Fp.zero())
        return self._value

    def to_commitment(self) -> "NullifierKeyContainer":
        if self._is_key:
            return NullifierKeyContainer.from_npk(self.get_npk())
        return self

    def raw_inner(self) -> Fp:
        """The stored field element (nk or npk), for serialization."""
        return self._value

    def __eq__(self, o):
        return (
            isinstance(o, NullifierKeyContainer)
            and o._is_key == self._is_key
            and o._value == self._value
        )

    def __repr__(self):
        kind = "Key" if self._is_key else "PublicKey"
        return f"NullifierKeyContainer::{kind}({self._value!r})"
