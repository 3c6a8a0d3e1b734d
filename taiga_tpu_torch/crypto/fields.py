"""Pasta prime fields Fp (Pallas base / Vesta scalar) and Fq (Pallas scalar / Vesta base).

Exact host-side arithmetic on Python ints, wrapped in small immutable classes.
This is the correctness oracle for the limb-decomposed TPU kernels in
`taiga_tpu.ops.limbs`.

Reference semantics: `pasta_curves` (heliaxdev fork) as used throughout
taiga_halo2 (e.g. `src/utils.rs:14-29`, `src/resource.rs:217-235`).

Both fields are 255-bit with 2-adicity 32 and multiplicative generator 5:
  p = 2^254 + 45560315531419706090280762371685220353 (Pallas base)
  q = 2^254 + 45560315531506369815346746415080538113 (Pallas scalar)

Byte representation (`to_repr`/`from_repr`) is 32-byte little-endian, matching
`ff::PrimeField::to_repr` for pasta_curves.
"""

from __future__ import annotations

import secrets

# Pallas base field modulus (= Vesta scalar field modulus)
P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Pallas scalar field modulus (= Vesta base field modulus)
Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

assert P % (1 << 32) == 1 and Q % (1 << 32) == 1  # 2-adicity 32


class _FieldMeta(type):
    def __repr__(cls):
        return cls.__name__


class Field(metaclass=_FieldMeta):
    """Base class for a prime field element. Subclasses set MODULUS/GENERATOR."""

    __slots__ = ("v",)

    MODULUS: int = 0
    GENERATOR: int = 5  # multiplicative generator of F*
    S: int = 32  # 2-adicity
    NUM_BITS: int = 255

    # Cached per-subclass (set in __init_subclass__)
    _ROOT_OF_UNITY: int = 0  # generator^((m-1) >> S), order 2^S
    _T_ODD: int = 0  # (m-1) >> S

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.MODULUS:
            m = cls.MODULUS
            cls._T_ODD = (m - 1) >> cls.S
            cls._ROOT_OF_UNITY = pow(cls.GENERATOR, cls._T_ODD, m)

    def __init__(self, v: int):
        self.v = v % self.MODULUS

    # --- constructors -------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def from_repr(cls, b: bytes):
        """32-byte little-endian; returns None if the value is >= MODULUS
        (mirrors `ff::PrimeField::from_repr` returning CtOption::none)."""
        assert len(b) == 32
        v = int.from_bytes(b, "little")
        if v >= cls.MODULUS:
            return None
        return cls(v)

    @classmethod
    def from_uniform_bytes(cls, b: bytes):
        """64-byte little-endian wide reduction (`ff::FromUniformBytes<64>`)."""
        assert len(b) == 64
        return cls(int.from_bytes(b, "little") % cls.MODULUS)

    @classmethod
    def from_u128(cls, v: int):
        return cls(v)

    @classmethod
    def random(cls, rng=None):
        if rng is None:
            return cls(secrets.randbits(512) % cls.MODULUS)
        return cls(rng.getrandbits(512) % cls.MODULUS)

    @classmethod
    def root_of_unity(cls):
        """Primitive 2^S-th root of unity."""
        return cls(cls._ROOT_OF_UNITY)

    # --- serialization ------------------------------------------------
    def to_repr(self) -> bytes:
        return self.v.to_bytes(32, "little")

    def to_bytes(self) -> bytes:
        return self.to_repr()

    # --- arithmetic ---------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def double(self):
        return type(self)(self.v << 1)

    def square(self):
        return type(self)(self.v * self.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.MODULUS))

    def invert(self):
        if self.v == 0:
            raise ZeroDivisionError("field inverse of zero")
        return type(self)(pow(self.v, -1, self.MODULUS))

    def __truediv__(self, o):
        return self * o.invert()

    def is_zero(self) -> bool:
        return self.v == 0

    def is_odd(self) -> bool:
        return bool(self.v & 1)

    def sqrt(self):
        """Tonelli-Shanks square root; returns None if not a QR.

        Result is canonicalized the way callers need via `is_odd()` checks.
        """
        m = self.MODULUS
        if self.v == 0:
            return type(self)(0)
        if pow(self.v, (m - 1) >> 1, m) != 1:
            return None
        # Tonelli-Shanks for m-1 = t * 2^S with t odd
        t, s = self._T_ODD, self.S
        z = self._ROOT_OF_UNITY  # generator of the 2-Sylow subgroup
        x = pow(self.v, (t + 1) >> 1, m)
        b = pow(self.v, t, m)
        while b != 1:
            # find least k with b^(2^k) == 1
            k, bb = 0, b
            while bb != 1:
                bb = bb * bb % m
                k += 1
            # z has order 2^s currently; adjust
            for _ in range(s - k - 1):
                z = z * z % m
            x = x * z % m
            z = z * z % m
            b = b * z % m
            s = k
        return type(self)(x)

    # --- dunder plumbing ---------------------------------------------
    def __eq__(self, o):
        return isinstance(o, Field) and type(o) is type(self) and o.v == self.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:064x})"

    def __int__(self):
        return self.v


class Fp(Field):
    """Pallas base field (circuit field) = Vesta scalar field."""

    __slots__ = ()
    MODULUS = P


class Fq(Field):
    """Pallas scalar field = Vesta base field."""

    __slots__ = ()
    MODULUS = Q


def mod_r_p(x: Fp) -> Fq:
    """Cast pallas::Base -> pallas::Scalar (no reduction needed: p < q).

    Reference: taiga_halo2/src/utils.rs:14-16.
    """
    return Fq(x.v)


def to_field_elements(data: bytes, field=Fp):
    """Pack bytes into field elements, 31 bytes (=(255-1)//8) per element, LE.

    Reference: taiga_halo2/src/utils.rs:88-98.
    """
    max_size = (field.NUM_BITS - 1) // 8
    out = []
    for i in range(0, len(data), max_size):
        chunk = data[i : i + max_size]
        out.append(field(int.from_bytes(chunk, "little")))
    return out
