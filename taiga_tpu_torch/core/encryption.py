"""Resource encryption: DH key exchange + Poseidon-sponge stream cipher.

Mirrors taiga_halo2/src/resource_encryption.rs:
  secret key = [sk] pk (Pallas point); sponge state initialised to
  (key.x, key.y, nonce + len * 2^128); per rate-2 chunk: permute, add message
  into the rate, emit the updated rate as ciphertext; append nonce; one more
  permute emits the MAC. Ciphertext = 10 msg + nonce + MAC = 12 elements.
"""

from __future__ import annotations

from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq
from ..crypto.poseidon import PoseidonSponge
from .constants import (
    POSEIDON_RATE,
    RESOURCE_ENCRYPTION_CIPHERTEXT_NUM,
    RESOURCE_ENCRYPTION_PLAINTEXT_NUM,
)


class SecretKey:
    __slots__ = ("point",)

    def __init__(self, point: PallasPoint):
        self.point = point

    @classmethod
    def from_dh_exchange(cls, pk: PallasPoint, sk: Fq):
        return cls(pk * sk)

    def inner(self) -> PallasPoint:
        return self.point

    def get_coordinates(self) -> tuple[Fp, Fp]:
        return self.point.coordinates()


def _sponge_init(message_len: int, secret_key: SecretKey, nonce: Fp) -> PoseidonSponge:
    kx, ky = secret_key.get_coordinates()
    length_nonce = nonce + Fp(message_len) * Fp(1 << 128)
    return PoseidonSponge([kx, ky, length_nonce])


class ResourcePlaintext:
    __slots__ = ("elements",)

    def __init__(self, elements: list[Fp]):
        assert len(elements) == RESOURCE_ENCRYPTION_PLAINTEXT_NUM
        self.elements = list(elements)

    @classmethod
    def padding(cls, msg: list[Fp]):
        assert len(msg) <= RESOURCE_ENCRYPTION_PLAINTEXT_NUM
        return cls(msg + [Fp.zero()] * (RESOURCE_ENCRYPTION_PLAINTEXT_NUM - len(msg)))

    def inner(self) -> list[Fp]:
        return self.elements

    def to_vec(self) -> list[Fp]:
        return list(self.elements)


class ResourceCiphertext:
    __slots__ = ("elements",)

    def __init__(self, elements: list[Fp]):
        assert len(elements) == RESOURCE_ENCRYPTION_CIPHERTEXT_NUM
        self.elements = list(elements)

    def inner(self) -> list[Fp]:
        return self.elements

    @classmethod
    def encrypt(cls, message: ResourcePlaintext, secret_key: SecretKey, nonce: Fp):
        sponge = _sponge_init(len(message.inner()), secret_key, nonce)
        cipher = []
        msg = message.inner()
        for i in range(0, len(msg), POSEIDON_RATE):
            sponge.permute()
            for j, m in enumerate(msg[i : i + POSEIDON_RATE]):
                sponge.state[j] = (sponge.state[j] + m.v) % Fp.MODULUS
                cipher.append(Fp(sponge.state[j]))
        cipher.append(nonce)
        sponge.permute()
        cipher.append(Fp(sponge.state[0]))
        return cls(cipher)

    def decrypt(self, secret_key: SecretKey) -> list[Fp] | None:
        n = len(self.elements)
        mac = self.elements[n - 1]
        nonce = self.elements[n - 2]
        sponge = _sponge_init(n - 2, secret_key, nonce)
        msg = []
        body = self.elements[: n - 2]
        for i in range(0, len(body), POSEIDON_RATE):
            sponge.permute()
            for j, c in enumerate(body[i : i + POSEIDON_RATE]):
                msg.append(Fp((c.v - sponge.state[j]) % Fp.MODULUS))
                sponge.state[j] = c.v
        sponge.permute()
        if mac.v != sponge.state[0]:
            return None
        return msg
