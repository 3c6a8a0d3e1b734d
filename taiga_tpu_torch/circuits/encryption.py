"""In-circuit resource encryption (DH + Poseidon duplex sponge).

Mirrors taiga_halo2/src/circuit/resource_encryption_circuit.rs
(:27-139): the sender derives pk = [sk]G and the shared secret [sk]rcv_pk
in-circuit, initializes the sponge with (secret.x, secret.y, len*2^128+nonce)
and absorbs/squeezes rate-2 chunks; the 14 output cells are
[cipher(10), nonce, mac, sender_pk.x, sender_pk.y], publicized at public
inputs 8..21 by the caller. Bit-exact with core/encryption.py (the host
ResourceCiphertext.encrypt) by construction.
"""

from __future__ import annotations

from ..core.constants import RESOURCE_ENCRYPTION_PLAINTEXT_NUM
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder
from . import gadgets as G
from .ec_gadgets import (
    PointCells,
    blind_base,
    constant_point,
    decompose_canonical_255,
    ec_scalar_mul_gadget,
)

P = Fp.MODULUS


def resource_encryption_gadget(
    b: CircuitBuilder,
    nonce_cell,
    sender_sk_cell,
    rcv_pk: PointCells,
    message_cells: list,
    one_cell,
) -> list:
    """Returns the 14 cells [cipher x10, nonce, mac, pk.x, pk.y]."""
    zero = G.constant_cell(b, 0)
    msg = list(message_cells)
    while len(msg) < RESOURCE_ENCRYPTION_PLAINTEXT_NUM:
        msg.append(zero)
    assert len(msg) == RESOURCE_ENCRYPTION_PLAINTEXT_NUM

    # canonical scalar bits of the sender sk (a base-field element, cast via
    # mod_r_p as in the reference's ScalarVar::from_base)
    sk_bits = decompose_canonical_255(b, sender_sk_cell, one_cell)
    gen = constant_point(b, PallasPoint.generator())
    sender_pk = ec_scalar_mul_gadget(b, gen, sk_bits, blind_base(b"enc-pk"))
    secret = ec_scalar_mul_gadget(b, rcv_pk, sk_bits, blind_base(b"enc-dh"))

    # sponge init: (secret.x, secret.y, len * 2^128 + nonce)
    length_nonce = G.add_const(
        b, nonce_cell, RESOURCE_ENCRYPTION_PLAINTEXT_NUM * (1 << 128)
    )
    state = [secret.x, secret.y, length_nonce]
    cipher = []
    for i in range(0, len(msg), 2):
        state = G.poseidon_permute(b, state)
        s0 = G.add_cells(b, state[0], msg[i])
        s1 = G.add_cells(b, state[1], msg[i + 1])
        state = [s0, s1, state[2]]
        cipher.extend([s0, s1])
    cipher.append(nonce_cell)
    state = G.poseidon_permute(b, state)
    cipher.append(state[0])  # MAC
    cipher.extend([sender_pk.x, sender_pk.y])
    return cipher
