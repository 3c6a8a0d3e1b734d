"""Public API, mirroring taiga_halo2/src/taiga_api.rs.

Copy of taiga_tpu/core/api.py. Constructors for resources and transactions
plus the byte-level wire formats (resource = 202 B borsh; compliance public
inputs = 192 B; proofs are self-describing transcript bytes). The functions
that prove or build a transparent partial transaction take the torch device
they run on ("cuda" unless the caller passes "cpu") and, where they prove,
the `randbits` every blind comes from.
"""

from __future__ import annotations

import secrets

from ..crypto.fields import Fp
from .compliance import ComplianceInfo
from .merkle import MerklePath
from .nullifier import Nullifier, NullifierKeyContainer
from .ptx import ShieldedPartialTransaction, TransparentPartialTransaction
from .resource import Resource
from .transaction import (
    ShieldedPartialTxBundle,
    Transaction,
    TransactionResult,
    TransparentPartialTxBundle,
)


def create_input_resource(logic, label, value, quantity, nk, is_ephemeral=False, rseed=None, nonce=None) -> Resource:
    """taiga_api.rs:32-50."""
    rseed = rseed if rseed is not None else Fp.random()
    nonce = nonce if nonce is not None else Nullifier.random()
    return Resource.new_input_resource(logic, label, value, quantity, nk, nonce, is_ephemeral, rseed)


def create_output_resource(logic, label, value, quantity, npk, is_ephemeral=False, rseed=None) -> Resource:
    """taiga_api.rs:52-67 (nonce is set later from the input nullifier)."""
    rseed = rseed if rseed is not None else Fp.random()
    return Resource.new_output_resource(logic, label, value, quantity, npk, is_ephemeral, rseed)


def create_shielded_partial_transaction(
    compliances, input_resource_app, output_resource_app, hints=b"", *, device="cuda",
    randbits=secrets.randbits
) -> ShieldedPartialTransaction:
    """taiga_api.rs:163-178 (from application bytecode), proved on `device`."""
    return ShieldedPartialTransaction.from_bytecode(
        compliances, input_resource_app, output_resource_app, hints, device=device,
        randbits=randbits
    )


def create_transparent_partial_transaction(
    compliances, input_resource_app, output_resource_app, hints=b"", *, device="cuda"
) -> TransparentPartialTransaction:
    """Its mock checks run on `device`."""
    return TransparentPartialTransaction(compliances, input_resource_app, output_resource_app,
                                         hints, device=device)


def create_transaction(shielded_ptxs, transparent_ptxs=()) -> Transaction:
    """taiga_api.rs:182-192."""
    return Transaction.build(
        ShieldedPartialTxBundle(list(shielded_ptxs)),
        TransparentPartialTxBundle(list(transparent_ptxs)),
    )


def verify_transaction(tx: Transaction) -> TransactionResult:
    """taiga_api.rs:206-213: execute = verify everything + state change."""
    return tx.execute()


def verify_shielded_partial_transaction(ptx: ShieldedPartialTransaction):
    """taiga_api.rs:217-224."""
    ptx.execute()


# --- wire formats -----------------------------------------------------------


def resource_serialize(r: Resource) -> bytes:
    return r.serialize()


def resource_deserialize(b: bytes) -> Resource:
    return Resource.deserialize(b)


def transaction_serialize(tx: Transaction) -> bytes:
    """taiga_api.rs:141-160."""
    from .wire import transaction_serialize as _ser

    return _ser(tx)


def transaction_deserialize(b: bytes, *, device="cuda") -> Transaction:
    """Its transparent partial transactions' mock checks run on `device`."""
    from .wire import transaction_deserialize as _de

    return _de(b, device=device)


def partial_transaction_serialize(ptx) -> bytes:
    """taiga_api.rs:104-139 (shielded or transparent, tagged by type)."""
    from .wire import shielded_ptx_serialize, transparent_ptx_serialize

    if isinstance(ptx, ShieldedPartialTransaction):
        return b"\x00" + shielded_ptx_serialize(ptx)
    return b"\x01" + transparent_ptx_serialize(ptx)


def partial_transaction_deserialize(b: bytes, *, device="cuda"):
    """A transparent partial transaction's mock checks run on `device`."""
    from ..ops.limbs import resolve_device
    from .wire import WireError, shielded_ptx_deserialize, transparent_ptx_deserialize

    resolve_device(device)
    if b[:1] == b"\x00":
        return shielded_ptx_deserialize(b[1:])
    if b[:1] == b"\x01":
        return transparent_ptx_deserialize(b[1:], device=device)
    # borsh enum decoding errors on unknown variant tags; so do we
    raise WireError(f"unknown partial-transaction tag {b[:1]!r}")
