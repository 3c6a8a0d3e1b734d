"""Deterministic wire formats for partial transactions and transactions.

Copy of taiga_tpu/core/wire.py: the byte layout is the JAX package's. The
deserializers that build a transparent partial transaction take the torch
device its mock checks run on ("cuda" unless the caller passes "cpu"; a
"cuda" request without a card raises).

Mirrors the borsh layouts documented in the reference's public API
(taiga_halo2/src/taiga_api.rs:69-160: resource 202 B, ptx = compliance units
+ per-logic verifying info, tx = shielded bundle + transparent bundle +
binding signature) and the `#[derive(BorshSerialize)]` impls on
ShieldedPartialTransaction (shielded_ptx.rs:34-40), TransparentPartialTransaction
(transparent_ptx.rs), and Transaction (transaction.rs:27-33).

Conventions (borsh): little-endian u32 length prefixes for sequences and byte
vectors, fixed 32-byte field-element reprs, u8 enum tags / option flags.
Proof byte lengths differ from the reference (our transcript is IPA over the
taiga-tpu prover), so `vec<u8>` prefixes replace the reference's fixed
4,676 / 158,216-byte blocks; everything else is structural parity.
"""

from __future__ import annotations

import io

from ..crypto.fields import Fp, Fq
from ..ops.limbs import resolve_device
from ..crypto.reddsa import BindingSignature
from ..circuits.bytecode import ApplicationByteCode, ResourceLogicByteCode
from .compliance import ComplianceInfo, CompliancePublicInputs
from .merkle import Anchor, LR, MerklePath, Node
from .proving import Proof, ResourceLogicVerifyingInfo
from .ptx import (
    ComplianceVerifyingInfo,
    ResourceLogicVerifyingInfoSet,
    ShieldedPartialTransaction,
    TransparentPartialTransaction,
)
from .resource import RandomSeed, Resource
from .transaction import (
    ShieldedPartialTxBundle,
    Transaction,
    TransparentPartialTxBundle,
)


class WireError(ValueError):
    pass


# --- primitives --------------------------------------------------------------


def _w_u8(w, v: int):
    w.write(bytes([v & 0xFF]))


def _w_u32(w, v: int):
    w.write(int(v).to_bytes(4, "little"))


def _w_vec(w, b: bytes):
    _w_u32(w, len(b))
    w.write(b)


def _w_str(w, s: str):
    _w_vec(w, s.encode())


def _w_fp(w, v: Fp):
    w.write(v.to_repr())


def _r_exact(r, n: int) -> bytes:
    b = r.read(n)
    if len(b) != n:
        raise WireError(f"truncated: wanted {n} bytes, got {len(b)}")
    return b


def _r_u8(r) -> int:
    return _r_exact(r, 1)[0]


def _r_u32(r) -> int:
    return int.from_bytes(_r_exact(r, 4), "little")


def _r_vec(r) -> bytes:
    return _r_exact(r, _r_u32(r))


def _r_str(r) -> str:
    return _r_vec(r).decode()


def _r_fp(r) -> Fp:
    v = Fp.from_repr(_r_exact(r, 32))
    if v is None:
        raise WireError("non-canonical field element")
    return v


def _r_fq(r) -> Fq:
    v = Fq.from_repr(_r_exact(r, 32))
    if v is None:
        raise WireError("non-canonical scalar element")
    return v


# --- resource-logic verifying info -------------------------------------------


def write_rl_verifying_info(w, info: ResourceLogicVerifyingInfo):
    _w_str(w, info.circuit_id)
    _w_vec(w, info.vk_bytes)  # the vk travels with the proof, as in the
    # reference's 158 kB RL verifying info (taiga_api.rs:104-139)
    _w_vec(w, info.proof.to_bytes())
    _w_u32(w, len(info.public_inputs))
    for v in info.public_inputs:
        _w_fp(w, v)


def read_rl_verifying_info(r) -> ResourceLogicVerifyingInfo:
    circuit_id = _r_str(r)
    vk_bytes = _r_vec(r)
    proof = Proof.from_bytes(_r_vec(r))
    n = _r_u32(r)
    pubs = [_r_fp(r) for _ in range(n)]
    return ResourceLogicVerifyingInfo(circuit_id, proof, pubs, vk_bytes)


def write_rl_info_set(w, s: ResourceLogicVerifyingInfoSet):
    write_rl_verifying_info(w, s.app_resource_logic_verifying_info)
    dyn = s.app_dynamic_resource_logic_verifying_info
    _w_u32(w, len(dyn))
    for d in dyn:
        write_rl_verifying_info(w, d)


def read_rl_info_set(r) -> ResourceLogicVerifyingInfoSet:
    app = read_rl_verifying_info(r)
    dyn = [read_rl_verifying_info(r) for _ in range(_r_u32(r))]
    return ResourceLogicVerifyingInfoSet(app, dyn)


# --- compliance --------------------------------------------------------------


def write_compliance_verifying_info(w, c: ComplianceVerifyingInfo):
    _w_vec(w, c.compliance_proof.to_bytes())
    w.write(c.compliance_instance.serialize())  # 192 B


def read_compliance_verifying_info(r) -> ComplianceVerifyingInfo:
    proof = Proof.from_bytes(_r_vec(r))
    inst = CompliancePublicInputs.deserialize(_r_exact(r, 192))
    return ComplianceVerifyingInfo(proof, inst)


def write_merkle_path(w, path: MerklePath):
    pairs = path.inner()
    _w_u32(w, len(pairs))
    for v, lr in pairs:
        _w_fp(w, v)
        _w_u8(w, 1 if lr.is_left() else 0)


def read_merkle_path(r) -> MerklePath:
    n = _r_u32(r)
    pairs = []
    for _ in range(n):
        v = _r_fp(r)
        lr = LR.L if _r_u8(r) else LR.R
        pairs.append((v, lr))
    return MerklePath.from_pairs(pairs)


def write_compliance_info(w, info: ComplianceInfo):
    w.write(info.input_resource.serialize())
    write_merkle_path(w, info.input_merkle_path)
    _w_fp(w, info.input_anchor.inner())
    w.write(info.output_resource.serialize())
    w.write(info.rseed.seed)


def read_compliance_info(r) -> ComplianceInfo:
    input_resource = Resource.deserialize(r)
    path = read_merkle_path(r)
    anchor = Anchor(_r_fp(r))
    output_resource = Resource.deserialize(r)
    rseed = RandomSeed(_r_exact(r, 32))
    return ComplianceInfo(input_resource, path, anchor, output_resource, rseed)


# --- bytecode ----------------------------------------------------------------


def write_bytecode(w, bc: ResourceLogicByteCode):
    _w_str(w, bc.name)
    _w_vec(w, bc.inputs)


def read_bytecode(r) -> ResourceLogicByteCode:
    return ResourceLogicByteCode(_r_str(r), _r_vec(r))


def write_app_bytecode(w, app: ApplicationByteCode):
    write_bytecode(w, app.app_resource_logic_bytecode)
    dyn = app.dynamic_resource_logic_bytecode
    _w_u32(w, len(dyn))
    for b in dyn:
        write_bytecode(w, b)


def read_app_bytecode(r) -> ApplicationByteCode:
    app = read_bytecode(r)
    dyn = [read_bytecode(r) for _ in range(_r_u32(r))]
    return ApplicationByteCode(app, dyn)


# --- partial transactions ------------------------------------------------------


def shielded_ptx_serialize(ptx: ShieldedPartialTransaction) -> bytes:
    w = io.BytesIO()
    _w_u32(w, len(ptx.compliances))
    for c in ptx.compliances:
        write_compliance_verifying_info(w, c)
    for group in (ptx.inputs, ptx.outputs):
        _w_u32(w, len(group))
        for s in group:
            write_rl_info_set(w, s)
    if ptx.binding_sig_r is None:
        _w_u8(w, 0)
    else:
        _w_u8(w, 1)
        w.write(ptx.binding_sig_r.to_repr())
    _w_vec(w, ptx.hints)
    return w.getvalue()


def shielded_ptx_deserialize(data: bytes | io.BytesIO) -> ShieldedPartialTransaction:
    r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    compliances = [read_compliance_verifying_info(r) for _ in range(_r_u32(r))]
    inputs = [read_rl_info_set(r) for _ in range(_r_u32(r))]
    outputs = [read_rl_info_set(r) for _ in range(_r_u32(r))]
    binding_sig_r = _r_fq(r) if _r_u8(r) else None
    hints = _r_vec(r)
    return ShieldedPartialTransaction(compliances, inputs, outputs, binding_sig_r, hints)


def transparent_ptx_serialize(ptx: TransparentPartialTransaction) -> bytes:
    w = io.BytesIO()
    _w_u32(w, len(ptx.compliances))
    for c in ptx.compliances:
        write_compliance_info(w, c)
    for group in (ptx.input_resource_app, ptx.output_resource_app):
        _w_u32(w, len(group))
        for app in group:
            write_app_bytecode(w, app)
    _w_vec(w, ptx.hints)
    return w.getvalue()


def transparent_ptx_deserialize(data: bytes | io.BytesIO, *,
                                device="cuda") -> TransparentPartialTransaction:
    """The partial transaction's mock checks run on `device`."""
    r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    compliances = [read_compliance_info(r) for _ in range(_r_u32(r))]
    input_apps = [read_app_bytecode(r) for _ in range(_r_u32(r))]
    output_apps = [read_app_bytecode(r) for _ in range(_r_u32(r))]
    hints = _r_vec(r)
    return TransparentPartialTransaction(compliances, input_apps, output_apps, hints,
                                         device=device)


# --- transaction ---------------------------------------------------------------


def transaction_serialize(tx: Transaction) -> bytes:
    """taiga_api.rs:141-160 layout: shielded bundle, transparent bundle,
    64-byte binding signature."""
    w = io.BytesIO()
    sp = tx.shielded_ptx_bundle.partial_txs
    _w_u32(w, len(sp))
    for ptx in sp:
        _w_vec(w, shielded_ptx_serialize(ptx))
    tp = tx.transparent_ptx_bundle.partial_txs
    _w_u32(w, len(tp))
    for ptx in tp:
        _w_vec(w, transparent_ptx_serialize(ptx))
    w.write(tx.signature.to_bytes())
    return w.getvalue()


def transaction_deserialize(data: bytes | io.BytesIO, *, device="cuda") -> Transaction:
    """Its transparent partial transactions' mock checks run on `device`."""
    resolve_device(device)
    r = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    shielded = [shielded_ptx_deserialize(_r_vec(r)) for _ in range(_r_u32(r))]
    transparent = [transparent_ptx_deserialize(_r_vec(r), device=device)
                   for _ in range(_r_u32(r))]
    sig = BindingSignature.from_bytes(_r_exact(r, 64))
    if sig is None:
        raise WireError("invalid binding signature encoding")
    return Transaction(
        ShieldedPartialTxBundle(shielded), TransparentPartialTxBundle(transparent), sig
    )
