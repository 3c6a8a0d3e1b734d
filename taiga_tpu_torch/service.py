"""Host-node interop service: the reference's Elixir-NIF equivalent.

Port of taiga_tpu/service.py: the same opcodes, status bytes, framing and
result encoding. Transparent partial transactions run their mock checks on
the service's torch device ("cuda" unless the caller passes "cpu"); serve()
resolves it before it reads the first packet, so without a card
`python -m taiga_tpu_torch.service` exits non-zero at once.

The reference exposes taiga to the Anoma node through rustler NIFs
(`#[cfg(feature = "nif")]` impls, e.g. taiga_halo2/src/transaction.rs:161-205).
Rust in-process bindings have no analogue here; the idiomatic Erlang/Elixir
interop for an external runtime is a **Port**: a child process speaking
length-prefixed packets over stdin/stdout ({packet, 4} framing). This module
implements that protocol, so an Anoma node can drive the port with
`Port.open({:spawn, "python -m taiga_tpu_torch.service"}, [{:packet, 4}, :binary])`.

Request packet:   u8 opcode || payload        (payload = wire.py formats)
Response packet:  u8 status (0 ok / 1 error) || payload

Opcodes mirror taiga_api.rs:
  0x01 VERIFY_TRANSACTION        payload = transaction bytes
       -> ok: result (u32 n || 32B anchors) * 3 groups (anchors/nfs/cms)
  0x02 VERIFY_SHIELDED_PTX       payload = shielded ptx bytes -> ok: empty
  0x03 CREATE_TRANSACTION        payload = u32 n || vec<ptx bytes (tagged)>
       -> ok: transaction bytes (proves nothing; composes + binding-signs)
  0x04 RESOURCE_ROUNDTRIP        payload = 202B resource -> ok: 202B resource
  0x05 PING                      -> ok: payload echoed
"""

from __future__ import annotations

import io
import struct
import sys
import traceback

OP_VERIFY_TRANSACTION = 0x01
OP_VERIFY_SHIELDED_PTX = 0x02
OP_CREATE_TRANSACTION = 0x03
OP_RESOURCE_ROUNDTRIP = 0x04
OP_PING = 0x05

STATUS_OK = 0
STATUS_ERROR = 1


def _encode_result(result) -> bytes:
    w = io.BytesIO()
    for group in (result.anchors, result.nullifiers, result.output_cms):
        w.write(struct.pack("<I", len(group)))
        for item in group:
            w.write(item.to_bytes())
    return w.getvalue()


def handle_request(packet: bytes, *, device="cuda") -> bytes:
    """One request -> one response payload (status byte prepended). A
    transparent partial transaction's mock checks run on `device`; a fault
    of the request maps to an error packet, a device without a card raises."""
    from .core import api
    from .core.transaction import (
        ShieldedPartialTxBundle,
        Transaction,
        TransparentPartialTxBundle,
    )
    from .core.ptx import ShieldedPartialTransaction
    from .ops.limbs import resolve_device

    resolve_device(device)
    try:
        if not packet:
            raise ValueError("empty packet")
        op, payload = packet[0], packet[1:]
        if op == OP_PING:
            return bytes([STATUS_OK]) + payload
        if op == OP_VERIFY_TRANSACTION:
            tx = api.transaction_deserialize(payload, device=device)
            result = api.verify_transaction(tx)
            return bytes([STATUS_OK]) + _encode_result(result)
        if op == OP_VERIFY_SHIELDED_PTX:
            ptx = api.partial_transaction_deserialize(b"\x00" + payload, device=device)
            api.verify_shielded_partial_transaction(ptx)
            return bytes([STATUS_OK])
        if op == OP_CREATE_TRANSACTION:
            r = io.BytesIO(payload)
            (n,) = struct.unpack("<I", r.read(4))
            shielded, transparent = [], []
            for _ in range(n):
                (ln,) = struct.unpack("<I", r.read(4))
                ptx = api.partial_transaction_deserialize(r.read(ln), device=device)
                if isinstance(ptx, ShieldedPartialTransaction):
                    shielded.append(ptx)
                else:
                    transparent.append(ptx)
            tx = Transaction.build(
                ShieldedPartialTxBundle(shielded),
                TransparentPartialTxBundle(transparent),
            )
            return bytes([STATUS_OK]) + api.transaction_serialize(tx)
        if op == OP_RESOURCE_ROUNDTRIP:
            res = api.resource_deserialize(payload)
            return bytes([STATUS_OK]) + api.resource_serialize(res)
        raise ValueError(f"unknown opcode {op:#x}")
    except Exception as e:  # noqa: BLE001 — every fault maps to an error packet
        msg = f"{type(e).__name__}: {e}"
        traceback.print_exc(file=sys.stderr)
        return bytes([STATUS_ERROR]) + msg.encode()


def serve(stdin=None, stdout=None, *, device="cuda"):
    """{packet, 4} loop: 4-byte big-endian length framing (Erlang Port).
    Requests run on `device`, resolved before the first packet is read."""
    from .ops.limbs import resolve_device

    resolve_device(device)
    fin = stdin if stdin is not None else sys.stdin.buffer
    fout = stdout if stdout is not None else sys.stdout.buffer
    while True:
        hdr = fin.read(4)
        if len(hdr) < 4:
            return  # EOF: port closed
        (n,) = struct.unpack(">I", hdr)
        packet = fin.read(n)
        if len(packet) < n:
            return
        resp = handle_request(packet, device=device)
        fout.write(struct.pack(">I", len(resp)))
        fout.write(resp)
        fout.flush()


if __name__ == "__main__":
    serve()
