"""The port's wire formats (taiga_tpu_torch.core.wire, core.api) and its
Erlang-Port service (taiga_tpu_torch.service) on the CPU, against the JAX
package.

The port's counterparts of the eight tests of tests/test_wire_service.py,
with device="cpu" (a transparent partial transaction's mock checks at
k = 12 run in plain torch on the CPU); then the cross-package checks: the
same structural objects, built in each package from random.Random(0xA11CE),
serialize to the same bytes and each package's deserializer reads the
other's and writes them back unchanged; a transaction's bytes are the JAX
package's but for the binding signature's random nonce, and each package
accepts the other's signature; both services answer one packet stream
with the same bytes; and, without a card, the entry points that default to
"cuda" raise, and `python -m taiga_tpu_torch.service` exits non-zero
without answering.
"""

import importlib
import io
import os
import random
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from taiga_tpu import service as jservice
from taiga_tpu_torch import service
from taiga_tpu_torch.circuits.bytecode import (
    DECLARED_REPRESENTATIONS,
    ResourceLogicByteCode,
    registered_names,
)
from taiga_tpu_torch.core import api, wire
from taiga_tpu_torch.core.error import InvalidResourceLogicRepresentation
from taiga_tpu_torch.core.ptx import ShieldedPartialTransaction, TransparentPartialTransaction

ROOT = Path(__file__).resolve().parents[1]
SEED = 0xA11CE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(root: str) -> SimpleNamespace:
    """The modules of one package (root "taiga_tpu" or "taiga_tpu_torch")
    that the structural objects are built from."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        torch=root == "taiga_tpu_torch", fields=mod("crypto.fields"), resource=mod("core.resource"),
        nullifier=mod("core.nullifier"), merkle=mod("core.merkle"),
        compliance=mod("core.compliance"), proving=mod("core.proving"), ptx=mod("core.ptx"),
        tree=mod("core.resource_tree"), trivial=mod("apps.trivial"),
        bytecode=mod("circuits.bytecode"), api=mod("core.api"), wire=mod("core.wire"))


PORT, JAX = _package("taiga_tpu_torch"), _package("taiga_tpu")


def _resource(ns, rng):
    """A random resource, every value drawn from rng (the JAX package's
    Resource.random draws its quantity from secrets)."""
    Fp, R = ns.fields.Fp, ns.resource
    return R.Resource(R.ResourceKind(Fp.random(rng), Fp.random(rng)), Fp.random(rng),
                      rng.getrandbits(64), ns.nullifier.NullifierKeyContainer.random_key(rng),
                      ns.nullifier.Nullifier.random(rng), False, Fp.random(rng))


def _balanced_compliance(ns, rng):
    """tests/test_wire_service.py's balanced compliance unit, every value
    drawn from rng (its MerklePath.random draws the siblings from
    secrets)."""
    inp, out = _resource(ns, rng), _resource(ns, rng)
    out.kind = inp.kind
    out.quantity = inp.quantity
    M = ns.merkle
    path = M.MerklePath.from_pairs(
        [(ns.fields.Fp.random(rng), M.LR.L if rng.getrandbits(1) else M.LR.R)
         for _ in range(32)])
    rseed = ns.resource.RandomSeed(rng.randbytes(32))
    return ns.compliance.ComplianceInfo(inp, path, None, out, rseed), inp, out


def _transparent_ptx(ns, rng):
    c1, in1, out1 = _balanced_compliance(ns, rng)
    c2, in2, out2 = _balanced_compliance(ns, rng)
    tree = ns.tree.ResourceMerkleTreeLeaves(
        [in1.get_nf().inner(), out1.commitment().inner(),
         in2.get_nf().inner(), out2.commitment().inner()])

    def app(res, leaf):
        circ = ns.trivial.TrivialResourceLogicCircuit.from_resource_path(
            res, tree.generate_path(leaf))
        return ns.bytecode.ApplicationByteCode(circ.to_bytecode(), [])

    kw = {"device": "cpu"} if ns.torch else {}
    return ns.ptx.TransparentPartialTransaction(
        [c1, c2],
        [app(in1, in1.get_nf().inner()), app(in2, in2.get_nf().inner())],
        [app(out1, out1.commitment().inner()), app(out2, out2.commitment().inner())],
        **kw)


def _fake_shielded_ptx(ns, rng):
    """A structural shielded partial transaction with opaque proof bytes:
    the wire layout without the prover."""
    c, _, _ = _balanced_compliance(ns, rng)
    pub, _ = c.build()
    P = ns.proving
    cinfo = ns.ptx.ComplianceVerifyingInfo(P.Proof(b"\x01\x02\x03" * 11), pub)
    rl = P.ResourceLogicVerifyingInfo(
        "taiga_tpu.rl.TrivialResourceLogicCircuit", P.Proof(b"\x09" * 7),
        [ns.fields.Fp.random(rng) for _ in range(22)], b"TVK1-opaque-test-bytes")
    s = ns.ptx.ResourceLogicVerifyingInfoSet(rl, [rl])
    return ns.ptx.ShieldedPartialTransaction([cinfo], [s], [s], ns.fields.Fq(1234), b"hints!")


def _port_transparent_ptx():
    return _transparent_ptx(PORT, random.Random(SEED))


def _port_fake_shielded_ptx():
    return _fake_shielded_ptx(PORT, random.Random(SEED))


# --- the port's counterparts of tests/test_wire_service.py --------------------


def test_transparent_ptx_roundtrip():
    ptx = _port_transparent_ptx()
    data = wire.transparent_ptx_serialize(ptx)
    back = wire.transparent_ptx_deserialize(data, device="cpu")
    assert back.device == "cpu"
    assert wire.transparent_ptx_serialize(back) == data
    back.execute()  # still a valid ptx after the round trip


def test_shielded_ptx_roundtrip_structural():
    ptx = _port_fake_shielded_ptx()
    data = wire.shielded_ptx_serialize(ptx)
    back = wire.shielded_ptx_deserialize(data)
    assert wire.shielded_ptx_serialize(back) == data
    assert back.binding_sig_r == ptx.binding_sig_r
    assert back.hints == b"hints!"
    assert back.compliances[0].compliance_instance.serialize() == \
        ptx.compliances[0].compliance_instance.serialize()


def test_transaction_roundtrip_and_reexecute():
    tx = api.create_transaction([], [_port_transparent_ptx()])
    data = api.transaction_serialize(tx)
    back = api.transaction_deserialize(data, device="cpu")
    assert api.transaction_serialize(back) == data
    result = api.verify_transaction(back)  # re-executes after round trip
    assert len(result.nullifiers) == 2


def test_truncated_transaction_rejected():
    tx = api.create_transaction([], [_port_transparent_ptx()])
    data = api.transaction_serialize(tx)
    with pytest.raises(Exception):
        api.transaction_deserialize(data[: len(data) // 2], device="cpu")


def test_partial_transaction_tagged_roundtrip():
    data = api.partial_transaction_serialize(_port_transparent_ptx())
    back = api.partial_transaction_deserialize(data, device="cpu")
    assert isinstance(back, TransparentPartialTransaction)
    data2 = api.partial_transaction_serialize(_port_fake_shielded_ptx())
    assert isinstance(api.partial_transaction_deserialize(data2, device="cpu"),
                      ShieldedPartialTransaction)


def _frames(packets: list[bytes]) -> io.BytesIO:
    fin = io.BytesIO()
    for p in packets:
        fin.write(struct.pack(">I", len(p)))
        fin.write(p)
    fin.seek(0)
    return fin


def _replies(fout: io.BytesIO) -> list[bytes]:
    fout.seek(0)
    out = []
    while True:
        hdr = fout.read(4)
        if len(hdr) < 4:
            return out
        (n,) = struct.unpack(">I", hdr)
        out.append(fout.read(n))


def _roundtrip_packets(packets: list[bytes], serve=None) -> list[bytes]:
    """Drive a service's serve() through in-memory {packet,4} framed pipes
    (the port's on the CPU unless `serve` is given)."""
    fout = io.BytesIO()
    if serve is None:
        service.serve(stdin=_frames(packets), stdout=fout, device="cpu")
    else:
        serve(stdin=_frames(packets), stdout=fout)
    return _replies(fout)


def test_service_ping_and_resource_roundtrip():
    res = _resource(PORT, random.Random(SEED))
    replies = _roundtrip_packets(
        [
            bytes([service.OP_PING]) + b"hello",
            bytes([service.OP_RESOURCE_ROUNDTRIP]) + res.serialize(),
            bytes([0x7F]),  # unknown opcode -> error packet, loop continues
        ]
    )
    assert replies[0] == bytes([service.STATUS_OK]) + b"hello"
    assert replies[1] == bytes([service.STATUS_OK]) + res.serialize()
    assert replies[2][0] == service.STATUS_ERROR


def test_service_create_and_verify_transaction():
    ptx_bytes = api.partial_transaction_serialize(_port_transparent_ptx())
    create = (
        bytes([service.OP_CREATE_TRANSACTION])
        + struct.pack("<I", 1)
        + struct.pack("<I", len(ptx_bytes))
        + ptx_bytes
    )
    (reply,) = _roundtrip_packets([create])
    assert reply[0] == service.STATUS_OK
    tx_bytes = reply[1:]
    # tampering the tx bytes must fail verification, and the loop goes on
    bad = bytearray(tx_bytes)
    bad[-1] ^= 1  # flip a binding-signature bit
    bad_reply, verify_reply = _roundtrip_packets(
        [bytes([service.OP_VERIFY_TRANSACTION]) + bytes(bad),
         bytes([service.OP_VERIFY_TRANSACTION]) + tx_bytes]
    )
    assert bad_reply[0] == service.STATUS_ERROR
    assert verify_reply[0] == service.STATUS_OK
    # result payload: 3 groups of 32-byte items (anchors, nfs, cms)
    r = io.BytesIO(verify_reply[1:])
    counts = []
    for _ in range(3):
        (n,) = struct.unpack("<I", r.read(4))
        r.read(32 * n)
        counts.append(n)
    assert counts == [2, 2, 2]
    assert not r.read()


def test_cascade_intent_declared_enum_roundtrip():
    """CascadeIntent parity (reference resource_logic_bytecode.rs:44): the
    representation is declared, so it wire-round-trips like any enum arm,
    but no circuit backs it, so decode raises like the reference's
    catch-all arm (rs:116-117)."""
    for name in registered_names():
        assert name in DECLARED_REPRESENTATIONS
    assert "CascadeIntent" in DECLARED_REPRESENTATIONS
    bc = ResourceLogicByteCode("CascadeIntent", b"\x01\x02\x03")
    buf = io.BytesIO()
    wire.write_bytecode(buf, bc)
    back = wire.read_bytecode(io.BytesIO(buf.getvalue()))
    assert back.name == "CascadeIntent" and back.inputs == b"\x01\x02\x03"
    with pytest.raises(InvalidResourceLogicRepresentation):
        back.decode()


# --- against the JAX package ---------------------------------------------------


def _deserializer(ns, kind):
    fn = getattr(ns.wire, f"{kind}_ptx_deserialize")
    return (lambda b: fn(b, device="cpu")) if ns.torch and kind == "transparent" else fn


@pytest.mark.parametrize("kind", ["transparent", "shielded"])
def test_structural_bytes_equal_reference(kind):
    """The same partial transaction, built in each package from
    random.Random(0xA11CE), serializes to the same bytes; each package reads
    the other's bytes and writes them back unchanged."""
    build = _transparent_ptx if kind == "transparent" else _fake_shielded_ptx
    got = getattr(PORT.wire, f"{kind}_ptx_serialize")(build(PORT, random.Random(SEED)))
    want = getattr(JAX.wire, f"{kind}_ptx_serialize")(build(JAX, random.Random(SEED)))
    assert got == want
    for reader, writer in ((PORT, JAX), (JAX, PORT)):
        back = _deserializer(reader, kind)(want if reader is PORT else got)
        assert getattr(reader.wire, f"{kind}_ptx_serialize")(back) == got
    tagged = PORT.api.partial_transaction_serialize(build(PORT, random.Random(SEED)))
    assert tagged == JAX.api.partial_transaction_serialize(build(JAX, random.Random(SEED)))


def test_transaction_bytes_equal_reference_but_the_signature():
    """A transaction of the same transparent partial transaction: its bytes
    are the JAX package's but the 64-byte binding signature, whose nonce is
    random; each package's verify_binding_sig accepts the other's."""
    got = PORT.api.transaction_serialize(
        PORT.api.create_transaction([], [_transparent_ptx(PORT, random.Random(SEED))]))
    want = JAX.api.transaction_serialize(
        JAX.api.create_transaction([], [_transparent_ptx(JAX, random.Random(SEED))]))
    assert len(got) == len(want)
    assert got[:-64] == want[:-64]
    PORT.api.transaction_deserialize(want, device="cpu").verify_binding_sig()
    JAX.api.transaction_deserialize(got).verify_binding_sig()


def test_service_replies_equal_reference():
    res = _resource(PORT, random.Random(SEED)).serialize()
    packets = [bytes([service.OP_PING]) + b"hello", bytes([service.OP_RESOURCE_ROUNDTRIP]) + res,
               bytes([0x7F]), b"", bytes([service.OP_PING])]
    got = _roundtrip_packets(packets)
    want = _roundtrip_packets(packets, jservice.serve)
    assert got == want
    assert [r[0] for r in got] == [0, 0, 1, 1, 0]
    assert (service.OP_VERIFY_TRANSACTION, service.OP_VERIFY_SHIELDED_PTX,
            service.OP_CREATE_TRANSACTION, service.OP_RESOURCE_ROUNDTRIP, service.OP_PING,
            service.STATUS_OK, service.STATUS_ERROR) == \
        (jservice.OP_VERIFY_TRANSACTION, jservice.OP_VERIFY_SHIELDED_PTX,
         jservice.OP_CREATE_TRANSACTION, jservice.OP_RESOURCE_ROUNDTRIP, jservice.OP_PING,
         jservice.STATUS_OK, jservice.STATUS_ERROR)


# --- no card -----------------------------------------------------------------


def test_cuda_entry_points_without_a_card_raise(monkeypatch):
    """The service, its request handler and every deserializer or
    constructor that builds a transparent partial transaction default to
    "cuda" and raise without a card; none answers on the CPU."""
    ptx = _port_transparent_ptx()
    ptx_bytes = wire.transparent_ptx_serialize(ptx)
    tx_bytes = api.transaction_serialize(api.create_transaction([], [ptx]))
    tagged = api.partial_transaction_serialize(_port_fake_shielded_ptx())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: service.serve(stdin=_frames([bytes([service.OP_PING])]), stdout=io.BytesIO()),
        lambda: service.handle_request(bytes([service.OP_PING])),
        lambda: wire.transparent_ptx_deserialize(ptx_bytes),
        lambda: wire.transaction_deserialize(tx_bytes),
        lambda: api.transaction_deserialize(tx_bytes),
        lambda: api.partial_transaction_deserialize(tagged),
        lambda: api.create_transparent_partial_transaction(
            ptx.compliances, ptx.input_resource_app, ptx.output_resource_app),
        lambda: api.create_shielded_partial_transaction(
            ptx.compliances, ptx.input_resource_app, ptx.output_resource_app),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_service_process_without_a_card_exits_at_once():
    ping = bytes([service.OP_PING]) + b"hello"
    proc = subprocess.run([sys.executable, "-m", "taiga_tpu_torch.service"], cwd=ROOT,
                          input=struct.pack(">I", len(ping)) + ping, capture_output=True,
                          timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == b""
    assert b"no CUDA device" in proc.stderr
