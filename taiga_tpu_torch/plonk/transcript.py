"""Blake2b Fiat-Shamir transcript.

Chained-state construction (personalization "TaigaTPU-Transcr"):
  state <- H(state || tag || data) on absorb;
  challenge = from_uniform_bytes(H(state || "chal")), state <- H(state || "chal").

The reference uses halo2's Blake2bRead/Write transcript
(taiga_halo2/src/proof.rs:25-54); ours is an independent, documented framing
(proof bytes are self-consistent between our prover and verifier).
"""

from __future__ import annotations

import hashlib

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp

PERSONAL = b"TaigaTPU-Transcr"


def _h(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64, person=PERSONAL).digest()


class Transcript:
    def __init__(self, label: bytes = b""):
        self.state = _h(b"init" + label)

    def absorb_bytes(self, data: bytes):
        self.state = _h(self.state + b"ab" + data)

    def absorb_point(self, pt: VestaPoint):
        self.absorb_bytes(b"P" + pt.to_bytes())

    def absorb_scalar(self, s: Fp):
        self.absorb_bytes(b"S" + s.to_repr())

    def challenge(self, label: bytes = b"") -> Fp:
        out = _h(self.state + b"ch" + label)
        self.state = _h(self.state + b"st" + label)
        return Fp.from_uniform_bytes(out)


class ProofWriter(Transcript):
    """Transcript that also records the proof byte stream."""

    def __init__(self, label: bytes = b""):
        super().__init__(label)
        self.data = bytearray()

    def write_point(self, pt: VestaPoint):
        self.data += pt.to_bytes()
        self.absorb_point(pt)

    def write_scalar(self, s: Fp):
        self.data += s.to_repr()
        self.absorb_scalar(s)

    def bytes(self) -> bytes:
        return bytes(self.data)


class LazyPoint:
    """A proof point whose decompression (Tonelli-Shanks sqrt) is deferred —
    resolve_lazy_points() materializes a whole batch in one native call.
    Attribute access before resolution falls back to the Python path (correct,
    just slower), so every consumer keeps working."""

    __slots__ = ("raw", "_pt")

    def __init__(self, raw: bytes):
        self.raw = raw
        self._pt = None

    def _resolve_now(self) -> VestaPoint:
        if self._pt is None:
            pt = VestaPoint.from_bytes(self.raw)
            if pt is None:
                raise ValueError("invalid point in proof")
            self._pt = pt
        return self._pt

    def is_identity(self) -> bool:
        return False  # the zero encoding short-circuits in read_point

    @property
    def x(self):
        return self._resolve_now().x

    @property
    def y(self):
        return self._resolve_now().y

    def to_bytes(self) -> bytes:
        return self.raw


def resolve_lazy_points(points) -> None:
    """Batch-decompress every unresolved LazyPoint via the native engine.
    Raises ValueError if any encoding is invalid (off-curve / x >= p)."""
    pending = [p for p in points
               if isinstance(p, LazyPoint) and p._pt is None]
    if not pending:
        return
    from ..crypto.fields import Fq
    from ..native import hostops as H

    xy, ok = H.point_decompress_vesta([p.raw for p in pending])
    if not ok.all():
        raise ValueError("invalid point in proof")
    for i, p in enumerate(pending):
        x = int(xy[i, 0]) | int(xy[i, 1]) << 64 | int(xy[i, 2]) << 128 \
            | int(xy[i, 3]) << 192
        y = int(xy[i, 4]) | int(xy[i, 5]) << 64 | int(xy[i, 6]) << 128 \
            | int(xy[i, 7]) << 192
        p._pt = VestaPoint(Fq(x), Fq(y))


class ProofReader(Transcript):
    """Transcript that replays a proof byte stream."""

    def __init__(self, proof: bytes, label: bytes = b""):
        super().__init__(label)
        self.proof = proof
        self.off = 0

    def read_point(self) -> VestaPoint:
        raw = self.proof[self.off : self.off + 32]
        if len(raw) != 32:
            raise ValueError("proof too short")
        self.off += 32
        if raw != bytes(32):
            from ..native import hostops as H

            if H.available():
                # defer the sqrt: the transcript only needs the compressed
                # bytes (to_bytes(from_bytes(b)) == b for valid encodings),
                # and the coordinates are only touched by the final MSM —
                # MSMClaim.check decompresses every pending point of the
                # whole batch in ONE native call (~66 Python Tonelli sqrts
                # per proof were the single largest verify cost)
                self.absorb_bytes(b"P" + raw)
                return LazyPoint(raw)
        pt = VestaPoint.from_bytes(raw)
        if pt is None:
            raise ValueError("invalid point in proof")
        self.absorb_point(pt)
        return pt

    def read_scalar(self) -> Fp:
        raw = self.proof[self.off : self.off + 32]
        if len(raw) != 32:
            raise ValueError("proof too short")
        self.off += 32
        s = Fp.from_repr(raw)
        if s is None:
            raise ValueError("invalid scalar in proof")
        self.absorb_scalar(s)
        return s

    def finished(self) -> bool:
        return self.off == len(self.proof)
