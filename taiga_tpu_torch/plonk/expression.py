"""Gate polynomial expressions: AST, degree tracking, serialization and
host evaluation.

Host half of taiga_tpu/plonk/expression.py. An Expression references cells
of the circuit's column tables at relative rotations. The port evaluates
expressions over whole domains on the device only through compiled tapes
(plonk/tape.py, ops/tape_device.py), so the reference's per-node device
evaluator has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.fields import Fp

FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"


class Expression:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Negated(self))

    def __mul__(self, other):
        return Product(self, _wrap(other))

    def __rmul__(self, other):
        return Product(_wrap(other), self)

    def __neg__(self):
        return Negated(self)

    def degree(self) -> int:
        raise NotImplementedError


def _wrap(v) -> "Expression":
    if isinstance(v, Expression):
        return v
    if isinstance(v, Fp):
        return Constant(v.v)
    if isinstance(v, int):
        return Constant(v % Fp.MODULUS)
    raise TypeError(type(v))


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0


@dataclass(frozen=True)
class Cell(Expression):
    """A column reference at a relative rotation."""

    kind: str  # fixed | advice | instance
    index: int
    rotation: int = 0

    def degree(self):
        return 1

    def at(self, rotation: int) -> "Cell":
        return Cell(self.kind, self.index, rotation)


@dataclass(frozen=True)
class ChallengeVar(Expression):
    """A symbolic transcript challenge (beta/gamma/...): a runtime scalar fed
    at evaluation time, so compiled evaluators are reusable across proofs.
    Degree 0 in X."""

    name: str

    def degree(self):
        return 0


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()


@dataclass(frozen=True)
class Negated(Expression):
    a: Expression

    def degree(self):
        return self.a.degree()


def rotations_used(expr: Expression, acc=None):
    """Set of (kind, index, rotation) cells referenced."""
    if acc is None:
        acc = set()
    if isinstance(expr, Cell):
        acc.add((expr.kind, expr.index, expr.rotation))
    elif isinstance(expr, Sum) or isinstance(expr, Product):
        rotations_used(expr.a, acc)
        rotations_used(expr.b, acc)
    elif isinstance(expr, Negated):
        rotations_used(expr.a, acc)
    return acc


# --- canonical serialization -------------------------------------------------
# Deterministic byte encoding for expressions — the basis of verifying-key
# serialization/compression (reference resource_logic_vk.rs:33-51 compresses
# the vk's pinned representation; ours hashes this canonical encoding).

_KIND_TAGS = {FIXED: 0, ADVICE: 1, INSTANCE: 2}
_KIND_BY_TAG = {v: k for k, v in _KIND_TAGS.items()}


def ser_expr(e: Expression, out: bytearray):
    if isinstance(e, Constant):
        out.append(0)
        out += e.value.to_bytes(32, "little")
    elif isinstance(e, Cell):
        out.append(1)
        out.append(_KIND_TAGS[e.kind])
        out += e.index.to_bytes(2, "little")
        out += (e.rotation & 0xFFFF).to_bytes(2, "little")
    elif isinstance(e, ChallengeVar):
        out.append(2)
        nb = e.name.encode()
        out.append(len(nb))
        out += nb
    elif isinstance(e, Sum):
        out.append(3)
        ser_expr(e.a, out)
        ser_expr(e.b, out)
    elif isinstance(e, Product):
        out.append(4)
        ser_expr(e.a, out)
        ser_expr(e.b, out)
    elif isinstance(e, Negated):
        out.append(5)
        ser_expr(e.a, out)
    else:
        raise TypeError(type(e))


def deser_expr(buf: bytes, pos: int) -> tuple[Expression, int]:
    tag = buf[pos]
    pos += 1
    if tag == 0:
        v = int.from_bytes(buf[pos : pos + 32], "little")
        return Constant(v), pos + 32
    if tag == 1:
        kind = _KIND_BY_TAG[buf[pos]]
        idx = int.from_bytes(buf[pos + 1 : pos + 3], "little")
        rot = int.from_bytes(buf[pos + 3 : pos + 5], "little")
        if rot >= 0x8000:
            rot -= 0x10000
        return Cell(kind, idx, rot), pos + 5
    if tag == 2:
        ln = buf[pos]
        name = buf[pos + 1 : pos + 1 + ln].decode()
        return ChallengeVar(name), pos + 1 + ln
    if tag == 3:
        a, pos = deser_expr(buf, pos)
        b, pos = deser_expr(buf, pos)
        return Sum(a, b), pos
    if tag == 4:
        a, pos = deser_expr(buf, pos)
        b, pos = deser_expr(buf, pos)
        return Product(a, b), pos
    if tag == 5:
        a, pos = deser_expr(buf, pos)
        return Negated(a), pos
    raise ValueError(f"bad expression tag {tag}")


# --- host evaluation (row-wise, exact ints) ---------------------------------


def eval_host(expr: Expression, row: int, n: int, fixed, advice, instance) -> int:
    """Evaluate at a single row over int column tables (lists of lists)."""
    p = Fp.MODULUS
    if isinstance(expr, Constant):
        return expr.value
    if isinstance(expr, ChallengeVar):
        raise TypeError("eval_host does not support challenges")
    if isinstance(expr, Cell):
        table = {FIXED: fixed, ADVICE: advice, INSTANCE: instance}[expr.kind]
        return table[expr.index][(row + expr.rotation) % n]
    if isinstance(expr, Sum):
        return (eval_host(expr.a, row, n, fixed, advice, instance)
                + eval_host(expr.b, row, n, fixed, advice, instance)) % p
    if isinstance(expr, Product):
        return (eval_host(expr.a, row, n, fixed, advice, instance)
                * eval_host(expr.b, row, n, fixed, advice, instance)) % p
    if isinstance(expr, Negated):
        return (-eval_host(expr.a, row, n, fixed, advice, instance)) % p
    raise TypeError(type(expr))
