"""Gate polynomial expressions: AST, degree tracking, serialization, host
and device evaluation.

Port of taiga_tpu/plonk/expression.py. An Expression references cells of
the circuit's column tables at relative rotations. The prover evaluates its
constraints over the extended domain through compiled tapes (plonk/tape.py,
ops/tape_device.py); eval_device_many evaluates a set of expressions over
whole-domain base tables in plain torch on the port's limb ops, on the
device of the tables, as the MockProver's gate checks need: the nodes of
all of them are levelled by height, and each level's sums, products and
negations are one batched limb operation each. eval_device is the case of
one expression.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..crypto.fields import Fp
from ..ops import limbs as L

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


# --- device evaluation (whole-domain, vectorized) ---------------------------


class TableSet:
    """Evaluation tables of the base domain on one torch device: dict
    kind -> (num_cols, n, 16) int32 limbs in Montgomery form. Rotation i
    means i rows."""

    def __init__(self, fixed, advice, instance):
        self.tables = {FIXED: fixed, ADVICE: advice, INSTANCE: instance}
        base = fixed if fixed is not None else advice
        self.n, self.device = base.shape[1], base.device
        self._lm: dict = {}

    def column_lm(self, kind: str, index: int) -> torch.Tensor:
        """Column `index` of `kind` as limb-major (16, n) (the tables are
        moved to limb-major once, on first use)."""
        t = self._lm.get(kind)
        if t is None:
            t = self._lm[kind] = self.tables[kind].movedim(-1, 0).contiguous()
        return t[:, index]


# the most lanes (nodes x rows) one batched operation of eval_device_many
# takes: bounds its float64 product accumulator to 32 x 2^20 x 8 B = 256 MiB
_MAX_LANES = 1 << 20


def eval_device(expr: Expression, ts: TableSet, challenges=None) -> torch.Tensor:
    """Evaluate an expression over the whole domain -> (n, 16) Montgomery,
    on the tables' device. challenges: dict name -> (16,) Montgomery limbs."""
    return eval_device_many([expr], ts, challenges)[0]


def eval_device_many(exprs, ts: TableSet, challenges=None) -> list[torch.Tensor]:
    """eval_device of each expression of `exprs`, evaluated together: the
    nodes of all of them (each node object once, however many parents share
    it) are levelled by height, and each level's sums, products and
    negations are each one batched limb operation over the stacked
    operands (in pieces of at most _MAX_LANES lanes). Every lane is the
    same field operation as a node-by-node evaluation, so the results are
    the same bits; the launches go from one set per node to one set per
    level and kind."""
    n = ts.n
    height: dict[int, int] = {}
    levels: dict[tuple[int, type], list[Expression]] = {}
    values: dict[int, torch.Tensor] = {}

    def visit(e: Expression) -> int:
        h = height.get(id(e))
        if h is not None:
            return h
        if isinstance(e, (Sum, Product)):
            h = 1 + max(visit(e.a), visit(e.b))
        elif isinstance(e, Negated):
            h = 1 + visit(e.a)
        else:
            h = 0
            values[id(e)] = _leaf_lm(e, ts, challenges)
        height[id(e)] = h
        if h:
            levels.setdefault((h, type(e)), []).append(e)
        return h

    for e in exprs:
        visit(e)
    for (_, kind), nodes in sorted(levels.items(), key=lambda kv: kv[0][0]):
        step = max(1, _MAX_LANES // n)
        for lo in range(0, len(nodes), step):
            part = nodes[lo : lo + step]
            a = torch.stack([values[id(e.a)].expand(L.NLIMBS, n) for e in part], dim=1)
            if kind is Negated:
                out = L.lm_sub(torch.zeros_like(a), a, L.FP)
            else:
                b = torch.stack([values[id(e.b)].expand(L.NLIMBS, n) for e in part], dim=1)
                out = (L.lm_add if kind is Sum else L.lm_mul)(a, b, L.FP)
            for j, e in enumerate(part):
                values[id(e)] = out[:, j]
    return [L.from_lm(values[id(e)].expand(L.NLIMBS, n)) for e in exprs]


def _leaf_lm(expr: Expression, ts: TableSet, challenges):
    """A leaf as limb-major (16, n), or (16, 1) where it is the same on every
    row (a constant or a challenge)."""
    if isinstance(expr, Cell):
        col = ts.column_lm(expr.kind, expr.index)
        if expr.rotation:
            col = torch.roll(col, -expr.rotation, dims=1)
        return col
    if isinstance(expr, Constant):
        limb = L.int_to_limbs(expr.value * L.FP.r % Fp.MODULUS)
        return L.const(limb, ts.device)[:, None]
    if isinstance(expr, ChallengeVar):
        return challenges[expr.name].reshape(L.NLIMBS, 1)
    raise TypeError(type(expr))
