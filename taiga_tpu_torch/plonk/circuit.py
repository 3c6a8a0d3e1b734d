"""Constraint system and circuit builder.

A circuit is data: gate polynomials over named columns (fixed/advice/instance)
plus copy constraints. Synthesis runs the same Python code in two modes:

  * keygen mode — records fixed-column values and copy constraints; advice
    values are None and simply propagate (the layout must be identical in
    both modes: row allocation is deterministic);
  * prove mode — additionally computes advice witness values (exact host
    ints; the heavy prover math happens on device afterwards).

This replaces halo2's Layouter/region machinery (reference
`halo2_proofs::circuit`) with a flat row allocator — deterministic layouts by
construction, and trivially serializable.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..crypto.fields import Fp
from .expression import ADVICE, FIXED, INSTANCE, Cell, Expression

P = Fp.MODULUS

# Degree/ext-domain policy: gates may have degree <= MAX_GATE_DEGREE; the
# permutation argument chunks columns so its constraint degree also fits.
MAX_GATE_DEGREE = 7
EXT_FACTOR = 8  # extended (coset) domain = 8n, supports quotient degree (7-1)n
PERM_CHUNK = 4  # columns per permutation grand-product chunk (degree 4+2)
BLINDING_ROWS = 8  # trailing advice rows randomized for zero-knowledge


@dataclass
class Gate:
    name: str
    poly: Expression


@dataclass
class Lookup:
    """A lookup argument: each row's tuple of input-expression values must
    appear among the rows of the table-expression tuple (halo2-style;
    the reference compliance config carries a 2^10 lookup table,
    compliance_circuit.rs:38-50). Input expressions should be selector-gated
    so ungated rows evaluate to a tuple present in the table (all-zero by
    convention)."""

    name: str
    pairs: list  # [(input_expr, table_expr)]


class ConstraintSystem:
    """Static circuit shape: columns, gates, and which columns can be copied."""

    def __init__(self, num_fixed: int, num_advice: int, num_instance: int = 1):
        self.num_fixed = num_fixed
        self.num_advice = num_advice
        self.num_instance = num_instance
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []

    def fixed(self, i: int) -> Cell:
        assert 0 <= i < self.num_fixed
        return Cell(FIXED, i)

    def advice(self, i: int) -> Cell:
        assert 0 <= i < self.num_advice
        return Cell(ADVICE, i)

    def instance(self, i: int = 0) -> Cell:
        assert 0 <= i < self.num_instance
        return Cell(INSTANCE, i)

    def create_gate(self, name: str, poly: Expression):
        d = poly.degree()
        assert d <= MAX_GATE_DEGREE, f"gate {name} degree {d} > {MAX_GATE_DEGREE}"
        self.gates.append(Gate(name, poly))

    def lookup(self, name: str, pairs):
        """Register a lookup argument; pairs = [(input_expr, table_expr)].
        The product constraint's degree is 2 + max(deg input, deg table) + 1,
        which must stay within MAX_GATE_DEGREE."""
        pairs = list(pairs)
        d = max(max(i.degree() for i, _ in pairs), max(t.degree() for _, t in pairs))
        assert d + 3 <= MAX_GATE_DEGREE, f"lookup {name} input degree {d} too high"
        self.lookups.append(Lookup(name, pairs))

    def column_list(self) -> list[tuple[str, int]]:
        """All columns eligible for copy constraints, in canonical order."""
        cols = [(ADVICE, i) for i in range(self.num_advice)]
        cols += [(INSTANCE, i) for i in range(self.num_instance)]
        cols += [(FIXED, i) for i in range(self.num_fixed)]
        return cols


@dataclass(frozen=True)
class AssignedCell:
    """A concrete (column, row) with its value (None in keygen mode)."""

    kind: str
    index: int
    row: int
    value: int | None

    def expr_at(self, base_row: int) -> Cell:
        return Cell(self.kind, self.index, self.row - base_row)


class CircuitBuilder:
    def __init__(self, cs: ConstraintSystem, k: int, mode: str):
        assert mode in ("keygen", "prove")
        self.cs = cs
        self.k = k
        self.n = 1 << k
        self.usable_rows = self.n - BLINDING_ROWS - 1
        self.mode = mode
        self.fixed = [[0] * self.n for _ in range(cs.num_fixed)]
        self.advice = [[0] * self.n for _ in range(cs.num_advice)]
        self.copies: list[tuple[tuple[str, int, int], tuple[str, int, int]]] = []
        self._cursor = 0

    # --- rows ---------------------------------------------------------
    def alloc_rows(self, m: int) -> int:
        row = self._cursor
        self._cursor += m
        assert self._cursor <= self.usable_rows, (
            f"circuit overflow: {self._cursor} > {self.usable_rows} usable rows (k={self.k})"
        )
        return row

    def rows_used(self) -> int:
        return self._cursor

    # --- assignment ---------------------------------------------------
    def assign_fixed(self, col: int, row: int, value: int | Fp):
        v = value.v if isinstance(value, Fp) else value % P
        self.fixed[col][row] = v

    def assign_advice(self, col: int, row: int, value: int | Fp | None) -> AssignedCell:
        if value is None:
            # keygen mode: values are unknown; prove mode: an unused cell
            # (defaults to 0 in the table; the MockProver catches any gadget
            # that wrongly leaves a constrained cell unassigned)
            return AssignedCell(ADVICE, col, row, None)
        v = value.v if isinstance(value, Fp) else value % P
        if self.mode == "prove":
            self.advice[col][row] = v
        return AssignedCell(ADVICE, col, row, v if self.mode == "prove" else None)

    def copy(self, a: AssignedCell, b: AssignedCell):
        """Constrain two cells equal (permutation argument)."""
        self.copies.append(((a.kind, a.index, a.row), (b.kind, b.index, b.row)))
        if self.mode == "prove" and a.value is not None and b.value is not None:
            assert a.value == b.value, "copy constraint violated at synthesis"

    def constrain_instance(self, cell: AssignedCell, instance_row: int, instance_col: int = 0):
        self.copies.append(
            ((cell.kind, cell.index, cell.row), (INSTANCE, instance_col, instance_row))
        )

    # --- value plumbing ----------------------------------------------
    def known(self, *cells: AssignedCell) -> bool:
        return all(c.value is not None for c in cells)

    def value(self, cell: AssignedCell) -> Fp | None:
        return None if cell.value is None else Fp(cell.value)


class Circuit:
    """Base class: subclasses define configure() and synthesize()."""

    NUM_FIXED = 1
    NUM_ADVICE = 4
    NUM_INSTANCE = 1

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, builder: CircuitBuilder, config):
        raise NotImplementedError

    @classmethod
    def build_cs(cls) -> tuple[ConstraintSystem, object]:
        cs = ConstraintSystem(cls.NUM_FIXED, cls.NUM_ADVICE, cls.NUM_INSTANCE)
        config = cls.configure(cs)
        return cs, config
