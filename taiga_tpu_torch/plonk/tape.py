"""Flat-tape compilation of constraint expressions ("circuits as data").

The quotient polynomial evaluates ~100 gate/argument expressions (~1800 AST
nodes) over the 8n extended coset. Walking the AST per node costs one full
vector pass per operator plus Python dispatch; this module compiles the whole
expression list ONCE per proving key into a linear instruction tape with

  * common-subexpression elimination (structural hashing — the Poseidon
    packed-round gates share almost all of their structure),
  * constant folding of scalar subtrees (challenges beta/gamma/theta/y stay
    symbolic: they are evaluated per proof into a small scalar table, so the
    tape itself is reusable across proofs), and
  * liveness-based register allocation (the evaluator's working set is a
    few dozen chunk-sized registers, not one buffer per AST node).

The same tape runs on two backends:
  * native C++ (`taiga_tape_eval` in native/src/pasta_host.cpp): chunked,
    OpenMP over chunks — the host prover's quotient stage;
  * the XLA device interpreter (ops/tape_device.py): a `lax.fori_loop` over
    the instruction array — ONE compiled program per domain size that serves
    EVERY circuit, replacing the per-circuit unrolled quotient graph whose
    compile time dominated TPU runs.

Reference counterpart: halo2_proofs' `create_proof` evaluates the constraint
system's compiled `Evaluator` over the extended domain (SURVEY.md §2.4); the
tape is this build's equivalent of halo2's `evaluation.rs` calculation graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crypto.fields import Fp
from .expression import (
    Cell,
    ChallengeVar,
    Constant,
    Expression,
    Negated,
    Product,
    Sum,
)
from .protocol import (
    L0,
    LBLIND,
    LLAST,
    LOOKUP_A,
    LOOKUP_S,
    LOOKUP_Z,
    SIGMA,
    XID,
    Z,
)
from .expression import ADVICE, FIXED, INSTANCE

P = Fp.MODULUS

# Table kinds in the order the evaluator receives them. Each table is a
# (num_cols, domain, 4)-u64 (host) / (num_cols, domain, 16)-u32 (device) stack.
TABLE_KINDS = (FIXED, ADVICE, INSTANCE, SIGMA, Z,
               LOOKUP_A, LOOKUP_S, LOOKUP_Z, XID, L0, LLAST, LBLIND)
TABLE_INDEX = {k: i for i, k in enumerate(TABLE_KINDS)}

# opcodes
OP_LOAD = 0   # dst <- tables[a][b] rotated by c rows
OP_ADD = 1    # dst <- reg[a] + reg[b]
OP_ADDS = 2   # dst <- reg[a] + scalar[b]
OP_MUL = 3    # dst <- reg[a] * reg[b]
OP_MULS = 4   # dst <- reg[a] * scalar[b]
OP_NEG = 5    # dst <- -reg[a]


@dataclass
class Tape:
    """Compiled tape. `code` is (L, 5) int32 rows (op, dst, a, b, c).
    `scalar_exprs` are pure-scalar Expressions (constants/challenges only)
    evaluated per proof into the scalar table, in slot order. `out_reg` holds
    the Horner accumulator after the last instruction."""

    code: np.ndarray
    scalar_exprs: list[Expression]
    num_regs: int
    out_reg: int

    def scalar_values(self, challenges: dict[str, int]) -> list[int]:
        from .protocol import eval_at_point

        def no_cells(kind, index, rot):  # pragma: no cover - scalar-only
            raise TypeError("scalar slot references a cell")

        return [eval_at_point(e, no_cells, challenges) % P
                for e in self.scalar_exprs]


def _is_scalar(e: Expression, memo: dict) -> bool:
    r = memo.get(id(e))
    if r is not None:
        return r
    if isinstance(e, (Constant, ChallengeVar)):
        r = True
    elif isinstance(e, Cell):
        r = False
    elif isinstance(e, (Sum, Product)):
        r = _is_scalar(e.a, memo) and _is_scalar(e.b, memo)
    elif isinstance(e, Negated):
        r = _is_scalar(e.a, memo)
    else:  # pragma: no cover
        raise TypeError(type(e))
    memo[id(e)] = r
    return r


def compile_tape(exprs: list[Expression], rot_scale: int,
                 y_name: str = "y") -> Tape:
    """Compile `acc = ((e0*y + e1)*y + e2)...` into a flat tape.

    rot_scale: rows per base-domain rotation step (EXT_FACTOR on the
    extended coset, 1 on the base domain).
    """
    scalar_memo: dict = {}
    scalar_slots: dict[Expression, int] = {}
    scalar_exprs: list[Expression] = []

    def scalar_slot(e: Expression) -> int:
        s = scalar_slots.get(e)
        if s is None:
            s = scalar_slots[e] = len(scalar_exprs)
            scalar_exprs.append(e)
        return s

    # --- pass 1: CSE value numbering over vector-valued nodes -------------
    # value := ("load", tbl, col, rot) | ("add"/"mul", va, vb) |
    #          ("adds"/"muls", va, slot) | ("neg", va)
    val_ids: dict = {}       # value key -> value id
    val_defs: list = []      # id -> value key
    node_val: dict[Expression, object] = {}  # expr -> ("v", id) or ("s", slot)

    def intern(key) -> int:
        vid = val_ids.get(key)
        if vid is None:
            vid = val_ids[key] = len(val_defs)
            val_defs.append(key)
        return vid

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        def visit(e: Expression):
            got = node_val.get(e)
            if got is not None:
                return got
            if _is_scalar(e, scalar_memo):
                r = ("s", scalar_slot(e))
            elif isinstance(e, Cell):
                tbl = TABLE_INDEX[e.kind]
                r = ("v", intern(("load", tbl, e.index, e.rotation * rot_scale)))
            elif isinstance(e, Negated):
                a = visit(e.a)
                # vector by _is_scalar above
                r = ("v", intern(("neg", a[1])))
            elif isinstance(e, (Sum, Product)):
                op = "add" if isinstance(e, Sum) else "mul"
                a = visit(e.a)
                b = visit(e.b)
                if a[0] == "s":
                    a, b = b, a
                if b[0] == "s":
                    key = (op + "s", a[1], b[1])
                else:
                    va, vb = a[1], b[1]
                    if va > vb:  # commutative: canonical order helps CSE
                        va, vb = vb, va
                    key = (op, va, vb)
                r = ("v", intern(key))
            else:  # pragma: no cover
                raise TypeError(type(e))
            node_val[e] = r
            return r

        roots = [visit(e) for e in exprs]
    finally:
        sys.setrecursionlimit(old_limit)

    # --- Horner chain over roots ------------------------------------------
    y_slot = scalar_slot(ChallengeVar(y_name))
    acc = None
    for r in roots:
        if r[0] == "s":
            # scalar-valued constraint row (cannot arise: every gate
            # references at least one cell; guard anyway)
            if acc is None:
                raise ValueError("pure-scalar constraint expression")
            acc = intern(("adds", intern(("muls", acc, y_slot)), r[1]))
        else:
            if acc is None:
                acc = r[1]
            else:
                step = intern(("muls", acc, y_slot))
                acc = intern(("add", *sorted((step, r[1]))))
    out_val = acc

    # --- pass 2: liveness + register allocation ---------------------------
    # Instruction order = value id order (defs precede uses by construction).
    nvals = len(val_defs)
    last_use = [i for i in range(nvals)]
    for vid, key in enumerate(val_defs):
        op = key[0]
        srcs = ()
        if op in ("add", "mul"):
            srcs = (key[1], key[2])
        elif op in ("adds", "muls", "neg"):
            srcs = (key[1],)
        for s in srcs:
            last_use[s] = max(last_use[s], vid)
    last_use[out_val] = nvals  # keep the output alive

    reg_of = [-1] * nvals
    free: list[int] = []
    next_reg = 0
    code = np.zeros((nvals, 5), dtype=np.int32)
    # values whose registers can be freed after instruction i
    expiring: dict[int, list[int]] = {}
    for vid in range(nvals):
        expiring.setdefault(last_use[vid], []).append(vid)
    for vid, key in enumerate(val_defs):
        op = key[0]
        # source registers
        if op == "load":
            a, b, c = key[1], key[2], key[3]
            opc = OP_LOAD
        elif op == "add":
            a, b, c = reg_of[key[1]], reg_of[key[2]], 0
            opc = OP_ADD
        elif op == "adds":
            a, b, c = reg_of[key[1]], key[2], 0
            opc = OP_ADDS
        elif op == "mul":
            a, b, c = reg_of[key[1]], reg_of[key[2]], 0
            opc = OP_MUL
        elif op == "muls":
            a, b, c = reg_of[key[1]], key[2], 0
            opc = OP_MULS
        else:  # neg
            a, b, c = reg_of[key[1]], 0, 0
            opc = OP_NEG
        # free registers of values whose last use was THIS instruction's
        # sources (safe: dst may then reuse a source register — ops allow
        # in-place update)
        for dead in expiring.get(vid, ()):
            if dead != vid and reg_of[dead] >= 0:
                free.append(reg_of[dead])
        if free:
            dst = free.pop()
        else:
            dst = next_reg
            next_reg += 1
        reg_of[vid] = dst
        code[vid] = (opc, dst, a, b, c)

    return Tape(code=code, scalar_exprs=scalar_exprs, num_regs=next_reg,
                out_reg=reg_of[out_val])
