"""Vamp-IR circuit compiler: portable VP source -> taiga-tpu circuit.

Copy of taiga_tpu/circuits/vamp_ir.py (host: parsing, inlining and
synthesis); its proofs run through the port's prover on a torch device
(core.proving.prove_resource_logic). The per-source classes keep the JAX
package's circuit ids (taiga_tpu.rl.vamp_ir.<digest>), so bytecode and
verifying infos read the same in both packages. The bytecode registry
imports this module when a "vamp_ir" bytecode is decoded
(circuits/bytecode.py::circuit_class_by_name), so the arm decodes in any
process.

The reference exposes `VampIRResourceLogicCircuit` (resource_logic_circuit.rs
:617-764) which parses Vamp-IR source (via the `vamp-ir` crate), populates
variable assignments by NAME (vamp_ir_utils.rs:15-46), and proves it as a
resource logic whose public inputs are the module's `pub` variables padded to
the 22-element RL layout.

This module is a from-scratch implementation of the Vamp-IR surface the
reference actually uses (the arithmetic subset exercised by
`vamp_ir_circuits/pyth.pir`): `pub` declarations, `def` function definitions
(inlined at application, i.e. proper macro expansion with parameter
substitution), juxtaposition application, blocks, field arithmetic
(+ - * / ^ with integer exponents), and `=` equality constraints. Source is
compiled onto the standard gadget chip (circuits/gadgets.py vanilla gate), so
Vamp-IR programs prove/verify through the same device prover as every other
circuit.

Out of scope (as in the reference's usage): tuples, higher-order functions,
`fresh` witnesses, iter/fold intrinsics.
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass

from ..core.constants import RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM
from ..core.resource import RandomSeed
from ..crypto.fields import Fp
from ..plonk.circuit import Circuit, CircuitBuilder, ConstraintSystem
from . import gadgets as G
from .bytecode import register_resource_logic

P = Fp.MODULUS


class VampIRError(Exception):
    pass


class SourceParsingError(VampIRError):
    pass


class MissingAssignment(VampIRError):
    def __init__(self, name: str):
        super().__init__(f"missing assignment for variable '{name}'")
        self.name = name


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Const:
    v: int


@dataclass(frozen=True)
class Var:
    name: str


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * / ^
    a: object
    b: object


@dataclass(frozen=True)
class Neg:
    a: object


@dataclass(frozen=True)
class Apply:
    fn: str
    args: tuple


@dataclass(frozen=True)
class Eq:
    """Equality constraint expression; its value is the rhs."""

    a: object
    b: object


@dataclass(frozen=True)
class Block:
    stmts: tuple  # expressions; value = last


@dataclass
class Def:
    name: str
    params: tuple
    body: object


# ---------------------------------------------------------------------------
# tokenizer / parser (recursive descent)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s+|//[^\n]*|/\*.*?\*/|(?P<num>\d+)|(?P<id>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<punct>[(){};,=^*/+-])",
    re.S,
)


def _tokenize(src: str) -> list[tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SourceParsingError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "num":
            toks.append(("num", m.group("num")))
        elif m.lastgroup == "id":
            toks.append(("id", m.group("id")))
        elif m.lastgroup == "punct":
            toks.append(("punct", m.group("punct")))
    return toks


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, val):
        kind, v = self.next()
        if v != val:
            raise SourceParsingError(f"expected {val!r}, got {v!r}")
        return v

    # module := stmt*
    def module(self):
        pubs, defs, constraints = [], {}, []
        while self.peek()[0] is not None:
            kind, v = self.peek()
            if v == "pub":
                self.next()
                while True:
                    k2, name = self.next()
                    if k2 != "id":
                        raise SourceParsingError("expected identifier after pub")
                    pubs.append(name)
                    if self.peek()[1] == ",":
                        self.next()
                        continue
                    break
                self.expect(";")
            elif v == "def":
                self.next()
                k2, name = self.next()
                if k2 != "id":
                    raise SourceParsingError("expected def name")
                params = []
                while self.peek()[0] == "id":
                    params.append(self.next()[1])
                self.expect("=")
                body = self.expr()
                self.expect(";")
                defs[name] = Def(name, tuple(params), body)
            else:
                constraints.append(self.expr())
                self.expect(";")
        return pubs, defs, constraints

    # expr := equality ("=" equality)*
    def expr(self):
        e = self.additive()
        while self.peek()[1] == "=":
            self.next()
            rhs = self.additive()
            e = Eq(e, rhs)
        return e

    def additive(self):
        e = self.term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = BinOp(op, e, self.term())
        return e

    def term(self):
        e = self.appl()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            e = BinOp(op, e, self.appl())
        return e

    # application by juxtaposition: atom+ (tightest after ^/unary)
    def appl(self):
        first = self.unary()
        args = []
        while self._atom_starts():
            args.append(self.unary())
        if args:
            if not isinstance(first, Var):
                raise SourceParsingError("application head must be a name")
            return Apply(first.name, tuple(args))
        return first

    def _atom_starts(self):
        kind, v = self.peek()
        return kind in ("num", "id") or v == "(" or v == "{"

    def unary(self):
        if self.peek()[1] == "-":
            self.next()
            return Neg(self.unary())
        return self.power()

    def power(self):
        e = self.atom()
        if self.peek()[1] == "^":
            self.next()
            kind, v = self.next()
            if kind != "num":
                raise SourceParsingError("exponent must be an integer literal")
            e = BinOp("^", e, Const(int(v)))
        return e

    def atom(self):
        kind, v = self.next()
        if kind == "num":
            return Const(int(v) % P)
        if kind == "id":
            return Var(v)
        if v == "(":
            e = self.expr()
            self.expect(")")
            return e
        if v == "{":
            stmts = []
            while self.peek()[1] != "}":
                stmts.append(self.expr())
                if self.peek()[1] == ";":
                    self.next()
            self.expect("}")
            return Block(tuple(stmts))
        raise SourceParsingError(f"unexpected token {v!r}")


def parse(source: str):
    """Parse Vamp-IR source -> (pub names, defs, top-level constraint exprs)."""
    return _Parser(_tokenize(source)).module()


# ---------------------------------------------------------------------------
# inlining: expand Apply/Block into flat constraint trees over free variables
# ---------------------------------------------------------------------------

_MAX_INLINE_DEPTH = 64


def _inline(e, defs, env, out_constraints, depth=0):
    """Expand e to a tree of Const/Var/BinOp/Neg, appending equality
    constraints to out_constraints. env maps parameter names to trees."""
    if depth > _MAX_INLINE_DEPTH:
        raise SourceParsingError("definition expansion too deep (recursion?)")
    if isinstance(e, Const):
        return e
    if isinstance(e, Var):
        if e.name in env:
            return env[e.name]
        if e.name in defs:
            d = defs[e.name]
            if d.params:
                raise SourceParsingError(f"function '{e.name}' used as value")
            return _inline(d.body, defs, {}, out_constraints, depth + 1)
        return e
    if isinstance(e, Neg):
        return Neg(_inline(e.a, defs, env, out_constraints, depth))
    if isinstance(e, BinOp):
        return BinOp(
            e.op,
            _inline(e.a, defs, env, out_constraints, depth),
            _inline(e.b, defs, env, out_constraints, depth),
        )
    if isinstance(e, Eq):
        a = _inline(e.a, defs, env, out_constraints, depth)
        b = _inline(e.b, defs, env, out_constraints, depth)
        out_constraints.append((a, b))
        return b
    if isinstance(e, Block):
        last = Const(0)
        for s in e.stmts:
            last = _inline(s, defs, env, out_constraints, depth)
        return last
    if isinstance(e, Apply):
        d = defs.get(e.fn)
        if d is None:
            raise SourceParsingError(f"undefined function '{e.fn}'")
        if len(e.args) != len(d.params):
            raise SourceParsingError(
                f"'{e.fn}' expects {len(d.params)} args, got {len(e.args)}"
            )
        args = [_inline(a, defs, env, out_constraints, depth) for a in e.args]
        return _inline(d.body, defs, dict(zip(d.params, args)), out_constraints, depth + 1)
    raise SourceParsingError(f"cannot inline {e!r}")


def _free_vars(e, acc):
    if isinstance(e, Var):
        acc.add(e.name)
    elif isinstance(e, (BinOp,)):
        _free_vars(e.a, acc)
        _free_vars(e.b, acc)
    elif isinstance(e, Neg):
        _free_vars(e.a, acc)


class VampIRModule:
    """Compiled module: flat constraints (lhs, rhs) over named free vars."""

    def __init__(self, source: str):
        self.source = source
        pubs, defs, exprs = parse(source)
        from ..core.constants import RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM as _NPUB

        if len(pubs) > _NPUB:
            raise VampIRError(
                f"{len(pubs)} pub variables exceed the fixed {_NPUB}-element "
                "resource-logic public-input layout"
            )
        self.pubs = pubs
        self.constraints: list[tuple] = []
        for e in exprs:
            v = _inline(e, defs, {}, self.constraints)
            # a bare non-equality top-level expression constrains nothing;
            # vamp-ir treats it as dead code — accept and drop.
            del v
        fv: set[str] = set()
        for a, b in self.constraints:
            _free_vars(a, fv)
            _free_vars(b, fv)
        for name in pubs:
            fv.add(name)
        self.variables = sorted(fv)
        self.digest = hashlib.blake2b(
            source.encode(), digest_size=12, person=b"TaigaTPUvampIR"
        ).hexdigest()

    # --- host evaluation ------------------------------------------------
    def eval_host(self, e, asg: dict) -> int:
        if isinstance(e, Const):
            return e.v % P
        if isinstance(e, Var):
            if e.name not in asg:
                raise MissingAssignment(e.name)
            return asg[e.name] % P
        if isinstance(e, Neg):
            return (-self.eval_host(e.a, asg)) % P
        if isinstance(e, BinOp):
            a = self.eval_host(e.a, asg)
            if e.op == "^":
                return pow(a, e.b.v, P)
            b = self.eval_host(e.b, asg)
            if e.op == "+":
                return (a + b) % P
            if e.op == "-":
                return (a - b) % P
            if e.op == "*":
                return a * b % P
            if e.op == "/":
                if b == 0:
                    raise VampIRError("division by zero in witness")
                return a * pow(b, -1, P) % P
        raise VampIRError(f"cannot evaluate {e!r}")

    def check_assignments(self, asg: dict):
        for name in self.variables:
            if name not in asg:
                raise MissingAssignment(name)


_MODULE_CACHE: dict[str, VampIRModule] = {}
_CLASS_CACHE: dict[str, type] = {}
_CACHE_LIMIT = 256  # untrusted wire input compiles dynamic classes: bound it
MAX_SOURCE_BYTES = 1 << 20


def _evict(cache: dict):
    while len(cache) > _CACHE_LIMIT:
        cache.pop(next(iter(cache)))


def compile_module(source: str) -> VampIRModule:
    if len(source) > MAX_SOURCE_BYTES:
        raise VampIRError("vamp-ir source too large")
    m = _MODULE_CACHE.get(source)
    if m is None:
        m = _MODULE_CACHE[source] = VampIRModule(source)
        _evict(_MODULE_CACHE)
    return m


@register_resource_logic("vamp_ir")
class VampIRResourceLogicCircuit(Circuit):
    """A Vamp-IR program proven as a resource logic (reference
    resource_logic_circuit.rs:617-764): public inputs are the module's `pub`
    variables, padded to the 22-element RL layout with RandomSeed padding
    (reference :722-727). Use `for_source(source)` to get the per-program
    circuit class (constraint layout is a pure function of the source)."""

    NUM_FIXED = G.NUM_FIXED
    NUM_ADVICE = G.NUM_ADVICE
    NUM_INSTANCE = 1
    MODULE: VampIRModule | None = None

    def __init__(self, assignments: dict | None = None):
        m = type(self).MODULE
        if m is None:
            raise VampIRError("use VampIRResourceLogicCircuit.for_source(...)")
        self.assignments = None
        if assignments is not None:
            asg = {
                k: (v.v if isinstance(v, Fp) else int(v) % P)
                for k, v in assignments.items()
            }
            m.check_assignments(asg)
            self.assignments = asg
        self._padding_seed = RandomSeed.random()

    # --- construction -----------------------------------------------------
    @classmethod
    def for_source(cls, source: str) -> type:
        """Dynamic per-source subclass (distinct proving-key cache entry)."""
        m = compile_module(source)
        sub = _CLASS_CACHE.get(m.digest)
        if sub is None:
            sub = type(
                f"VampIR_{m.digest}",
                (VampIRResourceLogicCircuit,),
                {"MODULE": m, "__module__": __name__},
            )
            sub.__qualname__ = sub.__name__
            _CLASS_CACHE[m.digest] = sub
            _evict(_CLASS_CACHE)
        return sub

    @classmethod
    def from_vamp_ir_source(cls, source: str, named_assignments: dict):
        return cls.for_source(source)(named_assignments)

    @classmethod
    def from_vamp_ir_file(cls, path: str, inputs_path: str):
        with open(path) as f:
            source = f.read()
        with open(inputs_path) as f:
            raw = json.load(f)
        asg = {k: int(v) % P for k, v in raw.items()}
        return cls.from_vamp_ir_source(source, asg)

    # --- bytecode (registry) round trip ------------------------------------
    def to_bytes(self) -> bytes:
        if self.assignments is None:
            raise VampIRError("cannot serialize an unassigned circuit")
        return json.dumps(
            {
                "source": type(self).MODULE.source,
                "inputs": {k: str(v) for k, v in self.assignments.items()},
            }
        ).encode()

    @classmethod
    def from_bytes(cls, data: bytes):
        obj = json.loads(data.decode())
        asg = {k: int(v) % P for k, v in obj["inputs"].items()}
        return cls.from_vamp_ir_source(obj["source"], asg)

    @classmethod
    def circuit_id(cls) -> str:
        m = cls.MODULE
        tag = m.digest if m is not None else "generic"
        return f"taiga_tpu.rl.vamp_ir.{tag}"

    # --- public inputs ------------------------------------------------------
    def get_public_inputs(self) -> list[Fp]:
        cached = getattr(self, "_cached_public_inputs", None)
        if cached is not None:
            return cached
        m = type(self).MODULE
        if self.assignments is None:
            raise VampIRError("no assignments populated")
        pubs = [Fp(self.assignments[name]) for name in m.pubs]
        pad = self._padding_seed.get_random_padding(
            RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM - len(pubs)
        )
        out = pubs + pad
        self._cached_public_inputs = out
        return out

    # --- synthesis ------------------------------------------------------------
    @classmethod
    def configure(cls, cs: ConstraintSystem):
        G.configure_standard(cs)
        return None

    def synthesize(self, b: CircuitBuilder, config):
        m = type(self).MODULE
        asg = self.assignments
        cells = {
            name: G.witness_cell(b, asg[name] if asg is not None else None)
            for name in m.variables
        }
        for a_e, b_e in m.constraints:
            ca = self._emit(b, a_e, cells, asg)
            cb = self._emit(b, b_e, cells, asg)
            G.assert_equal(b, ca, cb)
        for i, name in enumerate(m.pubs):
            b.constrain_instance(cells[name], i)
        # pad the remaining RL public-input rows with publicized witnesses
        vals = self.get_public_inputs() if asg is not None else None
        for idx in range(len(m.pubs), RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM):
            cell = G.witness_cell(b, vals[idx].v if vals else None)
            b.constrain_instance(cell, idx)

    def _emit(self, b: CircuitBuilder, e, cells: dict, asg):
        """Lower an expression tree to an assigned cell via the vanilla gate."""
        m = type(self).MODULE
        if isinstance(e, Const):
            return G.constant_cell(b, e.v)
        if isinstance(e, Var):
            return cells[e.name]
        if isinstance(e, Neg):
            return G.mul_const(b, self._emit(b, e.a, cells, asg), P - 1)
        if isinstance(e, BinOp):
            if e.op == "^":
                base = self._emit(b, e.a, cells, asg)
                return self._emit_pow(b, base, e.b.v)
            ca = self._emit(b, e.a, cells, asg)
            cb = self._emit(b, e.b, cells, asg)
            if e.op == "+":
                return G.add_cells(b, ca, cb)
            if e.op == "-":
                return G.sub_cells(b, ca, cb)
            if e.op == "*":
                return G.mul_cells(b, ca, cb)
            if e.op == "/":
                # q = a/b with b proven nonzero: witness binv, b*binv = 1,
                # then q*b = a.
                bv = None if asg is None else self.eval_host(m, e.b, asg)
                binv = G.witness_cell(
                    b, None if bv is None else pow(bv, -1, P) if bv else 0
                )
                one = G.mul_cells(b, cb, binv)
                G.assert_equal_constant(b, one, 1)
                qv = None if asg is None else self.eval_host(m, e, asg)
                q = G.witness_cell(b, qv)
                qa = G.mul_cells(b, q, cb)
                G.assert_equal(b, qa, ca)
                return q
        raise VampIRError(f"cannot lower {e!r}")

    @staticmethod
    def eval_host(m: VampIRModule, e, asg: dict) -> int:
        return m.eval_host(e, asg)

    def _emit_pow(self, b: CircuitBuilder, base, k: int):
        if k == 0:
            return G.constant_cell(b, 1)
        acc = None
        sq = base
        while k:
            if k & 1:
                acc = sq if acc is None else G.mul_cells(b, acc, sq)
            k >>= 1
            if k:
                sq = G.mul_cells(b, sq, sq)
        return acc
