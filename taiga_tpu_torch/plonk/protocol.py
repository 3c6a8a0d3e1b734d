"""Protocol pieces shared verbatim by prover and verifier.

Builds the full constraint list (user gates + permutation argument) as
Expression ASTs with the runtime challenges baked in as constants, and
collects the (column, rotation) opening queries. One construction, two
evaluations: the prover evaluates over extended-domain tables (vectorized
device ops), the verifier at the single challenge point — consistency of the
vanishing identity by construction.

Permutation argument (halo2-style, chunked):
  z_0(1) = 1;   z_c(1) = z_{c-1}(w^u)   (chunk linking, u = usable rows)
  (1 - l_last - l_blind) * [ z_c(wX) * prod(v + beta*sigma + gamma)
                             - z_c(X) * prod(v + beta*delta^j*X + gamma) ] = 0
  l_last * (z_last^2 - z_last) = 0
"""

from __future__ import annotations

from ..crypto.fields import Fp
from .circuit import EXT_FACTOR, PERM_CHUNK, ConstraintSystem
from .expression import ADVICE, FIXED, INSTANCE, Cell, ChallengeVar, Constant, Expression, rotations_used
from .keygen import DELTA

P = Fp.MODULUS

# virtual column kinds
SIGMA = "sigma"
Z = "z"
XID = "xid"
L0 = "l0"
LLAST = "llast"
LBLIND = "lblind"
QUOTIENT = "quotient"
LOOKUP_A = "lk_a"  # permuted (sorted) compressed input column A'
LOOKUP_S = "lk_s"  # permuted compressed table column S'
LOOKUP_Z = "lk_z"  # lookup grand-product column

COMMITTED_KINDS = (ADVICE, FIXED, SIGMA, Z, LOOKUP_A, LOOKUP_S, LOOKUP_Z, QUOTIENT)
NUM_H_PIECES = EXT_FACTOR - 1


def num_chunks(perm_cols) -> int:
    return (len(perm_cols) + PERM_CHUNK - 1) // PERM_CHUNK if perm_cols else 0


def build_constraints(
    cs: ConstraintSystem, perm_cols, usable_rows: int
) -> list[Expression]:
    """Deterministic ordered list of constraints. The beta/gamma transcript
    challenges are SYMBOLIC (ChallengeVar) so compiled evaluators are
    reusable across proofs (cache key = the constraint system, not the
    transcript)."""
    exprs: list[Expression] = [g.poly for g in cs.gates]
    if not perm_cols and not cs.lookups:
        return exprs
    beta = ChallengeVar("beta")
    gamma = ChallengeVar("gamma")
    chunks = [perm_cols[i : i + PERM_CHUNK] for i in range(0, len(perm_cols), PERM_CHUNK)]
    l0 = Cell(L0, 0)
    llast = Cell(LLAST, 0)
    lblind = Cell(LBLIND, 0)
    xid = Cell(XID, 0)
    one = Constant(1)
    active = one - (llast + lblind)
    # --- lookup arguments (halo2-style permuted pairs + product) ---------
    theta = ChallengeVar("theta")
    for li, lk in enumerate(cs.lookups):
        a_in = None
        s_tab = None
        for inp, tab in lk.pairs:
            a_in = inp if a_in is None else a_in * theta + inp
            s_tab = tab if s_tab is None else s_tab * theta + tab
        a_p = Cell(LOOKUP_A, li)
        s_p = Cell(LOOKUP_S, li)
        z = Cell(LOOKUP_Z, li)
        exprs.append(l0 * (one - z))
        exprs.append(llast * (z * z - z))
        exprs.append(
            active
            * (
                Cell(LOOKUP_Z, li, 1) * (a_p + beta) * (s_p + gamma)
                - z * (a_in + beta) * (s_tab + gamma)
            )
        )
        exprs.append(l0 * (a_p - s_p))
        exprs.append(active * (a_p - s_p) * (a_p - Cell(LOOKUP_A, li, -1)))
    if not perm_cols:
        return exprs
    for c, chunk in enumerate(chunks):
        z = Cell(Z, c)
        if c == 0:
            exprs.append(l0 * (one - z))
        else:
            exprs.append(l0 * (z - Cell(Z, c - 1, usable_rows)))
        prod_l: Expression = Cell(Z, c, 1)
        prod_r: Expression = z
        for j_local, (kind, idx) in enumerate(chunk):
            jg = c * PERM_CHUNK + j_local
            v = Cell(kind, idx, 0)
            prod_l = prod_l * (v + beta * Cell(SIGMA, jg) + gamma)
            prod_r = prod_r * (
                v + beta * Constant(pow(DELTA, jg, P)) * xid + gamma
            )
        exprs.append(active * (prod_l - prod_r))
    z_last = Cell(Z, len(chunks) - 1)
    exprs.append(llast * (z_last * z_last - z_last))
    return exprs


def protocol_for(vk) -> tuple[list[Expression], list[tuple[str, int, int]]]:
    """(constraints, queries) for a verifying key, built once and cached on
    the vk — the verifier used to rebuild both per call (~4 ms/verify)."""
    cached = getattr(vk, "_protocol_cache", None)
    if cached is None:
        exprs = build_constraints(vk.cs, vk.perm_cols, vk.usable_rows)
        queries = collect_queries(exprs, vk.cs.num_fixed)
        cached = (exprs, queries)
        try:
            vk._protocol_cache = cached
        except AttributeError:
            pass  # vk without __dict__: still correct, just uncached
    return cached


def protocol_compiled(vk):
    """The verifier's whole vanishing-identity fold compiled ONCE per vk into
    a flat Python code object: acc = ((0*y + e_0)*y + e_1)... % P. Returns
    (fn, cells) where fn(cell_vals, beta, gamma, theta, y) -> acc and `cells`
    is the ordered (kind, index, rotation) list whose values the caller
    supplies. ~10x faster than the recursive eval_at_point walk per verify."""
    cached = getattr(vk, "_protocol_compiled_cache", None)
    if cached is None:
        from .expression import Negated, Product, Sum

        exprs, _ = protocol_for(vk)
        cells: list[tuple[str, int, int]] = []
        index: dict = {}
        names = {"beta": "B", "gamma": "G", "theta": "T"}

        def emit(e) -> str:
            if isinstance(e, Constant):
                return str(e.value % P)
            if isinstance(e, ChallengeVar):
                return names[e.name]
            if isinstance(e, Cell):
                key = (e.kind, e.index, e.rotation)
                i = index.get(key)
                if i is None:
                    i = len(cells)
                    index[key] = i
                    cells.append(key)
                return f"V[{i}]"
            if isinstance(e, Sum):
                return f"({emit(e.a)}+{emit(e.b)})"
            if isinstance(e, Product):
                return f"({emit(e.a)}*{emit(e.b)}%P)"
            if isinstance(e, Negated):
                return f"(-{emit(e.a)})"
            raise TypeError(type(e))

        lines = ["def _acc(V, B, G, T, Y, P):", "    a = 0"]
        for e in exprs:
            lines.append(f"    a = (a*Y + ({emit(e)})) % P")
        lines.append("    return a")
        ns: dict = {}
        try:
            exec("\n".join(lines), ns)  # noqa: S102 — self-generated code
            cached = (ns["_acc"], cells)
        except (RecursionError, SyntaxError, MemoryError):
            # a future very-deep gate could exceed CPython's expression
            # nesting limits (ADVICE r4): fall back to the recursive walker
            def _acc_walk(V, B, G, T, Y, P, _exprs=exprs, _cells=tuple(cells)):
                vals = {c: v for c, v in zip(_cells, V)}
                ch = {"beta": B, "gamma": G, "theta": T, "y": Y}
                a = 0
                for e in _exprs:
                    a = (a * Y + eval_at_point(
                        e, lambda kd, i, r: vals[(kd, i, r)], ch)) % P
                return a

            cached = (_acc_walk, cells)
        try:
            vk._protocol_compiled_cache = cached
        except AttributeError:
            pass
    return cached


def collect_queries(exprs: list[Expression], num_fixed: int) -> list[tuple[str, int, int]]:
    """Ordered opening queries for committed columns: (kind, index, rotation).

    Includes every (committed column, rotation) referenced by any constraint,
    plus the quotient pieces at rotation 0. Deterministic ordering.
    """
    refs = set()
    for e in exprs:
        refs |= rotations_used(e)
    order = {ADVICE: 0, FIXED: 1, SIGMA: 2, Z: 3, LOOKUP_A: 4, LOOKUP_S: 5, LOOKUP_Z: 6}
    queries = sorted(
        (q for q in refs if q[0] in order),
        key=lambda q: (order[q[0]], q[1], q[2]),
    )
    # all fixed columns are opened even if unreferenced? no — only referenced.
    queries += [(QUOTIENT, i, 0) for i in range(NUM_H_PIECES)]
    return queries


def transparent_eval(kind: str, index: int, rotation: int, x: int, k: int,
                     usable_rows: int, omega: int, instance: list[int]) -> int:
    """Evaluate a transparent (uncommitted) column at x*omega^rotation."""
    n = 1 << k
    pt = x * pow(omega, rotation % n, P) % P
    if kind == XID:
        return pt
    zh = (pow(pt, n, P) - 1) % P
    n_inv = pow(n, -1, P)

    def lagrange(i: int) -> int:
        wi = pow(omega, i, P)
        denom = (pt - wi) % P
        if denom == 0:
            # pt is on the domain; L_i(pt) = (i == index of pt)
            return 1 if pt == wi else 0
        return wi * zh % P * n_inv % P * pow(denom, -1, P) % P

    if kind == L0:
        return lagrange(0)
    if kind == LLAST:
        return lagrange(usable_rows)
    if kind == LBLIND:
        return sum(lagrange(i) for i in range(usable_rows + 1, n)) % P
    if kind == INSTANCE:
        return sum(v * lagrange(i) for i, v in enumerate(instance) if v) % P
    raise KeyError((kind, index, rotation))


def eval_at_point(expr: Expression, getter, challenges=None) -> int:
    """Evaluate an expression given a cell-value getter(kind, index, rot) and
    a challenges dict name -> int."""
    from .expression import Negated, Product, Sum

    if isinstance(expr, Constant):
        return expr.value
    if isinstance(expr, ChallengeVar):
        return challenges[expr.name]
    if isinstance(expr, Cell):
        return getter(expr.kind, expr.index, expr.rotation)
    if isinstance(expr, Sum):
        return (eval_at_point(expr.a, getter, challenges)
                + eval_at_point(expr.b, getter, challenges)) % P
    if isinstance(expr, Product):
        return (eval_at_point(expr.a, getter, challenges)
                * eval_at_point(expr.b, getter, challenges)) % P
    if isinstance(expr, Negated):
        return (-eval_at_point(expr.a, getter, challenges)) % P
    raise TypeError(type(expr))
