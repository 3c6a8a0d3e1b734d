"""In-circuit Poseidon hash-to-curve (resource kind derivation).

Mirrors taiga_halo2/src/circuit/hash_to_curve.rs and the
curve/{map_to_curve,iso_map}.rs chips: u_i = Poseidon(message || postfix_i),
simplified-SWU each u_i onto the 3-isogenous curve, add the two iso points,
then apply the 3-isogeny rational maps — matching the host
`core.resource.poseidon_to_curve` (utils.rs:50-68) bit for bit.

Circuit strategy: witness the intermediates (inverses, square roots) and
constrain the defining equations —
  * ta = Z^2 u^4 + Z u^2, constrained nonzero via a witnessed inverse
    (completeness loss ~2/p for adversarially-chosen messages; the
    reference circuit makes the same exceptional-case tradeoff);
  * x1 from A*x1*ta + B*ta + B = 0; gx1 = x1^3 + A x1 + B;
  * square/nonsquare branch: witness r with r^2 = gx1 (flag = 1) or
    5 r^2 = gx1 (flag = 0; 5 generates Fp* so it is a quadratic
    non-residue, proving gx1 is not a square);
  * y^2 = gx(selected); the sign constraint sgn0(y) = sgn0(u) uses the
    canonical 255-bit decompositions of y and u (parity bits);
  * incomplete iso-curve chord addition; iso_map via witnessed quotients
    X*div_x = num_x, Y*div_y = num_y with div != 0 (witnessed inverses).
"""

from __future__ import annotations

from ..core.constants import (
    POSEIDON_TO_FIELD_U_0_POSTFIX,
    POSEIDON_TO_FIELD_U_1_POSTFIX,
)
from ..crypto.curves import PallasPoint, _swu_params, iso_map, map_to_curve_simple_swu
from ..crypto.fields import Fp
from ..plonk.circuit import CircuitBuilder
from . import gadgets as G
from .ec_gadgets import PointCells, decompose_canonical_255

P = Fp.MODULUS


def _inv_witness(b: CircuitBuilder, cell):
    """Witness cell^-1 and constrain cell * inv = 1 (forces cell != 0)."""
    v = cell.value
    inv = None if v is None else pow(v, -1, P)
    ic = G.witness_cell(b, inv)
    prod = G.mul_cells(b, cell, ic)
    G.assert_equal_constant(b, prod, 1)
    return ic


def _parity_bit(b: CircuitBuilder, cell, one_cell):
    """The low bit of the canonical representation of a field cell."""
    bits = decompose_canonical_255(b, cell, one_cell)
    return bits[0]


def map_to_curve_gadget(b: CircuitBuilder, u_cell, one_cell) -> PointCells:
    """Simplified SWU: field cell -> point on the iso-Pallas curve."""
    params = _swu_params(PallasPoint)
    A, B, Z = params.iso_a, params.iso_b, params.z

    uv = u_cell.value
    host_pt = None if uv is None else map_to_curve_simple_swu(Fp(uv))

    u2 = G.mul_cells(b, u_cell, u_cell)
    zu2 = G.mul_const(b, u2, Z)
    zu2_sq = G.mul_cells(b, zu2, zu2)
    ta = G.add_cells(b, zu2_sq, zu2)  # Z^2 u^4 + Z u^2
    _inv_witness(b, ta)  # ta != 0 (exceptional input excluded)

    # x1: A*x1*ta + B*ta + B = 0
    if uv is None:
        x1v = None
    else:
        tav = ta.value
        x1v = (-B) * pow(A, -1, P) % P * (1 + pow(tav, -1, P)) % P
    x1 = G.witness_cell(b, x1v)
    x1ta = G.mul_cells(b, x1, ta)
    ca, cb, _ = G.assign_vanilla(
        b, ql=A % P, qr=B % P, qc=B % P, va=x1ta.value, vb=ta.value
    )
    b.copy(ca, x1ta)
    b.copy(cb, ta)

    # gx1 = x1^3 + A x1 + B
    x1_2 = G.mul_cells(b, x1, x1)
    x1_3 = G.mul_cells(b, x1_2, x1)
    t = G.add_scaled(b, x1_3, x1, A)
    gx1 = G.add_const(b, t, B)

    # square / non-square branch witness
    if uv is None:
        flagv = rv = None
    else:
        s = Fp(gx1.value).sqrt()
        if s is not None:
            flagv, rv = 1, s.v
        else:
            # gx1 = 5 * r^2 (5 is a non-residue); r = sqrt(gx1/5)
            flagv = 0
            rv = Fp(gx1.value * pow(5, -1, P) % P).sqrt().v
    flag = G.witness_cell(b, flagv)
    G.is_bool(b, flag)
    r = G.witness_cell(b, rv)
    r2 = G.mul_cells(b, r, r)
    five_r2 = G.mul_const(b, r2, 5)
    sel_sq = G.select_cell(b, flag, r2, five_r2)
    G.assert_equal(b, sel_sq, gx1)

    # x = flag ? x1 : x2 = zu2 * x1;  gx = x^3 + A x + B;  y^2 = gx
    x2 = G.mul_cells(b, zu2, x1)
    x = G.select_cell(b, flag, x1, x2)
    x_2 = G.mul_cells(b, x, x)
    x_3 = G.mul_cells(b, x_2, x)
    t2 = G.add_scaled(b, x_3, x, A)
    gx = G.add_const(b, t2, B)
    yv = None if host_pt is None else host_pt.y.v
    y = G.witness_cell(b, yv)
    y2 = G.mul_cells(b, y, y)
    G.assert_equal(b, y2, gx)

    # sign: parity(y) == parity(u)
    pu = _parity_bit(b, u_cell, one_cell)
    py = _parity_bit(b, y, one_cell)
    G.assert_equal(b, pu, py)
    return PointCells(x, y)


def iso_add_gadget(b: CircuitBuilder, p1: PointCells, p2: PointCells) -> PointCells:
    """Incomplete chord addition on the iso curve (the chord law is
    curve-agnostic; u0 = u1 collisions are negligible)."""
    from .ec_gadgets import ec_add_gadget

    return ec_add_gadget(b, p1, p2)


def iso_map_gadget(b: CircuitBuilder, pt: PointCells) -> PointCells:
    """3-isogeny rational maps with witnessed quotients (iso_map.rs)."""
    k = _swu_params(PallasPoint).consts
    x, y = pt.x, pt.y

    def horner(cells_coeffs, xcell):
        # c0*x^d + ... evaluated left-to-right: acc = acc*x + c
        acc = None
        for c in cells_coeffs:
            if acc is None:
                acc = G.constant_cell(b, c)
            else:
                m = G.mul_cells(b, acc, xcell)
                acc = G.add_const(b, m, c)
        return acc

    num_x = horner([k[0], k[1], k[2], k[3]], x)
    div_x = horner([1, k[4], k[5]], x)
    num_y0 = horner([k[6], k[7], k[8], k[9]], x)
    num_y = G.mul_cells(b, num_y0, y)
    div_y = horner([1, k[10], k[11], k[12]], x)
    _inv_witness(b, div_x)
    _inv_witness(b, div_y)

    if x.value is None:
        Xv = Yv = None
    else:
        Xv = num_x.value * pow(div_x.value, -1, P) % P
        Yv = num_y.value * pow(div_y.value, -1, P) % P
    X = G.witness_cell(b, Xv)
    Y = G.witness_cell(b, Yv)
    G.assert_equal(b, G.mul_cells(b, X, div_x), num_x)
    G.assert_equal(b, G.mul_cells(b, Y, div_y), num_y)
    return PointCells(X, Y)


def derive_kind_gadget(b: CircuitBuilder, logic_cell, label_cell, one_cell) -> PointCells:
    """kind = poseidon_to_curve([logic, label]) in-circuit
    (integrity.rs:514-543 derive_kind)."""
    post0 = [G.constant_cell(b, v.v) for v in POSEIDON_TO_FIELD_U_0_POSTFIX]
    post1 = [G.constant_cell(b, v.v) for v in POSEIDON_TO_FIELD_U_1_POSTFIX]
    u0 = G.poseidon_hash_n_gadget(b, [logic_cell, label_cell] + post0)
    u1 = G.poseidon_hash_n_gadget(b, [logic_cell, label_cell] + post1)
    q0 = map_to_curve_gadget(b, u0, one_cell)
    q1 = map_to_curve_gadget(b, u1, one_cell)
    q = iso_add_gadget(b, q0, q1)
    return iso_map_gadget(b, q)
