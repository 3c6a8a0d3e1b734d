"""Fused 255-bit field and curve kernels: hand-written CUDA for Hopper, each
beside its plain PyTorch version.

Port of taiga_tpu/ops/ff_kernels.py. Layout is the reference's limb-major
one: a batch of B field elements is a (16, B) int32 tensor (16-bit limbs,
Montgomery form), limbs on rows and the batch on the fast axis, so a CUDA
warp's lanes read neighbouring words.

  K1 mont_mul_lm        a*b*R^-1 mod p                 csrc/mont_mul.cu
  K2 ec_add_proj_lm     complete projective add        csrc/ec_add_proj.cu
  K3 ec_add_proj_sel_lm sel ? P1 + P2 : P1             csrc/ec_add_proj.cu
     ec_seg_rounds_lm   K3 chained: segmented rounds   csrc/ec_add_proj.cu
     ec_horner_lm       K2 chained: a Horner evaluation  csrc/ec_add_proj.cu
     ec_bucket_weights_lm  K2 chained: sum_j j B_j       csrc/ec_add_proj.cu
  K5 ec_fold_shared_lm  G_lo + [s] G_hi, one shared s  csrc/ec_fold_shared.cu
  K6 ec_add_lm          complete Jacobian add          csrc/ec_add_jac.cu
     ec_add_tree_lm     K6 chained: columns' halving trees  csrc/ec_add_jac.cu
  K7 ec_add_select_lm   sel ? P1 + P2 : P1 (Jacobian)  csrc/ec_add_jac.cu
     ec_ladder_lm       K7 chained: double-and-add     csrc/ec_add_jac.cu
     ec_double_lm       Jacobian doubling (dbl-2009-l) csrc/ec_add_jac.cu
  K8 mont_inv_lm        a^-1 of each row (divsteps)    csrc/grand_product.cu
  K9 mont_cumprod_lm    prefix or suffix products      csrc/grand_product.cu
     powers_lm          1, x, .., x^(n-1) of each x    csrc/grand_product.cu
  K10 perm_terms_lm     the grand products' numerators csrc/grand_product.cu
      lookup_terms_lm   and denominators               csrc/grand_product.cu
  K11 ntt_lm            the NTT family, two passes     csrc/ntt.cu
  K12 eval_polys_lm     C polynomials at Q points      csrc/poly.cu
  K13 linear_combo_lm   sum_c w_c * stack_c (grouped)  csrc/poly.cu
  K14 synthetic_div_lm  (A(X) - A(p)) / (X - p)        csrc/poly.cu
  K15 permute_pairs_lm  the lookups' permuted pairs    csrc/lookup_sort.cu
  K16 from_mont_lm      a R^-1 (out of Montgomery form) csrc/convert.cu
  K17 msm_digits_lm     an MSM's window digits and keys csrc/convert.cu
  (K4, the tape interpreter, is ops/tape_device.py + csrc/tape_eval.cu;
  K11's plain version is ops/ntt.py::ntt_plain, K12-K14's are
  ops/poly.py::eval_polys_plain, linear_combo_plain, synthetic_div_plain,
  K15's ops/lookup_sort.py::permute_pairs_plain, K16's ops/limbs.py's
  from_mont, K17's ops/msm.py::msm_digits_plain.)
  K8-K17 take element-major (..., 16) rows, the layout of ops/limbs.py;
  mont_mul_rows runs K1 on such rows.

Dispatch is by the tensors' device: on the CPU a wrapper runs the plain
version; on a CUDA tensor it launches its kernel or raises. `plain_versions()`
forces the plain versions on the card too — the twin run that holds a whole
proof made by the kernels against one made without them. Every wrapper
counts its kernel launches in `<wrapper>.launches`.

Field constants are keyed by the field's name ("fp" or "fq"); nothing is
inferred from n0inv, which both Pasta primes share.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
import torch

from . import cuda_kernels as CK
from . import limbs as L

NLIMBS = 16

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within this block every wrapper (K1-K17, ec_seg_rounds, ec_horner,
    ec_bucket_weights, ec_ladder, ec_double, ec_add_tree, and
    poseidon_kernel's permute_batch and hash_n_batch) runs its plain
    version, on any device. Used to hold
    the kernels' results against the plain path. The flag is module state:
    it covers every thread, the pipelined prover's worker included."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its CUDA kernel: the inputs lie on
    a CUDA device (all on the same one) and plain versions are not forced."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu" or _force_plain:
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check_lm(name: str, t: torch.Tensor, *shape: int):
    if t.dtype != L.DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {L.DTYPE}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _spec(field: str) -> L.FieldSpec:
    return L.FIELDS[field]


# ---------------------------------------------------------------------------
# plain versions (limb-major int32 in and out)
# ---------------------------------------------------------------------------


def _mm_cios(a, b, field: str):
    """Montgomery product of limb-major int32 tensors (reference _mm_cios)."""
    return L.lm_mul(a, b, _spec(field))


def _madd(a, b, field: str):
    return L.lm_add(a, b, _spec(field))


def _msub(a, b, field: str):
    return L.lm_sub(a, b, _spec(field))


def _stacked(op, field: str):
    """op applied once to several operand pairs: lists of (16, B) tensors
    are stacked on a new axis, so each step of a formula is one call."""

    def run(lhs, rhs):
        return op(torch.stack(lhs, 1), torch.stack(rhs, 1), field).unbind(1)

    return run


def _ec_add_proj_core(x1, y1, z1, x2, y2, z2, field: str):
    """Complete homogeneous-projective addition for a = 0, b3 = 15
    (Renes-Costello-Batina 2015, Algorithm 7). Handles identity (0:1:0) and
    doubling with NO case analysis — 12 muls + 2 cheap b3 scalings.

    The reference's field operations, in its order, with the independent
    ones of each step stacked into one call (6 products, then 6 more, and
    the two b3 scalings side by side): every value, and so every limb, is
    the op-by-op formula's, at a fifth of the calls."""
    mm, add, sub = (_stacked(op, field) for op in (_mm_cios, _madd, _msub))

    s = add([x1, y1, x1, x2, y2, x2], [y1, z1, z1, y2, z2, z2])
    t0, t1, t2, m3, m4, mx = mm([x1, y1, z1, s[0], s[1], s[2]], [x2, y2, z2, s[3], s[4], s[5]])
    a01, a12, a02, d0 = add([t0, t1, t0, t0], [t1, t2, t2, t0])
    t3, t4, y3 = sub([m3, m4, mx], [a01, a12, a02])
    # t0 = 3 t0, and 15 t2, 15 y3 as 16t - t (b3 = 3b = 15 for both Pasta
    # curves; the reference's _mul15: four doublings and a subtract)
    d2, dy, t0 = add([t2, y3, d0], [t2, y3, t0])
    for _ in range(3):
        d2, dy = add([d2, dy], [d2, dy])
    t2, y3 = sub([d2, dy], [t2, y3])
    (z3,) = add([t1], [t2])
    (t1,) = sub([t1], [t2])
    p0, p1, p2, p3, p4, p5 = mm([t3, t4, y3, t1, t0, z3], [t1, y3, t0, z3, t3, t4])
    (x3,) = sub([p0], [p1])
    y3, z3 = add([p2, p5], [p3, p4])
    return x3.contiguous(), y3.contiguous(), z3.contiguous()


def _ec_dbl_proj_core(x, y, z, field: str):
    """2 (x : y : z) by the RCB add's polynomials at P = Q, as the kernels'
    doubling computes it (csrc/ec_group.cuh, ec_dbl_proj_group): x x, y y,
    z z, x y, y z, x z, where the add's (x1 + y1)(x2 + y2) - (t0 + t1) is
    2 x y (and likewise 2 y z, 2 x z), then the add's own chain and stage
    B. The same field values as _ec_add_proj_core(P, P), so, every value
    being canonical for canonical inputs, the same limbs."""
    mm, add, sub = (_stacked(op, field) for op in (_mm_cios, _madd, _msub))
    t0, t1, t2, m3, m4, m5 = mm([x, y, z, x, y, x], [x, y, z, y, z, z])
    t3, t4, y3, d0 = add([m3, m4, m5, t0], [m3, m4, m5, t0])
    d2, dy, t0 = add([t2, y3, d0], [t2, y3, t0])
    for _ in range(3):
        d2, dy = add([d2, dy], [d2, dy])
    t2, y3 = sub([d2, dy], [t2, y3])
    (z3,) = add([t1], [t2])
    (t1,) = sub([t1], [t2])
    p0, p1, p2, p3, p4, p5 = mm([t3, t4, y3, t1, t0, z3], [t1, y3, t0, z3, t3, t4])
    (x3,) = sub([p0], [p1])
    y3, z3 = add([p2, p5], [p3, p4])
    return x3.contiguous(), y3.contiguous(), z3.contiguous()


def _is_zero(a):
    return (a == 0).all(dim=0)


def _jac_stages(p1p2, q, field: str):
    """The Jacobian formulas by the product stages of csrc/ec_group.cuh's
    Jacobian core: the general add P1 + P2 (p1p2 = (x1, y1, z1, x2, y2, z2);
    the reference _ec_add_core's formula; gives x3, y3, z3, h, r) and the
    doubling 2Q (q = (x, y, z); dbl-2009-l for a = 0, no case analysis: an
    identity lane gets Z3 = 2YZ = 0), either or both, each stage's
    independent products of both stacked into one call (the add's 16 in 5
    calls, the doubling's 7 in the first 3). Every value, and so every limb,
    is the op-by-op formulas'. Returns (x3, y3, z3, h, r) or None, and 2Q or
    None."""
    mm, add, sub = (_stacked(op, field) for op in (_mm_cios, _madd, _msub))
    A, D = p1p2 is not None, q is not None
    if A:
        x1, y1, z1, x2, y2, z2 = p1p2
    if D:
        qx, qy, qz = q

    def both(a_ops, d_ops):  # the add's operands, then the doubling's
        return (a_ops() if A else []) + (d_ops() if D else [])

    # stage 1: z1 z1, z2 z2, z1 z2 | X X, Y Y, Y Z
    p = mm(both(lambda: [z1, z2, z1], lambda: [qx, qy, qy]),
           both(lambda: [z1, z2, z2], lambda: [qx, qy, qz]))
    if A:
        z1z1, z2z2, z1z2 = p[:3]
    if D:
        a_, b_, yz = p[-3:]
        xb, e_, dz = add([qx, a_, yz], [b_, a_, yz])
        (e_,) = add([e_], [a_])  # E = 3A
    # stage 2: x1 z2z2, x2 z1z1, z2 z2z2, z1 z1z1 | B B, (X+B)(X+B), E E
    p = mm(both(lambda: [x1, x2, z2, z1], lambda: [b_, xb, e_]),
           both(lambda: [z2z2, z1z1, z2z2, z1z1], lambda: [b_, xb, e_]))
    if A:
        u1, u2, t2, t1 = p[:4]
        (h,) = sub([u2], [u1])
    if D:
        c_, xb2, f_ = p[-3:]
        (d_,) = sub([xb2], [a_])
        (d_,) = sub([d_], [c_])
        (d_,) = add([d_], [d_])  # D = 2((X+B)^2 - A - C)
        c2, d2 = add([c_, d_], [c_, d_])
        (dx,) = sub([f_], [d2])
        (c8,) = add([c2], [c2])
        (c8,) = add([c8], [c8])  # 8C
        (t,) = sub([d_], [dx])
    # stage 3: y1 t2, y2 t1, h h, z1z2 h | E (D - X3)
    p = mm(both(lambda: [y1, y2, h, z1z2], lambda: [e_]),
           both(lambda: [t2, t1, h, h], lambda: [t]))
    dbl = None
    if D:
        (dy,) = sub([p[-1]], [c8])
        dbl = (dx.contiguous(), dy.contiguous(), dz.contiguous())
    if not A:
        return None, dbl
    s1, s2, hh, z3 = p[:4]
    (r,) = sub([s2], [s1])
    # stage 4: h hh, u1 hh, r r; stage 5: r (v - x3), s1 hhh
    hhh, v, r2 = mm([h, u1, r], [hh, hh, r])
    (v2,) = add([v], [v])
    (x3,) = sub([r2], [hhh])
    (x3,) = sub([x3], [v2])
    (vx,) = sub([v], [x3])
    rv, sh = mm([r, s1], [vx, hhh])
    (y3,) = sub([rv], [sh])
    return (x3, y3, z3, h, r), dbl


def _ec_double_core(x1, y1, z1, field: str):
    """Jacobian doubling for a = 0 (dbl-2009-l; taiga_tpu/ops/ec.py::ec_double),
    no case analysis: an identity lane (Z = 0) gets Z3 = 2YZ = 0."""
    return _jac_stages(None, (x1, y1, z1), field)[1]


def _ec_add_cases(x1, y1, z1, x2, y2, z2, x3, y3, z3, h, r, field: str):
    """The complete add's result from the general formula's (reference
    _ec_add_core's selection): the doubling of P1 where P1 = P2 (h = r = 0;
    computed only when a lane takes it), Z = 0 where P1 = -P2, the other
    operand where one is the identity (Z = 0)."""
    p_inf = _is_zero(z1)
    q_inf = _is_zero(z2)
    h_zero = _is_zero(h)
    r_zero = _is_zero(r)
    both = ~p_inf & ~q_inf
    is_double = both & h_zero & r_zero
    is_cancel = both & h_zero & ~r_zero

    xo, yo, zo = x3, y3, z3
    if bool(is_double.any()):  # the doubling path; no lane reads it otherwise
        dx, dy, dz = _ec_double_core(x1, y1, z1, field)
        xo = torch.where(is_double, dx, x3)
        yo = torch.where(is_double, dy, y3)
        zo = torch.where(is_double, dz, z3)
    zo = torch.where(is_cancel, 0, zo)
    xo = torch.where(p_inf, x2, torch.where(q_inf, x1, xo))
    yo = torch.where(p_inf, y2, torch.where(q_inf, y1, yo))
    zo = torch.where(p_inf, z2, torch.where(q_inf, z1, zo))
    return xo, yo, zo


def _ec_add_core(x1, y1, z1, x2, y2, z2, field: str):
    """Complete Jacobian addition (reference _ec_add_core): the general add
    (16 products in 5 stacked calls), then the selection of
    _ec_add_cases."""
    pts = (x1, y1, z1, x2, y2, z2)
    head, _ = _jac_stages(pts, None, field)
    return _ec_add_cases(*pts, *head, field)


def mont_mul_plain(a, b, field: str = "fq"):
    """Plain version of K1: (16, B) x (16, B) Montgomery product."""
    return _mm_cios(a, b, field)


def ec_add_proj_plain(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """Plain version of K2."""
    return _ec_add_proj_core(x1, y1, z1, x2, y2, z2, field)


def ec_add_proj_sel_plain(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """Plain version of K3: sel ? P1 + P2 : P1, lane-wise."""
    x3, y3, z3 = ec_add_proj_plain(x1, y1, z1, x2, y2, z2, field)
    m = sel[0] != 0
    return torch.where(m, x3, x1), torch.where(m, y3, y1), torch.where(m, z3, z1)


def seg_offsets(keys, tile: int = 0):
    """Each lane's offset from its run's first lane along the last axis of
    keys (..., n): runs are maximal stretches of equal keys, and with
    tile > 0 a tile's first lane also starts a run."""
    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    start = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    start[..., 1:] = keys[..., 1:] != keys[..., :-1]
    if tile:
        start |= idx % tile == 0
    return idx - torch.cummax(torch.where(start, idx, 0), dim=-1).values


def seg_adds(keys, rounds: int, tile: int = 0):
    """The lanes each round of ec_seg_rounds adds at, flattened: a list of
    int64 index tensors, round r's lanes i (offset a multiple of 2^(r+1))
    whose lane i + 2^r is in i's run. Ends at the first round with none."""
    n = keys.shape[-1]
    off = seg_offsets(keys, tile).reshape(-1)
    col = torch.arange(n, device=keys.device).repeat(off.numel() // max(n, 1))
    out = []
    for r in range(rounds):
        s = 1 << r
        cand = (off % (2 * s) == 0) & (col + s < n)
        if tile:
            cand &= col % tile + s < tile
        i = cand.nonzero()[:, 0]
        i = i[off[i + s] == off[i] + s]
        if i.numel() == 0:
            break
        out.append(i)
    return out


def ec_seg_rounds_plain(x, y, z, keys, rounds: int, field: str = "fq", tile: int = 0):
    """Plain version of ec_seg_rounds, over points (16, ..., n) and int64
    keys (..., n) sorted along the last axis (a row). Runs are maximal
    stretches of equal keys; with tile > 0 a tile's first lane also starts
    a run. Round r < rounds adds only at the offsets divisible by 2^(r+1)
    from a run's first lane: lane i <- P_i + P_(i + 2^r) where lane i + 2^r
    is in i's run (K2's add, on those lanes alone).

    The contract: a lane is *defined* when its offset from its run's first
    lane is a multiple of 2^rounds. A defined lane holds what the
    reference's Hillis-Steele rounds (taiga_tpu/ops/msm.py::_seg_rounds,
    the tile's edges as run edges where tile > 0) give it: the aligned
    binary tree ((P_i + P_i+1) + (P_i+2 + P_i+3)) + ... over
    [i, i + 2^rounds) cut at the run's end, by the reference's operations
    in its order, so with its limbs. Every other lane keeps its input."""
    shape = x.shape
    src = [v.reshape(16, -1) for v in (x, y, z)]
    pts = [v.clone() for v in src]
    for r, i in enumerate(seg_adds(keys, rounds, tile)):
        out = ec_add_proj_plain(*(v[:, i] for v in pts), *(v[:, i + (1 << r)] for v in pts),
                                field)
        for v, o in zip(pts, out):
            v[:, i] = o
    defined = (seg_offsets(keys, tile).reshape(-1) % (1 << rounds)) == 0
    return tuple(torch.where(defined, p, v).reshape(shape) for p, v in zip(pts, src))


def ec_add_plain(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """Plain version of K6."""
    return _ec_add_core(x1, y1, z1, x2, y2, z2, field)


def _tree_level(x, y, z, C: int, field: str, add):
    """One level of the halving tree over C columns of n points (16, C n):
    lane i of each column + lane i + n / 2 (`add`: K6 or its plain
    version). Returns 3 x (16, C n / 2)."""
    n = x.shape[1] // C
    h = n // 2
    cols = [v.reshape(NLIMBS, C, n) for v in (x, y, z)]
    return add(*(v[:, :, :h].reshape(NLIMBS, C * h).contiguous() for v in cols),
               *(v[:, :, h:].reshape(NLIMBS, C * h).contiguous() for v in cols), field)


def ec_add_tree_plain(x, y, z, C: int, field: str = "fq"):
    """Plain version of ec_add_tree: each column's halving tree (the
    reference's pairing, taiga_tpu/parallel/sharded.py:84-89), level by
    level over ec_add_plain."""
    pts = (x, y, z)
    while pts[0].shape[1] > C:
        pts = _tree_level(*pts, C, field, ec_add_plain)
    return pts


def ec_add_select_plain(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """Plain version of K7: sel ? P1 + P2 : P1 (Jacobian), lane-wise. With
    no lane selected that is P1, and no add is computed."""
    m = sel[0] != 0
    if not bool(m.any()):
        return x1.clone(), y1.clone(), z1.clone()
    x3, y3, z3 = ec_add_plain(x1, y1, z1, x2, y2, z2, field)
    return torch.where(m, x3, x1), torch.where(m, y3, y1), torch.where(m, z3, z1)


def ec_double_plain(x1, y1, z1, field: str = "fq"):
    """Plain version of the Jacobian doubling (ec_double_lm)."""
    return _ec_double_core(x1, y1, z1, field)


LADDER_BITS_MAX = 16 * NLIMBS  # the bits a scalar's limbs hold


def _ladder_lanes(scalars, n: int) -> tuple[int, int]:
    """(C, lane stride) of ec_ladder's scalars: (16,) one scalar shared by
    every lane (C = 1, stride 0), or (C, n, 16) one a lane (stride 16)."""
    if scalars.dim() == 1 and scalars.shape[0] == NLIMBS:
        return 1, 0
    if scalars.dim() == 3 and scalars.shape[1:] == (n, NLIMBS):
        return scalars.shape[0], NLIMBS
    raise ValueError(f"scalars: shape {tuple(scalars.shape)}, expected (16,) or (C, {n}, 16)")


def ec_ladder_plain(x, y, z, scalars, bits: int = 255, field: str = "fq"):
    """Plain version of ec_ladder: per lane, acc = (0, 0, 0); for bit i of
    the lane's scalar, LSB first, acc = bit ? acc + base : acc (K7's
    complete add), then, except after the last bit, base = 2 base (the
    doubling). Base (16, n); scalars as ec_ladder_lm takes them. Each step
    is ec_add_select_plain's add and ec_double_plain's doubling, their
    products stacked stage by stage (_jac_stages; the base doubled on each
    of the C x n lanes, as the kernel does); a step where no lane's bit is
    set only doubles. The loop ends at the highest bit set in any lane:
    after it acc does not change."""
    n = x.shape[1]
    C, _ = _ladder_lanes(scalars, n)
    limbs = scalars.reshape(-1, NLIMBS)
    ors = np.bitwise_or.reduce(limbs.cpu().numpy().astype(np.int64), axis=0)
    steps = (sum(int(v) << (16 * j) for j, v in enumerate(ors)) & ((1 << bits) - 1)).bit_length()
    base = tuple(v.repeat(1, C) for v in (x, y, z))
    acc = tuple(torch.zeros_like(v) for v in base)
    for i in range(steps):
        m = ((limbs[:, i // 16] >> (i % 16)) & 1) != 0
        last = i + 1 == steps
        if not bool(m.any()):
            if not last:
                base = _ec_double_core(*base, field)
            continue
        head, nxt = _jac_stages((*acc, *base), None if last else base, field)
        added = _ec_add_cases(*acc, *base, *head, field)
        acc = tuple(torch.where(m, s, a) for s, a in zip(added, acc))
        if not last:
            base = nxt
    return tuple(v.contiguous() for v in acc)


def ec_horner_plain(wx, wy, wz, doublings: int, field: str = "fq"):
    """Plain version of ec_horner: the loop of K2 adds it replaces. Terms
    (16, W, L), the most significant last: acc = term[W-1]; for
    w = W-2 .. 0, `doublings` times acc = acc + acc, then acc = acc + term[w]."""
    W = wx.shape[1]
    acc = tuple(v[:, W - 1].clone(memory_format=torch.contiguous_format) for v in (wx, wy, wz))
    for w in range(W - 2, -1, -1):
        for _ in range(doublings):
            acc = ec_add_proj_plain(*acc, *acc, field=field)
        acc = ec_add_proj_plain(*acc, *(v[:, w].contiguous() for v in (wx, wy, wz)), field=field)
    return acc


BUCKET_BITS_MAX = 8  # the widest window ec_bucket_weights takes (csrc/ec_add_proj.cu)


def ec_bucket_weights_plain(bx, by, bz, c: int, field: str = "fq"):
    """Plain version of ec_bucket_weights: the reference's weighting of an
    MSM window's buckets (taiga_tpu/ops/msm.py:140-173) over L columns of
    2^c bucket sums (16, L 2^c), column l's bucket j at lane l 2^c + j.
    Each bit t of j masks the buckets (B_j where the bit is set, else the
    identity (0 : 1 : 0)); each (bit, column) row reduces by the aligned
    binary tree, level by level (lane 2k + lane 2k + 1), which is lane 0
    of the reference's roll-add tree; then the Horner over the bits, the
    most significant first (ec_horner_plain, one doubling a bit). Returns
    3 x (16, L) sum_j j B_j."""
    n = 1 << c
    Lc = bx.shape[-1] // n
    dev = bx.device
    j = torch.arange(n, device=dev)
    keep = (((j[None, :] >> torch.arange(c, device=dev)[:, None]) & 1) > 0)[None, :, None, :]
    ident = (0, _spec(field).one_col(dev).view(NLIMBS, 1, 1, 1), 0)
    t = [torch.where(keep, v.reshape(NLIMBS, 1, Lc, n), e) for v, e in zip((bx, by, bz), ident)]
    while t[0].shape[-1] > 1:
        shape = t[0][..., 0::2].shape
        out = ec_add_proj_plain(*(v[..., 0::2].reshape(NLIMBS, -1) for v in t),
                                *(v[..., 1::2].reshape(NLIMBS, -1) for v in t), field)
        t = [o.reshape(shape) for o in out]
    return ec_horner_plain(*(v[..., 0].contiguous() for v in t), 1, field)


FOLD_STEPS = 255  # bits of the shared scalar that the fold reads


def ec_fold_shared_plain(gx_lo, gy_lo, gz_lo, gx_hi, gy_hi, gz_hi, scalar, field: str = "fq"):
    """Plain version of K5, the body of the reference's _ec_fold_shared_jit
    step for step: acc starts at the identity (0 : 1 : 0); for bit i of the
    shared scalar, LSB first, acc = bit ? acc + base : acc, then
    base = base + base; the result is G_lo + acc. Each step's add and
    doubling (both computed, as in the reference) run as one RCB call on
    2B stacked lanes."""
    B = gx_lo.shape[1]
    s = L.limbs_to_int(scalar.cpu().numpy())
    one = _spec(field).one_col(gx_lo.device).expand(NLIMBS, B).contiguous()
    acc = (torch.zeros_like(gx_lo), one, torch.zeros_like(gz_lo))
    base = (gx_hi, gy_hi, gz_hi)
    for i in range(FOLD_STEPS):
        lhs = [torch.cat([a, b], 1) for a, b in zip(acc, base)]
        rhs = [torch.cat([b, b], 1) for b in base]
        out = ec_add_proj_plain(*lhs, *rhs, field=field)
        if (s >> i) & 1:
            acc = tuple(o[:, :B].contiguous() for o in out)
        base = tuple(o[:, B:].contiguous() for o in out)
    return ec_add_proj_plain(gx_lo, gy_lo, gz_lo, *acc, field=field)


def mont_inv_plain(a, field: str = "fp"):
    """Plain version of K8: Fermat's chain (L.mont_inv) over (C, 16) rows."""
    return L.mont_inv(a, _spec(field))


def mont_cumprod_plain(a, field: str = "fp", reverse: bool = False):
    """Plain version of K9: inclusive products along the second-last axis of
    (..., n, 16) rows (suffix products when `reverse`), log2(n) doubling
    rounds of lm_mul."""
    if reverse:
        return torch.flip(mont_cumprod_plain(torch.flip(a, dims=[-2]), field), dims=[-2])
    spec = _spec(field)
    return L.from_lm(L.lm_scan(L.to_lm(a), lambda x, y: L.lm_mul(x, y, spec), dim=-1))


def powers_plain(x, n: int, field: str = "fp"):
    """Plain version of K9's powers entry: [1, x, ..., x^(n-1)] as (..., n,
    16) for Montgomery points x (..., 16), one scan of each x expanded along
    the row (mont_cumprod_plain) after a leading 1."""
    spec = _spec(field)
    lead = tuple(x.shape[:-1])
    xs = x.reshape(-1, 1, NLIMBS)
    one = L.const(spec.one_mont, x.device).expand(xs.shape[0], 1, NLIMBS)
    if n > 1:
        one = torch.cat([one, mont_cumprod_plain(xs.expand(xs.shape[0], n - 1, NLIMBS), field)],
                        dim=1)
    return one.reshape(lead + (n, NLIMBS))


def packed_words(a):
    """(..., 16) limbs as (..., 8) 32-bit words (int32 bit patterns): the
    packed layout the kernels read as two 16-byte vectors."""
    w = a[..., 0::2].to(torch.int64) | (a[..., 1::2].to(torch.int64) << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def perm_terms_plain(cols, sigma, omega_pows, beta, gamma, delta, chunk: int):
    """Plain version of K10's permutation entry, over Fp: the numerators
    prod_j (v_j + beta delta^j omega^i + gamma) and denominators
    prod_j (v_j + beta sigma_j[i] + gamma) of each chunk of `chunk`
    columns (the last may be shorter), for B proofs' permutation columns
    cols (B, P, n, 16), sigma (P, n, 16), omega_pows (n, 16), each proof's
    beta and gamma (B, 16) and delta^j (P, 16). Returns two (B, C, n, 16)."""
    be, ga = beta[:, None, :], gamma[:, None, :]
    nums, dens = [], []
    for j0 in range(0, cols.shape[1], chunk):
        num = den = None
        for j in range(j0, min(j0 + chunk, cols.shape[1])):
            v = cols[:, j]
            bd = L.mont_mul(be, delta[j], L.FP)
            t_num = L.add(L.add(v, L.mont_mul(bd, omega_pows, L.FP), L.FP), ga, L.FP)
            t_den = L.add(L.add(v, L.mont_mul(be, sigma[j], L.FP), L.FP), ga, L.FP)
            num = t_num if num is None else L.mont_mul(num, t_num, L.FP)
            den = t_den if den is None else L.mont_mul(den, t_den, L.FP)
        nums.append(num)
        dens.append(den)
    return torch.stack(nums, dim=1), torch.stack(dens, dim=1)


def lookup_terms_plain(a, s, ap, sp, beta, gamma):
    """Plain version of K10's lookup entry, over Fp: (A + beta)(S + gamma)
    and (A' + beta)(S' + gamma) for B proofs' (B, L, n, 16) columns and
    each proof's beta and gamma (B, 16)."""
    be, ga = beta[:, None, None, :], gamma[:, None, None, :]
    num = L.mont_mul(L.add(a, be, L.FP), L.add(s, ga, L.FP), L.FP)
    den = L.mont_mul(L.add(ap, be, L.FP), L.add(sp, ga, L.FP), L.FP)
    return num, den


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def mont_mul_lm(a, b, field: str = "fq"):
    """K1: (16, B) x (16, B) Montgomery product."""
    B = a.shape[-1]
    check_lm("a", a, NLIMBS, B)
    check_lm("b", b, NLIMBS, B)
    if not use_kernel(a, b):
        return mont_mul_plain(a, b, field)
    out = torch.empty_like(a)
    so = CK.lib("mont_mul")
    CK.check(so.taiga_mont_mul(_ptr(a), _ptr(b), _ptr(out), B, CK.FIELD_IDS[field],
                               CK.stream_ptr(a.device)), "mont_mul")
    mont_mul_lm.launches += 1
    return out


def mont_mul_rows(a, b, field: str = "fp"):
    """K1 over element-major operands: a * b * R^-1 of (..., 16) rows that
    broadcast against each other, through limb-major copies."""
    x, y = (L.to_lm(t) for t in torch.broadcast_tensors(a, b))
    return L.from_lm(mont_mul_lm(x.reshape(NLIMBS, -1), y.reshape(NLIMBS, -1),
                                 field).reshape(x.shape))


def check_rows(name: str, t: torch.Tensor, *shape: int):
    """dtype and shape of an element-major (..., 16) operand."""
    if t.dtype != L.DTYPE:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {L.DTYPE}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def mont_inv_lm(a, field: str = "fp"):
    """K8: the inverse of each of C Montgomery rows (C, 16), 0 mapping to 0:
    one thread a row runs Bernstein and Yang's constant-time divsteps (600
    of them in 30-bit limbs) and one product by R^3, one launch. The inverse
    is unique, so it equals the plain version's Fermat chain bit for bit."""
    check_rows("a", a, len(a), NLIMBS)
    if not use_kernel(a):
        return mont_inv_plain(a, field)
    a = a.contiguous()
    out = torch.empty_like(a)
    CK.check(CK.lib("grand_product").taiga_mont_inv(_ptr(a), _ptr(out), a.shape[0],
                                                    CK.FIELD_IDS[field],
                                                    CK.stream_ptr(a.device)), "mont_inv")
    mont_inv_lm.launches += 1
    return out


def _aligned_rows(t: torch.Tensor) -> bool:
    """Every element of t starts on a 16-byte boundary with its limbs
    adjacent: the kernels read an element as four 16-byte vectors."""
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


CUMPROD_THREADS = 128  # K9's threads a block (csrc/grand_product.cu kThreads)
CUMPROD_MAX_BLOCKS = 16  # K9 in one launch: blocks a row, a non-portable cluster (kMaxCluster)
CUMPROD_MAX_PER = 8  # K9 in one launch: elements a thread (kMaxPer)
CUMPROD_PER = 4  # K9 in one launch: elements a thread of a narrow call (a proof's rows)
CUMPROD_ONE_LAUNCH_N = CUMPROD_MAX_BLOCKS * CUMPROD_THREADS * CUMPROD_MAX_PER  # 16,384
POWERS_MAX_LOG = 11  # K9 powers: tables of at most 2^11 + 1 elements (kMaxPowLog)
POWERS_MAX_N = 1 << (2 * POWERS_MAX_LOG)  # the longest row of powers the card takes


def cumprod_launch(n: int, rows: int = 1, sms: int = 132) -> tuple[int, int] | None:
    """K9's one-launch shape for `rows` rows of n elements on a card of
    `sms` SMs: (blocks a row, the cluster's size; elements a thread), no
    block past a row's end. CUMPROD_PER a thread while those blocks number
    at most two an SM (the call is bound by its chain of products: 16
    blocks a row of 8,192), else CUMPROD_MAX_PER (bound by the products
    themselves: fewer warp-scan products an element, 8 blocks a row); more a
    thread where the cluster is full. None above CUMPROD_ONE_LAUNCH_N: the
    two passes over tiles of 1,024."""
    if n > CUMPROD_ONE_LAUNCH_N:
        return None
    per = CUMPROD_PER
    if rows * -(-n // (CUMPROD_THREADS * per)) > 2 * sms:
        per = CUMPROD_MAX_PER
    blocks = min(CUMPROD_MAX_BLOCKS, max(1, -(-n // (CUMPROD_THREADS * per))))
    per = -(-n // (CUMPROD_THREADS * blocks))
    return -(-n // (CUMPROD_THREADS * per)), per


def powers_table_log(n: int) -> int:
    """log2 T of K9's powers tables for rows of n: the least T = 2^t with
    T^2 >= n, so that x^i = x^(T (i >> t)) x^(i mod T) with x^j for j <= T
    and x^(T k) for k < ceil(n / T) in shared memory."""
    return ((n - 1).bit_length() + 1) // 2


def powers_per_thread(rows: int, n: int, sms: int) -> int:
    """Elements a thread of K9's powers writes: about two blocks an SM over
    the call (every block builds its own tables, so a wide call takes fewer,
    wider blocks), 1 to 8."""
    return min(8, max(1, -(-rows * n // (CUMPROD_THREADS * 2 * sms))))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mont_cumprod_lm(a, field: str = "fp", reverse: bool = False):
    """K9: inclusive products along the second-last axis of (..., n, 16)
    Montgomery rows (suffix products when `reverse`): one launch for rows of
    up to CUMPROD_ONE_LAUNCH_N (a cluster of blocks a row, sized by
    cumprod_launch), two for a longer row (tile products, then the scan).
    Any strides: an expanded or moved axis is read in place. Returns a
    contiguous tensor of a's shape."""
    if a.dim() < 2:
        raise ValueError(f"a: shape {tuple(a.shape)}, expected (..., n, 16)")
    check_rows("a", a, *a.shape[:-1], NLIMBS)
    if not use_kernel(a):
        return mont_cumprod_plain(a, field, reverse)
    n = a.shape[-2]
    v = a if a.dim() == 3 else a.reshape((math.prod(a.shape[:-2]), n, NLIMBS))
    if not _aligned_rows(v):
        v = v.contiguous()
    R = v.shape[0]
    out = torch.empty((R, n, NLIMBS), dtype=a.dtype, device=a.device)
    so = CK.lib("grand_product")
    launch = cumprod_launch(n, R, _sm_count(a.device))
    blocks, per = launch or (0, 0)
    tiles = 1 if launch else so.taiga_cumprod_tiles(n)
    totals = torch.empty((R * tiles * NLIMBS // 2,) if tiles > 1 else (0,), dtype=a.dtype,
                         device=a.device)
    CK.check(so.taiga_cumprod(_ptr(v), v.stride(1), v.stride(0), _ptr(out), NLIMBS, n * NLIMBS,
                              n, R, int(reverse), blocks, per,
                              _ptr(totals) if tiles > 1 else None, CK.FIELD_IDS[field],
                              CK.stream_ptr(a.device)), "mont_cumprod")
    mont_cumprod_lm.launches += 2 if tiles > 1 else 1
    return out.view(a.shape)


def powers_lm(x, n: int, field: str = "fp", packed: bool = False):
    """K9's powers entry: [1, x, ..., x^(n-1)] of Montgomery points x (...,
    16) -> (..., n, 16), or with `packed` (..., n, 8) 32-bit words (K12's
    table; packed_words of the same), in one launch with no scan along the
    row: every block builds x^j (j <= T) and x^(T k) in shared memory by
    doubling (powers_table_log), then writes x^i = x^(T (i >> t)) x^(i mod
    T), one product an element. On the card n <= POWERS_MAX_N."""
    if n < 1:
        raise ValueError(f"powers: n = {n}, expected >= 1")
    check_rows("x", x, *x.shape[:-1], NLIMBS)
    if not use_kernel(x):
        out = powers_plain(x, n, field)
        return packed_words(out) if packed else out
    if n > POWERS_MAX_N:
        raise ValueError(f"powers: n = {n}, the kernel takes {POWERS_MAX_N}")
    lead = tuple(x.shape[:-1])
    xv = x.reshape(-1, NLIMBS)
    if not _aligned_rows(xv):
        xv = xv.contiguous()
    R, words = xv.shape[0], NLIMBS // 2 if packed else NLIMBS
    out = torch.empty((R, n, words), dtype=x.dtype, device=x.device)
    if R == 0:
        return out.view(lead + (n, words))
    CK.check(CK.lib("grand_product").taiga_powers(
        _ptr(xv), xv.stride(0), _ptr(out), n, R, powers_table_log(n),
        powers_per_thread(R, n, _sm_count(x.device)), int(packed), CK.FIELD_IDS[field],
        CK.stream_ptr(x.device)), "powers")
    powers_lm.launches += 1
    return out.view(lead + (n, words))


def perm_terms_lm(cols, sigma, omega_pows, beta, gamma, delta, chunk: int):
    """K10, the permutation entry: perm_terms_plain's numerators and
    denominators of every chunk of B proofs in one launch, one thread an
    output element. Returns two contiguous (B, C, n, 16)."""
    B, P, n = cols.shape[:3]
    for nm, t, shape in (("cols", cols, (B, P, n)), ("sigma", sigma, (P, n)),
                         ("omega_pows", omega_pows, (n,)), ("beta", beta, (B,)),
                         ("gamma", gamma, (B,)), ("delta", delta, (P,))):
        check_rows(nm, t, *shape, NLIMBS)
    if chunk < 1:
        raise ValueError(f"perm_terms: chunk {chunk}")
    ins = (cols, sigma, omega_pows, beta, gamma, delta)
    if not use_kernel(*ins):
        return perm_terms_plain(*ins, chunk)
    ins = tuple(t.contiguous() for t in ins)
    C = -(-P // chunk)
    outs = tuple(torch.empty((B, C, n, NLIMBS), dtype=cols.dtype, device=cols.device)
                 for _ in range(2))
    CK.check(CK.lib("grand_product").taiga_perm_terms(
        *map(_ptr, ins + outs), B, P, n, chunk, CK.FIELD_IDS["fp"], CK.stream_ptr(cols.device)),
        "perm_terms")
    perm_terms_lm.launches += 1
    return outs


def lookup_terms_lm(a, s, ap, sp, beta, gamma):
    """K10, the lookup entry: lookup_terms_plain's numerators and
    denominators of B proofs' (B, L, n, 16) columns in one launch. Returns
    two contiguous (B, L, n, 16)."""
    B = a.shape[0]
    for nm, t in (("a", a), ("s", s), ("ap", ap), ("sp", sp)):
        check_rows(nm, t, *a.shape[:-1], NLIMBS)
    check_rows("beta", beta, B, NLIMBS)
    check_rows("gamma", gamma, B, NLIMBS)
    ins = (a, s, ap, sp, beta, gamma)
    if not use_kernel(*ins):
        return lookup_terms_plain(*ins)
    ins = tuple(t.contiguous() for t in ins)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(2))
    CK.check(CK.lib("grand_product").taiga_lookup_terms(
        *map(_ptr, ins + outs), B, a[0].numel() // NLIMBS, CK.FIELD_IDS["fp"],
        CK.stream_ptr(a.device)), "lookup_terms")
    lookup_terms_lm.launches += 1
    return outs


LINEAR_COMBO_MAX_GROUPS = 32  # the groups of a K13 launch (csrc/poly.cu kMaxComboGroups)
COMBO_WARPS = 8  # K13: warps a block at most (csrc/poly.cu kComboWarps)
COMBO_TILE = 32  # K13: positions a block (kComboTile)
COMBO_RUN = 8  # K13: products a lane sums before one reduction (kComboRun)
NTT_K_MAX = 18  # the largest domain K11 takes, 2^18: two passes of 2^9 (csrc/ntt.cu)
NTT_ONE_PASS_K = 10  # K11 runs k <= 10 in one launch, a larger k in two (csrc/ntt.cu kMaxLog)
NTT_MIN_THREADS = 132 * 1024  # K11 takes radix 4 only where that keeps this many threads


def ntt_radix_log(rows: int, k: int, nonzero: int) -> int:
    """log2 of K11's radix for a call over `rows` rows of 2^k that hold
    their first `nonzero` elements: 4 elements a thread (two stages a group
    in registers) when the rows are zero-padded to at least 8 times their
    length (the first group skips the butterflies of two zeros) and the
    call keeps NTT_MIN_THREADS threads busy, else 2. On dense rows radix 2
    measured faster at every shape of the prover, narrow or wide (PERF.md
    section 6)."""
    n = 1 << k
    sparse = k >= 3 and 8 * nonzero <= n
    return 2 if sparse and (rows * n) >> 2 >= NTT_MIN_THREADS else 1


def ntt_lm(x, k: int, field: str = "fp", inverse: bool = False, coset: int | None = None,
           nonzero: int | None = None):
    """K11: the NTT of (..., n, 16) Montgomery rows along the second-last
    axis, n = 2^k, natural order in and out; the inverse (w^-1 and n^-1)
    when `inverse`; over the coset g H with g = `coset` (the forward scales
    its input by g^i, the inverse its output by g^-i). With `nonzero`, x
    holds only each row's first `nonzero` elements, (..., nonzero, 16), and
    the rest of the 2^k read as zero (to_ext's padding, never built). Two
    launches (a four-step split, each pass's stages in groups of two or one
    in registers, ntt_radix_log's radix; the scales fused into the first
    pass's loads and the last pass's stores), one for k <= 10, each
    counted. Any strides: a moved axis is read in place. Returns a
    contiguous (..., n, 16) tensor. On the card 1 <= k <= NTT_K_MAX."""
    from . import ntt as NT  # ops/ntt.py holds the plain version and the tables

    if x.dim() < 2:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (..., n, 16)")
    n = 1 << k
    given = n if nonzero is None else nonzero  # elements a row holds
    if not 1 <= given <= n:
        raise ValueError(f"ntt: nonzero = {nonzero} of n = {n}")
    check_rows("x", x, *x.shape[:-2], given, NLIMBS)
    if not use_kernel(x):
        return NT.ntt_plain(x, k, field, inverse, coset, nonzero)
    if not 1 <= k <= NTT_K_MAX:
        raise ValueError(f"ntt: k = {k}, the kernel takes 1 .. {NTT_K_MAX}")
    lead = x.shape[:-2]
    v = x if x.dim() == 3 else x.reshape((math.prod(lead), given, NLIMBS))
    if not _aligned_rows(v):
        v = v.contiguous()
    R = v.shape[0]
    out = torch.empty((R, n, NLIMBS), dtype=x.dtype, device=x.device)
    if R == 0:
        return out.view(lead + (n, NLIMBS))
    so = CK.lib("ntt")
    launches = 1 if k <= NTT_ONE_PASS_K else 2
    scratch = torch.empty((R, n, NLIMBS // 2) if launches > 1 else (0,), dtype=x.dtype,
                          device=x.device)
    tw, pre, post = NT.kernel_tables(k, field, inverse, coset, str(x.device))
    CK.check(so.taiga_ntt(_ptr(v), v.stride(0), v.stride(1), given, _ptr(out),
                          _ptr(scratch) if launches > 1 else None, _ptr(tw),
                          None if pre is None else _ptr(pre),
                          None if post is None else _ptr(post),
                          int(post is not None and post.shape[0] > 1), R, k,
                          ntt_radix_log(R, k, given),
                          CK.FIELD_IDS[field], CK.stream_ptr(x.device)), "ntt")
    ntt_lm.launches += launches
    return out.view(lead + (n, NLIMBS))


def _lead_rows(t: torch.Tensor, lead: tuple, tail: tuple) -> torch.Tensor:
    """t broadcast to lead + tail and viewed as (prod(lead),) + tail rows
    the kernels read through their strides (expanded axes in place), or a
    contiguous copy where the elements are not 16-byte aligned."""
    v = t.expand(lead + tail).reshape((math.prod(lead),) + tail)
    return v if _aligned_rows(v) else v.contiguous()


def _check_poly_rows(name: str, t: torch.Tensor, ndim: int):
    if t.dim() < ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim} or more axes")
    check_rows(name, t, *t.shape[:-1], NLIMBS)


EVAL_TILE = 256  # positions of a K12 block: 32 lanes x 8 (csrc/poly.cu kEvalTile)


def eval_polys_lm(coeffs, points, field: str = "fp"):
    """K12: C polynomials at Q points, coeffs (..., C, n, 16) and points
    (..., Q, 16) Montgomery -> (..., Q, C, 16), the leading axes broadcast
    (a batch of proofs pairs each stack with its points). The powers table
    x^i (..., Q, n) comes packed from K9's powers entry (powers_lm); then one
    launch of one-warp blocks, each summing its lanes' unreduced products
    over a tile of EVAL_TILE positions and reducing once a point, or two
    when a row spans several tiles (the tiles' partial sums, then their
    sum). Any strides: an expanded axis is read in place."""
    from . import poly as PL  # ops/poly.py holds the plain version

    _check_poly_rows("coeffs", coeffs, 3)
    _check_poly_rows("points", points, 2)
    if coeffs.shape[-2] < 1:
        raise ValueError(f"coeffs: shape {tuple(coeffs.shape)}, no coefficient")
    if not use_kernel(coeffs, points):
        return PL.eval_polys_plain(coeffs, points, field)
    C, n = coeffs.shape[-3:-1]
    Q = points.shape[-2]
    lead = tuple(torch.broadcast_shapes(coeffs.shape[:-3], points.shape[:-2]))
    out = torch.empty(lead + (Q, C, NLIMBS), dtype=coeffs.dtype, device=coeffs.device)
    if out.numel() == 0:
        return out
    cv = _lead_rows(coeffs, lead, (C, n, NLIMBS))
    pv = _lead_rows(powers_lm(points, n, field, packed=True), lead, (Q, n, NLIMBS // 2))
    B = cv.shape[0]
    tiles = -(-n // EVAL_TILE)
    part = torch.empty((B * C * tiles * Q * NLIMBS // 2,) if tiles > 1 else (0,),
                       dtype=coeffs.dtype, device=coeffs.device)
    CK.check(CK.lib("poly").taiga_eval_polys(
        _ptr(cv), *cv.stride()[:3], _ptr(pv), *pv.stride()[:3], _ptr(part) if tiles > 1 else None,
        _ptr(out), B, C, Q, n, CK.FIELD_IDS[field], CK.stream_ptr(coeffs.device)), "eval_polys")
    eval_polys_lm.launches += 2 if tiles > 1 else 1
    return out


def linear_combo_warps(blocks: int, widest: int, sms: int = 132) -> int:
    """K13's warps a block for a call of `blocks` blocks whose widest group
    has `widest` terms: the terms spread over up to COMBO_WARPS warps while
    the blocks number at most two an SM (the call is bound by a lane's
    chain: a proof's widest group, 256 blocks of 8 warps), else a warp a
    run of COMBO_RUN terms (fewer, fuller warps: a batch's sum of 6 groups,
    one warp a block, measured twice as fast as six)."""
    if blocks <= 2 * sms:
        return min(COMBO_WARPS, widest)
    return min(COMBO_WARPS, -(-widest // COMBO_RUN))


def linear_combo_lm(stack, weights, field: str = "fp", cols=None, sizes=None, addend=None):
    """K13: weighted sums of a stack's columns, stack (..., C, n, 16) and
    weights Montgomery, the leading axes broadcast. Without `sizes`: sum_c
    weights[c] * stack[c], weights (..., C, 16) -> (..., n, 16). With
    `sizes` (G group sizes of S terms in all) and `cols` (S column indices
    of the stack, or None for columns 0 .. S - 1): out[g] = addend[g] +
    sum over group g's terms s of weights[s] * stack[cols[s]], weights (...,
    S, 16), addend (..., G, n, 16) or None -> (..., G, n, 16): the
    multiopen's point groups gathered in the kernel, and its f = h + sum_j
    w^(j+1) agg_j as one group with h for its addend. One launch: a block a
    tile of COMBO_TILE positions of one proof running every group, its
    warps sharing a group's terms (linear_combo_warps), lazily reduced
    sums. On the card at most LINEAR_COMBO_MAX_GROUPS groups. Any
    strides."""
    from . import poly as PL

    _check_poly_rows("stack", stack, 3)
    _check_poly_rows("weights", weights, 2)
    C, n = stack.shape[-3:-1]
    if sizes is None:
        if cols is not None or addend is not None:
            raise ValueError("linear_combo: cols and addend need sizes")
        S, G = C, 1
    else:
        sizes = tuple(int(z) for z in sizes)
        S, G = sum(sizes), len(sizes)
        if not sizes or min(sizes) < 1:
            raise ValueError(f"linear_combo: group sizes {sizes}")
        if cols is not None:
            cols = [int(c) for c in cols]
            if len(cols) != S or min(cols) < 0 or max(cols) >= C:
                raise ValueError(f"linear_combo: {len(cols)} columns, expected {S} in 0 .. {C - 1}")
        elif S > C:
            raise ValueError(f"linear_combo: {S} terms of a stack of {C} columns")
    if weights.shape[-2] != S or C < 1:
        raise ValueError(f"weights: shape {tuple(weights.shape)}, expected (..., {S}, 16), "
                         f"C >= 1")
    if addend is not None:
        _check_poly_rows("addend", addend, 3)
        if tuple(addend.shape[-3:-1]) != (G, n):
            raise ValueError(f"addend: shape {tuple(addend.shape)}, expected (..., {G}, {n}, 16)")
    ins = (stack, weights) + (() if addend is None else (addend,))
    if not use_kernel(*ins):
        if sizes is None:
            return PL.linear_combo_plain(stack, weights, field)
        return PL.linear_combo_groups_plain(stack, cols, sizes, weights, addend, field)
    if G > LINEAR_COMBO_MAX_GROUPS:
        raise ValueError(f"linear_combo: {G} groups, the kernel takes {LINEAR_COMBO_MAX_GROUPS}")
    lead = tuple(torch.broadcast_shapes(stack.shape[:-3], weights.shape[:-2],
                                        *(() if addend is None else (addend.shape[:-3],))))
    out = torch.empty(lead + (G, n, NLIMBS), dtype=stack.dtype, device=stack.device)
    if out.numel() == 0:
        return out if sizes else out[..., 0, :, :]
    sv = _lead_rows(stack, lead, (C, n, NLIMBS))
    wv = _lead_rows(weights, lead, (S, NLIMBS))
    av = None if addend is None else _lead_rows(addend, lead, (G, n, NLIMBS))
    col = None if cols is None else torch.as_tensor(cols, dtype=torch.int64, device=stack.device)
    off = (ctypes.c_int32 * (G + 1))(*np.cumsum((0,) + (sizes or (C,))).tolist())
    B = sv.shape[0]
    warps = linear_combo_warps(B * -(-n // COMBO_TILE), max(sizes or (C,)),
                               _sm_count(stack.device))
    CK.check(CK.lib("poly").taiga_linear_combo(
        _ptr(sv), *sv.stride()[:3], None if col is None else _ptr(col),
        ctypes.cast(off, ctypes.c_void_p), G, _ptr(wv), *wv.stride()[:2],
        None if av is None else _ptr(av), *(av.stride()[:3] if av is not None else (0, 0, 0)),
        _ptr(out), B, n, warps, CK.FIELD_IDS[field], CK.stream_ptr(stack.device)),
        "linear_combo")
    linear_combo_lm.launches += 1
    return out if sizes else out[..., 0, :, :]


def synthetic_div_lm(coeffs, point, point_inv, field: str = "fp"):
    """K14: q_i = point_inv^(i+1) * sum_{j>i} a_j point^j of coeffs (..., n,
    16), with point and point_inv (16,) shared or (..., 16) one a
    polynomial (broadcast against the leading axes). It scales by the given
    point_inv's powers, so it equals synthetic_div_plain for any point_inv.
    The powers tables come from K9's powers entry; then one launch, or two
    when a row is longer than a block's tile (the tiles' sums, then the
    scan). Any strides: a shared point's table is read through a row
    stride of 0."""
    from . import poly as PL

    _check_poly_rows("coeffs", coeffs, 2)
    _check_poly_rows("point", point, 1)
    _check_poly_rows("point_inv", point_inv, 1)
    if not use_kernel(coeffs, point, point_inv):
        return PL.synthetic_div_plain(coeffs, point, point_inv, field)
    n = coeffs.shape[-2]
    lead = tuple(torch.broadcast_shapes(coeffs.shape[:-2], point.shape[:-1],
                                        point_inv.shape[:-1]))
    out = torch.empty(lead + (n, NLIMBS), dtype=coeffs.dtype, device=coeffs.device)
    if out.numel() == 0:
        return out
    av = _lead_rows(coeffs, lead, (n, NLIMBS))
    pv = _lead_rows(powers_lm(point, n + 1, field), lead, (n + 1, NLIMBS))
    iv = _lead_rows(powers_lm(point_inv, n + 1, field), lead, (n + 1, NLIMBS))
    R = av.shape[0]
    so = CK.lib("poly")
    tiles = so.taiga_poly_tiles(n)
    totals = torch.empty((R * tiles * NLIMBS // 2,) if tiles > 1 else (0,), dtype=coeffs.dtype,
                         device=coeffs.device)
    CK.check(so.taiga_synthetic_div(_ptr(av), *av.stride()[:2], _ptr(pv), *pv.stride()[:2],
                                    _ptr(iv), *iv.stride()[:2], _ptr(out),
                                    _ptr(totals) if tiles > 1 else None, n, R,
                                    CK.FIELD_IDS[field], CK.stream_ptr(coeffs.device)),
             "synthetic_div")
    synthetic_div_lm.launches += 2 if tiles > 1 else 1
    return out


def _aligned_copy(t: torch.Tensor) -> torch.Tensor:
    """t itself when contiguous with its first element 16-byte aligned, else
    a contiguous copy: the kernels read an element as four 16-byte vectors."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


PERMUTE_PAIRS_LAUNCHES = 5  # K15's launches a call (csrc/lookup_sort.cu)


def permute_pairs_lm(a_v, s_v, u: int):
    """K15: the lookups' permuted pairs over the first u rows of R lookups'
    (R, n, 16) canonical Montgomery columns A and S -> A' and S' (R, u, 16)
    Montgomery and each lookup's ok flag (R,) bool, by value the JAX
    package's permute_pairs_device (ops/lookup_sort.py's module note).
    PERMUTE_PAIRS_LAUNCHES launches for all R lookups, each spread over a
    block a (row, tile of 1,024): the tiles sorted (from_mont fused), each
    key's rank by co-rank searches into the other tiles, the tiles' counts,
    the leftovers placed, and A' and S' copied from the inputs. The first u
    rows are read through the strides, in place."""
    from . import lookup_sort as LS  # ops/lookup_sort.py holds the plain version

    for nm, t in (("a_v", a_v), ("s_v", s_v)):
        if t.dim() != 3:
            raise ValueError(f"{nm}: shape {tuple(t.shape)}, expected (R, n, 16)")
        check_rows(nm, t, *a_v.shape[:2], NLIMBS)
    R, n = a_v.shape[:2]
    if not 1 <= u <= n:
        raise ValueError(f"permute_pairs: u = {u} of n = {n} rows")
    if not use_kernel(a_v, s_v):
        return LS.permute_pairs_plain(a_v, s_v, u)
    if 2 * R > 65535:
        raise ValueError(f"permute_pairs: {R} lookups, the kernel takes 32,767")
    av, sv = (t if _aligned_rows(t) else t.contiguous() for t in (a_v, s_v))
    ap = torch.empty((R, u, NLIMBS), dtype=a_v.dtype, device=a_v.device)
    sp = torch.empty_like(ap)
    ok = torch.empty((R,), dtype=torch.bool, device=a_v.device)
    if R == 0:
        return ap, sp, ok
    so = CK.lib("lookup_sort")
    scratch = torch.empty((so.taiga_permute_pairs_scratch(R, u),), dtype=a_v.dtype,
                          device=a_v.device)
    CK.check(so.taiga_permute_pairs(
        _ptr(av), av.stride(0), av.stride(1), _ptr(sv), sv.stride(0), sv.stride(1), _ptr(ap),
        _ptr(sp), _ptr(ok), _ptr(scratch), R, u, CK.FIELD_IDS["fp"], CK.stream_ptr(a_v.device)),
        "permute_pairs")
    permute_pairs_lm.launches += PERMUTE_PAIRS_LAUNCHES
    return ap, sp, ok


def from_mont_lm(a, field: str = "fp"):
    """K16: any (..., 16) canonical limbs out of Montgomery form (a R^-1),
    one launch, one thread an element. Returns a contiguous tensor."""
    if a.dim() < 1:
        raise ValueError(f"a: shape {tuple(a.shape)}, expected (..., 16)")
    check_rows("a", a, *a.shape[:-1], NLIMBS)
    spec = _spec(field)
    if not use_kernel(a):
        return L.from_mont(a, spec)
    a = _aligned_copy(a)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    CK.check(CK.lib("convert").taiga_from_mont(_ptr(a), _ptr(out), a.numel() // NLIMBS,
                                               CK.FIELD_IDS[field], CK.stream_ptr(a.device)),
             "from_mont")
    from_mont_lm.launches += 1
    return out


def msm_digits_lm(scalars, c: int, packed: bool = False):
    """K17: the c-bit window digits (16 % c == 0, W = 256 / c windows) of C
    columns of N plain scalars (C, N, 16), one launch, one thread a scalar:
    keyed (W, C, N) int64 col 2^c + digit, or, `packed`, the fixed-base
    path's (C W N,) int64 sort key ((col 2^c + digit) << idx_bits) | lane,
    lane = col W N + w N + i (ops/msm.py::msm_digits_plain)."""
    from . import msm as MS  # ops/msm.py holds the plain version

    if scalars.dim() != 3:
        raise ValueError(f"scalars: shape {tuple(scalars.shape)}, expected (C, N, 16)")
    check_rows("scalars", scalars, *scalars.shape[:2], NLIMBS)
    if c < 1 or 16 % c:
        raise ValueError(f"msm_digits: window c = {c} does not divide 16")
    C, N = scalars.shape[:2]
    W = 256 // c
    idx_bits = MS.packed_idx_bits(C * W * N)
    if packed and max(1, (C << c) - 1).bit_length() + idx_bits > 63:
        raise ValueError(f"msm_digits: ({C}, {N}) scalars at c = {c} overflow an int64 key")
    if not use_kernel(scalars):
        return MS.msm_digits_plain(scalars, c, packed)
    if C > 65535:
        raise ValueError(f"msm_digits: {C} columns, the kernel takes 65,535")
    s = _aligned_copy(scalars)
    out = torch.empty((C * W * N,) if packed else (W, C, N), dtype=torch.int64,
                      device=scalars.device)
    if out.numel() == 0:
        return out
    CK.check(CK.lib("convert").taiga_msm_digits(_ptr(s), _ptr(out), C, N, c, int(packed),
                                                idx_bits, CK.stream_ptr(s.device)), "msm_digits")
    msm_digits_lm.launches += 1
    return out


def ec_add_proj_lm(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """K2: projective (RCB complete) addition over (16, B) limb-major points."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    if not use_kernel(*pts):
        return ec_add_proj_plain(*pts, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_add_proj(*map(_ptr, pts + outs), B, CK.FIELD_IDS[field],
                                  CK.stream_ptr(x1.device)), "ec_add_proj")
    ec_add_proj_lm.launches += 1
    return outs


def ec_add_proj_sel_lm(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """K3: projective add with lane select, sel ? P1 + P2 : P1. Points
    (16, B); sel (1, B) int32 (nonzero selects). Identity is (0 : 1 : 0)."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    check_lm("sel", sel, 1, B)
    if not use_kernel(*pts, sel):
        return ec_add_proj_sel_plain(*pts, sel, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_add_proj_sel(*map(_ptr, pts + (sel,) + outs), B,
                                      CK.FIELD_IDS[field], CK.stream_ptr(x1.device)),
             "ec_add_proj_sel")
    ec_add_proj_sel_lm.launches += 1
    return outs


SEG_TILE_MAX = 128  # the widest tile of ec_seg_rounds: one block of the kernel
SEG_ROUNDS_MAX = 62  # rounds whose 2^(r + 1) an int64 offset holds


def ec_seg_rounds_lm(x, y, z, keys, rounds: int, field: str = "fq", tile: int = 0):
    """K3 chained: `rounds` rounds of the segmented reduction of
    ec_seg_rounds_plain over points (16, ..., n) int32 and keys (..., n)
    int64, sorted along each row, in one launch: tile == 0, rows of any
    length (a cooperative launch, a grid-wide barrier between rounds, the
    rounds ending at the first with no add); tile > 0 (a power of two, at
    most SEG_TILE_MAX, with 2^rounds <= tile and n a multiple of it), each
    block's tiles in shared memory. Returns 3 x (16, ..., n).

    The contract (as ec_seg_rounds_plain's): a lane is *defined* when its
    offset from its run's first lane (a tile's first lane starts a run) is
    a multiple of 2^rounds. A defined lane holds what the reference's
    Hillis-Steele rounds (taiga_tpu/ops/msm.py::_seg_rounds) give it, limb
    for limb; every other lane keeps its input point. Callers read defined
    lanes only (ops/msm.py)."""
    shape, n = x.shape, x.shape[-1]
    for nm, t in zip(("x", "y", "z"), (x, y, z)):
        check_lm(nm, t, *shape)
    if shape[0] != NLIMBS:
        raise ValueError(f"x: shape {tuple(shape)}, expected (16, ..., n)")
    if keys.dtype != torch.int64 or keys.shape != shape[1:] or not keys.is_contiguous():
        raise ValueError(f"keys: {keys.dtype} {tuple(keys.shape)}, expected contiguous int64 "
                         f"{tuple(shape[1:])}")
    if not 0 <= rounds <= SEG_ROUNDS_MAX:
        raise ValueError(f"ec_seg_rounds: rounds = {rounds}, expected 0 .. {SEG_ROUNDS_MAX}")
    if tile and (tile < 0 or tile & (tile - 1) or tile > SEG_TILE_MAX or (1 << rounds) > tile
                 or n % tile):
        raise ValueError(f"ec_seg_rounds: tile {tile} must be a power of two <= {SEG_TILE_MAX} "
                         f"dividing n = {n}, with 2^rounds = {1 << rounds} <= tile")
    if not use_kernel(x, y, z, keys):
        return ec_seg_rounds_plain(x, y, z, keys, rounds, field, tile)
    B = x.numel() // NLIMBS
    so, fid, stream = CK.lib("ec_add_proj"), CK.FIELD_IDS[field], CK.stream_ptr(x.device)
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if tile:
        CK.check(so.taiga_ec_seg_tile(*map(_ptr, (x, y, z, keys)), tile, rounds,
                                      *map(_ptr, outs), B, fid, stream), "ec_seg_tile")
    else:
        off = torch.empty(B, dtype=torch.int32, device=x.device)
        counts = torch.empty(max(rounds, 1), dtype=torch.int32, device=x.device)
        CK.check(so.taiga_ec_seg_rows(*map(_ptr, (x, y, z, keys)), n, rounds,
                                      *map(_ptr, outs + (off, counts)), B, fid, stream),
                 "ec_seg_rows")
    ec_seg_rounds_lm.launches += 1
    return outs


def ec_horner_lm(wx, wy, wz, doublings: int, field: str = "fq"):
    """K2 chained into one launch: the Horner evaluation of ec_horner_plain
    over terms (16, W, L) limb-major projective (the most significant term
    last), every add K2's RCB add in the plain version's order, one chain
    per column. Returns 3 x (16, L)."""
    if wx.dim() != 3:
        raise ValueError(f"wx: shape {tuple(wx.shape)}, expected (16, W, L)")
    W, Lc = wx.shape[1], wx.shape[2]
    for nm, t in zip(("wx", "wy", "wz"), (wx, wy, wz)):
        check_lm(nm, t, NLIMBS, W, Lc)
    if W < 1 or doublings < 0:
        raise ValueError(f"ec_horner: W = {W}, doublings = {doublings}")
    if not use_kernel(wx, wy, wz):
        return ec_horner_plain(wx, wy, wz, doublings, field)
    outs = tuple(torch.empty((NLIMBS, Lc), dtype=wx.dtype, device=wx.device) for _ in range(3))
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_horner(*map(_ptr, (wx, wy, wz) + outs), W, Lc, doublings,
                                CK.FIELD_IDS[field], CK.stream_ptr(wx.device)), "ec_horner")
    ec_horner_lm.launches += 1
    return outs


def ec_bucket_weights_lm(bx, by, bz, c: int, field: str = "fq"):
    """K2 chained: an MSM window's bucket weighting sum_j j B_j for each of
    L columns of 2^c bucket sums (16, L 2^c) limb-major projective (column
    l's bucket j at lane l 2^c + j; 1 <= c <= BUCKET_BITS_MAX), as
    ec_bucket_weights_plain computes it, every add K2's RCB add in its
    order: each (bit, column) row's aligned tree, then the Horner over the
    bits, in one launch (a cluster of c blocks a column). Returns
    3 x (16, L)."""
    if not 1 <= c <= BUCKET_BITS_MAX:
        raise ValueError(f"ec_bucket_weights: c = {c}, expected 1 .. {BUCKET_BITS_MAX}")
    M = bx.shape[-1]
    for nm, t in zip(("bx", "by", "bz"), (bx, by, bz)):
        check_lm(nm, t, NLIMBS, M)
    Lc = M >> c
    if Lc < 1 or Lc << c != M:
        raise ValueError(f"ec_bucket_weights: {M} lanes are not columns of 2^{c} buckets")
    if not use_kernel(bx, by, bz):
        return ec_bucket_weights_plain(bx, by, bz, c, field)
    outs = tuple(torch.empty((NLIMBS, Lc), dtype=bx.dtype, device=bx.device) for _ in range(3))
    one = _spec(field).one_col(bx.device)
    so = CK.lib("ec_add_proj")
    CK.check(so.taiga_ec_bucket_weights(*map(_ptr, (bx, by, bz, one)), c, Lc, *map(_ptr, outs),
                                        CK.FIELD_IDS[field], CK.stream_ptr(bx.device)),
             "ec_bucket_weights")
    ec_bucket_weights_lm.launches += 1
    return outs


def ec_add_lm(x1, y1, z1, x2, y2, z2, field: str = "fq"):
    """K6: complete Jacobian addition over (16, B) limb-major points
    (identity Z = 0)."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    if not use_kernel(*pts):
        return ec_add_plain(*pts, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_jac")
    CK.check(so.taiga_ec_add_jac(*map(_ptr, pts + outs), B, CK.FIELD_IDS[field],
                                 CK.stream_ptr(x1.device)), "ec_add")
    ec_add_lm.launches += 1
    return outs


TREE_MAX_N = 4096  # a column's points the tree kernel takes (kTreeMaxN, csrc/ec_add_jac.cu)


def ec_add_tree_lm(x, y, z, C: int, field: str = "fq"):
    """K6 chained: the sum of each of C columns of n Jacobian points
    (16, C n) limb-major (column c: lanes c n .. c n + n - 1; n a power of
    two) by the reference's halving tree -- at each level point i + point
    i + n / 2, the complete add -- in one launch (one block a column,
    its points in shared memory). A column of more than TREE_MAX_N points
    first runs K6 launches, a level each, down to TREE_MAX_N. Returns
    3 x (16, C)."""
    total = x.shape[-1]
    for nm, t in zip(("x", "y", "z"), (x, y, z)):
        check_lm(nm, t, NLIMBS, total)
    n = total // max(C, 1)
    if C < 1 or n < 1 or n * C != total or n & (n - 1):
        raise ValueError(f"ec_add_tree: {total} lanes are not C = {C} columns of a power of two")
    if not use_kernel(x, y, z):
        return ec_add_tree_plain(x, y, z, C, field)
    pts = (x, y, z)
    while pts[0].shape[1] // C > TREE_MAX_N:
        pts = _tree_level(*pts, C, field, ec_add_lm)
    outs = tuple(torch.empty((NLIMBS, C), dtype=x.dtype, device=x.device) for _ in range(3))
    so = CK.lib("ec_add_jac")
    CK.check(so.taiga_ec_add_tree(*map(_ptr, pts + outs), pts[0].shape[1] // C, C,
                                  CK.FIELD_IDS[field], CK.stream_ptr(x.device)),
             "ec_add_tree")
    ec_add_tree_lm.launches += 1
    return outs


def ec_add_select_lm(x1, y1, z1, x2, y2, z2, sel, field: str = "fq"):
    """K7: Jacobian add with lane select, sel ? P1 + P2 : P1. Points
    (16, B); sel (1, B) int32 (nonzero selects)."""
    B = x1.shape[-1]
    pts = (x1, y1, z1, x2, y2, z2)
    for nm, t in zip(("x1", "y1", "z1", "x2", "y2", "z2"), pts):
        check_lm(nm, t, NLIMBS, B)
    check_lm("sel", sel, 1, B)
    if not use_kernel(*pts, sel):
        return ec_add_select_plain(*pts, sel, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_jac")
    CK.check(so.taiga_ec_add_jac_sel(*map(_ptr, pts + (sel,) + outs), B,
                                     CK.FIELD_IDS[field], CK.stream_ptr(x1.device)),
             "ec_add_select")
    ec_add_select_lm.launches += 1
    return outs


def ec_ladder_lm(x, y, z, scalars, bits: int = 255, field: str = "fq"):
    """K7 chained into one launch: the double-and-add ladder of
    ec_ladder_plain over base (16, n) Jacobian limb-major points (identity
    Z = 0) and plain 16-bit scalar limbs (int32): (16,) one scalar shared by
    every lane, or (C, n, 16) one scalar a lane per column. Returns acc as
    3 x (16, C * n), lane c * n + i = [s_ci] P_i (C = 1 for a shared
    scalar); a lane whose bits are all 0 is (0, 0, 0)."""
    n = x.shape[-1]
    for nm, t in zip(("x", "y", "z"), (x, y, z)):
        check_lm(nm, t, NLIMBS, n)
    C, stride = _ladder_lanes(scalars, n)
    check_lm("scalars", scalars, *scalars.shape)
    if not 0 <= bits <= LADDER_BITS_MAX:
        raise ValueError(f"ec_ladder: bits = {bits}, expected 0 .. {LADDER_BITS_MAX}")
    if not use_kernel(x, y, z, scalars):
        return ec_ladder_plain(x, y, z, scalars, bits, field)
    outs = tuple(torch.empty((NLIMBS, C * n), dtype=x.dtype, device=x.device) for _ in range(3))
    so = CK.lib("ec_add_jac")
    CK.check(so.taiga_ec_ladder(*map(_ptr, (x, y, z, scalars)), stride, bits,
                                *map(_ptr, outs), n, C * n, CK.FIELD_IDS[field],
                                CK.stream_ptr(x.device)), "ec_ladder")
    ec_ladder_lm.launches += 1
    return outs


def ec_double_lm(x1, y1, z1, field: str = "fq"):
    """Jacobian doubling (dbl-2009-l, a = 0) over (16, B) limb-major points:
    the XLA program taiga_tpu/ops/ec.py::ec_double as one kernel. Unlike
    K6(P, P), an identity lane keeps the formula's X3, Y3 with Z3 = 0."""
    B = x1.shape[-1]
    pts = (x1, y1, z1)
    for nm, t in zip(("x1", "y1", "z1"), pts):
        check_lm(nm, t, NLIMBS, B)
    if not use_kernel(*pts):
        return ec_double_plain(*pts, field=field)
    outs = tuple(torch.empty_like(x1) for _ in range(3))
    so = CK.lib("ec_add_jac")
    CK.check(so.taiga_ec_double_jac(*map(_ptr, pts + outs), B, CK.FIELD_IDS[field],
                                    CK.stream_ptr(x1.device)), "ec_double")
    ec_double_lm.launches += 1
    return outs


def ec_fold_shared_lm(gx_lo, gy_lo, gz_lo, gx_hi, gy_hi, gz_hi, scalar_limbs,
                      field: str = "fq"):
    """K5: the IPA generator fold G' = G_lo + [s] G_hi with one shared
    255-bit scalar s, over (16, B) limb-major projective points (identity
    (0 : 1 : 0)); scalar_limbs is (1, 16) int32, plain 16-bit limbs. At
    every width: the reference's host branch for B <= 512 returns another
    projective representative and is not taken."""
    B = gx_lo.shape[-1]
    pts = (gx_lo, gy_lo, gz_lo, gx_hi, gy_hi, gz_hi)
    for nm, t in zip(("gx_lo", "gy_lo", "gz_lo", "gx_hi", "gy_hi", "gz_hi"), pts):
        check_lm(nm, t, NLIMBS, B)
    check_lm("scalar_limbs", scalar_limbs, 1, NLIMBS)
    if not use_kernel(*pts, scalar_limbs):
        return ec_fold_shared_plain(*pts, scalar_limbs, field=field)
    outs = tuple(torch.empty_like(gx_lo) for _ in range(3))
    one = _spec(field).one_col(gx_lo.device)
    so = CK.lib("ec_fold_shared")
    CK.check(so.taiga_ec_fold_shared(*map(_ptr, pts + (scalar_limbs, one) + outs), B,
                                     CK.FIELD_IDS[field], CK.stream_ptr(gx_lo.device)),
             "ec_fold_shared")
    ec_fold_shared_lm.launches += 1
    return outs


mont_mul_lm.launches = 0
ec_add_proj_lm.launches = 0
ec_add_proj_sel_lm.launches = 0
ec_seg_rounds_lm.launches = 0
ec_horner_lm.launches = 0
ec_bucket_weights_lm.launches = 0
ec_add_lm.launches = 0
ec_add_tree_lm.launches = 0
ec_add_select_lm.launches = 0
ec_ladder_lm.launches = 0
ec_double_lm.launches = 0
ec_fold_shared_lm.launches = 0
mont_inv_lm.launches = 0
mont_cumprod_lm.launches = 0
powers_lm.launches = 0
perm_terms_lm.launches = 0
lookup_terms_lm.launches = 0
ntt_lm.launches = 0
eval_polys_lm.launches = 0
linear_combo_lm.launches = 0
synthetic_div_lm.launches = 0
permute_pairs_lm.launches = 0
from_mont_lm.launches = 0
msm_digits_lm.launches = 0
