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
  K5 ec_fold_shared_lm  G_lo + [s] G_hi, one shared s  csrc/ec_fold_shared.cu
  K6 ec_add_lm          complete Jacobian add          csrc/ec_add_jac.cu
     ec_add_tree_lm     K6 chained: columns' halving trees  csrc/ec_add_jac.cu
  K7 ec_add_select_lm   sel ? P1 + P2 : P1 (Jacobian)  csrc/ec_add_jac.cu
     ec_ladder_lm       K7 chained: double-and-add     csrc/ec_add_jac.cu
     ec_double_lm       Jacobian doubling (dbl-2009-l) csrc/ec_add_jac.cu
  (K4, the tape interpreter, is ops/tape_device.py + csrc/tape_eval.cu.)

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

import numpy as np
import torch

from . import cuda_kernels as CK
from . import limbs as L

NLIMBS = 16

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within this block every wrapper (K1-K7, ec_seg_rounds, ec_horner,
    ec_ladder, ec_double, ec_add_tree, and poseidon_kernel's permute_batch
    and hash_n_batch) runs its plain version, on any device. Used to hold
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


def ec_seg_rounds_plain(x, y, z, keys, rounds: int, field: str = "fq", tile: int = 0):
    """Plain version of ec_seg_rounds: the segmented Hillis-Steele suffix
    reduction along the last axis of points (16, ..., n) with int64 keys
    (..., n), one K3 select-add a round over rolled copies: after round r,
    lane i holds the sum of its run's elements in [i, i + 2^(r+1)). With
    tile > 0 the lanes fall into tiles of `tile` and a tile's edges are run
    edges too."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    shape = x.shape
    for r in range(rounds):
        s = 1 << r
        same = (idx + s < n) & (keys == torch.roll(keys, -s, dims=-1))
        if tile:
            same &= idx % tile + s < tile
        nxt = (torch.roll(v, -s, dims=-1).reshape(16, -1) for v in (x, y, z))
        out = ec_add_proj_sel_plain(*(v.reshape(16, -1) for v in (x, y, z)), *nxt,
                                    same.reshape(1, -1), field)
        x, y, z = (o.reshape(shape) for o in out)
    return x, y, z


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


def ec_seg_rounds_lm(x, y, z, keys, rounds: int, field: str = "fq", tile: int = 0):
    """K3 chained: `rounds` rounds of ec_seg_rounds_plain over points
    (16, ..., n) int32 and keys (..., n) int64, every add K2's RCB add in
    the plain version's order. tile == 0: one launch a round, computing its
    select from the keys in the kernel. tile > 0 (a power of two, at most
    SEG_TILE_MAX, with 2^rounds <= tile and n a multiple of it): one launch
    for every round, each tile in shared memory. Returns 3 x (16, ..., n)."""
    shape, n = x.shape, x.shape[-1]
    for nm, t in zip(("x", "y", "z"), (x, y, z)):
        check_lm(nm, t, *shape)
    if shape[0] != NLIMBS:
        raise ValueError(f"x: shape {tuple(shape)}, expected (16, ..., n)")
    if keys.dtype != torch.int64 or keys.shape != shape[1:] or not keys.is_contiguous():
        raise ValueError(f"keys: {keys.dtype} {tuple(keys.shape)}, expected contiguous int64 "
                         f"{tuple(shape[1:])}")
    if rounds < 0:
        raise ValueError(f"ec_seg_rounds: rounds = {rounds}")
    if tile and (tile < 0 or tile & (tile - 1) or tile > SEG_TILE_MAX or (1 << rounds) > tile
                 or n % tile):
        raise ValueError(f"ec_seg_rounds: tile {tile} must be a power of two <= {SEG_TILE_MAX} "
                         f"dividing n = {n}, with 2^rounds = {1 << rounds} <= tile")
    if not use_kernel(x, y, z, keys):
        return ec_seg_rounds_plain(x, y, z, keys, rounds, field, tile)
    B = x.numel() // NLIMBS
    so, fid, stream = CK.lib("ec_add_proj"), CK.FIELD_IDS[field], CK.stream_ptr(x.device)
    if tile:
        outs = tuple(torch.empty_like(x) for _ in range(3))
        CK.check(so.taiga_ec_seg_tile(*map(_ptr, (x, y, z, keys)), tile, rounds,
                                      *map(_ptr, outs), B, fid, stream), "ec_seg_tile")
        ec_seg_rounds_lm.launches += 1
        return outs
    pts, bufs = (x, y, z), [tuple(torch.empty_like(x) for _ in range(3))
                            for _ in range(min(rounds, 2))]
    for r in range(rounds):
        out = bufs[r % 2]
        CK.check(so.taiga_ec_seg_round(*map(_ptr, pts + (keys,)), 1 << r, n, *map(_ptr, out),
                                       B, fid, stream), "ec_seg_round")
        ec_seg_rounds_lm.launches += 1
        pts = out
    return pts


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
ec_add_lm.launches = 0
ec_add_tree_lm.launches = 0
ec_add_select_lm.launches = 0
ec_ladder_lm.launches = 0
ec_double_lm.launches = 0
ec_fold_shared_lm.launches = 0
