#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (taiga_tpu_torch) once on one NVIDIA GPU.

Phases, in order; any mismatch or exception ends the script with a non-zero
exit code and no result line:
  1. the device: torch's name for it, and nvidia-smi's name and power limit;
  2. build the hand-written CUDA kernels from taiga_tpu_torch/csrc (one nvcc
     per source, all started together) and print the build time;
  3. name the kernels;
  4. hold each kernel against its plain PyTorch version on the card, bit for
     bit: on seeded inputs with the edge cases at n = 8192 lanes for the
     field and point kernels, and at the width of each kernel's widest
     launch in a warm proof, where it is also timed (device time per launch
     from a torch.profiler trace). K3 at 262,144 lanes with half the lanes
     selected at random, none, all, and one in 32, timed at each; its
     chained form ec_seg_rounds at the shapes of a fixed-base chunk's
     bucket pass: phase B (262,144 lanes of mixed blocks, all 7 rounds in
     one tile launch; also against one launch a round, and timed in both
     forms) and phase C (20,480 lanes, 15 launches), and at the general
     MSMs' rows of 32 windows (32 x 2,048 lanes, 11 launches; 32 x 4,096
     lanes, 6 launches; 32 x 1,024 compacted lanes, 10 launches), on both
     fields, timed at each; the compliance tape over the 8n = 65,536-lane
     coset for the tape interpreter, with the register count of its
     scheduled tape, the lanes a block and the host's scheduling time. The IPA
     fold K5 is checked at 4,096, 100 and 1 lanes with the scalars 0, 1,
     q - 1 and a random one, identities and a lane whose sum is the
     identity, and timed at each of the three widths; the Jacobian adds
     K6/K7 at 8,192 lanes with P + P, P + (-P) and identities, and timed at
     1,048,576 lanes beside K2; the chained Horner of K2 (ec_horner) on
     both fields at every shape a proof gives it (32 windows of 8 doublings
     over 1 and 2 columns; 8 bits of 1 doubling over 8, 32 and 64 columns,
     the last two over several blocks), with identity terms and a column
     whose last add meets its own negation, and timed at each shape (these
     with CUDA events: a launch is a long dependent chain);
  5. prove one compliance (Action) proof at k = 13 on the card with seeded
     blinds, cold (recording the selected share of every K3-family launch,
     as a histogram) and then warm, with the native (host) IPA open: counts
     of kernel launches are zeroed just before each proof and read just
     after; the proof must verify and equal, byte for byte, a second proof
     made through the plain versions on the card under the same seed. Then
     the same statement, warm, with the device IPA open (ipa="device"): it
     must equal the native-IPA proof byte for byte, launch K5 once per IPA
     round and K2 fewer than 400 times (each MSM's Horner chains are
     ec_horner launches, which both proofs must make), and verify on the
     native engine and through the device MSM (msm_device="cuda"); the
     device MSM's final check must refuse it with its a0 changed, and the
     verifier must refuse it for a changed instance. A profiled device-IPA
     proof, which launches K1, K2, K4, K5, ec_seg_rounds and ec_horner,
     gives each kernel's device time per proof, the device's busy time and
     its number of device operations;
  6. print per-stage wall times of both warm proofs beside the card's name
     and power limit, one JSON line of per-kernel numbers, and last
     {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--seed 7]
Needs one CUDA device and the CUDA toolkit (nvcc); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

K = 13              # the compliance proof's domain 2^K (core/constants.py)
N = 1 << K          # lanes of the edge-case checks of K1-K3: the SRS size
# Each kernel is timed at the width of its widest launch in a warm proof:
W_MONT_MUL = 8 * N            # the quotient's division by Z_H over the 8n coset
W_EC_ADD = 8 * 32 * N // 2    # msm._blocked_partials: first tree level, 8 columns x 32 windows
W_EC_ADD_SEL = 8 * 256 * 128  # msm._blocked_partials: 8 x 256 mixed blocks of 128 lanes
SEL_CASES = ("half", "zero", "one", "1in32")  # K3's selections: K3 is timed at each
# ec_seg_rounds at the shapes of a fixed-base chunk (8 columns, c = 8, k = 13)
# of msm._blocked_partials: phase B, the mixed blocks' rounds (tile 128),
# and phase C, the merge's rounds over 16,384 block sums + 4,096 partials
SEG_COLS, SEG_BUCKETS, SEG_BLOCK = 8, 256, 128
W_FOLD = N // 2               # the IPA's first generator fold
FOLD_WIDTHS = (W_FOLD, 100, 1)  # the widest fold, and widths below and off a block
# ec_horner's shapes (W terms, doublings, L columns) in a proof: the window
# Horner of msm (1 column) and msm_multi (2); the bit Horner of a fixed-base
# chunk (8 columns) and of msm's and msm_multi's buckets, whose 32 windows
# are lanes (32 and 64 columns: 2 and 4 blocks). The kernels line reports
# the second
HORNER_SHAPES = ((32, 8, 1), (32, 8, 2), (8, 1, 8), (8, 1, 32), (8, 1, 64))
MAX_K2_DEVICE_IPA = 400  # K2 launches a warm device-IPA proof may make
IMAD_PER_S = 67e12 / 4  # 32-bit integer multiply-adds/s, see bound_ms()
HBM_BYTES_PER_S = 3.35e12
MM_IMADS = 2 * 2 * 64 + 8  # one 8x32-bit CIOS product: lo+hi of 128 word products, 8 m's
KERNEL_SYMBOLS = {  # each kernel's device function, as the profiler names it
    "mont_mul": ("k_mont_mul",),
    "ec_add_proj": ("k_ec_add_proj",),
    "ec_add_proj_sel": ("k_ec_add_sel",),
    "ec_seg_rounds": ("k_ec_seg_round", "k_ec_seg_tile"),
    "tape_eval": ("k_tape_eval",),
    "ec_fold_shared": ("k_ec_fold_shared",),
    "ec_horner": ("k_ec_horner",),
    "ec_add": ("k_ec_add_jac<false>", "k_ec_add_jacILb0E"),
    "ec_add_select": ("k_ec_add_jac<true>", "k_ec_add_jacILb1E"),
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, imads: float):
    """Least time the card could take: the larger of the bytes over HBM's
    3.35 TB/s and the 32-bit multiply-adds over 16.75 T/s (the H100 SXM's
    67 TFLOP/s float32 rate counts an FMA as two operations, and Hopper
    issues 64 integer multiply-adds per SM per clock against 128 FMAs)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = imads / IMAD_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Stream time per call between two CUDA events: for the plain versions,
    whose time is that of many small launches and the host between them,
    and for a kernel whose launch outlasts the host's work between two."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_trace(fn):
    """Run fn under torch.profiler (device activity only). Returns each
    kernel's device time per launch in ms ({name: [ms, ...]}), the
    device's busy time in ms (every kernel, copy and fill; one stream) and
    the number of those device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per, busy, ops = {name: [] for name in KERNEL_SYMBOLS}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        ops += 1
        for name, syms in KERNEL_SYMBOLS.items():
            if any(s in e.name for s in syms):
                per[name].append(ms)
    return per, busy, ops


def kernel_ms(name: str, fn, reps: int, per_call: int = 1) -> float:
    """Device time per launch of kernel `name`, over `reps` calls of fn
    (each launching it `per_call` times), from the profiler: the wrapper's
    host work between launches is not counted. The trace may miss a launch
    now and then, so the mean is over the launches it saw, at least half."""
    fn()
    per, _, _ = device_trace(lambda: [fn() for _ in range(reps)])
    seen = per[name]
    if 2 * len(seen) < reps * per_call:
        raise AssertionError(f"{name}: the profiler saw {len(seen)} of {reps * per_call} launches")
    return sum(seen) / len(seen)


def seeded_randbits(seed: int):
    return random.Random(seed).getrandbits


# --- phase 4 inputs ------------------------------------------------------


def random_elems(rng, spec, B: int) -> np.ndarray:
    """(16, B) int32 canonical limbs (< 2^254 < p), edge values in the first
    lanes: 0, 1, p-1, R mod p."""
    from taiga_tpu_torch.ops import limbs as L

    x = rng.integers(0, 1 << 16, size=(16, B), dtype=np.int64).astype(np.int32)
    x[15] &= 0x3FFF
    edges = [0, 1, spec.modulus - 1, spec.r]
    for i, v in enumerate(edges):
        x[:, i] = L.int_to_limbs(v)
    return x


def field_inputs(rng, field: str, dev):
    """Two (16, B) operand sets: every edge value against every edge value
    in the first 16 lanes, random canonical elements elsewhere."""
    import torch
    from taiga_tpu_torch.ops import limbs as L

    spec = L.FIELDS[field]
    a, b = random_elems(rng, spec, N), random_elems(rng, spec, N)
    edges = a[:, :4].copy()
    for i in range(4):
        for j in range(4):
            a[:, 4 * i + j], b[:, 4 * i + j] = edges[:, i], edges[:, j]
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def curve_of(field: str):
    """The curve whose coordinates lie in `field`: Vesta over Fq, Pallas over Fp."""
    from taiga_tpu_torch.crypto.curves import PallasPoint, VestaPoint

    return VestaPoint if field == "fq" else PallasPoint


def affine_points(field: str, dev):
    """N affine curve points as (x, y, z = 1) limb-major (16, N) int32
    Montgomery: Vesta points from the k = 13 SRS, Pallas points small
    multiples of the generator, repeated."""
    import torch
    from taiga_tpu_torch.ops import ec
    from taiga_tpu_torch.plonk.srs import srs_device

    if field == "fq":
        px, py, pz = srs_device(K)
    else:
        g = curve_of(field).generator()
        pts, acc = [], g
        for _ in range(256):
            pts.append(acc)
            acc = acc + g
        px, py, pz = ec.points_to_device(pts)
    reps = -(-N // px.shape[0])
    return [torch.as_tensor(np.tile(v, (reps, 1))[:N].T.copy(), device=dev)
            for v in (px, py, pz)]


def point_inputs(rng, field: str, dev):
    """Two projective point sets (x, y, z), each (16, B) int32 Montgomery:
    curve points scaled by random nonzero z, with the identity (0:1:0),
    P + P and P + (-P) among them. Vesta points come from the k = 13 SRS,
    Pallas points are small multiples of the generator."""
    import torch
    from taiga_tpu_torch.ops import limbs as L

    spec = L.FIELDS[field]
    xyz = affine_points(field, dev)

    def scaled(perm):
        lam = torch.as_tensor(random_elems(rng, spec, N), device=dev)
        lam[:, :4] = torch.as_tensor(L.int_to_limbs(spec.r), device=dev)[:, None]  # nonzero
        return [L.mont_mul(c.T[perm].contiguous(), lam.T.contiguous(), spec).T.contiguous()
                for c in xyz]

    p1 = scaled(torch.arange(N, device=dev))
    p2 = scaled(torch.as_tensor(rng.permutation(N), device=dev))
    one = torch.as_tensor(L.int_to_limbs(spec.r), device=dev)
    zero = torch.zeros(16, dtype=torch.int32, device=dev)
    # lane 0: identity on the left, lane 1 on the right, lane 2 on both
    for lane, which in ((0, (p1,)), (1, (p2,)), (2, (p1, p2))):
        for p in which:
            p[0][:, lane], p[1][:, lane], p[2][:, lane] = zero, one, zero
    for c in range(3):  # lanes 3..4: P + P; lanes 5..6: P + (-P)
        p2[c][:, 3:5] = p1[c][:, 3:5]
        p2[c][:, 5:7] = p1[c][:, 5:7]
    p2[1][:, 5:7] = L.neg(p1[1][:, 5:7].T.contiguous(), spec).T
    return p1, p2


def jacobian_inputs(rng, field: str, dev):
    """Two Jacobian point sets (x, y, z), each (16, N) int32 Montgomery: the
    affine (X, Y) as (X l^2, Y l^3, l) for random nonzero l, with the
    identity (Z = 0) in lanes 0-2 (left, right, both), P + P in lanes 3-4
    (two representatives of one point) and P + (-P) in lanes 5-6."""
    import torch
    from taiga_tpu_torch.ops import limbs as L

    spec = L.FIELDS[field]
    ax, ay, _ = affine_points(field, dev)

    def scaled(perm):
        lam = random_elems(rng, spec, N)
        lam[:, :7] = lam[:, 7:14]  # random and nonzero where the edge values were
        lam = torch.as_tensor(lam.T.copy(), device=dev)
        l2 = L.mont_mul(lam, lam, spec)
        x = L.mont_mul(ax.T[perm].contiguous(), l2, spec)
        y = L.mont_mul(ay.T[perm].contiguous(), L.mont_mul(l2, lam, spec), spec)
        return [v.T.contiguous() for v in (x, y, lam)]

    perm2 = rng.permutation(N)
    perm2[3:7] = np.arange(3, 7)
    p1 = scaled(torch.arange(N, device=dev))
    p2 = scaled(torch.as_tensor(perm2, device=dev))
    one = torch.as_tensor(L.int_to_limbs(spec.r), device=dev)
    for lane, which in ((0, (p1,)), (1, (p2,)), (2, (p1, p2))):
        for p in which:
            p[0][:, lane], p[1][:, lane], p[2][:, lane] = 0, one, 0
    p2[1][:, 5:7] = L.neg(p2[1][:, 5:7].T.contiguous(), spec).T
    return p1, p2


def to_affine(field: str, x, y, z, lane: int, jacobian: bool):
    """Lane `lane` of limb-major Montgomery coordinates as a host point."""
    from taiga_tpu_torch.ops import limbs as L

    curve, spec = curve_of(field), L.FIELDS[field]
    X, Y, Z = (spec.array_from_mont(v[:, lane].cpu().numpy()[None])[0] for v in (x, y, z))
    if Z == 0:
        return curve.identity()
    p = spec.modulus
    zi = pow(Z, -1, p)
    F = curve.FIELD
    if jacobian:
        return curve(F(X * zi * zi % p), F(Y * zi * zi * zi % p))
    return curve(F(X * zi % p), F(Y * zi % p))


def set_lane(field: str, xyz, lane: int, pt):
    """Write host point `pt` into lane `lane` as projective (x : y : 1), or
    (0 : 1 : 0) for the identity."""
    import torch
    from taiga_tpu_torch.ops import limbs as L

    spec = L.FIELDS[field]
    vals = (0, 1, 0) if pt.is_identity() else (pt.x.v, pt.y.v, 1)
    for v, c in zip(xyz, vals):
        v[:, lane] = torch.as_tensor(spec.array_to_mont([c])[0], device=v.device)


# --- the phases ------------------------------------------------------------


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s))")
    log(smi)  # as nvidia-smi prints it
    return name, smi


def phase_build():
    import re

    from taiga_tpu_torch.ops import cuda_kernels as CK

    t0 = time.perf_counter()
    outs = CK.build(force=True)
    log(f"build: {len(outs)} sources with nvcc in {time.perf_counter() - t0:.2f} s")
    for name, out in outs.items():
        for line in out.splitlines():
            fn = re.search(r"(k_[a-z0-9_]+?)(ILb([01])E)?E", line)
            if "Compiling entry function" in line and fn:
                log(f"  {name}.cu: {fn.group(1)}{'' if fn.group(3) is None else f'<{fn.group(3)}>'}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}.cu:   {line.strip()}")


def compare(name, got, want):
    import torch

    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def wide_fe(gen, B: int, dev):
    """(16, B) int32 random canonical elements (< 2^254 < p), drawn on the
    card from a seeded generator: operands of the timed launches."""
    import torch

    x = torch.randint(0, 1 << 16, (16, B), generator=gen, dtype=torch.int32, device=dev)
    x[15] &= 0x3FFF
    return x


def phase_kernels(pk, seed: int, dev):
    """Kernel vs plain on the card; returns per-kernel numbers."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, tape_device as TD
    from taiga_tpu_torch.plonk.circuit import EXT_FACTOR
    from taiga_tpu_torch.plonk.protocol import (
        L0, LBLIND, LLAST, LOOKUP_A, LOOKUP_S, LOOKUP_Z, SIGMA, XID, Z, num_chunks)
    from taiga_tpu_torch.plonk.expression import ADVICE, FIXED, INSTANCE
    from taiga_tpu_torch.plonk.prover import get_pipeline
    from taiga_tpu_torch.plonk.tape import compile_tape

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    res = {}
    fe = 16 * 4  # bytes of one int32 (16,) element

    # K1: edge cases on both fields, then the quotient's launch (Fp)
    errs = []
    for field in ("fp", "fq"):
        a, b = field_inputs(rng, field, dev)
        got = FK.mont_mul_lm(a, b, field)
        with FK.plain_versions():
            want = FK.mont_mul_lm(a, b, field)
        errs.append(compare(f"mont_mul[{field}]", (got,), (want,)))
    B = W_MONT_MUL
    a, b = wide_fe(gen, B, dev), wide_fe(gen, B, dev)
    got = FK.mont_mul_lm(a, b, "fp")
    with FK.plain_versions():
        errs.append(compare("mont_mul[fp, wide]", (got,), (FK.mont_mul_lm(a, b, "fp"),)))
        pms = cuda_ms(lambda: FK.mont_mul_lm(a, b, "fp"), 3)
    ms = kernel_ms("mont_mul", lambda: FK.mont_mul_lm(a, b, "fp"), 200)
    res["mont_mul"] = dict(err=max(errs), ms=ms, plain_ms=pms, B=B,
                           bound=bound_ms(3 * fe * B, MM_IMADS * B))
    log(f"K1 mont_mul        equal on fp and fq at B={N} and on fp at B={B}; "
        f"at B={B}: {ms:.6f} ms per launch (plain {pms:.3f} ms)")

    # K2 / K3: edge cases on both fields, then the MSM's widest launches (Fq)
    errs2, errs3 = [], []
    for field in ("fp", "fq"):
        p1, p2 = point_inputs(rng, field, dev)
        sel = torch.as_tensor(rng.integers(0, 2, size=(1, N), dtype=np.int32), device=dev)
        got = FK.ec_add_proj_lm(*p1, *p2, field)
        got_s = FK.ec_add_proj_sel_lm(*p1, *p2, sel, field)
        with FK.plain_versions():
            want = FK.ec_add_proj_lm(*p1, *p2, field)
            want_s = FK.ec_add_proj_sel_lm(*p1, *p2, sel, field)
        errs2.append(compare(f"ec_add_proj[{field}]", got, want))
        errs3.append(compare(f"ec_add_proj_sel[{field}]", got_s, want_s))
        # identity + identity and P + (-P) give the identity (0 : Y : 0)
        for lane in (2, 5, 6):
            if got[2][:, lane].any() or got[0][:, lane].any() or not got[1][:, lane].any():
                raise AssertionError(f"ec_add_proj[{field}]: lane {lane} is not the identity")
    del p1, p2, got, got_s, want, want_s

    B2 = W_EC_ADD
    pts = [wide_fe(gen, B2, dev) for _ in range(6)]
    got = FK.ec_add_proj_lm(*pts, "fq")
    with FK.plain_versions():
        errs2.append(compare("ec_add_proj[fq, wide]", got, FK.ec_add_proj_lm(*pts, "fq")))
        pms2 = cuda_ms(lambda: FK.ec_add_proj_lm(*pts, "fq"), 1)
    ms2 = kernel_ms("ec_add_proj", lambda: FK.ec_add_proj_lm(*pts, "fq"), 20)
    res["ec_add_proj"] = dict(err=max(errs2), ms=ms2, plain_ms=pms2, B=B2,
                              bound=bound_ms(9 * fe * B2, 12 * MM_IMADS * B2))
    log(f"K2 ec_add_proj     equal on fp and fq at B={N} and on fq at B={B2}; "
        f"at B={B2}: {ms2:.6f} ms per launch (plain {pms2:.3f} ms)")

    res.update(phase_select(rng, gen, dev, max(errs3)))

    # K4: the compliance quotient tape over the extended coset
    vk, cs = pk.vk, pk.vk.cs
    pipe = get_pipeline(pk, dev)
    tape = compile_tape(pipe.exprs, EXT_FACTOR)
    D = vk.n * EXT_FACTOR
    counts = {FIXED: cs.num_fixed, ADVICE: cs.num_advice, INSTANCE: cs.num_instance,
              SIGMA: len(vk.perm_cols), Z: num_chunks(vk.perm_cols),
              LOOKUP_A: len(cs.lookups), LOOKUP_S: len(cs.lookups), LOOKUP_Z: len(cs.lookups),
              XID: 1, L0: 1, LLAST: 1, LBLIND: 1}
    ks = {}
    for kind, c in counts.items():
        v = rng.integers(0, 1 << 16, size=(c, D, 16), dtype=np.int64).astype(np.int32)
        v[..., 15] &= 0x3FFF
        ks[kind] = torch.as_tensor(v, device=dev)
    svals = [int(v) for v in rng.integers(1, 1 << 62, size=len(tape.scalar_exprs))]
    # the tape the kernel runs, scheduled once on the host and kept on the tape
    t0 = time.perf_counter()
    scode, regs = TD.device_code(tape, TD.table_offsets(ks)[0], D)
    t_sched = time.perf_counter() - t0
    t0 = time.perf_counter()
    TD.device_code(tape, TD.table_offsets(ks)[0], D)
    t_kept = time.perf_counter() - t0
    got = TD.tape_eval_device(tape, ks, svals, D)
    with FK.plain_versions():
        want = TD.tape_eval_device(tape, ks, svals, D)
    err4 = compare("tape_eval", (got,), (want,))
    ms4 = kernel_ms("tape_eval", lambda: TD.tape_eval_device(tape, ks, svals, D), 10)
    with FK.plain_versions():
        pms4 = cuda_ms(lambda: TD.tape_eval_device(tape, ks, svals, D), 1)
    code = np.asarray(tape.code)
    n_mul = int(((code[:, 0] == TD.OP_MUL) | (code[:, 0] == TD.OP_MULS)).sum())
    tc = sum(counts.values())
    tbytes = tc * 16 * 4 * (D + TD.LPAD + TD.RPAD) + code.nbytes + 16 * 4 * D
    n_sc = len(svals)
    res["tape_eval"] = dict(err=err4, ms=ms4, plain_ms=pms4, B=D,
                            bound=bound_ms(tbytes, n_mul * MM_IMADS * D))
    log(f"K4 tape_eval       D={D}, the tape's {code.shape[0]} instructions ({n_mul} products) "
        f"over {tape.num_regs} registers scheduled into {scode.shape[0]} over {regs} registers, "
        f"{TD.BLOCK_LANES} lanes a block ({TD.file_bytes(regs, n_sc)} B of shared memory): "
        f"equal; {ms4:.6f} ms per launch (plain {pms4:.1f} ms); scheduling on the host "
        f"{t_sched * 1e3:.1f} ms once, {t_kept * 1e3:.3f} ms a later call")
    del ks, got, want
    res.update(phase_fold_and_jacobian(rng, gen, dev))
    res.update(phase_horner(rng, dev))
    return res


def seg_selected(keys, rounds: int, tile: int):
    """Selected lanes (same run at distance 2^r) of each round of
    ec_seg_rounds over keys (..., n), as a (rounds,) tensor."""
    import torch

    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    out = []
    for r in range(rounds):
        s = 1 << r
        same = (idx + s < n) & (keys == torch.roll(keys, -s, dims=-1))
        if tile:
            same &= idx % tile + s < tile
        out.append(same.sum())
    return torch.stack(out)


def seg_keys(gen, dev):
    """Keys of ec_seg_rounds as _blocked_partials makes them for one
    fixed-base chunk: SEG_COLS columns of 32 windows x N random digits,
    keyed col * SEG_BUCKETS + digit and sorted (runs of ~1,000 lanes); phase
    B gathers the 128-lane blocks that hold a run edge (at most
    SEG_COLS * SEG_BUCKETS) under block-local keys; phase C sorts the
    uniform blocks' keys with the in-block run starts (sentinel where
    none)."""
    import torch

    total, nb = SEG_COLS * 32 * N, SEG_COLS * 32 * N // SEG_BLOCK
    keys = torch.sort(torch.randint(0, SEG_COLS * SEG_BUCKETS, (total,), generator=gen,
                                    device=dev)).values
    lo, hi = keys[0::SEG_BLOCK], keys[SEG_BLOCK - 1::SEG_BLOCK]
    mixed = lo != hi
    maxb = min(SEG_COLS * SEG_BUCKETS, nb)
    posb = mixed.nonzero()[:maxb, 0]
    posb = torch.cat([posb, posb[-1:].expand(maxb - posb.numel())])
    gidx = (posb[:, None] * SEG_BLOCK + torch.arange(SEG_BLOCK, device=dev)).reshape(-1)
    gkey = keys.index_select(0, gidx)
    blk = torch.arange(maxb, device=dev).repeat_interleave(SEG_BLOCK)
    phase_b = (blk * (SEG_COLS * SEG_BUCKETS + 1) + gkey).contiguous()
    prev = torch.cat([phase_b[:1] ^ 1, phase_b[:-1]])
    starts = ((torch.arange(phase_b.numel(), device=dev) % SEG_BLOCK == 0)
              | (phase_b != prev)).nonzero()[:, 0]
    ecap, sent = 2 * SEG_COLS * SEG_BUCKETS, SEG_COLS * SEG_BUCKETS
    mkey = torch.full((ecap,), sent, dtype=keys.dtype, device=dev)
    mkey[:min(ecap, starts.numel())] = gkey[starts[:ecap]]
    ukey = torch.where(mixed, sent, lo)
    phase_c = torch.sort(torch.cat([ukey, mkey])).values.contiguous()
    return phase_b, phase_c


def row_keys(gen, dev):
    """Keys of ec_seg_rounds as the general MSMs (msm, msm_multi: the
    device IPA's and the device-MSM verifier's) give them, one row of n
    lanes a window: 32 windows of c = 8 digits, each row sorted. At n =
    2,048 msm._window_reduce runs log2 n rounds in place; at n = 4,096
    msm._compact runs 6 rounds (CHUNK), gathers each run's partials at
    stride CHUNK into 1,024 lanes (sentinel keys beyond them) and runs 10
    rounds there. Returns {name: (keys, rounds)}."""
    import torch
    from taiga_tpu_torch.ops import msm as TM

    c, out = TM.WINDOW_BITS, {}
    d2 = torch.sort(torch.randint(0, 1 << c, (32, 2048), generator=gen, device=dev), -1).values
    out["rows 32 x 2048"] = (d2.contiguous(), 11)
    d4 = torch.sort(torch.randint(0, 1 << c, (32, 4096), generator=gen, device=dev), -1).values
    out["rows 32 x 4096"] = (d4.contiguous(), TM._CHUNK.bit_length() - 1)
    n, size = d4.shape[-1], TM._COMPACT
    idx = torch.arange(n, device=dev)
    start = torch.cat([torch.ones_like(d4[:, :1], dtype=torch.bool), d4[:, 1:] != d4[:, :-1]], -1)
    seg = torch.cummax(torch.where(start, idx, -1), -1).values
    pos = TM._nonzero_sized((idx - seg) % TM._CHUNK == 0, size, n)
    cd = torch.where(pos < n, TM._take(d4, pos.clamp(max=n - 1)), 1 << c)
    out["rows 32 x 1024, compacted"] = (cd.contiguous(), size.bit_length() - 1)
    return out


def phase_select(rng, gen, dev, err_edges):
    """K3 (ec_add_proj_sel) and K3 chained (ec_seg_rounds) against their
    plain versions, bit for bit; then timed. K3 at its widest launch with
    half the lanes selected at random, none, all, and one in 32; the rounds
    at phase B's shape (one tile launch, and one launch a round) and phase
    C's (one launch a round), and at the general MSMs' rows of windows
    (row_keys: one launch a round), on both fields."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK

    res = {}
    fe = 16 * 4
    B3 = W_EC_ADD_SEL
    pts = [wide_fe(gen, B3, dev) for _ in range(6)]
    sels = {"half": torch.randint(0, 2, (1, B3), generator=gen, dtype=torch.int32, device=dev),
            "zero": torch.zeros((1, B3), dtype=torch.int32, device=dev),
            "one": torch.ones((1, B3), dtype=torch.int32, device=dev),
            "1in32": (torch.randint(0, 32, (1, B3), generator=gen, device=dev) == 0).int()}
    err3, times = err_edges, {}
    for case in SEL_CASES:
        sel = sels[case]
        got = FK.ec_add_proj_sel_lm(*pts, sel, "fq")
        with FK.plain_versions():
            err3 = max(err3, compare(f"ec_add_proj_sel[fq, {case}]", got,
                                     FK.ec_add_proj_sel_lm(*pts, sel, "fq")))
        times[case] = kernel_ms("ec_add_proj_sel", lambda: FK.ec_add_proj_sel_lm(*pts, sel, "fq"),
                                50)
    sel = sels["half"]
    n_sel = int(sel.sum())
    with FK.plain_versions():
        pms3 = cuda_ms(lambda: FK.ec_add_proj_sel_lm(*pts, sel, "fq"), 1)
    # P1 read and the sum written on every lane, P2 read where sel is set
    res["ec_add_proj_sel"] = dict(err=err3, ms=times["half"], plain_ms=pms3, B=B3,
                                  bound=bound_ms(fe * (6 * B3 + 3 * n_sel) + 4 * B3,
                                                 12 * MM_IMADS * n_sel))
    log(f"K3 ec_add_proj_sel equal on fp and fq at B={N} and on fq at B={B3} with "
        f"{', '.join(SEL_CASES)} selected; at B={B3}: "
        + ", ".join(f"{c} {times[c]:.6f} ms" for c in SEL_CASES)
        + f" per launch ({n_sel} selected in 'half'; plain {pms3:.3f} ms)")
    del pts, sels

    phase_b, phase_c = seg_keys(gen, dev)
    shapes = {"B": (phase_b, SEG_BLOCK.bit_length() - 1, SEG_BLOCK),
              "C": (phase_c, max(1, (phase_c.numel() - 1).bit_length()), 0)}
    err, out = 0, {}
    for field in ("fp", "fq"):
        for ph, (keys, rounds, tile) in shapes.items():
            p = [wide_fe(gen, keys.numel(), dev) for _ in range(3)]
            got = FK.ec_seg_rounds_lm(*p, keys, rounds, field, tile)
            with FK.plain_versions():
                want = FK.ec_seg_rounds_lm(*p, keys, rounds, field, tile)
            err = max(err, compare(f"ec_seg_rounds[{field}, phase {ph}]", got, want))
            if tile:  # the tile form equals one launch a round where no run crosses a tile
                err = max(err, compare(f"ec_seg_rounds[{field}, phase {ph}, per round]",
                                       FK.ec_seg_rounds_lm(*p, keys, rounds, field), want))
            if field == "fq":
                out[ph] = p
    rows = row_keys(gen, dev)
    for field in ("fp", "fq"):
        for name, (keys, rounds) in rows.items():
            p = [wide_fe(gen, keys.numel(), dev).view((16,) + tuple(keys.shape))
                 for _ in range(3)]
            got = FK.ec_seg_rounds_lm(*p, keys, rounds, field)
            with FK.plain_versions():
                want = FK.ec_seg_rounds_lm(*p, keys, rounds, field)
            err = max(err, compare(f"ec_seg_rounds[{field}, {name}]", got, want))
            if field == "fq":
                out[name] = p

    def seg_ms(p, keys, rounds, tile):
        launches = 1 if tile else rounds
        return kernel_ms("ec_seg_rounds",
                         lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile), 10,
                         launches) * launches, launches

    cases = [(f"phase {ph}", out[ph], keys, rounds, tile)
             for ph, (keys, rounds, tile) in shapes.items()]
    cases += [(name, out[name], keys, rounds, 0) for name, (keys, rounds) in rows.items()]
    for name, p, keys, rounds, tile in cases:
        B = keys.numel()
        ms, launches = seg_ms(p, keys, rounds, tile)
        with FK.plain_versions():
            pms = cuda_ms(lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile), 1)
        adds = int(seg_selected(keys, rounds, tile).sum())
        bound = bound_ms(fe * 6 * B + 8 * B, 12 * MM_IMADS * adds)
        per_round = ""
        if tile:  # the same rounds, one launch each (equal on these keys: checked above)
            per_round = f"; one launch a round {seg_ms(p, keys, rounds, 0)[0]:.6f} ms"
        log(f"ec_seg_rounds      {name}: {tuple(keys.shape)} lanes, {rounds} rounds"
            f"{f', tile {tile}' if tile else ''}, {adds} adds ({adds / (B * rounds):.3f} of "
            f"lanes x rounds), equal on fp and fq; {ms:.6f} ms in {launches} launch(es)"
            f"{per_round} (bound {bound[0]:.6f} ms by {bound[1]}; plain {pms:.3f} ms)")
        if name == "phase B":
            res["ec_seg_rounds"] = dict(err=err, ms=ms, plain_ms=pms, B=B, bound=bound)
    return res


def phase_fold_and_jacobian(rng, gen, dev):
    """K5 (the IPA fold) and K6/K7 (the Jacobian adds) against their plain
    versions, bit for bit, on both fields; then timed.

    LONG_LAUNCH: each of these launches lasts milliseconds (K5 is one
    dependent chain of ~4,600 products a lane; K6/K7 run 23 products on a
    million lanes), so the host enqueues the next launch long before the
    last ends and the stream never idles: CUDA events around the loop read
    their device time. (The profiler's trace dropped about half of the
    launches of these long kernels in some runs.)"""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L

    res = {}
    fe = 16 * 4

    # K5: G_lo + [s] G_hi at each width of FOLD_WIDTHS, whose first lanes
    # hold identities in G_lo (lane 0), G_hi (1), both (2), and (lane 5)
    # G_lo = -[s] G_hi, whose sum is the identity. The plain version runs
    # once over the three widths side by side (its lanes are independent).
    err5 = 0
    s_rand = None
    for field in ("fp", "fq"):
        q = curve_of(field).SCALAR.MODULUS
        lo, hi = point_inputs(rng, field, dev)
        lo = [v[:, :W_FOLD].contiguous() for v in lo]
        hi = [v[:, :W_FOLD].contiguous() for v in hi]
        h5 = to_affine(field, *hi, 5, jacobian=False)
        s_r = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) ** 3 % q
        for s_val in (0, 1, q - 1, s_r):
            set_lane(field, lo, 5, -(h5 * s_val))
            sl = torch.as_tensor(L.int_to_limbs(s_val)[None], device=dev)
            got = [FK.ec_fold_shared_lm(*(v[:, :B].contiguous() for v in lo + hi), sl, field)
                   for B in FOLD_WIDTHS]
            with FK.plain_versions():
                want = FK.ec_fold_shared_lm(*(torch.cat([v[:, :B] for B in FOLD_WIDTHS], 1)
                                              .contiguous() for v in lo + hi), sl, field)
            off = 0
            for B, g in zip(FOLD_WIDTHS, got):
                err5 = max(err5, compare(f"ec_fold_shared[{field}, s={s_val}, B={B}]", g,
                                         [w[:, off:off + B] for w in want]))
                off += B
            if not to_affine(field, *got[0], 5, jacobian=False).is_identity():
                raise AssertionError(f"ec_fold_shared[{field}]: lane 5, G_lo = -[s] G_hi, "
                                     "does not sum to the identity")
            if field == "fq":
                s_rand = (s_r, sl)
        if field == "fq":
            fold_in = (lo, hi)
    s_val, sl = s_rand
    lo, hi = fold_in
    B5 = W_FOLD
    with FK.plain_versions():
        pms5 = cuda_ms(lambda: FK.ec_fold_shared_lm(*lo, *hi, sl, "fq"), 1)
    steps = (FK.FOLD_STEPS - 1) + bin(s_val).count("1") + 1  # doublings, adds, G_lo + acc
    log(f"K5 ec_fold_shared  equal on fp and fq at B={FOLD_WIDTHS} for s = 0, 1, q-1 and a "
        f"random s (plain at B={B5}: {pms5:.1f} ms); the chain: {2 * FK.FOLD_STEPS} product "
        f"stages a lane (a doubling beside each add, and the final add)")
    for B in FOLD_WIDTHS:  # see LONG_LAUNCH
        args = [v[:, :B].contiguous() for v in lo + hi]
        ms = cuda_ms(lambda: FK.ec_fold_shared_lm(*args, sl, "fq"), 20)
        bound = bound_ms(9 * fe * B + fe, steps * 12 * MM_IMADS * B)
        log(f"  at B={B}: {ms:.6f} ms per launch (bound {bound[0]:.6f} ms by {bound[1]})")
        if B == B5:
            res["ec_fold_shared"] = dict(err=err5, ms=ms, plain_ms=pms5, B=B5, bound=bound)
    del lo, hi, fold_in, args

    # K6 / K7: edge cases on both fields, then the width K2 is timed at (Fq)
    errs6, errs7 = [], []
    for field in ("fp", "fq"):
        p1, p2 = jacobian_inputs(rng, field, dev)
        sel = torch.as_tensor(rng.integers(0, 2, size=(1, N), dtype=np.int32), device=dev)
        sel[0, :7] = 1
        got = FK.ec_add_lm(*p1, *p2, field)
        got_s = FK.ec_add_select_lm(*p1, *p2, sel, field)
        with FK.plain_versions():
            want = FK.ec_add_lm(*p1, *p2, field)
            want_s = FK.ec_add_select_lm(*p1, *p2, sel, field)
        errs6.append(compare(f"ec_add[{field}]", got, want))
        errs7.append(compare(f"ec_add_select[{field}]", got_s, want_s))
        for lane in range(7):  # the edge lanes against the host group law
            a, b = (to_affine(field, *p, lane, jacobian=True) for p in (p1, p2))
            if to_affine(field, *got, lane, jacobian=True) != a + b:
                raise AssertionError(f"ec_add[{field}]: lane {lane} is not P1 + P2")
    del p1, p2, got, got_s, want, want_s

    B6 = W_EC_ADD
    pts = [wide_fe(gen, B6, dev) for _ in range(6)]
    got = FK.ec_add_lm(*pts, "fq")
    with FK.plain_versions():
        errs6.append(compare("ec_add[fq, wide]", got, FK.ec_add_lm(*pts, "fq")))
        pms6 = cuda_ms(lambda: FK.ec_add_lm(*pts, "fq"), 1)
    ms6 = cuda_ms(lambda: FK.ec_add_lm(*pts, "fq"), 20)  # see LONG_LAUNCH
    res["ec_add"] = dict(err=max(errs6), ms=ms6, plain_ms=pms6, B=B6,
                         bound=bound_ms(9 * fe * B6, 16 * MM_IMADS * B6))
    log(f"K6 ec_add          equal on fp and fq at B={N} and on fq at B={B6}; "
        f"at B={B6}: {ms6:.6f} ms per launch (plain {pms6:.3f} ms)")

    sel = torch.randint(0, 2, (1, B6), generator=gen, dtype=torch.int32, device=dev)
    n_sel = int(sel.sum())
    got = FK.ec_add_select_lm(*pts, sel, "fq")
    with FK.plain_versions():
        errs7.append(compare("ec_add_select[fq, wide]", got, FK.ec_add_select_lm(*pts, sel, "fq")))
        pms7 = cuda_ms(lambda: FK.ec_add_select_lm(*pts, sel, "fq"), 1)
    ms7 = cuda_ms(lambda: FK.ec_add_select_lm(*pts, sel, "fq"), 20)  # see LONG_LAUNCH
    res["ec_add_select"] = dict(err=max(errs7), ms=ms7, plain_ms=pms7, B=B6,
                                bound=bound_ms(fe * (6 * B6 + 3 * n_sel) + 4 * B6,
                                               16 * MM_IMADS * n_sel))
    log(f"K7 ec_add_select   equal on fp and fq at B={N} and on fq at B={B6}; "
        f"at B={B6} ({n_sel} selected): {ms7:.6f} ms per launch (plain {pms7:.3f} ms)")
    return res


def horner_terms(rng, field: str, dev, W: int, d: int, Lc: int):
    """Terms (16, W, Lc) x 3 of ec_horner: curve points scaled by random z,
    the identity as column 0's most significant term (the chain starts at
    the identity) and as its term 1, and in the last column a term 0 equal
    to the negation of the sum it is added to (the last add meets its own
    negation: the result is the identity)."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L

    spec = L.FIELDS[field]
    p1, _ = point_inputs(rng, field, dev)
    perm = torch.as_tensor(7 + rng.permutation(N - 7)[:W * Lc], device=dev)  # no edge lane
    t = [v.index_select(1, perm).reshape(16, W, Lc).contiguous() for v in p1]
    one = torch.as_tensor(L.int_to_limbs(spec.r), device=dev)
    for w in (W - 1, 1):
        t[0][:, w, 0], t[1][:, w, 0], t[2][:, w, 0] = 0, one, 0
    with FK.plain_versions():  # the sum before the last add, then its negation
        acc = FK.ec_horner_lm(*(v[:, 1:, -1:].contiguous() for v in t), d, field)
        for _ in range(d):
            acc = FK.ec_add_proj_lm(*acc, *acc, field)
    t[0][:, 0, -1], t[2][:, 0, -1] = acc[0][:, 0], acc[2][:, 0]
    t[1][:, 0, -1] = L.neg(acc[1].T.contiguous(), spec)[0]
    return t


def phase_horner(rng, dev):
    """ec_horner (K2 chained, one launch per Horner) against its plain
    version, the loop of K2 adds it replaces, bit for bit on both fields at
    the MSMs' shapes; then timed at each (see LONG_LAUNCH)."""
    from taiga_tpu_torch.ops import ff_kernels as FK

    fe = 16 * 4
    err, timed = 0, {}
    for field in ("fp", "fq"):
        for W, d, Lc in HORNER_SHAPES:
            t = horner_terms(rng, field, dev, W, d, Lc)
            got = FK.ec_horner_lm(*t, d, field)
            with FK.plain_versions():
                want = FK.ec_horner_lm(*t, d, field)
            err = max(err, compare(f"ec_horner[{field}, W={W}, d={d}, L={Lc}]", got, want))
            x, y, z = (v[:, -1] for v in got)
            if x.any() or z.any() or not y.any():
                raise AssertionError(f"ec_horner[{field}, W={W}]: the cancelling column "
                                     "is not the identity")
            if field == "fq":
                timed[(W, d, Lc)] = t
    log(f"ec_horner          equal on fp and fq at (W, doublings, L) = {HORNER_SHAPES}, with "
        f"identity terms and a last add that meets its own negation")
    res = {}
    for (W, d, Lc), t in timed.items():
        ms = cuda_ms(lambda: FK.ec_horner_lm(*t, d, "fq"), 20)
        adds = (W - 1) * (d + 1)
        bound = bound_ms(3 * fe * (W + 1) * Lc, adds * 12 * MM_IMADS * Lc)
        log(f"  at (W, d, L) = ({W}, {d}, {Lc}), a chain of {adds} adds ({2 * adds} product "
            f"stages) a column: {ms:.6f} ms per launch (bound {bound[0]:.6f} ms by {bound[1]})")
        if (W, d, Lc) == HORNER_SHAPES[1]:
            with FK.plain_versions():
                pms = cuda_ms(lambda: FK.ec_horner_lm(*t, d, "fq"), 1)
            log(f"    plain version (the loop of {adds} K2 adds) {pms:.3f} ms")
            res["ec_horner"] = dict(err=err, ms=ms, plain_ms=pms, B=(W, d, Lc), bound=bound)
    return res


KERNELS = [
    # name, wrapper attribute, source, TPU kernel replaced, the proofs whose
    # path launches it ("native": the native IPA open, "device": ipa="device")
    ("mont_mul", "mont_mul_lm", "taiga_tpu_torch/csrc/mont_mul.cu",
     "taiga_tpu/ops/ff_kernels.py:428", ("native", "device")),
    ("ec_add_proj", "ec_add_proj_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/ff_kernels.py:547", ("native", "device")),
    # K3's rounds on both paths go through ec_seg_rounds, its chained form
    ("ec_add_proj_sel", "ec_add_proj_sel_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/ff_kernels.py:511", ()),
    # K3 chained: the segmented rounds over K3 of the MSMs' bucket passes
    ("ec_seg_rounds", "ec_seg_rounds_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/msm.py:74-90", ("native", "device")),
    # K2 chained: the scan over K2 that combines an MSM's windows (and its
    # bit Horner, :158-173)
    ("ec_horner", "ec_horner_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/msm.py:417-424", ("native", "device")),
    ("tape_eval", "tape_eval_lm", "taiga_tpu_torch/csrc/tape_eval.cu",
     "taiga_tpu/ops/tape_device.py:81", ("native", "device")),
    ("ec_fold_shared", "ec_fold_shared_lm", "taiga_tpu_torch/csrc/ec_fold_shared.cu",
     "taiga_tpu/ops/ff_kernels.py:623", ("device",)),
    ("ec_add", "ec_add_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/ops/ff_kernels.py:483", ()),
    ("ec_add_select", "ec_add_select_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/ops/ff_kernels.py:448", ()),
]


def _wrapper(attr):
    from taiga_tpu_torch.ops import ff_kernels as FK, tape_device as TD

    return getattr(FK, attr, None) or getattr(TD, attr)


def zero_counts():
    for _, attr, _, _, _ in KERNELS:
        _wrapper(attr).launches = 0


def read_counts(what: str, path: str) -> dict:
    """The launch counts since zero_counts(); fails if a kernel of the path
    ("native" or "device" IPA) was never launched."""
    counts = {name: _wrapper(attr).launches for name, attr, _, _, _ in KERNELS}
    for name, _, _, _, paths in KERNELS:
        if path in paths and counts[name] == 0:
            raise AssertionError(f"the {what} proof never launched {name}")
    return counts


def profiled(prove, path: str, launches: dict):
    """One proof under the profiler: each kernel's device time over its
    launches, the device's busy time and its number of operations."""
    t0 = time.perf_counter()
    per, busy, ops = device_trace(prove)
    log(f"  under the profiler ({time.perf_counter() - t0:.2f} s with the profiler): "
        f"device busy {busy:.3f} ms in all, {ops} device operations (kernels, copies, fills)")
    for name, _, _, _, paths in KERNELS:
        if path not in paths:
            continue
        times = per[name]
        if not times:
            raise AssertionError(f"{name}: the profiler saw none of its launches in a warm proof")
        log(f"  {name:16s} {sum(times):10.3f} ms on the device over the {len(times)} launches "
            f"the trace saw (the count says {launches[name]})")


def phase_prove(pk, seed: int):
    """The main path: one seeded compliance proof on the card, cold, then
    warm (stage-timed); then warm with the device IPA open, stage-timed,
    verified through the device MSM and profiled; then through the plain
    versions."""
    import torch
    import taiga_tpu_torch as T
    from taiga_tpu_torch.crypto.fields import Fp
    from taiga_tpu_torch.ops import ff_kernels as FK, msm as TM
    from taiga_tpu_torch.plonk.prover import StageTimer
    from taiga_tpu_torch.plonk.verifier import verify_proof

    def prove(**kw):
        return T.prove_compliance(random.Random(seed), K, device="cuda",
                                  randbits=seeded_randbits(seed + 1), **kw)

    # the cold proof records the selected share of each K3-family launch.
    # The keys are made inside ops/msm.py and never leave it, so msm sees
    # ff_kernels through a view whose ec_seg_rounds_lm records them first;
    # ff_kernels itself is left as it is, so every launch and its count are
    # the wrapper's own, and the view is taken away when the proof ends
    selected = []

    class Recorded:
        def __getattr__(self, name):
            return getattr(FK, name)

        def ec_seg_rounds_lm(self, x, y, z, keys, rounds, field="fq", tile=0):
            selected.append((keys.numel(), rounds, tile, seg_selected(keys, rounds, tile)))
            return FK.ec_seg_rounds_lm(x, y, z, keys, rounds, field, tile)

    zero_counts()
    TM.FK = Recorded()
    t0 = time.perf_counter()
    try:
        vk, inst, proof = prove()
    finally:
        TM.FK = FK
    t_cold = time.perf_counter() - t0
    cold = read_counts("cold", "native")
    log(f"proof, cold (also builds the SRS table and the static tables once; its K3-family "
        f"launches measured, below): {t_cold:.2f} s, {len(proof)} bytes; launches {cold}")
    if not verify_proof(vk, inst, proof):
        raise AssertionError("the compliance proof does not verify")
    log("proof verifies under taiga_tpu_torch.plonk.verifier")

    timer = StageTimer("cuda")
    zero_counts()
    t0 = time.perf_counter()
    _, _, warm = prove(timer=timer)
    t_warm = time.perf_counter() - t0
    launches = read_counts("warm", "native")
    log(f"proof, warm: {t_warm:.2f} s; launches {launches}")
    if warm != proof:
        raise AssertionError("a second seeded proof differs from the first")
    shares = []  # (lanes, selected share) of each K3-family launch
    for lanes, rounds, tile, sel in selected:
        sel = sel.tolist()
        if tile:  # one launch for every round
            shares.append((lanes, sum(sel) / (lanes * rounds)))
        else:
            shares += [(lanes, v / lanes) for v in sel]
    if len(shares) != launches["ec_seg_rounds"] + launches["ec_add_proj_sel"]:
        raise AssertionError(f"the cold proof made {len(shares)} K3-family launches, the warm one "
                             f"{launches['ec_seg_rounds'] + launches['ec_add_proj_sel']}")
    hist = np.histogram([v for _, v in shares], bins=10, range=(0.0, 1.0))[0]
    log(f"selected share of the {len(shares)} K3-family launches of a native proof, in tenths "
        f"from 0 to 1: {hist.tolist()}; lanes x share summed: "
        f"{sum(n * v for n, v in shares):.0f} of {sum(n for n, _ in shares)} lanes")

    # the same statement with the device IPA open
    timer_d = StageTimer("cuda")
    zero_counts()
    t0 = time.perf_counter()
    _, _, dproof = prove(timer=timer_d, ipa="device")
    t_dev = time.perf_counter() - t0
    launches_d = read_counts("device-IPA", "device")
    log(f"proof with the device IPA open, warm: {t_dev:.2f} s; launches {launches_d}")
    family = ("ec_add_proj_sel", "ec_seg_rounds")
    log(f"K3-family launches per warm proof: native {sum(launches[k] for k in family)}, "
        f"device IPA {sum(launches_d[k] for k in family)}")
    if launches_d["ec_fold_shared"] != K:
        raise AssertionError(f"the device IPA folded {launches_d['ec_fold_shared']} times, not {K}")
    if launches_d["ec_add_proj"] >= MAX_K2_DEVICE_IPA:
        raise AssertionError(f"the device-IPA proof launched K2 {launches_d['ec_add_proj']} "
                             f"times, not fewer than {MAX_K2_DEVICE_IPA}")
    if dproof != proof:
        raise AssertionError("the device-IPA proof differs from the native-IPA proof")
    log("the device-IPA proof equals the native-IPA proof byte for byte")
    if not verify_proof(vk, inst, dproof):
        raise AssertionError("the device-IPA proof does not verify on the native engine")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = verify_proof(vk, inst, dproof, msm_device="cuda")
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the device-IPA proof does not verify through the device MSM")
    # a0, the IPA's last but one scalar, is read only by the final check:
    # changed, the proof passes every earlier check and reaches the MSM
    tampered = bytearray(dproof)
    tampered[-64] ^= 1
    zero_counts()
    if verify_proof(vk, inst, bytes(tampered), msm_device="cuda"):
        raise AssertionError("the device-MSM verifier accepts the proof with a0 changed")
    if FK.ec_add_proj_lm.launches == 0:
        raise AssertionError("the proof with a0 changed was refused before the device MSM")
    bad = [inst[0] + Fp(1)] + list(inst[1:])
    if verify_proof(vk, bad, dproof, msm_device="cuda"):
        raise AssertionError("the verifier accepts the proof for a changed instance")
    log(f"it verifies on the native engine and through the device MSM ({t_verify * 1e3:.1f} ms); "
        "the device MSM's final check refuses it with a0 changed, and the vanishing identity "
        "refuses it for a changed instance")
    profiled(lambda: prove(ipa="device"), "device", launches_d)

    pk.__dict__.pop("_pipelines", None)  # the twin rebuilds every table
    t0 = time.perf_counter()
    with FK.plain_versions():
        _, _, plain = prove()
    t_plain = time.perf_counter() - t0
    if plain != proof:
        raise AssertionError("the proof made with the kernels differs from the plain-version proof")
    log(f"plain-version proof on the card ({t_plain:.2f} s, cold) equals the kernel proof byte for byte")
    launches["ec_fold_shared"] = launches_d["ec_fold_shared"]  # the path that runs it
    return launches, (timer.stages, t_warm), (timer_d.stages, t_dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import taiga_tpu_torch as T

    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    log(json.dumps({"kernels": [name for name, _, _, _, _ in KERNELS]}))
    t0 = time.perf_counter()
    pk = T.compliance_proving_key(K)
    log(f"compliance keygen k={K} (host, native engine): {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    res = phase_kernels(pk, args.seed, dev)
    launches, native, device = phase_prove(pk, args.seed)

    for what, (stages, total) in (("native IPA", native), ("device IPA", device)):
        log(f"stage wall times of a warm k={K} proof, {what}, on {smi}:")
        for name, sec in stages:
            log(f"  {name:28s} {sec * 1e3:10.1f} ms")
        log(f"  {'total (prove_compliance)':28s} {total * 1e3:10.1f} ms   [{smi}]")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, attr, src, replaces, _ in KERNELS:
        r = res[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                     "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
