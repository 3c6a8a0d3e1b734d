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
     chained form ec_seg_rounds (one launch a call; a lane is defined at
     an offset from its run's start that is a multiple of 2^rounds, and
     every other lane keeps its input) on every lane at the shapes of a
     fixed-base chunk's bucket pass: phase B (262,144 lanes of mixed
     blocks, 7 rounds in the tile form; also against the row form, and
     timed in both) and phase C (20,480 lanes, 15 rounds), and at the
     general MSMs' rows of 32 windows (32 x 2,048 lanes, 11 rounds; 32 x
     4,096 lanes, 6 rounds; 32 x 1,024 compacted lanes, 10 rounds), on
     both fields, timed at each, with the aligned adds each needs (and,
     beside them, the Hillis-Steele selections the rounds made before); the compliance tape over the 8n = 65,536-lane
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
     with CUDA events: a launch is a long dependent chain); the bucket
     weighting ec_bucket_weights (each bit row's tree and the Horner over
     the bits in one launch) on both fields at a fixed-base chunk's 8
     columns and the general MSM's 32 windows of 256 buckets, empty
     buckets among them, and timed at both; the grand products' kernels
     (csrc/grand_product.cu): K8 (the divsteps inversion, one thread a
     lane, on both fields, on and off a warp's 32 lanes), K9 (prefix
     and suffix products: both ways at rows of 1 to 2,049 with a zero,
     at poly.powers' expanded layout and at the fixed-base table's
     262,144 Fq lanes) and K10 (the numerators and denominators, its
     permutation and lookup entries), with the lanes 0,
     1 and p - 1, at a single proof's and a batch of 8's shapes, timed at
     both (profiler); the NTT's kernel K11 (csrc/ntt.cu, phase_ntt), at
     radix 4 and at radix 2, in all four transforms at every k from 1 to
     18 on both fields, on rows of 0, 1 and p - 1, on a moved axis and on
     rows that hold only their first elements (the rest read as zero),
     and at the main path's calls (a proof's and a batch of 8's iNTT of
     12 columns at 2^13, the extension of a proof's and a batch's 12
     advice columns at 2^16 from their n / 8 coefficients, a batch's coset
     iNTT, one Fq shape), timed at each (profiler); the polynomial
     programs K12-K14 (csrc/poly.cu, phase_poly); and K15-K17 (phase_lookup): the lookups'
     permuted pairs (csrc/lookup_sort.cu) at a proof's 5 and a batch's 40
     rows of u = 8,183 on the compliance circuit's real compressed
     columns, the same with one entry moved out of the table (ok false),
     and random columns with heavy repeats, an all-equal column and rows
     of 0 and p - 1 (the batch's rows are these three cases'), and at the
     kernel's tile edges; the Montgomery conversions (csrc/convert.cu) both
     ways at a proof's (12, 8,192) and a batch's (8, 12, 8,192); the
     MSMs' window digits at a fixed-base chunk's 8 columns, chunks padded
     to 4, 2 and 1 columns, and keyed at the general MSMs' shapes; each
     timed (profiler);
  5. prove one compliance (Action) proof at k = 13 on the card with seeded
     blinds, cold (recording the selected share of every K3-family launch,
     as a histogram) and then warm, with the native (host) IPA open: counts
     of kernel launches are zeroed just before each proof and read just
     after; the proof must verify and equal, byte for byte, a second proof
     made through the plain versions on the card under the same seed. Then
     the same statement, warm, with the device IPA open (ipa="device"): it
     must equal the native-IPA proof byte for byte, launch K5 once per IPA
     round and K2 fewer than 400 times (each MSM weights its buckets in
     ec_bucket_weights launches, which both proofs must make, and the
     general MSMs' window Horners are ec_horner launches), and verify on the
     native engine and through the device MSM (msm_device="cuda"); the
     device MSM's final check must refuse it with its a0 changed, and the
     verifier must refuse it for a changed instance. A profiled device-IPA
     proof, which launches K1, K2, K4, K5, K8-K11, ec_seg_rounds,
     ec_horner and ec_bucket_weights,
     gives each kernel's device time per proof, the device's busy time and
     its number of device operations;
  6. print per-stage wall times of both warm proofs beside the card's name
     and power limit, one JSON line of per-kernel numbers (with each
     kernel's launches in a warm lockstep batch), and last
     {"ok": true, "device": {...}};
  7. (run between 5 and 6) the throughput paths: a lockstep batch of
     B = 8 compliance proofs at k = 13 (create_proofs_batch through
     prove_compliance_batch), cold and warm with stage times, the two
     byte-equal, all verified through the BatchVerifier, and a batch of one
     of phase 5's statement equal to phase 5's native-IPA proof; then the
     cross-batch pipeline (create_proofs_pipelined, chunks of 8, each
     chunk's multiopen and IPA tails on a side stream and a worker thread)
     over 16 compliance statements, whose first 8 proofs equal the warm
     batch, and over the first 8 followed by 4 trivial resource-logic
     circuits at k = 12 (a second proving key), whose compliance proofs
     equal the first run's and all of whose proofs verify; then
     prove_resource_logics_batch on 2 trivial circuits, whose verifying
     infos verify. Launch counts are zeroed before each batch and pipeline
     and read after; proofs per second of both paths are printed beside the
     warm single proof's time and the card's name and power limit. Last,
     the batch shapes' plain-version twin: a lockstep batch of 2 compliance
     proofs and prove_resource_logics_batch on the 2 trivial circuits, each
     equal byte for byte to the same call through the plain versions on the
     card under the same seeds (K1 is also held and timed at a batch of 8's
     width, 8 x 8n = 524,288 lanes, in phase 4);
  8. (run after 7) the transaction path: the keygens and device tables of
     the five logics new to it (token, signature verification, receiver,
     or-relation intent, partial-fulfillment intent; each timed); (a) the
     three example flows of taiga_tpu_torch/examples in transparent mode
     with the mock prover on the card, the first flow's nullifiers and
     output commitments (computed on the host) equal to a CPU run of the
     same seed, and one logic of each of the six classes they carry through the
     mock prover on the card and on the CPU, satisfied and broken, with
     equal gate masks and failure lists; (b) the three
     flows in shielded mode at k = 13 (compliance) and k = 12 (logics),
     seeded, each of which must pass Transaction.execute() and be refused
     with one byte of one resource-logic proof flipped, timed partial
     transaction by partial transaction with proofs per second, kernel
     launches counted over the three flows (zeroed before (b), read after
     it) and over one swap leg, and the peak device memory; (c)
     prove_resource_logics_batch on one swap leg's token and receiver
     logics through the kernels and through the plain versions on the
     card, byte-equal (K4 on the 10- and 13-column app tapes, K1 and the
     MSMs at k = 12);
  9. (run after 8) the node-facing surface: (a) the pyth Vamp-IR program of
     tests/test_vamp_ir.py as a resource logic at k = 12: its key (loaded
     from the disk cache or generated) and its device tables, timed; a cold
     proof through ResourceLogicByteCode("vamp_ir", ...).generate_proof;
     then one decoded circuit proved warm (launch counts zeroed just before,
     read just after) and through the plain versions on the card under the
     same seed, byte-equal (K4 on a new tape, K1 and the MSMs); each proof
     verifies against its carried vk and is refused with its first public
     input changed; (b) `python -m taiga_tpu_torch.service` as a child
     process with pipes, as a node starts it, timed from the spawn to its
     first PING reply, then fed {packet, 4} frames: a resource's round
     trip; phase 8's three shielded transactions, whose replies' anchors,
     nullifiers and commitments must equal execute() in this process; the
     three-party swap with one proof byte flipped (an error packet, and the
     next request still answered); each of its partial transactions; the
     transparent three-party swap of 8a composed by CREATE_TRANSACTION and
     verified (the child's mock prover on the card), with 8a's results; an
     unknown opcode (an error packet); its input closed, it must exit 0.
     Every request is timed. (c) the compliance key and the Vamp-IR key:
     whether this process loaded them from .pk_cache_torch/ or generated and
     stored them (a second run on one tree loads them), then a child
     process loads both with keygen forbidden; their verifying keys must
     equal this process's.
 10. (run after 9) the last modules: (a) the group law of ops/ec.py at
     4,096 lanes, on both fields, with identity, P = Q and P = -Q lanes:
     ec_add (K6), ec_double (the doubling kernel) and ec_scalar_mul_shared
     (one ec_ladder launch: K7 chained with the doubling, 255 steps)
     against their plain versions bit for bit and the host group law on
     sampled lanes, launch counts zeroed just before them and read after
     (the "group_law" path, fq's counts kept); ec_add_tree (K6 chained:
     each column's halving tree in one launch) at C x n = 1-3 x 1, 2, 8,
     64, at 1 x 8,192 (above the 4,096 points a block takes: one K6 level
     first) and at (f)'s 2 x 1,024, whose first level adds identities,
     P + P and P + (-P), against ec_add_tree_plain bit for bit and the
     host sum of every column; ec_ladder against ec_ladder_plain on both fields in
     both bit modes, a scalar shared by 4,096 lanes (0, 1, q and a random
     one) and a scalar a lane over (f)'s 2 x 1,024 lanes (0, 1, q - 1, q
     and 2^254 among random ones), identity lanes included, and the host
     group law on sampled lanes; K7 and the doubling single-step bit for
     bit at 1,024, 2,048 and 1,048,576 lanes; then K6 at 1,024 lanes,
     ec_add_tree at 2 x 1,024 (with its plain version's time, its bound
     and its chain of 10 dependent adds), K7
     and the doubling at those three widths and the ladder (shared at
     4,096 lanes, a scalar a lane at 2 x 1,024 and 1 x 1,024) timed, each
     ladder with one chain's length in product stages; (b) the list-based
     IPA open (host-int coefficients, opened by ipa_open_device) of a
     random polynomial at k = 13, whose bytes must equal ipa_open_device's
     and ipa_open_native's under one seed, verified and refused with a0 changed, timed, with its launches
     counted (zeroed just before, read after: the "ipa_list" path);
     multiopen_open_device is the hybrid multiopen with the device open,
     which phase 5's device-IPA proof runs; (d) the Poseidon kernels of
     csrc/poseidon.cu: permute_batch at 4,096 and 16,384 states against
     its plain version and the host permutation, and at 1,048,576 against
     the host permutation on sampled lanes; the sponge kernel
     (hash_n_batch) at lengths 1-8 against the host hash and at (4,096, 8)
     against its plain version and the host hash; merkle_root of 2^14
     leaves (the sponge a level) against its plain version and the host
     tree; each timed beside its plain version and its bound (the sparse
     form's 592 products a permutation, PR 8's 816 beside it); then the
     "poseidon" path, zeroed just before and read after: permute_batch at
     16,384 states (one launch), hash_n_batch at (4,096, 8) (one launch)
     and merkle_root of 2^14 leaves (14 launches); (e) the compliance
     key's fixed and sigma columns committed on the card
     (keygen.commit_columns) against the host engine's keygen, verifying
     keys equal, both timed; (f) the sharded layer at world 1 over NCCL in
     this process: sharded_msm_multi
     (Pippenger, and the bitserial ladder: one ec_ladder launch and one
     ec_add_tree launch, no K7, doubling or K6 launch; equal to Pippenger's
     and the host engine's MSM), ntt_mesh at k = 13,
     batch_hash_step, sharded_point_sum and prove_step against their
     unsharded counterparts, and a grouped create_proofs_batch of 2
     compliance proofs against the ungrouped batch byte for byte (the
     "parallel" path). World 1 runs the collectives but moves nothing
     between devices. The kernels line's "launches" is the count of each
     kernel's main path (its first path in KERNELS: phase 5's proof, or
     phase 10's), with every path's count beside it.

Usage: python3 chip_smoke.py [--seed 7]
Needs one CUDA device and the CUDA toolkit (nvcc); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import struct
import subprocess
import sys
import time

import numpy as np

K = 13              # the compliance proof's domain 2^K (core/constants.py)
N = 1 << K          # lanes of the edge-case checks of K1-K3: the SRS size
# Each kernel is timed at the width of its widest launch in a warm proof:
W_MONT_MUL = 8 * N            # the quotient's division by Z_H over the 8n coset
BATCH = 8                     # a lockstep batch, and a chunk of the pipeline (bench.py's B)
W_MONT_MUL_BATCH = BATCH * W_MONT_MUL  # the same division over a batch's B cosets
W_EC_ADD = 8 * 32 * N // 2    # msm._blocked_partials: first tree level, 8 columns x 32 windows
W_EC_ADD_SEL = 8 * 256 * 128  # msm._blocked_partials: 8 x 256 mixed blocks of 128 lanes
SEL_CASES = ("half", "zero", "one", "1in32")  # K3's selections: K3 is timed at each
# ec_seg_rounds at the shapes of a fixed-base chunk (8 columns, c = 8, k = 13)
# of msm._blocked_partials: phase B, the mixed blocks' rounds (tile 128),
# and phase C, the merge's rounds over 16,384 block sums + 4,096 partials
SEG_COLS, SEG_BUCKETS, SEG_BLOCK = 8, 256, 128
W_FOLD = N // 2               # the IPA's first generator fold
FOLD_WIDTHS = (W_FOLD, 100, 1)  # the widest fold, and widths below and off a block
# ec_horner's shapes (W terms, doublings, L columns): the window Horner of
# msm (1 column) and msm_multi (2) in a proof; the bit Horners of a
# fixed-base chunk (8 columns) and of msm's and msm_multi's buckets (32 and
# 64 columns: 2 and 4 blocks), which ec_bucket_weights runs now, held as
# before. The kernels line reports the second
HORNER_SHAPES = ((32, 8, 1), (32, 8, 2), (8, 1, 8), (8, 1, 32), (8, 1, 64))
# ec_bucket_weights' columns of 2^8 buckets: a fixed-base chunk (8 columns,
# the main path's), and msm's 32 windows (the general MSM's)
BUCKET_COLS = (8, 32)
BUCKET_COLS_WIDE = 70000  # columns of 2 buckets: above a grid's second axis (65,535)
MAX_K2_DEVICE_IPA = 400  # K2 launches a warm device-IPA proof may make
IMAD_PER_S = 67e12 / 4  # 32-bit integer multiply-adds/s, see bound_ms()
HBM_BYTES_PER_S = 3.35e12
MM_IMADS = 2 * 2 * 64 + 8  # one 8x32-bit CIOS product: lo+hi of 128 word products, 8 m's
WIDE_IMADS = 2 * 64  # one 256 x 256-bit product left unreduced: lo+hi of 64 word products
REDC_IMADS = MM_IMADS - WIDE_IMADS  # one Montgomery reduction: 8 rows of 8 word products, 8 m's
EVAL_RUN = 8  # K12's terms of a dot product summed unreduced before one reduction
KERNEL_SYMBOLS = {  # each kernel's device function, as the profiler names it
    "mont_mul": ("k_mont_mul",),
    "ec_add_proj": ("k_ec_add_proj",),
    "ec_add_proj_sel": ("k_ec_add_sel",),
    "ec_seg_rounds": ("k_ec_seg_rows", "k_ec_seg_tile"),
    "tape_eval": ("k_tape_eval",),
    "ec_fold_shared": ("k_ec_fold_shared",),
    "ec_horner": ("k_ec_horner",),
    "ec_bucket_weights": ("k_ec_bucket_weights",),
    "ec_add": ("k_ec_add_jac",),
    "ec_add_tree": ("k_ec_add_tree",),
    "ec_add_select": ("k_jac_add_select",),
    "ec_ladder": ("k_jac_ladder",),
    "ec_double": ("k_ec_double_jac",),
    "poseidon": ("k_poseidon_permute",),
    "poseidon_sponge": ("k_poseidon_sponge",),
    "mont_inv": ("k_mont_inv",),
    "mont_cumprod": ("k_cumprod_cluster", "k_cumprod_totals", "k_cumprod_apply"),
    "powers": ("k_powers",),
    "perm_terms": ("k_perm_terms",),
    "lookup_terms": ("k_lookup_terms",),
    "ntt": ("k_ntt_pass",),
    "eval_polys": ("k_eval_polys", "k_eval_reduce"),
    "linear_combo": ("k_linear_combo",),
    "synthetic_div": ("k_div_totals", "k_div_apply"),
    "permute_pairs": ("k_lookup_sort", "k_lookup_rank", "k_lookup_counts", "k_lookup_leftovers",
                      "k_lookup_fill"),
    "from_mont": ("k_from_mont",),
    "msm_digits": ("k_msm_digits",),
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


def once_ms(fn):
    """fn() run once, and its stream time between two CUDA events: a plain
    version's run that is both compared and timed (it takes seconds)."""
    import torch

    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


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
    # the trace's raw events: prof.events() would first build a tree of
    # every event in Python, about a minute for a proof's 300,000 operations
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        busy += ms
        ops += 1
        name_e = e.name()
        for name, syms in KERNEL_SYMBOLS.items():
            if any(s in name_e for s in syms):
                per[name].append(ms)
    return per, busy, ops


TRACES: dict[str, int] = {}


def kernel_ms(name: str, fn, reps: int, per_call: int = 1) -> float:
    """Device time per launch of kernel `name`, over `reps` calls of fn
    (each launching it `per_call` times), from the profiler: the wrapper's
    host work between launches is not counted. The trace may miss launches
    now and then (once it lost all 150 of a window), so the mean is over the
    launches it saw, at least half; a trace that saw fewer is taken again,
    up to three traces. TRACES[name] keeps the most traces any timing of
    the kernel needed (the kernels line reports it)."""
    fn()
    for n in range(1, 4):
        per, _, _ = device_trace(lambda: [fn() for _ in range(reps)])
        seen = per[name]
        if 2 * len(seen) >= reps * per_call:
            TRACES[name] = max(TRACES.get(name, 0), n)
            return sum(seen) / len(seen)
        log(f"  {name}: the profiler saw {len(seen)} of {reps * per_call} launches; tracing again")
    raise AssertionError(f"{name}: three traces each saw under half of {reps * per_call} launches")


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
            fn = re.search(r"(k_[a-z0-9_]+?)(I((?:L[bi]\d+E)+)E)?E", line)
            if "Compiling entry function" in line and fn:
                args = re.findall(r"L[bi](\d+)E", fn.group(3) or "")
                log(f"  {name}.cu: {fn.group(1)}" + (f"<{', '.join(args)}>" if args else ""))
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
    # a proof's launch (the row's numbers) and a lockstep batch's (its batch_ keys)
    k1 = {}
    for B in (W_MONT_MUL, W_MONT_MUL_BATCH):
        a, b = wide_fe(gen, B, dev), wide_fe(gen, B, dev)
        got = FK.mont_mul_lm(a, b, "fp")
        with FK.plain_versions():
            errs.append(compare(f"mont_mul[fp, B={B}]", (got,), (FK.mont_mul_lm(a, b, "fp"),)))
            pms = cuda_ms(lambda: FK.mont_mul_lm(a, b, "fp"), 3)
        ms = kernel_ms("mont_mul", lambda: FK.mont_mul_lm(a, b, "fp"), 200)
        k1[B] = dict(ms=ms, plain_ms=pms, bound=bound_ms(3 * fe * B, MM_IMADS * B))
        log(f"K1 mont_mul        at B={B}: equal; {ms:.6f} ms per launch (plain {pms:.3f} ms, "
            f"bound {k1[B]['bound'][0]:.6f} ms by {k1[B]['bound'][1]})")
    res["mont_mul"] = dict(err=max(errs), B=W_MONT_MUL, batch=k1[W_MONT_MUL_BATCH],
                           **k1[W_MONT_MUL])
    log(f"K1 mont_mul        equal on fp and fq at B={N}, and on fp at a proof's "
        f"B={W_MONT_MUL} and a batch's B={W_MONT_MUL_BATCH}")

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
    res.update(phase_bucket_weights(gen, dev))
    res.update(phase_grand_products(pk, gen, dev))
    res.update(phase_ntt(gen, dev))
    res.update(phase_poly(pk, gen, dev))
    res.update(phase_lookup(pk, gen, seed, dev))
    return res


def seg_selected(keys, rounds: int, tile: int):
    """The adds of each round of ec_seg_rounds over keys (..., n): round
    r's lanes at offsets divisible by 2^(r+1) from their run's start whose
    lane i + 2^r is in their run (the aligned adds the function needs), as
    a (rounds,) tensor (0 from the first round with none)."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK

    counts = [i.numel() for i in FK.seg_adds(keys, rounds, tile)]
    return torch.tensor(counts + [0] * (rounds - len(counts)))


def seg_selected_hs(keys, rounds: int, tile: int) -> int:
    """The lanes the Hillis-Steele rounds selected (same run at distance
    2^r, every round), which the earlier per-round kernels computed and
    their bound charged: printed beside the aligned adds, so that the row
    compares with theirs."""
    import torch

    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    total = 0
    for r in range(rounds):
        s = 1 << r
        same = (idx + s < n) & (keys == torch.roll(keys, -s, dims=-1))
        if tile:
            same &= idx % tile + s < tile
        total += int(same.sum())
    return total


def seg_keys(gen, dev):
    """Keys of ec_seg_rounds as _blocked_partials makes them for one
    fixed-base chunk: SEG_COLS columns of 32 windows x N random digits,
    keyed col * SEG_BUCKETS + digit and sorted (runs of ~1,000 lanes); phase
    B gathers the 128-lane blocks that hold a run edge (at most
    SEG_COLS * SEG_BUCKETS) under block-local keys; phase C sorts the
    uniform blocks' keys with the in-block run starts (where none, a key
    of its own above every bucket's, as _blocked_partials gives them)."""
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
    sk = sent + torch.arange(nb + ecap, dtype=keys.dtype, device=dev)  # a key a spare lane
    mkey = sk[nb:].clone()
    mkey[:min(ecap, starts.numel())] = gkey[starts[:ecap]]
    ukey = torch.where(mixed, sk[:nb], lo)
    phase_c = torch.sort(torch.cat([ukey, mkey])).values.contiguous()
    return phase_b, phase_c


def row_keys(gen, dev):
    """Keys of ec_seg_rounds as the general MSMs (msm, msm_multi: the
    device IPA's and the device-MSM verifier's) give them, one row of n
    lanes a window: 32 windows of c = 8 digits, each row sorted. At n =
    2,048 msm._window_reduce runs log2 n rounds in place; at n = 4,096
    msm._compact runs 6 rounds (CHUNK), gathers each run's partials at
    stride CHUNK into 1,024 lanes (beyond them a key a lane above every
    digit) and runs 10 rounds there. Returns {name: (keys, rounds)}."""
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
    cd = torch.where(pos < n, TM._take(d4, pos.clamp(max=n - 1)),
                     (1 << c) + torch.arange(size, device=dev))
    out["rows 32 x 1024, compacted"] = (cd.contiguous(), size.bit_length() - 1)
    return out


def long_run_keys(gen, dev):
    """Keys of ec_seg_rounds' row form whose runs span many 128-lane
    blocks, so that a round reads lanes another block wrote before the
    grid-wide barrier: 32 x 2,048 digits of 3 values (runs of ~680 lanes)
    at 11 rounds, and one row of 131,072 lanes under one key (more spans
    than the card holds blocks) at 18 rounds, the last with no add.
    Returns {name: (keys, rounds)}."""
    import torch

    d3 = torch.sort(torch.randint(0, 3, (32, 2048), generator=gen, device=dev), -1).values
    one = torch.zeros((1, 1 << 17), dtype=torch.int64, device=dev)
    return {"rows 32 x 2048 of 3 digits": (d3.contiguous(), 11),
            "row 1 x 131072 of one key": (one, 18)}


def phase_select(rng, gen, dev, err_edges):
    """K3 (ec_add_proj_sel) and K3 chained (ec_seg_rounds) against their
    plain versions, bit for bit; then timed. K3 at its widest launch with
    half the lanes selected at random, none, all, and one in 32; the rounds
    at phase B's shape (the tile form, and the row form) and phase C's, and
    at the general MSMs' rows of windows (row_keys), on every lane and both
    fields: one launch a call in either form."""
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
            if tile:  # the tile form equals the row form where no run crosses a tile
                err = max(err, compare(f"ec_seg_rounds[{field}, phase {ph}, row form]",
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
    long_runs = long_run_keys(gen, dev)
    for field in ("fp", "fq"):  # checked, not timed
        for name, (keys, rounds) in long_runs.items():
            p = [wide_fe(gen, keys.numel(), dev).view((16,) + tuple(keys.shape))
                 for _ in range(3)]
            got = FK.ec_seg_rounds_lm(*p, keys, rounds, field)
            with FK.plain_versions():
                want = FK.ec_seg_rounds_lm(*p, keys, rounds, field)
            err = max(err, compare(f"ec_seg_rounds[{field}, {name}]", got, want))
    log(f"ec_seg_rounds      long runs ({', '.join(long_runs)}): equal on fp and fq")
    del long_runs

    def seg_ms(p, keys, rounds, tile):
        return kernel_ms("ec_seg_rounds",
                         lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile), 10)

    cases = [(f"phase {ph}", out[ph], keys, rounds, tile)
             for ph, (keys, rounds, tile) in shapes.items()]
    cases += [(name, out[name], keys, rounds, 0) for name, (keys, rounds) in rows.items()]
    for name, p, keys, rounds, tile in cases:
        B = keys.numel()
        ms = seg_ms(p, keys, rounds, tile)
        with FK.plain_versions():
            pms = cuda_ms(lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile), 1)
        per = seg_selected(keys, rounds, tile)
        adds, hs = int(per.sum()), seg_selected_hs(keys, rounds, tile)
        bound = bound_ms(fe * 6 * B + 8 * B, 12 * MM_IMADS * adds)
        hs_bound = bound_ms(fe * 6 * B + 8 * B, 12 * MM_IMADS * hs)[0]
        row_form = ""
        if tile:  # the same rounds in the row form (equal on these keys: checked above)
            row_form = f"; the row form {seg_ms(p, keys, rounds, 0):.6f} ms"
        log(f"ec_seg_rounds      {name}: {tuple(keys.shape)} lanes, {rounds} rounds"
            f"{f', tile {tile}' if tile else ''}, {adds} aligned adds in "
            f"{int((per > 0).sum())} rounds with any (the Hillis-Steele rounds selected {hs}: "
            f"bound {hs_bound:.6f} ms), equal on fp and fq; {ms:.6f} ms in one launch"
            f"{row_form} (bound {bound[0]:.6f} ms by {bound[1]}; plain {pms:.3f} ms)")
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


def horner_terms(rng, field: str, dev, shapes):
    """Terms (16, W, Lc) x 3 of ec_horner for each (W, d, Lc) of shapes:
    curve points scaled by random z, the identity as column 0's most
    significant term (the chain starts at the identity) and as its term 1,
    and in the last column a term 0 equal to the negation of the sum it is
    added to (the last add meets its own negation: the result is the
    identity). Those sums come from one plain run for the shapes that share
    (W, d), their last columns side by side (columns are independent).
    Returns {(W, d, Lc): terms}."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L

    spec = L.FIELDS[field]
    one = torch.as_tensor(L.int_to_limbs(spec.r), device=dev)
    out = {}
    for W, d, Lc in shapes:
        p1, _ = point_inputs(rng, field, dev)
        perm = torch.as_tensor(7 + rng.permutation(N - 7)[:W * Lc], device=dev)  # no edge lane
        t = [v.index_select(1, perm).reshape(16, W, Lc).contiguous() for v in p1]
        for w in (W - 1, 1):
            t[0][:, w, 0], t[1][:, w, 0], t[2][:, w, 0] = 0, one, 0
        out[(W, d, Lc)] = t
    for W, d in dict.fromkeys((W, d) for W, d, _ in shapes):
        group = [out[sh] for sh in shapes if sh[:2] == (W, d)]
        last = [torch.cat([t[v][:, 1:, -1:] for t in group], 2).contiguous() for v in range(3)]
        with FK.plain_versions():  # the sums before the last adds, then their negations
            acc = FK.ec_horner_lm(*last, d, field)
            for _ in range(d):
                acc = FK.ec_add_proj_lm(*acc, *acc, field)
        neg = L.neg(acc[1].T.contiguous(), spec)
        for j, t in enumerate(group):
            t[0][:, 0, -1], t[2][:, 0, -1] = acc[0][:, j], acc[2][:, j]
            t[1][:, 0, -1] = neg[j]
    return out


def phase_horner(rng, dev):
    """ec_horner (K2 chained, one launch per Horner) against its plain
    version, the loop of K2 adds it replaces, bit for bit on both fields at
    the MSMs' shapes; then timed at each (see LONG_LAUNCH)."""
    from taiga_tpu_torch.ops import ff_kernels as FK

    fe = 16 * 4
    err, timed, pms = 0, {}, None
    for field in ("fp", "fq"):
        terms = horner_terms(rng, field, dev, HORNER_SHAPES)
        for (W, d, Lc), t in terms.items():
            got = FK.ec_horner_lm(*t, d, field)
            with FK.plain_versions():  # the reported shape's plain run is timed too
                want, ms = once_ms(lambda: FK.ec_horner_lm(*t, d, field))
            if field == "fq" and (W, d, Lc) == HORNER_SHAPES[1]:
                pms = ms
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
            log(f"    plain version (the loop of {adds} K2 adds) {pms:.3f} ms")
            res["ec_horner"] = dict(err=err, ms=ms, plain_ms=pms, B=(W, d, Lc), bound=bound)
    return res


def phase_bucket_weights(gen, dev):
    """ec_bucket_weights (each bit row's aligned tree and the Horner over
    the bits, one launch) against its plain version, bit for bit on both
    fields, at BUCKET_COLS columns of 2^8 buckets: random elements with
    about one bucket in 20 and every bucket 0 the identity (0 : 1 : 0), as
    _bucket_sums masks a bucket no digit hit; then timed at each (CUDA
    events, as ec_horner: one launch is a dependent chain)."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, msm as TM

    fe, c = 16 * 4, 8
    err, timed = 0, {}
    for field in ("fp", "fq"):
        for Lc in BUCKET_COLS:
            M = Lc << c
            keep = torch.rand(M, generator=gen, device=dev) >= 0.05
            keep[::1 << c] = False
            b = [v.contiguous() for v in
                 TM._mask_identity(*(wide_fe(gen, M, dev) for _ in range(3)), keep, field)]
            got = FK.ec_bucket_weights_lm(*b, c, field)
            with FK.plain_versions():  # timed too: the plain time of fq's rows
                want, pms = once_ms(lambda: FK.ec_bucket_weights_lm(*b, c, field))
            err = max(err, compare(f"ec_bucket_weights[{field}, L={Lc}]", got, want))
            if field == "fq":
                timed[Lc] = b, pms
        # more columns than a grid's second axis holds (65,535), at c = 1
        b = [wide_fe(gen, 2 * BUCKET_COLS_WIDE, dev) for _ in range(3)]
        got = FK.ec_bucket_weights_lm(*b, 1, field)
        with FK.plain_versions():
            want = FK.ec_bucket_weights_lm(*b, 1, field)
        err = max(err, compare(f"ec_bucket_weights[{field}, L={BUCKET_COLS_WIDE}, c=1]", got,
                               want))
    res = {}
    for Lc, (b, pms) in timed.items():
        ms = cuda_ms(lambda: FK.ec_bucket_weights_lm(*b, c, "fq"), 20)
        adds = c * ((1 << c) - 1) + 2 * (c - 1)  # the bit rows' trees, the Horner
        bound = bound_ms(3 * fe * (Lc << c) + 3 * fe * Lc, 12 * MM_IMADS * adds * Lc)
        log(f"ec_bucket_weights  equal on fp and fq at L={Lc} columns of 2^{c} buckets: "
            f"{adds} adds a column (a chain of {c} tree levels and {2 * (c - 1)} Horner adds, "
            f"{2 * (c + 2 * (c - 1))} product stages); {ms:.6f} ms per launch (bound "
            f"{bound[0]:.6f} ms by {bound[1]}; plain {pms:.3f} ms)")
        if Lc == BUCKET_COLS[0]:
            res["ec_bucket_weights"] = dict(err=err, ms=ms, plain_ms=pms, B=(Lc, c), bound=bound)
    return res


# K8's chain (csrc/grand_product.cu k_mont_inv): 20 batches of 30 divsteps,
# each batch's matrix update, one product by R^3; and the 32-bit operations
# a lane needs: a divstep's masks, conditional negations, adds and shifts
# (DIVSTEP_OPS), a batch's update of (d, e) and (f, g) (10 word products a
# limb, lo and hi, over 9 limbs), the product (the Fermat chain the kernel
# ran before was 254 + 75 products of MM_IMADS, 329 stages)
INV_DIVSTEPS, INV_BATCHES = 600, 20
INV_STAGES = INV_DIVSTEPS + INV_BATCHES + 1
DIVSTEP_OPS = 27
INV_OPS = INV_DIVSTEPS * DIVSTEP_OPS + INV_BATCHES * 10 * 9 * 2 + MM_IMADS
INV_EDGE_C = (1, 4, 32, 37, 64)  # K8's lanes: a proof's 4, a batch's 32, and off a warp
# K9's row lengths: a one-block tile of 512 (4 a thread) less one, at and
# past it, the old tiles' 1,024 edges, a proof's row plus one, the longest
# row of one launch (a cluster of 16 blocks, 8 a thread: ff_kernels
# CUMPROD_ONE_LAUNCH_N) and one more (the two passes)
SCAN_EDGE_N = (1, 2, 7, 511, 512, 513, 1024, 1025, 2049, 8193, 16384, 16385)
# K9's powers: rows about the main path's T = 128 (ff_kernels.powers_table_log
# of 8,191: 7), the x3 evaluation's 8,191, K14's 8,193, and T^2 + 1 = 16,385
POWERS_EDGE_N = (1, 2, 127, 128, 129, 8191, 8193, 16385)
# K9's powers at the main path's calls, (what, points, n, packed): a proof's
# query evaluations (6 points) and x3 evaluation (1), both K12's packed
# tables, and K14's limbs tables (6 points of 2^13 + 1); a batch's the same
# for 8 proofs
POWERS_SHAPES = (("query evals", 6, N - 1, True), ("x3", 1, N - 1, True),
                 ("K14 tables", 6, N + 1, False), ("query evals", 6 * BATCH, N - 1, True),
                 ("x3", BATCH, N - 1, True), ("K14 tables", 6 * BATCH, N + 1, False))


def rows_fe(gen, shape, spec, dev, edge_at=0):
    """Element-major (..., 16) random canonical elements (< 2^254 < p) drawn
    on the card, with 0, 1 (R mod p) and p - 1 from the flat lane edge_at
    on (None: no edge lanes)."""
    import torch
    from taiga_tpu_torch.ops import limbs as L

    x = wide_fe(gen, math.prod(shape), dev).T.contiguous()
    if edge_at is not None:
        for i, v in enumerate((0, spec.r, spec.modulus - 1)[: x.shape[0] - edge_at]):
            x[edge_at + i] = torch.as_tensor(L.int_to_limbs(v), device=dev)
    return x.view(*shape, 16)


def phase_grand_products(pk, gen, dev):
    """K8 (mont_inv), K9 (mont_cumprod) and K10 (perm_terms, lookup_terms)
    against their plain versions bit for bit, at the shapes of a single
    proof and of a lockstep batch of BATCH (C = proofs x chunks or x
    lookups rows of n = 2^K) and at the edges: the lanes 0, 1 and p - 1; K8
    on both fields and at batch_inv's (1, 16) in Fq; K9 forward and reverse
    with a zero in a row, at SCAN_EDGE_N, at an expanded row (stride 0) and
    at the fixed-base table's 262,144 lanes in Fq; K9's powers entry at
    POWERS_EDGE_N on both fields, limbs and packed; K8 at INV_EDGE_C lanes
    on both fields with 0, 1 and p - 1 first. Then each timed at both
    shapes (the profiler's device time, a call's launches summed, counted
    by the wrappers), and the powers at POWERS_SHAPES."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L
    from taiga_tpu_torch.plonk.circuit import PERM_CHUNK
    from taiga_tpu_torch.plonk.protocol import num_chunks

    vk = pk.vk
    P, nlk, nc = len(vk.perm_cols), len(vk.cs.lookups), num_chunks(vk.perm_cols)
    fe, n = 16 * 4, N
    res, err = {}, 0

    def held(name, got, plain):
        nonlocal err
        with FK.plain_versions():
            want, ms = once_ms(plain)
        got = got if isinstance(got, tuple) else (got,)
        err = max(err, compare(name, got, want if isinstance(want, tuple) else (want,)))
        return ms

    # K8: both fields' edges (0, 1, p - 1 in the first lanes; batch_inv's
    # one Fq lane), lanes on and off a warp's 32
    for field in ("fp", "fq"):
        for C in INV_EDGE_C:
            a = rows_fe(gen, (C,), L.FIELDS[field], dev)
            held(f"mont_inv[{field}, {C} lanes]", FK.mont_inv_lm(a, field),
                 lambda: FK.mont_inv_lm(a, field))
    # K9: row lengths at and across the tiles' and clusters' edges, a zero in a row
    for field in ("fp", "fq"):
        for m in SCAN_EDGE_N:
            a = rows_fe(gen, (3, m), L.FIELDS[field], dev)
            a[1, m // 2] = 0
            for rev in (False, True):
                held(f"mont_cumprod[{field}, 3 x {m}, reverse={rev}]",
                     FK.mont_cumprod_lm(a, field, rev), lambda: FK.mont_cumprod_lm(a, field, rev))
    x = rows_fe(gen, (3,), L.FP, dev)
    pw = x.expand(n - 1, 3, 16).movedim(0, -2)  # an expanded row: stride 0 along the scan
    held("mont_cumprod[powers' layout]", FK.mont_cumprod_lm(pw), lambda: FK.mont_cumprod_lm(pw))
    zs = rows_fe(gen, (1, 32 * n), L.FQ, dev)  # fixed_base_table's batch_inv: W x N lanes
    zs[0, :3] = zs[0, 3:6]  # nonzero, as the table's z
    held("mont_cumprod[fq, batch_inv]", FK.mont_cumprod_lm(zs, "fq"),
         lambda: FK.mont_cumprod_lm(zs, "fq"))
    # K9's powers entry: the points 0, 1 and p - 1 and a random one, limbs and packed
    for field in ("fp", "fq"):
        pts = rows_fe(gen, (4,), L.FIELDS[field], dev)
        for m in POWERS_EDGE_N:
            for packed in (False, True):
                held(f"powers[{field}, 4 x {m}{', packed' if packed else ''}]",
                     FK.powers_lm(pts, m, field, packed),
                     lambda: FK.powers_lm(pts, m, field, packed))
    pw_res = {}
    for what, Q, m, packed in POWERS_SHAPES:
        pts = rows_fe(gen, (Q,), L.FP, dev)

        def fn(pts=pts, m=m, packed=packed):
            return FK.powers_lm(pts, m, "fp", packed)

        plain = held(f"powers[{what}, {Q} x {m}{', packed' if packed else ''}]", fn(), fn)
        before = FK.powers_lm.launches
        fn()
        per_call = FK.powers_lm.launches - before
        ms = per_call * kernel_ms("powers", fn, 20, per_call)
        # Q n elements written (32 B packed, 64 as limbs), Q read, Q (n - 1) products
        words = 8 if packed else 16
        bound = bound_ms(4 * words * Q * m + fe * Q, MM_IMADS * Q * (m - 1))
        pw_res[f"{what} Q={Q}, n={m}"] = dict(ms=ms, plain_ms=plain, bound=bound,
                                             launches=per_call, B=(Q, m, words))
        log(f"powers             {what:12s} ({Q}, {m}{', packed' if packed else ''}): equal; "
            f"{ms:.6f} ms a call of {per_call} launch (plain {plain:.3f} ms, bound "
            f"{bound[0]:.6f} ms by {bound[1]})")

    # the grand products' shapes: one proof (the row) and a batch (its batch_ keys)
    for B in (1, BATCH):
        key = "row" if B == 1 else "batch"
        cols = rows_fe(gen, (B, P, n), L.FP, dev)
        sigma, omega = rows_fe(gen, (P, n), L.FP, dev), rows_fe(gen, (n,), L.FP, dev)
        # beta, gamma: the edges on the batch's last proofs, none at a proof's
        # shape, so every proof but those has each term of the products
        edge = B - 3 if B > 3 else None
        beta, gamma = (rows_fe(gen, (B,), L.FP, dev, edge) for _ in range(2))
        delta = rows_fe(gen, (P,), L.FP, dev)
        pin = (cols, sigma, omega, beta, gamma, delta)
        num, den = FK.perm_terms_lm(*pin, PERM_CHUNK)
        p_plain = held(f"perm_terms[B={B}]", (num, den), lambda: FK.perm_terms_lm(*pin, PERM_CHUNK))
        lk = [rows_fe(gen, (B, nlk, n), L.FP, dev) for _ in range(4)]
        lin = (*lk, beta, gamma)
        l_plain = held(f"lookup_terms[B={B}]", FK.lookup_terms_lm(*lin),
                       lambda: FK.lookup_terms_lm(*lin))
        rows = num.reshape(B * nc, n, 16)
        s_plain = held(f"mont_cumprod[B={B}]", FK.mont_cumprod_lm(rows),
                       lambda: FK.mont_cumprod_lm(rows))
        held(f"mont_cumprod[B={B}, reverse]", FK.mont_cumprod_lm(rows, reverse=True),
             lambda: FK.mont_cumprod_lm(rows, reverse=True))
        tot = rows[:, -1].contiguous()
        i_plain = held(f"mont_inv[B={B}]", FK.mont_inv_lm(tot), lambda: FK.mont_inv_lm(tot))

        before = FK.mont_cumprod_lm.launches
        FK.mont_cumprod_lm(rows)
        per_call = FK.mont_cumprod_lm.launches - before  # K9's launches a call
        ms = {"mont_inv": kernel_ms("mont_inv", lambda: FK.mont_inv_lm(tot), 20),
              "mont_cumprod": per_call * kernel_ms("mont_cumprod",
                                                   lambda: FK.mont_cumprod_lm(rows), 20,
                                                   per_call),
              "perm_terms": kernel_ms("perm_terms", lambda: FK.perm_terms_lm(*pin, PERM_CHUNK),
                                      20),
              "lookup_terms": kernel_ms("lookup_terms", lambda: FK.lookup_terms_lm(*lin), 20)}
        C, Cl = B * nc, B * nlk
        bounds = {
            "mont_inv": bound_ms(2 * fe * C, INV_OPS * C),
            "mont_cumprod": bound_ms(2 * fe * C * n, (n - 1) * MM_IMADS * C),
            # beta delta^j once a (proof, column); then 4 products a column,
            # less each chunk's first two, an element
            "perm_terms": bound_ms(fe * ((B + 1) * P * n + n + 2 * B + P + 2 * C * n),
                                   ((4 * P - 2 * nc) * B * n + B * P) * MM_IMADS),
            "lookup_terms": bound_ms(fe * 6 * Cl * n, 2 * MM_IMADS * Cl * n)}
        plain = {"mont_inv": i_plain, "mont_cumprod": s_plain, "perm_terms": p_plain,
                 "lookup_terms": l_plain}
        shapes = {"mont_inv": (C, 16), "mont_cumprod": (C, n, 16), "perm_terms": (B, P, n, 16),
                  "lookup_terms": (B, nlk, n, 16)}
        for name in ms:
            calls = f" of {per_call} launches" if name == "mont_cumprod" else ""
            log(f"{name:18s} at {shapes[name]}: equal; {ms[name]:.6f} ms a call{calls} (plain "
                f"{plain[name]:.3f} ms, bound {bounds[name][0]:.6f} ms by {bounds[name][1]})"
                + (f"; one chain of {INV_STAGES} dependent steps ({INV_DIVSTEPS} divsteps, "
                   f"{INV_BATCHES} updates, a product), {ms[name] / INV_STAGES * 1e3:.4f} us a "
                   f"step" if name == "mont_inv" else ""))
            res.setdefault(name, {})[key] = dict(ms=ms[name], plain_ms=plain[name],
                                                 bound=bounds[name], B=shapes[name])
    edge_n = "/".join(map(str, SCAN_EDGE_N))
    log(f"K8-K10 equal to their plain versions on every lane: K8 on fp and fq at "
        f"{'/'.join(map(str, INV_EDGE_C))} lanes with 0, 1 and p - 1, K9 at 3 x {edge_n} "
        f"both ways with a zero, at powers' layout and at 1 x "
        f"{32 * n} in fq, its powers at 4 x {'/'.join(map(str, POWERS_EDGE_N))} on both "
        f"fields (the points 0, 1, p - 1), limbs and packed, and all at a proof's and a batch "
        f"of {BATCH}'s shapes ({nc} chunks of {P} permutation columns and {nlk} lookups a proof)")
    out = {name: dict(err=err, **by["row"], batch=by["batch"]) for name, by in res.items()}
    first = next(iter(pw_res.values()))
    out["powers"] = dict(err=err, **first, batch=pw_res[f"query evals Q={6 * BATCH}, n={n - 1}"],
                         shapes={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                                         bound_ms=v["bound"][0], bound_by=v["bound"][1],
                                         launches=v["launches"]) for k, v in pw_res.items()})
    return out


NTT_SHAPES = (  # K11 at the main path's calls: (what, batch shape, k, inverse, coset, field)
    ("intt", (1, 12), K, True, None, "fp"),            # values_to_coeffs: a proof's 12 advice columns
    ("coset_ntt", (1, 12), K + 3, False, 5, "fp"),     # to_ext: a proof's advice, n / 8 nonzero
    ("coset_ntt", (BATCH, 12), K + 3, False, 5, "fp"),  # to_ext: a batch's advice
    ("coset_intt", (BATCH, 1), K + 3, True, 5, "fp"),  # quotient_coeffs_batch: a batch's quotients
    ("intt", (2,), K, True, None, "fq"),               # one Fq shape
    ("intt", (BATCH, 12), K, True, None, "fp"),        # values_to_coeffs: a batch's advice
)


def ntt_bound(rows: int, k: int, inverse: bool, coset, nonzero: int):
    """K11's bound: each input element read once (the rows' first
    `nonzero`: to_ext passes only its coefficients) and each output
    element written once (64 B each), and the tables read once; the
    products the function needs on rows nonzero only in their first
    `nonzero` elements: a radix-2 decimation in frequency's butterflies
    with a nonzero element, less the one whose twiddle is 1 in each group
    (k n / 2 - (n - 1) on dense rows), and the scales' (the forward coset's
    on the nonzero inputs, the inverse's on every output)."""
    n = 1 << k
    tables = 32 * (n // 2 + (n if coset is not None else 1 if inverse else 0))
    # stage s: 2^(s-1) groups, each nonzero in its first min(nonzero, 2 d)
    # elements, pairs (i, i + d) with d = n / 2^s
    butterflies = sum((1 << s - 1) * (min(nonzero, n >> s) - 1) for s in range(1, k + 1))
    scale = n if inverse else (nonzero if coset is not None else 0)
    return bound_ms(64 * rows * (nonzero + n) + tables, rows * (butterflies + scale) * MM_IMADS)


def phase_ntt(gen, dev):
    """K11 (ntt_lm, csrc/ntt.cu) against its plain version (ntt.ntt_plain)
    bit for bit, each case at radix 4 and at radix 2
    (ff_kernels.ntt_radix_log's two choices, each forced here): every k
    from 1 to 18 on both fields in all four transforms; rows of 0, 1 (R mod
    p) and p - 1; a moved axis as ntt_mesh passes it; rows that hold only
    their first `nonzero` elements (the rest read as zero) against
    ntt_plain of the rows padded with zeros: n / 8 (to_ext's: at radix 4
    the kernel skips the butterflies of two zeros), n / 8 + 1, and 1, at k
    = 4 and K + 3 on both fields; then the main path's shapes at the radix
    ntt_radix_log picks (NTT_SHAPES; the forward coset NTTs on n / 8
    nonzero inputs, as to_ext passes them), each timed (profiler device
    time, a call's launches summed) beside the plain version's time. k = 0
    and 19 raise on the card."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L, ntt as NT

    kinds = {"ntt": (False, None), "intt": (True, None), "coset_ntt": (False, 5),
             "coset_intt": (True, 5)}
    err = 0

    def held(what, x, k, field, inverse, coset, nonzero=None):
        nonlocal err
        got = FK.ntt_lm(x, k, field, inverse, coset, nonzero)
        if nonzero is not None:  # the plain version of the padded rows
            x = torch.cat([x, x.new_zeros(x.shape[:-2] + ((1 << k) - nonzero, 16))], dim=-2)
        want, ms = once_ms(lambda: NT.ntt_plain(x, k, field, inverse, coset))
        err = max(err, compare(f"ntt[{what}]", (got,), (want,)))
        return ms

    t0 = time.perf_counter()
    radix_log = FK.ntt_radix_log
    try:  # each case at each of ntt_radix_log's two choices, forced
        for logr in (2, 1):
            FK.ntt_radix_log = lambda *_, logr=logr: logr
            at = f"radix {1 << logr}"
            for field in ("fp", "fq"):
                spec = L.FIELDS[field]
                for k in range(1, FK.NTT_K_MAX + 1):
                    x = rows_fe(gen, (2 if k <= 16 else 1, 1 << k), spec, dev)
                    for kind, (inverse, coset) in kinds.items():
                        held(f"{kind}, {field}, k={k}, {at}", x, k, field, inverse, coset)
                # rows of 0, 1 and p - 1, through one and two passes
                for k in (10, K):
                    x = torch.stack([torch.as_tensor(L.int_to_limbs(v), dtype=torch.int32,
                                                     device=dev).expand(1 << k, 16)
                                     for v in (0, spec.r, spec.modulus - 1)])
                    for kind, (inverse, coset) in kinds.items():
                        held(f"{kind}, {field}, k={k}, constant rows, {at}", x, k, field,
                             inverse, coset)
                for k in (4, K + 3):
                    n = 1 << k
                    for nonzero in (n // 8, n // 8 + 1, 1):
                        x = rows_fe(gen, (2, nonzero), spec, dev)
                        for kind in ("coset_ntt", "ntt"):
                            held(f"{kind}, {field}, k={k}, {nonzero} nonzero, {at}", x, k,
                                 field, *kinds[kind], nonzero)
            # ntt_mesh's a.transpose(0, 1)
            moved = rows_fe(gen, (1 << K, 3), L.FP, dev).transpose(0, 1)
            for kind, (inverse, coset) in kinds.items():
                held(f"{kind}, moved axis, {at}", moved, K, "fp", inverse, coset)
    finally:
        FK.ntt_radix_log = radix_log
    for k in (0, FK.NTT_K_MAX + 1):
        x = torch.zeros((1, 1 << k, 16), dtype=torch.int32, device=dev)
        try:
            FK.ntt_lm(x, k)
        except ValueError:
            continue
        raise AssertionError(f"ntt_lm ran at k = {k}, outside 1 .. {FK.NTT_K_MAX}")
    log(f"K11 ntt equal to its plain version, at radix 4 and at radix 2, at every k from 1 to "
        f"{FK.NTT_K_MAX} on fp and fq in all four transforms, on constant rows of 0, 1 and "
        f"p - 1, on a moved axis and on rows of n / 8, n / 8 + 1 and 1 nonzero elements; k = 0 and "
        f"{FK.NTT_K_MAX + 1} refused ({time.perf_counter() - t0:.1f} s)")

    shapes = {}
    for kind, batch, k, inverse, coset, field in NTT_SHAPES:
        n = 1 << k
        # to_ext passes its n / 8 coefficients; the rest of the row reads as zero
        nonzero = n // 8 if coset is not None and not inverse else None
        x = rows_fe(gen, (*batch, nonzero or n), L.FIELDS[field], dev)
        key = f"{kind} {field} {tuple(batch) + (n,)}"
        before = FK.ntt_lm.launches
        plain = held(key, x, k, field, inverse, coset, nonzero)
        per_call = FK.ntt_lm.launches - before
        ms = per_call * kernel_ms("ntt", lambda: FK.ntt_lm(x, k, field, inverse, coset, nonzero),
                                  20, per_call)
        rows = math.prod(batch)
        bound = ntt_bound(rows, k, inverse, coset, nonzero or n)
        shapes[key] = dict(ms=ms, plain_ms=plain, bound=bound)
        log(f"K11 ntt {key:34s}: equal; {ms:.6f} ms a call of {per_call} launches (plain "
            f"{plain:.3f} ms, bound {bound[0]:.6f} ms by {bound[1]})")
        del x
    # the row: a proof's extension (NTT_SHAPES[1]); its batch_ keys: a batch's (NTT_SHAPES[2])
    row, batch = (shapes[list(shapes)[i]] for i in (1, 2))
    return {"ntt": dict(err=err, **row, batch=batch,
                        shapes={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                                        bound_ms=v["bound"][0], bound_by=v["bound"][1])
                                for k, v in shapes.items()})}


RL_K = 12                 # the resource logics' domain 2^RL_K (core/proving.py::resource_logic_k)
RL_QUERY_SHAPE = (81, 6)  # the trivial resource logic's (C, Q) at k = 12: phase 7 checks its key
POLY_SHAPES = (  # K12-K14 off the main path's shapes: (kernel, what, n, and its other sizes)
    ("eval_polys", "tile edge, 10 points", 1025, dict(B=1, C=3, Q=10)),
    # K12 at 1, 7, 8 and 9 points (across its old pass of 8), off and on its
    # tile of 256 positions, one column, one coefficient; every coefficient
    # p - 1 (the largest unreduced sums), off a tile's edge and at 2^13
    ("eval_polys", "1 point", 300, dict(B=1, C=2, Q=1)),
    ("eval_polys", "7 points", 257, dict(B=2, C=3, Q=7)),
    ("eval_polys", "8 points", 256, dict(B=1, C=2, Q=8)),
    ("eval_polys", "9 points, one column", 513, dict(B=1, C=1, Q=9)),
    ("eval_polys", "one coefficient", 1, dict(B=1, C=1, Q=3)),
    ("eval_polys", "every coefficient p - 1", 1000, dict(B=2, C=3, Q=6, top=True)),
    ("eval_polys", "9 points at 2^13, p - 1", N, dict(B=1, C=1, Q=9, top=True)),
    ("eval_polys", "points shared by 2 stacks", 64, dict(B=2, C=3, Q=2, shared=True)),
    # K13 at 1, 8, 9 and 90 terms (across its runs of 8), every coefficient
    # and weight p - 1 (the largest lazy sums), off a tile's edge; weights
    # shared by two stacks; 1,600 terms (past the 1,536 of the design
    # before); groups of 1, 8, 9 and 17 terms gathered from 20 columns, with
    # and without an addend
    ("linear_combo", "weights shared by 2 stacks", 65, dict(B=2, C=3, shared=True)),
    ("linear_combo", "one column of one", 1, dict(B=1, C=1)),
    ("linear_combo", "1,600 terms", 33, dict(B=1, C=1600)),
) + tuple(("linear_combo", f"{c} terms, p - 1", 8193, dict(B=2, C=c, top=True))
          for c in (1, 8, 9, 90)) + (
    ("linear_combo", "groups of 1/8/9/17, p - 1", 100,
     dict(B=2, C=20, sizes=(1, 8, 9, 17), top=True)),
    ("linear_combo", "groups of 1/8/9/17 with an addend", 1025,
     dict(B=2, C=20, sizes=(1, 8, 9, 17), addend=True)),
    ("synthetic_div", "a shared point", 2049, dict(B=2, G=1, shared=True)),
) + tuple(("synthetic_div", f"n = {n}", n, dict(B=1, G=3)) for n in (1, 2, 1024, 1025))


def query_shape(pk, dev):
    """(C, Q, groups) of a key's query evaluations and multiopen: the
    prover's committed coefficient tables (advice, fixed, sigma, z, the
    lookups' three and the quotient pieces), its query rotations and the
    multiopen's point groups' sizes in their order (first appearance)."""
    from taiga_tpu_torch.plonk.prover import get_pipeline
    from taiga_tpu_torch.plonk.protocol import NUM_H_PIECES, num_chunks

    vk, cs = pk.vk, pk.vk.cs
    C = (cs.num_advice + cs.num_fixed + len(vk.perm_cols) + num_chunks(vk.perm_cols)
         + 3 * len(cs.lookups) + NUM_H_PIECES)
    groups: dict[int, int] = {}
    for _, _, rot in get_pipeline(pk, dev).queries:
        groups[rot % vk.n] = groups.get(rot % vk.n, 0) + 1
    return C, len(groups), tuple(groups.values())


def group_cols(gen, C: int, sizes) -> list[int]:
    """The columns of K13's grouped call: each group distinct columns of C
    drawn on the card's generator, the first all C of them when it is as
    wide (the multiopen's rotation 0 queries every table); a column in
    several groups, as the multiopen's are."""
    import torch

    cols = []
    for z in sizes:
        cols += torch.randperm(C, generator=gen, device=gen.device)[:z].tolist()
    return cols


def poly_bound(kernel: str, B: int, n: int, C: int = 0, Q: int = 0, G: int = 0,
               shared: bool = False, sizes=None, cols=None, addend: bool = False):
    """K12-K14's bound: the inputs read once and the output written once
    (64 B an element), against the products the function needs: K12 B Q C n
    terms of its dot products, each a wide product left unreduced, one
    reduction a sum of EVAL_RUN terms, and each point's n - 1 powers; K13
    the same for its B n sums a group (a term a wide product, a run of
    EVAL_RUN a reduction; each distinct column read once, the addend's
    elements once); K14 two a position (a_j p^j and the scale) and each
    distinct point's and inverse's n powers."""
    fe = 64
    if kernel == "eval_polys":
        sums = B * Q * C * -(-n // EVAL_RUN)
        return bound_ms(fe * (B * C * n + B * Q + B * Q * C),
                        WIDE_IMADS * B * Q * C * n + REDC_IMADS * sums
                        + MM_IMADS * B * Q * (n - 1))
    if kernel == "linear_combo":
        sizes = sizes or (C,)
        S, G = sum(sizes), len(sizes)
        read = len(set(cols)) if cols is not None else S
        runs = B * n * sum(-(-z // EVAL_RUN) for z in sizes)
        return bound_ms(fe * (B * read * n + (S if shared else B * S) + B * G * n
                              + (B * G * n if addend else 0)),
                        WIDE_IMADS * B * S * n + REDC_IMADS * runs)
    R, P = B * G, 1 if shared else B * G
    return bound_ms(fe * (2 * R * n + 2 * P), MM_IMADS * (2 * R * n + 2 * P * n))


def phase_poly(pk, gen, dev):
    """K12-K14 (eval_polys_lm, linear_combo_lm, synthetic_div_lm,
    csrc/poly.cu) against their plain versions (ops/poly.py's *_plain) bit
    for bit on every element, with 0, 1 and p - 1 among the coefficients,
    points and weights, constant rows of each, and a point_inv that is not
    the point's inverse: off the path's shapes (POLY_SHAPES: the tiles'
    edges, more than 8 points, a shared point or weights read through a
    stride of 0), then at the main path's calls: a proof's and a batch of
    BATCH's query evaluations (the compliance circuit's C tables at its Q
    rotations, n = 2^K), the multiopen's (its point groups' aggregate
    gathered from the C tables in one launch, the G groups' division, their
    weighted sum h, f = h plus the groups' weighted sum, and the x3
    evaluation) at B = 1 and BATCH, and a trivial resource logic's query
    evaluations at k = 12, each timed (profiler device time of the kernel's
    own launches, and of the whole call with its powers tables on K9)
    beside its plain version's time and its bound."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L

    spec = L.FP
    consts = [torch.as_tensor(L.int_to_limbs(v), device=dev) for v in (0, spec.r,
                                                                       spec.modulus - 1)]
    err = 0

    def elems(*shape):  # random, 0 / 1 / p - 1 first, and constant rows where there are four
        x = rows_fe(gen, shape, spec, dev)
        if len(shape) >= 2:
            rows = x.view(-1, shape[-1], 16)
            for r, c in zip(range(1, rows.shape[0]), consts if rows.shape[0] >= 4 else ()):
                rows[r] = c
        return x

    def call(kernel, n, B=1, C=1, Q=1, G=1, shared=False, top=False, sizes=None, cols=None,
             addend=False):
        if kernel == "eval_polys":
            a = consts[2].expand(B, C, n, 16).contiguous() if top else elems(B, C, n)
            x = elems(Q) if shared else elems(B, Q)
            return lambda: FK.eval_polys_lm(a, x)
        if kernel == "linear_combo":
            S = sum(sizes) if sizes else C
            a = consts[2].expand(B, C, n, 16).contiguous() if top else elems(B, C, n)
            w = (consts[2].expand(B, S, 16).contiguous() if top
                 else elems(S) if shared else elems(B, S))
            if sizes is None:
                return lambda: FK.linear_combo_lm(a, w)
            cols = cols if cols is not None or S == C else group_cols(gen, C, sizes)
            h = elems(B, len(sizes), n) if addend else None
            return lambda: FK.linear_combo_lm(a, w, "fp", cols, sizes, h)
        a = elems(B, G, n)
        p, pinv = (elems(4)[3] if shared else elems(B, G) for _ in range(2))
        return lambda: FK.synthetic_div_lm(a, p, pinv)

    def held(kernel, what, fn):
        nonlocal err
        got = fn()
        with FK.plain_versions():
            want, ms = once_ms(fn)
        err = max(err, compare(f"{kernel}[{what}]", (got,), (want,)))
        return ms

    t0 = time.perf_counter()
    for kernel, what, n, kw in POLY_SHAPES:
        held(kernel, what, call(kernel, n, **kw))
    many = FK.LINEAR_COMBO_MAX_GROUPS + 1
    refused = (  # no coefficient; more groups than K13 passes offsets for
        lambda: FK.eval_polys_lm(elems(1, 2, 1)[:, :, :0], elems(1, 1)),
        lambda: FK.linear_combo_lm(torch.zeros((1, many, 1, 16), dtype=torch.int32, device=dev),
                                   elems(1, 1).expand(1, many, 16), "fp", None, (1,) * many))
    for fn in refused:
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError("a K12 / K13 call the kernels do not take was not refused")
    log(f"K12-K14 equal to their plain versions off the path's shapes "
        f"({', '.join(f'{k} {w}' for k, w, _, _ in POLY_SHAPES)}); refusals raised "
        f"({time.perf_counter() - t0:.1f} s)")

    C, Q, groups = query_shape(pk, dev)
    G = len(groups)
    # (kernel, what, n, sizes); the kernels line's row is each kernel's first
    # call at B = 1, its batch_ keys the same call at B = BATCH
    path = []
    # K13's grouped call on the columns the key's queries take (a seeded
    # draw of each group's distinct columns, the multiopen's sizes)
    cols = group_cols(gen, C, groups)
    for B in (1, BATCH):
        path += [("eval_polys", "query evals", N, dict(B=B, C=C, Q=Q)),
                 ("linear_combo", "aggregate", N, dict(B=B, C=C, sizes=groups, cols=cols)),
                 ("synthetic_div", "groups", N, dict(B=B, G=G)),
                 ("linear_combo", "groups", N, dict(B=B, C=G)),
                 ("linear_combo", "f", N, dict(B=B, C=G, sizes=(G,), addend=True)),
                 ("eval_polys", "x3", N, dict(B=B, C=G, Q=1))]
    path.append(("eval_polys", f"resource logic k={RL_K}", 1 << RL_K,
                 dict(B=1, C=RL_QUERY_SHAPE[0], Q=RL_QUERY_SHAPE[1])))
    shapes: dict[str, dict] = {"eval_polys": {}, "linear_combo": {}, "synthetic_div": {}}
    first: dict[str, str] = {}
    for kernel, what, n, kw in path:
        fn = call(kernel, n, **kw)
        plain = held(kernel, what, fn)
        wrapper = getattr(FK, f"{kernel}_lm")
        before = wrapper.launches
        fn()
        per_call = wrapper.launches - before
        ms = per_call * kernel_ms(kernel, fn, 20, per_call)
        best = (-1, 0.0, 0)  # the whole call's device time: a trace that lost launches is
        for _ in range(3):   # retaken, up to three, and the fullest kept
            per, busy, ops = device_trace(lambda: [fn() for _ in range(20)])
            best = max(best, (len(per[kernel]), busy, ops))
            if best[0] == 20 * per_call:
                break
        seen, busy, ops = best
        bound = poly_bound(kernel, n=n, **kw)
        key = f"{what} " + ", ".join(f"{k}={v}" for k, v in kw.items() if k != "cols") + f", n={n}"
        first.setdefault(kernel, what)
        shapes[kernel][key] = dict(ms=ms, plain_ms=plain, bound=bound, call_ms=busy / 20,
                                   call_ops=ops / 20, call_seen=seen,
                                   launches=per_call, what=what, B=kw["B"])
        lost = "" if seen == 20 * per_call else f", a trace that saw {seen} of its launches"
        log(f"{kernel:13s} {key:42s}: equal; {ms:.6f} ms a call of {per_call} launches, the "
            f"call with its powers {busy / 20:.6f} ms in {ops / 20:.1f} device operations{lost} "
            f"(plain {plain:.3f} ms, bound {bound[0]:.6f} ms by {bound[1]})")
    log(f"K12-K14 at the main path's shapes: the compliance circuit's C = {C} tables at Q = {Q} "
        f"rotations, its multiopen's {G} point groups of {'/'.join(map(str, groups))} queries")
    out = {}
    for kernel, by in shapes.items():
        row, batch = (next(v for v in by.values() if v["what"] == first[kernel] and v["B"] == B)
                      for B in (1, BATCH))
        out[kernel] = dict(err=err, **row, batch=batch,
                           shapes={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                                           bound_ms=v["bound"][0], bound_by=v["bound"][1],
                                           call_ms=v["call_ms"], call_ops=v["call_ops"],
                                           call_seen=v["call_seen"], launches=v["launches"])
                                   for k, v in by.items()})
    return out


LOOKUP_U = N - 9    # a k = 13 proof's usable rows: n less its 8 blinding rows and one
LOOKUPS = 5         # the compliance circuit's lookups: K15's rows a proof
LOOKUP_TILE = 1024  # K15's tile of positions (csrc/lookup_sort.cu kTile)
CONVERT_COLS = 12   # K16 at a proof's advice commit: 12 columns of n coefficients
# K17 at a fixed-base chunk's (columns, live columns): a full chunk, and chunks padded to
# a power of two with zero columns (msm_fixed_multi's remainder)
DIGIT_CHUNKS = ((8, 8), (4, 3), (2, 2), (1, 1))
WINDOW_C = 8        # the MSMs' window bits (ops/msm.py::WINDOW_BITS)
SORT_OPS = 9        # 32-bit subtractions with borrow a 256-bit key comparison needs


def lookup_columns(pk, seed: int, dev):
    """A compliance proof's compressed lookup columns A and S (LOOKUPS, n,
    16), Montgomery: the seeded statement's witness (synthesized on the
    host; the blinding rows left as the builder leaves them) through the
    prover's lookup tapes (K4) at a random theta. The tapes come from a
    pipeline of its own and run on the key's fixed columns, not on the
    pipeline's static tables, so no cache that the main path's first proof
    builds is warmed here and that proof stays cold."""
    import torch
    from taiga_tpu_torch.core.compliance import ComplianceInfo
    from taiga_tpu_torch.ops import limbs as L, tape_device as TD
    from taiga_tpu_torch.plonk.circuit import CircuitBuilder
    from taiga_tpu_torch.plonk.expression import ADVICE, FIXED, INSTANCE
    from taiga_tpu_torch.plonk.prover import ProverPipeline

    vk = pk.vk
    pis, circuit = ComplianceInfo.random(random.Random(seed)).build()
    inst = [v.v for v in pis.to_instance()]
    builder = CircuitBuilder(vk.cs, vk.k, "prove")
    circuit.synthesize(builder, pk.config)
    pipe = ProverPipeline(pk, dev)
    ks = {FIXED: pipe._t(pk.fixed_mont()),
          ADVICE: pipe._t(np.stack([L.FP.array_to_mont(col) for col in builder.advice])),
          INSTANCE: pipe._t(L.FP.array_to_mont(inst + [0] * (vk.n - len(inst)))[None])}
    ch = {"theta": random.Random(seed).getrandbits(250)}
    a, s = (torch.stack([TD.tape_eval_device(tapes[side], ks, tapes[side].scalar_values(ch), vk.n)
                         for tapes in pipe.lookup_tapes()]) for side in (0, 1))
    if a.shape != (LOOKUPS, N, 16):
        raise AssertionError(f"lookup columns {tuple(a.shape)}, expected ({LOOKUPS}, {N}, 16)")
    return a, s


def phase_lookup(pk, gen, seed: int, dev):
    """K15 (permute_pairs_lm, csrc/lookup_sort.cu), K16 (from_mont_lm)
    and K17 (msm_digits_lm, csrc/convert.cu) against their
    plain versions bit for bit on every element. K15 at a proof's
    (LOOKUPS, n) and a batch of BATCH's (BATCH LOOKUPS, n) rows with u = n -
    9: the compliance circuit's real compressed columns, the same with one A
    entry moved out of the table (its ok flag false, the outputs still
    equal), and random columns with heavy repeats, an all-equal column and
    rows of 0 and p - 1 (the batch: these three cases' rows); at the kernel's tile edges (tiles of LOOKUP_TILE
    positions): u below one tile, one tile and one tile and one on the real
    columns, a run of one value across a tile edge of sorted A and of
    sorted S, and a failing lookup whose missing value is the largest, in
    the last tile; K16 at a proof's (12, n) and a batch's
    (8, 12, n), rows of 0, 1 and p - 1 among them, and on Fq; K17 at a
    fixed-base chunk's 8 columns and the padded 4-, 2- and 1-column chunks
    (packed keys), and keyed at the device IPA's 2 x n / 2 and a general
    MSM's n. Each timed (profiler device time) beside its plain version's
    time and its bound."""
    import torch
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L

    spec = L.FP
    err = 0
    t0 = time.perf_counter()

    def held(what, fn):
        nonlocal err
        got = fn()
        with FK.plain_versions():
            want, ms = once_ms(fn)
        got, want = (g if isinstance(g, tuple) else (g,) for g in (got, want))
        err = max(err, compare(what, got, want))
        return got, ms

    def mont(vals):  # host ints -> (len, 16) Montgomery on the card
        return torch.as_tensor(spec.array_to_mont([v % spec.modulus for v in vals]), device=dev)

    # K15
    real_a, real_s = lookup_columns(pk, seed, dev)
    bad_a = real_a.clone()
    bad_a[0, 17] = mont([random.Random(seed + 1).getrandbits(254)])[0]  # not in the table
    rng = random.Random(seed + 2)
    table = [0, spec.modulus - 1] + [rng.getrandbits(254) for _ in range(N - 2)]
    rand_a, rand_s = [], []
    for r in range(LOOKUPS):
        if r == 0:    # all one value
            a = [table[5]] * N
        elif r == 1:  # 0 and p - 1, both in the table
            a = [0, spec.modulus - 1] * (N // 2)
        else:         # heavy repeats of a few values
            a = [rng.choice(table[: 4 ** r]) for _ in range(N)]
        rand_a.append(mont(a))
        rand_s.append(mont(table))
    rand_a, rand_s = torch.stack(rand_a), torch.stack(rand_s)
    # tile edges: in sorted A, about LOOKUP_TILE - 24 smaller values, then a
    # run of 100 copies of one value across the edge; S holds 13 copies of
    # the value at sorted place LOOKUP_TILE + 6 (12 in place of table values
    # that A never takes), a run across its own edge; row 0 also holds a
    # value above every table value but p - 1, missing, in the last tile.
    # Only the first LOOKUP_U rows of S count: A draws from those.
    tv = sorted(table[:LOOKUP_U])
    run_s = tv[LOOKUP_TILE + 6]
    edge_a, edge_s = [], []
    for r in range(LOOKUPS):
        a = ([tv[rng.randrange(LOOKUP_TILE - 124)] for _ in range(LOOKUP_TILE - 24)]
             + [tv[LOOKUP_TILE - 100]] * 100 + [run_s] * 3)
        a += [tv[rng.randrange(LOOKUP_TILE, LOOKUP_U)] for _ in range(N - len(a))]
        rng.shuffle(a)
        if r == 0:
            a[rng.randrange(LOOKUP_U)] = tv[-2] + 1
        srow = [run_s if v in tv[LOOKUP_TILE - 124: LOOKUP_TILE - 112] else v for v in table]
        edge_a.append(mont(a))
        edge_s.append(mont(srow))
    edge_a, edge_s = torch.stack(edge_a), torch.stack(edge_s)
    cases = {"real": (real_a, real_s), "one entry out": (bad_a, real_s),
             "random repeats": (rand_a, rand_s), "tile edges": (edge_a, edge_s)}
    k15, per_call = {}, set()
    for what, (a, s) in cases.items():
        before = FK.permute_pairs_lm.launches
        (ap, sp, ok), plain = held(f"permute_pairs[{what}]",
                                   lambda a=a, s=s: FK.permute_pairs_lm(a, s, LOOKUP_U))
        per_call.add(FK.permute_pairs_lm.launches - before)
        bad = {"one entry out", "tile edges"}
        want_ok = [what not in bad or r != 0 for r in range(LOOKUPS)]
        if ok.tolist() != want_ok:
            raise AssertionError(f"permute_pairs[{what}]: ok flags {ok.tolist()}, not {want_ok}")
        k15[what] = plain
    for u in (LOOKUP_TILE - 24, LOOKUP_TILE, LOOKUP_TILE + 1):
        held(f"permute_pairs[real, u = {u}]", lambda u=u: FK.permute_pairs_lm(real_a, real_s, u))
    if len(per_call) != 1:
        raise AssertionError(f"permute_pairs: {sorted(per_call)} launches a call")
    launches = per_call.pop()
    # a batch: the real, one-entry-out and random-repeats rows repeated in
    # one call, BATCH LOOKUPS rows (the tile edges are held above alone)
    timed = [cases[w] for w in ("real", "one entry out", "random repeats")]
    reps = -(-BATCH // len(timed))
    batch_a = torch.cat([c[0] for c in timed] * reps)[: BATCH * LOOKUPS]
    batch_s = torch.cat([c[1] for c in timed] * reps)[: BATCH * LOOKUPS]
    _, k15["batch"] = held("permute_pairs[batch]",
                           lambda: FK.permute_pairs_lm(batch_a, batch_s, LOOKUP_U))

    def lookup_bound(R):
        """The rows' A and S read and A' and S' written once, against the
        keys' 2 R u products out of Montgomery form (A' and S' are input
        elements, copied back) and a comparison sort's 2 R u log2 u
        comparisons of SORT_OPS word subtractions."""
        u = LOOKUP_U
        return bound_ms(4 * R * u * 64 + R, 2 * R * u * MM_IMADS
                        + 2 * R * u * math.log2(u) * SORT_OPS)

    out = {}
    shapes = {}
    for what, (a, s) in (("proof", cases["real"]), ("batch", (batch_a, batch_s))):
        R = a.shape[0]
        ms = launches * kernel_ms("permute_pairs",
                                  lambda a=a, s=s: FK.permute_pairs_lm(a, s, LOOKUP_U), 10,
                                  launches)
        plain = k15["real" if what == "proof" else "batch"]
        shapes[what] = dict(ms=ms, plain_ms=plain, bound=lookup_bound(R), R=R)
        log(f"K15 permute_pairs   at ({R}, {N}), u={LOOKUP_U}: equal; {ms:.6f} ms a call of "
            f"{launches} launches (plain {plain:.3f} ms, bound {shapes[what]['bound'][0]:.6f} ms "
            f"by {shapes[what]['bound'][1]})")
    out["permute_pairs"] = dict(err=err, **shapes["proof"], batch=shapes["batch"])
    log(f"K15 equal to its plain version on the real columns, one entry out (ok false), random "
        f"repeats, an all-equal column and rows of 0 and p - 1, the tile edges (u = "
        f"{LOOKUP_TILE - 24}, {LOOKUP_TILE}, {LOOKUP_TILE + 1}; runs across an edge of A and S; "
        f"a missing value in the last tile, ok false) and a batch of {BATCH}")

    # K16
    consts = [torch.as_tensor(L.int_to_limbs(v), device=dev)
              for v in (0, 1, spec.r, spec.modulus - 1)]
    fq = rows_fe(gen, (3, 100), L.FQ, dev)
    held("from_mont[fq]", lambda: FK.from_mont_lm(fq, "fq"))
    conv = {}
    for what, shape in (("proof", (CONVERT_COLS, N)), ("batch", (BATCH, CONVERT_COLS, N))):
        x = rows_fe(gen, shape, spec, dev)
        rows = x.view(-1, N, 16)
        for r, cst in enumerate(consts):
            rows[r + 1] = cst
        _, plain = held(f"from_mont[{what}]", lambda x=x: FK.from_mont_lm(x))
        ms = kernel_ms("from_mont", lambda x=x: FK.from_mont_lm(x), 20)
        M = x.numel() // 16
        conv[what] = dict(ms=ms, plain_ms=plain, bound=bound_ms(128 * M, MM_IMADS * M))
        b = conv[what]["bound"]
        log(f"K16 from_mont       at {tuple(shape)}: equal; {ms:.6f} ms a launch (plain "
            f"{plain:.3f} ms, bound {b[0]:.6f} ms by {b[1]})")
    out["from_mont"] = dict(err=err, **conv["proof"], batch=conv["batch"])

    # K17
    digit_shapes = {}
    for cols, live in DIGIT_CHUNKS:
        x = rows_fe(gen, (cols, N), L.FQ, dev)  # plain scalars, 0, 1 and q - 1 among them
        x[live:] = 0
        _, plain = held(f"msm_digits[{cols} columns, {live} live]",
                        lambda x=x: FK.msm_digits_lm(x, WINDOW_C, packed=True))
        ms = kernel_ms("msm_digits", lambda x=x: FK.msm_digits_lm(x, WINDOW_C, packed=True), 20)
        bound = bound_ms(cols * N * (64 + 8 * (256 // WINDOW_C)), 0)
        digit_shapes[f"packed {cols} columns, {live} live"] = dict(ms=ms, plain_ms=plain,
                                                                   bound=bound)
        log(f"K17 msm_digits      packed at ({cols}, {N}), {live} live: equal; {ms:.6f} ms a "
            f"launch (plain {plain:.3f} ms, bound {bound[0]:.6f} ms by {bound[1]})")
    for cols, n in ((2, N // 2), (1, N)):
        x = rows_fe(gen, (cols, n), L.FQ, dev)
        held(f"msm_digits[keyed {cols} x {n}]", lambda x=x: FK.msm_digits_lm(x, WINDOW_C))
    first = digit_shapes["packed 8 columns, 8 live"]
    out["msm_digits"] = dict(err=err, **first, shapes={
        k: dict(ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                bound_by=v["bound"][1]) for k, v in digit_shapes.items()})
    log(f"K15-K17 held and timed in {time.perf_counter() - t0:.1f} s")
    return out


KERNELS = [
    # name, wrapper attribute, source, TPU kernel replaced, the proofs whose
    # path launches it ("native": the native IPA open, "device": ipa="device",
    # "batch": a lockstep batch or the pipeline, which open natively; "tx":
    # the shielded transaction flows of phase 8; "vamp_ir": phase 9's
    # Vamp-IR logic proof; phase 10's "group_law": ops/ec.py's ec_add,
    # ec_double and ec_scalar_mul_shared, "ipa_list": the list-based IPA
    # open, "poseidon": permute_batch, hash_n_batch and merkle_root,
    # "parallel": the sharded layer at world 1)
    ("mont_mul", "mont_mul_lm", "taiga_tpu_torch/csrc/mont_mul.cu",
     "taiga_tpu/ops/ff_kernels.py:428", ("native", "device", "batch", "tx", "vamp_ir")),
    # K2: phase A of the fixed-base commitments (the general MSMs, which the
    # list-based open runs, launch none since ec_bucket_weights)
    ("ec_add_proj", "ec_add_proj_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/ff_kernels.py:547", ("native", "device", "batch", "tx", "vamp_ir")),
    # K3's rounds on both paths go through ec_seg_rounds, its chained form
    ("ec_add_proj_sel", "ec_add_proj_sel_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/ff_kernels.py:511", ("parallel",)),
    # K3 chained: the segmented rounds over K3 of the MSMs' bucket passes
    ("ec_seg_rounds", "ec_seg_rounds_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/msm.py:74-90",
     ("native", "device", "batch", "tx", "vamp_ir", "ipa_list")),
    # K2 chained: the scan over K2 that combines the general MSM's windows
    # (the fixed-base commitments' bit Horners are ec_bucket_weights')
    ("ec_horner", "ec_horner_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/msm.py:417-424", ("device", "ipa_list")),
    # K2 chained: an MSM window's bucket weighting, the bit-masked roll-add
    # tree over K2 and the Horner over the bits
    ("ec_bucket_weights", "ec_bucket_weights_lm", "taiga_tpu_torch/csrc/ec_add_proj.cu",
     "taiga_tpu/ops/msm.py:140-173",
     ("native", "device", "batch", "tx", "vamp_ir", "ipa_list")),
    ("tape_eval", "tape_eval_lm", "taiga_tpu_torch/csrc/tape_eval.cu",
     "taiga_tpu/ops/tape_device.py:81", ("native", "device", "batch", "tx", "vamp_ir")),
    ("ec_fold_shared", "ec_fold_shared_lm", "taiga_tpu_torch/csrc/ec_fold_shared.cu",
     "taiga_tpu/ops/ff_kernels.py:623", ("device", "ipa_list")),
    # K6: ec.ec_add (10a's group law); the sharded fold runs it at world > 1
    ("ec_add", "ec_add_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/ops/ff_kernels.py:483", ("group_law",)),
    # K6 chained: each column's halving tree of the bitserial MSM
    ("ec_add_tree", "ec_add_tree_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/parallel/sharded.py:84-89 (the halving tree over K6)", ("parallel",)),
    # K7 and the doubling single-step: on no path since ec_ladder chains them
    ("ec_add_select", "ec_add_select_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/ops/ff_kernels.py:448", ()),
    # K7 chained with the doubling: the whole double-and-add ladder
    ("ec_ladder", "ec_ladder_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "taiga_tpu/ops/ec.py:144-161 and taiga_tpu/parallel/sharded.py:58-86 (the ladders over "
     "K7 and the doubling)", ("parallel", "group_law")),
    # replace XLA programs, not Pallas calls
    ("ec_double", "ec_double_lm", "taiga_tpu_torch/csrc/ec_add_jac.cu",
     "none: the XLA program taiga_tpu/ops/ec.py:75", ("group_law",)),
    ("poseidon", "permute_batch", "taiga_tpu_torch/csrc/poseidon.cu",
     "none: the XLA program taiga_tpu/ops/poseidon_kernel.py:62", ("poseidon",)),
    # the whole sponge: hash_n_batch, merkle_root (a launch a level), batch_hash_step
    ("poseidon_sponge", "hash_n_batch", "taiga_tpu_torch/csrc/poseidon.cu",
     "none: the XLA program taiga_tpu/ops/poseidon_kernel.py:90", ("poseidon", "parallel")),
    # the grand products (every proof); K8 and K9 also in the fixed-base
    # table's batch_inv
    ("mont_inv", "mont_inv_lm", "taiga_tpu_torch/csrc/grand_product.cu",
     "none: the XLA program taiga_tpu/ops/limbs.py:281 (in taiga_tpu/plonk/prover.py:303, 428)",
     ("native", "device", "batch", "tx", "vamp_ir")),
    ("mont_cumprod", "mont_cumprod_lm", "taiga_tpu_torch/csrc/grand_product.cu",
     "none: the XLA program taiga_tpu/ops/poly.py:24 (in taiga_tpu/plonk/prover.py:303, 428)",
     ("native", "device", "batch", "tx", "vamp_ir")),
    # K9's powers entry (poly.powers): the tables of K12's and K14's calls
    # and of the IPA's b vector (the list-based open's)
    ("powers", "powers_lm", "taiga_tpu_torch/csrc/grand_product.cu",
     "none: the XLA program taiga_tpu/ops/poly.py:38 (powers, in :67 and :77)",
     ("native", "device", "batch", "tx", "vamp_ir", "ipa_list", "parallel")),
    # K10, one source with two entries
    ("perm_terms", "perm_terms_lm", "taiga_tpu_torch/csrc/grand_product.cu",
     "none: the XLA program taiga_tpu/plonk/prover.py:318-339 (_make_zfn's numerators and "
     "denominators)", ("native", "device", "batch", "tx", "vamp_ir")),
    ("lookup_terms", "lookup_terms_lm", "taiga_tpu_torch/csrc/grand_product.cu",
     "none: the XLA program taiga_tpu/plonk/prover.py:437-443 (_make_lzfn's numerators and "
     "denominators)", ("native", "device", "batch", "tx", "vamp_ir")),
    # K11: every transform of the prover, keygen's device commit and ntt_mesh
    ("ntt", "ntt_lm", "taiga_tpu_torch/csrc/ntt.cu",
     "none: the XLA programs taiga_tpu/ops/ntt.py:120 (_ntt_fixed_jit) and :252 "
     "(_coset_scale_jit)", ("native", "device", "batch", "tx", "vamp_ir", "parallel")),
    # K12-K14: every proof's query evaluations and its multiopen's aggregation
    ("eval_polys", "eval_polys_lm", "taiga_tpu_torch/csrc/poly.cu",
     "none: the XLA program taiga_tpu/ops/poly.py:66 (eval_polys_at_points)",
     ("native", "device", "batch", "tx", "vamp_ir", "parallel")),
    ("linear_combo", "linear_combo_lm", "taiga_tpu_torch/csrc/poly.cu",
     "none: the XLA programs taiga_tpu/ops/poly.py:94 (mont_linear_combo) and "
     "taiga_tpu/plonk/hybrid_open.py:60-76 (agg_fn, f_fn)",
     ("native", "device", "batch", "tx", "vamp_ir", "parallel")),
    ("synthetic_div", "synthetic_div_lm", "taiga_tpu_torch/csrc/poly.cu",
     "none: the XLA program taiga_tpu/ops/poly.py:77 (synthetic_div)",
     ("native", "device", "batch", "tx", "vamp_ir", "parallel")),
    # K15: every compliance proof's lookup permutation (three launches a call)
    ("permute_pairs", "permute_pairs_lm", "taiga_tpu_torch/csrc/lookup_sort.cu",
     "none: the XLA program taiga_tpu/ops/lookup_sort.py:112 (permute_pairs_device)",
     ("native", "device", "batch", "tx", "vamp_ir", "parallel")),
    # K16: the commits', query evaluations' and multiopen's conversions
    ("from_mont", "from_mont_lm", "taiga_tpu_torch/csrc/convert.cu",
     "none: the XLA program taiga_tpu/plonk/prover.py:739 (_from_mont_jit)",
     ("native", "device", "batch", "tx", "vamp_ir", "ipa_list", "parallel")),
    # K17: every MSM's window digits (the fixed-base chunks' packed keys)
    ("msm_digits", "msm_digits_lm", "taiga_tpu_torch/csrc/convert.cu",
     "none: the XLA program taiga_tpu/ops/msm.py:657-673 (_digits_all under vmap and "
     "_msm_fixed_dev's packed key)",
     ("native", "device", "batch", "tx", "vamp_ir", "ipa_list", "parallel")),
]


def _wrapper(attr):
    from taiga_tpu_torch.ops import ff_kernels as FK, poseidon_kernel as PK, tape_device as TD

    return getattr(FK, attr, None) or getattr(TD, attr, None) or getattr(PK, attr)


def zero_counts():
    for _, attr, _, _, _ in KERNELS:
        _wrapper(attr).launches = 0


def launch_counts() -> dict:
    """Each KERNELS row's launches since zero_counts()."""
    return {name: _wrapper(attr).launches for name, attr, _, _, _ in KERNELS}


def read_counts(what: str, path: str) -> dict:
    """The launch counts since zero_counts(); fails if a kernel of the path
    ("native" or "device" IPA, "batch", "tx", "vamp_ir", "group_law",
    "ipa_list", "poseidon", "parallel") was never launched."""
    counts = launch_counts()
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
    # (lanes, aligned adds a lane) of each K3-family launch: one a call
    shares = [(lanes, float(sel.sum()) / lanes) for lanes, _, _, sel in selected]
    if len(shares) != launches["ec_seg_rounds"] + launches["ec_add_proj_sel"]:
        raise AssertionError(f"the cold proof made {len(shares)} K3-family launches, the warm one "
                             f"{launches['ec_seg_rounds'] + launches['ec_add_proj_sel']}")
    hist = np.histogram([v for _, v in shares], bins=10, range=(0.0, 1.0))[0]
    log(f"aligned adds a lane of the {len(shares)} K3-family launches of a native proof, in "
        f"tenths from 0 to 1: {hist.tolist()}; adds summed: "
        f"{sum(n * v for n, v in shares):.0f} over {sum(n for n, _ in shares)} lanes")

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
    if FK.ec_bucket_weights_lm.launches == 0:  # the device MSM weights its buckets
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
    return launches, launches_d, (timer.stages, t_warm), (timer_d.stages, t_dev), proof


PIPE_PROOFS = 16   # compliance statements through the pipeline: two chunks
RL_PIPE = 4        # trivial resource-logic circuits after a chunk of them (a second key)
RL_BATCH = 2       # trivial circuits through prove_resource_logics_batch
TWIN = 2           # compliance statements of the batch's plain-version twin


def trivial_circuits(rng, count: int):
    """Trivial resource-logic circuits on random statements (the resource's
    nullifier in a resource tree of four leaves, as tools/prover_diff.py
    builds its "trivial" statement)."""
    from taiga_tpu_torch.apps.trivial import TrivialResourceLogicCircuit
    from taiga_tpu_torch.core.resource import Resource
    from taiga_tpu_torch.core.resource_tree import (
        ResourceExistenceWitness, ResourceMerkleTreeLeaves)
    from taiga_tpu_torch.crypto.fields import Fp

    out = []
    for _ in range(count):
        r = Resource.random(rng)
        ident = r.get_nf().inner()
        tree = ResourceMerkleTreeLeaves([ident] + [Fp.random(rng) for _ in range(3)])
        out.append(TrivialResourceLogicCircuit(
            ResourceExistenceWitness(r, tree.generate_path(ident))))
    return out


def verify_batch(vk, instances, proofs, what: str):
    from taiga_tpu_torch.plonk.verifier import BatchVerifier

    bv = BatchVerifier()
    for inst, p in zip(instances, proofs):
        bv.add(vk, inst, p)
    if not bv.finalize():
        raise AssertionError(f"the {what} proofs do not verify")


def phase_batch(pk, seed: int, single_proof: bytes):
    """Phase 7: the lockstep batch and the cross-batch pipeline on the card.
    Returns the warm batch's launches, its stage times and the throughput
    numbers."""
    import torch
    import taiga_tpu_torch as T
    from taiga_tpu_torch.apps.trivial import TrivialResourceLogicCircuit
    from taiga_tpu_torch.core.compliance import ComplianceInfo
    from taiga_tpu_torch.core.proving import (
        get_proving_key, prove_resource_logics_batch, resource_logic_k)
    from taiga_tpu_torch.ops import ff_kernels as FK
    from taiga_tpu_torch.plonk.prover import StageTimer, create_proofs_pipelined
    from taiga_tpu_torch.plonk.verifier import verify_proof

    rngs = lambda lo, hi: [random.Random(seed + i) for i in range(lo, hi)]

    def batch(**kw):
        t0 = time.perf_counter()
        out = T.prove_compliance_batch(rngs(0, BATCH), K, device="cuda",
                                       randbits=seeded_randbits(seed + 1), **kw)
        return out, time.perf_counter() - t0

    # 7a: the lockstep batch, cold (its shapes' first run) and warm
    zero_counts()
    (vk, insts, cold), t_cold = batch()
    read_counts("cold lockstep batch", "batch")
    timer = StageTimer("cuda")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (_, _, warm), t_warm = batch(timer=timer)
    peak_warm = torch.cuda.max_memory_allocated()
    launches = read_counts("warm lockstep batch", "batch")
    if warm != cold:
        raise AssertionError("a second seeded lockstep batch differs from the first")
    verify_batch(vk, insts, warm, "lockstep batch")
    _, _, one = T.prove_compliance_batch([random.Random(seed)], K, device="cuda",
                                         randbits=seeded_randbits(seed + 1))
    if one[0] != single_proof:
        raise AssertionError("a lockstep batch of one differs from phase 5's proof")
    family = launches["ec_add_proj_sel"] + launches["ec_seg_rounds"]
    log(f"lockstep batch of {BATCH} compliance proofs at k={K}: cold {t_cold:.2f} s, warm "
        f"{t_warm:.2f} s ({BATCH / t_warm:.4f} proofs/s), byte-equal, verified by the "
        f"BatchVerifier; a batch of one equals phase 5's proof; launches a warm batch: "
        f"K1 {launches['mont_mul']}, K2 {launches['ec_add_proj']}, ec_horner "
        f"{launches['ec_horner']}, ec_bucket_weights {launches['ec_bucket_weights']}, "
        f"K3 family {family}, K4 {launches['tape_eval']}; peak device memory of the warm batch "
        f"(torch.cuda.max_memory_allocated) {peak_warm / 2**30:.3f} GiB")

    # 7b: the pipeline over one key, then over two keys (a resource logic)
    built = [ComplianceInfo.random(r).build() for r in rngs(0, PIPE_PROOFS)]
    circuits = [c for _, c in built]
    cinsts = [pis.to_instance() for pis, _ in built]
    zero_counts()
    t0 = time.perf_counter()
    (piped,) = create_proofs_pipelined([(pk, circuits, cinsts)], chunk=BATCH, device="cuda",
                                       randbits=seeded_randbits(seed + 1))
    t_pipe = time.perf_counter() - t0
    read_counts("pipelined", "batch")
    if piped[:BATCH] != warm:
        raise AssertionError("the pipeline's first chunk differs from the lockstep batch")
    verify_batch(vk, cinsts, piped, "pipelined compliance")
    log(f"pipeline of {PIPE_PROOFS} compliance proofs in chunks of {BATCH}: {t_pipe:.2f} s "
        f"({PIPE_PROOFS / t_pipe:.4f} proofs/s); the first chunk equals the lockstep batch; "
        "all verify")

    t0 = time.perf_counter()
    rl_pk = get_proving_key(TrivialResourceLogicCircuit, resource_logic_k())
    log(f"trivial resource logic keygen k={resource_logic_k()} (host, native engine): "
        f"{time.perf_counter() - t0:.2f} s")
    rl_shape = query_shape(rl_pk, "cuda")[:2]
    if resource_logic_k() != RL_K or rl_shape != RL_QUERY_SHAPE:
        raise AssertionError(f"the trivial resource logic's (C, Q) at k={resource_logic_k()} is "
                             f"{rl_shape}: phase_poly held K12 at {RL_QUERY_SHAPE}, k={RL_K}")
    rl = trivial_circuits(random.Random(seed), RL_PIPE + RL_BATCH)
    rl_insts = [c.get_public_inputs() for c in rl[:RL_PIPE]]
    jobs = [(pk, circuits[:BATCH], cinsts[:BATCH]), (rl_pk, rl[:RL_PIPE], rl_insts)]
    zero_counts()
    t0 = time.perf_counter()
    both = create_proofs_pipelined(jobs, chunk=BATCH, device="cuda",
                                   randbits=seeded_randbits(seed + 1))
    t_two = time.perf_counter() - t0
    read_counts("two-key pipelined", "batch")
    if both[0] != piped[:BATCH]:
        raise AssertionError("the two-key pipeline's compliance proofs differ from the first run's")
    for inst, p in zip(rl_insts, both[1]):
        if not verify_proof(rl_pk.vk, inst, p):
            raise AssertionError("a pipelined trivial resource-logic proof does not verify")
    infos = prove_resource_logics_batch(rl[RL_PIPE:], device="cuda",
                                        randbits=seeded_randbits(seed + 2))
    for info in infos:
        info.verify()
    log(f"pipeline of {BATCH} compliance proofs then {RL_PIPE} trivial resource-logic "
        f"proofs (k={resource_logic_k()}): {t_two:.2f} s in all; the compliance proofs equal the "
        f"first run's, the resource-logic proofs verify; prove_resource_logics_batch on "
        f"{RL_BATCH} trivial circuits: their verifying infos verify")

    # the plain-version twin of the batch shapes: a lockstep batch of TWIN
    # compliance proofs (K1 over TWIN cosets, the MSMs over TWIN x columns)
    # and the resource logics' batch at k = 12 (K4 on the trivial tape, the
    # MSMs at n = 4,096), through the kernels and then through the plain
    # versions on the same seeds; the k = 12 tables are rebuilt plainly too
    def twin():
        _, _, pair = T.prove_compliance_batch(rngs(0, TWIN), K, device="cuda",
                                              randbits=seeded_randbits(seed + 3))
        rls = prove_resource_logics_batch(rl[RL_PIPE:], device="cuda",
                                          randbits=seeded_randbits(seed + 2))
        return pair + [info.proof.data for info in rls]

    kernel_twin = twin()
    if kernel_twin[TWIN:] != [info.proof.data for info in infos]:
        raise AssertionError("prove_resource_logics_batch differs between two seeded runs")
    rl_pk.__dict__.pop("_pipelines", None)
    t0 = time.perf_counter()
    with FK.plain_versions():
        plain_twin = twin()
    t_twin = time.perf_counter() - t0
    if plain_twin != kernel_twin:
        raise AssertionError("the batches made with the kernels differ from their plain-version "
                             "twins")
    log(f"plain-version twins on the card ({t_twin:.2f} s, the k={resource_logic_k()} tables "
        f"rebuilt): a lockstep batch of {TWIN} compliance proofs and prove_resource_logics_batch "
        f"on {RL_BATCH} trivial circuits equal the kernel runs byte for byte")
    torch.cuda.synchronize()
    return launches, timer.stages, dict(t_cold=t_cold, t_warm=t_warm, t_pipe=t_pipe,
                                        t_two=t_two)


# --- phase 8: the transaction path ------------------------------------------

FLOWS = (  # name, the example flow's function in taiga_tpu_torch/examples/tx_examples.py
    ("three-party swap", "create_token_swap_transaction"),
    ("intent-matched swap", "create_token_swap_intent_transaction"),
    ("partial-fulfillment swap", "create_partial_fulfillment_transaction"),
)
CPU_THREADS = 8  # torch's intra-op threads for the transparent flows' CPU run


def ptx_proofs(ptx) -> int:
    return len(ptx.compliances) + sum(1 + len(s.app_dynamic_resource_logic_verifying_info)
                                      for s in ptx.inputs + ptx.outputs)


def swap_leg_logics(seed: int):
    """The four resource-logic circuits of one leg of the three-party swap,
    in the order ShieldedPartialTransaction.build proves them: [token,
    signature verification, token, receiver] (the input's app logic and its
    dynamic logic, then the output's)."""
    from taiga_tpu_torch.apps import Token
    from taiga_tpu_torch.core.nullifier import NullifierKeyContainer
    from taiga_tpu_torch.crypto.curves import PallasPoint
    from taiga_tpu_torch.crypto.fields import Fq
    from taiga_tpu_torch.examples import tx_examples as X

    rng = random.Random(seed)
    auth_sk = Fq.random(rng)
    nk = NullifierKeyContainer.random_key(rng)
    leg = X.create_token_swap_ptx(rng, Token("btc", 5), auth_sk, nk.get_nk(), Token("eth", 10),
                                  PallasPoint.generator() * auth_sk.v, nk.get_npk(),
                                  "transparent", device="cuda")
    flat = []
    for app in leg.input_resource_app + leg.output_resource_app:
        flat.append(app.app_resource_logic_bytecode.decode())
        flat += [bc.decode() for bc in app.dynamic_resource_logic_bytecode]
    return flat


def transparent_logics(tx) -> list:
    """One decoded resource-logic circuit of each class that a transparent
    transaction's partial transactions carry, in order of first appearance."""
    seen = {}
    for ptx in tx.transparent_ptx_bundle.partial_txs:
        for app in ptx.input_resource_app + ptx.output_resource_app:
            for bc in [app.app_resource_logic_bytecode] + app.dynamic_resource_logic_bytecode:
                c = bc.decode()
                seen.setdefault(type(c), c)
    return list(seen.values())


def mock_twin(circuit, k: int, devices=("cuda", "cpu")) -> tuple[int, int]:
    """The mock prover's gate masks and failure lists of one statement on
    two devices, on its satisfied witness and on a broken one: the first
    advice cell of a copy and every advice cell of rows 0-7 and of every
    397th row from row 11 moved by -2, and
    the first public input moved by one. One synthesis feeds both devices.
    The masks must be equal bit for bit and the failure lists string for
    string; the satisfied witness must show no failure and the broken one
    a failing gate and a copy mismatch. Returns the failing gate rows and
    the failures of the broken witness."""
    from taiga_tpu_torch.plonk.expression import ADVICE
    from taiga_tpu_torch.plonk.mock import P, MockProver, gate_masks

    name = type(circuit).__name__
    first = MockProver.run(k, circuit, circuit.get_public_inputs(), device=devices[0])
    mps = [first] + [MockProver(k, first.builder, first.instance, type(circuit), device=d)
                     for d in devices[1:]]
    b = first.builder
    for broken in (False, True):
        if broken:
            (_, col, row), _ = next(c for c in b.copies if c[0][0] == ADVICE)
            rows = [*range(8), *range(11, b.usable_rows, 397)]
            cells = {(col, row)} | {(c, r) for c in range(len(b.advice)) for r in rows}
            for c, r in cells:
                b.advice[c][r] = (b.advice[c][r] - 2) % P
            for mp in mps:
                mp.instance[0] = (mp.instance[0] + 1) % P
        masks = [gate_masks(b.cs.gates, mp._tables()) for mp in mps]
        lists = [mp.verify() for mp in mps]
        what = "broken" if broken else "satisfied"
        for d, m, fl in zip(devices[1:], masks[1:], lists[1:]):
            if not np.array_equal(m, masks[0]):
                raise AssertionError(f"mock {name} ({what}): gate masks differ, {devices[0]} "
                                     f"against {d}")
            if fl != lists[0]:
                raise AssertionError(f"mock {name} ({what}): failure lists differ, "
                                     f"{devices[0]} against {d}")
        fl = lists[0]
        if not broken and (masks[0].any() or fl):
            raise AssertionError(f"mock {name}: the satisfied witness fails: {fl[:3]}")
        if broken and not (masks[0].any() and any(f.startswith("gate '") for f in fl)
                           and any(f.startswith("copy mismatch") for f in fl)):
            raise AssertionError(f"mock {name}: the broken witness shows no failing gate or "
                                 f"no copy mismatch: {fl[:3]}")
    return int(masks[0].sum()), len(fl)


def phase_tx(seed: int, smi: str):
    """Phase 8: the shielded transaction path on the card. (a) the three
    example flows in transparent mode, the mock prover on the card (the
    first flow against its CPU run), and its gate masks and failure lists
    on one logic of each class (mock_twin); (b) the three flows in shielded mode at k = 13 / 12,
    each executed, one tampered proof refused, timed by partial
    transaction; (c) prove_resource_logics_batch on one swap leg's token
    and receiver logics against its plain-version twin. Returns the launches of (b) and of its
    first partial transaction (one swap leg), and each flow's transparent
    and shielded transaction with its execute() result, by flow name."""
    import torch
    from taiga_tpu_torch.apps import (
        OrRelationIntentResourceLogicCircuit, PartialFulfillmentIntentResourceLogicCircuit,
        ReceiverResourceLogicCircuit, SignatureVerificationResourceLogicCircuit,
        TokenResourceLogicCircuit)
    from taiga_tpu_torch.core import ptx as PTX
    from taiga_tpu_torch.core.error import TransactionError
    from taiga_tpu_torch.core.proving import (
        Proof, get_proving_key, prove_resource_logics_batch, resource_logic_k)
    from taiga_tpu_torch.examples import tx_examples as X
    from taiga_tpu_torch.ops import ff_kernels as FK
    from taiga_tpu_torch.plonk.prover import get_pipeline

    rk = resource_logic_k()
    torch.cuda.reset_peak_memory_stats()
    # the proving keys of the five logics new to this phase (the trivial
    # logic's and the compliance circuit's were made before), and their
    # device tables
    for cls in (TokenResourceLogicCircuit, SignatureVerificationResourceLogicCircuit,
                ReceiverResourceLogicCircuit, OrRelationIntentResourceLogicCircuit,
                PartialFulfillmentIntentResourceLogicCircuit):
        t0 = time.perf_counter()
        pk = get_proving_key(cls, rk)
        t1 = time.perf_counter()
        get_pipeline(pk, "cuda").prepare()
        torch.cuda.synchronize()
        log(f"keygen {cls.__name__} k={rk} (host, native engine): {t1 - t0:.2f} s; its device "
            f"tables {time.perf_counter() - t1:.2f} s; {pk.vk.cs.num_advice} advice, "
            f"{len(pk.vk.perm_cols)} permutation columns")

    # 8a: the transparent flows, the mock prover on the card (the first also
    # on the CPU). A flow executes only if the mock accepts every logic on its
    # device, but its nullifiers and output commitments come from the host,
    # so the mock's device work is held by mock_twin: its gate masks and
    # failure lists on the card against the CPU, satisfied and broken, one
    # logic of each class
    mocked, transparent, shielded = {}, {}, {}
    for i, (name, fn) in enumerate(FLOWS):
        flow = getattr(X, fn)
        t0 = time.perf_counter()
        tx = flow(random.Random(seed + i), mode="transparent", device="cuda")
        got = tx.execute()
        t_gpu = time.perf_counter() - t0
        transparent[name] = (tx, got)
        threads = torch.get_num_threads()
        torch.set_num_threads(CPU_THREADS)
        try:
            want, t_cpu = None, 0.0
            if i == 0:
                t0 = time.perf_counter()
                want = flow(random.Random(seed + i), mode="transparent", device="cpu").execute()
                t_cpu = time.perf_counter() - t0
            for c in transparent_logics(tx):
                if type(c) not in mocked:
                    t0 = time.perf_counter()
                    rows, fails = mock_twin(c, rk)
                    mocked[type(c)] = True
                    log(f"  mock prover {type(c).__name__}: gate masks and failure lists equal "
                        f"on cuda and cpu, satisfied (none) and broken ({rows} failing gate "
                        f"rows, {fails} failures); {time.perf_counter() - t0:.2f} s")
        finally:
            torch.set_num_threads(threads)
        if want is None:
            log(f"transparent {name}: executed, mock prover on cuda {t_gpu:.2f} s; "
                f"{len(got.nullifiers)} nullifiers")
            continue
        for what in ("nullifiers", "output_cms"):
            if [v.inner().v for v in getattr(got, what)] != [v.inner().v for v in getattr(want, what)]:
                raise AssertionError(f"the transparent {name}'s {what} differ between cuda and cpu")
        log(f"transparent {name}: executed, mock prover on cuda {t_gpu:.2f} s, on the cpu "
            f"({CPU_THREADS} threads) {t_cpu:.2f} s; {len(got.nullifiers)} nullifiers and "
            f"output commitments (computed on the host) equal")
    if len(mocked) != 6:
        raise AssertionError(f"the mock twin saw {len(mocked)} logic classes, not 6")

    # 8b: the shielded flows, each partial transaction timed through a view
    # of ShieldedPartialTransaction that the examples build through
    built = []

    class Timed:
        @staticmethod
        def build(*a, **kw):
            before = launch_counts()
            t0 = time.perf_counter()
            ptx = PTX.ShieldedPartialTransaction.build(*a, **kw)
            torch.cuda.synchronize()
            built.append((time.perf_counter() - t0, ptx_proofs(ptx),
                          {n: c - before[n] for n, c in launch_counts().items()}))
            return ptx

    zero_counts()
    leg = None
    for i, (name, fn) in enumerate(FLOWS):
        built.clear()
        X.ShieldedPartialTransaction = Timed
        try:
            t0 = time.perf_counter()
            tx = getattr(X, fn)(random.Random(seed + 10 + i), mode="shielded", device="cuda",
                                randbits=seeded_randbits(seed + 20 + i))
            t_build = time.perf_counter() - t0
        finally:
            X.ShieldedPartialTransaction = PTX.ShieldedPartialTransaction
        t0 = time.perf_counter()
        result = tx.execute()
        t_exec = time.perf_counter() - t0
        shielded[name] = (tx, result)
        info = tx.shielded_ptx_bundle.partial_txs[0].inputs[0].app_resource_logic_verifying_info
        good = info.proof
        data = bytearray(good.data)
        data[64] ^= 1
        info.proof = Proof(bytes(data))
        try:
            tx.execute()
            raise AssertionError(f"the shielded {name} executed with a tampered proof")
        except TransactionError as e:
            refused = type(e).__name__
        finally:
            info.proof = good
        proofs = sum(n for _, n, _ in built)
        if leg is None:
            leg = built[0]
        for j, (t, n, _) in enumerate(built):
            log(f"  {name}, partial transaction {j}: {n} proofs in {t:.2f} s "
                f"({n / t:.4f} proofs/s)   [{smi}]")
        log(f"shielded {name}: {len(built)} partial transactions, {proofs} proofs, built in "
            f"{t_build:.2f} s ({proofs / t_build:.4f} proofs/s), Transaction.execute() "
            f"{t_exec:.2f} s, {len(result.nullifiers)} nullifiers; one flipped byte of a "
            f"resource-logic proof refused ({refused})   [{smi}]")
    launches = read_counts("shielded transaction", "tx")
    log(f"launches in the three shielded flows: {launches}; in one swap leg "
        f"({leg[1]} proofs): {leg[2]}")
    log(f"peak device memory since phase 8 began (torch.cuda.max_memory_allocated): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB   [{smi}]")

    # 8c: one swap leg's token and receiver logics (one of each app tape's
    # width: K4 on the 10- and 13-column tapes, K1 and the MSMs at k = 12)
    # through the kernels and through the plain versions on the same seed,
    # the k = 12 tables rebuilt plainly
    token, _, _, receiver = swap_leg_logics(seed + 30)
    flat = [token, receiver]
    t0 = time.perf_counter()
    kernel_twin = prove_resource_logics_batch(flat, device="cuda",
                                              randbits=seeded_randbits(seed + 31))
    t_kernel = time.perf_counter() - t0
    for info in kernel_twin:
        info.verify()
    for c in flat:
        get_proving_key(type(c), rk).__dict__.pop("_pipelines", None)
    t0 = time.perf_counter()
    with FK.plain_versions():
        plain_twin = prove_resource_logics_batch(flat, device="cuda",
                                                 randbits=seeded_randbits(seed + 31))
    t_plain = time.perf_counter() - t0
    if [i.proof.data for i in plain_twin] != [i.proof.data for i in kernel_twin]:
        raise AssertionError("prove_resource_logics_batch on a swap leg's logics differs from its "
                             "plain-version twin")
    log(f"plain-version twin of one swap leg's [{', '.join(type(c).__name__ for c in flat)}]: "
        f"kernels {t_kernel:.2f} s, plain versions {t_plain:.2f} s (tables rebuilt); "
        f"byte-equal, every proof verifies")
    torch.cuda.synchronize()
    return launches, leg[2], transparent, shielded


# --- phase 9: the node-facing surface ----------------------------------------

PYTH = """
// declare R to be public
pub R;

// define the Pythagorean relation we are checking
def pyth a b c = {
  a^2 + b^2 = c^2
};

// appends constraint x^2 + y^2 = R^2 to the circuit
pyth x y R;
"""  # tests/test_vamp_ir.py's program (the reference's vamp_ir_circuits/pyth.pir)
PYTH_WITNESS = {"x": 15, "y": 20, "R": 25}
SERVICE_TIMEOUT = 600  # seconds the service child may live before it is killed


def key_source(cls, k: int) -> str:
    """Whether get_proving_key will load the key of cls at 2^k from the
    disk cache or generate and store it (read before the call)."""
    from taiga_tpu_torch.core.proving import pk_cache_path

    path = pk_cache_path(cls, k)
    return ("loaded from .pk_cache_torch/" if path and os.path.exists(path)
            else "generated and stored in .pk_cache_torch/")


def refuse_changed_input(info, what: str):
    """A resource-logic verifying info must fail with its first public
    input changed."""
    from taiga_tpu_torch.core.error import ProofError
    from taiga_tpu_torch.core.proving import ResourceLogicVerifyingInfo
    from taiga_tpu_torch.crypto.fields import Fp

    bad = ResourceLogicVerifyingInfo(info.circuit_id, info.proof,
                                     [Fp(info.public_inputs[0].v + 1)] + info.public_inputs[1:],
                                     info.vk_bytes)
    try:
        bad.verify()
    except ProofError:
        return
    raise AssertionError(f"the {what} verifies with its first public input changed")


def phase_vamp_ir(seed: int, smi: str):
    """Phase 9a: the pyth Vamp-IR program as a resource logic at k = 12 on
    the card: its key and device tables, a cold proof through
    ResourceLogicByteCode("vamp_ir", ...).generate_proof, then one decoded
    circuit proved warm (launches counted) and through the plain versions
    under one seed, byte-equal. Each proof verifies against its carried vk
    and is refused with its first public input changed. Each decode draws a
    new padding seed (a new statement), so the twin proves the one decoded
    circuit twice. Returns the warm proof's launches and the key's class,
    how it was had and its time."""
    import torch
    from taiga_tpu_torch.circuits.bytecode import ResourceLogicByteCode
    from taiga_tpu_torch.circuits.vamp_ir import VampIRResourceLogicCircuit
    from taiga_tpu_torch.core.proving import get_proving_key, prove_resource_logic, resource_logic_k
    from taiga_tpu_torch.ops import ff_kernels as FK
    from taiga_tpu_torch.plonk.prover import get_pipeline

    rk = resource_logic_k()
    bc = ResourceLogicByteCode(
        "vamp_ir", VampIRResourceLogicCircuit.for_source(PYTH)(PYTH_WITNESS).to_bytes())
    circuit = bc.decode()
    cls = type(circuit)
    source = key_source(cls, rk)
    t0 = time.perf_counter()
    pk = get_proving_key(cls, rk)
    t_key = time.perf_counter() - t0
    t0 = time.perf_counter()
    get_pipeline(pk, "cuda").prepare()
    torch.cuda.synchronize()
    cs = pk.vk.cs
    log(f"Vamp-IR logic {cls.__name__} (pyth) k={rk}: key {source} in {t_key:.2f} s (host); "
        f"its device tables {time.perf_counter() - t0:.2f} s; {cs.num_fixed} fixed and "
        f"{cs.num_advice} advice columns, {len(cs.gates)} gates, {len(cs.lookups)} lookups, "
        f"{len(pk.vk.perm_cols)} permutation columns   [{smi}]")

    t0 = time.perf_counter()
    cold = bc.generate_proof(device="cuda", randbits=seeded_randbits(seed))
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    warm = prove_resource_logic(circuit, device="cuda", randbits=seeded_randbits(seed + 1))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launches = read_counts("Vamp-IR", "vamp_ir")
    for what, info in (("cold", cold), ("warm", warm)):
        if info.circuit_id != cls.circuit_id() or info.public_inputs[0].v != PYTH_WITNESS["R"]:
            raise AssertionError(f"the {what} Vamp-IR proof carries {info.circuit_id} and R = "
                                 f"{info.public_inputs[0].v}")
        info.verify()
        refuse_changed_input(info, f"{what} Vamp-IR proof")
    pk.__dict__.pop("_pipelines", None)  # the twin rebuilds the tables plainly
    t0 = time.perf_counter()
    with FK.plain_versions():
        plain = prove_resource_logic(circuit, device="cuda", randbits=seeded_randbits(seed + 1))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if plain.proof.data != warm.proof.data:
        raise AssertionError("the Vamp-IR proof differs from its plain-version twin")
    log(f"Vamp-IR proof ({len(warm.proof.data)} bytes): cold through the bytecode {t_cold:.2f} s, "
        f"warm {t_warm:.2f} s, plain-version twin {t_plain:.2f} s (tables rebuilt); byte-equal, "
        f"each verifies against its carried vk and is refused with R changed; launches of the "
        f"warm proof: {launches}   [{smi}]")
    return launches, (cls, rk, source, t_key)


class ServiceChild:
    """`python -m taiga_tpu_torch.service` as a child process with pipes,
    as a node starts it; killed if it outlives SERVICE_TIMEOUT."""

    def __init__(self):
        import tempfile
        import threading

        self.err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "taiga_tpu_torch.service"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err)
        self.watchdog = threading.Timer(SERVICE_TIMEOUT, self.proc.kill)
        self.watchdog.start()

    def _read(self, n: int) -> bytes:
        data = self.proc.stdout.read(n)
        if len(data) != n:
            self.err.seek(0)
            tail = self.err.read().decode(errors="replace")[-2000:]
            raise AssertionError(f"the service closed its output (exit {self.proc.poll()}): {tail}")
        return data

    def call(self, packet: bytes) -> tuple[int, bytes, float]:
        """One {packet, 4} request: (status, payload, wall seconds)."""
        t0 = time.perf_counter()
        self.proc.stdin.write(struct.pack(">I", len(packet)) + packet)
        self.proc.stdin.flush()
        (n,) = struct.unpack(">I", self._read(4))
        reply = self._read(n)
        if not reply:
            raise AssertionError("the service sent an empty reply")
        return reply[0], reply[1:], time.perf_counter() - t0

    def close(self) -> int:
        """Close its input, as a node closes the port; its exit code."""
        self.proc.stdin.close()
        try:
            return self.proc.wait(timeout=60)
        finally:
            self.stop()

    def stop(self):
        self.watchdog.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()


def result_groups(payload: bytes) -> list[list[bytes]]:
    """A VERIFY_TRANSACTION reply: anchors, nullifiers and output
    commitments, 32 bytes each."""
    import io

    r = io.BytesIO(payload)
    groups = []
    for _ in range(3):
        (n,) = struct.unpack("<I", r.read(4))
        groups.append([r.read(32) for _ in range(n)])
    if r.read():
        raise AssertionError("trailing bytes after a transaction result")
    return groups


def expected_groups(result) -> list[list[bytes]]:
    return [[v.to_bytes() for v in group]
            for group in (result.anchors, result.nullifiers, result.output_cms)]


def phase_service(smi: str, transparent: dict, shielded: dict):
    """Phase 9b: the service as a node runs it, fed phase 8's transactions
    in {packet, 4} frames: PING, a resource's round trip, the three
    shielded transactions (results equal to the in-process execute()), the
    three-party swap with one proof byte flipped (an error packet, and the
    next request answered), each of its partial transactions, the
    transparent swap composed by CREATE_TRANSACTION and verified with the
    mock prover on the card, and an unknown opcode; then its input closed,
    it must exit 0. Every request is timed."""
    from taiga_tpu_torch import service as S
    from taiga_tpu_torch.core import api, wire
    from taiga_tpu_torch.core.proving import Proof

    OK, ERR = S.STATUS_OK, S.STATUS_ERROR

    def expect(status, payload, want_status, what):
        if status != want_status:
            raise AssertionError(f"service, {what}: status {status}, wanted {want_status}: "
                                 f"{payload[:300]!r}")

    t_spawn = time.perf_counter()
    child = ServiceChild()
    try:
        status, payload, _ = child.call(bytes([S.OP_PING]) + b"taiga")
        expect(status, payload, OK, "PING")
        if payload != b"taiga":
            raise AssertionError(f"service, PING: echoed {payload!r}")
        log(f"service: python -m taiga_tpu_torch.service answered its first PING "
            f"{time.perf_counter() - t_spawn:.2f} s after the spawn   [{smi}]")

        def request(what, op, body, want_status=OK):
            status, payload, sec = child.call(bytes([op]) + body)
            expect(status, payload, want_status, what)
            log(f"  {what}: {'ok' if status == OK else 'error packet'} in {sec:.3f} s "
                f"({len(body)} bytes in, {len(payload)} out)   [{smi}]")
            return payload

        swap_tx, swap_result = transparent["three-party swap"]
        res = swap_tx.transparent_ptx_bundle.partial_txs[0].compliances[0].input_resource
        if request("RESOURCE_ROUNDTRIP", S.OP_RESOURCE_ROUNDTRIP, res.serialize()) != \
                res.serialize():
            raise AssertionError("service: the resource did not come back unchanged")
        for name, (tx, result) in shielded.items():
            got = result_groups(request(f"VERIFY_TRANSACTION shielded {name}",
                                        S.OP_VERIFY_TRANSACTION, api.transaction_serialize(tx)))
            if got != expected_groups(result):
                raise AssertionError(f"service: the shielded {name}'s anchors, nullifiers or "
                                     f"commitments differ from execute() in this process")
        tx = shielded["three-party swap"][0]
        info = tx.shielded_ptx_bundle.partial_txs[0].inputs[0].app_resource_logic_verifying_info
        good = info.proof
        data = bytearray(good.data)
        data[64] ^= 1
        info.proof = Proof(bytes(data))
        try:
            tampered = api.transaction_serialize(tx)
        finally:
            info.proof = good
        request("VERIFY_TRANSACTION shielded three-party swap, one proof byte flipped",
                S.OP_VERIFY_TRANSACTION, tampered, want_status=ERR)
        for j, ptx in enumerate(tx.shielded_ptx_bundle.partial_txs):
            if request(f"VERIFY_SHIELDED_PTX three-party swap, partial transaction {j}",
                       S.OP_VERIFY_SHIELDED_PTX, wire.shielded_ptx_serialize(ptx)):
                raise AssertionError("service: VERIFY_SHIELDED_PTX answered a payload")
        ptxs = [api.partial_transaction_serialize(p)
                for p in swap_tx.transparent_ptx_bundle.partial_txs]
        body = struct.pack("<I", len(ptxs)) + b"".join(struct.pack("<I", len(p)) + p for p in ptxs)
        t0 = time.perf_counter()
        created = request("CREATE_TRANSACTION transparent three-party swap",
                          S.OP_CREATE_TRANSACTION, body)
        got = result_groups(request("VERIFY_TRANSACTION transparent three-party swap (mock "
                                    "prover on the card)", S.OP_VERIFY_TRANSACTION, created))
        log(f"  transparent three-party swap, CREATE + VERIFY: {time.perf_counter() - t0:.3f} s"
            f"   [{smi}]")
        if got != expected_groups(swap_result):
            raise AssertionError("service: the transparent swap's anchors, nullifiers or "
                                 "commitments differ from phase 8a's")
        request("unknown opcode 0x7f", 0x7F, b"", want_status=ERR)
        code = child.close()
    finally:
        child.stop()
    if code != 0:
        raise AssertionError(f"the service exited with {code} when its input closed")
    log(f"service: every request answered as expected; exit 0 when its input closed; "
        f"{time.perf_counter() - t_spawn:.2f} s from the spawn   [{smi}]")


def phase_key_cache(keys, smi: str):
    """Phase 9c: how this process had its keys (loaded from the disk cache
    or generated and stored), then a child process loads them from the
    disk cache, keygen forbidden: each vk's SHA-256 must equal this
    process's."""
    import hashlib

    from taiga_tpu_torch.core.proving import get_proving_key

    want = {}
    for label, (cls, k, source, sec) in keys.items():
        want[label] = hashlib.sha256(get_proving_key(cls, k).vk.to_bytes()).hexdigest()
        log(f"key cache: {label} (k={k}) {source} in {sec:.2f} s in this process")
    code = f"""
import hashlib, json, time
from taiga_tpu_torch.core import proving as PR
from taiga_tpu_torch.plonk import keygen as KG

def no_keygen(*a, **kw):
    raise AssertionError("a keygen ran: the key was not loaded from the disk cache")

KG.keygen = no_keygen
from taiga_tpu_torch.circuits.compliance import ComplianceCircuit
from taiga_tpu_torch.circuits.vamp_ir import VampIRResourceLogicCircuit
out = {{}}
for label, cls, k in (("compliance", ComplianceCircuit, {K}),
                      ("vamp_ir", VampIRResourceLogicCircuit.for_source({PYTH!r}),
                       PR.resource_logic_k())):
    t0 = time.perf_counter()
    pk = PR.get_proving_key(cls, k)
    out[label] = [hashlib.sha256(pk.vk.to_bytes()).hexdigest(), time.perf_counter() - t0]
print(json.dumps(out))
"""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the key-cache child exited with {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for label, digest in want.items():
        if got[label][0] != digest:
            raise AssertionError(f"key cache: the child's {label} vk differs from this process's")
        log(f"key cache: a child process loaded the {label} key from .pk_cache_torch/ in "
            f"{got[label][1]:.3f} s (this process: {keys[label][2]} in {keys[label][3]:.2f} s); "
            f"vk SHA-256 {digest[:16]}... equal   [{smi}]")
    log(f"key cache: the child took {time.perf_counter() - t0:.2f} s in all (torch import included)")


# --- phase 10: the last modules -----------------------------------------------

W_GROUP = N // 2              # lanes of the group-law checks, and of the shared ladder
# 10f's bitserial MSM, the main path of ec_ladder (the ladder over
# BITS_COLS x BITS_POINTS lanes, a scalar a lane) and K6 (its halving tree,
# first level over BITS_COLS x BITS_POINTS / 2 lanes)
BITS_POINTS, BITS_COLS = 1024, 2
SAMPLED = (0, 1, 2, 3, 4, 5, 6, 7, 1000, W_GROUP - 1)  # lanes held against the host
# K7 and the doubling single-step: the bitserial MSM's widths before its
# ladder was one launch, and the width phase 4 times K2 and K6 at
SINGLE_WIDTHS = (BITS_POINTS, BITS_COLS * BITS_POINTS, W_EC_ADD)
LADDER_BITS = 255
# ec_add_tree's small columns (C, n), and one of N = 8,192 points, above
# the 4,096 a block takes (one K6 level first), beside 10f's BITS_COLS x
# BITS_POINTS
TREE_SHAPES = tuple((C, n) for n in (1, 2, 8, 64) for C in (1, 2, 3)) + ((1, N),)
POSEIDON_STATES = 16384       # bench.py tier 3's n
HASH_SHAPE = (4096, 8)        # bench.py tier 2's (batch, length)
POSEIDON_WIDTHS = (HASH_SHAPE[0], POSEIDON_STATES, 1 << 20)  # permute_batch timed at each
MERKLE_LEAVES = 1 << 14
# Montgomery products a permutation needs, in the sparse form
# (ops/poseidon_kernel.py::sparse_params): a full round 3 S-boxes of 3 and
# a dense 3 x 3 matrix, a partial round one S-box and a sparse matrix of
# 2t - 1 = 5; and the dense form's count (PR 8's bound), printed beside it
POSEIDON_PRODUCTS = 8 * (3 * 3 + 9) + 56 * (3 + 5)
POSEIDON_PRODUCTS_DENSE = 8 * (3 * 3 + 9) + 56 * (3 + 9)
# one state's chain on a quad of threads (csrc/poseidon.cu): a full round
# 6 product stages, a partial round 3, and the last partial round's w v
POSEIDON_STAGES = 8 * 6 + 56 * 3 + 1


def ladder_work(cols: list[list[int]], bits: int = LADDER_BITS) -> tuple[int, int]:
    """(products, product stages) of the ladders [s_cj] P_j over the
    columns' scalars s_cj (C lists of n). Products are what the function
    needs on this data, the bound's count: each point's doublings (7
    products) once, up to the highest set bit of its columns' scalars, and
    a general add (16 products) at every set bit of a lane after its first,
    which adds to the identity. Stages are one chain's as ec_ladder runs
    it, the longest lane's: a doubling's 3 after every bit but the last
    (every column redoes its points' doublings), and 2 more where the add
    runs, 5 at a last set bit."""
    mask = (1 << bits) - 1
    products, stages = 0, 0
    for j in range(len(cols[0])):
        lane = [col[j] & mask for col in cols]
        products += 7 * max(max(s.bit_length() for s in lane) - 1, 0)
        for s in lane:
            adds = max(bin(s).count("1") - 1, 0)
            products += 16 * adds
            last = s >> (bits - 1) & 1 and adds
            stages = max(stages, 3 * (bits - 1) + 2 * adds + (3 if last else 0))
    return products, stages


def host_points(field: str, x, y, z) -> list:
    """Every lane of limb-major Jacobian Montgomery coordinates as host
    points."""
    from taiga_tpu_torch.ops import limbs as L

    curve, spec = curve_of(field), L.FIELDS[field]
    p, F = spec.modulus, curve.FIELD
    X, Y, Z = (spec.array_from_mont(np.ascontiguousarray(v.T.cpu().numpy())) for v in (x, y, z))
    out = []
    for a, b, c in zip(X, Y, Z):
        if c == 0:
            out.append(curve.identity())
            continue
        zi = pow(c, -1, p)
        out.append(curve(F(a * zi * zi % p), F(b * zi * zi * zi % p)))
    return out


def tree_columns(p1, p2, C: int, n: int):
    """ec_add_tree's input (16, C n) x 3: column c is p1's lanes c h ..
    c h + h - 1, then p2's (h = n / 2), so that the tree's first level adds
    p1[i] and p2[i] -- jacobian_inputs' identities (lanes 0-2), P + P
    (3-4) and P + (-P) (5-6) in column 0; n = 1: p1's first C lanes."""
    import torch

    if n == 1:
        return [v[:, :C].contiguous() for v in p1]
    h = n // 2
    return [torch.cat([u[:, c * h:(c + 1) * h] for c in range(C) for u in (a, b)], 1)
            .contiguous() for a, b in zip(p1, p2)]


def phase_group_law(rng, gen, dev, smi: str):
    """10a: ec.ec_add (K6), ec.ec_double (the doubling kernel) and
    ec.ec_scalar_mul_shared (one ec_ladder launch) at 4,096 lanes on both
    fields, with identity, P = Q and P = -Q lanes (jacobian_inputs' lanes
    0-6), against their plain versions bit for bit and against the host
    group law on sampled lanes (the "group_law" path: launches zeroed just
    before, read after; returned with fq's counts); ec_add_tree on
    TREE_SHAPES and BITS_COLS x BITS_POINTS (tree_columns) against
    ec_add_tree_plain and the host sum of every column; ec_ladder in both
    bit modes on both fields bit for bit against ec_ladder_plain: one
    scalar shared by the 4,096 lanes (0, 1, q, whose last add meets the
    negation of the sum, and a random one) and one a lane over BITS_COLS x
    BITS_POINTS (0, 1, q - 1, q and 2^254 among random ones), with the host
    group law on sampled lanes; K7 and the doubling single-step at
    SINGLE_WIDTHS bit for bit; then K6 at 1,024 lanes, ec_add_tree at
    BITS_COLS x BITS_POINTS (its main path), K7 and the doubling at
    SINGLE_WIDTHS, and the ladder (shared at 4,096 lanes; a scalar a lane
    at BITS_COLS x BITS_POINTS, its main path, and at 1 x BITS_POINTS)
    timed with CUDA events."""
    import torch
    from taiga_tpu_torch.ops import ec, ff_kernels as FK, limbs as L

    fe = 16 * 4
    err, err_t, res = 0, 0, {}
    for field in ("fp", "fq"):
        spec = L.FIELDS[field]
        curve = curve_of(field)
        q = curve.SCALAR.MODULUS
        p1, p2 = jacobian_inputs(rng, field, dev)
        P = tuple(v[:, :W_GROUP].T.contiguous() for v in p1)  # (B, 16) rows
        Q = tuple(v[:, :W_GROUP].T.contiguous() for v in p2)
        s = int(rng.integers(1, 1 << 62)) ** 5 % q
        sl = L.int_to_limbs(s)
        zero_counts()  # the "group_law" path: ops/ec.py's three entry points
        got = (ec.ec_add(P, Q, spec), ec.ec_double(P, spec), ec.ec_scalar_mul_shared(P, sl, spec))
        launches = read_counts(f"group law [{field}]", "group_law")
        with FK.plain_versions():
            t0 = time.perf_counter()
            want = (ec.ec_add(P, Q, spec), ec.ec_double(P, spec))
            ladder = ec.ec_scalar_mul_shared(P, sl, spec)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        for what, g, w in zip(("ec_add", "ec_double", "ec_scalar_mul_shared"), got,
                              want + (ladder,)):
            err = max(err, compare(f"ec.{what}[{field}]", g, w))
        hosts = {lane: tuple(to_affine(field, *(v.T for v in pt), lane, jacobian=True)
                             for pt in (P, Q)) for lane in SAMPLED}
        for lane, (a, b) in hosts.items():
            outs = [to_affine(field, *(v.T for v in g), lane, jacobian=True) for g in got]
            if outs != [a + b, a + a, a * s]:
                raise AssertionError(f"ec[{field}]: lane {lane} disagrees with the host group law")

        # ec_add_tree (K6 chained) on TREE_SHAPES and 10f's 2 x 1,024,
        # against ec_add_tree_plain and the host sum of every column
        for C, n in TREE_SHAPES + ((BITS_COLS, BITS_POINTS),):
            cols = tree_columns(p1, p2, C, n)
            got_t = FK.ec_add_tree_lm(*cols, C, field)
            with FK.plain_versions():
                want_t = FK.ec_add_tree_lm(*cols, C, field)
            err_t = max(err_t, compare(f"ec_add_tree[{field}, {C} x {n}]", got_t, want_t))
            pts = host_points(field, *cols)
            for c in range(C):
                if to_affine(field, *got_t, c, jacobian=True) != sum(pts[c * n + 1:(c + 1) * n],
                                                                     pts[c * n]):
                    raise AssertionError(f"ec_add_tree[{field}, {C} x {n}]: column {c} is not "
                                         "the host sum")

        # ec_ladder, a shared scalar: the base is P's 4,096 lanes (identity
        # in lanes 0 and 2)
        base = [v.T.contiguous() for v in P]
        for sv in (0, 1, q):
            sl_t = torch.as_tensor(L.int_to_limbs(sv), device=dev)
            got_l = FK.ec_ladder_lm(*base, sl_t, LADDER_BITS, field)
            with FK.plain_versions():
                want_l = FK.ec_ladder_lm(*base, sl_t, LADDER_BITS, field)
            err = max(err, compare(f"ec_ladder[{field}, shared s={'q' if sv == q else sv}]",
                                   got_l, want_l))
            for lane, (a, _) in hosts.items():
                if to_affine(field, *got_l, lane, jacobian=True) != a * sv:
                    raise AssertionError(f"ec_ladder[{field}, shared]: lane {lane} is not [s] P")
            if sv == 0 and any(bool(v.any()) for v in got_l):
                raise AssertionError(f"ec_ladder[{field}]: the scalar 0 does not give (0, 0, 0)")
        # a scalar a lane, (C, n, 16): lane c * n + j is [s_cj] P_j
        nb = BITS_POINTS
        bl = [v[:, :nb].contiguous() for v in base]
        cols = [[int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(nb)]
                for _ in range(BITS_COLS)]
        for j, sv in enumerate((0, 1, q - 1, q, 1 << 254)):
            cols[0][3 + j] = sv  # lanes 3..7: beside the identity lanes 0 and 2
        cols[1][2] = 0
        scal = torch.as_tensor(np.stack([L.ints_to_limbs(c) for c in cols]), device=dev)
        got_l = FK.ec_ladder_lm(*bl, scal, LADDER_BITS, field)
        with FK.plain_versions():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_l = FK.ec_ladder_lm(*bl, scal, LADDER_BITS, field)
            torch.cuda.synchronize()
            ms_ladder_plain = (time.perf_counter() - t0) * 1e3  # fq's is the row's plain_ms
        err = max(err, compare(f"ec_ladder[{field}, a scalar a lane]", got_l, want_l))
        for c in range(BITS_COLS):
            for j in SAMPLED[:9]:
                a = hosts[j][0]
                if to_affine(field, *got_l, c * nb + j, jacobian=True) != a * cols[c][j]:
                    raise AssertionError(f"ec_ladder[{field}, a scalar a lane]: lane "
                                         f"({c}, {j}) is not [s] P")
        if any(bool(v[:, nb + 2].any()) for v in got_l):
            raise AssertionError(f"ec_ladder[{field}]: a lane whose bits are 0 is not (0, 0, 0)")
        if field == "fq":
            ms_d = cuda_ms(lambda: ec.ec_double(P, spec), 20)
            ms_l = cuda_ms(lambda: ec.ec_scalar_mul_shared(P, sl, spec), 5)
            fq_in = dict(P=P, Q=Q, s=s, base=base, scal=scal, cols=cols, t_plain=t_plain,
                         ladder_plain_ms=ms_ladder_plain,
                         tree=tree_columns(p1, p2, BITS_COLS, BITS_POINTS))
            log(f"ec.ec_double at B={W_GROUP} with its two transposes {ms_d:.6f} ms; "
                f"ec.ec_scalar_mul_shared at B={W_GROUP} (one ec_ladder launch and the "
                f"transposes) {ms_l:.3f} ms (plain, the three helpers: {t_plain:.2f} s)   [{smi}]")
    log(f"10a group law: ec_add (K6), ec_double and ec_scalar_mul_shared (ec_ladder) equal "
        f"their plain versions on fp and fq at B={W_GROUP} (identity, P = Q, P = -Q lanes) and "
        f"the host group law on lanes {SAMPLED}; ec_ladder equal to ec_ladder_plain on fp and "
        f"fq with a shared scalar (0, 1, q, random) at B={W_GROUP} and a scalar a lane (0, 1, "
        f"q - 1, q, 2^254 among random) at {BITS_COLS} x {BITS_POINTS}, and the host group law "
        f"on sampled lanes; ec_add_tree equal to ec_add_tree_plain and the host sum of every "
        f"column on fp and fq at C x n = {TREE_SHAPES} and {BITS_COLS} x {BITS_POINTS} "
        f"(identities, P + P and P + (-P) at the first level); ops/ec.py's launches (fq): "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))

    # K7 and the doubling single-step: bit for bit and timed at SINGLE_WIDTHS
    wide = [wide_fe(gen, SINGLE_WIDTHS[-1], dev) for _ in range(6)]
    half = torch.randint(0, 2, (1, SINGLE_WIDTHS[-1]), generator=gen, dtype=torch.int32,
                         device=dev)
    singles = {"ec_add_select": {}, "ec_double": {}}
    for B in SINGLE_WIDTHS:
        pts = [v[:, :B].contiguous() for v in wide]
        sel = half[:, :B].contiguous()
        n_sel = int(sel.sum())
        for name, fn, bound in (
                ("ec_add_select", lambda: FK.ec_add_select_lm(*pts, sel, "fq"),
                 bound_ms(fe * (6 * B + 3 * n_sel) + 4 * B, 16 * MM_IMADS * n_sel)),
                ("ec_double", lambda: FK.ec_double_lm(*pts[:3], "fq"),
                 bound_ms(6 * fe * B, 7 * MM_IMADS * B))):
            got = fn()
            with FK.plain_versions():
                err = max(err, compare(f"{name}[fq, B={B}]", got, fn()))
                pms = cuda_ms(fn, 3 if B <= 4096 else 1)
            ms = cuda_ms(fn, 50 if B <= 4096 else 20)
            singles[name][B] = dict(ms=ms, plain_ms=pms, bound=bound)
            log(f"{name} single-step at B={B}: {ms:.6f} ms per launch (plain {pms:.3f} ms; "
                f"bound {bound[0]:.6f} ms by {bound[1]})")
    del wide, half
    res["ec_double"] = dict(err=err, **singles["ec_double"][BITS_POINTS], B=BITS_POINTS,
                            widths=singles["ec_double"])
    res["ec_add_select"] = dict(widths=singles["ec_add_select"])

    # K6 at 1,024 lanes (the first level of PR 9's bitserial tree, before
    # ec_add_tree), and ec_add_tree at 10f's 2 x 1,024, its main path
    P, Q = fq_in["P"], fq_in["Q"]
    w6 = BITS_COLS * BITS_POINTS // 2
    p6, q6 = ([v[:w6].T.contiguous() for v in pt] for pt in (P, Q))
    b6 = bound_ms(9 * fe * w6, 16 * MM_IMADS * w6)  # as phase 4 reckons it
    res["ec_add"] = dict(ms=cuda_ms(lambda: FK.ec_add_lm(*p6, *q6, "fq"), 50), bound=b6, B=w6)
    log(f"ec_add at B={w6}: {res['ec_add']['ms']:.6f} ms per launch (bound {b6[0]:.6f} ms by "
        f"{b6[1]})")
    cols, C, n = fq_in["tree"], BITS_COLS, BITS_POINTS
    ms_t = cuda_ms(lambda: FK.ec_add_tree_lm(*cols, C, "fq"), 50)
    with FK.plain_versions():
        pms_t = cuda_ms(lambda: FK.ec_add_tree_lm(*cols, C, "fq"), 1)
    bound_t = bound_ms(3 * fe * (C * n + C), C * (n - 1) * 16 * MM_IMADS)
    levels = n.bit_length() - 1
    res["ec_add_tree"] = dict(err=err_t, ms=ms_t, plain_ms=pms_t, B=(C, n), bound=bound_t,
                              chain_adds=levels)
    log(f"ec_add_tree at {C} x {n}: {ms_t:.6f} ms per launch (plain, {levels} levels of "
        f"ec_add_plain: {pms_t:.3f} ms; bound {bound_t[0]:.6f} ms by {bound_t[1]}, "
        f"{C * (n - 1)} adds of 16 products; one chain: {levels} dependent adds)   [{smi}]")

    # the ladder timed: shared at W_GROUP lanes, a scalar a lane at
    # BITS_COLS x BITS_POINTS (10f's) and at 1 x BITS_POINTS, which says what
    # redoing each point's doublings in every column costs
    s, base, scal, cols = fq_in["s"], fq_in["base"], fq_in["scal"], fq_in["cols"]
    sl_t = torch.as_tensor(L.int_to_limbs(s), device=dev)
    ladders = {}
    for what, n, C, fn, scalars in (
            ("shared", W_GROUP, 1, lambda: FK.ec_ladder_lm(*base, sl_t, LADDER_BITS, "fq"),
             [[s] * W_GROUP]),
            ("lanes", BITS_POINTS, BITS_COLS,
             lambda: FK.ec_ladder_lm(*(v[:, :BITS_POINTS].contiguous() for v in base), scal,
                                     LADDER_BITS, "fq"), cols),
            ("lanes", BITS_POINTS, 1,
             lambda: FK.ec_ladder_lm(*(v[:, :BITS_POINTS].contiguous() for v in base),
                                     scal[:1].contiguous(), LADDER_BITS, "fq"), cols[:1])):
        products, stages = ladder_work(scalars)
        nbytes = 3 * fe * n + (fe if what == "shared" else fe * C * n) + 3 * fe * C * n
        bound = bound_ms(nbytes, products * MM_IMADS)
        ms = cuda_ms(fn, 10)
        ladders[(what, C, n)] = dict(ms=ms, bound=bound, stages=stages)
        log(f"ec_ladder, {'a shared scalar' if what == 'shared' else 'a scalar a lane'}, "
            f"{C} x {n} lanes: {ms:.6f} ms per launch (bound {bound[0]:.6f} ms by {bound[1]}; "
            f"one chain: {stages} product stages, {ms * 1e3 / stages:.4f} us a stage)")
    main = ladders[("lanes", BITS_COLS, BITS_POINTS)]
    pms = fq_in["ladder_plain_ms"]  # the plain run that fq's comparison above made
    shared = ladders[("shared", 1, W_GROUP)]
    res["ec_ladder"] = dict(err=err, ms=main["ms"], plain_ms=pms, B=(BITS_COLS, BITS_POINTS),
                            bound=main["bound"], stages=main["stages"],
                            shared_ms=shared["ms"], shared_bound=shared["bound"],
                            shared_stages=shared["stages"])
    log(f"ec_ladder plain version at {BITS_COLS} x {BITS_POINTS} (the loop of 255 steps): "
        f"{pms:.3f} ms; a scalar a lane over {BITS_COLS} columns against 1 (the doublings "
        f"redone per column): {main['ms']:.6f} / "
        f"{ladders[('lanes', 1, BITS_POINTS)]['ms']:.6f} ms   [{smi}]")
    return res, launches


def phase_ipa_list(seed: int, smi: str):
    """10b: the list-based IPA open (plonk/ipa.py::ipa_open: host-int
    coefficients, opened by ipa_open_device) of a random polynomial at
    k = 13 on the card; its bytes equal ipa_open_device's and
    ipa_open_native's under one seed; ipa_verify accepts it and refuses it
    with a0 changed. Launch counts zeroed just before the open, read after
    (the "ipa_list" path: K5 in the generator folds, ec_seg_rounds,
    ec_bucket_weights and ec_horner in the MSMs)."""
    import torch
    from taiga_tpu_torch.native import hostops as H
    from taiga_tpu_torch.ops import limbs as L
    from taiga_tpu_torch.plonk import ipa as TI
    from taiga_tpu_torch.plonk.native_open import _msm_point, ipa_open_native
    from taiga_tpu_torch.plonk.srs import get_params
    from taiga_tpu_torch.plonk.transcript import ProofReader, ProofWriter

    label = b"taiga-tpu-ipa-list"
    r = random.Random(seed)
    P = L.FP.modulus
    coeffs = [r.getrandbits(254) % P for _ in range(N)]
    x, blind = r.getrandbits(254) % P, r.getrandbits(254) % P
    params = get_params(K)
    mont = L.FP.array_to_mont(coeffs)
    proofs = {}
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = ProofWriter(label)
    TI.ipa_open(params, coeffs, blind, x, tr, seeded_randbits(seed + 1), device="cuda")
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    launches = read_counts("list-based IPA open", "ipa_list")
    proofs["list"] = tr.bytes()
    tr = ProofWriter(label)
    t0 = time.perf_counter()
    TI.ipa_open_device(params, torch.as_tensor(mont, device="cuda"), blind, x, tr,
                       seeded_randbits(seed + 1))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    proofs["device"] = tr.bytes()
    tr = ProofWriter(label)
    ipa_open_native(params, L.packed_to_u64(L.pack_limbs(torch.as_tensor(mont))), blind, x, tr,
                    seeded_randbits(seed + 1))
    proofs["native"] = tr.bytes()
    if not proofs["list"] == proofs["device"] == proofs["native"]:
        raise AssertionError("the list-based, device and native IPA opens differ")
    v = 0
    for c in reversed(coeffs):
        v = (v * x + c) % P
    commit = _msm_point(K, H.ints_to_u64(coeffs), blind)
    verify = lambda pr: TI.ipa_verify(params, [(commit, 1)], x, v, ProofReader(pr, label))
    tampered = bytearray(proofs["list"])
    tampered[-64] ^= 1
    if not verify(proofs["list"]) or verify(bytes(tampered)):
        raise AssertionError("ipa_verify does not accept the list-based open, or accepts it "
                             "with a0 changed")
    log(f"10b list-based IPA open at k={K}: {t_list:.3f} s (ipa_open_device {t_dev:.3f} s), "
        f"{len(proofs['list'])} bytes equal to ipa_open_device's and ipa_open_native's; "
        f"verified, refused with a0 changed; launches K5 {launches['ec_fold_shared']}, K2 "
        f"{launches['ec_add_proj']}, ec_seg_rounds {launches['ec_seg_rounds']}, ec_horner "
        f"{launches['ec_horner']}, ec_bucket_weights {launches['ec_bucket_weights']}   [{smi}]")
    return launches


def phase_poseidon(rng, dev, smi: str):
    """10d: permute_batch (csrc/poseidon.cu) at POSEIDON_WIDTHS states
    against its plain version bit for bit (4,096 and 16,384) and the host
    permutation on sampled lanes (all three; 1,048,576 only so: its plain
    version would take a minute); the sponge kernel (hash_n_batch) at
    lengths 1-8 against the host hash (every row), and at tier 2's (4,096,
    8) against its plain version and the host hash; merkle_root of 2^14
    leaves against its plain version and the host tree; each timed (a plain
    version once: the run that is compared). Then the "poseidon" path, launch counts
    zeroed just before and read after: permute_batch at tier 3's 16,384
    states, hash_n_batch at (4,096, 8) (one launch), merkle_root of 2^14
    leaves (a launch a level)."""
    import torch
    from taiga_tpu_torch.crypto import poseidon as hp
    from taiga_tpu_torch.crypto.fields import Fp
    from taiga_tpu_torch.ops import ff_kernels as FK, limbs as L, poseidon_kernel as PK

    spec = L.FP
    fe = 16 * 4

    def elems(count):  # (count, 16) canonical elements below 2^254 < p
        x = rng.integers(0, 1 << 16, size=(count, 16), dtype=np.int32)
        x[:, 15] &= 0x3FFF
        return torch.as_tensor(x, device=dev)

    def host_perm(states, got, lanes):
        host = spec.array_from_mont(states[list(lanes)].reshape(-1, 16).cpu())
        out = spec.array_from_mont(got[list(lanes)].reshape(-1, 16).cpu())
        return out == [v for i in range(len(lanes)) for v in hp.permute_ints(host[3 * i:3 * i + 3])]

    err, widths = 0, {}
    for n in POSEIDON_WIDTHS:
        states = elems(n * 3).reshape(n, 3, 16)
        got = PK.permute_batch(states)
        pms = None
        if n < POSEIDON_WIDTHS[-1]:
            with FK.plain_versions():
                want, pms = once_ms(lambda: PK.permute_batch(states))
            err = max(err, compare(f"poseidon.permute_batch[{n}]", (got,), (want,)))
        if not host_perm(states, got, SAMPLED[:8] + (n - 1,)):
            raise AssertionError(f"poseidon.permute_batch[{n}] disagrees with the host permutation")
        ms = cuda_ms(lambda: PK.permute_batch(states), 20 if n < POSEIDON_WIDTHS[-1] else 5)
        bound = bound_ms(2 * 3 * fe * n, POSEIDON_PRODUCTS * MM_IMADS * n)
        dense = bound_ms(2 * 3 * fe * n, POSEIDON_PRODUCTS_DENSE * MM_IMADS * n)
        widths[n] = dict(ms=ms, plain_ms=pms, bound=bound)
        log(f"10d poseidon permute_batch at {n} states: {ms:.6f} ms per launch "
            f"({n / (ms / 1e3):.0f} permutations/s; plain "
            f"{'not run' if pms is None else f'{pms:.1f} ms'}; bound {bound[0]:.6f} ms by "
            f"{bound[1]} at {POSEIDON_PRODUCTS} products a state, {dense[0]:.6f} ms at PR 8's "
            f"{POSEIDON_PRODUCTS_DENSE}; one chain {POSEIDON_STAGES} product stages), equal to "
            f"{'its plain version and ' if pms is not None else ''}the host permutation on "
            f"sampled lanes")
        del states, got

    def host_hashes(msgs, hashes, length):  # every row against the host sponge
        m_host = spec.array_from_mont(msgs.reshape(-1, 16).cpu())
        want = [hp.poseidon_hash_n([Fp(v) for v in m_host[length * i : length * (i + 1)]]).v
                for i in range(msgs.shape[0])]
        if [f.v for f in PK.mont_to_fps(hashes)] != want:
            raise AssertionError(f"poseidon.hash_n_batch[L={length}] disagrees with the host hash")

    for length in range(1, 9):  # 37 messages: a block and a ragged one
        msgs = elems(37 * length).reshape(37, length, 16)
        host_hashes(msgs, PK.hash_n_batch(msgs, length), length)
    B, length = HASH_SHAPE
    msgs = elems(B * length).reshape(B, length, 16)
    hashes = PK.hash_n_batch(msgs, length)
    with FK.plain_versions():
        want, pms_h = once_ms(lambda: PK.hash_n_batch(msgs, length))
    err = max(err, compare("poseidon.hash_n_batch", (hashes,), (want,)))
    host_hashes(msgs[list(SAMPLED[:8])], hashes[list(SAMPLED[:8])], length)
    ms_h = cuda_ms(lambda: PK.hash_n_batch(msgs, length), 20)
    blocks = -(-length // hp.RATE)
    bound_h = bound_ms(fe * B * (length + 1), B * blocks * POSEIDON_PRODUCTS * MM_IMADS)
    leaves = elems(MERKLE_LEAVES)
    root = PK.merkle_root(leaves)
    with FK.plain_versions():
        want, pms_m = once_ms(lambda: PK.merkle_root(leaves))
    err = max(err, compare("poseidon.merkle_root", (root,), (want,)))
    level = PK.mont_to_fps(leaves)
    while len(level) > 1:
        level = [hp.poseidon_hash(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    if PK.mont_to_fps(root[None])[0] != level[0]:
        raise AssertionError("poseidon.merkle_root disagrees with the host tree")
    ms_m = cuda_ms(lambda: PK.merkle_root(leaves), 10)
    bound_m = bound_ms(fe * (MERKLE_LEAVES + 1),
                       (MERKLE_LEAVES - 1) * POSEIDON_PRODUCTS * MM_IMADS)
    depth = MERKLE_LEAVES.bit_length() - 1
    log(f"10d poseidon hash_n_batch equal to the host hash at L = 1..8 (37 messages each) and "
        f"to its plain version and the host hash at {HASH_SHAPE}; at {HASH_SHAPE} {ms_h:.6f} ms per launch ({B / (ms_h / 1e3):.0f} "
        f"hashes/s; plain {pms_h:.1f} ms; bound {bound_h[0]:.6f} ms by {bound_h[1]}; one chain "
        f"{blocks} permutations, {blocks * POSEIDON_STAGES} product stages); merkle_root of "
        f"{MERKLE_LEAVES} leaves equal to its plain version and the host tree, {ms_m:.6f} ms "
        f"(plain {pms_m:.1f} ms; bound {bound_m[0]:.6f} ms by {bound_m[1]}; {depth} dependent "
        f"levels)   [{smi}]")

    states = elems(POSEIDON_STATES * 3).reshape(POSEIDON_STATES, 3, 16)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PK.permute_batch(states)
    torch.cuda.synchronize()
    t_perm = time.perf_counter() - t0
    t0 = time.perf_counter()
    PK.hash_n_batch(msgs, length)
    torch.cuda.synchronize()
    t_hash = time.perf_counter() - t0
    n_hash = PK.hash_n_batch.launches
    t0 = time.perf_counter()
    PK.merkle_root(leaves)
    torch.cuda.synchronize()
    t_root = time.perf_counter() - t0
    launches = read_counts("Poseidon", "poseidon")
    n_root = launches["poseidon_sponge"] - n_hash
    if (launches["poseidon"], n_hash, n_root) != (1, 1, depth):
        raise AssertionError(f"the Poseidon path launched permute {launches['poseidon']}, the "
                             f"sponge {n_hash} for hash_n_batch and {n_root} for merkle_root, "
                             f"not 1, 1 and {depth}")
    log(f"10d the poseidon path (host clock): permute_batch at {POSEIDON_STATES} states "
        f"{t_perm * 1e3:.3f} ms, hash_n_batch at {HASH_SHAPE} {t_hash * 1e3:.3f} ms (1 launch), "
        f"merkle_root of {MERKLE_LEAVES} leaves {t_root * 1e3:.3f} ms ({n_root} launches)")
    main = widths[POSEIDON_STATES]
    return {"poseidon": dict(err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                             B=POSEIDON_STATES, bound=main["bound"], widths=widths),
            "poseidon_sponge": dict(err=err, ms=ms_h, plain_ms=pms_h, B=HASH_SHAPE, bound=bound_h,
                                    chain_stages=blocks * POSEIDON_STAGES, merkle_ms=ms_m,
                                    merkle_plain_ms=pms_m, merkle_bound=bound_m,
                                    merkle_launches=n_root)}, launches


def phase_keygen_device(pk, smi: str):
    """10e: the compliance key's fixed and sigma columns committed on the
    card (keygen.commit_columns: one iNTT, msm_multi) against the host
    engine's keygen at k = 13: the same points, and a verifying key on
    them with the host key's bytes; both timed."""
    import torch
    from taiga_tpu_torch.circuits.compliance import ComplianceCircuit
    from taiga_tpu_torch.plonk.keygen import VerifyingKey, commit_columns, keygen

    t0 = time.perf_counter()
    host = keygen(ComplianceCircuit(), K)
    t_host = time.perf_counter() - t0
    cols = np.concatenate([host.fixed_mont(), host.sigma_mont()])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = commit_columns(K, cols, "cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    vk, nf = host.vk, len(host.vk.fixed_commitments)
    dev_vk = VerifyingKey(K, vk.cs, vk.perm_cols, pts[:nf], pts[nf:], vk.omega)
    want = pk.vk.to_bytes()
    if vk.to_bytes() != want or dev_vk.to_bytes() != want:
        raise AssertionError("the card's column commitments differ from the host keygen's")
    log(f"10e the compliance key's {len(pts)} column commitments at k={K}: {t_dev:.2f} s on "
        f"the card (commit_columns), the host engine's whole keygen {t_host:.2f} s; verifying "
        f"keys equal byte for byte   [{smi}]")


def phase_parallel(pk, seed: int, dev, smi: str):
    """10f: the sharded layer at world 1 over NCCL in this process:
    sharded_msm_multi (Pippenger, and the bitserial form: one ec_ladder and
    one ec_add_tree launch), ntt_mesh
    (k = 13), batch_hash_step, sharded_point_sum and prove_step against
    their unsharded counterparts, and a grouped create_proofs_batch of 2
    compliance proofs against the ungrouped batch, byte for byte. Launch
    counts zeroed just before, read after (the "parallel" path)."""
    import socket

    import torch
    import torch.distributed as dist
    from taiga_tpu_torch.core.compliance import ComplianceInfo
    from taiga_tpu_torch.crypto.curves import VestaPoint
    from taiga_tpu_torch.ops import ec, limbs as L, msm as TM, ntt, poseidon_kernel as PK
    from taiga_tpu_torch.parallel import sharded as SH
    from taiga_tpu_torch.native import hostops as H
    from taiga_tpu_torch.plonk.native_open import _msm_point
    from taiga_tpu_torch.plonk.prover import create_proofs_batch
    from taiga_tpu_torch.plonk.srs import srs_device

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    group = SH.make_group("cuda", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        r = random.Random(seed)
        gx, gy, gz = (torch.as_tensor(a, device=dev) for a in srs_device(K))
        scal = torch.as_tensor(np.stack([L.ints_to_limbs([r.getrandbits(255) for _ in range(N)])
                                         for _ in range(BITS_COLS)]), device=dev)
        vec = torch.as_tensor(L.FP.array_to_mont([r.getrandbits(254) for _ in range(N)]),
                              device=dev)
        msgs = torch.as_tensor(L.FP.array_to_mont([r.getrandbits(254) for _ in range(4096 * 8)])
                               .reshape(4096, 8, 16), device=dev)
        nb = BITS_POINTS  # one ec_ladder launch over BITS_COLS x nb lanes, then K6's tree
        built = [ComplianceInfo.random(random.Random(seed + 100 + i)).build() for i in range(2)]
        insts = [pis.to_instance() for pis, _ in built]
        circuits = [c for _, c in built]
        want_b = create_proofs_batch(pk, circuits, insts, device="cuda",
                                     randbits=seeded_randbits(seed + 101))
        times = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return out

        zero_counts()
        pip = timed("sharded_msm_multi", lambda: SH.sharded_msm_multi(group, gx, gy, gz, scal))
        before = launch_counts()
        bits = timed("sharded_msm_multi bitserial", lambda: SH.sharded_msm_multi(
            group, gx[:nb], gy[:nb], gz[:nb], scal[:, :nb].contiguous(), strategy="bitserial"))
        in_bits = {name: c - before[name] for name, c in launch_counts().items()}
        mesh = timed("ntt_mesh", lambda: ntt.ntt_mesh(group, vec, K, "fp"))
        hashes = timed("batch_hash_step", lambda: SH.batch_hash_step(group, msgs))
        psum = timed("sharded_point_sum", lambda: SH.sharded_point_sum(group, gx, gy, gz))
        step = timed("prove_step", lambda: SH.prove_step(group, msgs, gx, gy, gz))
        got_b = timed("create_proofs_batch(group)", lambda: create_proofs_batch(
            pk, circuits, insts, randbits=seeded_randbits(seed + 101), group=group))
        launches = read_counts("sharded layer", "parallel")

        pt = lambda a: ec.points_from_device(tuple(a[:, None]), VestaPoint)[0]
        if not torch.equal(pip, TM.msm_multi(gx, gy, gz, scal)):
            raise AssertionError("sharded_msm_multi differs from msm_multi")
        ref_b = TM.msm_multi(gx[:nb], gy[:nb], gz[:nb], scal[:, :nb].contiguous())
        host_b = [_msm_point(K, H.ints_to_u64([v % L.FP.modulus for v in
                                              L.limbs_to_ints(scal[c, :nb])]))
                  for c in range(BITS_COLS)]
        if not [pt(v) for v in bits] == [pt(v) for v in ref_b] == host_b:
            raise AssertionError("the bitserial sharded_msm_multi differs from msm_multi or "
                                 "the host MSM")
        want_bits = {"ec_ladder": 1, "ec_add_tree": 1, "ec_add_select": 0, "ec_double": 0,
                     "ec_add": 0}
        if {name: in_bits[name] for name in want_bits} != want_bits:
            raise AssertionError(f"the bitserial sharded_msm_multi launched {in_bits}, not "
                                 f"{want_bits}")
        if not torch.equal(mesh, ntt.ntt(vec, K, "fp")):
            raise AssertionError("ntt_mesh differs from ntt")
        if not torch.equal(hashes, PK.hash_n_batch(msgs, 8)):
            raise AssertionError("batch_hash_step differs from hash_n_batch")
        pts = ec.points_from_device((gx, gy, gz), VestaPoint)
        if pt(psum) != sum(pts[1:], pts[0]):
            raise AssertionError("sharded_point_sum differs from the host sum")
        if not (torch.equal(step[0], hashes) and torch.equal(step[1], psum)):
            raise AssertionError("prove_step differs from its two parts")
        if got_b != want_b:
            raise AssertionError("the grouped batch differs from the ungrouped batch")
    finally:
        dist.destroy_process_group()
    log("10f world 1 runs the sharded code and NCCL's collectives but moves nothing between "
        "devices; a multi-card run waits for a multi-card machine")
    log(f"10f the bitserial sharded_msm_multi ({BITS_COLS} x {nb}) equals msm_multi and the host "
        f"MSM; its launches: " + ", ".join(f"{k} {v}" for k, v in in_bits.items() if v))
    log(f"10f sharded layer at world 1 over NCCL, each equal to its unsharded counterpart: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
        + f"; launches {launches}   [{smi}]")
    return launches


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
    spent, t_mark = {}, [t_start]

    def mark(what: str):  # the time since the last mark, for the last lines
        now = time.perf_counter()
        spent[what] = now - t_mark[0]
        t_mark[0] = now

    kind, smi = phase_device()
    phase_build()
    mark("1-3 device and build")
    log(json.dumps({"kernels": [name for name, _, _, _, _ in KERNELS]}))
    from taiga_tpu_torch.circuits.compliance import ComplianceCircuit

    source = key_source(ComplianceCircuit, K)
    t0 = time.perf_counter()
    pk = T.compliance_proving_key(K)
    t_key = time.perf_counter() - t0
    log(f"compliance key k={K} (host, native engine): {source} in {t_key:.2f} s")
    dev = torch.device("cuda")
    res = phase_kernels(pk, args.seed, dev)
    mark("4 kernels")
    launches, launches_d, native, device, proof = phase_prove(pk, args.seed)
    mark("5 proofs")
    launches_b, stages_b, tb = phase_batch(pk, args.seed, proof)
    mark("7 batch and pipeline")
    launches_tx, launches_leg, transparent, shielded = phase_tx(args.seed, smi)
    mark("8 transactions")
    launches_vir, vir_key = phase_vamp_ir(args.seed + 40, smi)
    phase_service(smi, transparent, shielded)
    phase_key_cache({"compliance": (ComplianceCircuit, K, source, t_key), "vamp_ir": vir_key},
                    smi)
    mark("9 node-facing surface")
    t10 = time.perf_counter()
    rng10 = np.random.default_rng(args.seed + 50)
    gen10 = torch.Generator(device=dev)
    gen10.manual_seed(args.seed + 50)
    group_law, launches_gl = phase_group_law(rng10, gen10, dev, smi)
    res["ec_double"] = group_law["ec_double"]
    res["ec_ladder"] = group_law["ec_ladder"]
    res["ec_add_select"]["widths"] = group_law["ec_add_select"]["widths"]
    res["ec_add_tree"] = group_law["ec_add_tree"]
    k6 = group_law["ec_add"]  # K6 at 1,024 lanes
    res["ec_add"].update(narrow_ms=k6["ms"], narrow_bound=k6["bound"], narrow_B=k6["B"])
    launches_ipa = phase_ipa_list(args.seed + 51, smi)
    res_p, launches_pos = phase_poseidon(rng10, dev, smi)
    res.update(res_p)
    phase_keygen_device(pk, smi)
    launches_par = phase_parallel(pk, args.seed + 52, dev, smi)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s")
    mark("10 last modules")
    by_path = {"native": launches, "device": launches_d, "group_law": launches_gl,
               "ipa_list": launches_ipa, "poseidon": launches_pos, "parallel": launches_par}

    for what, (stages, total) in (("native IPA", native), ("device IPA", device)):
        log(f"stage wall times of a warm k={K} proof, {what}, on {smi}:")
        for name, sec in stages:
            log(f"  {name:28s} {sec * 1e3:10.1f} ms")
        log(f"  {'total (prove_compliance)':28s} {total * 1e3:10.1f} ms   [{smi}]")
    log(f"stage wall times of a warm lockstep batch of {BATCH} k={K} proofs on {smi}:")
    for name, sec in stages_b:
        log(f"  {name:32s} {sec * 1e3:10.1f} ms")
    log(f"  {'total (prove_compliance_batch)':32s} {tb['t_warm'] * 1e3:10.1f} ms   [{smi}]")
    log(f"throughput at k={K} on {smi}: single warm proof {native[1]:.3f} s "
        f"({1 / native[1]:.4f} proofs/s); lockstep batch of {BATCH} {BATCH / tb['t_warm']:.4f} "
        f"proofs/s; pipelined {PIPE_PROOFS} in chunks of {BATCH} "
        f"{PIPE_PROOFS / tb['t_pipe']:.4f} proofs/s; {BATCH} with {RL_PIPE} trivial "
        f"resource-logic proofs after them {tb['t_two']:.3f} s in all")
    log("time by phase: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, attr, src, replaces, paths in KERNELS:
        r = res[name]
        # "launches": the run of the kernel's main path, its first path
        # (phase 5's proof for K1-K5 and the chained forms); K7 is on no
        # path since ec_ladder chains it
        main_path = next((p for p in paths if p in by_path), None)
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": by_path[main_path][name] if main_path else 0,
                     "launches_path": main_path,
                     "launches_proof": launches[name], "launches_device": launches_d[name],
                     "launches_batch": launches_b[name],
                     "launches_tx": launches_tx[name], "launches_leg": launches_leg[name],
                     "launches_vamp_ir": launches_vir[name],
                     "launches_group_law": launches_gl[name],
                     "launches_ipa_list": launches_ipa[name],
                     "launches_poseidon": launches_pos[name],
                     "launches_parallel": launches_par[name],
                     "max_abs_err": r["err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                     "library_ms": None, "ms_traces": TRACES.get(name)})
        if "narrow_ms" in r:  # K6 at 1,024 lanes (phase 10a)
            rows[-1].update(narrow_ms=r["narrow_ms"], narrow_B=r["narrow_B"],
                            narrow_bound_ms=r["narrow_bound"][0],
                            narrow_bound_by=r["narrow_bound"][1])
        if "chain_adds" in r:  # ec_add_tree: one chain's dependent adds
            rows[-1].update(chain_adds=r["chain_adds"])
        if "merkle_ms" in r:  # the sponge: merkle_root of MERKLE_LEAVES, a launch a level
            rows[-1].update(chain_stages=r["chain_stages"], merkle_ms=r["merkle_ms"],
                            merkle_plain_ms=r["merkle_plain_ms"],
                            merkle_bound_ms=r["merkle_bound"][0],
                            merkle_bound_by=r["merkle_bound"][1],
                            merkle_launches=r["merkle_launches"])
        if "widths" in r:  # K7, the doubling (10a) and Poseidon (10d) at several widths
            rows[-1].update({f"{k}_by_width": {B: w[k] for B, w in r["widths"].items()}
                             for k in ("ms", "plain_ms")},
                            bound_ms_by_width={B: w["bound"][0] for B, w in r["widths"].items()})
        if "stages" in r:  # ec_ladder: one chain's product stages; the shared-scalar ladder
            rows[-1].update(chain_stages=r["stages"], shared_ms=r["shared_ms"],
                            shared_B=W_GROUP, shared_bound_ms=r["shared_bound"][0],
                            shared_chain_stages=r["shared_stages"])
        if "batch" in r:  # the kernel at the width of its launch in a lockstep batch
            b = r["batch"]
            rows[-1].update(batch_ms=b["ms"], batch_plain_ms=b["plain_ms"],
                            batch_bound_ms=b["bound"][0], batch_bound_by=b["bound"][1])
        if name == "mont_inv":
            rows[-1].update(chain_stages=INV_STAGES)
        if "shapes" in r:  # K11-K14 at each of the main path's calls
            rows[-1].update(shapes=r["shapes"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
