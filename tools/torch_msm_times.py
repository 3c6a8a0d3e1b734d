#!/usr/bin/env python3
"""Time the MSM's chained kernels of one checkout of the PyTorch/CUDA port
on one CUDA card, so that two checkouts can be compared in one run.

ec_seg_rounds (K3 chained) at the shapes of a fixed-base chunk (8 columns,
c = 8, k = 13) of ops/msm.py::_blocked_partials: phase B (262,144 lanes of
mixed blocks under block-local keys, tile 128, 7 rounds) and phase C
(20,480 lanes, 15 rounds), and at the general MSMs' rows of 32 windows (32
x 2,048 with 11 rounds, 32 x 4,096 with _compact's 6, and its 32 x 1,024
compacted lanes with 10), and at long runs (32 x 2,048 of 3 digits with 11
rounds; one row of 131,072 lanes under one key with 18); ec_horner (K2
chained) at (W, doublings, L) = (32, 8, 1), (32, 8, 2) and (8, 1, 8); the
bucket weighting of one fixed-base chunk (8 columns of 256 buckets): the
loop of K2 launches over rolled copies with ec_horner that
ops/msm.py::_bucket_sums ran before, and ec_bucket_weights where the
checkout has it; msm_fixed_multi on one chunk
of 8 columns at k = 13 (the SRS's shifted table, random 255-bit scalars)
with the launches of every kernel it makes. Every time is the stream time
per call between two CUDA events, after a warm-up call (a call of several
short launches includes the host's pace between them). With --check, each
kernel is first held against its plain version on the same inputs, bit
for bit (a short first call of a new build); chip_smoke.py holds them all.
Also prints cuobjdump's resource usage of csrc/ec_add_proj.cu's kernels
(registers, shared memory, SASS counts).

Usage: python3 tools/torch_msm_times.py [--root CHECKOUT] [--seed 7] [--check]
--root is the checkout whose taiga_tpu_torch is imported (and built into
its own csrc/build/); it defaults to this one. Needs one CUDA device and
the CUDA toolkit; prints one JSON object as its last line. It imports
nothing of chip_smoke.py, so that a parent checkout is timed alike.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from torch_k3_waves import kernel_resources
from torch_ladder_times import cuda_ms

K = 13
N = 1 << K
COLS, BUCKETS, BLOCK = 8, 256, 128  # a fixed-base chunk: 8 columns, c = 8, _BLOCK
HORNER_SHAPES = ((32, 8, 1), (32, 8, 2), (8, 1, 8))


def seg_shapes(gen, dev):
    """{name: (keys, rounds, tile)} of ec_seg_rounds as ops/msm.py makes
    them: phase B and phase C of one fixed-base chunk (SEG keys as
    chip_smoke.py's seg_keys draws them) and the general MSMs' rows; then
    two row cases of long runs (chip_smoke.py's long_run_keys)."""
    import torch

    total, nb = COLS * 32 * N, COLS * 32 * N // BLOCK
    keys = torch.sort(torch.randint(0, COLS * BUCKETS, (total,), generator=gen,
                                    device=dev)).values
    lo, hi = keys[0::BLOCK], keys[BLOCK - 1::BLOCK]
    mixed = lo != hi
    maxb = min(COLS * BUCKETS, nb)
    posb = mixed.nonzero()[:maxb, 0]
    posb = torch.cat([posb, posb[-1:].expand(maxb - posb.numel())])
    gidx = (posb[:, None] * BLOCK + torch.arange(BLOCK, device=dev)).reshape(-1)
    gkey = keys.index_select(0, gidx)
    blk = torch.arange(maxb, device=dev).repeat_interleave(BLOCK)
    phase_b = (blk * (COLS * BUCKETS + 1) + gkey).contiguous()
    prev = torch.cat([phase_b[:1] ^ 1, phase_b[:-1]])
    starts = ((torch.arange(phase_b.numel(), device=dev) % BLOCK == 0)
              | (phase_b != prev)).nonzero()[:, 0]
    ecap, sent = 2 * COLS * BUCKETS, COLS * BUCKETS
    sk = sent + torch.arange(nb + ecap, dtype=keys.dtype, device=dev)  # a key a spare lane
    mkey = sk[nb:].clone()
    mkey[:min(ecap, starts.numel())] = gkey[starts[:ecap]]
    phase_c = torch.sort(torch.cat([torch.where(mixed, sk[:nb], lo), mkey])).values.contiguous()
    out = {"phase B": (phase_b, BLOCK.bit_length() - 1, BLOCK),
           "phase C": (phase_c, max(1, (phase_c.numel() - 1).bit_length()), 0)}
    d2 = torch.sort(torch.randint(0, BUCKETS, (32, 2048), generator=gen, device=dev), -1).values
    out["rows 32 x 2048"] = (d2.contiguous(), 11, 0)
    d4 = torch.sort(torch.randint(0, BUCKETS, (32, 4096), generator=gen, device=dev), -1).values
    out["rows 32 x 4096"] = (d4.contiguous(), 6, 0)
    idx = torch.arange(4096, device=dev)
    start = torch.cat([torch.ones_like(d4[:, :1], dtype=torch.bool), d4[:, 1:] != d4[:, :-1]], -1)
    seg = torch.cummax(torch.where(start, idx, -1), -1).values
    mask = (idx - seg) % 64 == 0
    pos = torch.sort(torch.where(mask, idx, 4096), -1).values[:, :1024]
    cd = torch.where(pos < 4096, d4.gather(1, pos.clamp(max=4095)),
                     BUCKETS + torch.arange(1024, device=dev))
    out["rows 32 x 1024, compacted"] = (cd.contiguous(), 10, 0)
    d3 = torch.sort(torch.randint(0, 3, (32, 2048), generator=gen, device=dev), -1).values
    out["rows 32 x 2048 of 3 digits"] = (d3.contiguous(), 11, 0)
    one = torch.zeros((1, 1 << 17), dtype=torch.int64, device=dev)
    out["row 1 x 131072 of one key"] = (one, 18, 0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--check", action="store_true",
                    help="hold each kernel against its plain version first")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_msm_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK, msm as TM
    from taiga_tpu_torch.plonk.srs import srs_device

    if not FK.__file__.startswith(root):
        raise AssertionError(f"imported {FK.__file__}, not the checkout at {root}")
    out = CK.build(force=True)
    for line in out.get("ec_add_proj", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"  ptxas ec_add_proj: {line.strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    has_weights = hasattr(FK, "ec_bucket_weights_lm")

    def fe(*shape):
        x = torch.randint(0, 1 << 16, (16,) + shape, generator=gen, dtype=torch.int32,
                          device=dev)
        x[15] &= 0x3FFF
        return x

    def check(name, fn):
        if not args.check:
            return
        got = fn()
        with FK.plain_versions():
            want = fn()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        print(f"  {name}: equal to its plain version", flush=True)

    times, launches = {}, {}
    for name, (keys, rounds, tile) in seg_shapes(gen, dev).items():
        p = [fe(*keys.shape) for _ in range(3)]
        for field in ("fp", "fq") if args.check else ():
            check(f"ec_seg_rounds[{field}, {name}]",
                  lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, field, tile))
        FK.ec_seg_rounds_lm.launches = 0
        FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile)
        launches[f"ec_seg_rounds {name}"] = FK.ec_seg_rounds_lm.launches
        times[f"ec_seg_rounds {name}"] = cuda_ms(
            lambda: FK.ec_seg_rounds_lm(*p, keys, rounds, "fq", tile), 10)
        print(f"ec_seg_rounds {name}: {tuple(keys.shape)} lanes, {rounds} rounds: "
              f"{times[f'ec_seg_rounds {name}']:.6f} ms in "
              f"{launches[f'ec_seg_rounds {name}']} launch(es)", flush=True)
        del p

    for W, d, Lc in HORNER_SHAPES:
        t = [fe(W, Lc) for _ in range(3)]
        for field in ("fp", "fq") if args.check else ():
            check(f"ec_horner[{field}, ({W}, {d}, {Lc})]", lambda: FK.ec_horner_lm(*t, d, field))
        times[f"ec_horner ({W}, {d}, {Lc})"] = cuda_ms(lambda: FK.ec_horner_lm(*t, d, "fq"), 20)
        print(f"ec_horner ({W}, {d}, {Lc}): {times[f'ec_horner ({W}, {d}, {Lc})']:.6f} ms",
              flush=True)

    c = BUCKETS.bit_length() - 1
    buckets = [fe(COLS * BUCKETS) for _ in range(3)]
    empty = torch.rand(COLS * BUCKETS, generator=gen, device=dev) < 0.05
    empty[::BUCKETS] = True
    buckets = list(TM._mask_identity(*buckets, ~empty, "fq"))

    def k2_loop():  # ops/msm.py::_bucket_sums before ec_bucket_weights
        nb = BUCKETS
        bits = torch.arange(c, device=dev)
        keep = ((torch.arange(nb, device=dev)[None, :] >> bits[:, None]) & 1) > 0
        k = keep[:, None, :].expand(c, COLS, nb).reshape(-1)
        t = [v.reshape(16, 1, COLS, nb).expand(16, c, COLS, nb).reshape(16, -1)
             for v in buckets]
        t = list(TM._mask_identity(*t, k, "fq"))
        for r in range(c):
            nxt = [torch.roll(v.reshape(16, c * COLS, nb), -(1 << r), -1).reshape(16, -1)
                   for v in t]
            t = FK.ec_add_proj_lm(*t, *nxt, "fq")
        sel = torch.arange(c * COLS, device=dev) * nb
        terms = [v.index_select(1, sel).reshape(16, c, COLS).contiguous() for v in t]
        return FK.ec_horner_lm(*terms, 1, "fq")

    times["bucket weights: K2 loop + ec_horner"] = cuda_ms(k2_loop, 10)
    if has_weights:
        got = FK.ec_bucket_weights_lm(*buckets, c, "fq")
        if not all(torch.equal(g, w) for g, w in zip(got, k2_loop())):
            raise AssertionError("ec_bucket_weights differs from the K2 loop")
        for field in ("fp", "fq") if args.check else ():
            check(f"ec_bucket_weights[{field}, L = {COLS}]",
                  lambda: FK.ec_bucket_weights_lm(*buckets, c, field))
        times["bucket weights: ec_bucket_weights"] = cuda_ms(
            lambda: FK.ec_bucket_weights_lm(*buckets, c, "fq"), 20)
    print("bucket weights of a chunk: " + ", ".join(
        f"{k.split(': ')[1]} {v:.6f} ms" for k, v in times.items() if k.startswith("bucket")),
        flush=True)

    gx, gy, gz = (torch.as_tensor(a, device=dev) for a in srs_device(K))
    table = TM.fixed_base_table(gx, gy, gz, "fq")
    scal = torch.as_tensor(rng.integers(0, 1 << 16, (COLS, N, 16), dtype=np.int32), device=dev)
    scal[..., 15] &= 0x3FFF
    names = [n for n in ("mont_mul_lm", "ec_add_proj_lm", "ec_add_proj_sel_lm",
                         "ec_seg_rounds_lm", "ec_horner_lm", "ec_bucket_weights_lm")
             if hasattr(FK, n)]
    for n in names:
        getattr(FK, n).launches = 0
    first = TM.msm_fixed_multi(table, scal, "fq")
    launches["msm_fixed_multi"] = {n: getattr(FK, n).launches for n in names}
    chunk = f"msm_fixed_multi, {COLS} columns at k = {K}"
    times[chunk] = cuda_ms(lambda: TM.msm_fixed_multi(table, scal, "fq"), 5)
    if not torch.equal(TM.msm_fixed_multi(table, scal, "fq"), first):
        raise AssertionError("msm_fixed_multi differs between two calls")
    print(f"{chunk}: {times[chunk]:.6f} ms; launches {launches['msm_fixed_multi']}", flush=True)
    kernels = kernel_resources(CK._so_path("ec_add_proj"))
    for name, res in kernels.items():
        print(f"  {name}: {res}", flush=True)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "ms": times, "launches": launches, "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
