#!/usr/bin/env python3
"""Time the Jacobian kernels of one checkout of the PyTorch/CUDA port on one
CUDA card -- K7 (ec_add_select_lm), the doubling (ec_double_lm), the two
ladders over them (ops/ec.py::ec_scalar_mul_shared and
parallel/sharded.py::_local_msm_bitserial) and, where the checkout has it,
their one-launch form ec_ladder_lm -- so that two checkouts can be compared
in one run.

Widths: K7 and the doubling at 1,024, 2,048 and 1,048,576 lanes (random
limbs; K7 with half the lanes selected at random); ec_scalar_mul_shared at
4,096 lanes and the bitserial MSM at 2 columns x 1,024 points (the first
SRS points at k = 13, random 255-bit scalars); ec_ladder with one shared
scalar at 4,096 and 1,024 lanes and per lane at 2 x 1,024 and 1 x 1,024
(what redoing each point's doublings in every column costs), and at
1 x 1,024 with the shared scalar in every lane (the cost of lanes whose
bits differ). Every time is
the stream time per call between two CUDA events, after a warm-up call.
Also prints cuobjdump's resource usage of csrc/ec_add_jac.cu's kernels
(registers, shared memory, SASS counts). Holding the kernels against their
plain versions is chip_smoke.py's phase 10a, not this tool's.

Usage: python3 tools/torch_ladder_times.py [--root CHECKOUT] [--seed 7]
--root is the checkout whose taiga_tpu_torch is imported (and built into its
own csrc/build/); it defaults to this one. Needs one CUDA device and the
CUDA toolkit; prints one JSON object as its last line. It imports nothing
of chip_smoke.py (its own cuda_ms is chip_smoke.py's): a parent checkout's
chip_smoke.py may differ, and this tool must time both checkouts alike.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from torch_k3_waves import kernel_resources

SINGLE_WIDTHS = (1024, 2048, 1 << 20)
LADDER_LANES = 4096   # chip_smoke.py's W_GROUP
BITS_COLS, BITS_POINTS = 2, 1024


def cuda_ms(fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ladder_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ec, ff_kernels as FK, limbs as L
    from taiga_tpu_torch.parallel import sharded as SH
    from taiga_tpu_torch.plonk.srs import srs_device

    if not FK.__file__.startswith(root):
        raise AssertionError(f"imported {FK.__file__}, not the checkout at {root}")
    CK.build(force=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    has_ladder = hasattr(FK, "ec_ladder_lm")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    def fe(B):
        x = torch.randint(0, 1 << 16, (16, B), generator=gen, dtype=torch.int32, device=dev)
        x[15] &= 0x3FFF
        return x

    times = {}
    wide = [fe(SINGLE_WIDTHS[-1]) for _ in range(6)]
    half = torch.randint(0, 2, (1, SINGLE_WIDTHS[-1]), generator=gen, dtype=torch.int32,
                         device=dev)
    for B in SINGLE_WIDTHS:
        pts = [v[:, :B].contiguous() for v in wide]
        sel = half[:, :B].contiguous()
        reps = 20 if B > 4096 else 50
        times[f"ec_add_select_{B}"] = cuda_ms(lambda: FK.ec_add_select_lm(*pts, sel, "fq"), reps)
        times[f"ec_double_{B}"] = cuda_ms(lambda: FK.ec_double_lm(*pts[:3], "fq"), reps)
        print(f"K7 at {B}: {times[f'ec_add_select_{B}']:.6f} ms; doubling "
              f"{times[f'ec_double_{B}']:.6f} ms", flush=True)
    del wide, half

    gx, gy, gz = (torch.as_tensor(a, device=dev) for a in srs_device(13))
    r = np.random.default_rng(args.seed + 1)
    s = int.from_bytes(r.bytes(32), "little") >> 1
    sl = torch.as_tensor(L.int_to_limbs(s), device=dev)
    rows = tuple(v[:LADDER_LANES] for v in (gx, gy, gz))
    times["ec_scalar_mul_shared_4096"] = cuda_ms(
        lambda: ec.ec_scalar_mul_shared(rows, sl, L.FQ), 5)
    scal = torch.as_tensor(rng.integers(0, 1 << 16, (BITS_COLS, BITS_POINTS, 16), dtype=np.int32),
                           device=dev)
    scal[..., 15] &= 0x7FFF  # 255-bit scalars
    brow = tuple(v[:BITS_POINTS] for v in (gx, gy, gz))
    times["bitserial_2x1024"] = cuda_ms(lambda: SH._local_msm_bitserial(*brow, scal, "fq"), 5)
    print(f"ec_scalar_mul_shared at {LADDER_LANES}: {times['ec_scalar_mul_shared_4096']:.6f} ms; "
          f"bitserial MSM {BITS_COLS} x {BITS_POINTS}: {times['bitserial_2x1024']:.6f} ms",
          flush=True)
    if has_ladder:
        for n in (LADDER_LANES, BITS_POINTS):
            base = [v[:n].T.contiguous() for v in (gx, gy, gz)]
            times[f"ec_ladder_shared_{n}"] = cuda_ms(
                lambda: FK.ec_ladder_lm(*base, sl, 255, "fq"), 10)
        times["ec_ladder_lanes_2x1024"] = cuda_ms(
            lambda: FK.ec_ladder_lm(*base, scal, 255, "fq"), 10)
        one = scal[:1].contiguous()  # one column: the doublings not redone
        times["ec_ladder_lanes_1x1024"] = cuda_ms(
            lambda: FK.ec_ladder_lm(*base, one, 255, "fq"), 10)
        same = sl.expand(1, BITS_POINTS, 16).contiguous()  # a scalar a lane, all the same
        times["ec_ladder_lanes_same_1x1024"] = cuda_ms(
            lambda: FK.ec_ladder_lm(*base, same, 255, "fq"), 10)
        ones = torch.full_like(same, 0xFFFF)
        ones[..., 15] = 0x7FFF  # every bit set: an add at every step
        times["ec_ladder_lanes_ones_1x1024"] = cuda_ms(
            lambda: FK.ec_ladder_lm(*base, ones, 255, "fq"), 10)
        by4 = one[:, ::4].repeat_interleave(4, dim=1).contiguous()  # 4 lanes (a warp) alike
        times["ec_ladder_lanes_by4_1x1024"] = cuda_ms(
            lambda: FK.ec_ladder_lm(*base, by4, 255, "fq"), 10)
        print("ec_ladder: " + ", ".join(f"{k} {v:.6f} ms" for k, v in times.items()
                                        if k.startswith("ec_ladder")), flush=True)
    kernels = kernel_resources(CK._so_path("ec_add_jac"))
    for name, res in kernels.items():
        print(f"  {name}: {res}", flush=True)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "ms": times, "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
