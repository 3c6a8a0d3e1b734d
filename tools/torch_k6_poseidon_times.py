#!/usr/bin/env python3
"""Time K6, its chained form ec_add_tree and the Poseidon kernels of one
checkout of the PyTorch/CUDA port on one CUDA card, so that two checkouts
can be compared in one run.

K6 (ec_add_lm) at 1,048,576 and 1,024 lanes (random limbs), beside K7
(ec_add_select_lm) with every lane selected at the same widths; each
column's halving tree at 2 x 1,024 (parallel/sharded.py::
_local_msm_bitserial's): as one ec_add_tree launch where the checkout has
it, and as the level-by-level loop of K6 launches over half-column copies;
the bitserial MSM (_local_msm_bitserial) at 2 x 1,024 (the first SRS
points at k = 13, random 255-bit scalars); the Poseidon permutation
(permute_batch) at 4,096, 16,384 and 1,048,576 states, hash_n_batch at
(4,096, 8) and merkle_root of 2^14 leaves. Every time is the stream time
per call between two CUDA events, after a warm-up call. Also prints
cuobjdump's resource usage of csrc/ec_add_jac.cu's and csrc/poseidon.cu's
kernels (registers, shared memory, SASS counts). Holding the kernels
against their plain versions is chip_smoke.py's phases 4 and 10, not this
tool's.

Usage: python3 tools/torch_k6_poseidon_times.py [--root CHECKOUT] [--seed 7]
--root is the checkout whose taiga_tpu_torch is imported (and built into its
own csrc/build/); it defaults to this one. Needs one CUDA device and the
CUDA toolkit; prints one JSON object as its last line. It imports nothing
of chip_smoke.py: a parent checkout's chip_smoke.py may differ, and this
tool must time both checkouts alike.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from torch_k3_waves import kernel_resources
from torch_ladder_times import cuda_ms

K6_WIDTHS = (1024, 1 << 20)
BITS_COLS, BITS_POINTS = 2, 1024
POSEIDON_STATES = (4096, 16384, 1 << 20)
HASH_SHAPE = (4096, 8)
MERKLE_LEAVES = 1 << 14


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k6_poseidon_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK
    from taiga_tpu_torch.ops import poseidon_kernel as PK
    from taiga_tpu_torch.parallel import sharded as SH
    from taiga_tpu_torch.plonk.srs import srs_device

    if not FK.__file__.startswith(root):
        raise AssertionError(f"imported {FK.__file__}, not the checkout at {root}")
    out = CK.build(force=True)
    for name in ("ec_add_jac", "poseidon"):
        for line in out.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    has_tree = hasattr(FK, "ec_add_tree_lm")

    def fe(B):
        x = torch.randint(0, 1 << 16, (16, B), generator=gen, dtype=torch.int32, device=dev)
        x[15] &= 0x3FFF
        return x

    times = {}
    wide = [fe(K6_WIDTHS[-1]) for _ in range(6)]
    ones = torch.ones((1, K6_WIDTHS[-1]), dtype=torch.int32, device=dev)
    for B in K6_WIDTHS:
        pts = [v[:, :B].contiguous() for v in wide]
        sel = ones[:, :B].contiguous()
        reps = 20 if B > 4096 else 50
        times[f"ec_add_{B}"] = cuda_ms(lambda: FK.ec_add_lm(*pts, "fq"), reps)
        times[f"ec_add_select_all_{B}"] = cuda_ms(lambda: FK.ec_add_select_lm(*pts, sel, "fq"),
                                                  reps)
        print(f"K6 at {B}: {times[f'ec_add_{B}']:.6f} ms; K7, every lane selected, "
              f"{times[f'ec_add_select_all_{B}']:.6f} ms", flush=True)
    del wide, ones

    gx, gy, gz = (torch.as_tensor(a, device=dev) for a in srs_device(13))
    scal = torch.as_tensor(rng.integers(0, 1 << 16, (BITS_COLS, BITS_POINTS, 16), dtype=np.int32),
                           device=dev)
    scal[..., 15] &= 0x7FFF  # 255-bit scalars
    brow = tuple(v[:BITS_POINTS] for v in (gx, gy, gz))
    base = [v.T.contiguous() for v in brow]
    acc = FK.ec_ladder_lm(*base, scal, 255, "fq")

    def k6_loop():  # the parent's tree: K6 a level over half-column copies
        pts, n = acc, BITS_POINTS
        while n > 1:
            h = n // 2
            cols = [v.reshape(16, BITS_COLS, n) for v in pts]
            pts = FK.ec_add_lm(*(v[:, :, :h].reshape(16, -1).contiguous() for v in cols),
                               *(v[:, :, h:].reshape(16, -1).contiguous() for v in cols), "fq")
            n = h
        return pts

    times["tree_k6_loop_2x1024"] = cuda_ms(k6_loop, 20)
    if has_tree:
        times["ec_add_tree_2x1024"] = cuda_ms(lambda: FK.ec_add_tree_lm(*acc, BITS_COLS, "fq"), 20)
    times["bitserial_2x1024"] = cuda_ms(lambda: SH._local_msm_bitserial(*brow, scal, "fq"), 5)
    print("tree: " + ", ".join(f"{k} {v:.6f} ms" for k, v in times.items()
                               if "tree" in k or "bitserial" in k), flush=True)

    def elems(count):
        x = torch.randint(0, 1 << 16, (count, 16), generator=gen, dtype=torch.int32, device=dev)
        x[:, 15] &= 0x3FFF
        return x

    states = elems(3 * POSEIDON_STATES[-1]).reshape(-1, 3, 16)
    for n in POSEIDON_STATES:
        s = states[:n].contiguous()
        reps = 5 if n > 100000 else 20
        times[f"poseidon_{n}"] = cuda_ms(lambda: PK.permute_batch(s), reps)
    del states
    B, length = HASH_SHAPE
    msgs = elems(B * length).reshape(B, length, 16)
    leaves = elems(MERKLE_LEAVES)
    times["hash_n_batch_4096x8"] = cuda_ms(lambda: PK.hash_n_batch(msgs, length), 10)
    times["merkle_root_16384"] = cuda_ms(lambda: PK.merkle_root(leaves), 10)
    print("poseidon: " + ", ".join(f"{k} {v:.6f} ms" for k, v in times.items()
                                   if k.startswith(("poseidon", "hash", "merkle"))), flush=True)
    kernels = {}
    for lib in ("ec_add_jac", "poseidon"):
        kernels.update(kernel_resources(CK._so_path(lib)))
    for name, res in kernels.items():
        print(f"  {name}: {res}", flush=True)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "ms": times, "kernels": kernels}), flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
