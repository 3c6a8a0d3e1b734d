#!/usr/bin/env python3
"""Time the grand products' kernels of one checkout of the PyTorch/CUDA
port on one CUDA card, so that two checkouts can be compared in one run.

K8 mont_inv_lm, K9 mont_cumprod_lm (both directions) and K10's two
entries, perm_terms_lm and lookup_terms_lm, from csrc/grand_product.cu, at
the shapes of one compliance proof and of a lockstep batch of 8 at k = 13
(P permutation columns in chunks of PERM_CHUNK, L lookups a proof, rows of
n = 8,192). Each kernel is timed twice: the stream time per call between
two CUDA events, after a warm-up call, and its device time per call from
torch.profiler (the kernels' own durations summed, with the fastest and
slowest launch; the profiler first, as chip_smoke.py times them). With
--check, each kernel is first held against its plain version on the same
inputs, bit for bit (a short first call of a new build); chip_smoke.py
holds them all. Also prints
cuobjdump's resource usage of the source's kernels (registers, shared
memory, SASS counts).

Usage: python3 tools/torch_grand_product_times.py [--root CHECKOUT] [--seed 7] [--check]
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

N = 1 << 13
P, CHUNK, LOOKUPS = 13, 4, 5  # the compliance circuit's permutation columns and lookups
BATCHES = (1, 8)
SYMBOLS = {"mont_inv": ("k_mont_inv",), "mont_cumprod": ("k_cumprod_totals", "k_cumprod_apply"),
           "perm_terms": ("k_perm_terms",), "lookup_terms": ("k_lookup_terms",)}


def device_ms(fn, reps: int, syms) -> dict:
    """fn() run reps times under torch.profiler: the device time per call of
    the kernels named by syms, and their fastest and slowest launch, ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = [e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and any(s in e.name() for s in syms)]
    return {"per_call": sum(ms) / reps, "min": min(ms), "max": max(ms), "launches": len(ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--check", action="store_true",
                    help="hold each kernel against its plain version first")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_grand_product_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK

    if not FK.__file__.startswith(root):
        raise AssertionError(f"imported {FK.__file__}, not the checkout at {root}")
    CK.build(force=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def fe(*shape):  # element-major random canonical elements (< 2^254 < p)
        x = torch.randint(0, 1 << 16, shape + (16,), generator=gen, dtype=torch.int32,
                          device=dev)
        x[..., 15] &= 0x3FFF
        return x

    def check(name, fn):
        if not args.check:
            return
        got = fn()
        with FK.plain_versions():
            want = fn()
        got, want = ((t,) if torch.is_tensor(t) else t for t in (got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        print(f"  {name}: equal to its plain version", flush=True)

    times, device = {}, {}
    for B in BATCHES:
        C = -(-P // CHUNK)
        cols, sigma, omega = fe(B, P, N), fe(P, N), fe(N)
        beta, gamma, delta = fe(B), fe(B), fe(P)
        lk = [fe(B, LOOKUPS, N) for _ in range(4)]
        rows = fe(B * C, N)
        tot = rows[:, -1].contiguous()
        calls = {
            "mont_inv": lambda: FK.mont_inv_lm(tot),
            "mont_cumprod": lambda: FK.mont_cumprod_lm(rows),
            "mont_cumprod reverse": lambda: FK.mont_cumprod_lm(rows, reverse=True),
            "perm_terms": lambda: FK.perm_terms_lm(cols, sigma, omega, beta, gamma, delta,
                                                   CHUNK),
            "lookup_terms": lambda: FK.lookup_terms_lm(*lk, beta, gamma)}
        for name, fn in calls.items():
            check(f"{name}[B={B}]", fn)
            key = f"{name} B={B}"
            device[key] = device_ms(fn, 20, SYMBOLS[name.split()[0]])
            times[key] = cuda_ms(fn, 50)
            d = device[key]
            print(f"{key}: {times[key]:.6f} ms (events); device {d['per_call']:.6f} ms a call, "
                  f"launches {d['min']:.6f}-{d['max']:.6f} ms (profiler)", flush=True)
        del cols, sigma, lk, rows

    kernels = kernel_resources(CK._so_path("grand_product"))
    for k, r in sorted(kernels.items()):
        print(f"  {k}: {r}", flush=True)
    print(json.dumps({"root": root, "device": smi, "ms": times, "device_ms": device,
                      "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
