#!/usr/bin/env python3
"""Time one checkout's single compliance proof at k = 13 on one CUDA card,
stage by stage, so that two checkouts of the PyTorch/CUDA port can be
compared in one run (parent, change, change, parent).

The proof is chip_smoke.py's phase 5 native-IPA proof: prove_compliance on
the statement of random.Random(seed) with blinds from
random.Random(seed + 1), cold once and then warm `--proofs` times, each
with a StageTimer. With `--batch B`, then chip_smoke.py's phase 7 lockstep batch
(prove_compliance_batch on the statements of random.Random(seed + i), i <
B, blinds from random.Random(seed + 1)), cold once and warm once with a
StageTimer; each warm run also records the peak device memory it
allocated (torch.cuda.max_memory_allocated, reset just before it). With
`--count-ops`, one more warm proof (and batch) runs
under torch.profiler, restarted at every stage mark, and counts each
stage's device operations (kernels, copies, fills) and their device time.
Prints one JSON object as its last line: the checkout, the card
(nvidia-smi's name and power limit), the kernels' build time, the keygen
time, the cold proof's time and stage wall times, each warm proof's total
and stage wall times in seconds, the SHA-256 of the proof and of the batch's proofs (equal
across checkouts whose proofs are byte-identical), and the counts.

Usage: python3 tools/torch_single_proof.py [--root CHECKOUT] [--seed 7] [--proofs 3]
           [--batch 8] [--count-ops]
--root is the checkout whose taiga_tpu_torch is imported (and built into
its own csrc/build/); it defaults to this one. Needs one CUDA device and
the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import time

K = 13


class StageOps:
    """A stage timer's interface (mark) that counts each stage's device
    operations and their device time: a profiler session a stage, the
    device synchronized before each is stopped."""

    def __init__(self):
        self.stages: list[tuple[str, int, float]] = []
        self._start()

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def mark(self, name: str):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._prof.stop()
        ops, busy = 0, 0.0
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops += 1
                busy += e.duration_ns() / 1e6
        self.stages.append((name, ops, busy))
        self._start()

    def close(self):
        self._prof.stop()
        return {name: {"device_ops": ops, "device_ms": busy} for name, ops, busy in self.stages}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--proofs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_single_proof: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import taiga_tpu_torch as T
    from taiga_tpu_torch.ops import cuda_kernels as CK
    from taiga_tpu_torch.plonk.prover import StageTimer

    if not os.path.abspath(T.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {T.__file__}, not the checkout at {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    def prove(**kw):
        return T.prove_compliance(random.Random(args.seed), K, device="cuda",
                                  randbits=random.Random(args.seed + 1).getrandbits, **kw)

    t0 = time.perf_counter()
    CK.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    T.compliance_proving_key(K)
    t_keygen = time.perf_counter() - t0
    cold_timer = StageTimer("cuda")
    t0 = time.perf_counter()
    _, _, proof = prove(timer=cold_timer)
    t_cold = time.perf_counter() - t0
    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    warm = []
    for _ in range(args.proofs):
        timer = StageTimer("cuda")
        peak_reset()
        t0 = time.perf_counter()
        _, _, again = prove(timer=timer)
        total = time.perf_counter() - t0
        if again != proof:
            raise AssertionError("a warm seeded proof differs from the cold one")
        warm.append({"total": total, "stages": dict(timer.stages),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        print(f"{root}: warm proof {total:.3f} s", flush=True)
    out = {"root": root, "device": smi, "build_s": t_build, "keygen_s": t_keygen,
           "cold_s": t_cold, "cold_stages": dict(cold_timer.stages), "warm": warm,
           "proof_sha256": hashlib.sha256(proof).hexdigest()}
    if args.count_ops:
        ops = StageOps()
        prove(timer=ops)
        out["proof_ops"] = ops.close()
    if args.batch:
        def batch(**kw):
            t0 = time.perf_counter()
            _, _, proofs = T.prove_compliance_batch(
                [random.Random(args.seed + i) for i in range(args.batch)], K, device="cuda",
                randbits=random.Random(args.seed + 1).getrandbits, **kw)
            return proofs, time.perf_counter() - t0

        cold_b, out["batch_cold_s"] = batch()
        timer = StageTimer("cuda")
        peak_reset()
        warm_b, total = batch(timer=timer)
        if warm_b != cold_b:
            raise AssertionError("a warm seeded batch differs from the cold one")
        out["batch_warm"] = {"total": total, "stages": dict(timer.stages),
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        out["batch_sha256"] = hashlib.sha256(b"".join(cold_b)).hexdigest()
        print(f"{root}: warm batch of {args.batch} {total:.3f} s", flush=True)
        if args.count_ops:
            ops = StageOps()
            batch(timer=ops)
            out["batch_ops"] = ops.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
