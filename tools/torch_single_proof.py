#!/usr/bin/env python3
"""Time one checkout's single compliance proof at k = 13 on one CUDA card,
stage by stage, so that two checkouts of the PyTorch/CUDA port can be
compared in one run (parent, change, change, parent).

The proof is chip_smoke.py's phase 5 native-IPA proof: prove_compliance on
the statement of random.Random(seed) with blinds from
random.Random(seed + 1), cold once, then warm `--proofs` times with a
StageTimer. Prints one JSON object as its last line: the checkout, the
card (nvidia-smi's name and power limit), the kernels' build time, the
keygen time, the cold proof's time, each warm proof's total and stage wall
times in seconds, and the proof's SHA-256 (equal across checkouts whose
proofs are byte-identical).

Usage: python3 tools/torch_single_proof.py [--root CHECKOUT] [--seed 7] [--proofs 3]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--proofs", type=int, default=3)
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
    t0 = time.perf_counter()
    _, _, proof = prove()
    t_cold = time.perf_counter() - t0
    warm = []
    for _ in range(args.proofs):
        timer = StageTimer("cuda")
        t0 = time.perf_counter()
        _, _, again = prove(timer=timer)
        total = time.perf_counter() - t0
        if again != proof:
            raise AssertionError("a warm seeded proof differs from the cold one")
        warm.append({"total": total, "stages": dict(timer.stages)})
        print(f"{root}: warm proof {total:.3f} s", flush=True)
    print(json.dumps({"root": root, "device": smi, "build_s": t_build, "keygen_s": t_keygen,
                      "cold_s": t_cold, "warm": warm,
                      "proof_sha256": hashlib.sha256(proof).hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
