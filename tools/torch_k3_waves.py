#!/usr/bin/env python3
"""Time K3 (taiga_tpu_torch.ops.ff_kernels.ec_add_proj_sel_lm) of one
checkout of the PyTorch/CUDA port on one CUDA card, so that two checkouts'
K3 can be compared in one run, and say what sets its time.

1. Selections: at 262,144 lanes (a fixed-base chunk's mixed blocks, the
   width chip_smoke.py times K3 at) with half the lanes selected at random,
   none, all, and one in 32: device time per launch (torch.profiler, mean
   over 50 launches).
2. Waves: 128 x SMs x m lanes for m = 1 .. 12, with one lane of each 128
   selected and with all selected. For a kernel of 128-lane blocks, the m
   at which the time steps up is the number of blocks an SM holds at once;
   where one lane in 128 costs what 128 do, a launch's time is the latency
   of a wave of resident blocks, not the work it issues.
3. The built library's kernels: registers, shared memory, local memory
   and stack (cuobjdump -res-usage), and the number of SASS instructions
   in each, IMADs apart (cuobjdump -sass; a static count: the field
   products are unrolled, so it is close to what one thread issues for
   one add).

Usage: python3 tools/torch_k3_waves.py [--root CHECKOUT] [--seed 7]
--root is the checkout whose taiga_tpu_torch is imported (and built into
its own csrc/build/); it defaults to this one. Needs one CUDA device and
the CUDA toolkit; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

W_SEL = 8 * 256 * 128  # chip_smoke.py's W_EC_ADD_SEL
GROUP = 128            # lanes of a group, one of them selected in the sparse scan
WAVE_STEPS = range(1, 13)


def device_ms(fn, reps: int) -> float:
    """Mean device time of the point-add kernels fn launches, over reps calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and "ec_add" in e.name]
    if 2 * len(ts) < reps:
        raise AssertionError(f"the profiler saw {len(ts)} of {reps} launches")
    return sum(ts) / len(ts)


def tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found")


def demangle(names: list[str]) -> dict[str, str]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    # drop the parameter list (the last parenthesis), keep template arguments
    return {n: (d[:d.rfind("(")] if d.endswith(")") else d).removeprefix("void ")
            for n, d in zip(names, out)}


def kernel_resources(so: str) -> dict:
    """Per kernel of the library: REG, SHARED, LOCAL, STACK and its SASS
    instruction count (all, and IMAD*)."""
    cuobjdump = tool("cuobjdump")
    res, cur = {}, None
    usage = subprocess.run([cuobjdump, "-res-usage", so], capture_output=True, text=True,
                           check=True).stdout
    for line in usage.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            cur = res.setdefault(m.group(1), {})
            continue
        if cur is not None and "REG:" in line:
            for key in ("REG", "SHARED", "LOCAL", "STACK"):
                m = re.search(rf"\b{key}:(\d+)", line)
                if m:
                    cur[key.lower()] = int(m.group(1))
            cur = None
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = res.setdefault(m.group(1), {})
            cur["sass"], cur["imad"] = 0, 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is not None and m:
            cur["sass"] += 1
            cur["imad"] += m.group(1).startswith("IMAD")
    names = demangle(list(res))
    return {names[k]: v for k, v in res.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_waves: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK

    if not FK.__file__.startswith(root):
        raise AssertionError(f"imported {FK.__file__}, not the checkout at {root}")
    CK.build()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{root}: {torch.cuda.get_device_name(0)}, {sms} SMs; nvidia-smi: {smi}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def fe(B):
        x = torch.randint(0, 1 << 16, (16, B), generator=gen, dtype=torch.int32, device=dev)
        x[15] &= 0x3FFF
        return x

    pts = [fe(W_SEL) for _ in range(6)]
    sels = {"half": torch.randint(0, 2, (1, W_SEL), generator=gen, dtype=torch.int32,
                                  device=dev),
            "zero": torch.zeros((1, W_SEL), dtype=torch.int32, device=dev),
            "one": torch.ones((1, W_SEL), dtype=torch.int32, device=dev),
            "1in32": (torch.randint(0, 32, (1, W_SEL), generator=gen, device=dev) == 0).int()}
    selections = {}
    for case, sel in sels.items():
        selections[case] = device_ms(lambda: FK.ec_add_proj_sel_lm(*pts, sel, "fq"), 50)
        print(f"K3 at {W_SEL} lanes, {case} selected ({int(sel.sum())} adds): "
              f"{selections[case]:.6f} ms", flush=True)

    waves = {"one in 128": [], "all": []}
    for m in WAVE_STEPS:
        B = GROUP * sms * m
        p = [v[:, :B].contiguous() for v in pts]
        one = torch.zeros((1, B), dtype=torch.int32, device=dev)
        one[0, ::GROUP] = 1
        for case, sel in (("one in 128", one), ("all", torch.ones_like(one))):
            waves[case].append(device_ms(lambda: FK.ec_add_proj_sel_lm(*p, sel, "fq"), 20))
        print(f"K3 at {B} lanes ({m} x 128 an SM): one in 128 selected "
              f"{waves['one in 128'][-1]:.6f} ms, all {waves['all'][-1]:.6f} ms", flush=True)

    kernels = kernel_resources(CK._so_path("ec_add_proj"))
    for name, r in kernels.items():
        print(f"  {name}: {r}", flush=True)
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "sms": sms, "lanes": W_SEL, "selections_ms": selections,
                      "wave_groups_per_sm": list(WAVE_STEPS), "waves_ms": waves,
                      "kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
