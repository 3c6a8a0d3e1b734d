#!/usr/bin/env python3
"""Time the hand kernels of one checkout of the PyTorch/CUDA port on one
CUDA card, slice by slice, so that two checkouts can be compared in one run.

A slice is a row of SLICES: the wrapper that marks the checkout as having
its kernels, its source in csrc/, the kernels' symbols, and its calls at
the main path's shapes of a k = 13 compliance proof and a lockstep batch
of 8. A later kernel slice adds a row.

  grand_products  K8 mont_inv_lm, K9 mont_cumprod_lm (both directions) and
                  K10 perm_terms_lm / lookup_terms_lm at a proof's and a
                  batch's shapes (P permutation columns in chunks of
                  CHUNK, LOOKUPS lookups a proof, rows of 2^13); K9 on
                  the cold table build's batch_inv row (1, 262,144) in
                  Fq; then
                  K9's powers tables (powers_lm) at the main path's calls:
                  a proof's query evaluations (6 points) and x3
                  evaluation (1) of 2^13 - 1, packed as K12 takes them,
                  K14's tables (6 of 2^13 + 1) as limbs, and a batch's
                  (48, 8, 48). A checkout before K9's powers entry runs
                  ops/poly.py::powers, a scan of the expanded row (K9's
                  mont_cumprod_lm), as limbs.
  ntt             the public transforms of ops/ntt.py: a proof's and a
                  batch's 12 advice columns into coefficients (intt,
                  (1, 12, 2^13) and (8, 12, 2^13)), their
                  extension (coset_ntt, (1, 12, 2^16)) and a batch's
                  ((8, 12, 2^16)) as to_ext calls it: n / 8 coefficients
                  a row through coset_ntt's `nonzero`, or, in a checkout
                  whose coset_ntt has none, the rows padded with zeros
                  beforehand (the padding not timed), and a batch's
                  quotient back (coset_intt, (8, 1, 2^16)), and an Fq
                  iNTT ((2, 2^13)); then, where the
                  checkout chooses K11's radix (FK.ntt_radix_log), each of
                  them at each radix, 4 and 2. A checkout before K11
                  runs them as plain torch ops, and is timed all the same.
  poly            the public programs of ops/poly.py at a proof's and a
                  batch's shapes (B = 1, 8): the query evaluations
                  (eval_polys_at_points, (B, C, 2^13) at (B, Q) points),
                  the multiopen's weighted sum of its widest point group
                  and of its G groups (mont_linear_combo), its aggregate
                  of every group gathered from the C columns and its f =
                  h + the groups' weighted sum (mont_linear_combo_groups;
                  a checkout without it runs the multiopen's route before
                  it: index_select, mont_linear_combo a group and
                  torch.stack; mont_linear_combo and limbs.add), its division
                  (synthetic_div, (B, G, 2^13), a point a polynomial) and
                  its x3 evaluation ((B, G, 2^13) at one point); and a
                  trivial resource logic's query evaluations ((1, 81,
                  2^12) at 6 points). A checkout before K12-K14 runs
                  them as plain torch ops.
  lookup          the last plain-torch programs of the main path at a
                  proof's and a batch's shapes (B = 1, 8): the lookups'
                  permuted pairs (lookup_sort.permute_pairs_device, (5 B,
                  2^13) rows of u = 2^13 - 9, A drawn with repeats from S),
                  the Montgomery conversion of an advice commit's columns
                  (from_mont_lm, or limbs.from_mont, (B, 12, 2^13)), a
                  fixed-base chunk's window digits and packed sort keys
                  (msm_digits_lm, or the plain _digits_all loop and packing,
                  (8, 2^13) scalars at c = 8) and its projective-to-Jacobian
                  products (msm._to_jacobian over 8 columns). A checkout
                  before K15-K17 runs them as plain torch ops.

Each call is timed three ways: the stream time between two CUDA events
after a warm-up call; under torch.profiler, its device operations (kernels,
copies, fills) and their summed device time, each kernel's time by name,
and the slice's own kernels' launches, time and fastest and slowest launch;
and, where the checkout has
the slice's kernels, the plain version's time (ff_kernels.plain_versions,
CUDA events, one call). With --check each call is first held against its
plain version bit for bit (a short first call of a new build;
chip_smoke.py holds them all). Also prints cuobjdump's resource usage of
each slice's library (registers, shared memory, SASS counts).

Usage: python3 tools/torch_kernel_times.py [--root CHECKOUT] [--slice NAME]... [--seed 7] [--check]
--root is the checkout whose taiga_tpu_torch is imported (and built into
its own csrc/build/); it defaults to this one. --slice picks slices (all by
default). Needs one CUDA device and the CUDA toolkit; prints one JSON
object as its last line. It imports nothing of chip_smoke.py, so that a
parent checkout is timed alike.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from torch_k3_waves import kernel_resources
from torch_ladder_times import cuda_ms

K = 13
N = 1 << K
P, CHUNK, LOOKUPS = 13, 4, 5  # the compliance circuit's permutation columns and lookups
BATCH = 8


K9 = ("k_cumprod_cluster", "k_cumprod_totals", "k_cumprod_apply")  # K9's kernels, old and new
# the powers tables at the main path's calls, (what, points, n, packed): K12's
# (query evals, x3) packed, K14's as limbs
POWERS = (("query evals", 6, N - 1, True), ("x3", 1, N - 1, True),
          ("K14 tables", 6, N + 1, False), ("query evals", 6 * BATCH, N - 1, True),
          ("x3", BATCH, N - 1, True), ("K14 tables", 6 * BATCH, N + 1, False))


BATCH_INV_N = 32 * N  # the cold table build's batch_inv row


def grand_product_calls(mods, fe):
    """(name, fn, symbols) at a proof's and a batch's shapes."""
    FK, PL = mods["FK"], mods["PL"]
    calls = []
    for B in (1, BATCH):
        C = -(-P // CHUNK)
        cols, sigma, omega = fe(B, P, N), fe(P, N), fe(N)
        beta, gamma, delta = fe(B), fe(B), fe(P)
        lk = [fe(B, LOOKUPS, N) for _ in range(4)]
        rows = fe(B * C, N)
        tot = rows[:, -1].contiguous()
        calls += [
            (f"mont_inv B={B}", lambda tot=tot: FK.mont_inv_lm(tot), ("k_mont_inv",)),
            (f"mont_cumprod B={B}", lambda rows=rows: FK.mont_cumprod_lm(rows), K9),
            (f"mont_cumprod reverse B={B}",
             lambda rows=rows: FK.mont_cumprod_lm(rows, reverse=True), K9),
            (f"perm_terms B={B}",
             lambda a=(cols, sigma, omega, beta, gamma, delta): FK.perm_terms_lm(*a, CHUNK),
             ("k_perm_terms",)),
            (f"lookup_terms B={B}", lambda a=(*lk, beta, gamma): FK.lookup_terms_lm(*a),
             ("k_lookup_terms",)),
        ]
    zs = fe(1, BATCH_INV_N)
    calls.append((f"mont_cumprod batch_inv (1, {BATCH_INV_N}) fq",
                  lambda a=zs: FK.mont_cumprod_lm(a, "fq"), K9))
    for what, Q, n, packed in POWERS:
        if hasattr(FK, "powers_lm"):
            fn = (lambda x=fe(Q), n=n, packed=packed: FK.powers_lm(x, n, "fp", packed))
        else:  # a checkout before K9's powers entry: poly.powers scans as limbs
            fn = (lambda x=fe(Q), n=n: PL.powers(x, n))
        calls.append((f"powers {what} ({Q}, {n})", fn, ("k_powers",) + K9))
    return calls


def ntt_calls(mods, fe):
    import inspect

    import torch

    FK, NT = mods["FK"], mods["NT"]
    nonzero = "nonzero" in inspect.signature(NT.coset_ntt).parameters
    calls = []
    for fname, batch, k, field in (("intt", (1, 12), K, "fp"), ("intt", (BATCH, 12), K, "fp"),
                                   ("coset_ntt", (1, 12), K + 3, "fp"),
                                   ("coset_ntt", (BATCH, 12), K + 3, "fp"),
                                   ("coset_intt", (BATCH, 1), K + 3, "fp"),
                                   ("intt", (2,), K, "fq")):
        n = 1 << k
        fn = getattr(NT, fname)
        if fname != "coset_ntt":
            x = fe(*batch, n)
            call = (lambda fn=fn, x=x, k=k, f=field: fn(x, k, f))
        elif nonzero:  # to_ext: n / 8 coefficients, the rest read as zero
            x = fe(*batch, n // 8)
            call = (lambda fn=fn, x=x, k=k, f=field: fn(x, k, f, nonzero=x.shape[-2]))
        else:  # a parent's to_ext: the rows padded with zeros first
            x = torch.cat([fe(*batch, n // 8), fe(*batch, n - n // 8).zero_()], dim=-2)
            call = (lambda fn=fn, x=x, k=k, f=field: fn(x, k, f))
        calls.append((f"{fname} {field} {batch + (n,)}", call, ("k_ntt_pass",)))
    if hasattr(FK, "ntt_radix_log"):  # each call at each radix
        base = list(calls)
        for logr in (2, 1):
            for what, call, syms in base:
                def at_radix(call=call, logr=logr):
                    keep, FK.ntt_radix_log = FK.ntt_radix_log, (lambda *_: logr)
                    try:
                        return call()
                    finally:
                        FK.ntt_radix_log = keep
                calls.append((f"{what} radix {1 << logr}", at_radix, syms))
    return calls


C_ALL, Q_ROTS = 90, 6  # the compliance circuit's committed columns and query rotations
GROUPS = (90, 21, 8, 8, 3, 5)  # its multiopen's point groups (queries a point)
RL_C = 81  # a trivial resource logic's committed columns at k = 12 (its 6 rotations as Q_ROTS)


def poly_calls(mods, fe):
    import torch

    PL, L = mods["PL"], mods["L"]
    grouped = hasattr(PL, "mont_linear_combo_groups")
    # each group's distinct columns, the first all C_ALL (rotation 0 queries every table)
    gen = torch.Generator().manual_seed(5)
    cols = [c for z in GROUPS for c in torch.randperm(C_ALL, generator=gen)[:z].tolist()]

    def aggregate(stack, w):  # the multiopen's point groups, as the checkout forms them
        if grouped:
            return PL.mont_linear_combo_groups(stack, cols, GROUPS, w)
        idx, out, off = torch.as_tensor(cols, device=stack.device), [], 0
        for z in GROUPS:
            out.append(PL.mont_linear_combo(stack.index_select(1, idx[off : off + z]),
                                            w[:, off : off + z]))
            off += z
        return torch.stack(out, dim=1)

    def f_of(agg, w, h):  # the multiopen's f = h + sum_j w_j agg_j
        if grouped:
            return PL.mont_linear_combo_groups(agg, None, (agg.shape[1],), w,
                                               addend=h[:, None])[:, 0]
        return L.add(h, PL.mont_linear_combo(agg, w), L.FP)

    calls = []
    G = len(GROUPS)
    for B in (1, BATCH):
        coeffs, points = fe(B, C_ALL, N), fe(B, Q_ROTS)
        agg, w, pt, inv, x3 = fe(B, G, N), fe(B, G), fe(B, G), fe(B, G), fe(B, 1)
        sel, wsel = fe(B, GROUPS[0], N), fe(B, GROUPS[0])
        wall, h = fe(B, sum(GROUPS)), fe(B, N)
        calls += [
            (f"eval_polys query evals B={B}",
             lambda c=coeffs, x=points: PL.eval_polys_at_points(c, x),
             ("k_eval_polys", "k_eval_reduce")),
            (f"linear_combo widest group B={B}",
             lambda s=sel, v=wsel: PL.mont_linear_combo(s, v), ("k_linear_combo",)),
            (f"linear_combo groups B={B}", lambda a=agg, v=w: PL.mont_linear_combo(a, v),
             ("k_linear_combo",)),
            (f"linear_combo aggregate B={B}", lambda c=coeffs, v=wall: aggregate(c, v),
             ("k_linear_combo",)),
            (f"linear_combo f B={B}", lambda a=agg, v=w, h=h: f_of(a, v, h),
             ("k_linear_combo",)),
            (f"synthetic_div B={B}", lambda a=agg, p=pt, i=inv: PL.synthetic_div(a, p, i),
             ("k_div_totals", "k_div_apply")),
            (f"eval_polys x3 B={B}", lambda a=agg, x=x3: PL.eval_polys_at_points(a, x),
             ("k_eval_polys", "k_eval_reduce")),
        ]
    rl, rx = fe(1, RL_C, N // 2), fe(1, Q_ROTS)
    calls.append(("eval_polys resource logic k=12 B=1",
                  lambda c=rl, x=rx: PL.eval_polys_at_points(c, x),
                  ("k_eval_polys", "k_eval_reduce")))
    return calls


LOOKUP_ROWS = 5  # the compliance circuit's lookups
WINDOW_C = 8


def lookup_calls(mods, fe):
    import torch

    FK, L, LS, M = mods["FK"], mods["L"], mods["LS"], mods["M"]
    has = hasattr(FK, "msm_digits_lm")
    from_mont = FK.from_mont_lm if has else (lambda x: L.from_mont(x, L.FP))

    def digits(x):  # a chunk's packed sort keys, as the checkout's _msm_fixed_dev forms them
        if has:
            return FK.msm_digits_lm(x, WINDOW_C, packed=True)
        d = torch.stack([M._digits_all(s, WINDOW_C) for s in x])
        C, total = d.shape[0], d.numel()
        off = torch.arange(C, dtype=torch.int64, device=x.device)[:, None] << WINDOW_C
        comp = (d.reshape(C, -1) + off).reshape(total)
        return (comp << max(1, (total - 1).bit_length())) | torch.arange(
            total, dtype=torch.int64, device=x.device)

    def to_jacobian(X, Y, Z):  # (16, 8) limb-major projective; a parent took (8, 16) rows
        return M._to_jacobian(X, Y, Z, "fq") if has else M._to_jacobian(X.T, Y.T, Z.T, "fq")

    calls = []
    u = N - 9
    for B in (1, BATCH):
        s = fe(LOOKUP_ROWS * B, N)
        pick = torch.randint(0, 64, (LOOKUP_ROWS * B, N), device=s.device)
        a = torch.gather(s, 1, pick[..., None].expand(-1, -1, 16))  # heavy repeats, all in S
        cols = fe(B, 12, N)
        calls += [
            (f"permute_pairs B={B}", lambda a=a, s=s: LS.permute_pairs_device(a, s, u),
             ("k_lookup_keys", "k_lookup_sort", "k_lookup_rank", "k_lookup_counts",
              "k_lookup_leftovers", "k_lookup_merge", "k_lookup_fill")),
            (f"from_mont advice B={B}", lambda x=cols: from_mont(x), ("k_from_mont",)),
        ]
    sc = fe(8, N)
    pts = tuple(fe(8).T.contiguous() for _ in range(3))
    calls += [(f"msm_digits packed (8, {N})", lambda x=sc: digits(x), ("k_msm_digits",)),
              ("to_jacobian 8 columns", lambda p=pts: to_jacobian(*p), ("k_mont_mul",))]
    return calls


SLICES = {  # name: (the wrapper that marks the kernels, source, calls; a checkout
    #            without the wrapper runs the calls only if `before` is True)
    "grand_products": dict(wrapper="mont_inv_lm", source="grand_product",
                           calls=grand_product_calls, before=False),
    "ntt": dict(wrapper="ntt_lm", source="ntt", calls=ntt_calls, before=True),
    "poly": dict(wrapper="eval_polys_lm", source="poly", calls=poly_calls, before=True),
    "lookup": dict(wrapper="permute_pairs_lm", source=("lookup_sort", "convert"),
                   calls=lookup_calls, before=True),
}


def profiled(fn, reps: int, syms) -> dict:
    """fn() run reps times under torch.profiler: per call, its device
    operations and their summed device time, ms, each operation's time by
    name, and the launches and time of the kernels named by syms, with their
    fastest and slowest launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    own = [e.duration_ns() / 1e6 for e in ev if any(s in e.name() for s in syms)]
    by_kernel: dict[str, float] = {}  # every device operation's time by its name
    for e in ev:
        m = re.search(r"\bk_\w+", e.name())
        name = m.group(0) if m else e.name()[:40]
        by_kernel[name] = by_kernel.get(name, 0.0) + e.duration_ns() / 1e6 / reps
    return {"ops": len(ev) / reps, "device_ms": sum(e.duration_ns() for e in ev) / 1e6 / reps,
            "launches": len(own) / reps, "kernel_ms": sum(own) / reps,
            "min": min(own, default=None), "max": max(own, default=None),
            "by_kernel": by_kernel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--slice", action="append", choices=sorted(SLICES), dest="slices")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--check", action="store_true",
                    help="hold each call against its plain version first")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from taiga_tpu_torch.ops import cuda_kernels as CK, ff_kernels as FK, limbs as L
    from taiga_tpu_torch.ops import lookup_sort as LS, msm as M, ntt as NT, poly as PL

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

    def as_tuple(t):
        return (t,) if torch.is_tensor(t) else tuple(t)

    out = {}
    for name in args.slices or SLICES:
        sl = SLICES[name]
        has = hasattr(FK, sl["wrapper"])
        print(f"{name}: kernels {'present' if has else 'absent'}", flush=True)
        res = {"kernels_present": has, "calls": {}}
        out[name] = res
        if not has and not sl["before"]:
            continue
        mods = {"FK": FK, "NT": NT, "PL": PL, "L": L, "LS": LS, "M": M}
        for what, fn, syms in sl["calls"](mods, fe):
            r = {}
            if has:
                if args.check:
                    got = as_tuple(fn())
                    with FK.plain_versions():
                        want = as_tuple(fn())
                    if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                        raise AssertionError(f"{what}: the kernel differs from its plain version")
                    print(f"  {what}: equal to its plain version", flush=True)
                with FK.plain_versions():
                    r["plain_ms"] = cuda_ms(fn, 1)
            r.update(profiled(fn, 10, syms))
            r["events_ms"] = cuda_ms(fn, 20)
            res["calls"][what] = r
            span = "" if r["min"] is None else f" (launches {r['min']:.6f}-{r['max']:.6f})"
            print(f"  {what}: {r['events_ms']:.6f} ms (events); {r['ops']:.0f} device "
                  f"operations, {r['device_ms']:.6f} ms device time a call; its kernels "
                  f"{r['launches']:.0f} launches, {r['kernel_ms']:.6f} ms{span}"
                  + (f"; plain version {r['plain_ms']:.3f} ms" if has else ""), flush=True)
            if len(r["by_kernel"]) > 1:
                print("    " + ", ".join(f"{k} {v:.6f}" for k, v in r["by_kernel"].items()),
                      flush=True)
        if has:
            srcs = sl["source"] if isinstance(sl["source"], tuple) else (sl["source"],)
            res["resources"] = {k: v for src in srcs
                                for k, v in kernel_resources(CK._so_path(src)).items()}
            for k, v in sorted(res["resources"].items()):
                print(f"  {k}: {v}", flush=True)
    print(json.dumps({"root": root, "device": smi, "slices": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
