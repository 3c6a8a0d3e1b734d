"""Multi-process dryrun of the port's sharded layer on the CPU.

    python -m taiga_tpu_torch.parallel.dryrun --world 4

Port of __graft_entry__.dryrun_multichip: spawns `--world` processes, one
rank each, joined over gloo (torch.distributed on the CPU, a rendezvous on
127.0.0.1), and runs at small sizes, on every rank: prove_step (sharded
Poseidon hashing and point sum), the four-step ntt_mesh (forward and
inverse, both fields), sharded_msm_multi (bitserial) and a data-parallel
create_proofs_batch of a small Fibonacci circuit at k = 5, each against its
unsharded counterpart. Prints one JSON line. The same tasks serve the
tests (tests/test_torch_parallel.py): `run(world, task, **kw)` returns
every rank's result.
"""

from __future__ import annotations

import argparse
import json
import random
import socket
import sys
import time

import numpy as np
import torch

from ..crypto.curves import PallasPoint, VestaPoint
from ..crypto.fields import Fp
from ..ops import ec, limbs as L
from ..plonk.circuit import Circuit, CircuitBuilder, ConstraintSystem

CURVES = {"fp": PallasPoint, "fq": VestaPoint}


class FibCircuit(Circuit):
    """A Fibonacci-like chain a_{i+1} = a_i * a_{i-1} + a_{i-1} over STEPS
    steps from public (a0, a1) to a public out: the vanilla gate, copies and
    instance cells (the JAX package's tests/test_plonk.py circuit)."""

    NUM_FIXED = 5  # q_l q_r q_m q_o q_c
    NUM_ADVICE = 3
    NUM_INSTANCE = 1
    STEPS = 6

    def __init__(self, a0=None, a1=None):
        self.a0, self.a1 = a0, a1

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        ql, qr, qm, qo, qc = (cs.fixed(i) for i in range(5))
        a, b, c = (cs.advice(i) for i in range(3))
        cs.create_gate("vanilla", ql * a + qr * b + qm * a * b + qo * c + qc)
        return None

    def synthesize(self, builder: CircuitBuilder, config):
        def mul_add(x_cell, y_cell):  # c = x*y + y: q_m = 1, q_r = 1, q_o = -1
            row = builder.alloc_rows(1)
            builder.assign_fixed(1, row, 1)
            builder.assign_fixed(2, row, 1)
            builder.assign_fixed(3, row, Fp(-1))
            xa = builder.assign_advice(0, row, x_cell.value)
            ya = builder.assign_advice(1, row, y_cell.value)
            builder.copy(xa, x_cell)
            builder.copy(ya, y_cell)
            val = None
            if builder.known(xa, ya):
                val = Fp(xa.value) * Fp(ya.value) + Fp(ya.value)
            return builder.assign_advice(2, row, val)

        row = builder.alloc_rows(1)
        x = builder.assign_advice(0, row, self.a0)
        y = builder.assign_advice(1, row, self.a1)
        builder.constrain_instance(x, 0)
        builder.constrain_instance(y, 1)
        for _ in range(self.STEPS):
            x, y = y, mul_add(x, y)
        builder.constrain_instance(y, 2)

    @classmethod
    def statement(cls, a0: int, a1: int):
        x, y = Fp(a0), Fp(a1)
        for _ in range(cls.STEPS):
            x, y = y, x * y + y
        return cls(a0, a1), [a0, a1, y.v]


# --- seeded inputs (the same on every rank) ---------------------------------


def field_vector(seed: int, n: int, field: str) -> np.ndarray:
    rng = random.Random(seed)
    spec = L.FIELDS[field]
    return spec.array_to_mont([rng.randrange(spec.modulus) for _ in range(n)])


def curve_points(seed: int, n: int, field: str):
    """n random points as Jacobian (n, 16) x3 rows (Z = 1), lane 1 the
    identity; and the host points."""
    rng = random.Random(seed)
    pts = [CURVES[field].random(rng) for _ in range(n)]
    pts[1] = CURVES[field].identity()
    return ec.points_to_device(pts), pts


def scalar_columns(seed: int, C: int, n: int) -> np.ndarray:
    rng = random.Random(seed)
    return np.stack([L.ints_to_limbs([rng.getrandbits(255) for _ in range(n)])
                     for _ in range(C)])


def messages(seed: int, B: int) -> np.ndarray:
    return field_vector(seed, B * 8, "fp").reshape(B, 8, L.NLIMBS)


FIB_K = 5


def fib_batch(B: int):
    stmts = [FibCircuit.statement(3 + i, 4 + 2 * i) for i in range(B)]
    return [c for c, _ in stmts], [inst for _, inst in stmts]


_KEYS: dict = {}


def fib_key():
    from ..plonk.keygen import keygen

    if "fib" not in _KEYS:
        _KEYS["fib"] = keygen(FibCircuit(), FIB_K)
    return _KEYS["fib"]


# --- the tasks (run on every rank) -------------------------------------------


def task_ntt(group, k: int, field: str, inverse: bool, seed: int):
    """This rank's block of ntt_mesh of a seeded 2^k vector."""
    from ..ops.ntt import ntt_mesh

    x = torch.as_tensor(field_vector(seed, 1 << k, field), device=group.device)
    return ntt_mesh(group, x[group.shard(1 << k)].contiguous(), k, field, inverse).cpu().numpy()


def task_msm_multi(group, n: int, C: int, field: str, seed: int, strategy=None):
    from .sharded import sharded_msm_multi

    rows, _ = curve_points(seed, n, field)
    sl = group.shard(n)
    pts = [torch.as_tensor(r[sl], device=group.device) for r in rows]
    sc = torch.as_tensor(scalar_columns(seed + 1, C, n)[:, sl], device=group.device)
    return sharded_msm_multi(group, *pts, sc.contiguous(), field=field,
                             strategy=strategy).cpu().numpy()


def task_prove_step(group, B: int, n: int, field: str, seed: int):
    """(batch_hash_step, sharded_point_sum, prove_step's two) on seeded
    inputs; each rank passes its shard."""
    from .sharded import batch_hash_step, prove_step, sharded_point_sum

    msgs = torch.as_tensor(messages(seed, B)[group.shard(B)], device=group.device)
    rows, _ = curve_points(seed + 1, n, field)
    pts = [torch.as_tensor(r[group.shard(n)], device=group.device) for r in rows]
    h = batch_hash_step(group, msgs)
    s = sharded_point_sum(group, *pts, field=field)
    ph, ps = prove_step(group, msgs, *pts, field=field)
    return [t.cpu().numpy() for t in (h, s, ph, ps)]


def commit_inputs(seed: int, C: int):
    """C seeded coefficient columns of the Fibonacci key's domain (Montgomery)
    and their blinds."""
    n = 1 << FIB_K
    rng = random.Random(seed)
    return field_vector(seed, C * n, "fp").reshape(C, n, L.NLIMBS), \
        [rng.getrandbits(250) for _ in range(C)]


def task_commit(group, C: int, seed: int):
    """ProverPipeline.commit_coeff_rows(..., group=): the model-parallel
    commit of C seeded columns; the points' encodings."""
    from ..plonk.prover import get_pipeline

    coeffs, blinds = commit_inputs(seed, C)
    pipe = get_pipeline(fib_key(), group.device)
    pts = pipe.commit_coeff_rows(torch.as_tensor(coeffs, device=group.device), blinds,
                                 group=group)
    return [pt.to_bytes() for pt in pts]


def task_batch(group, B: int, seed: int):
    """A data-parallel create_proofs_batch of B Fibonacci statements at
    k = 5 under random.Random(seed)."""
    from ..plonk.prover import create_proofs_batch

    circuits, insts = fib_batch(B)
    return create_proofs_batch(fib_key(), circuits, insts, device=group.device,
                               randbits=random.Random(seed).getrandbits, group=group)


TASKS = {"ntt": task_ntt, "msm_multi": task_msm_multi, "prove_step": task_prove_step,
         "commit": task_commit, "batch": task_batch}


# --- spawning ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, jobs, out):
    import torch.distributed as dist

    from .sharded import make_group

    torch.set_num_threads(1)
    try:
        group = make_group("cpu", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                           world_size=world)
        results = [TASKS[name](group, **kw) for name, kw in jobs]
        out.put((rank, results, None))
    except BaseException as e:  # reported to the parent, which raises
        import traceback

        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_many(world: int, jobs, timeout: float = 600.0):
    """Run [(task, kwargs), ...] in `world` spawned gloo processes; returns
    each rank's list of results, by rank. A failing rank raises here."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, jobs, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = [None] * world, []
    try:
        for _ in range(world):
            rank, res, err = out.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errors:
        raise RuntimeError("dryrun ranks failed:\n" + "\n".join(errors))
    return results


def run(world: int, task: str, **kw):
    """One task in `world` spawned processes; every rank's result."""
    return [r[0] for r in run_many(world, [(task, kw)])]


def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def main(argv=None) -> int:
    from ..ops import ntt, poseidon_kernel as PK
    from ..plonk.verifier import verify_proof

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    D, seed = args.world, args.seed
    torch.set_num_threads(1)
    B, n, k = 2 * D, 8 * D, max(4, 2 * (D - 1).bit_length())
    jobs = [("prove_step", dict(B=B, n=n, field="fq", seed=seed))]
    jobs += [("ntt", dict(k=k, field=f, inverse=inv, seed=seed)) for f in ("fp", "fq")
             for inv in (False, True)]
    jobs += [("msm_multi", dict(n=n, C=2, field="fq", seed=seed, strategy="bitserial")),
             ("batch", dict(B=D, seed=seed))]
    t0 = time.perf_counter()
    res = run_many(D, jobs)
    t_run = time.perf_counter() - t0
    checks = {}
    replicated = (0, 5, 6)  # prove_step, msm_multi, batch: the same on every rank
    checks["replicated"] = all(
        _same(r[j], res[0][j]) for r in res[1:] for j in replicated)
    h, s, ph, ps = res[0][0]
    msgs = torch.as_tensor(messages(seed, B))
    checks["batch_hash_step"] = bool(np.array_equal(h, PK.hash_n_batch(msgs, 8).numpy()))
    rows, pts = curve_points(seed + 1, n, "fq")
    want = sum(pts[1:], pts[0])
    checks["sharded_point_sum"] = ec.points_from_device(tuple(s[:, None]), VestaPoint)[0] == want
    checks["prove_step"] = bool(np.array_equal(ph, h) and np.array_equal(ps, s))
    for j, (f, inv) in enumerate((f, inv) for f in ("fp", "fq") for inv in (False, True)):
        got = np.concatenate([r[1 + j] for r in res])
        x = torch.as_tensor(field_vector(seed, 1 << k, f))
        ref = (ntt.intt if inv else ntt.ntt)(x, k, f).numpy()
        checks[f"ntt_mesh[{f}{', inverse' if inv else ''}]"] = bool(np.array_equal(got, ref))
    rows, pts = curve_points(seed, n, "fq")
    sc = scalar_columns(seed + 1, 2, n)
    got = res[0][5]
    for c in range(2):
        want = VestaPoint.identity()
        for p, v in zip(pts, L.limbs_to_ints(sc[c])):
            want = want + p * v
        checks[f"sharded_msm_multi[bitserial, col {c}]"] = \
            ec.points_from_device(tuple(got[c][:, None]), VestaPoint)[0] == want
    proofs = res[0][6]
    circuits, insts = fib_batch(D)
    vk = fib_key().vk
    checks["create_proofs_batch[group]"] = all(
        verify_proof(vk, [Fp(v) for v in inst], p) for inst, p in zip(insts, proofs))
    ok = all(checks.values())
    print(json.dumps({"ok": ok, "world": D, "backend": "gloo", "k_ntt": k, "batch": D,
                      "seconds": round(t_run, 3), "checks": checks}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
