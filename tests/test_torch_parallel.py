"""The port's sharded layer (taiga_tpu_torch.parallel.sharded and
ops/ntt.py::ntt_mesh) over torch.distributed, in spawned gloo processes on
the CPU (parallel/dryrun.py::run), against the unsharded functions and the
host: ntt_mesh at world 2 and 4 (k = 10, as tests/test_ntt.py's mesh test)
on both fields, forward and inverse, bit for bit; sharded_msm_multi
(bitserial, the K7 ladder) against msm_multi and the host group law;
batch_hash_step, sharded_point_sum and prove_step against hash_n_batch and
the host sum; the model-parallel commit (commit_coeff_rows(..., group=))
against the host engine's MSM; a grouped create_proofs_batch of 2 Fibonacci proofs at k = 5
against the ungrouped batch, byte for byte. Each spawn pays about 5 s of
process start."""

import random

import numpy as np
import pytest
import torch

from taiga_tpu_torch.crypto.curves import VestaPoint
from taiga_tpu_torch.crypto.fields import Fp
from taiga_tpu_torch.native import hostops as TH
from taiga_tpu_torch.ops import ec, limbs as TL, msm as TM, ntt, poseidon_kernel as PK
from taiga_tpu_torch.parallel import dryrun as DR
from taiga_tpu_torch.parallel.sharded import Group
from taiga_tpu_torch.plonk.native_open import _msm_point
from taiga_tpu_torch.plonk.prover import create_proofs_batch
from taiga_tpu_torch.plonk.verifier import verify_proof

SEED = 20261017


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _point(a) -> VestaPoint:
    return ec.points_from_device(tuple(np.asarray(a)[:, None]), VestaPoint)[0]


@pytest.mark.parametrize("world,k", [(2, 6), (4, 10)])
def test_ntt_mesh_equals_ntt(world, k):
    cases = [(f, inv) for f in ("fp", "fq") for inv in (False, True)]
    res = DR.run_many(world, [("ntt", dict(k=k, field=f, inverse=inv, seed=SEED + k))
                              for f, inv in cases])
    for j, (f, inv) in enumerate(cases):
        got = np.concatenate([r[j] for r in res])
        x = torch.as_tensor(DR.field_vector(SEED + k, 1 << k, f))
        want = (ntt.intt if inv else ntt.ntt)(x, k, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{f} inverse={inv}")


def test_ntt_mesh_needs_world_dividing_both_halves():
    group = Group(0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="D \\| n1"):
        ntt.ntt_mesh(group, torch.zeros((16, 16), dtype=torch.int32), 4)


def test_sharded_msm_multi_bitserial_equals_msm_multi_and_host():
    n, C = 16, 2
    res = DR.run(2, "msm_multi", n=n, C=C, field="fq", seed=SEED, strategy="bitserial")
    np.testing.assert_array_equal(res[0], res[1])
    rows, pts = DR.curve_points(SEED, n, "fq")
    sc = DR.scalar_columns(SEED + 1, C, n)
    ref = TM.msm_multi(*(torch.as_tensor(r) for r in rows), torch.as_tensor(sc), field="fq",
                       c=4)
    for c in range(C):
        want = VestaPoint.identity()
        for p, v in zip(pts, (int.from_bytes(s.astype("<u2").tobytes(), "little")
                              for s in sc[c])):
            want = want + p * v
        assert _point(res[0][c]) == want == _point(ref[c].numpy())


def test_prove_step_and_sharded_commit_equal_unsharded():
    """prove_step and its parts, and ProverPipeline.commit_coeff_rows(...,
    group=) (the model-parallel commit) against the host engine's MSM."""
    B, n, C = 4, 16, 2
    res = DR.run_many(2, [("prove_step", dict(B=B, n=n, field="fq", seed=SEED)),
                          ("commit", dict(C=C, seed=SEED))])
    for a, b in zip(res[0][0], res[1][0]):
        np.testing.assert_array_equal(a, b)
    assert res[0][1] == res[1][1]
    coeffs, blinds = DR.commit_inputs(SEED, C)
    for j in range(C):
        plain = TL.FP.array_from_mont(coeffs[j])
        want = _msm_point(DR.FIB_K, TH.ints_to_u64(plain), blinds[j])
        assert res[0][1][j] == want.to_bytes()
    h, s, ph, ps = res[0][0]
    np.testing.assert_array_equal(h, PK.hash_n_batch(torch.as_tensor(DR.messages(SEED, B)),
                                                     8).numpy())
    _, pts = DR.curve_points(SEED + 1, n, "fq")
    assert _point(s) == sum(pts[1:], pts[0])
    np.testing.assert_array_equal(ph, h)
    np.testing.assert_array_equal(ps, s)


def test_grouped_batch_equals_ungrouped():
    B = 2
    res = DR.run(2, "batch", B=B, seed=SEED)
    assert res[0] == res[1]
    circuits, insts = DR.fib_batch(B)
    want = create_proofs_batch(DR.fib_key(), circuits, insts, device="cpu",
                               randbits=random.Random(SEED).getrandbits)
    assert res[0] == want
    for inst, proof in zip(insts, want):
        assert verify_proof(DR.fib_key().vk, [Fp(v) for v in inst], proof)


def test_grouped_batch_needs_world_dividing_batch():
    group = Group(0, 2, torch.device("cpu"), "gloo")
    circuits, insts = DR.fib_batch(3)
    with pytest.raises(ValueError, match="split over 2"):
        create_proofs_batch(DR.fib_key(), circuits, insts, device="cpu", group=group)
