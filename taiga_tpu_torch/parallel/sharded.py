"""Sharded kernels over a torch.distributed process group.

Port of taiga_tpu/parallel/sharded.py. The JAX package runs one process
over a device Mesh and cuts arrays with shard_map; the port runs one
process per device (SPMD), each holding its rank's contiguous shard, which
is what `Pspec(AXIS)` gives a device. Every function here takes this rank's
shard and returns the replicated result on every rank:

  sharded_msm / sharded_msm_multi: each rank reduces its points (Pippenger,
      or the bitserial ladder, ec_ladder, then ec_add_tree), the
      (C, 3, 16) partials are all-gathered and folded in rank order with
      ec.ec_add (K6);
  batch_hash_step: each rank hashes its share of a batch (Poseidon kernel),
      the hashes are all-gathered;
  sharded_point_sum: K3 Hillis-Steele rounds over the local points, the
      partials gathered and folded with K2;
  prove_step: batch_hash_step + sharded_point_sum, the multi-device
      dryrun's unit.

The fold order is the reference's, so the bits are the same. ops/ntt.py's
ntt_mesh and the prover's `group=` arguments (ProverPipeline.
commit_coeff_rows, create_proofs_batch) use the same group.
"""

from __future__ import annotations

import os

import torch

from ..ops import ec, ff_kernels as FK, limbs as L, msm as msm_mod
from ..ops import poseidon_kernel as PK


class Group:
    """The default process group as this rank sees it."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend

    def shard(self, n: int) -> slice:
        """This rank's contiguous block of n items (the world divides n)."""
        if n % self.world:
            raise ValueError(f"{n} items do not split over {self.world} ranks")
        m = n // self.world
        return slice(self.rank * m, (self.rank + 1) * m)

    def __repr__(self):
        return f"Group(rank={self.rank}, world={self.world}, device={self.device}, " \
               f"backend={self.backend!r})"


def make_group(device="cuda", *, init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None, local_rank: int | None = None) -> Group:
    """Join the default process group (or wrap it, when already initialized)
    and return this rank's view of it. device "cuda": NCCL on
    cuda:{local_rank} (raises without a card); "cpu": gloo. rank,
    world_size and local_rank default to the RANK, WORLD_SIZE and LOCAL_RANK
    environment variables, then to 0, 1 and rank; init_method (e.g.
    "tcp://127.0.0.1:29500" or "file:///...") defaults to the environment's
    rendezvous ("env://")."""
    import torch.distributed as dist

    kind = L.resolve_device(device).type
    env = os.environ
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(env.get("RANK", 0)) if rank is None else rank
        world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if kind == "cuda":
        dev, backend = torch.device("cuda", local_rank), "nccl"
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return Group(rank, world_size, dev, backend)


def all_gather(group: Group, t: torch.Tensor) -> torch.Tensor:
    """(…) on every rank -> (D, …), rank order, on every rank."""
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty((group.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    if group.backend == "nccl":
        dist.all_gather_into_tensor(out, t)
    else:
        dist.all_gather(list(out.unbind(0)), t)
    return out


def _fold_partials(parts, spec: L.FieldSpec):
    """Fold gathered (D, …, 3, 16) Jacobian partials in rank order with
    ec.ec_add: ((p0 + p1) + p2) + …, the reference's order."""
    acc = tuple(parts[0].select(-2, i) for i in range(3))
    for d in range(1, parts.shape[0]):
        acc = ec.ec_add(acc, tuple(parts[d].select(-2, i) for i in range(3)), spec)
    return torch.stack(acc, dim=-2)


def sharded_msm(group: Group, px, py, pz, scalar_limbs, field: str = "fq",
                c: int = msm_mod.WINDOW_BITS):
    """MSM over this rank's points (n_local, 16) x3 Jacobian and plain
    scalar limbs (n_local, 16): the local Pippenger's (3, 16) partial,
    gathered and folded. Returns (3, 16), replicated."""
    part = msm_mod.msm(px, py, pz, scalar_limbs, field=field, c=c)
    return _fold_partials(all_gather(group, part), L.FIELDS[field])


def _local_msm_bitserial(pxs, pys, pzs, sls, field: str, bits: int = 255):
    """Multi-column MSM as one shared doubling ladder (the reference's
    _local_msm_bitserial): acc (C, n) lanes, for bit i (LSB first) of every
    scalar, acc = bit ? acc + base : acc, then base = 2 base, the whole
    ladder in one ec_ladder launch (K7 chained with the doubling, the bit
    per lane); last, each column's lanes are summed by the reference's
    halving tree in one ec_add_tree launch (K6 chained). Returns (C, 3, 16)
    Jacobian."""
    C, n = sls.shape[0], sls.shape[1]
    if n & (n - 1):
        raise ValueError(f"the bitserial tree needs a power-of-two local shard, got {n}")
    base = [v.T.contiguous() for v in (pxs, pys, pzs)]  # (16, n)
    acc = FK.ec_ladder_lm(*base, sls.contiguous(), bits, field)  # (16, C * n)
    sums = FK.ec_add_tree_lm(*acc, C, field)  # (16, C)
    return torch.stack([v.T for v in sums], dim=1)  # (C, 3, 16)


STRATEGIES = ("pippenger", "bitserial")


def sharded_msm_multi(group: Group, px, py, pz, scalars, field: str = "fq",
                      c: int = msm_mod.WINDOW_BITS, strategy: str | None = None):
    """Multi-column MSM with the POINT axis sharded over the group: this
    rank's points (n_local, 16) x3 Jacobian Montgomery and its slice of the
    scalars (C, n_local, 16) plain limbs; each rank reduces its slice (all
    columns at once), the (C, 3, 16) partials are all-gathered and folded
    with complete Jacobian adds (K6). Returns (C, 3, 16), replicated.

    strategy: "pippenger" (the port's msm_multi; the default on the card)
    or "bitserial" (the ec_ladder ladder; the default on the CPU, as the reference
    picks by platform: short to run through the plain versions)."""
    if strategy is None:
        strategy = "pippenger" if px.device.type == "cuda" else "bitserial"
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, not {strategy!r}")
    if strategy == "pippenger":
        part = msm_mod.msm_multi(px, py, pz, scalars, field=field, c=c)
    else:
        part = _local_msm_bitserial(px, py, pz, scalars, field)
    return _fold_partials(all_gather(group, part), L.FIELDS[field])


def batch_hash_step(group: Group, messages):
    """Data-parallel ConstantLength<8> hashing: this rank's share of a batch,
    messages (B_local, 8, 16) Montgomery; the hashes of the whole batch,
    (B, 16) in batch order, on every rank."""
    return all_gather(group, PK.hash_n_batch(messages, 8)).reshape(-1, L.NLIMBS)


def sharded_point_sum(group: Group, px, py, pz, field: str = "fq"):
    """Sum of a sharded batch of Jacobian points: each rank reduces its
    (n_local, 16) rows by Hillis-Steele rounds of K3 on limb-major
    projective points, the (3, 16) partials are all-gathered and folded in
    rank order with K2, then converted back to Jacobian. Returns (3, 16),
    replicated."""
    spec = L.FIELDS[field]
    # (n, 16) Jacobian -> limb-major projective (X Z : Y : Z^3), the identity (0 : 1 : 0)
    z2 = L.mont_mul(pz, pz, spec)
    inf = L.is_zero(pz)
    x = torch.where(inf[:, None], 0, L.mont_mul(px, pz, spec)).T.contiguous()
    y = torch.where(inf[:, None], L.const(spec.one_mont, px.device), py).T.contiguous()
    z = torch.where(inf[:, None], 0, L.mont_mul(z2, pz, spec)).T.contiguous()
    ln = x.shape[1]
    lane = torch.arange(ln, device=px.device)
    for r in range((ln - 1).bit_length()):
        s = 1 << r
        sel = (lane + s < ln).to(L.DTYPE)[None].contiguous()
        x, y, z = FK.ec_add_proj_sel_lm(x, y, z, *(torch.roll(v, -s, dims=1).contiguous()
                                                   for v in (x, y, z)), sel, field)
    parts = all_gather(group, torch.stack([x[:, 0], y[:, 0], z[:, 0]]))  # (D, 3, 16)
    acc = tuple(parts[0, i][:, None].contiguous() for i in range(3))
    for d in range(1, group.world):
        acc = FK.ec_add_proj_lm(*acc, *(parts[d, i][:, None].contiguous() for i in range(3)),
                                field)
    X, Y, Z = (v[:, 0][None] for v in acc)
    xz = L.mont_mul(X, Z, spec)
    yz2 = L.mont_mul(Y, L.mont_mul(Z, Z, spec), spec)
    return torch.stack([xz[0], yz2[0], Z[0]])


def prove_step(group: Group, messages, px, py, pz, field: str = "fq"):
    """One combined multi-device proving step: data-parallel witness
    hashing and a sharded commitment-reduction round (the multi-device
    dryrun's unit). Returns (hashes (B, 16), the point sum (3, 16))."""
    return (batch_hash_step(group, messages),
            sharded_point_sum(group, px, py, pz, field=field))
