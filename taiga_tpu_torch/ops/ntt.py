"""Radix-2 NTT over Fp/Fq as vectorized limb tensors.

Port of taiga_tpu/ops/ntt.py: the constant-geometry (Pease) DIF NTT with
its final bit reversal, plus coset evaluation for the vanishing argument's
extended domain. Every stage is the SAME butterfly on static halves —
u = x[:n/2], v = x[n/2:], out interleaved as (u+v, (u-v)*tw) — then one
gather undoes the bit reversal. Plain torch ops (the reference's NTT is
plain XLA, not Pallas); the whole transform runs limb-major in int32, with
one layout change in and one out.

Bit-exact vs taiga_tpu.ops.ntt (tests/test_torch_ntt.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import limbs as L


def _spec(field: str) -> L.FieldSpec:
    return L.FIELDS[field]


@lru_cache(maxsize=None)
def domain_params(k: int, field: str = "fp"):
    """Returns (omega, omega_inv, n_inv, bitrev_idx) for the 2^k domain."""
    p = _spec(field).modulus
    n = 1 << k
    # generator 5 for both Pasta fields
    omega = pow(5, (p - 1) >> k, p)
    omega_inv = pow(omega, -1, p)
    n_inv = pow(n, -1, p)
    idx = np.zeros(n, dtype=np.int64)
    for i in range(n):
        idx[i] = int(format(i, f"0{k}b")[::-1], 2) if k else 0
    return omega, omega_inv, n_inv, idx


@lru_cache(maxsize=None)
def _pease_twiddles(k: int, field: str, inverse: bool) -> np.ndarray:
    """Stage-stacked twiddles tw[s, j] = w^(2^s * (j >> s)) as (k, n/2, 16)
    int32 Montgomery limbs, w = omega (or omega^-1 for the inverse)."""
    spec = _spec(field)
    pmod = spec.modulus
    n = 1 << k
    omega, omega_inv, _, _ = domain_params(k, field)
    w = omega_inv if inverse else omega
    tw = np.zeros((max(k, 1), n // 2, L.NLIMBS), np.int32)
    for s in range(k):
        step = pow(w, 1 << s, pmod)
        m = max(1, (n // 2) >> s)
        vals = [1] * m
        for i in range(1, m):
            vals[i] = vals[i - 1] * step % pmod
        row = np.repeat(np.asarray(spec.array_to_mont(vals)), 1 << s, axis=0)
        tw[s] = row[: n // 2]
    return tw


@lru_cache(maxsize=None)
def _tables(k: int, field: str, inverse: bool, device: str):
    """Device copies of the twiddles (limb-major int32, (k, 16, n/2)), the
    bit-reversal index and n^-1 (constants, cached per device)."""
    dev = torch.device(device)
    tw = torch.as_tensor(_pease_twiddles(k, field, inverse), device=dev)
    tw_lm = tw.permute(0, 2, 1).contiguous()
    idx = torch.as_tensor(domain_params(k, field)[3], device=dev)
    n_inv = torch.as_tensor(
        _spec(field).array_to_mont([domain_params(k, field)[2]])[0], device=dev)
    return tw_lm, idx, n_inv


def _ntt_core(coeffs: torch.Tensor, k: int, field: str, inverse: bool):
    """coeffs: (..., n, 16) Montgomery -> (..., n, 16) Montgomery."""
    spec = _spec(field)
    n = 1 << k
    half = n // 2
    tw, idx, n_inv = _tables(k, field, inverse, str(coeffs.device))
    x = L.to_lm(coeffs)  # (16, ..., n)
    nb = x.dim() - 2
    for s in range(k):
        ts = tw[s].view((L.NLIMBS,) + (1,) * nb + (half,))
        u = x[..., :half]
        v = x[..., half:]
        c0 = L.lm_add(u, v, spec)
        c1 = L.lm_mul(L.lm_sub(u, v, spec), ts, spec)
        x = torch.stack([c0, c1], dim=-1).reshape(x.shape)
    # Pease output is bit-reversed; one gather back to natural order
    x = x.index_select(-1, idx)
    if inverse:
        x = L.lm_mul(x, n_inv.view((L.NLIMBS,) + (1,) * (nb + 1)), spec)
    return L.from_lm(x)


def ntt(coeffs, k: int, field: str = "fp"):
    """Forward NTT: coefficients -> evaluations at omega^i (natural order)."""
    return _ntt_core(coeffs, k, field, False)


def intt(evals, k: int, field: str = "fp"):
    """Inverse NTT: evaluations -> coefficients."""
    return _ntt_core(evals, k, field, True)


@lru_cache(maxsize=None)
def _coset_powers(k: int, field: str, g: int, inverse: bool) -> np.ndarray:
    spec = _spec(field)
    p = spec.modulus
    n = 1 << k
    base = pow(g, -1, p) if inverse else g
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * base % p
    return spec.array_to_mont(pows)


@lru_cache(maxsize=None)
def _coset_powers_dev(k: int, field: str, g: int, inverse: bool, device: str):
    return torch.as_tensor(_coset_powers(k, field, g, inverse), device=torch.device(device))


def build_tables(k: int, device, field: str = "fp", g: int = 5):
    """Build now the device tables of every transform at 2^k on `device`
    (forward, inverse and both coset directions), which the transforms
    otherwise build at first use: for a caller that runs them from
    several threads."""
    key = str(torch.empty(0, device=device).device)
    for inverse in (False, True):
        _tables(k, field, inverse, key)
        _coset_powers_dev(k, field, g, inverse, key)


def coset_ntt(coeffs, k: int, field: str = "fp", g: int = 5):
    """Evaluations over the coset g*H (H = 2^k subgroup)."""
    cpow = _coset_powers_dev(k, field, g, False, str(coeffs.device))
    return _ntt_core(L.mont_mul(coeffs, cpow, _spec(field)), k, field, False)


def coset_intt(evals, k: int, field: str = "fp", g: int = 5):
    coeffs = _ntt_core(evals, k, field, True)
    cpow = _coset_powers_dev(k, field, g, True, str(evals.device))
    return L.mont_mul(coeffs, cpow, _spec(field))


# ---------------------------------------------------------------------------
# four-step (Bailey) NTT over a process group: n = n1*n2 as an (n1, n2)
# matrix: length-n1 column NTTs, twiddle scaling by w^(j1*i2), length-n2 row
# NTTs, transpose. Each resharding between phases is ONE all_to_all_single
# over the group, so a domain larger than a card's memory splits across the
# ranks with O(n/D) memory each and three collective transposes.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _four_step_twiddles(k: int, k1: int, field: str, inverse: bool) -> np.ndarray:
    """T[j1, i2] = w^(+-j1*i2) Montgomery, shape (2^k1, 2^(k-k1), 16) numpy."""
    spec = _spec(field)
    p = spec.modulus
    n1, n2 = 1 << k1, 1 << (k - k1)
    omega, omega_inv, _, _ = domain_params(k, field)
    w = omega_inv if inverse else omega
    vals = []
    for j1 in range(n1):
        base = pow(w, j1, p)
        acc = 1
        for _ in range(n2):
            vals.append(acc)
            acc = acc * base % p
    return spec.array_to_mont(vals).reshape(n1, n2, L.NLIMBS)


def _transpose_blocks(group, a: torch.Tensor) -> torch.Tensor:
    """The tiled all_to_all of the reference (split_axis=1, concat_axis=0):
    this rank's (r, c, 16) block cut into D column chunks, chunk j sent to
    rank j; the chunks received, in rank order, stacked as rows:
    (D*r, c/D, 16)."""
    import torch.distributed as dist

    D = group.world
    r, c = a.shape[0], a.shape[1]
    send = a.reshape(r, D, c // D, L.NLIMBS).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.reshape(D * r, c // D, L.NLIMBS)


def _untranspose_blocks(group, a: torch.Tensor) -> torch.Tensor:
    """The reference's all_to_all(split_axis=0, concat_axis=1): this rank's
    (R, c, 16) block cut into D row chunks, chunk j sent to rank j; the
    chunks received, in rank order, side by side: (R/D, D*c, 16)."""
    import torch.distributed as dist

    D = group.world
    R, c = a.shape[0], a.shape[1]
    send = a.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv.reshape(D, R // D, c, L.NLIMBS).transpose(0, 1).reshape(R // D, D * c, L.NLIMBS)


def ntt_mesh(group, x_local: torch.Tensor, k: int, field: str = "fp",
             inverse: bool = False) -> torch.Tensor:
    """Distributed NTT (or its inverse) of a 2^k-point (n, 16) Montgomery
    vector over `group` (parallel/sharded.py::make_group, D ranks): this
    rank holds the contiguous block x[rank*n/D : (rank+1)*n/D] of the
    natural-order input and gets the same block of the natural-order
    output. The four-step decomposition with all_to_all_single for its
    three transposes; needs D | n1 and D | n2 (k1 = ceil(k/2)). Bit-exact
    against ntt()/intt() (tests/test_torch_parallel.py)."""
    spec = _spec(field)
    D, rank = group.world, group.rank
    k1 = (k + 1) // 2
    k2 = k - k1
    n1, n2 = 1 << k1, 1 << k2
    if n1 % D or n2 % D:
        raise ValueError(f"four-step NTT needs D | n1 and D | n2 (D={D}, n1={n1}, n2={n2})")
    if x_local.shape != ((1 << k) // D, L.NLIMBS):
        raise ValueError(f"x_local: shape {tuple(x_local.shape)}, expected ({(1 << k) // D}, 16)")
    dev = x_local.device
    tw = torch.as_tensor(_four_step_twiddles(k, k1, field, inverse)[:, rank * n2 // D :
                                                                    (rank + 1) * n2 // D],
                         device=dev)
    # row shard (n1/D, n2) of A = x.reshape(n1, n2) -> column shard (n1, n2/D)
    a = _transpose_blocks(group, x_local.reshape(n1 // D, n2, L.NLIMBS))
    # length-n1 column NTTs (local), then the twiddles of this column block
    a = _ntt_core(a.transpose(0, 1), k1, field, inverse).transpose(0, 1)
    a = L.mont_mul(a, tw, spec)
    # -> row shard (n1/D, n2); length-n2 row NTTs (local); the inverse's
    # sub-transforms scale by 1/n1 and 1/n2: 1/n in all
    a = _ntt_core(_untranspose_blocks(group, a), k2, field, inverse)
    # X[j1 + n1*j2] = A'[j1, j2]: to column shards, then this rank's
    # contiguous block of X is its (n2/D, n1) transpose, flattened
    a = _transpose_blocks(group, a)
    return a.transpose(0, 1).reshape(n1 * (n2 // D), L.NLIMBS).contiguous()
