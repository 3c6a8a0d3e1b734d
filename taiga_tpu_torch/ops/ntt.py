"""Radix-2 NTT over Fp/Fq on (..., n, 16) Montgomery rows.

Port of taiga_tpu/ops/ntt.py. On a CUDA tensor every transform (ntt,
intt, coset_ntt, coset_intt) is K11, ff_kernels.ntt_lm (csrc/ntt.cu): a
four-step split into two passes (one for k <= 10), each line's stages in
groups in registers at radix 4 or 2 (ff_kernels.ntt_radix_log picks by
the call's size), the coset and n^-1 scales fused into its loads and
stores, its twiddles from one compact table (twiddle_table); a
zero-padded input (coset_ntt's `nonzero`) is never built. The plain
version, ntt_plain, is the reference's constant-geometry (Pease) DIF NTT
with its final bit reversal and the coset scale as a separate product,
limb-major in plain torch ops; the CPU runs it. The four-step NTT over a process group (ntt_mesh) runs
its sub-transforms through the same wrapper.

Bit-exact vs taiga_tpu.ops.ntt (tests/test_torch_ntt.py,
tests/test_torch_ntt_kernel.py); K11 against ntt_plain on the card in
chip_smoke.py (phase_ntt).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import ff_kernels as FK
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


def _pease(coeffs: torch.Tensor, k: int, field: str, inverse: bool):
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


@lru_cache(maxsize=None)
def _coset_powers(k: int, field: str, g: int, inverse: bool) -> np.ndarray:
    spec = _spec(field)
    p = spec.modulus
    return spec.array_to_mont(_powers(pow(g, -1, p) if inverse else g, 1 << k, p))


@lru_cache(maxsize=None)
def _coset_powers_dev(k: int, field: str, g: int, inverse: bool, device: str):
    return torch.as_tensor(_coset_powers(k, field, g, inverse), device=torch.device(device))


def ntt_plain(x, k: int, field: str = "fp", inverse: bool = False, coset: int | None = None,
              nonzero: int | None = None):
    """K11's plain version (ff_kernels.ntt_lm): the transform of (..., n,
    16) Montgomery rows, n = 2^k, as the reference computes it: the coset
    scale by g^i first (forward, g = `coset`), the constant-geometry Pease
    stages, the bit-reversal gather and the inverse's n^-1
    (taiga_tpu/ops/ntt.py::_ntt_fixed_jit), then the scale by g^-i
    (inverse), each in plain torch ops. With `nonzero`, x is (...,
    nonzero, 16) and is padded with zeros to n first."""
    spec = _spec(field)
    if nonzero is not None:
        padded = x.new_zeros(x.shape[:-2] + (1 << k, L.NLIMBS))
        padded[..., :nonzero, :] = x
        x = padded
    if coset is not None and not inverse:
        x = L.mont_mul(x, _coset_powers_dev(k, field, coset, False, str(x.device)), spec)
    x = _pease(x, k, field, inverse)
    if coset is not None and inverse:
        x = L.mont_mul(x, _coset_powers_dev(k, field, coset, True, str(x.device)), spec)
    return x


def _powers(base: int, count: int, p: int) -> list[int]:
    """[base^0, ..., base^(count - 1)] mod p."""
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % p
    return out


def _mont_packed(vals, spec: L.FieldSpec) -> np.ndarray:
    """Host ints -> Montgomery form packed as K11 reads it: (N, 8) uint32,
    an element's 8 little-endian 32-bit words."""
    return L.ints_to_packed([v * spec.r % spec.modulus for v in vals])


@lru_cache(maxsize=None)
def twiddle_table(k: int, field: str, inverse: bool) -> np.ndarray:
    """K11's compact twiddle table: w^e for 0 <= e < n/2 (w = omega, or
    omega^-1 for the inverse; w^(n/2) = -1 gives the rest), Montgomery
    form, packed (max(n/2, 1), 8) uint32."""
    p = _spec(field).modulus
    omega, omega_inv, _, _ = domain_params(k, field)
    return _mont_packed(_powers(omega_inv if inverse else omega, max((1 << k) // 2, 1), p),
                        _spec(field))


@lru_cache(maxsize=None)
def kernel_tables(k: int, field: str, inverse: bool, coset: int | None, device: str):
    """K11's device tables of one transform, packed (entries, 8) int32:
    the twiddles; the scale at load (the forward coset's g^i, n entries, or
    None); the scale at store (the inverse's n^-1, one entry, or n^-1 g^-i
    with a coset, n entries, or None)."""
    spec = _spec(field)
    p, n = spec.modulus, 1 << k
    dev = torch.device(device)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.view(np.int32), device=dev)

    pre = post = None
    if inverse:
        n_inv = domain_params(k, field)[2]
        scale = [n_inv] if coset is None else [n_inv * c % p
                                                for c in _powers(pow(coset, -1, p), n, p)]
        post = on_dev(_mont_packed(scale, spec))
    elif coset is not None:
        pre = on_dev(_mont_packed(_powers(coset, n, p), spec))
    return on_dev(twiddle_table(k, field, inverse)), pre, post


def build_tables(k: int, device, field: str = "fp", g: int = 5):
    """Build now the device tables of every transform at 2^k on `device`
    (forward, inverse and both coset directions; K11's on a CUDA device,
    the plain version's where that runs), which the transforms otherwise
    build at first use: for a caller that runs them from several threads."""
    t = torch.empty(0, device=device)
    key = str(t.device)
    for inverse in (False, True):
        if FK.use_kernel(t):
            for coset in (None, g):
                kernel_tables(k, field, inverse, coset, key)
        else:
            _tables(k, field, inverse, key)
            _coset_powers_dev(k, field, g, inverse, key)


def ntt(coeffs, k: int, field: str = "fp"):
    """Forward NTT: coefficients -> evaluations at omega^i (natural order)."""
    return FK.ntt_lm(coeffs, k, field)


def intt(evals, k: int, field: str = "fp"):
    """Inverse NTT: evaluations -> coefficients."""
    return FK.ntt_lm(evals, k, field, inverse=True)


def coset_ntt(coeffs, k: int, field: str = "fp", g: int = 5, nonzero: int | None = None):
    """Evaluations over the coset g*H (H = 2^k subgroup); with `nonzero`,
    of the (..., nonzero, 16) coefficients padded with zeros to 2^k."""
    return FK.ntt_lm(coeffs, k, field, coset=g, nonzero=nonzero)


def coset_intt(evals, k: int, field: str = "fp", g: int = 5):
    """Coefficients from evaluations over the coset g*H."""
    return FK.ntt_lm(evals, k, field, inverse=True, coset=g)


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
    a = FK.ntt_lm(a.transpose(0, 1), k1, field, inverse).transpose(0, 1)
    a = L.mont_mul(a, tw, spec)
    # -> row shard (n1/D, n2); length-n2 row NTTs (local); the inverse's
    # sub-transforms scale by 1/n1 and 1/n2: 1/n in all
    a = FK.ntt_lm(_untranspose_blocks(group, a), k2, field, inverse)
    # X[j1 + n1*j2] = A'[j1, j2]: to column shards, then this rank's
    # contiguous block of X is its (n2/D, n1) transpose, flattened
    a = _transpose_blocks(group, a)
    return a.transpose(0, 1).reshape(n1 * (n2 // D), L.NLIMBS).contiguous()
