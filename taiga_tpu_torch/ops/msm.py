"""Multi-scalar multiplication on fused point kernels.

Port of taiga_tpu/ops/msm.py. MSM(s, G) = sum_i [s_i] G_i.

The general Pippenger (`msm`, `msm_multi`: any point set; the device IPA's
commitments and L/R points, the device verifier's <s, G>) runs the
reference's device path at every size: per c-bit window, sort the digits
(stably), gather the points, reduce each digit's run (K3 rounds), weight the
buckets by their digit (K2), then combine the windows by Horner (K2). The
windows are independent, so they are reduced together, each on its own lanes.

The segmented reductions (`ec_seg_rounds_lm`, one launch a call) compute
only the lanes whose offset from their run's first lane is a multiple of
2^rounds (its contract; every other lane keeps its input point), and every
caller here reads only such lanes: `_compact` the stride-CHUNK partials of
its first call (offsets that are multiples of 2^6) and the run starts of
its second, `_blocked_partials` the in-block run starts of phase B (a
tile's first lane starts a run) and phase C's run starts, `_window_reduce`
its run starts; `_bucket_sums` reads run starts only.

The fixed-base path is the one the prover commits every column with: one
fixed point set, so the window structure is baked into data: a shifted table
T[w][i] = [2^(c*w)] G_i, built once per domain, turns every commitment into a
SINGLE bucket accumulation over W*N lanes:

  * digits of all columns are keyed col*2^c + digit and sorted (a total
    order: key and lane index packed into one int64);
  * the table rows are gathered in sorted order and reduced per run by
    the segmented rounds of K3 (`ec_seg_rounds_lm`), or — for large
    windows — by a blocked tree of K2 (ec_add_proj, `_blocked_partials`)
    plus a fix-up of the blocks that straddle runs;
  * the 2^c bucket sums of each column are weighted by their digit through
    the digit's bit decomposition (a K2 tree a bit and a Horner over the
    bits: one `ec_bucket_weights_lm` launch).

The general MSM's Horner over its windows is one chained launch
(ec_horner_lm), not one K2 launch per add.

Points inside are limb-major projective (16, B) int32 coordinates with the
identity (0 : 1 : 0). The reference stores a non-finite input as (0, 0) after
affine normalization; the port asserts that every input is finite instead.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ff_kernels as FK
from . import limbs as L

WINDOW_BITS = 8
_CHUNK = 64  # in-chunk reduction span before compaction
_BLOCK = 128  # blocked-reduction tile (phase A of _blocked_partials)


def _digits_all(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(N, 16) limbs -> (n_windows, N) int64 window digits, little-endian."""
    assert 16 % c == 0
    per_limb = 16 // c
    rows = []
    for w in range(16 * per_limb):
        limb = scalar_limbs[:, w // per_limb].to(torch.int64)
        shift = c * (w % per_limb)
        rows.append((limb >> shift) & ((1 << c) - 1))
    return torch.stack(rows)


def packed_idx_bits(total: int) -> int:
    """The lane bits of the fixed-base path's packed sort key over `total`
    lanes."""
    return max(1, (total - 1).bit_length())


def msm_digits_plain(scalars: torch.Tensor, c: int, packed: bool = False) -> torch.Tensor:
    """K17's plain version: the c-bit window digits of C columns of plain
    scalars (C, N, 16), W = 256 / c windows. Keyed: (W, C, N) int64 col 2^c
    + digit, the general MSMs' composite key. Packed: the fixed-base path's
    (C W N,) int64 sort key ((col 2^c + digit) << idx_bits) | lane, lane =
    col W N + w N + i (a total order equal to a stable sort of the keys)."""
    ncols = scalars.shape[0]
    col_off = torch.arange(ncols, dtype=torch.int64, device=scalars.device)[:, None] << c
    if not packed:
        digits = torch.stack([_digits_all(s, c) for s in scalars], dim=1)  # (W, C, N)
        return digits + col_off
    digits = torch.stack([_digits_all(s, c) for s in scalars])  # (C, W, N)
    total = digits.numel()
    comp = (digits.reshape(ncols, -1) + col_off).reshape(total)
    lanes = torch.arange(total, dtype=torch.int64, device=scalars.device)
    return (comp << packed_idx_bits(total)) | lanes


def _mask_identity(x, y, z, keep, field: str):
    """Lanes where keep is False become the projective identity (0:1:0).
    Points (16, ..., L), keep (..., L)."""
    one = L.FIELDS[field].one_col(x.device).view((16,) + (1,) * (x.dim() - 1))
    k = keep[None]
    x = torch.where(k, x, 0)
    y = torch.where(k, y, one)
    z = torch.where(k, z, 0)
    return x, y, z


def _nonzero_sized(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of True entries along the last axis, ascending, padded with
    `fill` to `size` (the reference's static-size nonzero), for each row of
    a (..., L) mask. The callers' bounds are guarantees of sortedness;
    exceeding one raises instead of truncating."""
    n = mask.shape[-1]
    count = int(mask.sum(-1).max())
    if count > size:
        raise AssertionError(f"nonzero: {count} entries exceed the static bound {size}")
    key = torch.where(mask, torch.arange(n, device=mask.device), n)
    pos = torch.sort(key, dim=-1).values[..., :size]
    if size > n:
        pos = torch.cat([pos, pos.new_full(tuple(mask.shape[:-1]) + (size - n,), n)], dim=-1)
    return torch.where(pos == n, fill, pos)


def _take(v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """v (16, ..., L) or keys (..., L) gathered along the last axis at the
    positions pos (..., K)."""
    if v.dim() > pos.dim():
        pos = pos.unsqueeze(0).expand((v.shape[0],) + tuple(pos.shape))
    return torch.gather(v, -1, pos)


def _lanes(v: torch.Tensor) -> torch.Tensor:
    """(16, ..., L) coordinates as one contiguous (16, B) kernel operand."""
    return v.reshape(16, -1).contiguous()


def _cols(v, lo: int, hi: int):
    return v[:, lo:hi].contiguous()


def _blocked_partials(x, y, z, dcomp, field: str, ncols: int, nbuckets: int,
                      total: int):
    """Work-efficient bucket partials for LARGE sorted windows.

    When total >> ncols*nbuckets, almost every 128-lane block lies inside
    ONE digit run, so:
      A. tree-reduce every block unconditionally (K2 on halving widths —
         boundary blocks produce garbage, fixed next);
      B. gather only the MIXED blocks (<= ncols*nbuckets of them, a static
         bound from sortedness) and Hillis-Steele within them (K3, every
         round of a block in one tile launch) — per-(block, run) partials
         at the in-block run starts;
      C. merge the uniform block sums with the mixed-run partials, re-sort,
         and finish with one small segmented pass.
    Returns (x, y, z, keys, length) sorted by key with each run's first
    lane holding the full bucket sum."""
    dev = x.device
    nb = total // _BLOCK

    def tr(v):  # lane order: j * nb + block
        return v.reshape(16, nb, _BLOCK).transpose(1, 2).reshape(16, total).contiguous()

    ax, ay, az = tr(x), tr(y), tr(z)
    h = _BLOCK
    while h > 1:
        h //= 2
        sz = h * nb
        ax, ay, az = FK.ec_add_proj_lm(
            _cols(ax, 0, sz), _cols(ay, 0, sz), _cols(az, 0, sz),
            _cols(ax, sz, 2 * sz), _cols(ay, sz, 2 * sz), _cols(az, sz, 2 * sz),
            field=field)
    bk_lo = dcomp[0::_BLOCK]
    bk_hi = dcomp[_BLOCK - 1 :: _BLOCK]
    mixed = bk_lo != bk_hi

    # --- B: fix up the mixed blocks --------------------------------------
    maxb = min(ncols * nbuckets, nb)
    posb = _nonzero_sized(mixed, maxb, nb)
    validb = posb < nb
    posbc = torch.clamp(posb, 0, nb - 1)
    gidx = (posbc[:, None] * _BLOCK + torch.arange(_BLOCK, device=dev)[None, :]).reshape(-1)
    gx = x.index_select(1, gidx)
    gy = y.index_select(1, gidx)
    gz = z.index_select(1, gidx)
    gkey = dcomp.index_select(0, gidx)
    glanes = maxb * _BLOCK
    lane_valid = validb.repeat_interleave(_BLOCK)
    gx, gy, gz = _mask_identity(gx, gy, gz, lane_valid, field)
    # runs must not merge across gathered blocks: composite block-local key
    blk = torch.arange(maxb, dtype=dcomp.dtype, device=dev).repeat_interleave(_BLOCK)
    comp2 = blk * (ncols * nbuckets + 1) + gkey
    # every run of the gathered blocks lies in one block: all rounds in one launch
    gx, gy, gz = FK.ec_seg_rounds_lm(gx, gy, gz, comp2, _BLOCK.bit_length() - 1, field,
                                     tile=_BLOCK)
    # read only the in-block run starts: offset 0 in a run (a tile's first
    # lane starts one), defined lanes of ec_seg_rounds
    gi = torch.arange(glanes, device=dev)
    prev = torch.cat([comp2[:1] ^ 1, comp2[:-1]])
    is_start = ((gi % _BLOCK == 0) | (comp2 != prev)) & lane_valid
    # <= runs + mixed-blocks <= 2 * ncols * nbuckets in-block run starts
    ecap = 2 * ncols * nbuckets
    spos = _nonzero_sized(is_start, ecap, glanes)
    svalid = spos < glanes
    sposc = torch.clamp(spos, 0, glanes - 1)
    # a key of its own for each lane that holds no partial (above every
    # bucket's key, ascending in lane order): single-lane runs, so the
    # merge's rounds end with its longest bucket run, and the lanes sort
    # as under one shared sentinel
    sent = ncols * nbuckets
    ekey_sent = sent + torch.arange(nb + ecap, dtype=dcomp.dtype, device=dev)
    mkey = torch.where(svalid, gkey.index_select(0, sposc), ekey_sent[nb:])
    mx = gx.index_select(1, sposc)
    my = gy.index_select(1, sposc)
    mz = gz.index_select(1, sposc)
    mx, my, mz = _mask_identity(mx, my, mz, svalid, field)

    # --- C: merge uniform block sums + mixed-run partials ----------------
    ukey = torch.where(mixed, ekey_sent[:nb], bk_lo)
    ux, uy, uz = _mask_identity(ax, ay, az, ~mixed, field)
    ekeys = torch.cat([ukey, mkey])
    en = nb + ecap
    order = torch.argsort(ekeys, stable=True)
    ekeys = ekeys.index_select(0, order)
    ex = torch.cat([ux, mx], dim=1).index_select(1, order)
    ey = torch.cat([uy, my], dim=1).index_select(1, order)
    ez = torch.cat([uz, mz], dim=1).index_select(1, order)
    # _bucket_sums reads each run's first lane: defined in ec_seg_rounds
    ex, ey, ez = FK.ec_seg_rounds_lm(ex, ey, ez, ekeys, max(1, (en - 1).bit_length()), field)
    return ex, ey, ez, ekeys, en


def _compact(x, y, z, d, total: int, size: int, sentinel: int, field: str):
    """Reduce the sorted runs of points (16, ..., total) with keys
    (..., total) to partials at stride CHUNK from each run's start (CHUNK
    rounds), gather those to `size` lanes (identities beyond them, keyed
    sentinel, sentinel + 1, ...: single-lane runs, so the second call's
    rounds end with the longest run of partials) and finish the runs
    there. Returns (x, y, z, keys)."""
    dev = x.device
    # gathered below: the lanes at offsets from their run's start that are
    # multiples of CHUNK = 2^rounds, the defined lanes of ec_seg_rounds
    x, y, z = FK.ec_seg_rounds_lm(x, y, z, d, _CHUNK.bit_length() - 1, field)
    idx = torch.arange(total, device=dev)
    first = torch.ones(tuple(d.shape[:-1]) + (1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([first, d[..., 1:] != d[..., :-1]], dim=-1)
    start_idx = torch.where(is_start, idx, -1)
    seg_start = torch.cummax(start_idx, dim=-1).values
    mask = ((idx - seg_start) % _CHUNK) == 0
    pos = _nonzero_sized(mask, size, total)
    valid = pos < total
    posc = torch.clamp(pos, 0, total - 1)
    cd = torch.where(valid, _take(d, posc),
                     sentinel + torch.arange(size, dtype=d.dtype, device=dev))
    x, y, z = _mask_identity(_take(x, posc), _take(y, posc), _take(z, posc), valid, field)
    # _bucket_sums reads the run starts: defined lanes
    x, y, z = FK.ec_seg_rounds_lm(x, y, z, cd, size.bit_length() - 1, field)
    return x, y, z, cd


def _bucket_sums(x, y, z, cd, c: int, ncols: int, size: int, field: str):
    """From reduced runs (each run's first lane holds its bucket's sum; keys
    col*2^c + digit, sorted, over `size` lanes) to each column's window sum
    sum_j j*B_j: buckets extracted by searchsorted (run starts only), then
    weighted through the bits of j in one ec_bucket_weights_lm launch over
    the (batch x ncols) columns.
    Returns 3 x (16, ..., ncols) projective points."""
    dev = x.device
    batch = tuple(cd.shape[:-1])
    nbuckets = 1 << c
    targets = torch.arange(ncols * nbuckets, dtype=cd.dtype, device=dev)
    pos = torch.searchsorted(cd, targets.expand(batch + targets.shape).contiguous())
    pos = torch.clamp(pos, 0, size - 1)
    present = _take(cd, pos) == targets
    buckets = _mask_identity(_take(x, pos), _take(y, pos), _take(z, pos), present, field)
    acc = FK.ec_bucket_weights_lm(*(_lanes(v) for v in buckets), c, field)
    return tuple(v.view((16,) + batch + (ncols,)) for v in acc)


def _window_reduce_multi(pts_lm, dcomp, field: str, c: int, ncols: int, n: int,
                         compact: int):
    """Bucket-accumulate one window for NCOLS scalar columns sharing one
    point set. pts_lm is (16, ncols*n) limb-major projective points in
    composite-key sorted order; dcomp is the sorted composite key
    col*2^c + digit (so runs never cross column boundaries). Returns the
    window partial sums as (3, 16, ncols) projective points.

    Leading axes between the limbs and the lanes (points (16, W, ncols*n),
    keys (W, ncols*n)) are independent windows, reduced together: every
    launch covers all of them, with the reference's per-window adds on the
    same lanes."""
    x, y, z = pts_lm
    nbuckets = 1 << c
    total = ncols * n
    x, y, z = _mask_identity(x, y, z, (dcomp & (nbuckets - 1)) != 0, field)

    if total % _BLOCK == 0 and total // _BLOCK >= 4 * ncols * nbuckets:
        if dcomp.dim() > 1:  # the blocked reduction takes one window at a time
            outs = [_window_reduce_multi((x[:, w], y[:, w], z[:, w]), dcomp[w], field, c,
                                         ncols, n, compact) for w in range(dcomp.shape[0])]
            return tuple(torch.stack([o[i] for o in outs], dim=1) for i in range(3))
        x, y, z, cd, compact = _blocked_partials(
            x, y, z, dcomp, field, ncols, nbuckets, total)
    else:
        x, y, z, cd = _compact(x, y, z, dcomp, total, compact, ncols * nbuckets, field)
    return _bucket_sums(x, y, z, cd, c, ncols, compact, field)


# ---------------------------------------------------------------------------
# the general Pippenger (any point set): msm, msm_multi
# ---------------------------------------------------------------------------

_COMPACT = 1024  # compacted lane count of a single-column window (>= n/CHUNK + 2^c)


def scalars_to_limbs(scalars: list[int]) -> np.ndarray:
    """Plain (non-Montgomery) 16-bit limb array (N, 16) int32 from int scalars."""
    return L.ints_to_limbs(list(scalars))


def _window_reduce(pts_lm, d, field: str, c: int, n: int):
    """Bucket-accumulate the windows of one scalar column (reference
    _window_reduce): points (16, W, n) in digit-sorted order, digits (W, n).
    Up to 2*COMPACT lanes every run is reduced in place (log2 n rounds);
    above, runs are compacted first. Returns 3 x (16, W, 1)."""
    x, y, z = _mask_identity(*pts_lm, d != 0, field)
    if n <= 2 * _COMPACT:
        logn = max(1, n.bit_length() - 1)
        x, y, z = FK.ec_seg_rounds_lm(x, y, z, d, logn, field)
        size = n
    else:
        x, y, z, d = _compact(x, y, z, d, n, _COMPACT, 1 << c, field)
        size = _COMPACT
    return _bucket_sums(x, y, z, d, c, 1, size, field)


def _to_projective(px, py, pz, field: str, in_form: str):
    """The MSM's input as limb-major projective (16, N) coordinates:
    Jacobian (X, Y, Z) rows (N, 16) become (X*Z : Y : Z^3), Z = 0 the
    identity (0 : 1 : 0); projective input passes through."""
    if in_form == "projective":
        return px, py, pz
    if in_form != "jacobian":
        raise ValueError(f"in_form must be 'jacobian' or 'projective', not {in_form!r}")
    x, z = _jacobian_xz(px, pz, field)
    return _mask_identity(x, py.T, z, ~L.is_zero(pz), field)


def _jacobian_xz(px, pz, field: str):
    """Jacobian rows (N, 16) X and Z -> the limb-major (16, N) projective
    X*Z and Z^3: three K1 launches."""
    xt, zt = px.T.contiguous(), pz.T.contiguous()
    z2 = FK.mont_mul_lm(zt, zt, field)
    return FK.mont_mul_lm(xt, zt, field), FK.mont_mul_lm(z2, zt, field)


def _gather_sorted(pts, pidx):
    """Limb-major points (16, N) gathered at (W, M) indices -> (16, W, M)."""
    return tuple(v.index_select(1, pidx.reshape(-1)).view((16,) + tuple(pidx.shape))
                 for v in pts)


def _to_jacobian(X, Y, Z, field: str):
    """Limb-major projective (16, L) (X : Y : Z) -> Jacobian rows (L, 16)
    (X*Z, Y*Z^2, Z): three K1 launches."""
    X, Y, Z = (v.contiguous() for v in (X, Y, Z))
    zz = FK.mont_mul_lm(Z, Z, field)
    return FK.mont_mul_lm(X, Z, field).T, FK.mont_mul_lm(Y, zz, field).T, Z.T


def msm(px, py, pz, scalar_limbs, field: str = "fq", c: int = WINDOW_BITS,
        in_form: str = "jacobian"):
    """MSM over a batch of points and plain-form scalar limbs (N, 16):
    sum_i [s_i] P_i as one Jacobian point (3, 16). Points are (N, 16) x3
    Jacobian Montgomery rows, or limb-major (16, N) projective coordinates
    (identity (0 : 1 : 0)) with in_form="projective". The reference's
    device path at every size: its host branch for N <= 512 is not taken.

    The windows, independent passes of the reference's scan, are reduced
    together (one launch per round for all of them); their sums combine by
    Horner from the most significant window."""
    pp = _to_projective(px, py, pz, field, in_form)
    digits = FK.msm_digits_lm(scalar_limbs[None], c)[:, 0]  # (W, N)
    d, order = torch.sort(digits, dim=-1, stable=True)
    ws = _window_reduce(_gather_sorted(pp, order), d, field, c, digits.shape[1])
    # windows most significant last: acc = [2^c] acc + w, one chained launch
    xz, yz2, Z = _to_jacobian(*FK.ec_horner_lm(*ws, c, field), field)  # (1, 16) each
    return torch.stack([xz[0], yz2[0], Z[0]])


def msm_multi(px, py, pz, scalars, field: str = "fq", c: int = WINDOW_BITS,
              in_form: str = "jacobian"):
    """Batched Pippenger MSM: NCOLS scalar vectors (NCOLS, N, 16) plain
    limbs over ONE shared point set (as for msm). Returns (NCOLS, 3, 16)
    Jacobian points. The reference's device path at every size."""
    ncols, n = scalars.shape[0], scalars.shape[1]
    nbuckets = 1 << c
    total = ncols * n
    # compacted width: per-column stride-CHUNK partials + bucket runs
    compact = 1 << max(1, (total // _CHUNK + ncols * nbuckets - 1).bit_length())
    pp = _to_projective(px, py, pz, field, in_form)
    comp = FK.msm_digits_lm(scalars, c)  # (W, ncols, n) composite keys
    d, order = torch.sort(comp.reshape(comp.shape[0], total), dim=-1, stable=True)
    pts = _gather_sorted(pp, order % n)  # shared point set: same points for every column
    ws = _window_reduce_multi(pts, d, field, c, ncols, n, compact)  # 3 x (16, W, ncols)
    # the windows' Horner, 3 x (16, ncols), as (ncols, 3, 16) Jacobian
    return torch.stack(_to_jacobian(*FK.ec_horner_lm(*ws, c, field), field), dim=1)


def msm_host(points, scalars):
    """Reference host MSM (slow; the tests' oracle)."""
    acc = type(points[0]).identity()
    for p, s in zip(points, scalars):
        acc = acc + p * s
    return acc


# ---------------------------------------------------------------------------
# the shifted table
# ---------------------------------------------------------------------------


def batch_inv(v: torch.Tensor, spec: L.FieldSpec) -> torch.Tensor:
    """Inverses of (N, 16) nonzero Montgomery elements: inv_i =
    prefix_{i-1} * suffix_{i+1} * (prod_all)^-1 — two scans (K9) and one
    Fermat inversion (K8) instead of one Fermat chain per lane."""
    one = L.const(spec.one_mont, v.device)[None]
    pre = FK.mont_cumprod_lm(v, spec.name)
    suf = FK.mont_cumprod_lm(v, spec.name, reverse=True)
    inv_all = FK.mont_inv_lm(pre[-1:], spec.name)
    pre_x = torch.cat([one, pre[:-1]])
    suf_x = torch.cat([suf[1:], one])
    return FK.mont_mul_rows(FK.mont_mul_rows(pre_x, suf_x, spec.name), inv_all, spec.name)


def fixed_base_table(px, py, pz, field: str = "fq", c: int = WINDOW_BITS):
    """(N, 16) Jacobian Montgomery points -> (W*N, 16) row-major packed
    AFFINE shifted table (row w*N+i = [2^(c*w)] G_i; each row is x|y as 8
    words of packed 16-bit limb pairs).

    Row-major packed rows make the MSM's dominant cost — the gather in
    sorted-digit order — one row gather of 64 bytes per lane. The [2^c]
    multiples are c complete doublings (K2) per window; one batched
    inversion and two K1 products normalize all W*N of them. Every input
    point must be finite (the identity has no affine form); SRS points
    always are."""
    spec = L.FIELDS[field]
    if L.is_zero(pz).any():
        raise ValueError("fixed_base_table: every point must be finite")
    n = px.shape[0]
    W = 256 // c
    x, z = _jacobian_xz(px, pz, field)
    y = py.T.contiguous()
    tables = []
    for _ in range(W):
        tables.append((x, y, z))
        for _ in range(c):  # [2^c] multiples: c complete doublings
            x, y, z = FK.ec_add_proj_lm(x, y, z, x, y, z, field=field)
    # limb-major (16, W*N): lane w*N+i holds [2^(c*w)] G_i
    lm = [torch.stack([t[i] for t in tables], dim=1).reshape(16, W * n) for i in range(3)]
    zinv = batch_inv(lm[2].T, spec).T.contiguous()
    xa = FK.mont_mul_lm(lm[0], zinv, field)
    ya = FK.mont_mul_lm(lm[1], zinv, field)
    packed = torch.cat([t[0::2] | (t[1::2] << 16) for t in (xa, ya)], dim=0)  # (16, W*N)
    return packed.T.contiguous()


def _unpack_rows_lm(rows_t, field: str):
    """(16, T) packed affine rows -> three (16, T) limb-major projective
    coordinate tensors (z = 1 in Montgomery form)."""
    outs = []
    for ci in range(2):
        p = rows_t[8 * ci : 8 * (ci + 1)]
        lo = p & 0xFFFF
        hi = (p >> 16) & 0xFFFF
        outs.append(torch.stack([lo, hi], dim=1).reshape(16, -1))
    outs.append(L.FIELDS[field].one_col(rows_t.device).expand(outs[0].shape).contiguous())
    return outs


def _msm_fixed_dev(tbl, scalars, field: str, c: int):
    ncols, n = scalars.shape[0], scalars.shape[1]
    W = 256 // c
    nbuckets = 1 << c
    total = ncols * W * n
    compact = 1 << max(1, (total // _CHUNK + ncols * nbuckets - 1).bit_length())

    # one sort of an int64 key: composite key in the high bits, lane index
    # in the low bits — a total order, equal to a stable argsort of the keys
    idx_bits = packed_idx_bits(total)
    packed = torch.sort(FK.msm_digits_lm(scalars, c, packed=True)).values
    d = packed >> idx_bits
    order = packed & ((1 << idx_bits) - 1)
    pidx = order % (W * n)  # table lanes repeat per column
    pts = _unpack_rows_lm(tbl.index_select(0, pidx).T.contiguous(), field)
    X, Y, Z = _window_reduce_multi(pts, d, field, c, ncols, W * n, compact)
    # (3, 16, ncols) projective -> (ncols, 3, 16) Jacobian
    return torch.stack(_to_jacobian(X, Y, Z, field), dim=1)


def msm_fixed_multi(table, scalars, field: str = "fq", c: int = WINDOW_BITS,
                    col_chunk: int = 8):
    """Multi-column fixed-base MSM over a shifted table from
    fixed_base_table(). scalars: (C, N, 16) plain limbs. Returns
    (C, 3, 16) Jacobian Montgomery points.

    Columns are processed in chunks of `col_chunk` to bound the gathered
    working set; the remainder is padded to the next power of two (zero
    scalar columns reduce to the identity)."""
    C = scalars.shape[0]
    if table.shape[0] != (256 // c) * scalars.shape[1]:
        raise ValueError("fixed-base table does not match the scalar count")
    outs = []
    lo = 0
    while lo < C:
        take = min(col_chunk, C - lo)
        size = take if take == col_chunk else 1 << (take - 1).bit_length()
        chunk = scalars[lo : lo + take]
        if size != take:
            chunk = torch.cat(
                [chunk, torch.zeros((size - take,) + tuple(chunk.shape[1:]),
                                    dtype=chunk.dtype, device=chunk.device)], dim=0)
        outs.append(_msm_fixed_dev(table, chunk, field, c)[:take])
        lo += take
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
