"""Proof creation pipeline (device-resident).

Port of taiga_tpu/plonk/prover.py::_create_proof_device and the parts of its
ProverPipeline that the single-proof path runs. On every device the port
takes the branches the reference takes on a TPU: commitments through the
fixed-base SRS MSM (ops/msm.py) and the quotient numerator through the tape
interpreter (ops/tape_device.py). The stages, in transcript order:

  synthesize witness (host ints)                      -> advice columns
  iNTT + fixed-base MSM                               -> advice commitments
  theta -> compressed lookup columns (tapes over the base domain), device
      sort/merge permutation, commit A'/S'
  beta, gamma -> permutation and lookup grand products (scans + one
      inversion per chunk), commit
  y -> quotient: the compiled constraint tape over the 8n coset, divide by
      Z_H, coset iNTT, split, commit
  x -> evaluations at the query points
  multiopen: device aggregation, then the IPA open: the native C++ tail or
      the device open (plonk/hybrid_open.py, `ipa=`)

Every blind is drawn through the caller's `randbits(300) % p`, in the
reference's order, so `random.Random(seed).getrandbits` reproduces the
reference's seeded proof byte for byte.

Per-proving-key device state (fixed/sigma coefficient + extended tables,
transparent domain tables, the SRS shifted table, compiled tapes) is built
once per device and cached on the pipeline.
"""

from __future__ import annotations

import secrets
import time
from functools import lru_cache

import numpy as np
import torch

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp
from ..ops import ec, limbs as L, lookup_sort as LS, msm as msm_mod, ntt, poly
from ..ops import ff_kernels as FK, tape_device as TD
from .circuit import BLINDING_ROWS, EXT_FACTOR, PERM_CHUNK, CircuitBuilder
from .expression import ADVICE, FIXED, INSTANCE
from .keygen import DELTA, ProvingKey
from .protocol import (
    L0,
    LBLIND,
    LLAST,
    LOOKUP_A,
    LOOKUP_S,
    LOOKUP_Z,
    NUM_H_PIECES,
    QUOTIENT,
    SIGMA,
    XID,
    Z,
    build_constraints,
    collect_queries,
)
from .srs import get_params, srs_device
from .tape import compile_tape
from .transcript import ProofWriter

P = Fp.MODULUS


class StageTimer:
    """Per-stage wall-clock attribution, in the stage names of the
    reference's _StageTimer. Synchronizes the device at each mark so device
    time lands in the right bucket; pass one to create_proof to use it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stages: list[tuple[str, float]] = []
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str):
        self._sync()
        now = time.perf_counter()
        self.stages.append((name, now - self.t))
        self.t = now


class _NoTimer:
    def mark(self, name: str):
        pass


class _Rand:
    """Blinds and fillers from the caller's randbits, reference order."""

    def __init__(self, randbits):
        self.randbits = randbits

    def __call__(self) -> int:
        return self.randbits(300) % P

    def mont_rows(self, count: int) -> np.ndarray:
        return L.FP.array_to_mont([self() for _ in range(count)])


def _mont_scalar(v: int, device):
    return L.const(L.int_to_limbs(v * L.FP.r % P), device)


@lru_cache(maxsize=None)
def _ext_domain_tables(k: int):
    """Numpy Montgomery ext-coset tables xid/l0/llast/lblind and Z_H^-1 on the
    coset, all shape (8n, 16) int32."""
    n = 1 << k
    ke = k + 3
    usable = n - BLINDING_ROWS - 1
    g = 5
    p = P
    omega_ext = pow(5, (p - 1) >> ke, p)
    pts = [1] * (n * EXT_FACTOR)
    for i in range(1, n * EXT_FACTOR):
        pts[i] = pts[i - 1] * omega_ext % p
    xid = [g * v % p for v in pts]
    gn = pow(g, n, p)
    w8 = pow(omega_ext, n, p)
    zh8 = [(gn * pow(w8, i, p) - 1) % p for i in range(EXT_FACTOR)]
    zh8_inv = [pow(v, -1, p) for v in zh8]
    zh_inv = [zh8_inv[i % EXT_FACTOR] for i in range(n * EXT_FACTOR)]

    def indicator_ext(rows):
        base = [0] * n
        for r in rows:
            base[r] = 1
        coeffs = ntt.intt(torch.as_tensor(L.FP.array_to_mont(base)), k, "fp")
        padded = torch.zeros((n * EXT_FACTOR, L.NLIMBS), dtype=L.DTYPE)
        padded[:n] = coeffs
        return ntt.coset_ntt(padded, ke, "fp").numpy()

    l0 = indicator_ext([0])
    llast = indicator_ext([usable])
    lblind = indicator_ext(range(usable + 1, n))
    return (
        L.FP.array_to_mont(xid),
        l0,
        llast,
        lblind,
        L.FP.array_to_mont(zh_inv),
    )


class ProverPipeline:
    """Per-ProvingKey, per-device pipeline state + cached static tables."""

    def __init__(self, pk: ProvingKey, device):
        self.pk = pk
        self.device = L.resolve_device(device)
        vk = pk.vk
        self.k = vk.k
        self.n = vk.n
        self.u = vk.usable_rows
        self.omega = vk.omega
        self.exprs = build_constraints(vk.cs, vk.perm_cols, self.u)
        self.queries = collect_queries(self.exprs, vk.cs.num_fixed)
        self.chunks = [
            vk.perm_cols[i : i + PERM_CHUNK]
            for i in range(0, len(vk.perm_cols), PERM_CHUNK)
        ]
        self._static = None
        self._srs_table = None
        self._tape = None
        self._lookup_tapes = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=self.device)

    # --- static device tables -----------------------------------------
    def static_tables(self):
        if self._static is not None:
            return self._static
        pk, k, n = self.pk, self.k, self.n
        xid, l0, llast, lblind, zh_inv = _ext_domain_tables(k)
        fixed_v = self._t(pk.fixed_mont())  # (F, n, 16) values
        sigma_v = self._t(pk.sigma_mont())
        fixed_c = ntt.intt(fixed_v, k, "fp") if fixed_v.shape[0] else fixed_v
        sigma_c = ntt.intt(sigma_v, k, "fp") if sigma_v.shape[0] else sigma_v
        self._static = {
            "xid": self._t(xid),
            "l0": self._t(l0),
            "llast": self._t(llast),
            "lblind": self._t(lblind),
            "zh_inv_lm": self._t(np.ascontiguousarray(zh_inv.T)),  # (16, 8n) limb-major
            "fixed_v": fixed_v,
            "sigma_v": sigma_v,
            "fixed_c": fixed_c,
            "sigma_c": sigma_c,
            "fixed_e": self.to_ext(fixed_c),
            "sigma_e": self.to_ext(sigma_c),
            "omega_pows": self._t(L.FP.array_to_mont(self._host_powers(self.omega, n))),
        }
        return self._static

    @staticmethod
    def _host_powers(base: int, n: int):
        out = [1] * n
        for i in range(1, n):
            out[i] = out[i - 1] * base % P
        return out

    def values_to_coeffs(self, vals_mont):
        return ntt.intt(vals_mont, self.k, "fp")

    def to_ext(self, coeffs_mont):
        n = self.n
        shape = tuple(coeffs_mont.shape[:-2]) + (n * EXT_FACTOR, L.NLIMBS)
        padded = torch.zeros(shape, dtype=L.DTYPE, device=coeffs_mont.device)
        padded[..., :n, :] = coeffs_mont
        return ntt.coset_ntt(padded, self.k + 3, "fp")

    # --- commitments ---------------------------------------------------
    def srs_table(self):
        """The fixed-base shifted table of the SRS on this device."""
        if self._srs_table is None:
            gx, gy, gz = (self._t(a) for a in srs_device(self.k))
            self._srs_table = msm_mod.fixed_base_table(gx, gy, gz, field="fq")
        return self._srs_table

    def commit_coeff_rows(self, coeffs_mont, blinds: list[int]) -> list[VestaPoint]:
        """Commit each row of (C, n, 16) Montgomery coefficients — ONE
        multi-column fixed-base MSM over the shared SRS for all C columns."""
        plain = L.from_mont(coeffs_mont, L.FP)
        outs = msm_mod.msm_fixed_multi(self.srs_table(), plain, field="fq")
        pts = ec.points_from_device((outs[:, 0], outs[:, 1], outs[:, 2]), VestaPoint)
        w = get_params(self.k).w
        return [pt + w * b if b else pt for pt, b in zip(pts, blinds)]

    # --- permutation grand products ------------------------------------
    def _grand_products(self, num, den):
        """cps[c][i] = prod_{j<=i} num_c[j] / den_c[j] for (C, n, 16) stacks,
        with the division done by ONE Fermat inversion per chunk:
        inv(prefix_den[i]) = suffix_den_excl[i] * inv(total_den)."""
        cumprod = lambda a: poly.mont_cumprod(a.movedim(1, 0), "fp").movedim(0, 1)
        num_cp = cumprod(num)
        den_sfx = torch.flip(cumprod(torch.flip(den, dims=[1])), dims=[1])
        inv_total = L.mont_inv(den_sfx[:, 0], L.FP)  # (C, 16)
        one_row = self._t(L.FP.one_mont).expand(den_sfx.shape[0], 1, L.NLIMBS)
        sfx_excl = torch.cat([den_sfx[:, 1:], one_row], dim=1)
        den_cp_inv = L.mont_mul(sfx_excl, inv_total[:, None, :], L.FP)
        return L.mont_mul(num_cp, den_cp_inv, L.FP)

    def z_values(self, cols_v, beta: int, gamma: int, rand: _Rand):
        """Grand-product columns as (n_chunks, n, 16) Montgomery values —
        cumprods, cross-chunk chaining, and blinding-row fill on device."""
        st = self.static_tables()
        n, u = self.n, self.u
        beta_m = _mont_scalar(beta, self.device)
        gamma_m = _mont_scalar(gamma, self.device)
        # blinding rows u+1..n-1 are random; tiny, generated host-side
        rand_rows = self._t(np.stack([rand.mont_rows(n - u - 1) for _ in self.chunks]))
        perm_index = {c: j for j, c in enumerate(self.pk.vk.perm_cols)}
        nums, dens = [], []
        for c, chunk in enumerate(self.chunks):
            num = den = None
            for j_local, col in enumerate(chunk):
                jg = c * PERM_CHUNK + j_local
                v = cols_v[perm_index[col]]
                bd = L.mont_mul(beta_m, _mont_scalar(pow(DELTA, jg, P), self.device), L.FP)
                t_num = L.add(L.add(v, L.mont_mul(bd, st["omega_pows"], L.FP), L.FP),
                              gamma_m, L.FP)
                t_den = L.add(L.add(v, L.mont_mul(beta_m, st["sigma_v"][jg], L.FP), L.FP),
                              gamma_m, L.FP)
                num = t_num if num is None else L.mont_mul(num, t_num, L.FP)
                den = t_den if den is None else L.mont_mul(den, t_den, L.FP)
            nums.append(num)
            dens.append(den)
        cps = self._grand_products(torch.stack(nums), torch.stack(dens))
        # chain: running_c = prod_{c'<c} cp_{c'}[u-1]; z_c[0] = running_c,
        # z_c[i+1] = running_c * cp_c[i] for i < u, blinding rows random
        one = self._t(L.FP.one_mont)[None]
        finals = cps[:, u - 1]  # (C, 16)
        running = torch.cat([one, poly.mont_cumprod(finals, "fp")[:-1]], dim=0)
        z_main = L.mont_mul(running[:, None, :], cps, L.FP)
        return torch.cat([running[:, None, :], z_main[:, :u], rand_rows], dim=1)

    # --- lookup argument --------------------------------------------------
    def lookup_as_values(self, advice_v, inst_v, theta: int):
        """Compressed input/table value columns for every lookup over the
        base domain, A = ((a_0*theta + a_1)*theta + ...), evaluated by the
        tape interpreter with theta as the Horner variable: returns (A, S)
        each (L, n, 16) Montgomery."""
        st = self.static_tables()
        if self._lookup_tapes is None:
            self._lookup_tapes = [
                tuple(compile_tape([pair[side] for pair in lk.pairs], 1, y_name="theta")
                      for side in (0, 1))
                for lk in self.pk.vk.cs.lookups
            ]
        ks = {FIXED: st["fixed_v"], ADVICE: advice_v, INSTANCE: inst_v}
        ch = {"theta": theta}
        a_rows, s_rows = [], []
        for a_tape, s_tape in self._lookup_tapes:
            a_rows.append(TD.tape_eval_device(a_tape, ks, a_tape.scalar_values(ch), self.n))
            s_rows.append(TD.tape_eval_device(s_tape, ks, s_tape.scalar_values(ch), self.n))
        return torch.stack(a_rows), torch.stack(s_rows)

    def lookup_z_values(self, a_v, s_v, ap_v, sp_v, beta: int, gamma: int, rand: _Rand):
        """Lookup grand products: Z[0]=1, Z[i+1]=Z[i]*(A+beta)(S+gamma) /
        ((A'+beta)(S'+gamma)) over usable rows; blinding rows random.
        All inputs (L, n, 16) Montgomery."""
        n, u = self.n, self.u
        rand_rows = self._t(np.stack([rand.mont_rows(n - u - 1) for _ in range(a_v.shape[0])]))
        beta_m = _mont_scalar(beta, self.device)
        gamma_m = _mont_scalar(gamma, self.device)
        num = L.mont_mul(L.add(a_v, beta_m, L.FP), L.add(s_v, gamma_m, L.FP), L.FP)
        den = L.mont_mul(L.add(ap_v, beta_m, L.FP), L.add(sp_v, gamma_m, L.FP), L.FP)
        cps = self._grand_products(num, den)
        ones = self._t(L.FP.one_mont).expand(cps.shape[0], 1, L.NLIMBS)
        return torch.cat([ones, cps[:, :u], rand_rows], dim=1)

    # --- quotient -------------------------------------------------------
    def quotient_coeffs(self, advice_e, inst_e, z_e, beta: int, gamma: int, y: int,
                        theta: int = 0, lk_a_e=None, lk_s_e=None, lk_z_e=None):
        """Quotient numerator via the tape interpreter over the extended
        coset (ONE kernel launch for the whole constraint system), divided
        by Z_H and brought back to coefficients."""
        st = self.static_tables()
        if self._tape is None:
            self._tape = compile_tape(self.exprs, EXT_FACTOR)
        ne = self.n * EXT_FACTOR
        if not self.pk.vk.cs.lookups:
            empty = torch.zeros((0, ne, L.NLIMBS), dtype=L.DTYPE, device=self.device)
            lk_a_e = lk_s_e = lk_z_e = empty
        ks = {
            FIXED: st["fixed_e"], SIGMA: st["sigma_e"], ADVICE: advice_e,
            INSTANCE: inst_e, Z: z_e,
            LOOKUP_A: lk_a_e, LOOKUP_S: lk_s_e, LOOKUP_Z: lk_z_e,
            XID: st["xid"][None], L0: st["l0"][None],
            LLAST: st["llast"][None], LBLIND: st["lblind"][None],
        }
        svals = self._tape.scalar_values(
            {"beta": beta, "gamma": gamma, "theta": theta, "y": y})
        acc = TD.tape_eval_device(self._tape, ks, svals, ne)  # (ne, 16)
        # divide by Z_H: one K1 product over the limb-major coset
        num = FK.mont_mul_lm(acc.T.contiguous(), st["zh_inv_lm"], "fp")
        return ntt.coset_intt(num.T, self.k + 3, "fp")


def get_pipeline(pk: ProvingKey, device) -> ProverPipeline:
    """The pipeline of `pk` on `device` (cached on the key, one per device)."""
    dev = L.resolve_device(device)
    pipes = pk.__dict__.setdefault("_pipelines", {})
    pipe = pipes.get(str(dev))
    if pipe is None:
        pipe = pipes[str(dev)] = ProverPipeline(pk, dev)
    return pipe


def create_proof(pk: ProvingKey, circuit, instance: list[Fp], *, device="cuda",
                 randbits=secrets.randbits, timer: StageTimer | None = None,
                 ipa: str = "native") -> bytes:
    """Prove `circuit` against `pk` on `device` ("cuda" unless the caller
    asks for "cpu"). Every blind comes from `randbits`; `timer` (a
    StageTimer) records per-stage wall times; `ipa` picks the IPA open of
    the multiopen: "native" (the C++ engine on the host) or "device"
    (plonk/ipa.py::ipa_open_device). Both give the same proof bytes."""
    from .hybrid_open import IPA_OPENS, multiopen_open_hybrid

    if ipa not in IPA_OPENS:
        raise ValueError(f"ipa must be one of {IPA_OPENS}, not {ipa!r}")
    vk = pk.vk
    k, n, u = vk.k, vk.n, vk.usable_rows
    omega = vk.omega
    pipe = get_pipeline(pk, device)
    dev = pipe.device
    inst = [v.v if isinstance(v, Fp) else int(v) % P for v in instance]
    rand = _Rand(randbits)
    st_t = timer if timer is not None else _NoTimer()

    # --- synthesize witness ------------------------------------------
    cs = vk.cs
    builder = CircuitBuilder(cs, k, "prove")
    circuit.synthesize(builder, pk.config)
    advice = builder.advice
    for col in advice:
        for i in range(u, n):
            col[i] = rand()
    st_t.mark("witness synthesis")

    tr = ProofWriter(b"taiga-tpu-plonk")
    tr.absorb_bytes(vk.digest)
    tr.absorb_bytes(len(inst).to_bytes(4, "little"))
    for v in inst:
        tr.absorb_scalar(Fp(v))

    # --- advice commitments ------------------------------------------
    inst_col = inst + [0] * (n - len(inst))
    advice_v = pipe._t(np.stack([L.FP.array_to_mont(col) for col in advice]))  # (A, n, 16)
    advice_c = pipe.values_to_coeffs(advice_v)
    advice_blinds = [rand() for _ in advice]
    for pt in pipe.commit_coeff_rows(advice_c, advice_blinds):
        tr.write_point(pt)
    st_t.mark("advice commit")

    # --- lookup permuted columns (halo2 lookup::commit_permuted) -------
    lookups = vk.cs.lookups
    theta = 0
    lk_a_v = lk_s_v = lk_ap_v = lk_sp_v = None
    lk_ap_c = lk_sp_c = None
    lk_ap_blinds = lk_sp_blinds = []
    inst_v = pipe._t(L.FP.array_to_mont(inst_col))[None]
    if lookups:
        theta = tr.challenge(b"theta").v
        lk_a_v, lk_s_v = pipe.lookup_as_values(advice_v, inst_v, theta)
        nlk = len(lookups)
        ap_u, sp_u, lk_ok = LS.permute_pairs_device(lk_a_v, lk_s_v, u)
        # checked at once (the host has just waited on the advice commit):
        # left until after the quotient, a failing lookup surfaces as a
        # quotient that does not divide, as in taiga_tpu/plonk/prover.py,
        # whose device path asserts the degree (:1001) before it reads the
        # flag (:1063)
        if not bool(lk_ok.all()):
            raise ValueError("lookup failure: input value not in table")
        # blinding rows drawn per lookup ap-then-sp — the host prover's order
        rand_rows = [rand.mont_rows(n - u) for _ in range(2 * nlk)]
        ap_rand = pipe._t(np.stack(rand_rows[0::2]))
        sp_rand = pipe._t(np.stack(rand_rows[1::2]))
        lk_ap_v = torch.cat([ap_u, ap_rand], dim=1)
        lk_sp_v = torch.cat([sp_u, sp_rand], dim=1)
        both_c = pipe.values_to_coeffs(torch.cat([lk_ap_v, lk_sp_v], dim=0))
        lk_ap_c, lk_sp_c = both_c[:nlk], both_c[nlk:]
        lk_ap_blinds = [rand() for _ in lookups]
        lk_sp_blinds = [rand() for _ in lookups]
        pts = pipe.commit_coeff_rows(both_c, lk_ap_blinds + lk_sp_blinds)
        for a_pt, s_pt in zip(pts[:nlk], pts[nlk:]):
            tr.write_point(a_pt)
            tr.write_point(s_pt)
        st_t.mark("lookup permuted commit")

    beta = tr.challenge(b"beta").v
    gamma = tr.challenge(b"gamma").v

    # --- permutation products ----------------------------------------
    st = pipe.static_tables()
    perm_tables = []
    for kind, idx in vk.perm_cols:
        if kind == ADVICE:
            perm_tables.append(advice_v[idx])
        elif kind == FIXED:
            perm_tables.append(st["fixed_v"][idx])
        else:
            perm_tables.append(inst_v[0])
    z_v = pipe.z_values(torch.stack(perm_tables), beta, gamma, rand)
    st_t.mark("perm grand products")
    z_c = pipe.values_to_coeffs(z_v)
    z_blinds = [rand() for _ in range(z_v.shape[0])]
    lk_z_c = None
    lk_z_blinds = []
    if lookups:
        # permutation + lookup grand products commit in ONE batched MSM
        # (transcript order: z chunks, then lookup z's)
        lk_z_v = pipe.lookup_z_values(lk_a_v, lk_s_v, lk_ap_v, lk_sp_v, beta, gamma, rand)
        lk_z_c = pipe.values_to_coeffs(lk_z_v)
        lk_z_blinds = [rand() for _ in lookups]
        pts = pipe.commit_coeff_rows(torch.cat([z_c, lk_z_c], dim=0), z_blinds + lk_z_blinds)
    else:
        pts = pipe.commit_coeff_rows(z_c, z_blinds)
    for pt in pts:
        tr.write_point(pt)
    st_t.mark("z commit")

    y = tr.challenge(b"y").v

    # --- quotient -----------------------------------------------------
    inst_c = pipe.values_to_coeffs(inst_v)
    advice_e = pipe.to_ext(advice_c)
    inst_e = pipe.to_ext(inst_c)
    z_e = pipe.to_ext(z_c)
    lk_kwargs = {}
    if lookups:
        lk_kwargs = dict(
            theta=theta,
            lk_a_e=pipe.to_ext(lk_ap_c),
            lk_s_e=pipe.to_ext(lk_sp_c),
            lk_z_e=pipe.to_ext(lk_z_c),
        )
    st_t.mark("extend advice/inst/z")
    h_all = pipe.quotient_coeffs(advice_e, inst_e, z_e, beta, gamma, y, **lk_kwargs)
    # degree check: pieces beyond NUM_H_PIECES*n must vanish
    tail = L.from_mont(h_all[NUM_H_PIECES * n :], L.FP)
    if bool(tail.any()):
        raise AssertionError("quotient degree overflow")
    st_t.mark("quotient eval")
    h_pieces = h_all[: NUM_H_PIECES * n].reshape(NUM_H_PIECES, n, L.NLIMBS)
    h_blinds = [rand() for _ in range(NUM_H_PIECES)]
    for pt in pipe.commit_coeff_rows(h_pieces, h_blinds):
        tr.write_point(pt)
    st_t.mark("h commit")

    x = tr.challenge(b"x").v

    # --- stack all committed coefficient tables -----------------------
    # order must match collect_queries kinds
    empty_c = torch.zeros((0, n, L.NLIMBS), dtype=L.DTYPE, device=dev)
    kind_stacks = {
        ADVICE: (advice_c, advice_blinds),
        FIXED: (st["fixed_c"], [0] * st["fixed_c"].shape[0]),
        SIGMA: (st["sigma_c"], [0] * st["sigma_c"].shape[0]),
        Z: (z_c, z_blinds),
        LOOKUP_A: (lk_ap_c if lookups else empty_c, lk_ap_blinds),
        LOOKUP_S: (lk_sp_c if lookups else empty_c, lk_sp_blinds),
        LOOKUP_Z: (lk_z_c if lookups else empty_c, lk_z_blinds),
        QUOTIENT: (h_pieces, h_blinds),
    }
    kind_order = (ADVICE, FIXED, SIGMA, Z, LOOKUP_A, LOOKUP_S, LOOKUP_Z, QUOTIENT)

    # --- evaluations at the query points (device) ---------------------
    queries = pipe.queries
    rotset = sorted({rot % n for (_, _, rot) in queries})
    points = {rot: x * pow(omega, rot, P) % P for rot in rotset}
    all_coeffs = torch.cat(
        [kind_stacks[kd][0] for kd in kind_order if kind_stacks[kd][0].shape[0]], dim=0)
    offsets = {}
    off = 0
    for kd in kind_order:
        offsets[kd] = off
        off += kind_stacks[kd][0].shape[0]
    pts_mont = torch.stack([_mont_scalar(points[rot], dev) for rot in rotset])
    evals_dev = poly.eval_polys_at_points(all_coeffs, pts_mont)  # (Q, C, 16)
    ev_ints = L.limbs_to_ints(L.from_mont(evals_dev, L.FP))
    ncols = all_coeffs.shape[0]
    evals_host = {}
    for qi, rot in enumerate(rotset):
        for kd in kind_order:
            base = offsets[kd]
            for ci in range(kind_stacks[kd][0].shape[0]):
                evals_host[(kd, ci, rot)] = ev_ints[qi * ncols + base + ci]

    evals = {}
    for kind, idx, rot in queries:
        v = evals_host[(kind, idx, rot % n)]
        evals[(kind, idx, rot)] = v
        tr.write_scalar(Fp(v))
    st_t.mark("query evals")

    # --- multiopen (device aggregation + the IPA open) -----------------
    entries = []
    for kind, idx, rot in queries:
        entries.append(
            {
                "coeff_idx": offsets[kind] + idx,
                "blind": kind_stacks[kind][1][idx],
                "point": points[rot % n],
                "value": evals[(kind, idx, rot)],
            }
        )
    multiopen_open_hybrid(pipe, all_coeffs, entries, tr, randbits, ipa=ipa)
    st_t.mark("multiopen + IPA (device)" if ipa == "device" else "multiopen + IPA")
    return tr.bytes()
