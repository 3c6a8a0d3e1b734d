"""Proof creation pipeline (device-resident).

Port of taiga_tpu/plonk/prover.py: _create_proof_device, the lockstep batch
(create_proofs_batch, _batch_phase1/_batch_phase2) and the cross-batch
pipeline (create_proofs_pipelined), with the ProverPipeline stages they
run. A single proof is a batch of one. On every device the port
takes the branches the reference takes on a TPU: commitments through the
fixed-base SRS MSM (ops/msm.py) and the quotient numerator through the tape
interpreter (ops/tape_device.py). The stages, in transcript order:

  synthesize witness (host ints)                      -> advice columns
  iNTT + fixed-base MSM                               -> advice commitments
  theta -> compressed lookup columns (tapes over the base domain), device
      sort/merge permutation, commit A'/S'
  beta, gamma -> permutation and lookup grand products (scans + one
      inversion for all their columns), commit
  y -> quotient: the compiled constraint tape over the 8n coset, divide by
      Z_H, coset iNTT, split, commit
  x -> evaluations at the query points
  multiopen: device aggregation, then the IPA open: the native C++ tail or
      the device open (plonk/hybrid_open.py, `ipa=`)

Every blind is drawn through the caller's `randbits(300) % p`, in the
reference's order, so `random.Random(seed).getrandbits` reproduces the
reference's seeded proof byte for byte. A batch draws stage by stage, and
proof by proof within a stage, as the reference's batch does; its phase 2
values (the multiopen's h blinds, then each native IPA open's draws) are
drawn on the calling thread before phase 2 starts, so a batch's bytes do
not depend on thread timing (the reference draws them on its worker
threads). The pipeline's worker thread runs phase 2 on its own CUDA
stream; FK.plain_versions() and the kernels' launch counts are module
state that both threads see.

Per-proving-key device state (fixed/sigma coefficient + extended tables,
transparent domain tables, the SRS shifted table, compiled tapes) is built
once per device and cached on the pipeline.
"""

from __future__ import annotations

import secrets
import time
from concurrent.futures import ThreadPoolExecutor
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
    """Blinds and fillers from the caller's randbits, reference order. A
    batch draws stage by stage, and proof by proof within a stage: every
    stage draws through per_proof, the one place that order is kept."""

    def __init__(self, randbits):
        self.randbits = randbits

    def per_proof(self, B: int, count: int, reduce: bool = True) -> list[list[int]]:
        """One stage's draws: `count` 300-bit values for each of B proofs,
        proof by proof, each reduced mod p unless `reduce` is False."""
        m = P if reduce else 1 << 300
        return [[self.randbits(300) % m for _ in range(count)] for _ in range(B)]

    def mont_rows(self, B: int, rows: int, count: int) -> np.ndarray:
        """(B * rows, count, 16) Montgomery blinding rows, proof by proof."""
        vals = [r for vs in self.per_proof(B, rows * count) for r in vs]
        return L.FP.array_to_mont(vals).reshape(B * rows, count, L.NLIMBS)


class _ShareRand(_Rand):
    """A rank's share of a batch of B proofs (group.shard(B)): each stage
    draws the whole batch's values, in the single-process order, and keeps
    the share's."""

    def __init__(self, randbits, B: int, share: slice):
        super().__init__(randbits)
        self.B, self.share = B, share

    def per_proof(self, B: int, count: int, reduce: bool = True) -> list[list[int]]:
        if B != self.share.stop - self.share.start:
            raise ValueError(f"a stage of {B} proofs, the share holds "
                             f"{self.share.stop - self.share.start}")
        return super().per_proof(self.B, count, reduce)[self.share]


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
        self._srs_shard = None
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

    def commit_coeff_rows(self, coeffs_mont, blinds: list[int], group=None) -> list[VestaPoint]:
        """Commit each row of (C, n, 16) Montgomery coefficients — ONE
        multi-column fixed-base MSM over the shared SRS for all C columns.
        With `group` (parallel/sharded.py::make_group), the model-parallel
        commit: ONE MSM's points sharded over the ranks, each rank reducing
        its block of the SRS and of every column, the partials gathered and
        folded (sharded_msm_multi); every rank holds the same coefficients
        and gets the same points."""
        if group is None:
            outs = msm_mod.msm_fixed_multi(self.srs_table(), L.from_mont(coeffs_mont, L.FP),
                                           field="fq")
        else:
            outs = self._msm_sharded(coeffs_mont, group)
        pts = ec.points_from_device((outs[:, 0], outs[:, 1], outs[:, 2]), VestaPoint)
        w = get_params(self.k).w
        return [pt + w * b if b else pt for pt, b in zip(pts, blinds)]

    def _msm_sharded(self, coeffs_mont, group):
        """This rank's block of the SRS (cached) and of every column through
        sharded_msm_multi: (C, 3, 16) Jacobian, replicated."""
        from ..parallel import sharded

        sl = group.shard(self.n)
        key = (group.rank, group.world)
        if self._srs_shard is None or self._srs_shard[0] != key:
            self._srs_shard = (key, tuple(self._t(a[sl]) for a in srs_device(self.k)))
        plain = L.from_mont(coeffs_mont[:, sl].contiguous(), L.FP)
        return sharded.sharded_msm_multi(group, *self._srs_shard[1], plain, field="fq")

    # --- permutation grand products ------------------------------------
    def _grand_products(self, num, den):
        """cps[c][i] = prod_{j<=i} num_c[j] / den_c[j] for (C, n, 16) stacks,
        with the division done by ONE Fermat inversion for all C columns:
        inv(prefix_den[i]) = suffix_den_excl[i] * inv(total_den)."""
        cumprod = lambda a: poly.mont_cumprod(a.movedim(1, 0), "fp").movedim(0, 1)
        num_cp = cumprod(num)
        den_sfx = torch.flip(cumprod(torch.flip(den, dims=[1])), dims=[1])
        inv_total = L.mont_inv(den_sfx[:, 0], L.FP)  # (C, 16)
        one_row = self._t(L.FP.one_mont).expand(den_sfx.shape[0], 1, L.NLIMBS)
        sfx_excl = torch.cat([den_sfx[:, 1:], one_row], dim=1)
        den_cp_inv = L.mont_mul(sfx_excl, inv_total[:, None, :], L.FP)
        return L.mont_mul(num_cp, den_cp_inv, L.FP)

    def _mont_per_proof(self, vals: list[int]):
        """One Montgomery scalar per proof, (B, 1, 16): broadcasts over a
        proof's (n, 16) column."""
        return self._t(np.stack([L.int_to_limbs(v * L.FP.r % P) for v in vals]))[:, None, :]

    def z_values_batch(self, cols_vb, betas: list[int], gammas: list[int], rand: _Rand):
        """Grand-product columns of B proofs, (B, chunks, n, 16) Montgomery,
        from their (B, P, n, 16) permutation columns: the cumprods of all
        B * chunks columns share ONE inversion, then the cross-chunk
        chaining and the blinding rows, drawn for every proof in turn."""
        st = self.static_tables()
        n, u = self.n, self.u
        B, nc = cols_vb.shape[0], len(self.chunks)
        rand_rows = self._t(rand.mont_rows(B, nc, n - u - 1))
        beta_m = self._mont_per_proof(betas)
        gamma_m = self._mont_per_proof(gammas)
        perm_index = {c: j for j, c in enumerate(self.pk.vk.perm_cols)}
        nums, dens = [], []
        for c, chunk in enumerate(self.chunks):
            num = den = None
            for j_local, col in enumerate(chunk):
                jg = c * PERM_CHUNK + j_local
                v = cols_vb[:, perm_index[col]]  # (B, n, 16)
                bd = L.mont_mul(beta_m, _mont_scalar(pow(DELTA, jg, P), self.device), L.FP)
                t_num = L.add(L.add(v, L.mont_mul(bd, st["omega_pows"], L.FP), L.FP),
                              gamma_m, L.FP)
                t_den = L.add(L.add(v, L.mont_mul(beta_m, st["sigma_v"][jg], L.FP), L.FP),
                              gamma_m, L.FP)
                num = t_num if num is None else L.mont_mul(num, t_num, L.FP)
                den = t_den if den is None else L.mont_mul(den, t_den, L.FP)
            nums.append(num)
            dens.append(den)
        flat = lambda cols: torch.stack(cols, dim=1).reshape(B * nc, n, L.NLIMBS)
        cps = self._grand_products(flat(nums), flat(dens)).reshape(B, nc, n, L.NLIMBS)
        # chain: running_c = prod_{c'<c} cp_{c'}[u-1]; z_c[0] = running_c,
        # z_c[i+1] = running_c * cp_c[i] for i < u, blinding rows random
        one = self._t(L.FP.one_mont).expand(B, 1, L.NLIMBS)
        finals = cps[:, :, u - 1]  # (B, C, 16)
        prefix = poly.mont_cumprod(finals.movedim(1, 0), "fp").movedim(0, 1)
        running = torch.cat([one, prefix[:, :-1]], dim=1)
        z_main = L.mont_mul(running[:, :, None, :], cps, L.FP)
        return torch.cat([running[:, :, None, :], z_main[:, :, :u],
                          rand_rows.reshape(B, nc, n - u - 1, L.NLIMBS)], dim=2)

    # --- lookup argument --------------------------------------------------
    def lookup_tapes(self):
        """Each lookup's (input, table) expressions compiled into a tape over
        the base domain, theta-compressed."""
        if self._lookup_tapes is None:
            self._lookup_tapes = [
                tuple(compile_tape([pair[side] for pair in lk.pairs], 1, y_name="theta")
                      for side in (0, 1))
                for lk in self.pk.vk.cs.lookups
            ]
        return self._lookup_tapes

    def lookup_as_values_batch(self, advice_vb, inst_vb, thetas: list[int]):
        """Compressed input/table value columns for every lookup of B proofs
        over the base domain, A = ((a_0*theta + a_1)*theta + ...), each
        evaluated by the tape interpreter on its own proof's columns (a
        LOAD's rotation wraps within a proof): returns (A, S), each
        (B, L, n, 16) Montgomery."""
        st = self.static_tables()
        a_rows, s_rows = [], []
        for advice_v, inst_v, theta in zip(advice_vb, inst_vb, thetas):
            ks = {FIXED: st["fixed_v"], ADVICE: advice_v, INSTANCE: inst_v}
            ch = {"theta": theta}
            for a_tape, s_tape in self.lookup_tapes():
                a_rows.append(TD.tape_eval_device(a_tape, ks, a_tape.scalar_values(ch), self.n))
                s_rows.append(TD.tape_eval_device(s_tape, ks, s_tape.scalar_values(ch), self.n))
        shape = (len(thetas), len(self.lookup_tapes()), self.n, L.NLIMBS)
        return torch.stack(a_rows).reshape(shape), torch.stack(s_rows).reshape(shape)

    def lookup_z_values_batch(self, a_vb, s_vb, ap_vb, sp_vb, betas: list[int],
                              gammas: list[int], rand: _Rand):
        """Lookup grand products of B proofs: Z[0]=1, Z[i+1]=Z[i]*(A+beta)
        (S+gamma) / ((A'+beta)(S'+gamma)) over usable rows, ONE inversion
        for all B * L columns; blinding rows random, drawn for every proof
        in turn. All inputs (B, L, n, 16) Montgomery."""
        n, u = self.n, self.u
        B, nlk = a_vb.shape[:2]
        rand_rows = self._t(rand.mont_rows(B, nlk, n - u - 1))
        beta_m = self._mont_per_proof(betas)[:, None]
        gamma_m = self._mont_per_proof(gammas)[:, None]
        num = L.mont_mul(L.add(a_vb, beta_m, L.FP), L.add(s_vb, gamma_m, L.FP), L.FP)
        den = L.mont_mul(L.add(ap_vb, beta_m, L.FP), L.add(sp_vb, gamma_m, L.FP), L.FP)
        flat = lambda a: a.reshape(B * nlk, n, L.NLIMBS)
        cps = self._grand_products(flat(num), flat(den))
        ones = self._t(L.FP.one_mont).expand(B * nlk, 1, L.NLIMBS)
        z = torch.cat([ones, cps[:, :u], rand_rows], dim=1)
        return z.reshape(B, nlk, n, L.NLIMBS)

    # --- quotient -------------------------------------------------------
    def quotient_tape(self):
        """The whole constraint system compiled into one tape over the
        extended coset."""
        if self._tape is None:
            self._tape = compile_tape(self.exprs, EXT_FACTOR)
        return self._tape

    def quotient_coeffs_batch(self, advice_eb, inst_eb, z_eb, betas, gammas, ys, thetas,
                              lk_a_eb=None, lk_s_eb=None, lk_z_eb=None):
        """Quotient numerators of B proofs by the tape interpreter over the
        extended coset, ONE K4 launch a proof (each proof has its own
        challenges), then ONE K1 product dividing all B by Z_H and one coset
        iNTT over the (B, 8n, 16) stack. Returns (B, 8n, 16) coefficients."""
        st = self.static_tables()
        tape = self.quotient_tape()
        B, ne = advice_eb.shape[0], self.n * EXT_FACTOR
        if not self.pk.vk.cs.lookups:
            lk_a_eb = lk_s_eb = lk_z_eb = torch.zeros(
                (B, 0, ne, L.NLIMBS), dtype=L.DTYPE, device=self.device)
        accs = []
        for b in range(B):
            ks = {
                FIXED: st["fixed_e"], SIGMA: st["sigma_e"], ADVICE: advice_eb[b],
                INSTANCE: inst_eb[b], Z: z_eb[b],
                LOOKUP_A: lk_a_eb[b], LOOKUP_S: lk_s_eb[b], LOOKUP_Z: lk_z_eb[b],
                XID: st["xid"][None], L0: st["l0"][None],
                LLAST: st["llast"][None], LBLIND: st["lblind"][None],
            }
            svals = tape.scalar_values(
                {"beta": betas[b], "gamma": gammas[b], "theta": thetas[b], "y": ys[b]})
            accs.append(TD.tape_eval_device(tape, ks, svals, ne))  # (ne, 16)
        acc_lm = torch.stack(accs).reshape(B * ne, L.NLIMBS).T.contiguous()
        # divide by Z_H: one K1 product over the limb-major cosets of all B
        num = FK.mont_mul_lm(acc_lm, st["zh_inv_lm"].repeat(1, B), "fp")
        return ntt.coset_intt(num.T.reshape(B, ne, L.NLIMBS), self.k + 3, "fp")

    def prepare(self):
        """Build now what the pipeline otherwise builds at first use: the
        static and domain tables, the SRS table and its host rows, the
        compiled tapes and the transforms' tables at k and k + 3. A
        pipelined prover calls this before its loop, so that the worker
        thread running a batch's multiopen and IPA tails (the h commit, the
        native opens) only reads this state. The tapes' device schedules
        (ops/tape_device.py::device_code) are made at their first
        evaluation; only the main thread evaluates tapes."""
        from .msm_claim import srs_host_rows

        self.static_tables()
        self.srs_table()
        self.quotient_tape()
        self.lookup_tapes()
        for k in (self.k, self.k + 3):
            ntt.build_tables(k, self.device)
        get_params(self.k)
        srs_host_rows(self.k)


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
    (plonk/ipa.py::ipa_open_device; the multiopen is then
    multiopen_open_device). Both give the same proof bytes. The stages are
    those of a lockstep batch of one proof (_batch_phase1)."""
    from .hybrid_open import IPA_OPENS, multiopen_open_hybrid

    if ipa not in IPA_OPENS:
        raise ValueError(f"ipa must be one of {IPA_OPENS}, not {ipa!r}")
    st = _batch_phase1(pk, [circuit], [instance], device=device, rand=_Rand(randbits),
                       timer=timer, batch=False)
    multiopen_open_hybrid(st.pipe, st.all_coeffs_b[0], st.entries_b[0], st.trs[0], randbits,
                          ipa=ipa)
    st.timer.mark("multiopen + IPA (device)" if ipa == "device" else "multiopen + IPA")
    return st.trs[0].bytes()


def multiopen_open_device(pipe: ProverPipeline, all_coeffs, entries, tr, randbits):
    """The all-device multiopen (taiga_tpu/plonk/prover.py::
    multiopen_open_device): the hybrid multiopen's device aggregation, then
    ipa_open_device. Transcript-identical to the reference's under the same
    randbits (h_blind drawn first, then the open's draws)."""
    from .hybrid_open import multiopen_open_hybrid

    multiopen_open_hybrid(pipe, all_coeffs, entries, tr, randbits, ipa="device")


def create_proofs_batch(pk: ProvingKey, circuits, instances, *, device="cuda",
                        randbits=secrets.randbits, timer: StageTimer | None = None,
                        group=None) -> list[bytes]:
    """Prove a BATCH of statements of one circuit in lockstep on `device`:
    every device stage runs once over a leading axis of B proofs (their
    columns in one iNTT, one multi-column MSM a commit stage, one
    grand-product stack with one inversion, one Z_H division), while the
    transcripts stay per proof. The multiopen ends in one native IPA open
    a proof, on up to 4 threads. Every blind comes from `randbits` on the
    calling thread, in the reference's order (stage by stage, proof by
    proof within a stage); a batch of one equals create_proof. `timer`
    records the reference's batch stage names. Returns one proof a
    statement, in order; each verifies on its own.

    With `group` (parallel/sharded.py::make_group), data-parallel: every
    rank is given the whole batch, proves its contiguous share on its own
    device (the group's; `device` is not read) and draws the whole batch's
    values in the single-process order, keeping its share's; the proofs
    are then gathered to every rank in batch order. The result equals the
    ungrouped call's byte for byte; the world must divide B."""
    if group is not None:
        return _batch_grouped(pk, circuits, instances, group, randbits, timer)
    rand = _Rand(randbits)
    st = _batch_phase1(pk, circuits, instances, device=device, rand=rand, timer=timer)
    return _batch_phase2(st, _phase2_draws(st, rand))


def _batch_grouped(pk: ProvingKey, circuits, instances, group, randbits, timer) -> list[bytes]:
    """create_proofs_batch(..., group=): this rank's share of the batch on
    the values it would draw in the whole batch (_ShareRand), then the
    proofs of every rank gathered in batch order."""
    from ..parallel import sharded

    B = len(circuits)
    if len(instances) != B:
        raise ValueError(f"{B} circuits and {len(instances)} instances")
    share = group.shard(B)
    rand = _ShareRand(randbits, B, share)
    st = _batch_phase1(pk, circuits[share], instances[share], device=group.device, rand=rand,
                       timer=timer)
    proofs = _batch_phase2(st, _phase2_draws(st, rand))
    if len({len(p) for p in proofs}) != 1:
        raise RuntimeError("the share's proofs differ in length")
    local = torch.frombuffer(bytearray(b"".join(proofs)), dtype=torch.uint8)
    local = local.reshape(len(proofs), -1).to(group.device)
    return [bytes(row.cpu().numpy()) for row in
            sharded.all_gather(group, local).reshape(B, -1)]


def create_proofs_pipelined(jobs, chunk: int = 8, *, device="cuda",
                            randbits=secrets.randbits) -> list[list[bytes]]:
    """Prove several batches, each chunk's multiopen and native IPA tails
    (_batch_phase2, host-bound) on a worker thread while the main thread
    runs the next chunk's device stages (_batch_phase1).

    jobs: [(pk, circuits, instances), ...]; jobs may use different proving
    keys (a compliance batch, then resource-logic batches). A job longer
    than `chunk` is split into lockstep batches of `chunk`. On a CUDA
    device the worker runs on its own stream, which first waits for the
    main stream's phase 1 of its chunk. Every value phase 2 draws is drawn
    on the calling thread right after its chunk's phase 1, so the proofs
    equal create_proofs_batch called chunk by chunk on the same
    `randbits`, at any thread timing. A failure in either thread fails the
    call. Returns one list of proofs a job, in job order."""
    dev = L.resolve_device(device)
    pieces = [(ji, pk, circuits[lo : lo + chunk], instances[lo : lo + chunk])
              for ji, (pk, circuits, instances) in enumerate(jobs)
              for lo in range(0, len(circuits), chunk)]
    for pk in {id(pk): pk for _, pk, _, _ in pieces}.values():
        get_pipeline(pk, dev).prepare()
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    rand = _Rand(randbits)
    results: list[list[bytes]] = [[] for _ in jobs]
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = fut_ji = None
        for ji, pk, cs, insts in pieces:
            st = _batch_phase1(pk, cs, insts, device=dev, rand=rand)
            draws = _phase2_draws(st, rand)
            ready = _hand_over(st, side)
            if fut is not None:
                results[fut_ji].extend(fut.result())
            fut, fut_ji = ex.submit(_phase2_on, side, ready, st, draws), ji
        if fut is not None:
            results[fut_ji].extend(fut.result())
    return results


def _hand_over(st: "_Phase1", side):
    """Order phase 2 on stream `side` after phase 1 on the current stream:
    an event recorded at phase 1's end, and the coefficient stack phase 2
    reads marked as used on `side`, so that the caching allocator does not
    give its memory to the next chunk while `side` still reads it."""
    if side is None:
        return None
    st.all_coeffs_b.record_stream(side)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(st.pipe.device))
    return ev


def _phase2_on(side, ready, st: "_Phase1", draws) -> list[bytes]:
    if side is None:
        return _batch_phase2(st, draws)
    with torch.cuda.stream(side):
        side.wait_event(ready)
        return _batch_phase2(st, draws)


class _Phase1:
    """What a batch's phase 2 needs: the pipeline, the (B, C, n, 16)
    coefficient stack, each proof's opening entries and transcript, the
    stage timer."""

    def __init__(self, pipe, all_coeffs_b, entries_b, trs, timer):
        self.pipe = pipe
        self.all_coeffs_b = all_coeffs_b
        self.entries_b = entries_b
        self.trs = trs
        self.timer = timer


def _phase2_draws(st: _Phase1, rand: _Rand):
    """Every value phase 2 of a batch draws, drawn now on the calling
    thread in the order a serial phase 2 draws them: the B h blinds of the
    multiopen, then each proof's native IPA open (native_open.draws)."""
    from .native_open import draws

    B, k = len(st.trs), st.pipe.k
    h_blinds = [b for (b,) in rand.per_proof(B, 1)]
    tails = rand.per_proof(B, draws(k), reduce=False)
    return h_blinds, tails


def _batch_phase2(st: _Phase1, draws) -> list[bytes]:
    """The host-bound tail of a lockstep batch: the batched hybrid
    multiopen and the native IPA opens, on the values of _phase2_draws."""
    from .hybrid_open import multiopen_open_hybrid_batch

    h_blinds, tails = draws
    multiopen_open_hybrid_batch(st.pipe, st.all_coeffs_b, st.entries_b, st.trs, h_blinds, tails)
    st.timer.mark("multiopen + IPA (batch)")
    return [tr.bytes() for tr in st.trs]


def _batch_phase1(pk: ProvingKey, circuits, instances, *, device, rand: _Rand, timer=None,
                  batch: bool = True) -> _Phase1:
    """The device-heavy front of a lockstep batch, witness synthesis through
    the query evaluations, for B statements of one circuit. Draws, all
    through `rand` (_Rand.per_proof), stage by stage and proof by proof
    within a stage: the witness fillers, the advice blinds, the lookup rows
    (by proof, lookup, A' then S'), the A' then the S' blinds, the z rows
    and blinds, the lookup z rows and blinds, the h blinds. `batch` picks the stage names:
    the reference's batch names, or its single-proof names."""
    vk = pk.vk
    n, u = vk.n, vk.usable_rows
    omega = vk.omega
    pipe = get_pipeline(pk, device)
    dev = pipe.device
    B = len(circuits)
    if B < 1 or len(instances) != B:
        raise ValueError(f"{B} circuits and {len(instances)} instances: need one each, B >= 1")
    st_t = timer if timer is not None else _NoTimer()
    suffix = " (batch)" if batch else ""
    mark = lambda name: st_t.mark(name + suffix)
    cs = vk.cs
    lookups = cs.lookups
    nlk = len(lookups)
    insts = [[v.v if isinstance(v, Fp) else int(v) % P for v in inst] for inst in instances]

    # --- synthesize the witnesses --------------------------------------
    advices = []
    fillers = rand.per_proof(B, cs.num_advice * (n - u))
    for circuit, fill in zip(circuits, fillers):
        builder = CircuitBuilder(cs, vk.k, "prove")
        circuit.synthesize(builder, pk.config)
        for c, col in enumerate(builder.advice):
            col[u:n] = fill[c * (n - u) : (c + 1) * (n - u)]
        advices.append(builder.advice)
    mark("witness synthesis")

    trs = []
    for inst in insts:
        tr = ProofWriter(b"taiga-tpu-plonk")
        tr.absorb_bytes(vk.digest)
        tr.absorb_bytes(len(inst).to_bytes(4, "little"))
        for v in inst:
            tr.absorb_scalar(Fp(v))
        trs.append(tr)

    def commit(coeffs_b, blinds_b, order=None):
        """One multi-column MSM over every proof's columns, (B, C, n, 16),
        rows proof by proof; each proof's C points go to its transcript in
        column order, or in `order` (column indices)."""
        C = coeffs_b.shape[1]
        pts = pipe.commit_coeff_rows(coeffs_b.reshape(B * C, n, L.NLIMBS),
                                     [b for bs in blinds_b for b in bs])
        for bi, tr in enumerate(trs):
            for j in order or range(C):
                tr.write_point(pts[bi * C + j])

    # --- advice commitments ----------------------------------------------
    ncols = cs.num_advice
    advice_vb = pipe._t(np.stack([np.stack([L.FP.array_to_mont(col) for col in adv])
                                  for adv in advices]))  # (B, A, n, 16)
    inst_vb = pipe._t(np.stack([L.FP.array_to_mont(inst + [0] * (n - len(inst)))[None]
                                for inst in insts]))  # (B, 1, n, 16)
    advice_cb = pipe.values_to_coeffs(advice_vb)
    advice_blinds = rand.per_proof(B, ncols)
    commit(advice_cb, advice_blinds)
    mark("advice commit")

    # --- lookup permuted columns (halo2 lookup::commit_permuted) -------
    thetas = [0] * B
    lk_a_vb = lk_s_vb = lk_ap_vb = lk_sp_vb = lk_ap_cb = lk_sp_cb = None
    lk_ap_blinds = lk_sp_blinds = [[] for _ in range(B)]
    if lookups:
        thetas = [tr.challenge(b"theta").v for tr in trs]
        lk_a_vb, lk_s_vb = pipe.lookup_as_values_batch(advice_vb, inst_vb, thetas)
        flat = lambda a: a.reshape(B * nlk, n, L.NLIMBS)
        ap_u, sp_u, lk_ok = LS.permute_pairs_device(flat(lk_a_vb), flat(lk_s_vb), u)
        # checked at once (the host has just waited on the advice commit):
        # left until after the quotient, a failing lookup surfaces as a
        # quotient that does not divide, as in taiga_tpu/plonk/prover.py,
        # whose device path asserts the degree (:1001) before it reads the
        # flag (:1063)
        bad = [bi for bi in range(B) if not bool(lk_ok[bi * nlk : (bi + 1) * nlk].all())]
        if bad:
            raise ValueError(f"lookup failure: input value not in table (proofs {bad})")
        # blinding rows by (proof, lookup), A' then S': the host prover's
        # order within a proof
        rand_rows = rand.mont_rows(B, 2 * nlk, n - u)
        lk_ap_vb = torch.cat([ap_u, pipe._t(rand_rows[0::2])], dim=1)
        lk_sp_vb = torch.cat([sp_u, pipe._t(rand_rows[1::2])], dim=1)
        lk_ap_vb = lk_ap_vb.reshape(B, nlk, n, L.NLIMBS)
        lk_sp_vb = lk_sp_vb.reshape(B, nlk, n, L.NLIMBS)
        both_cb = pipe.values_to_coeffs(torch.cat([lk_ap_vb, lk_sp_vb], dim=1))
        lk_ap_cb, lk_sp_cb = both_cb[:, :nlk], both_cb[:, nlk:]
        lk_ap_blinds = rand.per_proof(B, nlk)
        lk_sp_blinds = rand.per_proof(B, nlk)
        # rows per proof A'_0..A'_L, S'_0..S'_L; transcript A'_0, S'_0, A'_1, ...
        commit(both_cb, [a + s for a, s in zip(lk_ap_blinds, lk_sp_blinds)],
               order=[j for li in range(nlk) for j in (li, nlk + li)])
        mark("lookup permuted commit")

    betas = [tr.challenge(b"beta").v for tr in trs]
    gammas = [tr.challenge(b"gamma").v for tr in trs]

    # --- permutation products ----------------------------------------
    st = pipe.static_tables()
    perm_cols = []
    for kind, idx in vk.perm_cols:
        if kind == ADVICE:
            perm_cols.append(advice_vb[:, idx])
        elif kind == FIXED:
            perm_cols.append(st["fixed_v"][idx].expand(B, n, L.NLIMBS))
        else:
            perm_cols.append(inst_vb[:, 0])
    z_vb = pipe.z_values_batch(torch.stack(perm_cols, dim=1), betas, gammas, rand)
    mark("perm grand products")
    z_cb = pipe.values_to_coeffs(z_vb)
    nz = z_vb.shape[1]
    z_blinds = rand.per_proof(B, nz)
    lk_z_cb = None
    lk_z_blinds = [[] for _ in range(B)]
    if lookups:
        # permutation + lookup grand products commit in ONE batched MSM
        # (transcript order per proof: z chunks, then lookup z's)
        lk_z_vb = pipe.lookup_z_values_batch(lk_a_vb, lk_s_vb, lk_ap_vb, lk_sp_vb, betas,
                                             gammas, rand)
        lk_z_cb = pipe.values_to_coeffs(lk_z_vb)
        lk_z_blinds = rand.per_proof(B, nlk)
        commit(torch.cat([z_cb, lk_z_cb], dim=1),
               [zb + lb for zb, lb in zip(z_blinds, lk_z_blinds)])
    else:
        commit(z_cb, z_blinds)
    mark("z commit")

    ys = [tr.challenge(b"y").v for tr in trs]

    # --- quotient -----------------------------------------------------
    inst_cb = pipe.values_to_coeffs(inst_vb)
    advice_eb = pipe.to_ext(advice_cb)
    inst_eb = pipe.to_ext(inst_cb)
    z_eb = pipe.to_ext(z_cb)
    lk_kwargs = {}
    if lookups:
        lk_kwargs = dict(lk_a_eb=pipe.to_ext(lk_ap_cb), lk_s_eb=pipe.to_ext(lk_sp_cb),
                         lk_z_eb=pipe.to_ext(lk_z_cb))
    st_t.mark("extend (batch)" if batch else "extend advice/inst/z")
    h_all_b = pipe.quotient_coeffs_batch(advice_eb, inst_eb, z_eb, betas, gammas, ys, thetas,
                                         **lk_kwargs)
    del advice_eb, inst_eb, z_eb, lk_kwargs
    # degree check: pieces beyond NUM_H_PIECES*n must vanish
    if bool(L.from_mont(h_all_b[:, NUM_H_PIECES * n :], L.FP).any()):
        raise AssertionError("quotient degree overflow")
    mark("quotient eval")
    h_pieces_b = h_all_b[:, : NUM_H_PIECES * n].reshape(B, NUM_H_PIECES, n, L.NLIMBS)
    h_blinds = rand.per_proof(B, NUM_H_PIECES)
    commit(h_pieces_b, h_blinds)
    mark("h commit")

    xs = [tr.challenge(b"x").v for tr in trs]

    # --- stack all committed coefficient tables -----------------------
    # order must match collect_queries kinds
    empty_b = torch.zeros((B, 0, n, L.NLIMBS), dtype=L.DTYPE, device=dev)
    fixed_b = st["fixed_c"].expand((B,) + tuple(st["fixed_c"].shape))
    sigma_b = st["sigma_c"].expand((B,) + tuple(st["sigma_c"].shape))
    kind_stacks = {
        ADVICE: (advice_cb, advice_blinds),
        FIXED: (fixed_b, [[0] * fixed_b.shape[1]] * B),
        SIGMA: (sigma_b, [[0] * sigma_b.shape[1]] * B),
        Z: (z_cb, z_blinds),
        LOOKUP_A: (lk_ap_cb if lookups else empty_b, lk_ap_blinds),
        LOOKUP_S: (lk_sp_cb if lookups else empty_b, lk_sp_blinds),
        LOOKUP_Z: (lk_z_cb if lookups else empty_b, lk_z_blinds),
        QUOTIENT: (h_pieces_b, h_blinds),
    }
    kind_order = (ADVICE, FIXED, SIGMA, Z, LOOKUP_A, LOOKUP_S, LOOKUP_Z, QUOTIENT)
    all_coeffs_b = torch.cat([kind_stacks[kd][0] for kd in kind_order
                              if kind_stacks[kd][0].shape[1]], dim=1)  # (B, C, n, 16)
    offsets = {}
    off = 0
    for kd in kind_order:
        offsets[kd] = off
        off += kind_stacks[kd][0].shape[1]

    # --- evaluations at the query points (device) ---------------------
    queries = pipe.queries
    rotset = sorted({rot % n for (_, _, rot) in queries})
    points_b = [{rot: x * pow(omega, rot, P) % P for rot in rotset} for x in xs]
    pts_mont_b = pipe._t(np.stack([np.stack([L.int_to_limbs(pts[rot] * L.FP.r % P)
                                             for rot in rotset]) for pts in points_b]))
    evals_dev = poly.eval_polys_at_points(all_coeffs_b, pts_mont_b)  # (B, Q, C, 16)
    ev_ints = L.limbs_to_ints(L.from_mont(evals_dev, L.FP))
    ncols_all, nq = all_coeffs_b.shape[1], len(rotset)
    row = {rot: qi for qi, rot in enumerate(rotset)}
    entries_b = []
    for bi, tr in enumerate(trs):
        entries = []
        for kind, idx, rot in queries:
            v = ev_ints[(bi * nq + row[rot % n]) * ncols_all + offsets[kind] + idx]
            tr.write_scalar(Fp(v))
            entries.append({
                "coeff_idx": offsets[kind] + idx,
                "blind": kind_stacks[kind][1][bi][idx],
                "point": points_b[bi][rot % n],
                "value": v,
            })
        entries_b.append(entries)
    mark("query evals")
    return _Phase1(pipe, all_coeffs_b, entries_b, trs, st_t)
