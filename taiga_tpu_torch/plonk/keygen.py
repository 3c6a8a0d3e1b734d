"""Proving/verifying key generation.

Runs circuit synthesis in keygen mode to obtain fixed columns and copy
constraints, builds the permutation argument's sigma columns from the copy
cycles, and commits fixed + sigma columns into the verifying key.

Port of taiga_tpu/plonk/keygen.py. Keygen is host work on every device: the
commitments go through the port's copy of the native engine, the branch the
reference takes whenever its engine is built. `commit_columns` is the
reference's device branch of commit_column: the same commitments from a
key's Montgomery tables, by the port's iNTT and MSM on a device.
`proving_key_from_arrays` rebuilds a proving key from plain data (the
verifying key's bytes and the Montgomery fixed/sigma tables), so a key made
elsewhere can be carried across.

Permutation tags follow halo2's scheme: cell (column j, row i) has identity
tag delta^j * omega^i, where delta = g^(2^32) generates distinct cosets of the
odd-order subgroup; sigma_j(omega^i) is the tag of the *next* cell in the
copy cycle (identity for uninvolved cells).

Proving keys are cached per circuit digest — the reference re-keygens per
resource-logic proof (~4 s each, taiga_halo2 constant.rs:6146); we never do
(SURVEY.md §7 hard part #6).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..crypto.curves import VestaPoint
from ..crypto.fields import Fp
from ..ops import limbs as L
from .circuit import BLINDING_ROWS, CircuitBuilder, ConstraintSystem
from .expression import ADVICE, FIXED, INSTANCE
from .srs import get_params

P = Fp.MODULUS
DELTA = pow(5, 1 << 32, P)  # generator of the odd-order subgroup


def commit_column(k: int, values: list[int], blind: int = 0) -> VestaPoint:
    """IPA commitment of a Lagrange-basis column: iNTT to coefficients, then
    sum c_i G_i + blind*W. Must match the prover's column commitments, which
    are over the COEFFICIENT basis (prover.py commit_coeff_rows) — the
    multiopen opens coefficient polynomials. Runs on the native host engine
    (threaded NTT + Pippenger); raises if the engine cannot be built."""
    from ..native import FIELD_FP, FIELD_FQ, hostops as H
    from .msm_claim import srs_host_rows

    if not H.available():
        raise RuntimeError("keygen needs the native host engine (g++ build failed)")
    omega_inv = pow(omega_for(k), -1, P)
    vals = H.to_mont(FIELD_FP, H.ints_to_u64([v % P for v in values]))
    coeffs = H.ntt(FIELD_FP, vals, k, omega_inv, inverse=True)
    x, y, inf = H.msm(FIELD_FQ, srs_host_rows(k), H.from_mont(FIELD_FP, coeffs))
    pt = VestaPoint.identity() if inf else VestaPoint.from_xy(x, y)
    if blind:
        pt = pt + get_params(k).w * blind
    return pt


COMMIT_CHUNK = 8  # columns a device MSM commits at once (msm_multi)


def commit_columns(k: int, values_mont, device) -> list[VestaPoint]:
    """Unblinded commitments of Lagrange-basis columns, (C, n, 16)
    Montgomery values (ProvingKey.fixed_mont / sigma_mont), on `device`: one
    iNTT for all of them, then the general MSM over the SRS (ops/msm.py,
    msm_multi), COMMIT_CHUNK columns at a time. Equal to commit_column's
    points (the device branch of taiga_tpu/plonk/keygen.py::commit_column)."""
    from ..ops import ec, msm as msm_mod, ntt
    from .srs import srs_device

    dev = L.resolve_device(device)
    coeffs = L.from_mont(ntt.intt(L.const(values_mont, dev), k, "fp"), L.FP)
    gx, gy, gz = (L.const(a, dev) for a in srs_device(k))
    pts = []
    for lo in range(0, coeffs.shape[0], COMMIT_CHUNK):
        out = msm_mod.msm_multi(gx, gy, gz, coeffs[lo : lo + COMMIT_CHUNK], field="fq")
        pts += ec.points_from_device((out[:, 0], out[:, 1], out[:, 2]), VestaPoint)
    return pts


class _DSU:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        while self.parent.setdefault(x, x) != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


class VerifyingKey:
    def __init__(self, k, cs, perm_cols, fixed_commitments, sigma_commitments, omega):
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.perm_cols = perm_cols  # ordered [(kind, index)]
        self.fixed_commitments = fixed_commitments
        self.sigma_commitments = sigma_commitments
        self.omega = omega
        self.usable_rows = self.n - BLINDING_ROWS - 1
        # the digest covers the FULL vk serialization — gate and lookup
        # structure included — so it pins the circuit's constraints, not just
        # its committed columns (reference vk.pinned(), resource_logic_vk.rs)
        h = hashlib.blake2b(digest_size=32, person=b"TaigaTPU-vk-dgst")
        h.update(self.to_bytes())
        self.digest = h.digest()

    def transcript_seed(self) -> bytes:
        return self.digest

    # --- serialization -------------------------------------------------
    # Layout (all little-endian):
    #   magic "TVK1" | k u8 | num_fixed u16 | num_advice u16 | num_instance u16
    #   | num_gates u16 | per gate: name len u8 + name + expr
    #   | num_lookups u16 | per lookup: name len u8 + name + npairs u8 + exprs
    #   | num_perm_cols u16 | per col: kind u8 + index u16
    #   | fixed/sigma commitments: count u16 + 32-byte points each
    def to_bytes(self) -> bytes:
        from .circuit import ConstraintSystem  # noqa: F401 (doc reference)
        from .expression import ser_expr

        out = bytearray(b"TVK1")
        out.append(self.k)
        cs = self.cs
        out += cs.num_fixed.to_bytes(2, "little")
        out += cs.num_advice.to_bytes(2, "little")
        out += cs.num_instance.to_bytes(2, "little")
        out += len(cs.gates).to_bytes(2, "little")
        for g in cs.gates:
            nb = g.name.encode()
            out.append(len(nb))
            out += nb
            ser_expr(g.poly, out)
        out += len(cs.lookups).to_bytes(2, "little")
        for lk in cs.lookups:
            nb = lk.name.encode()
            out.append(len(nb))
            out += nb
            out.append(len(lk.pairs))
            for inp, tab in lk.pairs:
                ser_expr(inp, out)
                ser_expr(tab, out)
        kind_tag = {ADVICE: 0, INSTANCE: 1, FIXED: 2}
        out += len(self.perm_cols).to_bytes(2, "little")
        for kind, idx in self.perm_cols:
            out.append(kind_tag[kind])
            out += idx.to_bytes(2, "little")
        for commits in (self.fixed_commitments, self.sigma_commitments):
            out += len(commits).to_bytes(2, "little")
            for c in commits:
                out += c.to_bytes()
        return bytes(out)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "VerifyingKey":
        from .circuit import ConstraintSystem, Gate, Lookup
        from .expression import deser_expr

        if buf[:4] != b"TVK1":
            raise ValueError("bad vk magic")
        pos = 4
        k = buf[pos]
        pos += 1

        def u16():
            nonlocal pos
            v = int.from_bytes(buf[pos : pos + 2], "little")
            pos += 2
            return v

        nf, na, ni = u16(), u16(), u16()
        cs = ConstraintSystem(nf, na, ni)
        for _ in range(u16()):
            ln = buf[pos]
            name = buf[pos + 1 : pos + 1 + ln].decode()
            pos += 1 + ln
            poly, pos = deser_expr(buf, pos)
            cs.gates.append(Gate(name, poly))
        for _ in range(u16()):
            ln = buf[pos]
            name = buf[pos + 1 : pos + 1 + ln].decode()
            pos += 1 + ln
            npairs = buf[pos]
            pos += 1
            pairs = []
            for _ in range(npairs):
                inp, pos = deser_expr(buf, pos)
                tab, pos = deser_expr(buf, pos)
                pairs.append((inp, tab))
            cs.lookups.append(Lookup(name, pairs))
        kind_by_tag = {0: ADVICE, 1: INSTANCE, 2: FIXED}
        perm_cols = []
        for _ in range(u16()):
            kind = kind_by_tag[buf[pos]]
            pos += 1
            perm_cols.append((kind, u16()))
        commits = []
        for _ in range(2):
            cnt = u16()
            pts = []
            for _ in range(cnt):
                pt = VestaPoint.from_bytes(buf[pos : pos + 32])
                if pt is None:
                    raise ValueError("bad vk commitment point")
                pts.append(pt)
                pos += 32
            commits.append(pts)
        if pos != len(buf):
            raise ValueError("trailing vk bytes")
        return cls(k, cs, perm_cols, commits[0], commits[1], omega_for(k))

    def compressed(self) -> "Fp":
        """Blake2b-compress the serialized vk into a base-field element — the
        resource 'logic' field (reference resource_logic_vk.rs:33-51)."""
        h = hashlib.blake2b(
            self.to_bytes(), digest_size=64, person=b"TaigaTPU-rl-vkcm"
        ).digest()
        return Fp.from_uniform_bytes(h)


class ProvingKey:
    """Verifying key + the Montgomery fixed and sigma value tables, each
    (columns, n, 16) int32 numpy arrays (16-bit limbs)."""

    def __init__(self, vk, fixed_mont: np.ndarray, sigma_mont: np.ndarray, config):
        self.vk = vk
        self._fixed = fixed_mont
        self._sigma = sigma_mont
        self.config = config

    def fixed_mont(self) -> np.ndarray:
        """(num_fixed, n, 16) Montgomery values of the fixed columns."""
        return self._fixed

    def sigma_mont(self) -> np.ndarray:
        """(num_perm_cols, n, 16) Montgomery values of the sigma columns."""
        return self._sigma


def _cols_to_mont(cols: list[list[int]], n: int) -> np.ndarray:
    if not cols:
        return np.zeros((0, n, L.NLIMBS), np.int32)
    return np.stack([L.FP.array_to_mont(col) for col in cols])


def proving_key_from_arrays(vk_bytes: bytes, fixed_mont, sigma_mont, config=None) -> ProvingKey:
    """A proving key from plain data: the verifying key's serialization
    (VerifyingKey.to_bytes, which carries the constraint system and the
    permutation columns) and the (columns, n, 16) Montgomery fixed and sigma
    tables (ProvingKey.fixed_mont / sigma_mont, any integer dtype holding
    16-bit limbs)."""
    vk = VerifyingKey.from_bytes(vk_bytes)
    fixed = np.ascontiguousarray(np.asarray(fixed_mont), dtype=np.int32)
    sigma = np.ascontiguousarray(np.asarray(sigma_mont), dtype=np.int32)
    for name, arr, ncols in (("fixed", fixed, vk.cs.num_fixed),
                             ("sigma", sigma, len(vk.perm_cols))):
        if arr.shape != (ncols, vk.n, L.NLIMBS):
            raise ValueError(f"{name} table shape {arr.shape} does not match the key")
    return ProvingKey(vk, fixed, sigma, config)


def omega_for(k: int) -> int:
    return pow(5, (P - 1) >> k, P)


def keygen(circuit, k: int) -> ProvingKey:
    """Generate the proving key for a circuit instance (witness ignored)."""
    cs, config = type(circuit).build_cs()
    builder = CircuitBuilder(cs, k, "keygen")
    circuit.synthesize(builder, config)
    return keygen_from_builder(cs, config, builder, k)


def keygen_from_builder(cs: ConstraintSystem, config, builder: CircuitBuilder, k: int) -> ProvingKey:
    n = 1 << k
    omega = omega_for(k)

    # --- permutation assembly ----------------------------------------
    used_cols = sorted(
        {(kind, idx) for (a, b) in builder.copies for (kind, idx, _) in (a, b)},
        key=lambda c: ({ADVICE: 0, INSTANCE: 1, FIXED: 2}[c[0]], c[1]),
    )
    col_pos = {c: j for j, c in enumerate(used_cols)}

    dsu = _DSU()
    for a, b in builder.copies:
        dsu.union(a, b)
    classes: dict = {}
    for a, b in builder.copies:
        for cell in (a, b):
            classes.setdefault(dsu.find(cell), set()).add(cell)

    # sigma(cell) = next cell in its class cycle (sorted for determinism)
    next_in_cycle = {}
    for members in classes.values():
        cyc = sorted(members, key=lambda c: (col_pos[(c[0], c[1])], c[2]))
        for i, cell in enumerate(cyc):
            next_in_cycle[cell] = cyc[(i + 1) % len(cyc)]

    # tag(col j, row i) = delta^j * omega^i
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % P
    delta_pows = [pow(DELTA, j, P) for j in range(len(used_cols))]

    sigma_cols = []
    for kind, idx in used_cols:
        j = col_pos[(kind, idx)]
        col = [delta_pows[j] * omega_pows[i] % P for i in range(n)]
        sigma_cols.append(col)
    for cell, nxt in next_in_cycle.items():
        kind, idx, row = cell
        nk, ni, nrow = nxt
        sigma_cols[col_pos[(kind, idx)]][row] = (
            delta_pows[col_pos[(nk, ni)]] * omega_pows[nrow] % P
        )

    # --- commitments --------------------------------------------------
    fixed_commitments = [commit_column(k, col) for col in builder.fixed]
    sigma_commitments = [commit_column(k, col) for col in sigma_cols]

    vk = VerifyingKey(k, cs, used_cols, fixed_commitments, sigma_commitments, omega)
    return ProvingKey(vk, _cols_to_mont(builder.fixed, n), _cols_to_mont(sigma_cols, n), config)
