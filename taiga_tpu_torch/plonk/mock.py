"""MockProver equivalent: evaluate every gate over the whole domain on a
torch device and check satisfaction, lookups, copies and instance bindings,
without proving.

Port of taiga_tpu/plonk/mock.py. The reference's MockProver is the
workhorse of the circuit tests and powers the *transparent* execution path
(taiga_halo2/src/transparent_ptx.rs:40-98). The gate masks come from
expression.eval_device_many (all gates at once) in plain torch on `device` ("cuda" unless the caller
passes "cpu"); the lookups and copies are checked on the host, as the
reference checks them. verify() returns the reference's failure strings, in
the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import Fp
from ..ops import limbs as L
from .circuit import Circuit, CircuitBuilder
from .expression import ADVICE, FIXED, INSTANCE, TableSet, eval_device_many, eval_host

P = Fp.MODULUS


class VerifyFailure(Exception):
    pass


def gate_masks(gates, ts: TableSet) -> np.ndarray:
    """(num_gates, n) bool: where each gate's polynomial is nonzero."""
    if not gates:
        return np.zeros((0, ts.n), dtype=bool)
    vals = eval_device_many([g.poly for g in gates], ts)
    return torch.stack([~L.is_zero(v) for v in vals]).cpu().numpy()


class MockProver:
    def __init__(self, k: int, builder: CircuitBuilder, instance: list[int],
                 circuit_cls=None, *, device="cuda"):
        self.k = k
        self.n = 1 << k
        self.builder = builder
        self.circuit_cls = circuit_cls
        self.device = L.resolve_device(device)
        self.instance = [v % P for v in instance] + [0] * (self.n - len(instance))

    @classmethod
    def run(cls, k: int, circuit: Circuit, instance: list[Fp], *, device="cuda") -> "MockProver":
        L.resolve_device(device)  # before the synthesis: a missing card raises at once
        cs, config = type(circuit).build_cs()
        builder = CircuitBuilder(cs, k, "prove")
        circuit.synthesize(builder, config)
        return cls(k, builder, [v.v if isinstance(v, Fp) else v for v in instance],
                   circuit_cls=type(circuit), device=device)

    def _tables(self) -> TableSet:
        b = self.builder

        def to_mont(cols):
            if not cols:
                return torch.zeros((0, self.n, L.NLIMBS), dtype=L.DTYPE, device=self.device)
            flat = [v for col in cols for v in col]
            plain = L.ints_to_limbs(flat).reshape(len(cols), self.n, L.NLIMBS)
            return L.to_mont(L.const(plain, self.device), L.FP)

        return TableSet(to_mont(b.fixed), to_mont(b.advice), to_mont([self.instance]))

    def verify(self) -> list[str]:
        """Returns a list of failure descriptions (empty == satisfied)."""
        failures = []
        b = self.builder
        masks = gate_masks(b.cs.gates, self._tables())
        for gi, gate in enumerate(b.cs.gates):
            bad_rows = np.nonzero(masks[gi])[0]
            if bad_rows.size:
                failures.append(
                    f"gate '{gate.name}' not satisfied at rows {bad_rows[:8].tolist()}"
                    + ("..." if bad_rows.size > 8 else "")
                )
        # lookup arguments: every usable row's input tuple must appear among
        # the table tuples (halo2 MockProver checks lookups the same way)
        tables = {FIXED: b.fixed, ADVICE: b.advice, INSTANCE: [self.instance]}
        usable = b.usable_rows
        for lk in b.cs.lookups:
            table_rows = set()
            for r in range(usable):
                table_rows.add(tuple(
                    eval_host(tab, r, self.n, b.fixed, b.advice, [self.instance])
                    for _, tab in lk.pairs
                ))
            for r in range(usable):
                tup = tuple(
                    eval_host(inp, r, self.n, b.fixed, b.advice, [self.instance])
                    for inp, _ in lk.pairs
                )
                if tup not in table_rows:
                    failures.append(
                        f"lookup '{lk.name}' failed at row {r}: "
                        f"{tuple(hex(v) for v in tup)} not in table"
                    )
        # copy constraints
        for (ak, ai, ar), (bk, bi, br) in b.copies:
            va = tables[ak][ai][ar]
            vb = tables[bk][bi][br]
            if va != vb:
                failures.append(
                    f"copy mismatch: {ak}[{ai}][{ar}]={va:#x} != {bk}[{bi}][{br}]={vb:#x}"
                )
        return failures

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            raise VerifyFailure("; ".join(failures))
