"""The plain version of the port's tape interpreter (K4;
taiga_tpu_torch.ops.tape_device) against the JAX package's
taiga_tpu.ops.tape_device.tape_eval_device on the quotient tape of
tests/test_lookup.py's ByteRangeCircuit at k = 9 (extended domain 4,096
lanes), on seeded random tables and scalars; exact equality. Both evaluators
run the tape as schedule_tape reorders it; the compliance circuit's tape
(compiled without keygen) is held to its register budget and to the
unscheduled tape's values. The CUDA kernel is held against this plain
version on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiga_tpu.ops import tape_device as JTD
from taiga_tpu.plonk import protocol as JPR, tape as JT
from taiga_tpu.plonk.circuit import EXT_FACTOR
from taiga_tpu.plonk.keygen import keygen as jkeygen
from taiga_tpu_torch.ops import limbs as TL, tape_device as TTD
from taiga_tpu_torch.circuits.compliance import ComplianceCircuit
from taiga_tpu_torch.plonk import keygen as TK, protocol as TPR, tape as TT
from taiga_tpu_torch.plonk.circuit import CircuitBuilder
from tests.test_lookup import ByteRangeCircuit


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions run many small ops: one intra-op thread per test
    worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 9
D = (1 << K) * EXT_FACTOR


@pytest.fixture(scope="module")
def tapes():
    jpk = jkeygen(ByteRangeCircuit(), K)
    tpk = TK.proving_key_from_arrays(jpk.vk.to_bytes(), jpk.fixed_mont(), jpk.sigma_mont())
    jvk, tvk = jpk.vk, tpk.vk
    jtape = JT.compile_tape(JPR.build_constraints(jvk.cs, jvk.perm_cols, jvk.usable_rows),
                            EXT_FACTOR)
    ttape = TT.compile_tape(TPR.build_constraints(tvk.cs, tvk.perm_cols, tvk.usable_rows),
                            EXT_FACTOR)
    cs = jvk.cs
    counts = {JT.FIXED: cs.num_fixed, JT.ADVICE: cs.num_advice, JT.INSTANCE: cs.num_instance,
              JT.SIGMA: len(jvk.perm_cols), JT.Z: JPR.num_chunks(jvk.perm_cols),
              JT.LOOKUP_A: len(cs.lookups), JT.LOOKUP_S: len(cs.lookups),
              JT.LOOKUP_Z: len(cs.lookups), JT.XID: 1, JT.L0: 1, JT.LLAST: 1, JT.LBLIND: 1}
    return jtape, ttape, counts


def _tables(counts, seed, d=D):
    rng = np.random.default_rng(seed)
    out = {}
    for kind, c in counts.items():
        v = rng.integers(0, 1 << 16, size=(c, d, 16), dtype=np.int64)
        v[..., 15] &= 0x3FFF
        out[kind] = v
    return out


def _eval_both(jtape, ttape, counts, seed):
    tabs = _tables(counts, seed)
    rng = np.random.default_rng(seed + 1)
    svals = [int(x) for x in rng.integers(1, 1 << 62, size=len(jtape.scalar_exprs))]
    want = JTD.tape_eval_device(
        jtape, {k: jnp.asarray(v.astype(np.uint32)) for k, v in tabs.items()}, svals, D)
    got = TTD.tape_eval_device(
        ttape, {k: torch.as_tensor(v.astype(np.int32)) for k, v in tabs.items()}, svals, D)
    return got.numpy().astype(np.int64), np.asarray(want).astype(np.int64)


def test_port_compiles_the_same_tape(tapes):
    jtape, ttape, _ = tapes
    np.testing.assert_array_equal(ttape.code, jtape.code)
    assert (ttape.num_regs, ttape.out_reg) == (jtape.num_regs, jtape.out_reg)


def test_tape_eval_plain_matches_reference(tapes):
    got, want = _eval_both(*tapes, seed=21)
    assert got.shape == (D, 16)
    np.testing.assert_array_equal(got, want)


def _shift_registers(tape, mod):
    """The same program with every register r renamed (r + 1) % num_regs,
    so the output register moves."""
    code = tape.code.copy()
    n = tape.num_regs
    for row in code:
        row[1] = (row[1] + 1) % n
        if row[0] != JT.OP_LOAD:
            row[2] = (row[2] + 1) % n
            if row[0] in (JT.OP_ADD, JT.OP_MUL):
                row[3] = (row[3] + 1) % n
    return mod.Tape(code=code, scalar_exprs=tape.scalar_exprs, num_regs=n,
                    out_reg=(tape.out_reg + 1) % n)


def test_out_register_rename(tapes):
    jtape, ttape, counts = tapes
    base_got, _ = _eval_both(jtape, ttape, counts, seed=31)
    got, want = _eval_both(_shift_registers(jtape, JT), _shift_registers(ttape, TT), counts,
                           seed=31)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base_got)


def test_normalize_code_and_pad_tables(tapes):
    jtape, ttape, counts = tapes
    offsets, off = {}, 0
    for kind in JT.TABLE_KINDS:
        offsets[kind] = off
        off += counts[kind]
    np.testing.assert_array_equal(TTD.normalize_code(np.asarray(ttape.code), offsets, D),
                                  JTD.normalize_code(np.asarray(jtape.code), offsets, D))
    t = _tables({JT.FIXED: 3}, 41)[JT.FIXED]
    np.testing.assert_array_equal(
        TTD.pad_tables(torch.as_tensor(t.astype(np.int32)), D).numpy().astype(np.int64),
        np.asarray(JTD.pad_tables(jnp.asarray(t.astype(np.uint32)), D)).astype(np.int64))


def test_kernel_wrapper_validates_its_program():
    code = np.array([[TTD.OP_LOAD, 0, 0, 5, 0], [TTD.OP_MUL, 1, 0, 0, 0]], np.int32)
    TTD._check_code(code, num_regs=2, tc=1, n_scalars=1)
    for bad in ([TTD.OP_LOAD, 0, 1, 5, 0], [TTD.OP_MUL, 2, 0, 0, 0], [TTD.OP_MULS, 1, 0, 1, 0],
                [9, 0, 0, 0, 0], [TTD.OP_ADD, 1, 0, -1, 0]):
        with pytest.raises(ValueError):
            TTD._check_code(np.array([bad], np.int32), num_regs=2, tc=1, n_scalars=1)
    tables = torch.zeros((1, 16, 64 + TTD.LPAD + TTD.RPAD), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TTD.tape_eval_lm(code, torch.zeros((1, 16), dtype=torch.int32), tables, "fp", 2, 64)


def _offsets(counts):
    offsets, off = {}, 0
    for kind in JT.TABLE_KINDS:
        if counts[kind]:
            offsets[kind] = off
            off += counts[kind]
    return offsets


def _writes_before_reads(code):
    written = set()
    for op, dst, a, b, _ in code.tolist():
        if op != TTD.OP_LOAD:
            assert a in written
            if op in (TTD.OP_ADD, TTD.OP_MUL):
                assert b in written
        written.add(dst)


def _seeded_inputs(counts, svals, d, seed):
    tabs = _tables(counts, seed, d)
    cat = np.concatenate([tabs[k] for k in JT.TABLE_KINDS if counts[k]])
    sc = np.stack([TL.int_to_limbs(v * TL.FP.r % TL.FP.modulus) for v in svals])
    return torch.as_tensor(cat.astype(np.int32)), torch.as_tensor(sc.astype(np.int32))


def test_scheduled_tape_matches_reference(tapes):
    """schedule_tape's stream, through tape_eval_plain, equals the JAX
    package's evaluation of the compiled tape bit for bit."""
    jtape, ttape, counts = tapes
    code, regs = TTD.device_code(ttape, _offsets(counts), D)
    assert regs <= ttape.num_regs
    _writes_before_reads(code)
    rng = np.random.default_rng(52)
    svals = [int(x) for x in rng.integers(1, 1 << 62, size=len(jtape.scalar_exprs))]
    tables, scalars = _seeded_inputs(counts, svals, D, 51)
    TTD._check_code(code, regs, tables.shape[0], scalars.shape[0])
    got = TTD.tape_eval_plain(code, scalars, tables, "fp", regs, D)
    tabs = _tables(counts, 51)
    want = JTD.tape_eval_device(
        jtape, {k: jnp.asarray(v.astype(np.uint32)) for k, v in tabs.items()}, svals, D)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def test_device_code_is_scheduled_once_per_tape(tapes):
    """device_code schedules a tape once per (offsets, domain) and hands
    back the same read-only stream after; another domain, or another tape
    with the same code, gets its own, equal where the inputs are."""
    _, ttape, counts = tapes
    code, regs = TTD.device_code(ttape, _offsets(counts), D)
    assert TTD.device_code(ttape, dict(_offsets(counts)), D)[0] is code
    assert not code.flags.writeable
    other = TTD.device_code(ttape, _offsets(counts), 2 * D)[0]
    assert other is not code
    fresh = TT.Tape(code=ttape.code.copy(), scalar_exprs=ttape.scalar_exprs,
                    num_regs=ttape.num_regs, out_reg=ttape.out_reg)
    code2, regs2 = TTD.device_code(fresh, _offsets(counts), D)
    assert code2 is not code and regs2 == regs
    np.testing.assert_array_equal(code2, code)


def test_compliance_tape_schedules_into_few_registers():
    """The compliance quotient tape (1,213 instructions over 117 registers)
    scheduled: at most 64 registers, every register written before it is
    read, in range; over a 1,024-lane domain it evaluates to the
    unscheduled tape's values."""
    cs, config = ComplianceCircuit.build_cs()
    layout = CircuitBuilder(cs, 13, "keygen")
    ComplianceCircuit().synthesize(layout, config)
    kinds = {JT.ADVICE: 0, JT.INSTANCE: 1, JT.FIXED: 2}
    perm = sorted({(kind, idx) for pair in layout.copies for (kind, idx, _) in pair},
                  key=lambda c: (kinds[c[0]], c[1]))
    tape = TT.compile_tape(TPR.build_constraints(cs, perm, layout.usable_rows), EXT_FACTOR)
    assert tape.out_reg == 0
    counts = {JT.FIXED: cs.num_fixed, JT.ADVICE: cs.num_advice, JT.INSTANCE: cs.num_instance,
              JT.SIGMA: len(perm), JT.Z: TPR.num_chunks(perm), JT.LOOKUP_A: len(cs.lookups),
              JT.LOOKUP_S: len(cs.lookups), JT.LOOKUP_Z: len(cs.lookups), JT.XID: 1, JT.L0: 1,
              JT.LLAST: 1, JT.LBLIND: 1}
    d = 1024
    plain_code = TTD.normalize_code(np.asarray(tape.code), _offsets(counts), d)
    code, regs = TTD.device_code(tape, _offsets(counts), d)
    assert regs <= 64 < tape.num_regs
    _writes_before_reads(code)
    rng = np.random.default_rng(53)
    svals = [int(x) for x in rng.integers(1, 1 << 62, size=len(tape.scalar_exprs))]
    tables, scalars = _seeded_inputs(counts, svals, d, 54)
    TTD._check_code(code, regs, tables.shape[0], scalars.shape[0])
    got = TTD.tape_eval_plain(code, scalars, tables, "fp", regs, d)
    want = TTD.tape_eval_plain(plain_code, scalars, tables, "fp", tape.num_regs, d)
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_a_tape_beyond_shared_memory():
    """A register file that does not fit in a block's shared memory (at
    BLOCK_LANES lanes) is refused, before any launch, not evaluated
    elsewhere."""
    code = np.array([[TTD.OP_LOAD, 0, 0, 0, 0]], np.int32)
    tables = torch.zeros((1, 16, 64 + TTD.LPAD + TTD.RPAD), dtype=torch.int32)
    regs = next(r for r in range(1, 1024) if TTD.file_bytes(r, 1) > TTD.SMEM_BYTES)
    with pytest.raises(ValueError, match="registers"):
        TTD.tape_eval_lm(code, torch.zeros((1, 16), dtype=torch.int32), tables, "fp", regs, 64)
