"""Device interpreter for compiled constraint tapes (plonk/tape.py).

Port of taiga_tpu/ops/tape_device.py. One kernel (K4, csrc/tape_eval.cu)
executes ANY circuit's tape: the instruction stream is data, so switching
circuits or domain sizes never rebuilds anything. The prover runs it for the
quotient numerator over the extended coset and, with `theta` as the Horner
variable, for the compressed lookup columns over the base domain.

Execution model: a host pass (`schedule_tape`) reorders the tape so that
few values are live, then one thread per domain lane walks it over a
register file in shared memory; LOADs read a rotated window of the padded
limb-major table (left pad LPAD wrap rows, so any scaled rotation in
(-LPAD, RPAD) is an offset into one row). The plain version follows the
reference's `_tape_eval_xla`: one full-domain limb op per instruction, over
the same scheduled tape.

The reference buckets the register, table and code counts to bound its
compile cache; a CUDA launch takes any count, so the port does not.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_kernels as CK
from . import ff_kernels as FK
from . import limbs as L

NLIMBS = 16
LPAD = 128   # left wrap pad: supports scaled rotations down to -LPAD
RPAD = 128   # right pad: rotations up to RPAD-1 past the lane

OP_LOAD, OP_ADD, OP_ADDS, OP_MUL, OP_MULS, OP_NEG = range(6)


def pad_tables(tables_cat: torch.Tensor, domain: int) -> torch.Tensor:
    """(TC, domain, 16) Montgomery column stack -> (TC, 16, domain+LPAD+RPAD)
    limb-major padded table (wrap rows replicated)."""
    t = tables_cat.movedim(-1, -2)  # (TC, 16, D)
    left = t[:, :, domain - LPAD:]
    right = t[:, :, :RPAD]
    return torch.cat([left, t, right], dim=2).contiguous()


def normalize_code(code: np.ndarray, kind_offsets: dict[str, int],
                   domain: int) -> np.ndarray:
    """Rewrite tape LOADs for the flat device table: a <- global column,
    b <- scaled rotation normalized to (-LPAD, RPAD)."""
    from ..plonk.tape import TABLE_KINDS

    out = code.copy()
    for row in out:
        if row[0] != OP_LOAD:
            continue
        kind = TABLE_KINDS[row[2]]
        rot = int(row[4]) % domain
        if rot >= domain // 2:
            rot -= domain
        assert -LPAD < rot < RPAD, f"rotation {rot} outside pad window"
        row[2] = kind_offsets[kind] + int(row[3])
        row[3] = rot
        row[4] = 0
    return out


def schedule_tape(code: np.ndarray, num_regs: int) -> tuple[np.ndarray, int]:
    """The same computation as `code` (normalized rows over num_regs
    registers, the result in register 0 after the last instruction) in an
    order that keeps few values live, and its register count.

    The tape computes every constraint before folding any into the Horner
    accumulator, so its values stay live until the end. Here instructions
    are emitted on demand from the result, the operand that needs more
    registers first (Sethi-Ullman): the accumulator chain comes first, and
    each constraint folds in as soon as it is computed. A LOAD, and a NEG,
    ADDS or MULS over one (up to 3 deep), is recomputed at each use instead
    of held; every other value is computed once. Registers are then
    allocated by liveness, the result in register 0. Field operations are
    exact, so the result is bit for bit the input tape's."""
    # SSA: one value per instruction, (op, source values, immediates)
    defs: list[tuple[int, tuple, tuple]] = []
    cur = [-1] * num_regs
    for op, dst, a, b, c in np.asarray(code).tolist():
        if op == OP_LOAD:
            srcs, imm = (), (a, b, c)
        elif op in (OP_ADD, OP_MUL):
            srcs, imm = (cur[a], cur[b]), ()
        elif op in (OP_ADDS, OP_MULS):
            srcs, imm = (cur[a],), (b,)
        else:
            srcs, imm = (cur[a],), ()
        if min(srcs, default=0) < 0:
            raise ValueError("tape: a register is read before it is written")
        defs.append((op, srcs, imm))
        cur[dst] = len(defs) - 1
    if cur[0] < 0:
        raise ValueError("tape: register 0 is never written")
    remat, need = [0] * len(defs), [1] * len(defs)
    for v, (op, srcs, _) in enumerate(defs):
        if op == OP_LOAD:
            remat[v] = 1
        elif len(srcs) == 1 and 0 < remat[srcs[0]] < 3:
            remat[v] = remat[srcs[0]] + 1
        if len(srcs) == 1:
            need[v] = need[srcs[0]]
        elif srcs:
            na, nb = need[srcs[0]], need[srcs[1]]
            need[v] = max(na, nb) if na != nb else na + 1

    # emission (iterative post-order): rows (op, source instructions, imm)
    ins: list[tuple[int, tuple, tuple]] = []
    held: dict[int, int] = {}
    results: list[int] = []
    work = [(cur[0], False)]
    while work:
        v, ready = work.pop()
        op, srcs, imm = defs[v]
        if not ready:
            if v in held:
                results.append(held[v])
                continue
            work.append((v, True))
            swap = len(srcs) == 2 and need[srcs[1]] > need[srcs[0]]
            work.extend((s, False) for s in (srcs if swap else srcs[::-1]))
            continue
        got = results[len(results) - len(srcs):]
        del results[len(results) - len(srcs):]
        if len(srcs) == 2 and need[srcs[1]] > need[srcs[0]]:
            got.reverse()  # the second operand was emitted first
        ins.append((op, tuple(got), imm))
        if not remat[v]:
            held[v] = len(ins) - 1
        results.append(len(ins) - 1)

    # linear-scan allocation; the result is the last instruction
    last_use = list(range(len(ins)))
    for i, (_, srcs, _) in enumerate(ins):
        for s in srcs:
            last_use[s] = i
    last_use[-1] = len(ins)
    reg, free, expiring, rows, n_regs = [0] * len(ins), [], {}, [], 0
    for i, (op, srcs, imm) in enumerate(ins):
        free.extend(reg[d] for d in expiring.pop(i, ()))
        if free:
            free.sort(reverse=True)
            reg[i] = free.pop()
        else:
            reg[i], n_regs = n_regs, n_regs + 1
        expiring.setdefault(last_use[i], []).append(i)
        src = [reg[s] for s in srcs]
        if op == OP_LOAD:
            rows.append((op, reg[i]) + imm)
        elif op in (OP_ADD, OP_MUL):
            rows.append((op, reg[i], src[0], src[1], 0))
        elif op in (OP_ADDS, OP_MULS):
            rows.append((op, reg[i], src[0], imm[0], 0))
        else:
            rows.append((op, reg[i], src[0], 0, 0))
    out = np.asarray(rows, dtype=np.int32)
    r = reg[-1]
    if r != 0:  # rename registers r and 0, so that the result lands in 0
        for col, is_reg in ((1, np.ones(len(out), bool)), (2, out[:, 0] != OP_LOAD),
                            (3, (out[:, 0] == OP_ADD) | (out[:, 0] == OP_MUL))):
            v = out[:, col]
            zero, rr = is_reg & (v == 0), is_reg & (v == r)
            v[zero], v[rr] = r, 0
    return out, n_regs


def _check_code(code: np.ndarray, num_regs: int, tc: int, n_scalars: int):
    """Every index the kernel will follow is in range (validated on the host:
    the kernel trusts its instruction stream)."""
    op, dst, a, b = code[:, 0], code[:, 1], code[:, 2], code[:, 3]
    if ((op < OP_LOAD) | (op > OP_NEG)).any():
        raise ValueError("tape: unknown opcode")
    if ((dst < 0) | (dst >= num_regs)).any():
        raise ValueError("tape: destination register out of range")
    load = op == OP_LOAD
    if ((a[load] < 0) | (a[load] >= tc)).any():
        raise ValueError("tape: table column out of range")
    if ((a[~load] < 0) | (a[~load] >= num_regs)).any():
        raise ValueError("tape: source register out of range")
    rr = (op == OP_ADD) | (op == OP_MUL)
    if ((b[rr] < 0) | (b[rr] >= num_regs)).any():
        raise ValueError("tape: source register out of range")
    rs = (op == OP_ADDS) | (op == OP_MULS)
    if ((b[rs] < 0) | (b[rs] >= n_scalars)).any():
        raise ValueError("tape: scalar slot out of range")


def tape_eval_plain(code_np, scalars, tables_cat, field: str, num_regs: int,
                    domain: int):
    """Plain version of K4 (the reference's `_tape_eval_xla`): one
    full-domain limb op per instruction over the UNPADDED tables.
    code_np (T, 5) normalized code; scalars (S, 16) int32 Montgomery;
    tables_cat (TC, D, 16) int32. Returns register 0 as (D, 16) int32."""
    regs: list = [None] * num_regs
    t_lm = tables_cat.movedim(-1, -2)  # (TC, 16, D)
    sc = scalars
    for op, dst, a, b, _c in code_np:
        if op == OP_LOAD:
            regs[dst] = torch.roll(t_lm[a], -int(b), dims=1)
        elif op == OP_ADD:
            regs[dst] = FK._madd(regs[a], regs[b], field)
        elif op == OP_ADDS:
            regs[dst] = FK._madd(regs[a], sc[b][:, None], field)
        elif op == OP_MUL:
            regs[dst] = FK._mm_cios(regs[a], regs[b], field)
        elif op == OP_MULS:
            regs[dst] = FK._mm_cios(regs[a], sc[b][:, None], field)
        else:
            regs[dst] = FK._msub(torch.zeros_like(regs[a]), regs[a], field)
    return regs[0].movedim(0, 1).contiguous()


SMEM_BYTES = 232448  # shared memory a block may use on the H100
BLOCK_LANES = 64  # lanes (threads) of one K4 block


def file_bytes(num_regs: int, n_scalars: int) -> int:
    """Shared memory of one K4 block: its BLOCK_LANES lanes' register files
    (8 packed words a register) and the packed scalars."""
    return 4 * 8 * (num_regs * BLOCK_LANES + n_scalars)


def tape_eval_lm(code_np, scalars, tables_pad, field: str, num_regs: int,
                 domain: int):
    """K4 launch: code_np (T, 5) normalized code (host); scalars (S, 16)
    int32; tables_pad (TC, 16, D+LPAD+RPAD) int32 from pad_tables.
    Returns register 0 as (D, 16) int32. The register file is on chip,
    BLOCK_LANES lanes a block; a tape whose registers do not fit raises
    ValueError."""
    tc = tables_pad.shape[0]
    check = FK.check_lm
    if tables_pad.dtype != L.DTYPE or not tables_pad.is_contiguous() \
            or tables_pad.shape[1:] != (NLIMBS, domain + LPAD + RPAD):
        raise ValueError(f"tables_pad: bad layout {tuple(tables_pad.shape)} {tables_pad.dtype}")
    n_scalars = scalars.shape[0]
    check("scalars", scalars, n_scalars, NLIMBS)
    if file_bytes(num_regs, n_scalars) > SMEM_BYTES:
        raise ValueError(f"tape: {num_regs} registers do not fit in {SMEM_BYTES} bytes of "
                         f"shared memory at {BLOCK_LANES} lanes a block")
    if not FK.use_kernel(scalars, tables_pad):
        raise ValueError("tape_eval_lm launches the CUDA kernel: inputs must be on a CUDA device")
    code_np = np.ascontiguousarray(code_np, dtype=np.int32)
    _check_code(code_np, num_regs, tc, n_scalars)
    so = CK.lib("tape_eval")
    if code_np.shape[0] > so.taiga_tape_max_code():
        raise ValueError(f"tape: {code_np.shape[0]} instructions, more than the kernel's "
                         f"{so.taiga_tape_max_code()}")
    dev = tables_pad.device
    code = torch.as_tensor(code_np[:, :4].copy(), device=dev)
    out = torch.empty((domain, NLIMBS), dtype=L.DTYPE, device=dev)
    CK.check(so.taiga_tape_eval(code.data_ptr(), code_np.shape[0], scalars.data_ptr(), n_scalars,
                                tables_pad.data_ptr(), domain + LPAD + RPAD, num_regs,
                                out.data_ptr(), domain, CK.FIELD_IDS[field],
                                CK.stream_ptr(dev)), "tape_eval")
    tape_eval_lm.launches += 1
    return out


tape_eval_lm.launches = 0


def device_code(tape, offsets: dict[str, int], domain: int) -> tuple[np.ndarray, int]:
    """The tape as both evaluators run it: normalized for the flat table
    (column offsets by kind), its result renamed into register 0, and
    scheduled (schedule_tape). Returns (code, registers), read-only; kept on
    the tape per (offsets, domain), so a prover schedules each tape once."""
    cache = vars(tape).setdefault("_device_code", {})
    key = (tuple(sorted(offsets.items())), domain)
    if key in cache:
        return cache[key]
    code = normalize_code(np.asarray(tape.code), offsets, domain)
    if tape.out_reg != 0:  # rename registers 0 and out_reg
        swap = {0: tape.out_reg, tape.out_reg: 0}
        for row in code:
            if row[0] != OP_LOAD:
                row[2] = swap.get(int(row[2]), int(row[2]))
                row[3] = swap.get(int(row[3]), int(row[3])) \
                    if row[0] in (OP_ADD, OP_MUL) else row[3]
            row[1] = swap.get(int(row[1]), int(row[1]))
    code, num_regs = schedule_tape(code, max(tape.num_regs, 1))
    code.setflags(write=False)
    cache[key] = code, num_regs
    return cache[key]


def table_offsets(kind_stacks: dict) -> tuple[dict[str, int], list]:
    """The flat table's column offset of each kind present in kind_stacks
    (kind -> (C_kind, domain, 16)), in TABLE_KINDS order, and the stacks
    in that order."""
    from ..plonk.tape import TABLE_KINDS

    offsets, stacks, off = {}, [], 0
    for kind in TABLE_KINDS:
        arr = kind_stacks.get(kind)
        if arr is None or arr.shape[0] == 0:
            continue
        offsets[kind] = off
        stacks.append(arr)
        off += arr.shape[0]
    return offsets, stacks


def tape_eval_device(tape, kind_stacks: dict, scalar_values: list[int],
                     domain: int, field: str = "fp"):
    """Evaluate a compiled tape over a domain of `domain` lanes.

    tape: plonk.tape.Tape (rot_scale already baked into rotations);
    kind_stacks: kind -> (C_kind, domain, 16) int32 Montgomery tensors
    (missing kinds allowed when the tape never loads them);
    scalar_values: per-proof ints for tape.scalar_exprs.
    Returns (domain, 16) int32 Montgomery values of the out register.
    """
    offsets, stacks = table_offsets(kind_stacks)
    tables_cat = torch.cat(stacks, dim=0) if len(stacks) > 1 else stacks[0]
    code, num_regs = device_code(tape, offsets, domain)

    spec = L.FIELDS[field]
    sc = np.zeros((max(1, len(scalar_values)), NLIMBS), np.int32)
    for i, v in enumerate(scalar_values):
        sc[i] = L.int_to_limbs(v * spec.r % spec.modulus)
    scalars = torch.as_tensor(sc, device=tables_cat.device)
    if FK.use_kernel(tables_cat):
        return tape_eval_lm(code, scalars, pad_tables(tables_cat, domain), field,
                            num_regs, domain)
    return tape_eval_plain(code, scalars, tables_cat, field, num_regs, domain)
