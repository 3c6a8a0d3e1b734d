"""Device interpreter for compiled constraint tapes (plonk/tape.py).

Port of taiga_tpu/ops/tape_device.py. One kernel (K4, csrc/tape_eval.cu)
executes ANY circuit's tape: the instruction stream is data, so switching
circuits or domain sizes never rebuilds anything. The prover runs it for the
quotient numerator over the extended coset and, with `theta` as the Horner
variable, for the compressed lookup columns over the base domain.

Execution model: one thread per domain lane walks the whole tape over a
device-memory register file [R][16][D]; LOADs read a rotated window of the
padded limb-major table (left pad LPAD wrap rows, so any scaled rotation in
(-LPAD, RPAD) is an offset into one row). The plain version follows the
reference's `_tape_eval_xla`: one full-domain limb op per instruction.

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


def tape_eval_lm(code_np, scalars, tables_pad, field: str, num_regs: int,
                 domain: int):
    """K4 launch: code_np (T, 5) normalized code (host); scalars (S, 16)
    int32; tables_pad (TC, 16, D+LPAD+RPAD) int32 from pad_tables.
    Returns register 0 as (D, 16) int32."""
    tc = tables_pad.shape[0]
    check = FK.check_lm
    if tables_pad.dtype != L.DTYPE or not tables_pad.is_contiguous() \
            or tables_pad.shape[1:] != (NLIMBS, domain + LPAD + RPAD):
        raise ValueError(f"tables_pad: bad layout {tuple(tables_pad.shape)} {tables_pad.dtype}")
    check("scalars", scalars, scalars.shape[0], NLIMBS)
    if not FK.use_kernel(scalars, tables_pad):
        raise ValueError("tape_eval_lm launches the CUDA kernel: inputs must be on a CUDA device")
    code_np = np.ascontiguousarray(code_np, dtype=np.int32)
    _check_code(code_np, num_regs, tc, scalars.shape[0])
    dev = tables_pad.device
    code = torch.as_tensor(code_np, device=dev)
    regs = torch.empty((num_regs, NLIMBS, domain), dtype=L.DTYPE, device=dev)
    so = CK.lib("tape_eval")
    CK.check(so.taiga_tape_eval(code.data_ptr(), code_np.shape[0], scalars.data_ptr(),
                                tables_pad.data_ptr(), domain + LPAD + RPAD,
                                regs.data_ptr(), domain, CK.FIELD_IDS[field],
                                CK.stream_ptr(dev)), "tape_eval")
    tape_eval_lm.launches += 1
    return regs[0].movedim(0, 1).contiguous()


tape_eval_lm.launches = 0


def tape_eval_device(tape, kind_stacks: dict, scalar_values: list[int],
                     domain: int, field: str = "fp"):
    """Evaluate a compiled tape over a domain of `domain` lanes.

    tape: plonk.tape.Tape (rot_scale already baked into rotations);
    kind_stacks: kind -> (C_kind, domain, 16) int32 Montgomery tensors
    (missing kinds allowed when the tape never loads them);
    scalar_values: per-proof ints for tape.scalar_exprs.
    Returns (domain, 16) int32 Montgomery values of the out register.
    """
    from ..plonk.tape import TABLE_KINDS

    offsets = {}
    stacks = []
    off = 0
    for kind in TABLE_KINDS:
        arr = kind_stacks.get(kind)
        if arr is None or arr.shape[0] == 0:
            continue
        offsets[kind] = off
        stacks.append(arr)
        off += arr.shape[0]
    tables_cat = torch.cat(stacks, dim=0) if len(stacks) > 1 else stacks[0]
    code = normalize_code(np.asarray(tape.code), offsets, domain)

    # rename registers so the output lands in register 0
    if tape.out_reg != 0:
        swap = {0: tape.out_reg, tape.out_reg: 0}
        for row in code:
            if row[0] != OP_LOAD:
                row[2] = swap.get(int(row[2]), int(row[2]))
                row[3] = swap.get(int(row[3]), int(row[3])) \
                    if row[0] in (OP_ADD, OP_MUL) else row[3]
            row[1] = swap.get(int(row[1]), int(row[1]))

    spec = L.FIELDS[field]
    sc = np.zeros((max(1, len(scalar_values)), NLIMBS), np.int32)
    for i, v in enumerate(scalar_values):
        sc[i] = L.int_to_limbs(v * spec.r % spec.modulus)
    scalars = torch.as_tensor(sc, device=tables_cat.device)
    num_regs = max(tape.num_regs, 1)
    if FK.use_kernel(tables_cat):
        return tape_eval_lm(code, scalars, pad_tables(tables_cat, domain), field,
                            num_regs, domain)
    return tape_eval_plain(code, scalars, tables_cat, field, num_regs, domain)
