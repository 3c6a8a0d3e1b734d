"""The compliance (Action) circuit — the fixed protocol circuit.

Statement (9 public inputs, rows per core/constants.py, mirroring
taiga_halo2/src/circuit/compliance_circuit.rs):
  row 0: nf           nullifier of the consumed input resource
  row 1: anchor       Merkle root the input resource is a member of
                      (only enforced when the input is not ephemeral)
  row 2: cm           commitment of the created output resource
  row 3: delta_x      homomorphic delta commitment x
  row 4: delta_y      homomorphic delta commitment y
  rows 5-8: input/output resource-logic commitments (2 x 128-bit halves each)

In-circuit relations (see gadget docstrings for layouts):
  * input integrity  (integrity.rs:51-190): npk = Poseidon(nk, 0); psi/rcm
    PRF-derived; cm_in = Poseidon-8; u64 quantity range check; nf derived;
  * depth-32 Poseidon Merkle membership + the ephemeral-gated anchor equality
    (compliance_circuit.rs:126-140, 261-278);
  * output integrity (integrity.rs:193-325): nonce_out = nf; psi/rcm derived
    in-circuit; cm_out = Poseidon-8;
  * delta commitment (integrity.rs:546-630): [q_in]K_in - [q_out]K_out +
    [rcv]R via in-circuit EC scalar muls, with the kind points derived
    fully in-circuit (Poseidon-to-field + SWU + 3-isogeny,
    circuits/hash_to_curve.py);
  * resource-logic commitments recomputed in-circuit with the Blake2s gadget
    (circuits/blake2s.py; compliance_circuit.rs:281-324).
"""

from __future__ import annotations

import secrets

from ..core.constants import (
    PRF_EXPAND_PSI,
    PRF_EXPAND_RCM,
    TAIGA_COMMITMENT_TREE_DEPTH,
    prf_expand_personalization_to_field,
    resource_commitment_r_generator,
)
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq
from ..plonk.circuit import Circuit, CircuitBuilder, ConstraintSystem
from . import gadgets as G
from .ec_gadgets import (
    PointCells as _PointCells,
    blind_base as _blind_base,
    ec_add_gadget,
    ec_scalar_mul_gadget,
    witness_point,
)

P = Fp.MODULUS


class ComplianceCircuit(Circuit):
    NUM_FIXED = G.NUM_FIXED
    NUM_ADVICE = G.NUM_ADVICE
    NUM_INSTANCE = 1

    def __init__(self, compliance_info=None):
        """compliance_info: core.compliance.ComplianceInfo or None (keygen)."""
        self.info = compliance_info

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        G.configure_standard(cs)
        return None

    # -- witness helpers ----------------------------------------------
    def _w(self, f):
        """Witness accessor: returns None in keygen mode."""
        if self.info is None:
            return None
        return f(self.info)

    def synthesize(self, b: CircuitBuilder, config):
        info = self.info
        w = lambda v: None if info is None else v

        inp = None if info is None else info.input_resource
        out = None if info is None else info.output_resource

        pers = prf_expand_personalization_to_field().v
        pers_c = G.constant_cell(b, pers)
        zero = G.constant_cell(b, 0)
        one = G.constant_cell(b, 1)

        # --- input resource integrity --------------------------------
        nk = G.witness_cell(b, w(inp.get_nk().v if info else None))
        logic_in = G.witness_cell(b, w(inp.get_logic().v if info else None))
        label_in = G.witness_cell(b, w(inp.get_label().v if info else None))
        value_in = G.witness_cell(b, w(inp.value.v if info else None))
        quantity_in = G.witness_cell(b, w(inp.quantity if info else None))
        nonce_in = G.witness_cell(b, w(inp.nonce.inner().v if info else None))
        eph_in = G.witness_cell(b, w((1 if inp.is_ephemeral else 0) if info else None))
        rseed_in = G.witness_cell(b, w(inp.rseed.v if info else None))
        G.is_bool(b, eph_in)
        # u64 range check; the bits are reused by the delta scalar mul below
        q_in_bits = G.decompose_bits(b, quantity_in, 64)

        npk_in = G.poseidon_hash2_gadget(b, nk, zero)
        psi_in = G.poseidon_hash_n_gadget(
            b, [pers_c, G.constant_cell(b, PRF_EXPAND_PSI), rseed_in, nonce_in]
        )
        rcm_in = G.poseidon_hash_n_gadget(
            b, [pers_c, G.constant_cell(b, PRF_EXPAND_RCM), rseed_in, nonce_in]
        )
        e_in = G.add_scaled(b, quantity_in, eph_in, 1 << 128)
        cm_in = G.poseidon_hash_n_gadget(
            b, [logic_in, label_in, value_in, npk_in, nonce_in, psi_in, e_in, rcm_in]
        )
        nf = G.poseidon_hash_n_gadget(b, [nk, nonce_in, psi_in, cm_in])
        b.constrain_instance(nf, 0)

        # --- merkle membership + gated anchor check ------------------
        path_cells = []
        for d in range(TAIGA_COMMITMENT_TREE_DEPTH):
            if info is None:
                sib, lr = None, None
            else:
                node, lrv = info.input_merkle_path.path[d]
                sib = node.inner().v
                lr = 1 if lrv.is_left() else 0
            sc = G.witness_cell(b, sib)
            lc = G.witness_cell(b, lr)
            G.is_bool(b, lc)
            path_cells.append((sc, lc))
        root = G.merkle_root_gadget(b, cm_in, path_cells)
        anchor = G.witness_cell(b, w(info.input_anchor.inner().v if info else None))
        not_eph = G.sub_cells(b, one, eph_in)
        diff = G.sub_cells(b, root, anchor)
        gated = G.mul_cells(b, not_eph, diff)
        G.assert_equal_constant(b, gated, 0)
        b.constrain_instance(anchor, 1)

        # --- output resource integrity -------------------------------
        logic_out = G.witness_cell(b, w(out.get_logic().v if info else None))
        label_out = G.witness_cell(b, w(out.get_label().v if info else None))
        value_out = G.witness_cell(b, w(out.value.v if info else None))
        quantity_out = G.witness_cell(b, w(out.quantity if info else None))
        npk_out = G.witness_cell(b, w(out.get_npk().v if info else None))
        eph_out = G.witness_cell(b, w((1 if out.is_ephemeral else 0) if info else None))
        rseed_out = G.witness_cell(b, w(out.rseed.v if info else None))
        G.is_bool(b, eph_out)
        q_out_bits = G.decompose_bits(b, quantity_out, 64)
        # output nonce = input nullifier (compliance.rs:128-153)
        nonce_out = nf
        psi_out = G.poseidon_hash_n_gadget(
            b, [pers_c, G.constant_cell(b, PRF_EXPAND_PSI), rseed_out, nonce_out]
        )
        rcm_out = G.poseidon_hash_n_gadget(
            b, [pers_c, G.constant_cell(b, PRF_EXPAND_RCM), rseed_out, nonce_out]
        )
        e_out = G.add_scaled(b, quantity_out, eph_out, 1 << 128)
        cm_out = G.poseidon_hash_n_gadget(
            b,
            [logic_out, label_out, value_out, npk_out, nonce_out, psi_out, e_out, rcm_out],
        )
        b.constrain_instance(cm_out, 2)

        # --- delta commitment ----------------------------------------
        # kind points derived fully in-circuit: Poseidon-to-field, SWU onto
        # the iso curve, 3-isogeny map (circuits/hash_to_curve.py; reference
        # integrity.rs:514-543)
        from .hash_to_curve import derive_kind_gadget

        kin = derive_kind_gadget(b, logic_in, label_in, one)
        kout = derive_kind_gadget(b, logic_out, label_out, one)
        rcv_val = None if info is None else info.get_rcv().v
        rcv = G.witness_cell(b, rcv_val)
        # rcv is a Pallas scalar sampled < p by construction (RandomSeed.
        # get_rcv), so its canonical (< p) 255-bit decomposition IS the
        # scalar's integer — two distinct decompositions of the same cell
        # (v and v+p) are ruled out by decompose_canonical_255, closing the
        # delta-malleability of a non-canonical split.
        from .ec_gadgets import decompose_canonical_255

        rcv_bits = decompose_canonical_255(b, rcv)

        # delta = [q_in]K_in - [q_out]K_out + [rcv]R in ONE blinded
        # simultaneous double-and-add — robust to the balanced case where
        # [q]K_in and [q]K_out cancel exactly (incomplete adds never see
        # P + (-P); see ec_multi_scalar_mul_gadget)
        from .ec_gadgets import ec_multi_scalar_mul_gadget, ec_neg_point

        r_gen = resource_commitment_r_generator()
        r_cells = _PointCells(
            G.constant_cell(b, r_gen.x.v), G.constant_cell(b, r_gen.y.v)
        )
        delta = ec_multi_scalar_mul_gadget(
            b,
            [
                (kin, q_in_bits),
                (ec_neg_point(b, kout), q_out_bits),
                (r_cells, rcv_bits),
            ],
            _blind_base(),
        )
        b.constrain_instance(delta.x, 3)
        b.constrain_instance(delta.y, 4)

        # --- resource-logic commitments (in-circuit Blake2s,
        #     compliance_circuit.rs:281-324) -------------------------
        from .blake2s import resource_logic_commitment_gadget

        in_cm_r = G.witness_cell(
            b, w(info.get_input_resource_logic_com_r().v if info else None)
        )
        out_cm_r = G.witness_cell(
            b, w(info.get_output_resource_logic_com_r().v if info else None)
        )
        in_lo, in_hi = resource_logic_commitment_gadget(b, logic_in, in_cm_r, one)
        out_lo, out_hi = resource_logic_commitment_gadget(b, logic_out, out_cm_r, one)
        b.constrain_instance(in_lo, 5)
        b.constrain_instance(in_hi, 6)
        b.constrain_instance(out_lo, 7)
        b.constrain_instance(out_hi, 8)
