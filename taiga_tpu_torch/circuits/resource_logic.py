"""Resource-logic (validity predicate) circuit framework.

Mirrors taiga_halo2/src/circuit/resource_logic_circuit.rs:
a resource logic proves, for ONE "self" resource inside a partial
transaction, that (a) the resource is a member of the ptx's depth-4 resource
tree (public input 0 = the tree root), (b) the publicized self-resource id is
its nullifier (input) or commitment (output) (public input 1), and (c) any
application-specific custom constraints hold. 22 public inputs (layout in
core/constants.py): [root, self_id, 2x dynamic RL cm pairs, 2 custom, 14
encryption].

`basic_constraints` is the shared part (reference :421-475, built on the
`load_resource` gadget of integrity.rs:328-512); subclasses override
`custom_constraints` and `get_public_inputs`.
"""

from __future__ import annotations

import secrets

from ..core.constants import (
    PRF_EXPAND_PSI,
    PRF_EXPAND_PSI as _PSI,
    PRF_EXPAND_RCM,
    RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_BEGIN_IDX,
    RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM,
    TAIGA_RESOURCE_TREE_DEPTH,
    prf_expand_personalization_to_field,
)
from ..core.resource import RandomSeed, Resource
from ..core.resource_tree import ResourceExistenceWitness
from ..crypto.fields import Fp
from ..plonk.circuit import Circuit, CircuitBuilder, ConstraintSystem
from . import gadgets as G

P = Fp.MODULUS


class ResourceStatus:
    """Assigned cells for the loaded self resource (reference :507-533)."""

    def __init__(self, **cells):
        self.__dict__.update(cells)


def load_resource_gadget(b: CircuitBuilder, w: "ResourceExistenceWitness | None") -> "ResourceStatus":
    """Load a resource + its depth-4 membership into the circuit (the
    reference's `load_resource`, integrity.rs:328-512): witnesses all fields,
    derives npk conditionally from the nk container, recomputes psi/rcm/cm/nf,
    selects identity = is_input ? nf : cm and folds the resource-tree root.
    Used for the self resource and, by intents, for extra resources."""
    info = w is not None
    res: Resource | None = w.get_resource() if info else None

    pers_c = G.constant_cell(b, prf_expand_personalization_to_field().v)
    zero = G.constant_cell(b, 0)

    def wit(v):
        return G.witness_cell(b, v if info else None)

    logic = wit(res.get_logic().v if info else None)
    label = wit(res.get_label().v if info else None)
    value = wit(res.value.v if info else None)
    quantity = wit(res.quantity if info else None)
    nonce = wit(res.nonce.inner().v if info else None)
    eph = wit((1 if res.is_ephemeral else 0) if info else None)
    rseed = wit(res.rseed.v if info else None)
    G.is_bool(b, eph)

    # conditional npk (integrity.rs load_resource): the container holds
    # either the key (npk = Poseidon(nk, 0)) or the commitment directly.
    is_key_v = None if not info else (1 if res.nk_container.is_key() else 0)
    is_key = wit(is_key_v)
    G.is_bool(b, is_key)
    nk_raw = wit(res.nk_container.raw_inner().v if info else None)
    npk_hashed = G.poseidon_hash2_gadget(b, nk_raw, zero)
    npk = G.select_cell(b, is_key, npk_hashed, nk_raw)

    psi = G.poseidon_hash_n_gadget(
        b, [pers_c, G.constant_cell(b, PRF_EXPAND_PSI), rseed, nonce]
    )
    rcm = G.poseidon_hash_n_gadget(
        b, [pers_c, G.constant_cell(b, PRF_EXPAND_RCM), rseed, nonce]
    )
    e = G.add_scaled(b, quantity, eph, 1 << 128)
    cm = G.poseidon_hash_n_gadget(
        b, [logic, label, value, npk, nonce, psi, e, rcm]
    )
    nf = G.poseidon_hash_n_gadget(b, [nk_raw, nonce, psi, cm])

    # identity = is_input ? nf : cm; is_input = first path step has the
    # sibling on the right (LSB of the leaf position is 0)
    path_cells = []
    lr_bits = []
    for d in range(TAIGA_RESOURCE_TREE_DEPTH):
        if info:
            sib, lrv = w.get_path()[d]
            sv = sib.v
            lv = 1 if lrv.is_left() else 0
        else:
            sv = lv = None
        sc = G.witness_cell(b, sv)
        lc = G.witness_cell(b, lv)
        G.is_bool(b, lc)
        path_cells.append((sc, lc))
        lr_bits.append(lc)
    one = G.constant_cell(b, 1)
    is_input = G.sub_cells(b, one, lr_bits[0])  # L(=1) at step 0 => output
    identity = G.select_cell(b, is_input, nf, cm)
    root = G.merkle_root_gadget(b, identity, path_cells)

    return ResourceStatus(
        logic=logic,
        label=label,
        value=value,
        quantity=quantity,
        nonce=nonce,
        is_ephemeral=eph,
        rseed=rseed,
        npk=npk,
        nk_raw=nk_raw,
        is_input=is_input,
        cm=cm,
        nf=nf,
        identity=identity,
        root=root,
    )


class ResourceLogicCircuit(Circuit):
    """Base class. Subclasses set NUM_* if they need more columns, override
    `custom_constraints(builder, basic)` and `custom_public_inputs()`."""

    NUM_FIXED = G.NUM_FIXED
    NUM_ADVICE = G.NUM_ADVICE
    NUM_INSTANCE = 1

    def __init__(self, self_resource: ResourceExistenceWitness | None = None):
        self.self_resource = self_resource
        # 16 padding values for public inputs 6..21 (overridden by apps that
        # constrain custom/encryption outputs); deterministic per instance.
        self._padding_seed = RandomSeed.random()

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        G.configure_standard(cs)
        return None

    # --- public input assembly (host side) ----------------------------
    def get_public_inputs(self) -> list[Fp]:
        # cached: padding is random per instance but must be identical between
        # the instance list and the publicized witness cells
        cached = getattr(self, "_cached_public_inputs", None)
        if cached is not None:
            return cached
        w = self.self_resource
        root = Fp(w.get_root().v)
        self_id = Fp(w.get_identity().v)
        dyn = self.dynamic_rl_commitments()
        rest = self.custom_public_inputs()
        out = [root, self_id] + dyn + rest
        assert len(out) == RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM
        self._cached_public_inputs = out
        return out

    def dynamic_rl_commitments(self) -> list[Fp]:
        """Public inputs 2..5: two dynamic RL commitment pairs; default = the
        zero commitment, constrained as constants in-circuit (reference
        blake2s.rs:37-78 publicize_default_dynamic_resource_logic_commitments)."""
        from ..core.rl_commitment import ResourceLogicCommitment

        d = ResourceLogicCommitment.default().to_public_inputs()
        return d + d

    def custom_public_inputs(self) -> list[Fp]:
        """Public inputs 6..21; default = random padding."""
        return self._padding_seed.get_random_padding(16)

    # --- synthesis ----------------------------------------------------
    def synthesize(self, b: CircuitBuilder, config):
        basic = self.basic_constraints(b)
        self.custom_constraints(b, basic)
        self.publicize_remaining(b, basic)

    def basic_constraints(self, b: CircuitBuilder) -> ResourceStatus:
        status = load_resource_gadget(b, self.self_resource)
        b.constrain_instance(status.root, 0)
        b.constrain_instance(status.identity, 1)
        return status

    def custom_constraints(self, b: CircuitBuilder, basic: ResourceStatus):
        """Default: no extra constraints (trivial logic)."""

    def publicize_remaining(self, b: CircuitBuilder, basic: ResourceStatus):
        """Expose public inputs 2..21 as witnessed cells. Subclasses that
        *constrain* specific indices should override `constrained_indices`
        and bind their own cells instead."""
        from ..core.rl_commitment import ResourceLogicCommitment

        vals = None
        if self.self_resource is not None:
            vals = self.get_public_inputs()
        bound = self.bound_public_cells(b, basic)
        default_cm = ResourceLogicCommitment.default().to_public_inputs()
        for idx in range(2, RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM):
            if idx in bound:
                b.constrain_instance(bound[idx], idx)
            elif idx < 6:
                # unbound dynamic RL commitment slots are CONSTRAINED to the
                # default commitment (not free witnesses)
                cell = G.constant_cell(b, default_cm[(idx - 2) % 2].v)
                b.constrain_instance(cell, idx)
            else:
                cell = G.witness_cell(b, vals[idx].v if vals else None)
                b.constrain_instance(cell, idx)

    def bound_public_cells(self, b: CircuitBuilder, basic: ResourceStatus) -> dict:
        """Map public-input index -> cell for app-constrained outputs."""
        return {}

    # --- host-side logic hash (the 'logic' field of resources) --------
    @classmethod
    def compressed_vk(cls) -> Fp:
        """The REAL Blake2b-compressed verifying key (reference
        resource_logic_vk.rs:33-51): keygen (cached per class/k, in memory
        and on disk) then compress the canonical vk serialization — so a
        resource's `logic` field commits to the circuit's actual constraints
        (gates, lookups, fixed/permutation commitments), and changing one
        gate changes every resource of this kind."""
        from ..core.proving import get_proving_key, resource_logic_k

        return get_proving_key(cls, resource_logic_k()).vk.compressed()

    @classmethod
    def verifying_key_bytes(cls) -> bytes:
        from ..core.proving import get_proving_key, resource_logic_k

        return get_proving_key(cls, resource_logic_k()).vk.to_bytes()

    @classmethod
    def circuit_id(cls) -> str:
        return f"taiga_tpu.rl.{cls.__name__}"
