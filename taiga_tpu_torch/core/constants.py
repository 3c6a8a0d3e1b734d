"""Protocol constants, mirroring taiga_halo2/src/constant.rs.

Personalizations, tree depths, public-input layouts, circuit size, and the
Sinsemilla commit-domain generators (derived, not embedded — they are fixed
points produced by hash-to-curve and cached lazily).
"""

from __future__ import annotations

from functools import lru_cache

from ..crypto.curves import PallasPoint, pallas_hash_to_curve
from ..crypto.fields import Fp, to_field_elements

# --- personalizations (constant.rs:23-42) ----------------------------------
RESOURCE_COMMITMENT_PERSONALIZATION = "Taiga-NoteCommit"
TRANSACTION_BINDING_HASH_PERSONALIZATION = b"TxBindingSigHash"
RESOURCE_LOGIC_COMMITMENT_PERSONALIZATION = b"VPCommit"
PRF_EXPAND_PERSONALIZATION = b"Taiga_ExpandSeed"

PRF_EXPAND_PSI = 0
PRF_EXPAND_RCM = 1
PRF_EXPAND_PUBLIC_INPUT_PADDING = 2
PRF_EXPAND_VCM_R = 3
PRF_EXPAND_INPUT_RESOURCE_LOGIC_CM_R = 4
PRF_EXPAND_OUTPUT_RESOURCE_LOGIC_CM_R = 5
PRF_EXPAND_DYNAMIC_RESOURCE_LOGIC_1_CM_R = 6
PRF_EXPAND_DYNAMIC_RESOURCE_LOGIC_2_CM_R = 7


def prf_expand_personalization_to_field() -> Fp:
    return to_field_elements(PRF_EXPAND_PERSONALIZATION)[0]


# --- tree shapes (constant.rs:45-50) ----------------------------------------
TAIGA_COMMITMENT_TREE_DEPTH = 32
TAIGA_RESOURCE_TREE_DEPTH = 4
TAIGA_RESOURCE_TREE_LEAVES_NUM = 1 << TAIGA_RESOURCE_TREE_DEPTH

BASE_BITS_NUM = 255

# --- compliance circuit public input rows (constant.rs:54-62) ----------------
COMPLIANCE_NF_PUBLIC_INPUT_ROW_IDX = 0
COMPLIANCE_ANCHOR_PUBLIC_INPUT_ROW_IDX = 1
COMPLIANCE_OUTPUT_CM_PUBLIC_INPUT_ROW_IDX = 2
COMPLIANCE_DELTA_CM_X_PUBLIC_INPUT_ROW_IDX = 3
COMPLIANCE_DELTA_CM_Y_PUBLIC_INPUT_ROW_IDX = 4
COMPLIANCE_INPUT_RESOURCE_LOGIC_CM_1_ROW_IDX = 5
COMPLIANCE_INPUT_RESOURCE_LOGIC_CM_2_ROW_IDX = 6
COMPLIANCE_OUTPUT_RESOURCE_LOGIC_CM_1_ROW_IDX = 7
COMPLIANCE_OUTPUT_RESOURCE_LOGIC_CM_2_ROW_IDX = 8
COMPLIANCE_PUBLIC_INPUT_NUM = 9

# --- poseidon-to-curve (constant.rs:64-67, 102-121) --------------------------
POSEIDON_TO_CURVE_INPUT_LEN = 3
CURVE_ID = "pallas"
VALUE_BASE_DOMAIN_POSTFIX = "Taiga-NoteType"


def _poseidon_to_field_postfix(index: int) -> list[Fp]:
    postfix = f"{VALUE_BASE_DOMAIN_POSTFIX}-{CURVE_ID}-{index}".encode()
    postfix += bytes([4 + len(CURVE_ID) + len(VALUE_BASE_DOMAIN_POSTFIX)])
    return to_field_elements(postfix)


POSEIDON_TO_FIELD_U_0_POSTFIX = _poseidon_to_field_postfix(0)
POSEIDON_TO_FIELD_U_1_POSTFIX = _poseidon_to_field_postfix(1)

# --- resource logic public input layout (constant.rs:68-92) ------------------
RESOURCE_LOGIC_CIRCUIT_MANDATORY_PUBLIC_INPUT_NUM = 6
RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_NUM = 2
RESOURCE_ENCRYPTION_PLAINTEXT_NUM = 10
RESOURCE_ENCRYPTION_CIPHERTEXT_NUM = RESOURCE_ENCRYPTION_PLAINTEXT_NUM + 2
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PUBLIC_INPUT_NUM = (
    RESOURCE_ENCRYPTION_CIPHERTEXT_NUM + 2
)
RESOURCE_LOGIC_CIRCUIT_PUBLIC_INPUT_NUM = (
    RESOURCE_LOGIC_CIRCUIT_MANDATORY_PUBLIC_INPUT_NUM
    + RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_NUM
    + RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PUBLIC_INPUT_NUM
)  # = 22

RESOURCE_LOGIC_CIRCUIT_RESOURCE_MERKLE_ROOT_IDX = 0
RESOURCE_LOGIC_CIRCUIT_SELF_RESOURCE_ID_IDX = 1
RESOURCE_LOGIC_CIRCUIT_FIRST_DYNAMIC_RESOURCE_LOGIC_CM_1 = 2
RESOURCE_LOGIC_CIRCUIT_FIRST_DYNAMIC_RESOURCE_LOGIC_CM_2 = 3
RESOURCE_LOGIC_CIRCUIT_SECOND_DYNAMIC_RESOURCE_LOGIC_CM_1 = 4
RESOURCE_LOGIC_CIRCUIT_SECOND_DYNAMIC_RESOURCE_LOGIC_CM_2 = 5
RESOURCE_LOGIC_CIRCUIT_CUSTOM_PUBLIC_INPUT_BEGIN_IDX = 6
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PUBLIC_INPUT_BEGIN_IDX = 8
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_NONCE_IDX = 18
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_MAC_IDX = 19
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PK_X_IDX = 20
RESOURCE_LOGIC_CIRCUIT_RESOURCE_ENCRYPTION_PK_Y_IDX = 21

# --- poseidon shape (constant.rs:99-100) -------------------------------------
POSEIDON_RATE = 2
POSEIDON_WIDTH = 3

# --- circuit size -------------------------------------------------------------
# The reference runs both circuits at k = 15 (constant.rs:123-125) because its
# bit-oriented gadgets need ~25k rows. This build's lookup/packed gadgets
# (spread-table Blake2s, 4-rounds-per-row Poseidon, fused EC conditional adds)
# prove the SAME statements in ~6.2k rows (compliance) / <2.4k rows (every
# resource logic), so the production domains are k = 13 and k = 12 — a 4-8x
# smaller NTT/MSM/quotient per proof.
PARAMS_SIZE = 13
COMPLIANCE_CIRCUIT_PARAMS_SIZE = 13
RESOURCE_LOGIC_CIRCUIT_PARAMS_SIZE = 12

MAX_DYNAMIC_RESOURCE_LOGIC_NUM = 2

# --- Sinsemilla commit-domain generators (constant.rs:156-181) ---------------
_Q_PERSONALIZATION = "z.cash:SinsemillaQ"
_R_PERSONALIZATION = "z.cash:SinsemillaR"


@lru_cache(maxsize=None)
def resource_commitment_generator() -> PallasPoint:
    """CommitDomain("Taiga-NoteCommit").Q()."""
    return pallas_hash_to_curve(
        _Q_PERSONALIZATION, f"{RESOURCE_COMMITMENT_PERSONALIZATION}-M".encode()
    )


# CommitDomain("Taiga-NoteCommit").R() — the delta-commitment blinding base
# and the RedDSA binding-signature basepoint (binding_signature.rs:23-33,
# delta_commitment.rs:20-32). BIT-EXACT vs the reference: recovered from the
# reference's embedded fixed-base window table (constant.rs:183-3085 R_U/R_Z,
# generated by halo2_gadgets find_zs_and_us from this exact point) by solving
# y([2]R) = R_U[0][0]^2 - R_Z[0] and R = [2^-1 mod q]([2]R), then verified
# against all eight window-0 table equations — see tools/recover_r_generator.py
# and tests/test_reference_vectors.py. Our own group-hash derivation of
# "Taiga-NoteCommit-r" differs from pasta_curves' BLAKE2b XMD at byte level,
# so the protocol constant is pinned rather than derived.
_R_GENERATOR_X = 0x041959EB3111584D60946E45BF5126F4F58304C956778E9F6D8AAE9FE21CFE00
_R_GENERATOR_Y = 0x1319B788FE5FEC163EBB783B59D92092B8B4F7C83326A3808C0B30657333C5E1


@lru_cache(maxsize=None)
def resource_commitment_r_generator() -> PallasPoint:
    return PallasPoint.from_xy(_R_GENERATOR_X, _R_GENERATOR_Y)
