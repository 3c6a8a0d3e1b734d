"""The three reference end-to-end transaction flows.

Port of taiga_tpu/examples/tx_examples.py. Each flow builds real partial
transactions and executes the resulting Transaction. `mode="shielded"`
drives the full prover (a lockstep batch of the compliance proofs, then the
resource-logic proofs); `mode="transparent"` drives the constraint-evaluator
path (MockProver-equivalent) through the same application bytecodes — the
same circuits, without proof creation. Every proof and mock check runs on
`device` ("cuda" unless the caller passes "cpu"), and every proof draws its
blinds from the one `randbits` (default secrets.randbits), in the reference's
order, so a seeded rng and a seeded randbits give the same proofs.

Reference: taiga_halo2/examples/tx_examples/
  token.rs:16-90 (create_token_swap_ptx)
  token_swap_without_intent.rs:17-74
  token_swap_with_intent.rs:27-258
  partial_fulfillment_token_swap.rs
"""

from __future__ import annotations

import secrets

from ..apps.or_relation_intent import (
    OrRelationIntentResourceLogicCircuit,
    create_intent_resource,
)
from ..apps.partial_fulfillment_intent import (
    PartialFulfillmentIntentResourceLogicCircuit,
    Swap,
)
from ..apps.token import Token, TokenAuthorization
from ..core.compliance import ComplianceInfo
from ..core.constants import TAIGA_COMMITMENT_TREE_DEPTH
from ..core.merkle import Anchor, MerklePath
from ..core.nullifier import NullifierKeyContainer
from ..core.ptx import ShieldedPartialTransaction, TransparentPartialTransaction
from ..core.resource_logics import ResourceLogics
from ..core.resource_tree import ResourceExistenceWitness, ResourceMerkleTreeLeaves
from ..core.transaction import (
    ShieldedPartialTxBundle,
    Transaction,
    TransparentPartialTxBundle,
)
from ..crypto.curves import PallasPoint
from ..crypto.fields import Fp, Fq
from ..ops.limbs import resolve_device


def _build_ptx(mode, compliances, input_logics, output_logics, device, randbits):
    if mode == "shielded":
        return ShieldedPartialTransaction.build(compliances, input_logics, output_logics,
                                                device=device, randbits=randbits)
    return TransparentPartialTransaction(
        compliances,
        [l.to_application_bytecode() for l in input_logics],
        [l.to_application_bytecode() for l in output_logics],
        device=device,
    )


def _bundle(mode, ptxs) -> Transaction:
    if mode == "shielded":
        return Transaction.build(ShieldedPartialTxBundle(ptxs), TransparentPartialTxBundle())
    return Transaction.build(ShieldedPartialTxBundle(), TransparentPartialTxBundle(ptxs))


# ---------------------------------------------------------------------------
# flow 1: 3-party cyclic swap (token_swap_without_intent.rs)
# ---------------------------------------------------------------------------


def create_token_swap_ptx(
    rng,
    input_token: Token,
    input_auth_sk: Fq,
    input_nk: Fp,
    output_token: Token,
    output_auth_pk: PallasPoint,
    output_npk: Fp,
    mode: str = "transparent",
    *,
    device="cuda",
    randbits=secrets.randbits,
):
    """One party's 1-in/1-out swap leg (examples/tx_examples/token.rs:16-90)."""
    input_auth = TokenAuthorization(PallasPoint.generator() * input_auth_sk.v)
    input_resource = input_token.create_random_input_token_resource(rng, input_nk, input_auth)
    output_auth = TokenAuthorization(output_auth_pk)
    output_resource = output_token.create_random_output_token_resource(
        rng, output_npk, output_auth
    )

    merkle_path = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    compliance = ComplianceInfo(
        input_resource.resource, merkle_path, None, output_resource.resource
    )

    nf = input_resource.resource.get_nf().inner()
    cm = output_resource.resource.commitment().inner()
    tree = ResourceMerkleTreeLeaves([nf, cm])

    input_logics = input_resource.generate_input_token_resource_logics(
        rng, input_auth, input_auth_sk, tree.generate_path(nf)
    )
    output_logics = output_resource.generate_output_token_resource_logics(
        rng, output_auth, tree.generate_path(cm)
    )
    return _build_ptx(mode, [compliance], [input_logics], [output_logics], device, randbits)


def create_token_swap_transaction(rng, mode: str = "transparent", *, device="cuda",
                                  randbits=secrets.randbits) -> Transaction:
    """Alice 5 BTC -> 10 ETH, Bob 10 ETH -> 15 XAN, Carol 15 XAN -> 5 BTC."""
    resolve_device(device)
    g = PallasPoint.generator()
    btc, eth, xan = Token("btc", 5), Token("eth", 10), Token("xan", 15)

    ptxs = []
    parties = [(btc, eth), (eth, xan), (xan, btc)]
    for sell, buy in parties:
        auth_sk = Fq.random(rng)
        auth_pk = g * auth_sk.v
        nk = NullifierKeyContainer.random_key(rng)
        ptxs.append(
            create_token_swap_ptx(
                rng, sell, auth_sk, nk.get_nk(), buy, auth_pk, nk.get_npk(), mode,
                device=device, randbits=randbits,
            )
        )
    return _bundle(mode, ptxs)


# ---------------------------------------------------------------------------
# flow 2: intent-matched swap (token_swap_with_intent.rs)
# ---------------------------------------------------------------------------


def create_token_intent_ptx(
    rng, token_1: Token, token_2: Token, input_token: Token,
    input_auth_sk: Fq, input_nk: Fp, mode: str = "transparent",
    *, device="cuda", randbits=secrets.randbits,
):
    """Alice: consume the BTC input, create the or-relation intent
    (token_swap_with_intent.rs:27-120)."""
    input_auth = TokenAuthorization(PallasPoint.generator() * input_auth_sk.v)
    input_resource = input_token.create_random_input_token_resource(rng, input_nk, input_auth)
    receiver_npk = input_resource.get_npk()
    receiver_value = input_resource.resource.value
    intent = create_intent_resource(
        rng, token_1, token_2, receiver_npk, receiver_value, input_nk
    )

    merkle_path = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    compliance = ComplianceInfo(input_resource.resource, merkle_path, None, intent)

    nf = input_resource.resource.get_nf().inner()
    cm = intent.commitment().inner()
    tree = ResourceMerkleTreeLeaves([nf, cm])

    input_logics = input_resource.generate_input_token_resource_logics(
        rng, input_auth, input_auth_sk, tree.generate_path(nf)
    )
    intent_witness = ResourceExistenceWitness(intent, tree.generate_path(cm))
    output_logics = ResourceLogics(
        OrRelationIntentResourceLogicCircuit(
            intent_witness,
            intent_witness,  # the desired resource is unchecked on creation
            token_1, token_2, receiver_npk, receiver_value,
        )
    )
    ptx = _build_ptx(mode, [compliance], [input_logics], [output_logics], device, randbits)
    return ptx, input_nk, receiver_npk, receiver_value


def consume_token_intent_ptx(
    rng, token_1: Token, token_2: Token, input_nk: Fp,
    receiver_npk: Fp, receiver_value: Fp,
    output_token: Token, output_auth_pk: PallasPoint, mode: str = "transparent",
    *, device="cuda", randbits=secrets.randbits,
):
    """Solver: consume the intent, create the desired output
    (token_swap_with_intent.rs:122-208)."""
    intent = create_intent_resource(
        rng, token_1, token_2, receiver_npk, receiver_value, input_nk
    )
    output_auth = TokenAuthorization(output_auth_pk)
    output_npk = NullifierKeyContainer.from_key(input_nk).get_npk()
    output_resource = output_token.create_random_output_token_resource(
        rng, output_npk, output_auth
    )

    merkle_path = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    anchor = Anchor(Fp.random(rng))  # the intent is ephemeral: anchor unchecked
    compliance = ComplianceInfo(intent, merkle_path, anchor, output_resource.resource)

    nf = intent.get_nf().inner()
    cm = output_resource.resource.commitment().inner()
    tree = ResourceMerkleTreeLeaves([nf, cm])

    intent_logics = ResourceLogics(
        OrRelationIntentResourceLogicCircuit(
            ResourceExistenceWitness(intent, tree.generate_path(nf)),
            ResourceExistenceWitness(output_resource.resource, tree.generate_path(cm)),
            token_1, token_2, receiver_npk, receiver_value,
        )
    )
    output_logics = output_resource.generate_output_token_resource_logics(
        rng, output_auth, tree.generate_path(cm)
    )
    return _build_ptx(mode, [compliance], [intent_logics], [output_logics], device, randbits)


def create_token_swap_intent_transaction(rng, mode: str = "transparent", *, device="cuda",
                                         randbits=secrets.randbits) -> Transaction:
    """Alice wants 1 DOLPHIN or 2 MONKEY for 5 BTC; Bob fills with 1 DOLPHIN."""
    resolve_device(device)
    kw = dict(device=device, randbits=randbits)
    g = PallasPoint.generator()
    dolphin, monkey, btc = Token("dolphin", 1), Token("monkey", 2), Token("btc", 5)

    alice_auth_sk = Fq.random(rng)
    alice_auth_pk = g * alice_auth_sk.v
    alice_nk = Fp.random(rng)
    alice_ptx, intent_nk, receiver_npk, receiver_value = create_token_intent_ptx(
        rng, dolphin, monkey, btc, alice_auth_sk, alice_nk, mode, **kw
    )

    bob_auth_sk = Fq.random(rng)
    bob_auth_pk = g * bob_auth_sk.v
    bob_nk = NullifierKeyContainer.random_key(rng)
    bob_ptx = create_token_swap_ptx(
        rng, dolphin, bob_auth_sk, bob_nk.get_nk(), btc, bob_auth_pk,
        bob_nk.get_npk(), mode, **kw,
    )

    solver_ptx = consume_token_intent_ptx(
        rng, dolphin, monkey, intent_nk, receiver_npk, receiver_value,
        dolphin, alice_auth_pk, mode, **kw,
    )
    return _bundle(mode, [alice_ptx, bob_ptx, solver_ptx])


# ---------------------------------------------------------------------------
# flow 3: partial fulfillment (partial_fulfillment_token_swap.rs)
# ---------------------------------------------------------------------------


def create_partial_fulfillment_intent_ptx(rng, swap: Swap, input_auth_sk: Fq, mode, *,
                                          device="cuda", randbits=secrets.randbits):
    """Alice: consume sell resource, create the limit-order intent. Returns
    (ptx, intent_resource) — the SAME intent resource is later consumed."""
    intent = swap.create_intent_resource(rng)

    merkle_path = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    compliance = ComplianceInfo(swap.sell.resource, merkle_path, None, intent)

    nf = swap.sell.resource.get_nf().inner()
    cm = intent.commitment().inner()
    tree = ResourceMerkleTreeLeaves([nf, cm])

    input_logics = swap.sell.generate_input_token_resource_logics(
        rng, swap.auth, input_auth_sk, tree.generate_path(nf)
    )
    dummy = ResourceExistenceWitness.default()
    output_logics = ResourceLogics(
        PartialFulfillmentIntentResourceLogicCircuit(
            ResourceExistenceWitness(intent, tree.generate_path(cm)),
            ResourceExistenceWitness(swap.sell.resource, tree.generate_path(nf)),
            dummy, dummy, swap,
        )
    )
    return (_build_ptx(mode, [compliance], [input_logics], [output_logics], device, randbits),
            intent)


def consume_partial_fulfillment_intent_ptx(rng, swap: Swap, intent, offer: Token, mode, *,
                                           device="cuda", randbits=secrets.randbits):
    """Solver: consume the intent; create offer + returned resources
    (2 compliance units — the intent consumption pairs with the offer, an
    ephemeral padding input pairs with the returned change)."""
    from ..core.resource import Resource

    offer_resource, returned_resource = swap.fill(rng, offer)

    padding_input = Resource.random_padding_resource(rng)

    merkle_path = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    anchor = Anchor(Fp.random(rng))
    compliance_1 = ComplianceInfo(intent, merkle_path, anchor, offer_resource)
    merkle_path_2 = MerklePath.random(rng, TAIGA_COMMITMENT_TREE_DEPTH)
    anchor_2 = Anchor(Fp.random(rng))
    compliance_2 = ComplianceInfo(
        padding_input, merkle_path_2, anchor_2, returned_resource
    )

    nf_1 = intent.get_nf().inner()
    cm_1 = offer_resource.commitment().inner()
    nf_2 = padding_input.get_nf().inner()
    cm_2 = returned_resource.commitment().inner()
    tree = ResourceMerkleTreeLeaves([nf_1, cm_1, nf_2, cm_2])

    intent_logics = ResourceLogics(
        PartialFulfillmentIntentResourceLogicCircuit(
            ResourceExistenceWitness(intent, tree.generate_path(nf_1)),
            ResourceExistenceWitness(swap.sell.resource, tree.generate_path(nf_1)),
            ResourceExistenceWitness(offer_resource, tree.generate_path(cm_1)),
            ResourceExistenceWitness(returned_resource, tree.generate_path(cm_2)),
            swap,
        )
    )
    padding_logics = ResourceLogics.create_padding_resource_resource_logics(
        padding_input, tree.generate_path(nf_2)
    )
    # the offer output is a BUY-token resource to the seller
    from ..apps.token import TokenResource

    offer_token = TokenResource(swap.buy.name, offer_resource)
    offer_logics = offer_token.generate_output_token_resource_logics(
        rng, swap.auth, tree.generate_path(cm_1)
    )
    # the returned change resource is a token output back to the seller
    returned_token = TokenResource(swap.sell.token_name, returned_resource)
    returned_logics = returned_token.generate_output_token_resource_logics(
        rng, swap.auth, tree.generate_path(cm_2)
    )
    return _build_ptx(
        mode,
        [compliance_1, compliance_2],
        [intent_logics, padding_logics],
        [offer_logics, returned_logics],
        device,
        randbits,
    )


def create_partial_fulfillment_transaction(rng, mode: str = "transparent", *, device="cuda",
                                           randbits=secrets.randbits) -> Transaction:
    """Alice sells 2 BTC for 10 ETH; Bob provides 5 ETH for 1 BTC; the solver
    fills half of Alice's order (5 ETH to Alice, 1 BTC change back)
    (partial_fulfillment_token_swap.rs:233-272)."""
    resolve_device(device)
    kw = dict(device=device, randbits=randbits)
    g = PallasPoint.generator()
    alice_auth_sk = Fq.random(rng)
    alice_auth = TokenAuthorization(g * alice_auth_sk.v)
    swap = Swap.random(rng, Token("btc", 2), Token("eth", 10), alice_auth)

    alice_ptx, intent = create_partial_fulfillment_intent_ptx(rng, swap, alice_auth_sk, mode,
                                                              **kw)

    # Bob: 5 ETH in, 1 BTC out (the counterparty leg keeping the tx balanced)
    bob_auth_sk = Fq.random(rng)
    bob_nk = NullifierKeyContainer.random_key(rng)
    bob_ptx = create_token_swap_ptx(
        rng, Token("eth", 5), bob_auth_sk, bob_nk.get_nk(),
        Token("btc", 1), g * bob_auth_sk.v, bob_nk.get_npk(), mode, **kw,
    )

    solver_ptx = consume_partial_fulfillment_intent_ptx(
        rng, swap, intent, Token("eth", 5), mode, **kw
    )
    return _bundle(mode, [alice_ptx, bob_ptx, solver_ptx])
