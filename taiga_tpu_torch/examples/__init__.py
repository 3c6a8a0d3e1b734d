"""End-to-end transaction example flows.

Mirrors taiga_halo2/examples/tx_examples/: the 3-party cyclic
token swap, the intent-matched swap (or-relation intent + solver), and the
partial-fulfillment limit order.
"""

from .tx_examples import (
    create_partial_fulfillment_transaction,
    create_token_swap_intent_transaction,
    create_token_swap_transaction,
)
