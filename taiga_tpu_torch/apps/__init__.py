"""Applications (L6): example resource logics.

Copy of taiga_tpu/apps. Mirrors
taiga_halo2/src/circuit/resource_logic_examples/:
trivial, token, signature-verification (Schnorr auth), receiver (verifiable
encryption), or-relation intent, partial-fulfillment intent, field addition.

Importing this package registers every example in the resource-logic
bytecode registry (circuits/bytecode.py).
"""

from . import (  # noqa: F401  (registration side effects)
    field_addition,
    or_relation_intent,
    partial_fulfillment_intent,
    receiver,
    signature_verification,
    token,
    trivial,
)
from .field_addition import FieldAdditionResourceLogicCircuit
from .or_relation_intent import OrRelationIntentResourceLogicCircuit
from .partial_fulfillment_intent import (
    PartialFulfillmentIntentResourceLogicCircuit,
    Swap,
)
from .receiver import ReceiverResourceLogicCircuit
from .signature_verification import (
    SchnorrSignature,
    SignatureVerificationResourceLogicCircuit,
)
from .token import Token, TokenAuthorization, TokenResource, TokenResourceLogicCircuit
from .trivial import TrivialResourceLogicCircuit
