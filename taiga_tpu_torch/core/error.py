"""Transaction error types (mirrors taiga_halo2/src/error.rs)."""


class TransactionError(Exception):
    pass


class ProofError(TransactionError):
    pass


class InvalidBindingSignature(TransactionError):
    pass


class MissingBindingSignatures(TransactionError):
    pass


class InconsistentNullifier(TransactionError):
    pass


class InconsistentOutputResourceCommitment(TransactionError):
    pass


class InconsistentSelfResourceID(TransactionError):
    pass


class MissingPartialTxBindingSignatureR(TransactionError):
    pass


class InvalidResourceLogicRepresentation(TransactionError):
    pass


class InconsistentResourceMerkleRoot(TransactionError):
    pass
