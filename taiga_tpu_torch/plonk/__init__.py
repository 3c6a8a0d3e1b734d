"""Halo2-style PLONK proving system over the Pasta cycle with IPA commitments.

Modules:
  transcript   Blake2b Fiat-Shamir transcript
  srs          IPA structured reference string (Vesta generators)
  expression   gate polynomial AST (host and device evaluation, serialization)
  circuit      ConstraintSystem + CircuitBuilder (keygen/prove dual mode)
  tape         constraint expressions compiled to a register-machine tape
  keygen       proving/verifying key generation (host, native engine)
  prover       proof creation pipeline on a torch device
  hybrid_open  device multiopen aggregation + native IPA open
  verifier     proof verification
  ipa          inner-product-argument verification
  mock         MockProver: gates, lookups and copies checked without proving
"""
