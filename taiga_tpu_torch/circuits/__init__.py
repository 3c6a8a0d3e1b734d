"""Circuit layer (L3): compliance circuit, resource-logic framework, gadgets.

Own TPU-first layouts (not translations of the reference's halo2 chips): the
same *statements* as taiga_halo2/src/circuit/ — nullifier integrity, resource
commitments, Merkle membership, delta commitments, resource-logic commitments
— expressed over a shared 12-advice-column standard configuration with
poseidon round gates, a vanilla arithmetic gate, bit gates, and EC gates.
"""
