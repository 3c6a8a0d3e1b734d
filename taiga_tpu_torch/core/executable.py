"""Executable: the unified partial-transaction interface.

Mirrors taiga_halo2/src/executable.rs — execute() plus the
induced state-change accessors; the default resource Merkle root interleaves
[nf_1, cm_1, nf_2, cm_2, ...] into the depth-4 tree.
"""

from __future__ import annotations

from ..crypto.fields import Fp
from .resource_tree import ResourceMerkleTreeLeaves


class Executable:
    def execute(self) -> None:
        raise NotImplementedError

    def get_nullifiers(self):
        raise NotImplementedError

    def get_output_cms(self):
        raise NotImplementedError

    def get_delta_commitments(self):
        raise NotImplementedError

    def get_anchors(self):
        raise NotImplementedError

    def get_resource_merkle_root(self) -> Fp:
        leaves = []
        for nf, cm in zip(self.get_nullifiers(), self.get_output_cms()):
            leaves.append(nf.inner())
            leaves.append(cm.inner())
        return ResourceMerkleTreeLeaves(leaves).root()
