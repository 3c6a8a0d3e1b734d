"""Per-partial-transaction resource Merkle tree (depth 4, 16 leaves).

Mirrors taiga_halo2/src/resource_tree.rs: leaves are the
interleaved [nf_1, cm_1, nf_2, cm_2, ...] identities of the ptx's resources;
a ResourceExistenceWitness proves a resource's membership, with "is input"
encoded in the LSB of the path (inputs sit at even positions, so the first
sibling of an input is on the right).
"""

from __future__ import annotations

from ..crypto.fields import Fp
from ..crypto.poseidon import poseidon_hash
from .constants import TAIGA_RESOURCE_TREE_DEPTH, TAIGA_RESOURCE_TREE_LEAVES_NUM
from .merkle import LR, MerklePath, Node
from .resource import Resource


class ResourceExistenceWitness:
    __slots__ = ("resource", "merkle_path")

    def __init__(self, resource: Resource, merkle_path: list[tuple[Fp, LR]]):
        assert len(merkle_path) == TAIGA_RESOURCE_TREE_DEPTH
        self.resource = resource
        self.merkle_path = list(merkle_path)

    @classmethod
    def default(cls):
        return cls(
            Resource.random(),
            [(Fp.zero(), LR.R)] * TAIGA_RESOURCE_TREE_DEPTH,
        )

    def get_resource(self) -> Resource:
        return self.resource

    def get_path(self) -> list[tuple[Fp, LR]]:
        return self.merkle_path

    def is_input(self) -> bool:
        # Input identities (nullifiers) sit at even leaf positions; their first
        # sibling is therefore on the right (LR.R -> not left).
        return not self.merkle_path[0][1].is_left()

    def get_identity(self) -> Fp:
        if self.is_input():
            return self.resource.get_nf().inner()
        return self.resource.commitment().inner()

    def get_root(self) -> Fp:
        node = Node(self.get_identity())
        return MerklePath.from_pairs(self.merkle_path).root(node).inner()

    def serialize(self) -> bytes:
        """resource (202 B) + 4 x (32 B sibling + 1 B is_left) = 334 B
        (borsh layout, reference resource_tree.rs:71-100)."""
        out = self.resource.serialize()
        for value, lr in self.merkle_path:
            out += value.to_repr()
            out += bytes([1 if lr.is_left() else 0])
        return out

    @classmethod
    def deserialize(cls, data: bytes) -> "ResourceExistenceWitness":
        import io

        r = io.BytesIO(data)
        resource = Resource.deserialize(r)
        path = []
        for _ in range(TAIGA_RESOURCE_TREE_DEPTH):
            v = Fp.from_repr(r.read(32))
            if v is None:
                raise ValueError("path node out of range")
            b = r.read(1)[0]
            path.append((v, LR.L if b == 0x01 else LR.R))
        return cls(resource, path)


class ResourceMerkleTreeLeaves:
    """Fixed 16-leaf binary Poseidon tree, zero-padded."""

    __slots__ = ("leaves",)

    def __init__(self, leaves: list[Fp]):
        assert len(leaves) <= TAIGA_RESOURCE_TREE_LEAVES_NUM
        self.leaves = list(leaves)

    def insert(self, value: Fp):
        self.leaves.append(value)

    def root(self) -> Fp:
        layer = self.leaves + [Fp.zero()] * (TAIGA_RESOURCE_TREE_LEAVES_NUM - len(self.leaves))
        while len(layer) > 1:
            layer = [poseidon_hash(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
        return layer[0]

    def generate_path(self, cur_leaf: Fp) -> list[tuple[Fp, LR]] | None:
        layer = self.leaves + [Fp.zero()] * (TAIGA_RESOURCE_TREE_LEAVES_NUM - len(self.leaves))
        try:
            pos = next(i for i, v in enumerate(layer) if v == cur_leaf)
        except StopIteration:
            return None
        path = []
        while len(layer) > 1:
            if pos % 2 == 0:
                path.append((layer[pos + 1], LR.R))
            else:
                path.append((layer[pos - 1], LR.L))
            layer = [poseidon_hash(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
            pos //= 2
        return path
