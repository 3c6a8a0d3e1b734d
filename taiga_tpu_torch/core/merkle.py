"""Commitment Merkle tree: Anchor, LR, Node, MerklePath.

Mirrors taiga_halo2/src/merkle_tree.rs — depth-32 tree with
Node::combine = poseidon_hash(left, right) (not Sinsemilla, per the reference's
own deviation note at merkle_tree.rs:114).
"""

from __future__ import annotations

import enum
from typing import Iterable

from ..crypto.fields import Fp
from ..crypto.poseidon import poseidon_hash
from .constants import TAIGA_COMMITMENT_TREE_DEPTH


class LR(enum.Enum):
    """Position of the *sibling* node: L means the sibling is the left child."""

    R = 0
    L = 1

    def is_left(self) -> bool:
        return self is LR.L

    @classmethod
    def from_bool(cls, b: bool) -> "LR":
        return cls.L if b else cls.R


class Anchor:
    __slots__ = ("value",)

    def __init__(self, value: Fp):
        self.value = value

    def inner(self) -> Fp:
        return self.value

    def to_bytes(self) -> bytes:
        return self.value.to_repr()

    @classmethod
    def from_bytes(cls, b: bytes):
        v = Fp.from_repr(b)
        return None if v is None else cls(v)

    def __eq__(self, o):
        return isinstance(o, Anchor) and o.value == self.value

    def __hash__(self):
        return hash(("Anchor", self.value.v))

    def __repr__(self):
        return f"Anchor({self.value!r})"


class Node:
    __slots__ = ("value",)

    def __init__(self, value: Fp):
        self.value = value

    def inner(self) -> Fp:
        return self.value

    @staticmethod
    def combine(left: "Node", right: "Node") -> "Node":
        return Node(poseidon_hash(left.value, right.value))

    @classmethod
    def rand(cls, rng=None):
        return cls(Fp.random(rng))


class MerklePath:
    """An authentication path: list of (sibling, LR) from leaf to root."""

    __slots__ = ("path",)

    def __init__(self, path: Iterable[tuple[Node, LR]]):
        self.path = list(path)

    @classmethod
    def from_path(cls, path):
        return cls(path)

    @classmethod
    def random(cls, rng, depth: int = TAIGA_COMMITMENT_TREE_DEPTH):
        import random as _random

        r = rng if rng is not None else _random
        return cls(
            (Node(Fp.random(rng)), LR.from_bool(bool(r.getrandbits(1))))
            for _ in range(depth)
        )

    @classmethod
    def default(cls, depth: int = TAIGA_COMMITMENT_TREE_DEPTH):
        return cls((Node(Fp.one()), LR.L) for _ in range(depth))

    @classmethod
    def from_pairs(cls, pairs: Iterable[tuple[Fp, LR]]):
        return cls((Node(v), lr) for v, lr in pairs)

    def root(self, leaf: Node) -> Anchor:
        node = leaf
        for sibling, lr in self.path:
            if lr is LR.R:
                node = Node.combine(node, sibling)
            else:
                node = Node.combine(sibling, node)
        return Anchor(node.value)

    def inner(self) -> list[tuple[Fp, LR]]:
        return [(n.value, lr) for n, lr in self.path]

    def __len__(self):
        return len(self.path)
