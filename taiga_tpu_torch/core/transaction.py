"""Transaction: bundles of partial transactions sealed by a binding signature.

Copy of taiga_tpu/core/transaction.py (host: the binding signature and its
check run on the host; the partial transactions' proofs were made, and are
verified, by the port). Mirrors taiga_halo2/src/transaction.rs: build() signs the
Blake2b-256 digest of all nf/cm/delta/anchors with sk = sum of the ptx rcv
sums, then strips private info; execute() verifies every ptx and the binding
signature against vk = sum of all delta commitment points, returning the
induced state change.
"""

from __future__ import annotations

import hashlib

from ..crypto.curves import PallasPoint
from ..crypto.fields import Fq
from ..crypto.reddsa import BindingSignature, BindingSigningKey, BindingVerificationKey
from .constants import (
    TRANSACTION_BINDING_HASH_PERSONALIZATION,
    resource_commitment_r_generator,
)
from .error import InvalidBindingSignature, MissingPartialTxBindingSignatureR
from .ptx import ShieldedPartialTransaction, TransparentPartialTransaction


class TransactionResult:
    def __init__(self, anchors=None, nullifiers=None, output_cms=None):
        self.anchors = anchors or []
        self.nullifiers = nullifiers or []
        self.output_cms = output_cms or []

    def append(self, other: "TransactionResult"):
        self.anchors += other.anchors
        self.nullifiers += other.nullifiers
        self.output_cms += other.output_cms


class ShieldedPartialTxBundle:
    def __init__(self, partial_txs: list[ShieldedPartialTransaction] | None = None):
        self.partial_txs = partial_txs or []

    def is_empty(self):
        return not self.partial_txs

    def add_partial_tx(self, ptx):
        self.partial_txs.append(ptx)

    def get_binding_sig_r(self) -> Fq:
        total = Fq.zero()
        for ptx in self.partial_txs:
            r = ptx.get_binding_sig_r()
            if r is None:
                raise MissingPartialTxBindingSignatureR()
            total = total + r
        return total

    def clean_private_info(self):
        for ptx in self.partial_txs:
            ptx.clean_private_info()

    def execute(self) -> TransactionResult:
        for ptx in self.partial_txs:
            ptx.execute()
        return TransactionResult(
            anchors=self.get_anchors(),
            nullifiers=self.get_nullifiers(),
            output_cms=self.get_output_cms(),
        )

    def _collect(self, fn):
        out = []
        for ptx in self.partial_txs:
            out += fn(ptx)
        return out

    def get_nullifiers(self):
        return self._collect(lambda p: p.get_nullifiers())

    def get_output_cms(self):
        return self._collect(lambda p: p.get_output_cms())

    def get_delta_commitments(self):
        return self._collect(lambda p: p.get_delta_commitments())

    def get_anchors(self):
        return self._collect(lambda p: p.get_anchors())


class TransparentPartialTxBundle(ShieldedPartialTxBundle):
    def __init__(self, partial_txs: list[TransparentPartialTransaction] | None = None):
        self.partial_txs = partial_txs or []

    def get_binding_sig_r(self) -> Fq:
        return Fq.zero()

    def clean_private_info(self):
        pass


class Transaction:
    def __init__(self, shielded_ptx_bundle, transparent_ptx_bundle, signature: BindingSignature):
        self.shielded_ptx_bundle = shielded_ptx_bundle
        self.transparent_ptx_bundle = transparent_ptx_bundle
        self.signature = signature

    @classmethod
    def build(cls, shielded_bundle: ShieldedPartialTxBundle, transparent_bundle: TransparentPartialTxBundle):
        assert not (shielded_bundle.is_empty() and transparent_bundle.is_empty())
        sk = BindingSigningKey(
            shielded_bundle.get_binding_sig_r(), resource_commitment_r_generator()
        )
        sig_hash = cls.digest(shielded_bundle, transparent_bundle)
        signature = sk.sign(sig_hash)
        shielded_bundle.clean_private_info()
        return cls(shielded_bundle, transparent_bundle, signature)

    def execute(self) -> TransactionResult:
        result = self.shielded_ptx_bundle.execute()
        result.append(self.transparent_ptx_bundle.execute())
        self.verify_binding_sig()
        return result

    def verify_binding_sig(self):
        vk = self.get_binding_vk()
        sig_hash = self.digest(self.shielded_ptx_bundle, self.transparent_ptx_bundle)
        if not vk.verify(resource_commitment_r_generator(), sig_hash, self.signature):
            raise InvalidBindingSignature()

    def get_binding_vk(self) -> BindingVerificationKey:
        vk = PallasPoint.identity()
        for d in self.shielded_ptx_bundle.get_delta_commitments():
            vk = vk + d.inner()
        for d in self.transparent_ptx_bundle.get_delta_commitments():
            vk = vk + d.inner()
        return BindingVerificationKey(vk)

    @staticmethod
    def digest(shielded_bundle, transparent_bundle) -> bytes:
        """Blake2b-256(person="TxBindingSigHash") over nf || cm || delta ||
        anchor of both bundles (transaction.rs:116-158)."""
        h = hashlib.blake2b(
            digest_size=32, person=TRANSACTION_BINDING_HASH_PERSONALIZATION
        )
        for bundle in (shielded_bundle, transparent_bundle):
            for nf in bundle.get_nullifiers():
                h.update(nf.to_bytes())
            for cm in bundle.get_output_cms():
                h.update(cm.to_bytes())
            for d in bundle.get_delta_commitments():
                h.update(d.to_bytes())
            for a in bundle.get_anchors():
                h.update(a.to_bytes())
        return h.digest()
