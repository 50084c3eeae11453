"""Reference check of halo2 proofs: the frozen verifier of ``halo2/``, run
against the verifying key's bytes and the reference SRS's G2 points."""

from __future__ import annotations

import hashlib
import types

from .halo2.verifier import verify_proof
from .halo2.vk import VerifyingKey
from .kzg import verifier_g2


class ProofChecker:
    def __init__(self, vk_bytes: bytes):
        self.vk_sha256 = hashlib.sha256(vk_bytes).hexdigest()
        self.vk = VerifyingKey.from_bytes(vk_bytes)
        g2, s_g2 = verifier_g2()
        self.params = types.SimpleNamespace(g2=g2, s_g2=s_g2)

    def verifies(self, proof: bytes, instances=None) -> bool:
        return verify_proof(self.params, self.vk, proof, instances)
