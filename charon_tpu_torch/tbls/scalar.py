"""Scalar-field (Fr) key work of the tbls seam: key generation and the
Shamir split and recovery, pure big-int math over Fr — the port's copy of
charon_tpu/tbls/python_impl.py:36-70 (FrScalarOps), which every backend of
the reference inherits so that the logic cannot diverge."""

from __future__ import annotations

import secrets

from ..crypto import fields as PF
from .types import PrivateKey


class FrScalarOps:
    """generate_secret_key, threshold_split and recover_secret over Fr."""

    def generate_secret_key(self) -> PrivateKey:
        while True:
            k = secrets.randbelow(PF.R)
            if k != 0:
                return PrivateKey(k.to_bytes(32, "big"))

    def threshold_split(self, secret: PrivateKey, total: int, threshold: int) -> dict[int, PrivateKey]:
        """Shamir split over Fr; shares evaluated at x = 1..total."""
        if not 1 <= threshold <= total:
            raise ValueError("invalid threshold/total")
        coeffs = [self._scalar(secret)] + [secrets.randbelow(PF.R) for _ in range(threshold - 1)]
        shares = {}
        for i in range(1, total + 1):
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * i + c) % PF.R
            shares[i] = PrivateKey(acc.to_bytes(32, "big"))
        return shares

    def recover_secret(self, shares: dict[int, PrivateKey], total: int, threshold: int) -> PrivateKey:
        ids = sorted(shares)
        if len(ids) < threshold:
            raise ValueError("insufficient shares")
        ids = ids[:threshold]
        lam = PF.lagrange_coefficients_at_zero(ids)
        acc = 0
        for i, l in zip(ids, lam):
            acc = (acc + l * self._scalar(shares[i])) % PF.R
        return PrivateKey(acc.to_bytes(32, "big"))

    @staticmethod
    def _scalar(secret: PrivateKey) -> int:
        k = int.from_bytes(bytes(secret), "big")
        if k == 0 or k >= PF.R:
            raise ValueError("invalid secret scalar")
        return k
