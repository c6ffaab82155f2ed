"""Threshold-BLS value types: fixed-size byte strings, as in
charon_tpu/tbls/types.py (PrivateKey 32 bytes, PublicKey 48 bytes,
Signature 96 bytes)."""

from __future__ import annotations


class PrivateKey(bytes):
    SIZE = 32

    def __new__(cls, data: bytes):
        if len(data) != cls.SIZE:
            raise ValueError(f"PrivateKey must be {cls.SIZE} bytes, got {len(data)}")
        return super().__new__(cls, data)


class PublicKey(bytes):
    SIZE = 48

    def __new__(cls, data: bytes):
        if len(data) != cls.SIZE:
            raise ValueError(f"PublicKey must be {cls.SIZE} bytes, got {len(data)}")
        return super().__new__(cls, data)


class Signature(bytes):
    SIZE = 96

    def __new__(cls, data: bytes):
        if len(data) != cls.SIZE:
            raise ValueError(f"Signature must be {cls.SIZE} bytes, got {len(data)}")
        return super().__new__(cls, data)
