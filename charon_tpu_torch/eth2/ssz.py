"""SSZ (SimpleSerialize) — serialization and hash_tree_root merkleization;
the port's copy of charon_tpu/eth2/ssz.py.

A from-scratch implementation of the consensus-spec SSZ subset the duty
pipeline needs (the reference consumes this via fastssz codegen, see
app/genssz and eth2util/../ssz.go files): little-endian uintN, byte
vectors/lists, bitlists, fixed vectors, element lists with length mix-in, and
containers. Types are described by small descriptor objects; containers are
dataclasses with an `ssz_fields` class attribute.
"""

from __future__ import annotations

import dataclasses
from hashlib import sha256
from typing import Any, Sequence

BYTES_PER_CHUNK = 32
_ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# Precomputed zero-subtree hashes: _zero_hashes[i] is the root of a depth-i
# all-zero tree.
_zero_hashes = [_ZERO_CHUNK]
for _ in range(64):
    _zero_hashes.append(sha256(_zero_hashes[-1] + _zero_hashes[-1]).digest())


def _hash(a: bytes, b: bytes) -> bytes:
    return sha256(a + b).digest()


def _merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Merkleize chunks into a single root, padding to `limit` chunks
    (or next power of two of len(chunks) when limit is None)."""
    count = len(chunks)
    if limit is None:
        limit = count
    if limit == 0:
        return _ZERO_CHUNK
    depth = max(limit - 1, 0).bit_length()
    if count > limit:
        raise ValueError("too many chunks")
    layer = list(chunks)
    for d in range(depth):
        if len(layer) % 2 == 1:
            layer.append(_zero_hashes[d])
        layer = [_hash(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    return layer[0] if layer else _zero_hashes[depth]


def _mix_in_length(root: bytes, length: int) -> bytes:
    return _hash(root, length.to_bytes(32, "little"))


def _pack_bytes(data: bytes) -> list[bytes]:
    chunks = [data[i: i + 32] for i in range(0, len(data), 32)] or [b""]
    return [c.ljust(32, b"\x00") for c in chunks]


# ---------------------------------------------------------------------------
# Type descriptors
# ---------------------------------------------------------------------------


class SSZType:
    def serialize(self, value: Any) -> bytes:
        raise NotImplementedError

    def hash_tree_root(self, value: Any) -> bytes:
        raise NotImplementedError

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        raise NotImplementedError


class UintN(SSZType):
    def __init__(self, bits: int):
        self.bits = bits

    def serialize(self, value: int) -> bytes:
        return int(value).to_bytes(self.bits // 8, "little")

    def hash_tree_root(self, value: int) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def fixed_size(self) -> int:
        return self.bits // 8


uint8 = UintN(8)
uint64 = UintN(64)
uint256 = UintN(256)


class Boolean(SSZType):
    def serialize(self, value: bool) -> bytes:
        return b"\x01" if value else b"\x00"

    def hash_tree_root(self, value: bool) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def fixed_size(self) -> int:
        return 1


boolean = Boolean()


class ByteVector(SSZType):
    def __init__(self, length: int):
        self.length = length

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)} bytes")
        return value

    def hash_tree_root(self, value: bytes) -> bytes:
        return _merkleize(_pack_bytes(self.serialize(value)))

    def fixed_size(self) -> int:
        return self.length


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


class ByteList(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return value

    def hash_tree_root(self, value: bytes) -> bytes:
        value = self.serialize(value)
        limit_chunks = (self.limit + 31) // 32
        return _mix_in_length(_merkleize(_pack_bytes(value) if value else [],
                                         limit_chunks), len(value))

    def is_fixed_size(self) -> bool:
        return False


class Bitlist(SSZType):
    """SSZ bitlist: little-endian bits with a trailing sentinel bit in the
    serialization; merkleized over bit-packed chunks with length mix-in."""

    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, bits: Sequence[bool]) -> bytes:
        if len(bits) > self.limit:
            raise ValueError("Bitlist over limit")
        as_int = 0
        for i, bit in enumerate(bits):
            if bit:
                as_int |= 1 << i
        as_int |= 1 << len(bits)  # delimiting sentinel bit
        return as_int.to_bytes(len(bits) // 8 + 1, "little")

    @staticmethod
    def deserialize(data: bytes) -> list[bool]:
        if not data or data[-1] == 0:
            raise ValueError("invalid bitlist serialization")
        as_int = int.from_bytes(data, "little")
        length = as_int.bit_length() - 1
        return [bool((as_int >> i) & 1) for i in range(length)]

    def hash_tree_root(self, bits: Sequence[bool]) -> bytes:
        as_int = 0
        for i, bit in enumerate(bits):
            if bit:
                as_int |= 1 << i
        data = as_int.to_bytes((len(bits) + 7) // 8, "little") if bits else b""
        limit_chunks = (self.limit + 255) // 256
        return _mix_in_length(_merkleize(_pack_bytes(data) if data else [],
                                         limit_chunks), len(bits))

    def is_fixed_size(self) -> bool:
        return False


class Bitvector(SSZType):
    def __init__(self, length: int):
        self.length = length

    def serialize(self, bits: Sequence[bool]) -> bytes:
        if len(bits) != self.length:
            raise ValueError("Bitvector length mismatch")
        as_int = 0
        for i, bit in enumerate(bits):
            if bit:
                as_int |= 1 << i
        return as_int.to_bytes((self.length + 7) // 8, "little")

    def hash_tree_root(self, bits: Sequence[bool]) -> bytes:
        return _merkleize(_pack_bytes(self.serialize(bits)))

    def fixed_size(self) -> int:
        return (self.length + 7) // 8


class List(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def serialize(self, values: Sequence[Any]) -> bytes:
        if len(values) > self.limit:
            raise ValueError("List over limit")
        if self.elem.is_fixed_size():
            return b"".join(self.elem.serialize(v) for v in values)
        parts = [self.elem.serialize(v) for v in values]
        offset = 4 * len(parts)
        out = b""
        for p in parts:
            out += offset.to_bytes(4, "little")
            offset += len(p)
        return out + b"".join(parts)

    def hash_tree_root(self, values: Sequence[Any]) -> bytes:
        if isinstance(self.elem, UintN):
            data = b"".join(self.elem.serialize(v) for v in values)
            limit_chunks = (self.limit * self.elem.fixed_size() + 31) // 32
            root = _merkleize(_pack_bytes(data) if data else [], limit_chunks)
        else:
            roots = [self.elem.hash_tree_root(v) for v in values]
            root = _merkleize(roots, self.limit)
        return _mix_in_length(root, len(values))

    def is_fixed_size(self) -> bool:
        return False


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        self.elem = elem
        self.length = length

    def serialize(self, values: Sequence[Any]) -> bytes:
        if len(values) != self.length:
            raise ValueError("Vector length mismatch")
        return b"".join(self.elem.serialize(v) for v in values)

    def hash_tree_root(self, values: Sequence[Any]) -> bytes:
        if isinstance(self.elem, UintN):
            return _merkleize(_pack_bytes(self.serialize(values)))
        return _merkleize([self.elem.hash_tree_root(v) for v in values])

    def is_fixed_size(self) -> bool:
        return self.elem.is_fixed_size()

    def fixed_size(self) -> int:
        return self.elem.fixed_size() * self.length


class Container(SSZType):
    """Descriptor for a dataclass with `ssz_fields: [(name, SSZType)]`."""

    def __init__(self, cls: type):
        self.cls = cls
        self.fields: list[tuple[str, SSZType]] = cls.ssz_fields

    def serialize(self, value: Any) -> bytes:
        fixed_parts: list[bytes | None] = []
        var_parts: list[bytes] = []
        for name, typ in self.fields:
            v = getattr(value, name)
            if typ.is_fixed_size():
                fixed_parts.append(typ.serialize(v))
            else:
                fixed_parts.append(None)
                var_parts.append(typ.serialize(v))
        fixed_len = sum(len(p) if p is not None else 4 for p in fixed_parts)
        offset = fixed_len
        out = b""
        vi = 0
        for p in fixed_parts:
            if p is not None:
                out += p
            else:
                out += offset.to_bytes(4, "little")
                offset += len(var_parts[vi])
                vi += 1
        return out + b"".join(var_parts)

    def hash_tree_root(self, value: Any) -> bytes:
        roots = [typ.hash_tree_root(getattr(value, name))
                 for name, typ in self.fields]
        return _merkleize(roots)

    def is_fixed_size(self) -> bool:
        return all(t.is_fixed_size() for _, t in self.fields)

    def fixed_size(self) -> int:
        return sum(t.fixed_size() for _, t in self.fields)


def container_type(value_or_cls: Any) -> Container:
    cls = value_or_cls if isinstance(value_or_cls, type) else type(value_or_cls)
    if not hasattr(cls, "ssz_fields"):
        raise TypeError(f"{cls.__name__} has no ssz_fields")
    return Container(cls)


def hash_tree_root(value: Any, typ: SSZType | None = None) -> bytes:
    """Root of any SSZ value; containers infer their descriptor."""
    if typ is None:
        typ = container_type(value)
    return typ.hash_tree_root(value)


def serialize(value: Any, typ: SSZType | None = None) -> bytes:
    if typ is None:
        typ = container_type(value)
    return typ.serialize(value)


def ssz_container(cls):
    """Decorator: dataclass + SSZ container with hash_tree_root method.

    Fields are declared with dataclass syntax plus an `ssz_fields` class
    attribute listing (name, SSZType) in SSZ order.
    """
    cls = dataclasses.dataclass(cls)

    def _htr(self) -> bytes:
        return Container(cls).hash_tree_root(self)

    def _ser(self) -> bytes:
        return Container(cls).serialize(self)

    cls.hash_tree_root = _htr
    cls.ssz_serialize = _ser
    return cls
