"""Core workflow value types (reference core/types.go); the port's copy of
charon_tpu/core/types.py, with its own registry of signed types.

The unit of work is a `Duty{slot, type}`; all values flowing through the
pipeline are duty-scoped and immutable — components clone values at every
scope boundary (reference docs/architecture.md:180-183, core/types.go Clone
methods). Four abstract value kinds flow through the pipeline:

  DutyDefinition — what must be done (from the scheduler)
  UnsignedData   — the data to sign (from the fetcher, agreed by consensus)
  SignedData     — data plus a (partial or aggregate) BLS signature
  ParSignedData  — SignedData plus the share index that produced it

and their per-validator batch maps (…Set), which batch all validators of a
slot through one pipeline step — the batching axis the device backend exploits.
"""

from __future__ import annotations

import copy
import enum
import functools
from dataclasses import dataclass
from typing import Any, Protocol, runtime_checkable

from .. import tbls

# ---------------------------------------------------------------------------
# Duty
# ---------------------------------------------------------------------------


class DutyType(enum.IntEnum):
    """The 13 duty types (reference core/types.go:28-45)."""

    UNKNOWN = 0
    PROPOSER = 1
    ATTESTER = 2
    SIGNATURE = 3
    EXIT = 4
    BUILDER_PROPOSER = 5
    BUILDER_REGISTRATION = 6
    RANDAO = 7
    PREPARE_AGGREGATOR = 8
    AGGREGATOR = 9
    SYNC_MESSAGE = 10
    PREPARE_SYNC_CONTRIBUTION = 11
    SYNC_CONTRIBUTION = 12
    INFO_SYNC = 13

    def __str__(self) -> str:  # noqa: DunderStr — used in logs/metrics labels
        return self.name.lower()

    @property
    def valid(self) -> bool:
        return self is not DutyType.UNKNOWN


@functools.total_ordering
@dataclass(frozen=True)
class Duty:
    """The unit of work: a type happening on a slot (reference types.go:81)."""

    slot: int
    type: DutyType

    def __str__(self) -> str:
        return f"{self.slot}/{self.type}"

    def __lt__(self, other: "Duty") -> bool:
        return (self.slot, int(self.type)) < (other.slot, int(other.type))


def new_attester_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.ATTESTER)


def new_proposer_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.PROPOSER)


def new_randao_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.RANDAO)


# ---------------------------------------------------------------------------
# PubKey — the DV root public key as 0x-hex string (reference types.go:293)
# ---------------------------------------------------------------------------

PubKey = str  # "0x" + 96 hex chars


def pubkey_from_bytes(pk: bytes | tbls.PublicKey) -> PubKey:
    b = bytes(pk)
    if len(b) != 48:
        raise ValueError(f"pubkey must be 48 bytes, got {len(b)}")
    return "0x" + b.hex()


def pubkey_to_bytes(pk: PubKey) -> tbls.PublicKey:
    if not pk.startswith("0x") or len(pk) != 98:
        raise ValueError(f"invalid core pubkey {pk[:20]!r}")
    return tbls.PublicKey(bytes.fromhex(pk[2:]))


# ---------------------------------------------------------------------------
# Value kinds
# ---------------------------------------------------------------------------


@runtime_checkable
class DutyDefinition(Protocol):
    """How a duty is performed, per validator (reference types.go:334)."""

    def clone(self) -> "DutyDefinition": ...
    def to_json(self) -> dict: ...


@runtime_checkable
class UnsignedData(Protocol):
    """Unsigned duty data object (reference types.go:366)."""

    def clone(self) -> "UnsignedData": ...
    def to_json(self) -> dict: ...


@runtime_checkable
class SignedData(Protocol):
    """Signed duty data: payload + BLS signature (reference types.go:408).

    message_root() is the root of the *payload* (pre-domain object root) —
    partials for the same duty+validator group by it in ParSigDB; the
    threshold check requires t matching roots (parsigdb/memory.go:198).
    """

    def message_root(self) -> bytes: ...
    def signature(self) -> tbls.Signature: ...
    def set_signature(self, sig: tbls.Signature) -> "SignedData": ...
    def clone(self) -> "SignedData": ...
    def to_json(self) -> dict: ...


@dataclass(frozen=True)
class ParSignedData:
    """A partially signed duty datum: SignedData signed by a single key share,
    tagged with the share index (1-indexed; reference types.go:437-452)."""

    data: SignedData
    share_idx: int

    def message_root(self) -> bytes:
        return self.data.message_root()

    def signature(self) -> tbls.Signature:
        return self.data.signature()

    def clone(self) -> "ParSignedData":
        return ParSignedData(self.data.clone(), self.share_idx)

    def to_json(self) -> dict:
        return {"data": encode_signed(self.data), "share_idx": self.share_idx}

    @staticmethod
    def from_json(obj: dict) -> "ParSignedData":
        return ParSignedData(decode_signed(obj["data"]), int(obj["share_idx"]))


# Per-validator batch maps (reference types.go:342,369,433): one pipeline step
# processes all validators of a slot at once.
DutyDefinitionSet = dict[PubKey, DutyDefinition]
UnsignedDataSet = dict[PubKey, UnsignedData]
SignedDataSet = dict[PubKey, SignedData]
ParSignedDataSet = dict[PubKey, ParSignedData]


def clone_set(s: dict[PubKey, Any]) -> dict[PubKey, Any]:
    """Clone a value set at a scope boundary (reference types.go Clone)."""
    return {k: v.clone() for k, v in s.items()}


def deep_clone(v: Any) -> Any:
    return copy.deepcopy(v)


# ---------------------------------------------------------------------------
# JSON codec registry — SignedData/UnsignedData/DutyDefinition implementations
# register here so sets round-trip over the wire (p2p parsigex, consensus) and
# into golden test files (reference core/proto.go:31-229 analogue).
# ---------------------------------------------------------------------------

_signed_types: dict[str, type] = {}
_unsigned_types: dict[str, type] = {}
_definition_types: dict[str, type] = {}


def register_signed(name: str):
    def deco(cls):
        _signed_types[name] = cls
        cls.type_name = name
        return cls
    return deco


def register_unsigned(name: str):
    def deco(cls):
        _unsigned_types[name] = cls
        cls.type_name = name
        return cls
    return deco


def register_definition(name: str):
    def deco(cls):
        _definition_types[name] = cls
        cls.type_name = name
        return cls
    return deco


def encode_signed(data: SignedData) -> dict:
    return {"type": data.type_name, "value": data.to_json()}


def decode_signed(obj: dict) -> SignedData:
    cls = _signed_types.get(obj.get("type", ""))
    if cls is None:
        raise ValueError(f"unknown signed data type {obj.get('type')!r}")
    return cls.from_json(obj["value"])


def encode_unsigned(data: UnsignedData) -> dict:
    return {"type": data.type_name, "value": data.to_json()}


def decode_unsigned(obj: dict) -> UnsignedData:
    cls = _unsigned_types.get(obj.get("type", ""))
    if cls is None:
        raise ValueError(f"unknown unsigned data type {obj.get('type')!r}")
    return cls.from_json(obj["value"])


def encode_definition(data: DutyDefinition) -> dict:
    return {"type": data.type_name, "value": data.to_json()}


def decode_definition(obj: dict) -> DutyDefinition:
    cls = _definition_types.get(obj.get("type", ""))
    if cls is None:
        raise ValueError(f"unknown duty definition type {obj.get('type')!r}")
    return cls.from_json(obj["value"])


# -- hex helpers shared by the concrete value types -------------------------


def hx(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def unhx(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)
