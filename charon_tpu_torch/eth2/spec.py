"""Minimal consensus-spec datatypes used by the duty pipeline; the port's
copy of charon_tpu/eth2/spec.py.

The reference consumes these via go-eth2-client (attestations, blocks, sync
committee messages, registrations...); this is a from-scratch SSZ-typed subset
sufficient for every duty type the pipeline signs and broadcasts. Block bodies
are carried as an opaque payload with a declared `body_root` — consensus,
signing, and aggregation all operate on roots, so the pipeline is agnostic to
body contents (a deliberate simplification vs the reference's
VersionedSignedBeaconBlock, core/signeddata.go:205).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .ssz import (
    Bitlist,
    Bitvector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    ssz_container,
    uint64,
)

MAX_VALIDATORS_PER_COMMITTEE = 2048
SYNC_COMMITTEE_SIZE = 512
SYNC_COMMITTEE_SUBNET_COUNT = 4
TARGET_AGGREGATORS_PER_COMMITTEE = 16


@ssz_container
class Checkpoint:
    epoch: int
    root: bytes
    ssz_fields = [("epoch", uint64), ("root", Bytes32)]


@ssz_container
class AttestationData:
    slot: int
    index: int
    beacon_block_root: bytes
    source: "Checkpoint"
    target: "Checkpoint"
    ssz_fields = None  # set below (needs Checkpoint container descriptor)


@ssz_container
class Attestation:
    aggregation_bits: list
    data: "AttestationData"
    signature: bytes
    ssz_fields = None


@ssz_container
class AggregateAndProof:
    aggregator_index: int
    aggregate: "Attestation"
    selection_proof: bytes
    ssz_fields = None


@ssz_container
class SignedAggregateAndProof:
    message: "AggregateAndProof"
    signature: bytes
    ssz_fields = None


@ssz_container
class BeaconBlockHeader:
    slot: int
    proposer_index: int
    parent_root: bytes
    state_root: bytes
    body_root: bytes
    ssz_fields = [
        ("slot", uint64), ("proposer_index", uint64), ("parent_root", Bytes32),
        ("state_root", Bytes32), ("body_root", Bytes32),
    ]


@dataclass
class BeaconBlock:
    """Block with opaque body: hash_tree_root == the header root, which is what
    the proposer signs (consensus-spec compute_signing_root(block) equals the
    root of its header)."""

    slot: int
    proposer_index: int
    parent_root: bytes
    state_root: bytes
    body_root: bytes
    body: Any = None          # opaque payload, not merkleized
    blinded: bool = False     # builder (blinded) proposal flag

    def header(self) -> BeaconBlockHeader:
        return BeaconBlockHeader(self.slot, self.proposer_index,
                                 self.parent_root, self.state_root, self.body_root)

    def hash_tree_root(self) -> bytes:
        return self.header().hash_tree_root()


@dataclass
class SignedBeaconBlock:
    message: BeaconBlock
    signature: bytes = b"\x00" * 96


@ssz_container
class VoluntaryExit:
    epoch: int
    validator_index: int
    ssz_fields = [("epoch", uint64), ("validator_index", uint64)]


@ssz_container
class SignedVoluntaryExit:
    message: "VoluntaryExit"
    signature: bytes
    ssz_fields = None


@ssz_container
class DepositMessage:
    pubkey: bytes
    withdrawal_credentials: bytes
    amount: int
    ssz_fields = [("pubkey", Bytes48), ("withdrawal_credentials", Bytes32),
                  ("amount", uint64)]


@ssz_container
class DepositData:
    pubkey: bytes
    withdrawal_credentials: bytes
    amount: int
    signature: bytes
    ssz_fields = [("pubkey", Bytes48), ("withdrawal_credentials", Bytes32),
                  ("amount", uint64), ("signature", Bytes96)]


@ssz_container
class ValidatorRegistration:
    fee_recipient: bytes
    gas_limit: int
    timestamp: int
    pubkey: bytes
    ssz_fields = [("fee_recipient", Bytes20), ("gas_limit", uint64),
                  ("timestamp", uint64), ("pubkey", Bytes48)]


@ssz_container
class SignedValidatorRegistration:
    message: "ValidatorRegistration"
    signature: bytes
    ssz_fields = None


@ssz_container
class SyncCommitteeMessage:
    slot: int
    beacon_block_root: bytes
    validator_index: int
    signature: bytes
    ssz_fields = [("slot", uint64), ("beacon_block_root", Bytes32),
                  ("validator_index", uint64), ("signature", Bytes96)]


@ssz_container
class SyncCommitteeContribution:
    slot: int
    beacon_block_root: bytes
    subcommittee_index: int
    aggregation_bits: list
    signature: bytes
    ssz_fields = [
        ("slot", uint64), ("beacon_block_root", Bytes32),
        ("subcommittee_index", uint64),
        ("aggregation_bits", Bitvector(SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT)),
        ("signature", Bytes96),
    ]


@ssz_container
class ContributionAndProof:
    aggregator_index: int
    contribution: "SyncCommitteeContribution"
    selection_proof: bytes
    ssz_fields = None


@ssz_container
class SignedContributionAndProof:
    message: "ContributionAndProof"
    signature: bytes
    ssz_fields = None


@ssz_container
class SyncAggregatorSelectionData:
    slot: int
    subcommittee_index: int
    ssz_fields = [("slot", uint64), ("subcommittee_index", uint64)]


@ssz_container
class ForkData:
    current_version: bytes
    genesis_validators_root: bytes
    ssz_fields = [("current_version", Bytes4),
                  ("genesis_validators_root", Bytes32)]


@ssz_container
class SigningData:
    object_root: bytes
    domain: bytes
    ssz_fields = [("object_root", Bytes32), ("domain", Bytes32)]


@ssz_container
class BeaconCommitteeSelection:
    """DVT aggregator selection (eth2exp, reference eth2util/eth2exp):
    validator's partial selection proof, combined cluster-wide."""
    validator_index: int
    slot: int
    selection_proof: bytes
    ssz_fields = [("validator_index", uint64), ("slot", uint64),
                  ("selection_proof", Bytes96)]


@ssz_container
class SyncCommitteeSelection:
    validator_index: int
    slot: int
    subcommittee_index: int
    selection_proof: bytes
    ssz_fields = [("validator_index", uint64), ("slot", uint64),
                  ("subcommittee_index", uint64), ("selection_proof", Bytes96)]


# Fix up forward-referencing ssz_fields now that all classes exist.
from .ssz import Container  # noqa: E402

AttestationData.ssz_fields = [
    ("slot", uint64), ("index", uint64), ("beacon_block_root", Bytes32),
    ("source", Container(Checkpoint)), ("target", Container(Checkpoint)),
]
Attestation.ssz_fields = [
    ("aggregation_bits", Bitlist(MAX_VALIDATORS_PER_COMMITTEE)),
    ("data", Container(AttestationData)), ("signature", Bytes96),
]
AggregateAndProof.ssz_fields = [
    ("aggregator_index", uint64), ("aggregate", Container(Attestation)),
    ("selection_proof", Bytes96),
]
SignedAggregateAndProof.ssz_fields = [
    ("message", Container(AggregateAndProof)), ("signature", Bytes96),
]
SignedVoluntaryExit.ssz_fields = [
    ("message", Container(VoluntaryExit)), ("signature", Bytes96),
]
SignedValidatorRegistration.ssz_fields = [
    ("message", Container(ValidatorRegistration)), ("signature", Bytes96),
]
ContributionAndProof.ssz_fields = [
    ("aggregator_index", uint64),
    ("contribution", Container(SyncCommitteeContribution)),
    ("selection_proof", Bytes96),
]
SignedContributionAndProof.ssz_fields = [
    ("message", Container(ContributionAndProof)), ("signature", Bytes96),
]


# ---------------------------------------------------------------------------
# Beacon-API duty descriptors (plain dataclasses; API types, not SSZ).
# ---------------------------------------------------------------------------


@dataclass
class AttesterDuty:
    pubkey: bytes
    slot: int
    validator_index: int
    committee_index: int
    committee_length: int
    committees_at_slot: int
    validator_committee_index: int


@dataclass
class ProposerDuty:
    pubkey: bytes
    slot: int
    validator_index: int


@dataclass
class SyncCommitteeDuty:
    pubkey: bytes
    validator_index: int
    validator_sync_committee_indices: list[int] = field(default_factory=list)


@dataclass
class Validator:
    """Beacon-state validator record subset (beacon-API /eth/v1/beacon/states/
    head/validators response shape)."""
    index: int
    pubkey: bytes
    status: str = "active_ongoing"
    effective_balance: int = 32 * 10**9
    activation_epoch: int = 0
    withdrawal_credentials: bytes = b"\x00" * 32

    def is_active(self) -> bool:
        return self.status.startswith("active")


@dataclass
class ChainSpec:
    """Chain parameters fetched from the BN at startup (the reference reads
    these via eth2wrap Spec/Genesis providers)."""
    genesis_time: float
    genesis_validators_root: bytes = b"\x00" * 32
    seconds_per_slot: float = 12.0
    slots_per_epoch: int = 32
    # Fork schedule: (activation_epoch, fork_version) sorted ascending; the
    # domain for an epoch uses the latest fork at or before it.
    fork_schedule: tuple = ((0, b"\x00\x00\x00\x00"),)
    epochs_per_sync_committee_period: int = 256
    # EIP-7044: on Deneb+ networks voluntary exits always use the Capella
    # fork domain; None means pre-Deneb behavior (exit-epoch fork domain).
    capella_fork_version: bytes | None = None

    def fork_version_at(self, epoch: int) -> bytes:
        version = self.fork_schedule[0][1]
        for activation, v in self.fork_schedule:
            if epoch >= activation:
                version = v
        return version

    @property
    def genesis_fork_version(self) -> bytes:
        return self.fork_schedule[0][1]

    def slot_start_time(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def slot_at(self, now: float) -> int:
        if now < self.genesis_time:
            return -1
        return int((now - self.genesis_time) // self.seconds_per_slot)

    def epoch_of(self, slot: int) -> int:
        return slot // self.slots_per_epoch
