"""Signing domains and signing roots (reference eth2util/signing/signing.go);
the port's copy of charon_tpu/eth2/signing.py.

Implements the consensus-spec domain separation: every signed object's message
is compute_signing_root(object_root, domain) where
domain = domain_type ++ fork_data_root(fork_version, genesis_validators_root)[:28].
`verify` checks a signature against the DV root (or share) pubkey via the tbls
seam of this package (reference signing.go:88 Verify → tbls.Verify).
"""

from __future__ import annotations

from .. import tbls
from .spec import ChainSpec, ForkData, SigningData
from .ssz import hash_tree_root, uint64

# DomainName constants (reference eth2util/signing/signing.go:20-40).
DOMAIN_BEACON_PROPOSER = bytes.fromhex("00000000")
DOMAIN_BEACON_ATTESTER = bytes.fromhex("01000000")
DOMAIN_RANDAO = bytes.fromhex("02000000")
DOMAIN_DEPOSIT = bytes.fromhex("03000000")
DOMAIN_VOLUNTARY_EXIT = bytes.fromhex("04000000")
DOMAIN_SELECTION_PROOF = bytes.fromhex("05000000")
DOMAIN_AGGREGATE_AND_PROOF = bytes.fromhex("06000000")
DOMAIN_SYNC_COMMITTEE = bytes.fromhex("07000000")
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = bytes.fromhex("08000000")
DOMAIN_CONTRIBUTION_AND_PROOF = bytes.fromhex("09000000")
DOMAIN_APPLICATION_BUILDER = bytes.fromhex("00000001")


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return ForkData(current_version, genesis_validators_root).hash_tree_root()


def compute_domain(domain_type: bytes, fork_version: bytes,
                   genesis_validators_root: bytes) -> bytes:
    return domain_type + compute_fork_data_root(
        fork_version, genesis_validators_root)[:28]


def get_domain(spec: ChainSpec, domain_type: bytes, epoch: int) -> bytes:
    """Fork-aware domain for an epoch. The deposit and builder domains always
    use the genesis fork with a zero genesis_validators_root (consensus-spec /
    builder-specs). Voluntary exits are pinned to the Capella fork domain
    regardless of the exit's epoch per EIP-7044 (in force Deneb+), so exit
    signatures stay valid across future forks."""
    if domain_type in (DOMAIN_DEPOSIT, DOMAIN_APPLICATION_BUILDER):
        return compute_domain(domain_type, spec.genesis_fork_version, b"\x00" * 32)
    if domain_type == DOMAIN_VOLUNTARY_EXIT and spec.capella_fork_version is not None:
        return compute_domain(domain_type, spec.capella_fork_version,
                              spec.genesis_validators_root)
    return compute_domain(domain_type, spec.fork_version_at(epoch),
                          spec.genesis_validators_root)


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    return SigningData(object_root, domain).hash_tree_root()


def signing_root_for(spec: ChainSpec, domain_type: bytes, epoch: int,
                     object_root: bytes) -> bytes:
    return compute_signing_root(object_root, get_domain(spec, domain_type, epoch))


def randao_signing_root(spec: ChainSpec, epoch: int) -> bytes:
    """Randao reveals sign hash_tree_root(epoch) under DOMAIN_RANDAO."""
    return signing_root_for(spec, DOMAIN_RANDAO, epoch,
                            uint64.hash_tree_root(epoch))


def slot_selection_root(spec: ChainSpec, slot: int) -> bytes:
    """Aggregation selection proofs sign hash_tree_root(slot) under
    DOMAIN_SELECTION_PROOF."""
    epoch = spec.epoch_of(slot)
    return signing_root_for(spec, DOMAIN_SELECTION_PROOF, epoch,
                            uint64.hash_tree_root(slot))


def verify(spec: ChainSpec, domain_type: bytes, epoch: int, object_root: bytes,
           pubkey: tbls.PublicKey, signature: tbls.Signature) -> bool:
    """Verify an eth2 signed object (reference signing.go:88)."""
    root = signing_root_for(spec, domain_type, epoch, object_root)
    return tbls.verify(pubkey, root, signature)


def sign(spec: ChainSpec, domain_type: bytes, epoch: int, object_root: bytes,
         secret: tbls.PrivateKey) -> tbls.Signature:
    root = signing_root_for(spec, domain_type, epoch, object_root)
    return tbls.sign(secret, root)
