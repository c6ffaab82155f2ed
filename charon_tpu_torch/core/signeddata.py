"""Concrete SignedData implementations (reference core/signeddata.go); the
port's copy of charon_tpu/core/signeddata.py, registered in this package's
core/types registry.

Each wraps an eth2 spec payload plus its BLS signature and knows its signing
domain + epoch, so the pipeline can verify partial and aggregate signatures
generically (reference core/eth2signeddata.go:33 VerifyEth2SignedData).
message_root() is the pre-domain object root used to group matching partials.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .. import tbls
from ..eth2 import signing, spec
from ..eth2.ssz import uint64
from .types import hx, register_signed, unhx

ZERO_SIG = b"\x00" * 96


def _replace_sig(obj, sig: tbls.Signature):
    return dataclasses.replace(obj, sig=tbls.Signature(bytes(sig)))


class _Eth2Signed:
    """Shared behaviour: signature accessors + eth2 verification metadata."""

    sig: bytes
    domain_type: bytes

    def signature(self) -> tbls.Signature:
        return tbls.Signature(bytes(self.sig))

    def set_signature(self, sig: tbls.Signature):
        return _replace_sig(self, sig)

    def clone(self):
        return dataclasses.replace(self)

    def epoch(self, chain: spec.ChainSpec) -> int:
        raise NotImplementedError

    def verify(self, chain: spec.ChainSpec, pubkey: tbls.PublicKey) -> bool:
        """VerifyEth2SignedData (reference core/eth2signeddata.go:33)."""
        return signing.verify(chain, self.domain_type, self.epoch(chain),
                              self.message_root(), pubkey,
                              tbls.Signature(bytes(self.sig)))

    def signing_root(self, chain: spec.ChainSpec) -> bytes:
        return signing.signing_root_for(chain, self.domain_type,
                                        self.epoch(chain), self.message_root())


@register_signed("attestation")
@dataclass(frozen=True)
class SignedAttestation(_Eth2Signed):
    """An attestation signed by a (share of a) validator
    (reference core/signeddata.go:616 Attestation)."""

    att: spec.Attestation
    domain_type = signing.DOMAIN_BEACON_ATTESTER

    @property
    def sig(self) -> bytes:
        return bytes(self.att.signature)

    def set_signature(self, sig: tbls.Signature) -> "SignedAttestation":
        new_att = dataclasses.replace(self.att, signature=bytes(sig))
        return SignedAttestation(new_att)

    def clone(self) -> "SignedAttestation":
        return SignedAttestation(dataclasses.replace(
            self.att, aggregation_bits=list(self.att.aggregation_bits),
            data=dataclasses.replace(
                self.att.data,
                source=dataclasses.replace(self.att.data.source),
                target=dataclasses.replace(self.att.data.target))))

    def message_root(self) -> bytes:
        return self.att.data.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return self.att.data.target.epoch

    def to_json(self) -> dict:
        d = self.att.data
        return {
            "aggregation_bits": self.att.aggregation_bits,
            "data": {
                "slot": d.slot, "index": d.index,
                "beacon_block_root": hx(d.beacon_block_root),
                "source": {"epoch": d.source.epoch, "root": hx(d.source.root)},
                "target": {"epoch": d.target.epoch, "root": hx(d.target.root)},
            },
            "signature": hx(self.att.signature),
        }

    @staticmethod
    def from_json(obj: dict) -> "SignedAttestation":
        d = obj["data"]
        data = spec.AttestationData(
            slot=int(d["slot"]), index=int(d["index"]),
            beacon_block_root=unhx(d["beacon_block_root"]),
            source=spec.Checkpoint(int(d["source"]["epoch"]), unhx(d["source"]["root"])),
            target=spec.Checkpoint(int(d["target"]["epoch"]), unhx(d["target"]["root"])))
        return SignedAttestation(spec.Attestation(
            aggregation_bits=[bool(b) for b in obj["aggregation_bits"]],
            data=data, signature=unhx(obj["signature"])))


@register_signed("randao")
@dataclass(frozen=True)
class SignedRandao(_Eth2Signed):
    """Signed randao reveal for an epoch (reference core/signeddata.go:931)."""

    randao_epoch: int
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_RANDAO

    def message_root(self) -> bytes:
        return uint64.hash_tree_root(self.randao_epoch)

    def epoch(self, chain: spec.ChainSpec) -> int:
        return self.randao_epoch

    def to_json(self) -> dict:
        return {"epoch": self.randao_epoch, "signature": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "SignedRandao":
        return SignedRandao(int(obj["epoch"]), unhx(obj["signature"]))


@register_signed("block")
@dataclass(frozen=True)
class SignedProposal(_Eth2Signed):
    """Signed (possibly blinded) beacon block proposal
    (reference core/signeddata.go:205 VersionedSignedBeaconBlock)."""

    block: spec.BeaconBlock
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_BEACON_PROPOSER

    def message_root(self) -> bytes:
        return self.block.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.block.slot)

    def clone(self) -> "SignedProposal":
        return SignedProposal(dataclasses.replace(self.block), self.sig)

    def to_json(self) -> dict:
        b = self.block
        return {"block": {
            "slot": b.slot, "proposer_index": b.proposer_index,
            "parent_root": hx(b.parent_root), "state_root": hx(b.state_root),
            "body_root": hx(b.body_root), "blinded": b.blinded,
        }, "signature": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "SignedProposal":
        b = obj["block"]
        return SignedProposal(spec.BeaconBlock(
            slot=int(b["slot"]), proposer_index=int(b["proposer_index"]),
            parent_root=unhx(b["parent_root"]), state_root=unhx(b["state_root"]),
            body_root=unhx(b["body_root"]), blinded=bool(b.get("blinded", False))),
            unhx(obj["signature"]))


@register_signed("voluntary_exit")
@dataclass(frozen=True)
class SignedExit(_Eth2Signed):
    """Signed voluntary exit (reference core/signeddata.go SignedVoluntaryExit)."""

    exit: spec.VoluntaryExit
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_VOLUNTARY_EXIT

    def message_root(self) -> bytes:
        return self.exit.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return self.exit.epoch

    def clone(self) -> "SignedExit":
        return SignedExit(dataclasses.replace(self.exit), self.sig)

    def to_json(self) -> dict:
        return {"epoch": self.exit.epoch,
                "validator_index": self.exit.validator_index,
                "signature": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "SignedExit":
        return SignedExit(spec.VoluntaryExit(int(obj["epoch"]),
                                             int(obj["validator_index"])),
                          unhx(obj["signature"]))


@register_signed("aggregate_and_proof")
@dataclass(frozen=True)
class SignedAggregateAndProof(_Eth2Signed):
    """Signed aggregate-and-proof (reference core/signeddata.go:1142)."""

    message: spec.AggregateAndProof
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_AGGREGATE_AND_PROOF

    def message_root(self) -> bytes:
        return self.message.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.message.aggregate.data.slot)

    def clone(self) -> "SignedAggregateAndProof":
        m = self.message
        agg = dataclasses.replace(
            m.aggregate, aggregation_bits=list(m.aggregate.aggregation_bits))
        return SignedAggregateAndProof(dataclasses.replace(m, aggregate=agg), self.sig)

    def to_json(self) -> dict:
        m = self.message
        return {
            "aggregator_index": m.aggregator_index,
            "aggregate": SignedAttestation(m.aggregate).to_json(),
            "selection_proof": hx(m.selection_proof),
            "signature": hx(self.sig),
        }

    @staticmethod
    def from_json(obj: dict) -> "SignedAggregateAndProof":
        agg = SignedAttestation.from_json(obj["aggregate"]).att
        return SignedAggregateAndProof(
            spec.AggregateAndProof(int(obj["aggregator_index"]), agg,
                                   unhx(obj["selection_proof"])),
            unhx(obj["signature"]))


@register_signed("sync_message")
@dataclass(frozen=True)
class SignedSyncMessage(_Eth2Signed):
    """Sync-committee message: signs the beacon block root directly
    (reference core/signeddata.go SignedSyncMessage)."""

    msg: spec.SyncCommitteeMessage
    domain_type = signing.DOMAIN_SYNC_COMMITTEE

    @property
    def sig(self) -> bytes:
        return bytes(self.msg.signature)

    def set_signature(self, sig: tbls.Signature) -> "SignedSyncMessage":
        return SignedSyncMessage(dataclasses.replace(self.msg, signature=bytes(sig)))

    def clone(self) -> "SignedSyncMessage":
        return SignedSyncMessage(dataclasses.replace(self.msg))

    def message_root(self) -> bytes:
        return bytes(self.msg.beacon_block_root)

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.msg.slot)

    def to_json(self) -> dict:
        return {"slot": self.msg.slot,
                "beacon_block_root": hx(self.msg.beacon_block_root),
                "validator_index": self.msg.validator_index,
                "signature": hx(self.msg.signature)}

    @staticmethod
    def from_json(obj: dict) -> "SignedSyncMessage":
        return SignedSyncMessage(spec.SyncCommitteeMessage(
            int(obj["slot"]), unhx(obj["beacon_block_root"]),
            int(obj["validator_index"]), unhx(obj["signature"])))


@register_signed("contribution_and_proof")
@dataclass(frozen=True)
class SignedSyncContributionAndProof(_Eth2Signed):
    """Signed sync-committee contribution-and-proof
    (reference core/signeddata.go:1309 SyncContributionAndProof)."""

    message: spec.ContributionAndProof
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_CONTRIBUTION_AND_PROOF

    def message_root(self) -> bytes:
        return self.message.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.message.contribution.slot)

    def clone(self) -> "SignedSyncContributionAndProof":
        m = self.message
        contrib = dataclasses.replace(
            m.contribution, aggregation_bits=list(m.contribution.aggregation_bits))
        return SignedSyncContributionAndProof(
            dataclasses.replace(m, contribution=contrib), self.sig)

    def to_json(self) -> dict:
        c = self.message.contribution
        return {
            "aggregator_index": self.message.aggregator_index,
            "contribution": {
                "slot": c.slot, "beacon_block_root": hx(c.beacon_block_root),
                "subcommittee_index": c.subcommittee_index,
                "aggregation_bits": c.aggregation_bits,
                "signature": hx(c.signature),
            },
            "selection_proof": hx(self.message.selection_proof),
            "signature": hx(self.sig),
        }

    @staticmethod
    def from_json(obj: dict) -> "SignedSyncContributionAndProof":
        c = obj["contribution"]
        contrib = spec.SyncCommitteeContribution(
            int(c["slot"]), unhx(c["beacon_block_root"]),
            int(c["subcommittee_index"]),
            [bool(b) for b in c["aggregation_bits"]], unhx(c["signature"]))
        return SignedSyncContributionAndProof(
            spec.ContributionAndProof(int(obj["aggregator_index"]), contrib,
                                      unhx(obj["selection_proof"])),
            unhx(obj["signature"]))


@register_signed("beacon_committee_selection")
@dataclass(frozen=True)
class BeaconCommitteeSelection(_Eth2Signed):
    """Partial beacon-committee selection proof — the DVT-specific value
    aggregated cluster-wide so aggregator selection works with key shares
    (reference eth2util/eth2exp, core duty PREPARE_AGGREGATOR)."""

    validator_index: int
    slot: int
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_SELECTION_PROOF

    def message_root(self) -> bytes:
        return uint64.hash_tree_root(self.slot)

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.slot)

    def to_json(self) -> dict:
        return {"validator_index": self.validator_index, "slot": self.slot,
                "selection_proof": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "BeaconCommitteeSelection":
        return BeaconCommitteeSelection(int(obj["validator_index"]),
                                        int(obj["slot"]),
                                        unhx(obj["selection_proof"]))


@register_signed("sync_committee_selection")
@dataclass(frozen=True)
class SyncCommitteeSelection(_Eth2Signed):
    """Partial sync-committee selection proof (reference eth2util/eth2exp)."""

    validator_index: int
    slot: int
    subcommittee_index: int
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF

    def message_root(self) -> bytes:
        return spec.SyncAggregatorSelectionData(
            self.slot, self.subcommittee_index).hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        return chain.epoch_of(self.slot)

    def to_json(self) -> dict:
        return {"validator_index": self.validator_index, "slot": self.slot,
                "subcommittee_index": self.subcommittee_index,
                "selection_proof": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "SyncCommitteeSelection":
        return SyncCommitteeSelection(int(obj["validator_index"]),
                                      int(obj["slot"]),
                                      int(obj["subcommittee_index"]),
                                      unhx(obj["selection_proof"]))


@register_signed("validator_registration")
@dataclass(frozen=True)
class SignedRegistration(_Eth2Signed):
    """Signed builder validator registration
    (reference core/signeddata.go VersionedSignedValidatorRegistration)."""

    registration: spec.ValidatorRegistration
    sig: bytes = ZERO_SIG
    domain_type = signing.DOMAIN_APPLICATION_BUILDER

    def message_root(self) -> bytes:
        return self.registration.hash_tree_root()

    def epoch(self, chain: spec.ChainSpec) -> int:
        # Registrations are epoch-independent (builder domain ignores fork).
        return 0

    def clone(self) -> "SignedRegistration":
        return SignedRegistration(dataclasses.replace(self.registration), self.sig)

    def to_json(self) -> dict:
        r = self.registration
        return {"message": {
            "fee_recipient": hx(r.fee_recipient), "gas_limit": r.gas_limit,
            "timestamp": r.timestamp, "pubkey": hx(r.pubkey),
        }, "signature": hx(self.sig)}

    @staticmethod
    def from_json(obj: dict) -> "SignedRegistration":
        m = obj["message"]
        return SignedRegistration(spec.ValidatorRegistration(
            unhx(m["fee_recipient"]), int(m["gas_limit"]), int(m["timestamp"]),
            unhx(m["pubkey"])), unhx(obj["signature"]))
