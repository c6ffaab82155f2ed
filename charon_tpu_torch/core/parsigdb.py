"""ParSigDB — in-memory partial-signature store (reference
core/parsigdb/memory.go); the port's copy of charon_tpu/core/parsigdb.py.

StoreInternal (from the local VC) fans out to internal subscribers — the
ParSigEx broadcast (memory.go:57-77). StoreExternal (from peers) dedups by
share index, errors on equivocation (same share, different sig, memory.go:145-
177), and when exactly `threshold` partials with a *matching message root*
exist for a duty+validator, fires the threshold subscribers → SigAgg
(memory.go:100-122, getThresholdMatching:198). Trimmed by the Deadliner.
"""

from __future__ import annotations

import time as time_mod
from collections import defaultdict

from ..utils import errors, log, metrics
from .deadline import Deadliner
from .types import Duty, DutyType, ParSignedData, ParSignedDataSet, PubKey

_log = log.with_topic("parsigdb")

_store_counter = metrics.counter(
    "core_parsigdb_store_total", "Partial signatures stored", ("source",))
# Threshold-progress instrumentation: the DV-critical question is
# "how long from the FIRST partial to the t-th matching partial, and which
# peer is dragging" — latency per duty type, contribution counts per share.
_quorum_latency = metrics.histogram(
    "core_parsig_quorum_latency_seconds",
    "First partial seen to threshold reached, per duty+validator", ("type",))
_contrib_counter = metrics.counter(
    "core_parsig_contributions_total",
    "Stored (non-duplicate) partials by contributing share index",
    ("share_idx",))
_partials_at_quorum = metrics.gauge(
    "core_parsig_partials_at_quorum_count",
    "Partials already present when the threshold fired", ("type",))

# Duty types where one validator legitimately signs several distinct payloads
# per duty — e.g. one SyncCommitteeSelection per subcommittee for the same
# (slot, PREPARE_SYNC_CONTRIBUTION) duty. For these a second payload from the
# same share is NOT equivocation; each message root aggregates independently
# (the reference keys selections per subcommittee).
MULTI_ROOT_DUTIES = frozenset({
    DutyType.PREPARE_AGGREGATOR,
    DutyType.PREPARE_SYNC_CONTRIBUTION,
})


class MemDB:  # lint: implements=ParSigDB
    """reference parsigdb.NewMemDB (memory.go:18)."""

    def __init__(self, threshold: int, deadliner: Deadliner | None = None):
        self._threshold = threshold
        self._deadliner = deadliner
        # (duty, pubkey) -> (share_idx, message_root) -> ParSignedData
        self._sigs: dict[tuple[Duty, PubKey],
                         dict[tuple[int, bytes], ParSignedData]] = defaultdict(dict)
        # Threshold fires once per (duty, pubkey, message_root).
        self._fired: set[tuple[Duty, PubKey, bytes]] = set()
        # (duty, pubkey) -> monotonic time the FIRST partial landed; the
        # quorum-latency histogram measures from here to threshold.
        self._first_seen: dict[tuple[Duty, PubKey], float] = {}
        self._internal_subs = []
        self._threshold_subs = []

    def subscribe_internal(self, fn) -> None:
        self._internal_subs.append(fn)

    def subscribe_threshold(self, fn) -> None:
        self._threshold_subs.append(fn)

    async def run_trim(self) -> None:
        """GC expired duties (reference memory.go:127 Trim)."""
        if self._deadliner is None:
            return
        async for duty in self._deadliner.expired():
            for key in [k for k in self._sigs if k[0] == duty]:
                del self._sigs[key]
            self._fired = {f for f in self._fired if f[0] != duty}
            for key in [k for k in self._first_seen if k[0] == duty]:
                del self._first_seen[key]

    async def store_internal(self, duty: Duty, parsigs: ParSignedDataSet) -> None:
        """Store our own VC's partials and fan out to internal subscribers
        (ParSigEx broadcast; reference memory.go:57-77)."""
        _store_counter.inc("internal", amount=len(parsigs))
        threshold_hits = await self._store(duty, parsigs)
        for fn in self._internal_subs:
            await fn(duty, {k: v.clone() for k, v in parsigs.items()})
        await self._fire_threshold(duty, threshold_hits)

    async def store_external(self, duty: Duty, parsigs: ParSignedDataSet) -> None:
        """Store peer partials (already verified by ParSigEx;
        reference memory.go:80-122 StoreExternal)."""
        _store_counter.inc("external", amount=len(parsigs))
        threshold_hits = await self._store(duty, parsigs)
        await self._fire_threshold(duty, threshold_hits)

    async def _store(self, duty: Duty,
                     parsigs: ParSignedDataSet) -> dict[PubKey, list[list[ParSignedData]]]:
        if self._deadliner is not None and not self._deadliner.add(duty):
            _log.debug("dropping expired duty partials", duty=str(duty))
            return {}
        hits: dict[PubKey, list[list[ParSignedData]]] = defaultdict(list)
        equivocation: BaseException | None = None
        multi_root = duty.type in MULTI_ROOT_DUTIES
        for pubkey, psd in parsigs.items():
            key = (duty, pubkey)
            root = psd.message_root()
            existing = self._sigs[key].get((psd.share_idx, root))
            if existing is not None:
                if bytes(existing.signature()) != bytes(psd.signature()):
                    # Same share, same payload, different signature.
                    equivocation = errors.new("equivocating partial signature",
                                              duty=str(duty),
                                              share_idx=psd.share_idx)
                continue  # duplicate, drop
            if not multi_root and any(si == psd.share_idx
                                      for si, _ in self._sigs[key]):
                # Equivocation: for single-payload duties one share signing
                # two different things is byzantine (reference
                # memory.go:145-177). Record it but keep processing the rest
                # of the batch — one faulty peer must not suppress other
                # validators' threshold hits.
                equivocation = errors.new("equivocating partial signature",
                                          duty=str(duty),
                                          share_idx=psd.share_idx)
                continue
            self._sigs[key][(psd.share_idx, root)] = psd.clone()
            now = time_mod.monotonic()
            self._first_seen.setdefault(key, now)
            _contrib_counter.inc(str(psd.share_idx))
            if (duty, pubkey, root) in self._fired:
                continue
            matching = self._root_group(key, root)
            # Fire exactly once per duty+validator+root, when the matching-
            # root group reaches threshold (reference memory.go:100-122,
            # getThresholdMatching:198).
            if len(matching) >= self._threshold:
                self._fired.add((duty, pubkey, root))
                _quorum_latency.observe(now - self._first_seen[key],
                                        str(duty.type))
                _partials_at_quorum.set(len(self._sigs[key]), str(duty.type))
                hits[pubkey].append(matching[: self._threshold])
        if equivocation is not None:
            _log.warn("equivocating partial in batch", err=equivocation,
                      duty=str(duty))
        return dict(hits)

    def _root_group(self, key, root: bytes) -> list[ParSignedData]:
        """All partials for key with the given message root."""
        return [psd for (_, r), psd in self._sigs[key].items() if r == root]

    async def _fire_threshold(
            self, duty: Duty,
            hits: dict[PubKey, list[list[ParSignedData]]]) -> None:
        if not hits:
            return
        _log.debug("threshold reached", duty=str(duty), pubkeys=len(hits))
        # Each root group aggregates independently; SigAgg takes one group per
        # pubkey per call, so emit in waves (a pubkey with k root groups —
        # e.g. k sync subcommittees — appears in k successive payloads).
        wave = 0
        while True:
            payload = {pk: [p.clone() for p in groups[wave]]
                       for pk, groups in hits.items() if wave < len(groups)}
            if not payload:
                return
            for fn in self._threshold_subs:
                await fn(duty, payload)
            wave += 1
