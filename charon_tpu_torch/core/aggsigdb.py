"""AggSigDB — in-memory store of final aggregate signatures with blocking
awaits (reference core/aggsigdb/memory.go); the port's copy of
charon_tpu/core/aggsigdb.py.

Consumed by the Fetcher (aggregated randao for proposals, combined selection
proofs for aggregation duties) and the ValidatorAPI (serving combined
selections). The reference serializes access through a single-goroutine
command loop (memory.go:116-160); here asyncio's single-threaded event loop
gives the same discipline, with futures for the blocking Await.
"""

from __future__ import annotations

import asyncio
import time as time_mod

from ..utils import errors, log, metrics
from .deadline import Deadliner
from .types import Duty, PubKey, SignedData, SignedDataSet

_log = log.with_topic("aggsigdb")

# The consumer side of threshold progress: how long fetcher/vapi callers
# block waiting for an aggregate that quorum has not yet produced. A cached
# hit observes ~0, so the histogram's upper quantiles isolate the waits.
_await_hist = metrics.histogram(
    "core_aggsigdb_await_seconds",
    "Time await_ blocked before the aggregate existed", ("type",))


class MemDB:  # lint: implements=AggSigDB
    """reference aggsigdb.NewMemDB; Store memory.go:44, Await memory.go:86."""

    def __init__(self, deadliner: Deadliner | None = None):
        # (duty, pubkey) -> message_root -> SignedData. Most duties have one
        # aggregate per validator; selection duties can have several (one per
        # subcommittee), each keyed by its payload root.
        self._data: dict[tuple[Duty, PubKey], dict[bytes, SignedData]] = {}
        # Waiter key includes the awaited root, or None for "any/first".
        self._waiters: dict[tuple[Duty, PubKey, bytes | None],
                            list[asyncio.Future]] = {}
        self._deadliner = deadliner

    async def run_gc(self) -> None:
        if self._deadliner is None:
            return
        async for duty in self._deadliner.expired():
            self._data = {k: v for k, v in self._data.items() if k[0] != duty}
            for key in [k for k in self._waiters if k[0] == duty]:
                # Fail (don't abandon) awaits whose aggregate never arrived —
                # a hanging future would wedge its caller forever.
                for fut in self._waiters.pop(key):
                    if not fut.done():
                        fut.set_exception(errors.new(
                            "duty expired awaiting aggregate signature",
                            duty=str(duty)))

    async def store(self, duty: Duty, signed: SignedDataSet) -> None:
        """Store aggregates, resolving blocked awaits (memory.go:44)."""
        if self._deadliner is not None and not self._deadliner.add(duty):
            _log.debug("dropping expired duty aggregate", duty=str(duty))
            return
        for pubkey, data in signed.items():
            key = (duty, pubkey)
            root = data.message_root()
            by_root = self._data.setdefault(key, {})
            existing = by_root.get(root)
            if existing is not None:
                if bytes(existing.signature()) != bytes(data.signature()):
                    raise errors.new("conflicting aggregate signature",
                                     duty=str(duty), pubkey=pubkey[:10])
                continue
            by_root[root] = data.clone()
            for waiter_root in (root, None):
                for fut in self._waiters.pop((duty, pubkey, waiter_root), []):
                    if not fut.done():
                        fut.set_result(data.clone())

    async def await_(self, duty: Duty, pubkey: PubKey,
                     root: bytes | None = None) -> SignedData:
        """Block until an aggregate for (duty, pubkey) exists (memory.go:86).

        With `root`, waits for the aggregate over that specific payload —
        required for selection duties where one validator aggregates several
        payloads (e.g. per sync subcommittee); without it, the first/only
        aggregate resolves the await."""
        by_root = self._data.get((duty, pubkey))
        if by_root:
            if root is None:
                _await_hist.observe(0.0, str(duty.type))
                return next(iter(by_root.values())).clone()
            if root in by_root:
                _await_hist.observe(0.0, str(duty.type))
                return by_root[root].clone()
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault((duty, pubkey, root), []).append(fut)
        t0 = time_mod.monotonic()
        try:
            return await fut
        finally:
            _await_hist.observe(time_mod.monotonic() - t0, str(duty.type))
