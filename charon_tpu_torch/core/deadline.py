"""Duty deadlines and the Deadliner expiry clock (reference core/deadline.go);
the port's copy of charon_tpu/core/deadline.py.

A duty expires `LATE_FACTOR` slots after its own slot starts
(deadline.go:19 lateFactor=5): after that no downstream step can help it, so
in-memory stores GC it. Duty types that live longer than a slot (exits,
builder registrations) never expire (deadline.go:27-36).
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import AsyncIterator, Callable

from ..eth2.spec import ChainSpec
from .types import Duty, DutyType

LATE_FACTOR = 5

# Duty types without deadlines (reference deadline.go:30-34).
_NO_DEADLINE = {DutyType.EXIT, DutyType.BUILDER_REGISTRATION}


def duty_deadline(spec: ChainSpec, duty: Duty) -> float | None:
    """Absolute unix deadline for a duty, or None if it never expires
    (reference deadline.go:27 NewDutyDeadlineFunc)."""
    if duty.type in _NO_DEADLINE:
        return None
    return spec.slot_start_time(duty.slot + LATE_FACTOR)


DeadlineFunc = Callable[[Duty], float | None]


def new_duty_deadline_func(spec: ChainSpec) -> DeadlineFunc:
    return lambda duty: duty_deadline(spec, duty)


class Deadliner:
    """Emits duties as they expire (reference core/deadline.go:40 Deadliner).

    add(duty) returns False if the duty already expired (callers then drop
    it); expired() yields duties in deadline order as they pass.
    """

    def __init__(self, deadline_func: DeadlineFunc, clock: Callable[[], float] = time.time):
        self._deadline_func = deadline_func
        self._clock = clock
        self._heap: list[tuple[float, Duty]] = []
        self._pending: set[Duty] = set()
        self._wake = asyncio.Event()

    def add(self, duty: Duty) -> bool:
        deadline = self._deadline_func(duty)
        if deadline is None:
            return True  # never expires, nothing to track
        if deadline <= self._clock():
            return False
        if duty not in self._pending:
            self._pending.add(duty)
            heapq.heappush(self._heap, (deadline, duty))
            self._wake.set()
        return True

    async def expired(self) -> AsyncIterator[Duty]:
        """Yield duties as their deadlines pass."""
        while True:
            while not self._heap:
                self._wake.clear()
                await self._wake.wait()
            deadline, duty = self._heap[0]
            delay = deadline - self._clock()
            if delay > 0:
                self._wake.clear()
                # asyncio.wait, not wait_for: on Python 3.10 wait_for can
                # swallow an external cancel that races its timeout (or the
                # event firing), leaving this loop running forever after
                # task.cancel() — which deadlocks stop() paths that gather
                # the gc/trim tasks consuming this iterator.
                waiter = asyncio.ensure_future(self._wake.wait())
                try:
                    done, _ = await asyncio.wait({waiter}, timeout=delay)
                finally:
                    waiter.cancel()
                if done:
                    continue  # new duty added; re-evaluate the head
            heapq.heappop(self._heap)
            self._pending.discard(duty)
            yield duty
