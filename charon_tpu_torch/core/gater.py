"""Duty gater — anti-DoS filter for duties received from peers
(reference core/gater.go:19,36); the port's copy of charon_tpu/core/gater.py.

Rejects duties of invalid type or for slots too far in the future (peers
cannot make us allocate state for arbitrary slots). Allows up to
ALLOWED_FUTURE_EPOCHS ahead of the current slot.
"""

from __future__ import annotations

import time
from typing import Callable

from ..eth2.spec import ChainSpec
from .types import Duty, DutyType

ALLOWED_FUTURE_EPOCHS = 2

DutyGaterFunc = Callable[[Duty], bool]


def new_duty_gater(spec: ChainSpec, clock: Callable[[], float] = time.time) -> DutyGaterFunc:
    def gate(duty: Duty) -> bool:
        if not isinstance(duty.type, DutyType) or not duty.type.valid:
            return False
        if duty.slot < 0:
            return False
        current = spec.slot_at(clock())
        max_slot = current + ALLOWED_FUTURE_EPOCHS * spec.slots_per_epoch
        return duty.slot <= max_slot
    return gate
