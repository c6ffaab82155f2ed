"""The guard around the port's device plane, the port's copy of
charon_tpu/ops/guard.py on one device.

The device is the fast path, and the only one that can fail for reasons
that are not the inputs': a lost or faulted card, an allocation that
fails, a fence that never returns. The guard
keeps such a failure from costing a duty: the slot lands on the native
rung, which gives the same bytes and the same verdict.

**Classification** (`classify`): a ValueError is an *input* error (a bad
encoding, an invalid point, a length mismatch): no rung can change it and
it propagates. A *device-class* failure is "device_lost" (DEVICE_ERRORS:
the injected `faults.DeviceLostFault`, `torch.AcceleratorError` of a lost
or faulted context and `torch.cuda.OutOfMemoryError`) or "timeout"
(`TimeoutError`); `is_device_error` also walks the `cause` / `__cause__`
chain. A failed kernel build (`subprocess.CalledProcessError` of nvcc or of
the native library's make) is "build", a kernel that did not launch
(`cuda_plane.DeviceError`: an invalid configuration, too many resources,
no image for the card) is "launch", and anything else is "error". Three
deliberate differences from the reference, which retries "error" (and with
it a failed build or launch): in the port only device-class failures land
on the native rung; "build", "launch" and "error" propagate from every
rung, so that neither a kernel that fails to build or to launch nor a bug
in one leaves the port quietly on the CPU.

**The ladder** (`finish_slot`): on one device the reference's ladder goes
straight to the native rung (its widths D/2 ... 1 are empty at D = 1), and
so does the port's: `native.native_slot_fallback`, Lagrange coefficients
and ct_lincomb_g2 a validator, then ct_verify_batch. Every landing adds one
to FALLBACKS[(reason, "native")] and is logged.

**The circuit breaker** (`CircuitBreaker`): `threshold` consecutive
device-class slot failures open it, and then every slot goes to the native
rung with no launch (`allow_device_dispatch`, asked by
plane_agg.dispatch_slot) until `cooldown` seconds have passed; then one
probe slot may try the device: its success closes the breaker, its failure
opens it again; a probe that ends in neither (an input error, a bug)
proves nothing about the device and is released (`release_probe`), so
that the next slot probes again. The state is `BREAKER.state`: 0 closed,
1 half-open, 2 open.

The slot watchdog (TorchImpl.threshold_aggregate_verify_submit) hands a
submitted slot whose deadline expired to `watchdog_recover`, and the
verify and the ceremony note their own native landings
(`note_verify_fallback`, `note_ceremony_fallback`).

The fallbacks apply while `fallback_enabled()`: TorchImpl turns them off
for its calls with `fallback(False)` (its `fallback_on_device_error`), and
then every device-class error raises. The counters are plain locked
counters of this module (`counters()`), not the reference's metrics
registry.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import logging
import os
import subprocess
import threading
import time

import torch

from ..utils import faults
from . import cuda_plane as CP
from . import policy as policy_mod

_log = logging.getLogger(__name__)

SLOT_DEADLINE_ENV = policy_mod.ENV_SLOT_DEADLINE

CLOSED, HALF_OPEN, OPEN = 0.0, 1.0, 2.0

# exception classes that mean the device failed, not the inputs (not
# cuda_plane.DeviceError: a launch that the runtime refused is a defect of
# the port's kernels or their build, "launch")
DEVICE_ERRORS = (faults.DeviceLostFault, TimeoutError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())

_counts_lock = threading.Lock()
# slots (and verifies, ceremony checks and TorchImpl calls) landed off the
# device, by (reason, target): the reference's ops_sigagg_fallback_total
FALLBACKS: collections.Counter = collections.Counter()
# submitted slots whose watchdog deadline expired: ops_sigagg_watchdog_total
_watchdog = 0

_fallback_var = contextvars.ContextVar("charon_tpu_torch_guard_fallback", default=True)


def fallback_enabled() -> bool:
    """May a device-class failure land on the native rung here?"""
    return _fallback_var.get()


@contextlib.contextmanager
def fallback(enabled: bool):
    """Turn the native landings on or off for the calls in this block (on
    this thread)."""
    token = _fallback_var.set(bool(enabled))
    try:
        yield
    finally:
        _fallback_var.reset(token)


def classify(exc: BaseException) -> str:
    """The failure taxonomy: "input" (a ValueError: it propagates),
    "timeout", "device_lost" (DEVICE_ERRORS), "build" (a failed kernel or
    native library build), "launch" (a kernel that did not launch) or
    "error" (anything else)."""
    if isinstance(exc, ValueError):
        return "input"
    if isinstance(exc, TimeoutError):
        return "timeout"
    if isinstance(exc, DEVICE_ERRORS):
        return "device_lost"
    if isinstance(exc, subprocess.SubprocessError):
        return "build"
    if isinstance(exc, CP.DeviceError):
        return "launch"
    return "error"


def device_reason(exc: BaseException) -> str | None:
    """The class of the first device-class failure on exc's cause chain
    ("device_lost" or "timeout"), or None."""
    seen: set[int] = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        reason = classify(cur)
        if reason in ("device_lost", "timeout"):
            return reason
        nxt = getattr(cur, "cause", None)
        cur = nxt if isinstance(nxt, BaseException) else cur.__cause__
    return None


def is_device_error(exc: BaseException) -> bool:
    """True when exc, or anything on its `cause` / `__cause__` chain, is a
    device-class failure: systemic, not the fault of any input."""
    return device_reason(exc) is not None


def slot_deadline_default() -> float:
    """The submitted slot's watchdog deadline in seconds; 0 disables it."""
    return policy_mod.slot_deadline_default()


class CircuitBreaker:
    """Consecutive-failure breaker over the whole device plane.

    closed --(threshold consecutive slot failures)--> open
    open --(cooldown elapsed)--> half-open (one probe slot allowed)
    half-open --probe succeeds--> closed / --probe fails--> open
    """

    def __init__(self, threshold: int | None = None, cooldown: float | None = None) -> None:
        self._threshold = max(1, threshold if threshold is not None
                              else policy_mod.breaker_threshold_default())
        self._cooldown = max(0.0, cooldown if cooldown is not None
                             else policy_mod.breaker_cooldown_default())
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> float:
        with self._lock:
            return self._state

    def allow_device(self) -> bool:
        """May the next slot touch the device? Open turns half-open once the
        cooldown has passed; half-open admits one probe slot in flight."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and time.monotonic() - self._opened_at >= self._cooldown:
                self._state = HALF_OPEN
                self._probing = False
                _log.info("plane breaker half-open; probing the device path")
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self._state != CLOSED:
                self._state = CLOSED
                _log.info("plane breaker closed; device path restored")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or self._consecutive >= self._threshold:
                if self._state != OPEN:
                    _log.warning("plane breaker OPEN after %d consecutive failures; slots go "
                                 "native for %.1f s", self._consecutive, self._cooldown)
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._probing = False

    def release_probe(self) -> None:
        """The probe in flight ended in neither a success nor a device
        failure (an input error, a bug): it proved nothing, so the breaker
        stays half-open and admits the next slot as its probe. No-op in any
        other state."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probing = False


BREAKER = CircuitBreaker()


def configure(threshold: int | None = None, cooldown: float | None = None,
              slot_deadline: float | None = None) -> None:
    """Set the breaker's shape (a new BREAKER) and the watchdog deadline;
    None keeps that knob's environment or default value."""
    global BREAKER
    if threshold is not None or cooldown is not None:
        BREAKER = CircuitBreaker(threshold=threshold, cooldown=cooldown)
    if slot_deadline is not None:
        os.environ[SLOT_DEADLINE_ENV] = str(float(slot_deadline))


def reset_for_testing() -> None:
    """A fresh breaker from the environment and every counter at 0."""
    global BREAKER, _watchdog
    BREAKER = CircuitBreaker()
    with _counts_lock:
        FALLBACKS.clear()
        _watchdog = 0


def allow_device_dispatch() -> bool:
    """plane_agg.dispatch_slot's breaker gate: False sends the slot to the
    native rung with no device work."""
    return BREAKER.allow_device()


def counters() -> dict:
    """A snapshot: {"fallback": {(reason, target): n}, "watchdog": n,
    "breaker": state}."""
    with _counts_lock:
        return {"fallback": dict(FALLBACKS), "watchdog": _watchdog, "breaker": BREAKER.state}


def fallback_total(reason: str, target: str = "native") -> int:
    with _counts_lock:
        return FALLBACKS[reason, target]


def watchdog_total() -> int:
    with _counts_lock:
        return _watchdog


def _landed(reason: str, target: str = "native") -> None:
    with _counts_lock:
        FALLBACKS[reason, target] += 1


def _expired() -> None:
    global _watchdog
    with _counts_lock:
        _watchdog += 1


def finish_slot(state, inputs, finish, hash_fn=None):
    """Complete one dispatched slot, landing on the native rung on a
    device-class failure. `state` is plane_agg.dispatch_slot's:
    ("native_slot",) when the breaker was open, ("dispatch_failed", exc)
    when the dispatch failed device-class, else the pending state that
    `finish(state)` reads back, emits and verifies. `inputs` is the
    (batches, pks, msgs) of the slot, kept for the native rung. Input
    errors, build failures and other errors propagate unchanged, and so
    does every error outside fallback_enabled()."""
    if not fallback_enabled():
        return finish(state)
    tag = state[0]
    if tag == "native_slot":
        _landed("breaker_open")
        _log.warning("slot routed native: breaker open")
        return _native_rung(inputs, hash_fn)
    if tag == "dispatch_failed":
        exc = state[1]
        BREAKER.record_failure()
        _log.warning("slot dispatch failed on the device: %r", exc)
        return _run_ladder(inputs, hash_fn, device_reason(exc), exc)
    try:
        out = finish(state)
    except Exception as exc:
        reason = device_reason(exc)
        if reason is None:
            BREAKER.release_probe()
            raise
        BREAKER.record_failure()
        _log.warning("slot failed on the device: %r", exc)
        return _run_ladder(inputs, hash_fn, reason, exc)
    BREAKER.record_success()
    return out


def watchdog_recover(inputs, hash_fn=None):
    """A submitted slot's deadline expired: its fence is hung. The stuck
    slot is abandoned (nothing can safely interrupt a CUDA wait) and the
    slot runs again on the native rung, counted as "watchdog_timeout"."""
    _expired()
    BREAKER.record_failure()
    _log.error("slot watchdog deadline expired; recovering on the native rung")
    return _run_ladder(inputs, hash_fn, "watchdog_timeout",
                       TimeoutError("sigagg slot watchdog deadline expired"))


def note_watchdog_expiry() -> None:
    """A submitted slot's deadline expired where no native landing is
    allowed: counted; the slot's Future gets a TimeoutError."""
    _expired()
    _log.error("slot watchdog deadline expired; no fallback, the slot raises")


def note_ceremony_fallback(reason: str, exc: BaseException | None = None) -> None:
    """A ceremony device path (frost.msm, or the batched keygen) failed
    device-class and its caller degrades to the native path: feeds the
    breaker and FALLBACKS, as a slot's landing does."""
    BREAKER.record_failure()
    _landed(reason)
    _log.warning("ceremony device path degraded to native (%s): %r", reason, exc)


def note_verify_fallback(reason: str, exc: BaseException | None = None) -> None:
    """The slot's (or the bulk verify's) device pairing check failed
    device-class and the caller re-runs the same verdict through native
    ct_pairing_check: feeds the breaker and FALLBACKS."""
    BREAKER.record_failure()
    _landed(reason)
    _log.warning("pairing verify degraded to the native rung (%s): %r", reason, exc)


def note_call_fallback(op: str, exc: BaseException) -> None:
    """A TorchImpl call (`op`) caught a device-class error that no rung
    below it absorbed and answers from the native library: counted."""
    _landed(device_reason(exc))
    _log.warning("%s: device failed; native fallback: %r", op, exc)


def _run_ladder(inputs, hash_fn, reason, first_exc):
    """The single-device ladder: the native rung, counted. Its input errors
    raise as they are; any other failure raises chained to the device's."""
    _landed(reason)
    _log.warning("slot degraded to the native rung (%s)", reason)
    try:
        return _native_rung(inputs, hash_fn)
    except Exception as exc:
        if classify(exc) in ("input", "build", "launch"):
            raise
        raise exc from first_exc


def _native_rung(inputs, hash_fn):
    if hash_fn is not None:
        # the native rung computes the standard hash to G2 and must not
        # silently diverge from a custom one
        raise RuntimeError("native fallback cannot honor a custom hash_fn")
    from .. import native

    batches, pks, msgs = inputs
    return native.native_slot_fallback(batches, pks, msgs)
