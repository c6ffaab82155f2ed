"""TorchImpl: the port as a whole tbls backend, behind the same seam as the
reference's TPUImpl (charon_tpu/tbls/tpu_impl.py:100-332):

    from charon_tpu import tbls
    tbls.set_implementation(TorchImpl())        # cuda:0

It has every method of the `charon_tpu.tbls.Implementation` protocol, and
`threshold_aggregate_verify_overlapped`, `threshold_aggregate_verify_submit`,
`pin_pubkeys` and `verify_batch_each`, which the facade and the duty
pipeline reach:

  * threshold_aggregate(_batch), threshold_aggregate_verify_batch: the
    fused slot (ops/plane_agg.py) on the device.
  * verify_batch: the bulk RLC verify of (pk, msg, sig) triples
    (plane_agg.rlc_verify_batch: chunks of 1,024 on the device, the G2
    subgroup check included, then the pairing on the impl's rung), run on
    the device's slot thread in order with the slots and verifies queued
    there before it: the coalescer calls it from executor threads, and
    device work on two threads at once shares the interpreter lock and
    the stream, each part taking several times as long as alone.
  * threshold_aggregate_verify_submit / _overlapped: the serial fused slot
    run whole on the device's slot thread (`slot_thread`), so the caller (the
    duty pipeline's event loop) is free while it runs. The reference's
    SigAggPipeline, which overlaps one slot's pack with another's finish, is
    not ported: the port's slot is host-bound, and two slots' host work at
    once share the interpreter lock and lose to one after another.
  * verify_batch_each: per-triple verdicts, the attribution after a failed
    batch (the coalescer's), in ONE device call on the slot thread
    (plane_agg.verify_each: each triple's pairing on its own lane, the final
    exponentiations batched), where the reference's TPUImpl runs native
    ct_verify an item; the same verdicts.
  * pin_pubkeys: pins the set's planes in this impl's pk-plane cache.
  * key material (generate_secret_key, threshold_split, recover_secret over
    Fr; secret_to_public_key, sign, verify, aggregate, verify_aggregate):
    the native library through the port's loader, as the reference's calls
    go to NativeImpl.

Every batch size goes to the device: there is no small-batch routing. The
device is explicit. `TorchImpl()` runs on cuda:0 and raises when CUDA is
absent; only `TorchImpl(device="cpu")` selects the plain versions of the
kernels, which is what the CPU tests pass.

The slot and the bulk verify check their pairings on the device by default
(`verify="device"`: H(m) and the multi-pairing on the rows kernels, as the
reference's default device verify); `verify="native"` selects the native
ct_pairing_check rung explicitly. The rung is the attribute `rung`
(`verify` is the protocol's method).

A device error (ops/guard.py: a lost or faulted card, an allocation that
failed, a timeout) lands on the native rung, with the
same bytes and verdicts, as in the reference: the slot through the guard
(the plane breaker, the native slot rung), the device pairing check through
its verify fallback, and, as the belt of the calls with no guard below
them, threshold_aggregate_batch and verify_batch answer natively when a
device-class error reaches them, and verify_batch_each, behind the
verify's breaker gate, does too (`fallback_on_device_error`, default True,
as TPUImpl's). Set it False and every device-class error raises instead,
through the call or the Future. Input errors (ValueError), a kernel that
failed to build or to launch and any other error always raise. A
submitted slot has a watchdog: past `CHARON_TPU_SLOT_DEADLINE_S` (600 s; 0
disables it) its Future resolves from the native rung (or, with the
fallback off, with a TimeoutError), the late result is dropped, and the
device's slot thread is replaced so that later slots do not queue behind
the hung one.
"""

from __future__ import annotations

import concurrent.futures as futures
import heapq
import itertools
import threading
import time

import numpy as np
import torch

from .. import native
from ..ops import guard
from ..ops import plane_agg as PA
from ..ops import policy as policy_mod
from .scalar import FrScalarOps
from .types import PrivateKey, PublicKey, Signature

_SLOT_THREADS: dict[str, futures.ThreadPoolExecutor] = {}
_SLOT_THREADS_LOCK = threading.Lock()


def _thread_prefix(device) -> str:
    return f"sigagg-slot-{torch.device(device)}"


def slot_thread(device) -> futures.ThreadPoolExecutor:
    """The device's slot thread, shared by every TorchImpl on it: submitted
    slots and bulk verifies run on it one at a time, in submission order."""
    key = str(torch.device(device))
    with _SLOT_THREADS_LOCK:
        pool = _SLOT_THREADS.get(key)
        if pool is None:
            pool = _SLOT_THREADS[key] = futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=_thread_prefix(key))
        return pool


def replace_slot_thread(device, hung: futures.ThreadPoolExecutor) -> None:
    """After a watchdog expiry: give the device a fresh slot thread, unless
    `hung` was replaced already. The slots and verifies queued behind the
    hung one are cancelled there and run again on the new thread (the
    slots by their watchdogs, the verifies by TorchImpl._on_slot_thread)."""
    key = str(torch.device(device))
    with _SLOT_THREADS_LOCK:
        if _SLOT_THREADS.get(key) is not hung:
            return
        _SLOT_THREADS[key] = futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=_thread_prefix(key))
    hung.shutdown(wait=False, cancel_futures=True)


class _Alarms:
    """The submitted slots' watchdogs on one daemon thread: each armed
    alarm fires at its deadline unless it was cancelled first. Arming one
    starts no thread, and wakes the alarm thread only when the new alarm is
    the earliest: a thread that a submit starts or wakes takes the
    interpreter lock from the submitting thread, which then waits for it
    behind the running slot. An alarm that fires runs its function on a
    thread of its own, so that one recovery holds up no other deadline."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = itertools.count()
        self._thread: threading.Thread | None = None

    def arm(self, delay: float, fn) -> threading.Event:
        """Run fn `delay` seconds from now unless the returned Event is set
        before."""
        cancelled = threading.Event()
        with self._cv:
            heapq.heappush(self._heap, (time.monotonic() + delay, next(self._seq), fn,
                                        cancelled))
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="sigagg-watchdog",
                                                daemon=True)
                self._thread.start()
            elif self._heap[0][3] is cancelled:
                self._cv.notify()
        return cancelled

    def _run(self) -> None:
        with self._cv:
            while True:
                if not self._heap:
                    self._cv.wait()
                    continue
                when, _n, fn, cancelled = self._heap[0]
                left = when - time.monotonic()
                if left > 0 and not cancelled.is_set():
                    self._cv.wait(left)
                    continue
                heapq.heappop(self._heap)
                if not cancelled.is_set():
                    threading.Thread(target=fn, name="sigagg-watchdog-expiry",
                                     daemon=True).start()


_ALARMS = _Alarms()


class TorchImpl(FrScalarOps):
    """tbls implementation running the device work on one CUDA device."""

    name = "torch-cuda"
    # False: a device-class error raises instead of landing natively
    # (chip_smoke.py's phases 1-8, as the reference's benches)
    fallback_on_device_error = True

    def __init__(self, device: str | torch.device | None = None, verify: str = "device"):
        if verify not in PA.VERIFY_PATHS:
            raise ValueError(f"verify must be one of {PA.VERIFY_PATHS}, got {verify!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TorchImpl needs a CUDA device; pass device='cpu' "
                                   "for the plain CPU path")
            device = "cuda:0"
        self.device = torch.device(device)
        self.pk_cache = PA.PkPlaneCache()
        self.rung = verify          # the verify rung; `verify` is the protocol's method
        self.h2c = PA.H2CCache(policy_mod.h2c_cache_cap_default())
        # pairs checked per rung (the reference's ops_pairing_total{path})
        self.pairing_path: dict[str, int] = {p: 0 for p in PA.VERIFY_PATHS}
        self.last_times = PA.SlotTimes()

    @staticmethod
    def _raw(batches) -> list[dict[int, bytes]]:
        for b in batches:
            if not b:
                raise ValueError("no partial signatures to aggregate")
        return [{i: bytes(s) for i, s in b.items()} for b in batches]

    @staticmethod
    def _check_lengths(*lists) -> None:
        if len({len(x) for x in lists}) != 1:
            raise ValueError("length mismatch")

    # -- key material: Fr from FrScalarOps, curve work native -------------

    def secret_to_public_key(self, secret: PrivateKey) -> PublicKey:
        self._scalar(secret)
        return PublicKey(native.pubkey(bytes(secret)))

    def sign(self, private_key: PrivateKey, data: bytes) -> Signature:
        self._scalar(private_key)
        return Signature(native.sign(bytes(private_key), data))

    def verify(self, public_key: PublicKey, data: bytes, signature: Signature) -> bool:
        return native.verify(bytes(public_key), data, bytes(signature))

    def aggregate(self, sigs: list[Signature]) -> Signature:
        if not sigs:
            raise ValueError("no signatures to aggregate")
        out = native.aggregate_g2([bytes(s) for s in sigs])
        if out is None:
            raise ValueError("invalid signature encoding")
        return Signature(out)

    def verify_aggregate(self, public_keys: list[PublicKey], data: bytes,
                         signature: Signature) -> bool:
        """FastAggregateVerify: all keys signed the same message."""
        if not public_keys:
            return False
        pk = native.aggregate_g1([bytes(p) for p in public_keys])
        return pk is not None and self.verify(PublicKey(pk), data, signature)

    # -- the device paths -------------------------------------------------

    def threshold_aggregate(self, partial_sigs: dict[int, Signature]) -> Signature:
        return self.threshold_aggregate_batch([partial_sigs])[0]

    def _lands_native(self, op: str, exc: BaseException) -> bool:
        """The belt: may `op` answer natively after `exc`? Only a
        device-class error with the fallback on, and the landing is
        counted."""
        if not (self.fallback_on_device_error and guard.is_device_error(exc)):
            return False
        guard.note_call_fallback(op, exc)
        return True

    def threshold_aggregate_batch(self, batches: list[dict[int, Signature]]) -> list[Signature]:
        if not batches:
            return []
        raw = self._raw(batches)
        try:
            with guard.fallback(self.fallback_on_device_error):
                out = PA.aggregate(PA.layout_slots(raw), self.device)
        except Exception as exc:
            if not self._lands_native("threshold_aggregate_batch", exc):
                raise
            out = native.threshold_aggregate(raw)
        return [Signature(r) for r in out]

    def verify_batch(self, public_keys: list[PublicKey], datas: list[bytes],
                     signatures: list[Signature]) -> bool:
        """All-or-nothing RLC batch verify on the device for every n >= 1
        (n = 0 is True): a False means at least one bad triple, including
        a bad encoding, an infinity or an out-of-subgroup point. The device
        part runs on the device's slot thread, after the slots and verifies
        queued before it."""
        self._check_lengths(public_keys, datas, signatures)
        pks, msgs, sigs = ([bytes(x) for x in xs] for xs in (public_keys, datas, signatures))
        try:
            return self._on_slot_thread(self._verify_device, pks, msgs, sigs)
        except Exception as exc:
            if not self._lands_native("verify_batch", exc):
                raise
        return native.verify_batch_chunked(pks, msgs, sigs)

    def verify_batch_each(self, public_keys: list[PublicKey], datas: list[bytes],
                          signatures: list[Signature]) -> np.ndarray:
        """Per-item validity, the attribution after a failed batch: native
        ct_verify's verdict for each triple (a bad encoding, an infinity or
        an out-of-subgroup point False in its own item), from one device
        call (plane_agg.verify_each) on the device's slot thread, after the
        work queued there. Guarded as the verify's pairing check is: with
        the fallback on, an open breaker answers natively item by item, and
        so does a device-class error of the call, counted
        (guard.note_verify_fallback); any other error raises. The native
        rung (`rung == "native"`) answers natively item by item."""
        self._check_lengths(public_keys, datas, signatures)
        pks, msgs, sigs = ([bytes(x) for x in xs] for xs in (public_keys, datas, signatures))
        guarded = self.fallback_on_device_error
        if self.rung == "device" and not (guarded and guard.BREAKER.state == guard.OPEN):
            try:
                return self._on_slot_thread(PA.verify_each, pks, msgs, sigs, self.device,
                                            self.pk_cache, self.h2c)
            except Exception as exc:
                reason = guard.device_reason(exc)
                if not guarded or reason is None:
                    raise
                guard.note_verify_fallback(reason, exc)
        return np.asarray([native.verify(pk, d, s) for pk, d, s in zip(pks, msgs, sigs)],
                          dtype=bool)

    def _verify_device(self, pks, msgs, sigs) -> bool:
        with guard.fallback(self.fallback_on_device_error):
            return PA.rlc_verify_batch(pks, msgs, sigs, self.device, self.pk_cache, self.h2c,
                                       self.pairing_path, self.rung)

    def _on_slot_thread(self, fn, *args):
        """fn(*args) on the device's slot thread, after the work queued there
        before it (inline when called there). A watchdog that replaces the
        thread cancels what queued behind the hung slot: that runs again on
        the new thread."""
        if threading.current_thread().name.startswith(_thread_prefix(self.device) + "_"):
            return fn(*args)
        while True:
            pool, fut = self._queue(fn, args)
            try:
                return fut.result()
            except futures.CancelledError:
                if slot_thread(self.device) is pool:
                    raise

    def threshold_aggregate_verify_batch(self, batches, public_keys, datas):
        """Fused slot: the aggregates plus one RLC verdict over all of them,
        through the guard (PA.threshold_aggregate_and_verify lands its own
        device-class failures while the fallback is on)."""
        self._check_lengths(batches, public_keys, datas)
        with guard.fallback(self.fallback_on_device_error):
            raw, ok = PA.threshold_aggregate_and_verify(
                self._raw(batches), [bytes(pk) for pk in public_keys],
                [bytes(d) for d in datas], self.device, self.pk_cache, self.h2c,
                self.pairing_path, times=self.last_times, verify=self.rung)
        return [Signature(r) for r in raw], ok

    def threshold_aggregate_verify_overlapped(self, batches, public_keys, datas):
        """threshold_aggregate_verify_batch on the device's slot thread, in
        order with the slots submitted before it."""
        return self.threshold_aggregate_verify_submit(batches, public_keys, datas).result()

    def threshold_aggregate_verify_submit(self, batches, public_keys, datas) -> futures.Future:
        """Queue threshold_aggregate_verify_batch on the device's slot thread
        and return its Future of (aggregates, ok) at once. Every error,
        input validation included, arrives through the Future. With a
        watchdog deadline (guard.slot_deadline_default(), read here; 0
        disables it) the Future is the first to settle of the slot and
        the watchdog (the reference's SigAggPipeline._watchdog_wrap)."""
        args = (batches, public_keys, datas)
        deadline = guard.slot_deadline_default()
        if not deadline:
            return self._queue(self.threshold_aggregate_verify_batch, args)[1]
        return self._watched(args, deadline)

    def _queue(self, fn, args) -> tuple:
        """(the slot thread, fn's Future): fn(*args) queued on the device's
        current slot thread, again on its successor if a watchdog replaced
        it in between."""
        pool = slot_thread(self.device)
        try:
            return pool, pool.submit(fn, *args)
        except RuntimeError:
            if slot_thread(self.device) is pool:    # not replaced: the interpreter is exiting
                raise
            return self._queue(fn, args)

    def _watched(self, args, deadline: float) -> futures.Future:
        """The slot on the device's slot thread under an alarm (_ALARMS) of
        `deadline` seconds, armed now. The slot's result settles the
        returned Future if it comes first. Otherwise the alarm replaces the
        slot thread (replace_slot_thread) and settles it from the native
        rung (guard.watchdog_recover; with the fallback off, a TimeoutError)
        and the slot's late result is dropped. A slot cancelled while it
        queued behind a hung one runs again on the new slot thread."""
        out: futures.Future = futures.Future()
        out.set_running_or_notify_cancel()
        lock = threading.Lock()
        pools, expired = [], threading.Event()

        def settle(value=None, exc=None) -> bool:
            with lock:
                if out.done():
                    return False
                if exc is not None:
                    out.set_exception(exc)
                else:
                    out.set_result(value)
                return True

        def submit() -> None:
            pool, fut = self._queue(self.threshold_aggregate_verify_batch, args)
            pools.append(pool)
            fut.add_done_callback(done)

        def done(fut: futures.Future) -> None:
            if fut.cancelled():
                if not expired.is_set():
                    submit()
                return
            alarm.set()
            exc = fut.exception()
            settle(None if exc is not None else fut.result(), exc)

        def expire() -> None:
            if out.done():
                return
            expired.set()
            if pools:
                replace_slot_thread(self.device, pools[-1])
            if not self.fallback_on_device_error:
                guard.note_watchdog_expiry()
                settle(exc=TimeoutError("sigagg slot watchdog deadline expired"))
                return
            try:
                self._check_lengths(*args)
                raw, ok = guard.watchdog_recover(
                    (self._raw(args[0]), [bytes(pk) for pk in args[1]],
                     [bytes(d) for d in args[2]]))
            except BaseException as exc:  # noqa: BLE001 — the Future carries it
                settle(exc=exc)
            else:
                settle(([Signature(r) for r in raw], ok))

        alarm = _ALARMS.arm(deadline, expire)
        try:
            submit()
        except BaseException:
            alarm.set()
            raise
        return out

    def pin_pubkeys(self, public_keys) -> None:
        """Keep this set's pk planes (every span, bucket and device) through
        any cache pressure: the cluster's own share and root sets."""
        self.pk_cache.pin([bytes(pk) for pk in public_keys])
