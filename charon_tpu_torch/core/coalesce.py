"""Cross-duty batching window for device crypto dispatches: the port's
copy of charon_tpu/core/coalesce.py, over the port's tbls facade.

A device call has a fixed floor (the slot's decompression scans and MSM
launches, the verify's pairing), so one duty of a small cluster (100
validators) pays that floor alone. This window COALESCES concurrent
submissions — the attestation duty and the sync-committee duty of the same
slot, adjacent slots' stragglers, parsigex inbound sets from several peers
— into ONE fused device call. Submissions queue for at most `window`
seconds or until `flush_at` items are pending, whichever comes first, or
until every keyed group's declared contributors have arrived (close on
quorum). The fused call runs off the event loop (the default executor for
the verify; TorchImpl's slot thread behind threshold_aggregate_verify_submit
for the slot), so the loop — and with it the NEXT duty's submission path —
stays live.

A fused call that returns False is attributed per submission: one
per-item verify of the flush (tbls.verify_batch_each), each submission's
verdict the AND of its own items, where the reference re-verifies each
submission with a verify_batch of its own.

A dispatch that raises is bisected to isolate the offending submission,
unless `ops.guard.is_device_error` calls the error device-class (a lost or
faulted card, an allocation failure, a timeout): then the whole flush fails
with it. The port's own classes "build" and "launch" (a kernel that did not
build or did not launch) are not device-class and are bisected like any
other error, as the reference bisects every error it does not call
device-class.

SURVEY §2.4 names this batching window as the design lever; the reference
buffers partials per duty (reference core/parsigdb/memory.go:100-122) and
dispatches per duty to herumi.
"""

from __future__ import annotations

import asyncio
import time

from .. import tbls
from ..utils import aio, faults, log, metrics

_log = log.with_topic("coalesce")

_flush_hist = metrics.histogram(
    "core_coalesce_flush_items", "Items per coalesced device flush",
    ("kind",), buckets=(64, 128, 192, 256, 512, 1024, 2048, 4096))
_wait_hist = metrics.histogram(
    "core_coalesce_wait_seconds", "Submission wait inside the window",
    ("kind",))
_overload_c = metrics.counter(
    "core_coalesce_overload_total",
    "Submissions shed by the backpressure admission check", ("kind",))
_backlog_g = metrics.gauge(
    "core_coalesce_backlog_seconds",
    "Estimated seconds to drain in-flight + queued fused dispatches")


class OverloadedError(RuntimeError):
    """The batching window cannot absorb new work inside its deadline
    budget — either the estimated drain time of in-flight + queued fused
    dispatches exceeds the budget, or the device plane is failing
    dispatches wholesale (consecutive device-class flush failures) and
    admitting more work would only grow an undeliverable backlog.

    Deliberately NOT a CharonError (an input error): overload carries a
    retry hint in `retry_after` (seconds)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = max(0.0, retry_after)


class _Window:
    """One batching window: queues (size, payload, future) submissions and
    flushes them through `dispatch` when `flush_at` items are pending or
    `window` seconds after the first submission. `dispatch(reqs)` runs in
    an asyncio task and must resolve every request's future itself."""

    def __init__(self, kind: str, window: float, flush_at: int | None,
                 dispatch):
        self.kind = kind
        self.window = window
        # None = the default, ops/policy.flush_at_default(), read at every
        # trigger check
        self._flush_at = flush_at
        self._dispatch = dispatch
        self._q: list[tuple[int, object, asyncio.Future]] = []
        self._timer: asyncio.TimerHandle | None = None
        # close-on-quorum state: per-group DISTINCT contributor sets vs the
        # expected contributor count the submitter declared (reference
        # ParSigDB's threshold trigger shape, core/parsigdb/memory.go:100)
        self._seen: dict[object, set] = {}
        self._expected: dict[object, int] = {}
        self._unkeyed = 0

    @property
    def flush_at(self) -> int:
        """The live count trigger: an explicit constructor value wins,
        otherwise ops/policy.flush_at_default() (one chunk of 1,024 per
        device), read per call."""
        if self._flush_at is not None:
            return self._flush_at
        from ..ops import policy as policy_mod

        return policy_mod.flush_at_default()

    @flush_at.setter
    def flush_at(self, value: int | None) -> None:
        self._flush_at = value

    async def submit(self, size: int, payload, key=None,
                     expected: int | None = None, contributor=None):
        """Queue one submission. `key`/`expected`/`contributor` enable
        ADAPTIVE close: when every queued group's declared contributor set
        has fully arrived (e.g. parsigex sets from all n−1 peers for a
        duty), the window flushes immediately instead of waiting out the
        timer — peers arriving over a spread no longer leave the device
        idle for the fixed window, and a straggler is still bounded by the
        timer. Contributors are counted DISTINCT (a duplicate/retransmitted
        set must not trigger a premature flush)."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._q.append((size, payload, fut))
        if key is not None and expected:
            # an anonymous submission still counts once via a unique token
            token = contributor if contributor is not None else object()
            self._seen.setdefault(key, set()).add(token)
            self._expected[key] = expected
        else:
            self._unkeyed += 1
        if (sum(s for s, _, _ in self._q) >= self.flush_at
                or self._quorum_complete()):
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.window, self._flush)
        t0 = loop.time()
        try:
            return await fut
        finally:
            _wait_hist.observe(loop.time() - t0, self.kind)

    def _quorum_complete(self) -> bool:
        """Every queued submission is group-keyed and every group's expected
        contributor set has fully arrived (distinct contributors)."""
        if self._unkeyed or not self._seen:
            return False
        return all(len(self._seen[k]) >= self._expected[k]
                   for k in self._seen)

    def _flush(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        reqs, self._q = self._q, []
        self._seen, self._expected, self._unkeyed = {}, {}, 0
        if reqs:
            # aio.spawn, not ensure_future: the loop only weak-refs tasks,
            # and a GC'd flush would strand every waiter in the window.
            aio.spawn(self._run(reqs), name=f"coalesce-{self.kind}")

    async def _run(self, reqs, fail_budget: list | None = None) -> None:
        _flush_hist.observe(sum(s for s, _, _ in reqs), self.kind)
        futs = [f for _, _, f in reqs]
        if fail_budget is None:
            # A SINGLE bad submission fails at most one dispatch per bisect
            # level — log2(flush_at)+1 of them. More CONSECUTIVE failures
            # than that with no success anywhere means the failure is
            # systemic (device down, every item malformed), and a full
            # bisect tree would serially await up to 2N-1 dispatches at the
            # device floor — far past the slot budget. [remaining,
            # last_exc, initial] is shared across the
            # whole flush's recursion; each SUCCESSFUL dispatch refills the
            # budget (k scattered offenders produce healthy sibling batches
            # between failures, so isolation completes — only a
            # success-free failure streak abandons). Once exhausted,
            # pending subtrees fail in one pass with the last observed
            # exception instead of dispatching at all.
            b0 = max(2, self.flush_at).bit_length() + 1
            fail_budget = [b0, None, b0]
        elif fail_budget[0] <= 0:
            for f in futs:
                _resolve(f, exc=fail_budget[1])
            return
        try:
            await self._dispatch([p for _, p, _ in reqs], futs)
            fail_budget[0] = fail_budget[2]  # success: refill the streak
        except Exception as exc:  # noqa: BLE001 — isolate the offender
            # One malformed submission (e.g. bytes that fail the device
            # parse) must not fail every duty sharing the window. Bisect:
            # healthy halves still run as fused batches, so the offender is
            # isolated in O(log N) dispatches instead of N serial ones —
            # each dispatch has the device floor, so a serial retry of a
            # full window would blow the slot budget.
            from ..ops import guard

            if guard.is_device_error(exc):
                # Device-class failure (lost card, hung fence, failed
                # allocation): systemic by definition — no input item
                # caused it, so bisecting re-dispatches up to 2N-1 times
                # against broken hardware. Fail the whole flush with the
                # classified error; callers see one attributable cause.
                _log.warn("coalesced dispatch hit device-class failure; "
                          "failing flush without bisect",
                          requests=len(reqs), err=exc)
                for f in futs:
                    _resolve(f, exc=exc)
                return
            if len(reqs) == 1:
                _resolve(futs[0], exc=exc)
                return
            fail_budget[0] -= 1
            fail_budget[1] = exc
            if fail_budget[0] <= 0:
                _log.warn(
                    "coalesced dispatch failing systemically; "
                    "abandoning bisect", requests=len(reqs))
                for f in futs:
                    _resolve(f, exc=exc)
                return
            _log.debug("coalesced dispatch raised; bisecting",
                       requests=len(reqs))
            mid = len(reqs) // 2
            await self._run(reqs[:mid], fail_budget)
            await self._run(reqs[mid:], fail_budget)


def _resolve(fut: asyncio.Future, result=None, exc=None) -> None:
    """Set a waiter's outcome, tolerating waiters that went away (deadline
    cancellation cancels the awaited future) — one dead waiter must never
    strand the other requests in the flush."""
    if fut.done():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


class TblsCoalescer:
    """Batches aggregate+verify and bulk-verify submissions across
    concurrent duties into single fused tbls dispatches (module doc)."""

    def __init__(self, window: float = 0.025, flush_at: int | None = None,
                 deadline_budget_s: float | None = 12.0,
                 overload_streak: int = 2,
                 overload_cooldown_s: float = 5.0):
        # An EXPLICIT flush_at always wins, for both windows. The default
        # (flush_at=None, resolved at every trigger check by
        # ops/policy.flush_at_default) is one verify chunk of 1,024 per
        # device: coalescing amortizes the device call's floor until the
        # batch outgrows a chunk, so flushing EARLIER by count would split
        # batches that could have shared one call; the window timer still
        # bounds the latency of batches that never fill.
        self._agg = _Window("agg", window, flush_at, self._dispatch_agg)
        self._ver = _Window("verify", window, flush_at, self._dispatch_ver)
        self.flushes = 0
        self.coalesced_flushes = 0
        # Backpressure admission state (check_admission): estimated drain
        # time of the dispatch backlog vs `deadline_budget_s` (None turns
        # admission off entirely), plus a device-failure fail-fast — after
        # `overload_streak` CONSECUTIVE device-class flush failures new
        # work is shed for `overload_cooldown_s` (half-open style: the
        # first successful dispatch after the cooldown clears the state).
        self._deadline_budget_s = deadline_budget_s
        self.overload_streak = max(1, overload_streak)
        self.overload_cooldown_s = overload_cooldown_s
        self._inflight = 0            # fused dispatches currently running
        self._ewma_s = 0.0            # smoothed wall time per fused dispatch
        self._device_fail_streak = 0  # consecutive device-class failures
        self._overloaded_until = 0.0  # monotonic instant fail-fast expires

    @property
    def deadline_budget_s(self) -> float | None:
        """The live admission budget: a policy-MANAGED value (the
        reference's autotuner shedding under a spike) overrides the constructor/
        assigned value; an unmanaged policy (deadline_budget_s=None)
        leaves the local value — including admission-off None — alone."""
        from ..ops import policy as policy_mod

        managed = policy_mod.deadline_budget_override()
        return managed if managed is not None else self._deadline_budget_s

    @deadline_budget_s.setter
    def deadline_budget_s(self, value: float | None) -> None:
        self._deadline_budget_s = value

    # ---- public API ------------------------------------------------------

    async def aggregate_verify(self, batches, pks, roots):
        """Queue one duty's (batches, pks, signing roots); resolves to
        (agg_sigs, ok) for exactly this submission once a window flushes.
        ok=False means at least one of THIS submission's aggregates failed
        (per-request re-verify attributes fused-batch failures). Sheds
        with OverloadedError when admission fails (check_admission)."""
        self.check_admission("agg")
        return await self._agg.submit(
            len(batches), (list(batches), list(pks), list(roots)))

    async def verify(self, pks, roots, sigs, key=None,
                     expected: int | None = None, contributor=None) -> bool:
        """Queue one bulk verify (the parsigex inbound path); resolves to
        the validity of exactly this submission's set. key/expected/
        contributor declare the duty's contributor group for adaptive
        close-on-quorum (_Window.submit). Sheds with OverloadedError when
        admission fails (check_admission)."""
        self.check_admission("verify")
        return await self._ver.submit(
            len(sigs), (list(pks), list(roots), list(sigs)),
            key=key, expected=expected, contributor=contributor)

    # ---- backpressure admission ------------------------------------------

    def backlog_seconds(self) -> float:
        """Estimated seconds to drain the current dispatch backlog: fused
        dispatches in flight plus windows with queued submissions, each
        costed at the smoothed dispatch wall time. 0.0 until the first
        dispatch completes (no estimate beats a wrong fail-closed)."""
        queued = (1 if self._agg._q else 0) + (1 if self._ver._q else 0)
        est = (self._inflight + queued) * self._ewma_s
        _backlog_g.set(est)
        return est

    def check_admission(self, kind: str = "submit") -> None:
        """Raise OverloadedError when new work cannot plausibly complete
        inside the deadline budget. The submit paths above call it, so
        in-process callers — parsigex inbound sets, sigagg — shed instead of
        growing the backlog."""
        if self.deadline_budget_s is None:
            return
        now = time.monotonic()
        if now < self._overloaded_until:
            _overload_c.inc(kind)
            raise OverloadedError(
                f"device plane shedding load: {self._device_fail_streak} "
                "consecutive device-class dispatch failures",
                retry_after=self._overloaded_until - now)
        est = self.backlog_seconds()
        if est > self.deadline_budget_s:
            _overload_c.inc(kind)
            raise OverloadedError(
                f"dispatch backlog {est:.2f}s exceeds the "
                f"{self.deadline_budget_s:.1f}s deadline budget",
                retry_after=min(est, 30.0))

    # ---- fused dispatches ------------------------------------------------

    def _note_flush(self, n_reqs: int) -> None:
        self.flushes += 1
        if n_reqs > 1:
            self.coalesced_flushes += 1

    async def _tracked(self, inner, payloads, futs) -> None:
        """Account one fused dispatch for admission: in-flight count, EWMA
        wall time, and the device-class failure streak that arms the
        fail-fast. The sigagg.pack fault site fires here too: the
        coalescer's fused dispatch is the entry into the slot."""
        from ..ops import guard

        self._inflight += 1
        t0 = time.monotonic()
        try:
            faults.check("sigagg.pack")
            await inner(payloads, futs)
        except Exception as exc:
            if guard.is_device_error(exc):
                self._device_fail_streak += 1
                if self._device_fail_streak >= self.overload_streak:
                    self._overloaded_until = (
                        time.monotonic() + self.overload_cooldown_s)
            raise
        else:
            dt = time.monotonic() - t0
            self._ewma_s = (dt if self._ewma_s == 0.0
                            else 0.8 * self._ewma_s + 0.2 * dt)
            self._device_fail_streak = 0
            self._overloaded_until = 0.0
        finally:
            self._inflight -= 1
            _backlog_g.set(self._inflight * self._ewma_s)

    async def _dispatch_agg(self, payloads, futs) -> None:
        await self._tracked(self._dispatch_agg_inner, payloads, futs)

    async def _dispatch_ver(self, payloads, futs) -> None:
        await self._tracked(self._dispatch_ver_inner, payloads, futs)

    async def _dispatch_agg_inner(self, payloads, futs) -> None:
        loop = asyncio.get_running_loop()
        self._note_flush(len(payloads))
        batches = [b for p in payloads for b in p[0]]
        pks = [k for p in payloads for k in p[1]]
        roots = [r for p in payloads for r in p[2]]
        # the SUBMIT facade: the executor hop covers only the submit —
        # TorchImpl.threshold_aggregate_verify_submit queues the slot on
        # the device's slot thread and returns its Future at once, and the
        # slot thread resolves it. The default-executor thread is back in
        # the pool while the slot runs.
        pipe_fut = await loop.run_in_executor(
            None, tbls.threshold_aggregate_verify_submit,
            batches, pks, roots)
        sigs, ok = await asyncio.wrap_future(pipe_fut)
        off = 0
        slices = []
        for p in payloads:
            n = len(p[0])
            slices.append(sigs[off:off + n])
            off += n
        if ok:
            for f, s in zip(futs, slices):
                _resolve(f, (s, True))
            return
        # attribution: the fused batch failed somewhere — one per-item
        # verify of the whole flush, so only the offending request(s) see
        # ok=False
        _log.debug("coalesced aggregate batch failed; attributing",
                   requests=len(payloads), items=len(batches))
        oks = await self._attribute(loop, [p[1] for p in payloads],
                                    [p[2] for p in payloads], slices)
        for f, s, r_ok in zip(futs, slices, oks):
            _resolve(f, (s, r_ok))

    async def _dispatch_ver_inner(self, payloads, futs) -> None:
        loop = asyncio.get_running_loop()
        self._note_flush(len(payloads))
        pks = [k for p in payloads for k in p[0]]
        roots = [r for p in payloads for r in p[1]]
        sigs = [s for p in payloads for s in p[2]]
        ok = await loop.run_in_executor(
            None, tbls.verify_batch, pks, roots, sigs)
        if ok:
            for f in futs:
                _resolve(f, True)
            return
        oks = await self._attribute(loop, *([p[c] for p in payloads]
                                            for c in range(3)))
        for f, r_ok in zip(futs, oks):
            _resolve(f, r_ok)

    @staticmethod
    async def _attribute(loop, pks, roots, sigs) -> list[bool]:
        """A failed flush's verdicts per request (pks, roots and sigs hold
        each request's list): ONE tbls.verify_batch_each over the flush's
        items (on a TorchImpl one device call), each request's verdict the
        AND of its slice. The reference re-runs verify_batch a request, one
        after another; the verdicts are the same."""
        each = await loop.run_in_executor(
            None, tbls.verify_batch_each, [k for p in pks for k in p],
            [r for p in roots for r in p], [s for p in sigs for s in p])
        out, off = [], 0
        for p in pks:
            out.append(bool(all(each[off:off + len(p)])))
            off += len(p)
        return out
