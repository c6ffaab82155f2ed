"""The cross-duty coalescer (core/coalesce.py) of both packages on the
scenarios of tests/test_coalesce.py, each behind its own package's tbls
facade with a counting backend, plus the port's own: its policy accessors
(ops/policy.py), a device-class error of the port's guard failing a
flush without a bisect, the flushes' verifies queueing on the device, and
a failed flush attributed in one verify_batch_each call (the reference
re-verifies each submission) with the reference's outcomes on natively
signed triples."""

import asyncio
import threading
import time

import pytest

from charon_tpu import tbls as ref_tbls
from charon_tpu.core.coalesce import TblsCoalescer as RefCoalescer
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.core.coalesce import TblsCoalescer as PortCoalescer
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import guard, policy
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.tbls import torch_impl as TI
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.utils import faults

PACKAGES = {"reference": (RefCoalescer, ref_tbls), "port": (PortCoalescer, port_tbls)}
# explicit everywhere flushes are counted: the reference's default is one
# TILE per mesh device (8,192 on the tests' 8 virtual devices), the port's
# 1,024
FLUSH_AT = 1024


class _CountingImpl:
    """Stub backend recording fused-call batch sizes (no submit call: both
    facades run the serial call and hand back a resolved Future)."""

    def __init__(self):
        self.agg_calls: list[int] = []
        self.ver_calls: list[int] = []
        self.each_calls: list[int] = []
        self.fail_roots: set[bytes] = set()

    def threshold_aggregate_verify_batch(self, batches, pks, roots):
        self.agg_calls.append(len(batches))
        ok = not any(r in self.fail_roots for r in roots)
        return [b"\xc0" + bytes(95)] * len(batches), ok

    def verify_batch(self, pks, roots, sigs):
        self.ver_calls.append(len(sigs))
        return not any(r in self.fail_roots for r in roots)

    def verify_batch_each(self, pks, roots, sigs):
        self.each_calls.append(len(sigs))
        return [r not in self.fail_roots for r in roots]


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    """(the package's TblsCoalescer, the counting backend installed in its
    tbls facade; the previous backend restored after)."""
    cls, tbls = PACKAGES[request.param]
    old = tbls._impl
    impl = _CountingImpl()
    tbls.set_implementation(impl)
    yield cls, impl
    tbls.set_implementation(old)


def _agg_req(n, tag):
    return [{1: b"s" * 96} for _ in range(n)], [b"p" * 48] * n, [tag] * n


def test_concurrent_duties_share_one_dispatch(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.02, flush_at=FLUSH_AT)
        r1, r2 = await asyncio.gather(co.aggregate_verify(*_agg_req(100, b"a" * 32)),
                                      co.aggregate_verify(*_agg_req(100, b"b" * 32)))
        return r1, r2, co

    (sigs1, ok1), (sigs2, ok2), co = asyncio.run(run())
    assert ok1 and ok2 and len(sigs1) == len(sigs2) == 100
    assert impl.agg_calls == [200] and co.coalesced_flushes == 1


def test_window_timer_flushes_single_small_duty(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.01, flush_at=FLUSH_AT)
        t0 = asyncio.get_running_loop().time()
        sigs, ok = await co.aggregate_verify(*_agg_req(10, b"c" * 32))
        return sigs, ok, asyncio.get_running_loop().time() - t0

    sigs, ok, dt = asyncio.run(run())
    assert ok and len(sigs) == 10 and impl.agg_calls == [10] and dt >= 0.01


def test_failure_attributed_to_offending_request_only(pkg):
    cls, impl = pkg
    impl.fail_roots = {b"bad" + b"\x00" * 29}

    async def run():
        co = cls(window=0.02, flush_at=FLUSH_AT)
        return await asyncio.gather(co.aggregate_verify(*_agg_req(100, b"a" * 32)),
                                    co.aggregate_verify(*_agg_req(100, b"bad" + b"\x00" * 29)))

    (_, ok1), (_, ok2) = asyncio.run(run())
    assert ok1 is True and ok2 is False
    assert impl.agg_calls == [200]
    if cls is PortCoalescer:     # one per-item verify of the flush
        assert impl.ver_calls == [] and impl.each_calls == [200]
    else:                        # a verify_batch a request
        assert sorted(impl.ver_calls) == [100, 100] and impl.each_calls == []


def test_verify_path_coalesces_peers(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.02, flush_at=FLUSH_AT)
        return await asyncio.gather(*[co.verify([b"p" * 48] * 100, [bytes([i]) * 32] * 100,
                                                [b"s" * 96] * 100) for i in range(3)])

    assert all(asyncio.run(run()))
    assert impl.ver_calls == [300]


def test_count_trigger_flushes_before_the_timer(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=5.0, flush_at=64)
        return await asyncio.wait_for(asyncio.gather(*[
            co.verify([b"p" * 48] * 32, [bytes([i]) * 32] * 32, [b"s" * 96] * 32)
            for i in range(2)]), 2.0)

    assert all(asyncio.run(run()))
    assert impl.ver_calls == [64]


def test_cancelled_waiter_does_not_strand_others(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.03, flush_at=FLUSH_AT)
        t1 = asyncio.ensure_future(co.aggregate_verify(*_agg_req(50, b"a" * 32)))
        await asyncio.sleep(0.005)
        t1.cancel()
        sigs, ok = await co.aggregate_verify(*_agg_req(100, b"b" * 32))
        assert t1.cancelled() or t1.done()
        return sigs, ok

    sigs, ok = asyncio.run(run())
    assert ok and len(sigs) == 100 and impl.agg_calls == [150]


def test_close_on_quorum_flushes_before_timer(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=5.0, flush_at=10_000)

        async def peer(i):
            await asyncio.sleep(0.01 * i)
            return await co.verify([b"p" * 48] * 4, [bytes([i])] * 4, [b"s" * 96] * 4,
                                   key=("attester", 7), expected=3)

        t0 = asyncio.get_running_loop().time()
        oks = await asyncio.wait_for(asyncio.gather(*(peer(i) for i in range(3))), 2.0)
        return oks, asyncio.get_running_loop().time() - t0

    oks, elapsed = asyncio.run(run())
    assert all(oks) and impl.ver_calls == [12] and elapsed < 1.0


def test_quorum_waits_for_stragglers_until_timer(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.05, flush_at=10_000)

        async def peer(i):
            return await co.verify([b"p" * 48], [bytes([i])], [b"s" * 96],
                                   key=("attester", 8), expected=3)

        t0 = asyncio.get_running_loop().time()
        oks = await asyncio.wait_for(asyncio.gather(peer(0), peer(1)), 2.0)
        return oks, asyncio.get_running_loop().time() - t0

    oks, elapsed = asyncio.run(run())
    assert all(oks) and impl.ver_calls == [2] and elapsed >= 0.045


def test_mixed_unkeyed_submission_defeats_early_close(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.05, flush_at=10_000)

        async def keyed(i):
            return await co.verify([b"p" * 48], [bytes([i])], [b"s" * 96],
                                   key=("sync", 9), expected=2)

        return await asyncio.wait_for(asyncio.gather(
            keyed(0), co.verify([b"p" * 48], [b"\xf0"], [b"s" * 96]), keyed(1)), 2.0)

    assert all(asyncio.run(run())) and impl.ver_calls == [3]


def test_duplicate_contributor_does_not_fake_quorum(pkg):
    cls, impl = pkg

    async def run():
        co = cls(window=0.05, flush_at=10_000)

        async def send(contrib):
            return await co.verify([b"p" * 48], [bytes([contrib])], [b"s" * 96],
                                   key=("attester", 11), expected=3, contributor=contrib)

        t0 = asyncio.get_running_loop().time()
        oks = await asyncio.wait_for(asyncio.gather(send(1), send(1), send(2)), 2.0)
        return oks, asyncio.get_running_loop().time() - t0

    oks, elapsed = asyncio.run(run())
    assert all(oks) and impl.ver_calls == [3] and elapsed >= 0.045


def _exploding(calls, exc):
    def agg(batches, pks, roots):
        calls.append(len(batches))
        raise exc
    return agg


def test_systemic_failure_abandons_bisect(pkg):
    cls, impl = pkg
    calls = []
    impl.threshold_aggregate_verify_batch = _exploding(calls, RuntimeError("device down"))

    async def run():
        co = cls(window=0.01, flush_at=64)
        return await asyncio.gather(*[co.aggregate_verify(*_agg_req(1, bytes([i]) * 32))
                                      for i in range(64)], return_exceptions=True)

    results = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) for r in results)
    assert len(calls) <= 16, calls


def _raising_on(boom):
    def agg(batches, pks, roots):
        if any(r in boom for r in roots):
            raise ValueError("malformed submission")
        return [b"\xc0" + bytes(95)] * len(batches), True
    return agg


@pytest.mark.parametrize("bad", [(15,), (10, 50)])
def test_bisect_isolates_offenders(pkg, bad):
    cls, impl = pkg
    n = 16 if bad == (15,) else 64
    tags = [b"bad%d" % i + b"\x00" * 27 if i in bad else bytes([i]) * 32 for i in range(n)]
    impl.threshold_aggregate_verify_batch = _raising_on({tags[i] for i in bad})

    async def run():
        co = cls(window=0.01, flush_at=n)
        return await asyncio.gather(*[co.aggregate_verify(*_agg_req(1, t)) for t in tags],
                                    return_exceptions=True)

    results = asyncio.run(run())
    for i, r in enumerate(results):
        if i in bad:
            assert isinstance(r, ValueError)
        else:
            assert not isinstance(r, Exception) and r[1] is True


def test_both_coalescers_flush_alike():
    """The same submissions through each package's coalescer give the same
    dispatches, in the same order, and the same verdicts; the failed flush
    (submissions 5-9, 7 failing) is attributed by the reference in a
    verify_batch a submission, by the port in one verify_batch_each."""
    got = {}
    for name, (cls, tbls) in PACKAGES.items():
        old = tbls._impl
        impl = _CountingImpl()
        impl.fail_roots = {b"\x07" * 32}
        tbls.set_implementation(impl)
        try:
            async def run():
                co = cls(window=0.02, flush_at=256)
                return await asyncio.gather(*[
                    co.verify([b"p" * 48] * 60, [bytes([i]) * 32] * 60, [b"s" * 96] * 60,
                              key=("attester", i % 2), expected=5, contributor=i)
                    for i in range(10)])

            got[name] = (asyncio.run(run()), impl.ver_calls, impl.each_calls)
        finally:
            tbls.set_implementation(old)
    assert got["port"][0] == got["reference"][0] == [i != 7 for i in range(10)]
    assert got["reference"][1:] == ([300, 300] + [60] * 5, [])
    assert got["port"][1:] == ([300, 300], [300])


# -- the port's own -------------------------------------------------------


def test_port_policy_accessors_and_an_explicit_flush_at():
    assert policy.deadline_budget_override() is None
    assert policy.flush_at_default() == PA.VERIFY_CHUNK == 1024
    assert PortCoalescer()._agg.flush_at == PortCoalescer()._ver.flush_at == 1024
    assert PortCoalescer().deadline_budget_s == 12.0
    co = PortCoalescer(flush_at=4)
    assert co._agg.flush_at == co._ver.flush_at == 4
    co.deadline_budget_s = None
    co.check_admission()       # admission off


def test_explicit_flush_at_wins_over_the_default():
    """flush_at=4 flushes at the 4th item, long before the 5 s timer; the
    default (1,024) would have waited for it."""
    old = port_tbls._impl
    impl = _CountingImpl()
    port_tbls.set_implementation(impl)
    try:
        async def run(flush_at):
            co = PortCoalescer(window=5.0, flush_at=flush_at)
            futs = [asyncio.ensure_future(co.verify([b"p" * 48] * 2, [b"r" * 32] * 2,
                                                    [b"s" * 96] * 2)) for _ in range(2)]
            done, _ = await asyncio.wait(futs, timeout=0.3)
            for f in futs:
                f.cancel()
            return len(done)

        assert asyncio.run(run(4)) == 2 and impl.ver_calls == [4]
        assert asyncio.run(run(None)) == 0 and impl.ver_calls == [4]
    finally:
        port_tbls.set_implementation(old)


@pytest.mark.parametrize("exc", [faults.DeviceLostFault("card lost"), TimeoutError("fence")],
                         ids=["device_lost", "timeout"])
def test_port_device_class_error_fails_the_flush_without_bisect(exc):
    """The port's guard calls the error device-class: one dispatch, every
    submission of the flush fails with it, and two such flushes in a row
    shed new work (the fail-fast)."""
    assert guard.is_device_error(exc)
    old = port_tbls._impl
    impl = _CountingImpl()
    calls = []
    impl.threshold_aggregate_verify_batch = _exploding(calls, exc)
    port_tbls.set_implementation(impl)
    try:
        async def run():
            co = PortCoalescer(window=0.01, flush_at=64, overload_streak=2)
            first = await asyncio.gather(*[co.aggregate_verify(*_agg_req(1, bytes([i]) * 32))
                                           for i in range(16)], return_exceptions=True)
            second = await asyncio.gather(co.aggregate_verify(*_agg_req(1, b"x" * 32)),
                                          return_exceptions=True)
            with pytest.raises(Exception) as shed:
                co.check_admission()
            return first, second, shed.value

        first, second, shed = asyncio.run(run())
    finally:
        port_tbls.set_implementation(old)
    assert calls == [16, 1]
    # the same error (asyncio re-raises a Future's TimeoutError as a copy)
    assert all(type(r) is type(exc) and str(r) == str(exc) for r in first + second)
    assert type(shed).__name__ == "OverloadedError"


def test_port_launch_error_is_bisected_within_its_budget():
    """A kernel that did not launch (cuda_plane.DeviceError, class "launch")
    is not device-class: the coalescer bisects it as any other error, as the
    reference does every error it does not call device-class: the flush
    fails after at most log2(flush_at) + 1 failed dispatches of several
    submissions (the bisect's budget), each leaf it reached one more."""
    exc = CP.DeviceError("launch failed: too many resources requested for launch")
    assert guard.classify(exc) == "launch" and not guard.is_device_error(exc)
    old = port_tbls._impl
    impl = _CountingImpl()
    calls = []
    impl.threshold_aggregate_verify_batch = _exploding(calls, exc)
    port_tbls.set_implementation(impl)
    try:
        async def run():
            co = PortCoalescer(window=0.01, flush_at=64)
            return await asyncio.gather(*[co.aggregate_verify(*_agg_req(1, bytes([i]) * 32))
                                          for i in range(64)], return_exceptions=True)

        results = asyncio.run(run())
    finally:
        port_tbls.set_implementation(old)
    assert all(r is exc for r in results)
    assert sum(c > 1 for c in calls) == (64).bit_length() + 1, calls
    assert len(calls) <= 16, calls


def test_concurrent_flushes_verify_one_at_a_time(monkeypatch):
    """Four verify flushes that the count trigger starts at once, on one
    TorchImpl device: their device verifies run one after another on the
    device's slot thread, and every submission gets its verdict."""
    active, peak, threads = [0], [0], []
    gate = threading.Lock()

    def rlc_verify_batch(pks, msgs, sigs, *rest):
        with gate:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        threads.append(threading.current_thread().name)
        time.sleep(0.05)
        with gate:
            active[0] -= 1
        return True

    monkeypatch.setattr(PA, "rlc_verify_batch", rlc_verify_batch)
    old = port_tbls._impl
    port_tbls.set_implementation(TorchImpl(device="cpu", verify="native"))
    try:
        async def run():
            co = PortCoalescer(window=5.0, flush_at=2)
            return await asyncio.gather(*[co.verify([b"p" * 48] * 2, [bytes([i]) * 32] * 2,
                                                    [b"s" * 96] * 2) for i in range(4)])

        assert asyncio.run(run()) == [True] * 4
    finally:
        port_tbls.set_implementation(old)
    assert peak[0] == 1 and len(threads) == 4
    assert all(t.startswith("sigagg-slot-cpu_") for t in threads)


def test_a_verify_queued_behind_a_hung_slot_runs_on_the_new_slot_thread(monkeypatch):
    """A verify queued behind a slot that hangs past its watchdog deadline
    is cancelled with the hung thread's queue and runs on the thread that
    replaces it; a verify called on the slot thread itself runs inline."""
    release = threading.Event()

    def slot(*args, **kwargs):
        assert release.wait(10), "test gate never released"
        return [b"\xaa" * 96], True

    ran = []

    def rlc_verify_batch(pks, msgs, sigs, *rest):
        ran.append(threading.current_thread())
        return True

    monkeypatch.setattr(PA, "threshold_aggregate_and_verify", slot)
    monkeypatch.setattr(PA, "rlc_verify_batch", rlc_verify_batch)
    monkeypatch.setenv(policy.ENV_SLOT_DEADLINE, "0.3")
    impl = TorchImpl(device="cpu", verify="native")
    impl.fallback_on_device_error = False
    try:
        hung = impl.threshold_aggregate_verify_submit([{1: b"s" * 96}], [b"p" * 48], [b"r" * 32])
        time.sleep(0.05)
        hung_thread = TI.slot_thread("cpu")
        assert impl.verify_batch([b"p" * 48], [b"r" * 32], [b"s" * 96]) is True
        assert isinstance(hung.exception(timeout=10), TimeoutError)
        assert TI.slot_thread("cpu") is not hung_thread
        assert ran[0].name.startswith("sigagg-slot-cpu_")
        inline = TI.slot_thread("cpu").submit(
            impl.verify_batch, [b"p" * 48], [b"r" * 32], [b"s" * 96])
        assert inline.result(timeout=10) is True and ran[1] is ran[0]
    finally:
        release.set()
        guard.reset_for_testing()


# -- a failed flush, attributed in one call --------------------------------


class _NativeCounting:
    """The reference's NativeImpl behind either facade, counting the calls
    a coalescer makes: the fused slot and verify, and the per-item verify
    (native ct_verify an item, as TPUImpl.verify_batch_each)."""

    def __init__(self):
        from charon_tpu.tbls.native_impl import NativeImpl

        self.native = NativeImpl()
        self.calls: list[tuple[str, int]] = []

    def threshold_aggregate_verify_batch(self, batches, pks, roots):
        self.calls.append(("aggregate", len(batches)))
        return self.native.threshold_aggregate_verify_batch(batches, pks, roots)

    def verify_batch(self, pks, roots, sigs):
        self.calls.append(("verify", len(sigs)))
        return self.native.verify_batch(pks, roots, sigs)

    def verify_batch_each(self, pks, roots, sigs):
        self.calls.append(("each", len(sigs)))
        return [self.native.verify(*t) for t in zip(pks, roots, sigs)]


@pytest.fixture(scope="module")
def signed():
    """Three validators' keys (root and 2-of-3 shares, native) and, for three
    roots, each validator's root signature and share partials."""
    import random

    from charon_tpu.crypto import fields as RPF
    from charon_tpu.tbls.native_impl import NativeImpl
    from charon_tpu.tbls.types import PrivateKey

    native = NativeImpl()
    rng = random.Random(23)
    roots = [bytes([0x30 + i]) * 32 for i in range(3)]
    vals = []
    for _ in range(3):
        sk = PrivateKey(rng.randrange(1, RPF.R).to_bytes(32, "big"))
        shares = native.threshold_split(sk, 3, 2)
        vals.append({"pk": bytes(native.secret_to_public_key(sk)),
                     "sig": {r: bytes(native.sign(sk, r)) for r in roots},
                     "partials": {r: {i: native.sign(shares[i], r) for i in (1, 2)}
                                  for r in roots}})
    return roots, vals


def _flush_of_three(cls, tbls, kind, submissions):
    """The three submissions through one flush of `cls` behind `tbls` with
    a _NativeCounting backend: (outcomes, the backend's calls)."""
    old = tbls._impl
    impl = _NativeCounting()
    tbls.set_implementation(impl)
    try:
        async def run():
            co = cls(window=5.0, flush_at=sum(len(s[0]) for s in submissions),
                     deadline_budget_s=None)
            call = co.aggregate_verify if kind == "aggregate" else co.verify
            return await asyncio.gather(*[call(*s) for s in submissions])

        out = asyncio.run(run())
    finally:
        tbls.set_implementation(old)
    if kind == "aggregate":
        out = [([bytes(x) for x in sigs], ok) for sigs, ok in out]
    return out, impl.calls


@pytest.mark.parametrize("kind", ["verify", "aggregate"])
@pytest.mark.parametrize("tampered", [None, 1])
def test_a_failed_flush_is_attributed_in_one_call(signed, kind, tampered):
    """A flush of three submissions (3, 2 and 1 items over natively signed
    triples or partials), the middle one tampered (validator 1's signature,
    or its partial of share 2, over another root): the port's futures get
    the reference coalescer's outcomes, every other submission True. The
    port makes one verify_batch_each over the flush's 6 items after the
    failed fused call and no verify_batch; the reference one verify_batch a
    submission. A passing flush makes the fused call alone."""
    roots, vals = signed
    subs = []
    for k, items in enumerate(([0, 1, 2], [0, 1], [2])):
        root = roots[k]
        if kind == "verify":
            sigs = [vals[v]["sig"][root] for v in items]
            if k == tampered:
                sigs[1] = vals[1]["sig"][roots[0]]
            subs.append(([vals[v]["pk"] for v in items], [root] * len(items), sigs))
        else:
            batches = [dict(vals[v]["partials"][root]) for v in items]
            if k == tampered:
                batches[1][2] = vals[1]["partials"][roots[0]][2]
            subs.append((batches, [vals[v]["pk"] for v in items], [root] * len(items)))
    got = {name: _flush_of_three(cls, tbls, kind, subs) for name, (cls, tbls) in PACKAGES.items()}
    port, ref = got["port"], got["reference"]
    assert port[0] == ref[0]
    oks = [o if kind == "verify" else o[1] for o in port[0]]
    assert oks == [k != tampered for k in range(3)]
    fused = ("verify" if kind == "verify" else "aggregate", 6)
    if tampered is None:
        assert port[1] == ref[1] == [fused]
    else:
        assert port[1] == [fused, ("each", 6)]
        assert ref[1] == [fused, ("verify", 3), ("verify", 2), ("verify", 1)]
