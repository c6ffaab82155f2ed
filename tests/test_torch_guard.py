"""The port's guard (charon_tpu_torch/ops/guard.py) and its routing through
the slot, the submit front door, the TorchImpl belt and the FROST ceremony,
on the CPU against the reference (charon_tpu/ops/guard.py,
charon_tpu/tbls/native_impl.py native_slot_fallback, charon_tpu/dkg/
frost.py): the failure taxonomy and the cause-chain walk, the circuit
breaker's state sequences under one scripted clock, the policy knobs, a
small slot (8 validators at 2-of-3 from a numpy seed) with a planned fault
at each site landing on the native rung with the bytes and the verdict of
the fault-free run and of the reference's rung, the open breaker's
zero-launch slot, the verify fallback, the watchdog, the
fallback_on_device_error switch, the build failure that is never absorbed,
and the ceremony's frost.msm and keygen fallbacks. Every comparison is
exact: equal bytes, verdicts, exception texts and breaker states. The slot's
device stages are run once; the faulted runs replay its pending state, as
tests/test_faults_guard.py stubs the reference's stages."""

import logging
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from charon_tpu.dkg import frost as RFROST
from charon_tpu.ops import guard as RG
from charon_tpu.ops import policy as RPOL
from charon_tpu.tbls.native_impl import native_slot_fallback as ref_native_slot
from charon_tpu.utils import errors as RERR
from charon_tpu.utils import faults as RFAULTS
from charon_tpu_torch import native
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.dkg import frost as TF
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import guard as G
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.ops import policy as POL
from charon_tpu_torch.tbls import torch_impl as TI
from charon_tpu_torch.utils import errors as TERR
from charon_tpu_torch.utils import faults

V, N, T = 8, 3, 2
SITES = ("sigagg.pack", "sigagg.execute", "sigagg.readback", "sigagg.finish")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Knobs at their defaults, no plan, a fresh breaker and counters; all
    restored after (guard.configure writes the deadline's variable)."""
    for env in (POL.ENV_BREAKER_THRESHOLD, POL.ENV_BREAKER_COOLDOWN, POL.ENV_SLOT_DEADLINE):
        monkeypatch.setenv(env, "")
        monkeypatch.delenv(env)
    faults.disarm()
    RFAULTS.disarm()
    G.reset_for_testing()
    RG.reset_for_testing()
    yield
    faults.disarm()
    RFAULTS.disarm()
    G.reset_for_testing()
    RG.reset_for_testing()


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

SHARED = {
    "ValueError": lambda m: ValueError("bad encoding"),
    "TimeoutError": lambda m: TimeoutError("fence"),
    "RuntimeError": lambda m: RuntimeError("CUDA error: an illegal memory access"),
    "ConnectionError": lambda m: ConnectionError("peer"),
    "KeyError": lambda m: KeyError("k"),
    "DeviceLostFault": lambda m: m.DeviceLostFault("lost"),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_classify_matches_the_reference(name):
    """Each package's own exception gets the same class in both."""
    assert G.classify(SHARED[name](faults)) == RG.classify(SHARED[name](RFAULTS))


def test_the_port_s_device_errors_and_the_build_failure():
    """The port's device types are device-class; a failed build is "build"
    and a refused launch "launch" in the port, both "error" (retried) in
    the reference: the stated differences of classify."""
    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory"),
                faults.DeviceLostFault("x")):
        assert G.classify(exc) == "device_lost" and G.is_device_error(exc)
    launch = CP.DeviceError("CUDA kernel fe_mul<1> did not launch: error 209")
    assert (G.classify(launch), RG.classify(RuntimeError(str(launch)))) == ("launch", "error")
    assert not G.is_device_error(launch) and CP.DeviceError not in G.DEVICE_ERRORS
    if hasattr(torch, "AcceleratorError"):
        assert torch.AcceleratorError in G.DEVICE_ERRORS
    build = subprocess.CalledProcessError(2, ["nvcc"], "", "error: identifier undefined")
    assert (G.classify(build), RG.classify(build)) == ("build", "error")
    assert not G.is_device_error(build)
    assert G.classify(subprocess.TimeoutExpired(["nvcc"], 900)) == "build"


def _chains(m, errors):
    """(exception, is it device-class): the cause chain through `cause`
    (CharonError) and `__cause__`, cycles included."""
    def caused(exc, cause):
        exc.__cause__ = cause
        return exc

    loop = RuntimeError("a")
    loop.__cause__ = RuntimeError("b")
    loop.__cause__.__cause__ = loop
    return [
        (errors.CharonError("slot failed", cause=m.DeviceLostFault("lost")), True),
        (errors.CharonError("outer", cause=errors.CharonError("inner", cause=TimeoutError())),
         True),
        (caused(RuntimeError("wrapped"), m.DeviceLostFault("lost")), True),
        (caused(KeyError("k"), caused(RuntimeError("r"), TimeoutError())), True),
        (errors.CharonError("input", cause=ValueError("bad")), False),
        (caused(RuntimeError("plain"), RuntimeError("plainer")), False),
        (loop, False),
        (ValueError("bad"), False),
    ]


@pytest.mark.parametrize("k", range(8))
def test_is_device_error_walks_the_cause_chain(k):
    port, want = _chains(faults, TERR)[k]
    ref, ref_want = _chains(RFAULTS, RERR)[k]
    assert G.is_device_error(port) is want == RG.is_device_error(ref) == ref_want


# ---------------------------------------------------------------------------
# the breaker, under one scripted clock
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


SCRIPTS = {
    "trip, wait, probe succeeds": (2, 5.0, ["allow", "fail", "allow", "fail", "allow", 4.9,
                                            "allow", 0.2, "allow", "allow", "ok", "allow"]),
    "probe fails and reopens": (1, 1.0, ["fail", "allow", 1.0, "allow", "fail", "allow", 0.5,
                                         "allow", 0.6, "allow", "ok", "allow"]),
    "success resets the count": (2, 1.0, ["fail", "ok", "fail", "allow", "fail", "allow"]),
    "threshold below one clamps": (0, 0.0, ["allow", "fail", "allow", "allow", "ok"]),
    "negative cooldown clamps": (3, -4.0, ["fail", "fail", "fail", "allow", "allow", "fail",
                                           "allow", "ok", "fail"]),
    "failures while open": (1, 2.0, ["fail", "fail", 1.5, "fail", 1.5, "allow", 0.6, "allow",
                                     "allow", "ok"]),
}


def _run_script(mod, monkeypatch, threshold, cooldown, script):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    b = mod.CircuitBreaker(threshold=threshold, cooldown=cooldown)
    seen = []
    for step in script:
        if isinstance(step, float):
            clock.now += step
        elif step == "allow":
            seen.append(("allow", b.allow_device()))
        else:
            (b.record_failure if step == "fail" else b.record_success)()
        seen.append(b.state)
    return seen


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_state_sequences_match_the_reference(name, monkeypatch):
    threshold, cooldown, script = SCRIPTS[name]
    got = _run_script(G, monkeypatch, threshold, cooldown, script)
    assert got == _run_script(RG, monkeypatch, threshold, cooldown, script)
    if name == "trip, wait, probe succeeds":
        allows = [s[1] for s in got if isinstance(s, tuple)]
        assert allows == [True, True, False, False, True, False, True]
        assert got[-1] == G.CLOSED


@pytest.mark.parametrize("env, raw", [(None, None), ("threshold", "0"), ("threshold", "7"),
                                      ("threshold", "x"), ("cooldown", "1.5"),
                                      ("cooldown", "-2"), ("deadline", "0"),
                                      ("deadline", "0.15"), ("deadline", "later")])
def test_policy_knobs_read_as_the_reference_s(env, raw, monkeypatch):
    name = {"threshold": POL.ENV_BREAKER_THRESHOLD, "cooldown": POL.ENV_BREAKER_COOLDOWN,
            "deadline": POL.ENV_SLOT_DEADLINE}.get(env)
    if name is not None:
        monkeypatch.setenv(name, raw)
    assert RPOL.installed() is None
    for fn in ("breaker_threshold_default", "breaker_cooldown_default", "slot_deadline_default"):
        assert getattr(POL, fn)() == getattr(RPOL, fn)()
    b = G.CircuitBreaker()
    assert (b._threshold, b._cooldown) == (RG.CircuitBreaker()._threshold,
                                           RG.CircuitBreaker()._cooldown)
    G.configure(threshold=4, cooldown=9.0, slot_deadline=3)
    assert (G.BREAKER._threshold, G.BREAKER._cooldown, G.slot_deadline_default()) == (4, 9.0, 3.0)


def test_the_counters_and_the_breaker_under_threads(caplog):
    """24 threads at a short switch interval: no landing is lost, and the
    breaker, opened by the first threshold of failures, stays open."""
    caplog.set_level(logging.CRITICAL, logger=G.__name__)
    G.configure(threshold=5, cooldown=3600.0)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    allowed = []

    def work():
        for _ in range(200):
            G.note_verify_fallback("device_lost")
            allowed.append(G.allow_device_dispatch())

    try:
        threads = [threading.Thread(target=work) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert G.counters() == {"fallback": {("device_lost", "native"): 24 * 200},
                            "watchdog": 0, "breaker": G.OPEN}
    assert allowed.count(True) <= 4


# ---------------------------------------------------------------------------
# the slot
# ---------------------------------------------------------------------------


def _cluster():
    """V validators at T-of-N from a numpy seed, over two messages."""
    rng = np.random.default_rng(1212)

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % (PF.R - 1) + 1

    batches, pks, msgs = [], [], []
    for v in range(V):
        coeffs = [scalar() for _ in range(T)]
        msg = bytes([0x30 + v % 2]) * 32
        ids = sorted(int(i) for i in rng.choice(np.arange(1, N + 1), T, replace=False))
        batches.append({i: native.sign((sum(c * i ** k for k, c in enumerate(coeffs))
                                        % PF.R).to_bytes(32, "big"), msg) for i in ids})
        pks.append(native.pubkey(coeffs[0].to_bytes(32, "big")))
        msgs.append(msg)
    return batches, pks, msgs


@pytest.fixture(scope="module")
def slot():
    """One fault-free slot on TorchImpl(device="cpu", verify="native"): its
    result, its pending device state and the (S, group points) of its
    verify, kept for the faulted runs."""
    torch.set_num_threads(1)
    batches, pks, msgs = _cluster()
    impl = TI.TorchImpl(device="cpu", verify="native")
    seen = {}
    real_slot, real_finish = PA.fused_slot, PA.pairing_finish
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PA, "fused_slot", lambda *a: seen.setdefault("state", real_slot(*a)))
        mp.setattr(PA, "pairing_finish", lambda S, pts, *a: seen.setdefault("pairs", (S, pts))
                   and real_finish(S, pts, *a))
        G.reset_for_testing()
        aggs, ok = impl.threshold_aggregate_verify_batch(batches, pks, msgs)
    assert ok and G.counters()["fallback"] == {}
    return dict(batches=batches, pks=pks, msgs=msgs, aggs=[bytes(a) for a in aggs], ok=ok,
                state=seen["state"], pairs=seen["pairs"])


def _replay(monkeypatch, slot):
    """fused_slot replays the fault-free run's pending state, its
    sigagg.pack site first."""
    def replay(layout, pks, msgs, device, cache):
        faults.check("sigagg.pack")
        return slot["state"]

    monkeypatch.setattr(PA, "fused_slot", replay)


def _plain_calls() -> int:
    return sum(sum(k.plain_calls.values()) for k in CP.KERNELS.values())


def test_the_native_rung_is_the_reference_s(slot):
    want = ref_native_slot(slot["batches"], slot["pks"], slot["msgs"])
    assert native.native_slot_fallback(slot["batches"], slot["pks"], slot["msgs"]) == want
    assert want == (slot["aggs"], True)
    bad = [dict(b) for b in slot["batches"]]
    bad[3][sorted(bad[3])[0]] = b"\x80" + b"\x11" * 95
    for fn in (native.native_slot_fallback, ref_native_slot):
        with pytest.raises(ValueError, match="^invalid partial signature encoding$"):
            fn(bad, slot["pks"], slot["msgs"])


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("kind", ["device_lost", "timeout"])
def test_a_fault_at_each_site_lands_native(slot, site, kind, monkeypatch):
    """The slot lands on the native rung with the fault-free run's bytes
    and verdict, which are the reference rung's; counted once, SlotTimes
    filled."""
    _replay(monkeypatch, slot)
    impl = TI.TorchImpl(device="cpu", verify="native")
    faults.arm([{"site": site, "kind": kind}])
    reason = "device_lost" if kind == "device_lost" else "timeout"
    aggs, ok = impl.threshold_aggregate_verify_batch(slot["batches"], slot["pks"], slot["msgs"])
    assert ([bytes(a) for a in aggs], ok) == (slot["aggs"], slot["ok"])
    assert ([bytes(a) for a in aggs], ok) == ref_native_slot(slot["batches"], slot["pks"],
                                                             slot["msgs"])
    assert G.counters() == {"fallback": {(reason, "native"): 1}, "watchdog": 0,
                            "breaker": G.CLOSED}
    assert faults.injected(site) >= 1 and faults.invocations(site) == 1
    t = impl.last_times
    assert t.native > 0 and t.verify == 0
    assert (t.readback > 0) is (site == "sigagg.finish")


def test_the_native_rung_refuses_a_custom_hash(slot):
    """A slot with a custom hash to G2 cannot land natively: the rung
    computes the standard hash (the reference's guard.py:469-478)."""
    inputs = (slot["batches"], slot["pks"], slot["msgs"])
    with pytest.raises(RuntimeError, match="cannot honor a custom hash_fn"):
        G.finish_slot(("native_slot",), inputs, None, hash_fn=lambda m: m)
    with pytest.raises(RuntimeError, match="cannot honor a custom hash_fn"):
        G.watchdog_recover(inputs, hash_fn=lambda m: m)
    assert G.finish_slot(("native_slot",), inputs, None) == ref_native_slot(*inputs)


@pytest.mark.parametrize("kind, exc", [("input", ValueError), ("error", RuntimeError)])
def test_input_and_other_errors_propagate(slot, kind, exc, monkeypatch):
    _replay(monkeypatch, slot)
    faults.arm([{"site": "sigagg.readback", "kind": kind, "msg": "planned"}])
    with pytest.raises(exc, match="^planned$"):
        TI.TorchImpl(device="cpu", verify="native").threshold_aggregate_verify_batch(
            slot["batches"], slot["pks"], slot["msgs"])
    assert G.counters()["fallback"] == {} and G.BREAKER.state == G.CLOSED


def test_a_tampered_partial_under_a_fault_is_false(slot):
    """The real fused_slot faults at its first line (no plain call); the
    native rung gives the reference rung's False."""
    bad = [dict(b) for b in slot["batches"]]
    bad[5][sorted(bad[5])[0]] = slot["batches"][6][sorted(slot["batches"][6])[0]]
    faults.arm([{"site": "sigagg.pack"}])
    CP.reset_counts()
    aggs, ok = TI.TorchImpl(device="cpu", verify="native").threshold_aggregate_verify_batch(
        bad, slot["pks"], slot["msgs"])
    assert _plain_calls() == 0 and ok is False
    assert ([bytes(a) for a in aggs], ok) == ref_native_slot(bad, slot["pks"], slot["msgs"])


def test_the_breaker_opens_routes_with_no_work_and_probes_back(slot, monkeypatch):
    """Three device failures open the breaker; the next slot lands native as
    "breaker_open" with no plain call; after the cooldown one fault-free
    probe slot runs on the device path and closes it."""
    clock = _Clock()
    monkeypatch.setattr(G, "time", clock)
    _replay(monkeypatch, slot)
    G.configure(threshold=3, cooldown=1.0)
    impl = TI.TorchImpl(device="cpu", verify="native")
    args = (slot["batches"], slot["pks"], slot["msgs"])
    faults.arm([{"site": "sigagg.execute", "count": 3}])
    for k in range(3):
        assert G.BREAKER.state == G.CLOSED
        assert [bytes(a) for a in impl.threshold_aggregate_verify_batch(*args)[0]] == slot["aggs"]
    assert G.BREAKER.state == G.OPEN
    monkeypatch.setattr(PA, "fused_slot", lambda *a: pytest.fail("dispatched while open"))
    CP.reset_counts()
    assert [bytes(a) for a in impl.threshold_aggregate_verify_batch(*args)[0]] == slot["aggs"]
    assert _plain_calls() == 0
    assert G.counters()["fallback"] == {("device_lost", "native"): 3,
                                        ("breaker_open", "native"): 1}
    clock.now += 1.0
    _replay(monkeypatch, slot)
    aggs, ok = impl.threshold_aggregate_verify_batch(*args)
    assert ([bytes(a) for a in aggs], ok) == (slot["aggs"], True)
    assert G.BREAKER.state == G.CLOSED and impl.last_times.native == 0
    assert G.fallback_total("breaker_open") == 1


def test_the_verify_fallback(slot, monkeypatch):
    """A device-class failure of the device pairing check re-runs it
    natively: the same verdict, counted in pairing_path["native"]; other
    errors and the fallback switched off raise; an open breaker sends the
    check native without trying the device."""
    S, pts = slot["pairs"]
    calls = []

    def lost(*_a):
        calls.append(1)
        raise faults.DeviceLostFault("card lost mid-verify")

    monkeypatch.setattr(PA, "device_pairing_check", lost)
    path = {}
    assert PA.pairing_finish(S, pts, PA.H2CCache(), path, "device", "cpu") is True
    assert path == {"native": len(pts) + 1} and G.fallback_total("device_lost") == 1
    bad = PC.jac_add(PC.Fq2Ops, S, S)
    assert PA.pairing_finish(bad, pts, PA.H2CCache(), {}, "device", "cpu") is False
    with G.fallback(False), pytest.raises(faults.DeviceLostFault):
        PA.pairing_finish(S, pts, PA.H2CCache(), {}, "device", "cpu")
    monkeypatch.setattr(PA, "device_pairing_check",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("kernel bug")))
    with pytest.raises(RuntimeError, match="kernel bug"):
        PA.pairing_finish(S, pts, PA.H2CCache(), {}, "device", "cpu")
    G.configure(threshold=1, cooldown=60.0)
    G.BREAKER.record_failure()
    monkeypatch.setattr(PA, "device_pairing_check", lost)
    n = len(calls)
    assert PA.pairing_finish(S, pts, PA.H2CCache(), path, "device", "cpu") is True
    assert len(calls) == n and path == {"native": 2 * (len(pts) + 1)}


def test_fallback_off_raises_and_the_belt_answers_natively(slot, monkeypatch):
    """fallback_on_device_error=False: a planned fault raises through the
    slot, and no landing is counted. The belt (on): a device-class error
    that reaches threshold_aggregate_batch, verify_batch or the slot call
    is answered natively, with the reference's bytes and verdicts (the slot
    call through the guard below it)."""
    _replay(monkeypatch, slot)
    args = (slot["batches"], slot["pks"], slot["msgs"])
    off = TI.TorchImpl(device="cpu", verify="native")
    off.fallback_on_device_error = False
    faults.arm([{"site": "sigagg.readback"}])
    with pytest.raises(faults.DeviceLostFault):
        off.threshold_aggregate_verify_batch(*args)
    assert G.counters()["fallback"] == {} and G.BREAKER.state == G.CLOSED

    def boom(*_a, **_k):
        raise faults.DeviceLostFault("card lost")

    for name in ("aggregate", "rlc_verify_batch", "fused_slot"):
        monkeypatch.setattr(PA, name, boom)
    on = TI.TorchImpl(device="cpu", verify="native")
    want = ref_native_slot(*args)
    assert [bytes(s) for s in on.threshold_aggregate_batch(slot["batches"])] == want[0]
    assert on.verify_batch(slot["pks"], slot["msgs"], want[0]) is True
    assert on.verify_batch(slot["pks"], slot["msgs"], want[0][::-1]) is False
    got = on.threshold_aggregate_verify_batch(*args)
    assert ([bytes(s) for s in got[0]], got[1]) == want
    assert G.fallback_total("device_lost") == 4
    for call in (lambda: off.threshold_aggregate_batch(slot["batches"]),
                 lambda: off.verify_batch(slot["pks"], slot["msgs"], want[0]),
                 lambda: off.threshold_aggregate_verify_batch(*args)):
        with pytest.raises(faults.DeviceLostFault):
            call()


@pytest.mark.parametrize("fallback", [True, False])
def test_a_build_failure_raises_at_every_setting(slot, fallback, monkeypatch):
    def build_fails(*_a):
        raise subprocess.CalledProcessError(2, ["nvcc"], "", "ptxas fatal")

    monkeypatch.setattr(PA, "fused_slot", build_fails)
    impl = TI.TorchImpl(device="cpu", verify="native")
    impl.fallback_on_device_error = fallback
    with pytest.raises(subprocess.CalledProcessError):
        impl.threshold_aggregate_verify_batch(slot["batches"], slot["pks"], slot["msgs"])
    assert G.counters() == {"fallback": {}, "watchdog": 0, "breaker": G.CLOSED}


LAUNCH = "CUDA kernel fe_mul<2> did not launch: error 209"


def _refused(*_a, **_k):
    raise CP.DeviceError(LAUNCH)


def _launch_entry(entry, slot, items, monkeypatch):
    """A call whose device work stops at a refused launch, at `entry`."""
    impl = TI.TorchImpl(device="cpu", verify="native")
    args = (slot["batches"], slot["pks"], slot["msgs"])
    if entry == "slot dispatch":
        monkeypatch.setattr(PA, "fused_slot", _refused)
        return impl, lambda: impl.threshold_aggregate_verify_batch(*args)
    if entry == "slot readback":
        _replay(monkeypatch, slot)
        monkeypatch.setattr(PA, "readback", _refused)
        return impl, lambda: impl.threshold_aggregate_verify_batch(*args)
    if entry == "aggregate":
        monkeypatch.setattr(PA, "aggregate", _refused)
        return impl, lambda: impl.threshold_aggregate_batch(slot["batches"])
    if entry == "verify_batch":
        monkeypatch.setattr(PA, "rlc_verify_dispatch", _refused)
        return impl, lambda: impl.verify_batch(slot["pks"], slot["msgs"], slot["aggs"])
    if entry == "pairing":
        monkeypatch.setattr(PA, "device_pairing_check", _refused)
        return impl, lambda: PA.pairing_finish(*slot["pairs"], PA.H2CCache(), {}, "device",
                                               "cpu")
    if entry == "keygen":
        monkeypatch.setattr(TF, "DEVICE_KEYGEN", True)
        monkeypatch.setattr(TF, "_DEVICE_MIN_KEYGEN", 0)
        monkeypatch.setattr(PA, "g1_mul_gen_batch", _refused)
        return impl, lambda: TF._mul_gen_many([3, 5, 7], "cpu")
    monkeypatch.setattr(TF, "_DEVICE_MIN_POINTS", 0)
    monkeypatch.setattr(TF, "_verify_shares_device", _refused)
    return impl, lambda: TF.verify_shares_batch(items, "cpu")


@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("entry", ["slot dispatch", "slot readback", "aggregate", "verify_batch",
                                   "pairing", "keygen", "share check"])
def test_a_launch_failure_raises_at_every_setting(slot, items, entry, fallback, monkeypatch):
    """A kernel that did not launch (cuda_plane.DeviceError) is a defect
    of the port, not a lost card: every entry raises it, with the fallback
    on or off, and nothing lands, counts or feeds the breaker."""
    impl, call = _launch_entry(entry, slot, items, monkeypatch)
    impl.fallback_on_device_error = fallback
    before = dict(TF.FALLBACKS)
    with G.fallback(fallback), pytest.raises(CP.DeviceError, match=f"^{LAUNCH}$"):
        call()
    assert G.counters() == {"fallback": {}, "watchdog": 0, "breaker": G.CLOSED}
    assert dict(TF.FALLBACKS) == before


def _half_open(monkeypatch) -> None:
    """A breaker (threshold 1, cooldown 1 s) opened and past its cooldown."""
    clock = _Clock()
    monkeypatch.setattr(G, "time", clock)
    G.configure(threshold=1, cooldown=1.0)
    G.BREAKER.record_failure()
    clock.now += 1.0


@pytest.mark.parametrize("probe", ["bad encoding", "bug at readback"])
def test_a_slot_probe_that_proves_nothing_is_released(slot, probe, monkeypatch):
    """A half-open breaker's probe slot that ends in an input error or a
    bug raises it and leaves the breaker half-open, its probe released:
    the next good slot probes the device path and closes the breaker."""
    _half_open(monkeypatch)
    impl = TI.TorchImpl(device="cpu", verify="native")
    args = (slot["batches"], slot["pks"], slot["msgs"])
    if probe == "bad encoding":
        bad = [dict(b) for b in slot["batches"]]
        bad[3][sorted(bad[3])[0]] = b"\x9f" + b"\xff" * 95
        with pytest.raises(ValueError):
            impl.threshold_aggregate_verify_batch(bad, slot["pks"], slot["msgs"])
    else:
        _replay(monkeypatch, slot)
        faults.arm([{"site": "sigagg.readback", "kind": "error", "msg": "planned"}])
        with pytest.raises(RuntimeError, match="^planned$"):
            impl.threshold_aggregate_verify_batch(*args)
        faults.disarm()
    assert G.BREAKER.state == G.HALF_OPEN
    _replay(monkeypatch, slot)
    aggs, ok = impl.threshold_aggregate_verify_batch(*args)
    assert ([bytes(a) for a in aggs], ok) == (slot["aggs"], True)
    assert G.BREAKER.state == G.CLOSED and impl.last_times.native == 0
    assert G.counters()["fallback"] == {}


@pytest.mark.parametrize("outcome", ["False", "ValueError", "RuntimeError"])
def test_a_ceremony_probe_that_proves_nothing_is_released(items, outcome, monkeypatch):
    """The share check as the half-open breaker's probe: a False verdict, a
    ValueError (both go to the per-item check) or a bug (raised) releases
    the probe, and the next batch may probe again."""
    _half_open(monkeypatch)
    monkeypatch.setattr(TF, "_DEVICE_MIN_POINTS", 0)

    def device(*_a):
        if outcome == "False":
            return False
        raise (ValueError if outcome == "ValueError" else RuntimeError)("planned")

    monkeypatch.setattr(TF, "_verify_shares_device", device)
    if outcome == "RuntimeError":
        with pytest.raises(RuntimeError, match="^planned$"):
            TF.verify_shares_batch(items, "cpu")
    else:
        TF.verify_shares_batch(items, "cpu")
    assert G.BREAKER.state == G.HALF_OPEN and TF.device_gate(6)
    assert not TF.device_gate(6)                   # one probe in flight at a time


# ---------------------------------------------------------------------------
# the watchdog of the submit front door
# ---------------------------------------------------------------------------


def _stub_slot(monkeypatch, finish):
    def stub(batches, pks, msgs, device, pk_cache, h2c, pairing_path, times=None,
             verify="device"):
        return finish(batches)

    monkeypatch.setattr(PA, "threshold_aggregate_and_verify", stub)


def test_the_watchdog_recovers_a_hung_slot(slot, monkeypatch):
    """A slot whose readback hangs past 0.15 s resolves from the native rung
    (the reference's bytes), counted once; the slot queued behind it runs
    again on a fresh slot thread; the next one too; the late result is
    dropped."""
    release = threading.Event()
    threads = []

    def finish(batches):
        threads.append(threading.current_thread())
        if len(threads) == 1:
            assert release.wait(10), "test gate never released"
            return ["late"], False
        return [b"\xaa" * 96], True

    _stub_slot(monkeypatch, finish)
    args = (slot["batches"], slot["pks"], slot["msgs"])
    impl = TI.TorchImpl(device="cpu", verify="native")
    try:
        monkeypatch.setenv(POL.ENV_SLOT_DEADLINE, "0.15")
        hung = impl.threshold_aggregate_verify_submit(*args)
        monkeypatch.setenv(POL.ENV_SLOT_DEADLINE, "5")
        queued = impl.threshold_aggregate_verify_submit(*args)
        aggs, ok = hung.result(timeout=10)
        assert ([bytes(a) for a in aggs], ok) == ref_native_slot(*args)
        assert queued.result(timeout=10) == ([b"\xaa" * 96], True)
        assert impl.threshold_aggregate_verify_submit(*args).result(timeout=10) == (
            [b"\xaa" * 96], True)
        assert threads[1] is not threads[0] and threads[2] is threads[1]
        assert G.counters() == {"fallback": {("watchdog_timeout", "native"): 1},
                                "watchdog": 1, "breaker": G.CLOSED}
    finally:
        release.set()
    assert hung.result()[1] is True


def test_the_watchdog_off_and_with_the_fallback_off(slot, monkeypatch):
    """A deadline of 0 disables the watchdog: a slow slot's own result.
    With fallback_on_device_error off an expiry is a TimeoutError."""
    release = threading.Event()

    def finish(batches):
        release.wait(0.4)
        return [b"\xbb" * 96], True

    _stub_slot(monkeypatch, finish)
    args = (slot["batches"], slot["pks"], slot["msgs"])
    impl = TI.TorchImpl(device="cpu", verify="native")
    monkeypatch.setenv(POL.ENV_SLOT_DEADLINE, "0")
    assert impl.threshold_aggregate_verify_submit(*args).result(timeout=10) == (
        [b"\xbb" * 96], True)
    assert G.watchdog_total() == 0
    impl.fallback_on_device_error = False
    monkeypatch.setenv(POL.ENV_SLOT_DEADLINE, "0.15")
    try:
        exc = impl.threshold_aggregate_verify_submit(*args).exception(timeout=10)
        assert isinstance(exc, TimeoutError) and "watchdog" in str(exc)
        assert G.counters() == {"fallback": {}, "watchdog": 1, "breaker": G.CLOSED}
    finally:
        release.set()


# ---------------------------------------------------------------------------
# the ceremony
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """Node 1's share checks of 3 dealers at threshold 2 (native round 1)."""
    rounds = [RFROST.Participant(i, 2, 3, b"guard ctx").round1() for i in (1, 2, 3)]
    return [(1, s[1], b.commitments) for b, s in rounds]


def _verdict(fn, batch):
    try:
        fn(batch)
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))
    return None


@pytest.mark.parametrize("case", ["valid", "tampered"])
def test_a_frost_msm_fault_gives_the_reference_s_verdict(items, case, monkeypatch):
    """Both packages' share checks past their gates with frost.msm planned:
    both degrade to the per-item native check, with the same verdict or
    error text; the port counts the checks as native and the fallback."""
    batch = list(items)
    if case == "tampered":
        mi, sh, cm = batch[1]
        batch[1] = (mi, (sh + 1) % PF.R, cm)
    monkeypatch.setattr(RFROST, "_interpreted", lambda: False)
    monkeypatch.setattr(RFROST, "_DEVICE_MIN_POINTS", 0)
    monkeypatch.setattr(TF, "_DEVICE_MIN_POINTS", 0)
    monkeypatch.setattr(TF, "_verify_shares_device", lambda *a: pytest.fail("device path ran"))
    RFAULTS.arm([{"site": "frost.msm"}])
    faults.arm([{"site": "frost.msm"}])
    before, fell = TF.MSM_PATHS["native"], TF.FALLBACKS["frost.msm", "device_lost"]
    got = _verdict(lambda b: TF.verify_shares_batch(b, "cpu"), batch)
    assert got == _verdict(RFROST.verify_shares_batch, batch)
    assert (got is None) is (case == "valid")
    assert TF.MSM_PATHS["native"] - before == (3 if case == "valid" else 1)
    assert TF.FALLBACKS["frost.msm", "device_lost"] == fell + 1
    assert G.fallback_total("device_lost") == 1 and RG.BREAKER.state == G.BREAKER.state


def test_the_ceremony_gate_and_keygen_fallback(items, monkeypatch):
    """An open breaker closes device_gate; a device-class failure of the
    batched keygen gives native keygen's bytes, other errors raise."""
    monkeypatch.setattr(TF, "_DEVICE_MIN_POINTS", 0)
    assert TF.device_gate(6)
    G.configure(threshold=1, cooldown=60.0)
    G.BREAKER.record_failure()
    assert not TF.device_gate(6)
    monkeypatch.setattr(TF, "DEVICE_KEYGEN", True)
    monkeypatch.setattr(TF, "_DEVICE_MIN_KEYGEN", 0)
    scalars = [3, 5, 7]
    monkeypatch.setattr(PA, "g1_mul_gen_batch",
                        lambda s, d: (_ for _ in ()).throw(faults.DeviceLostFault("lost")))
    before = TF.FALLBACKS["keygen", "device_lost"]
    assert TF._mul_gen_many(scalars, "cpu") == [native.pubkey(k.to_bytes(32, "big"))
                                                for k in scalars]
    assert TF.FALLBACKS["keygen", "device_lost"] == before + 1
    monkeypatch.setattr(PA, "g1_mul_gen_batch",
                        lambda s, d: (_ for _ in ()).throw(RuntimeError("kernel bug")))
    with pytest.raises(RuntimeError, match="kernel bug"):
        TF._mul_gen_many(scalars, "cpu")
