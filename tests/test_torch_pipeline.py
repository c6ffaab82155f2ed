"""The port's submit front door (TorchImpl.threshold_aggregate_verify_submit
and _overlapped on the device's slot thread, charon_tpu_torch/tbls/
torch_impl.py): the call returns before its slot runs; slots run one at a
time in submission order, from one thread or several; every error (input
validation, a bad encoding, an invalid partial, a device error) and a bad
pubkey set's (aggregates, False) arrive through the slot's Future without
touching the slots around it; the tbls facade reaches it; one real V = 2
slot on the CPU is byte-identical to the serial call. Then the launch
counters under threads and the port's environment knob against the
reference's."""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from charon_tpu import tbls as RT
from charon_tpu.ops import policy as RPOL
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.ops import policy as POL
from charon_tpu_torch.tbls import torch_impl as TI

SIG = b"\xc0" + b"\x00" * 95          # the compressed point at infinity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stub_slot(monkeypatch, finish):
    """The serial slot's body replaced: `finish(batches)` returns
    (aggregates, ok) or raises; it runs where the slot runs."""
    def slot(batches, pks, msgs, device, pk_cache, h2c, pairing_path, times=None,
             verify="device"):
        return finish(batches)

    monkeypatch.setattr(PA, "threshold_aggregate_and_verify", slot)


def _tag(batches) -> bytes:
    """A slot's name, carried in its one partial's index."""
    return bytes([next(iter(batches[0]))]) * 96


def _batch(k: int) -> list[dict[int, bytes]]:
    return [{k: SIG}]


def test_submit_returns_before_the_slot_runs(monkeypatch):
    """The Future comes back while the slot is still held; it settles on
    the slot thread, not on the caller's."""
    release, ran_on = threading.Event(), []

    def finish(batches):
        ran_on.append(threading.current_thread())
        assert release.wait(30), "test gate never released"
        return [_tag(batches)], True

    _stub_slot(monkeypatch, finish)
    impl = TI.TorchImpl(device="cpu")
    try:
        fut = impl.threshold_aggregate_verify_submit(_batch(1), [b"pk"], [b"m"])
        assert not fut.done()
    finally:
        release.set()
    aggs, ok = fut.result(timeout=30)
    assert ok is True and aggs == [_tag(_batch(1))]
    assert ran_on[0] is not threading.current_thread()
    assert ran_on[0].name.startswith("sigagg-slot-cpu")


def test_slots_run_one_at_a_time_in_submission_order(monkeypatch):
    """Eight slots submitted back to back run in order, never two at once."""
    running, peak, order, lock = [0], [0], [], threading.Lock()

    def finish(batches):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        order.append(next(iter(batches[0])))
        threading.Event().wait(0.005)
        with lock:
            running[0] -= 1
        return [_tag(batches)], True

    _stub_slot(monkeypatch, finish)
    impl = TI.TorchImpl(device="cpu")
    futs = [impl.threshold_aggregate_verify_submit(_batch(k), [b"pk"], [b"m"])
            for k in range(1, 9)]
    assert [f.result(timeout=30)[0] for f in futs] == [[_tag(_batch(k))] for k in range(1, 9)]
    assert order == list(range(1, 9)) and peak[0] == 1


def test_slots_from_several_threads_share_one_slot_thread(monkeypatch):
    """Four submitting threads, two TorchImpls on one device: every slot
    runs on the same thread, one at a time, each Future its own slot's."""
    running, peak, threads, lock = [0], [0], set(), threading.Lock()

    def finish(batches):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
            threads.add(threading.current_thread().name)
        threading.Event().wait(0.002)
        with lock:
            running[0] -= 1
        return [_tag(batches)], True

    _stub_slot(monkeypatch, finish)
    impls = [TI.TorchImpl(device="cpu"), TI.TorchImpl(device="cpu")]
    got = {}

    def submit(t):
        for k in range(4):
            idx = 1 + 4 * t + k
            got[idx] = impls[t % 2].threshold_aggregate_verify_submit(_batch(idx), [b"pk"],
                                                                      [b"m"])

    workers = [threading.Thread(target=submit, args=(t,)) for t in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert sorted(got) == list(range(1, 17))
    assert all(f.result(timeout=30) == ([_tag(_batch(k))], True) for k, f in got.items())
    assert peak[0] == 1 and len(threads) == 1


def test_an_invalid_partial_arrives_through_the_future(monkeypatch):
    """A slot's ValueError is its Future's exception; the slots before and
    after it settle with their own results."""
    def finish(batches):
        if next(iter(batches[0])) == 2:
            raise ValueError("invalid partial signature at index 0")
        return [_tag(batches)], True

    _stub_slot(monkeypatch, finish)
    impl = TI.TorchImpl(device="cpu")
    f1, f2, f3 = [impl.threshold_aggregate_verify_submit(_batch(k), [b"pk"], [b"m"])
                  for k in (1, 2, 3)]
    assert f1.result(timeout=30) == ([_tag(_batch(1))], True)
    with pytest.raises(ValueError, match="invalid partial signature"):
        f2.result(timeout=30)
    assert f3.result(timeout=30) == ([_tag(_batch(3))], True)


def test_a_device_error_propagates_through_the_future(monkeypatch):
    """No fallback: a RuntimeError of the slot is the Future's exception,
    and overlapped raises it."""
    def finish(batches):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    _stub_slot(monkeypatch, finish)
    impl = TI.TorchImpl(device="cpu")
    exc = impl.threshold_aggregate_verify_submit(_batch(1), [b"pk"], [b"m"]).exception(timeout=30)
    assert isinstance(exc, RuntimeError) and "illegal memory access" in str(exc)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        impl.threshold_aggregate_verify_overlapped(_batch(1), [b"pk"], [b"m"])


@pytest.mark.parametrize("batches, pks, msgs, match", [
    ([{1: SIG}], [b"pk", b"pk"], [b"m"], "length mismatch"),
    ([{}], [b"pk"], [b"m"], "no partial signatures"),
])
def test_input_validation_arrives_through_the_future(batches, pks, msgs, match):
    """A length mismatch and an empty partial set: the call returns, its
    Future carries the serial call's ValueError."""
    fut = TI.TorchImpl(device="cpu").threshold_aggregate_verify_submit(batches, pks, msgs)
    with pytest.raises(ValueError, match=match):
        fut.result(timeout=30)


def test_a_bad_encoding_arrives_through_the_future():
    """A partial without the compression flag is rejected by the real
    parse, through the Future."""
    native = NativeImpl()
    sk = PrivateKey((7).to_bytes(32, "big"))
    good = bytes(native.sign(sk, b"\x01" * 32))
    bad = bytes([good[0] & 0x7F]) + good[1:]
    fut = TI.TorchImpl(device="cpu").threshold_aggregate_verify_submit(
        [{1: bad, 2: bad}], [bytes(native.secret_to_public_key(sk))], [b"\x01" * 32])
    with pytest.raises(ValueError):
        fut.result(timeout=60)


def test_no_slots_give_an_empty_true():
    fut = TI.TorchImpl(device="cpu").threshold_aggregate_verify_submit([], [], [])
    assert fut.result(timeout=30) == ([], True)


def test_bad_pk_slot_gives_aggregates_and_false(monkeypatch):
    """The real emit of a bad pubkey set, on the slot thread: the
    aggregates (plane_agg.aggregate of its layout) and the verdict False."""
    monkeypatch.setattr(PA, "fused_slot", lambda layout, pks, msgs, device, cache: ("bad_pk",
                                                                                     "layout"))
    monkeypatch.setattr(PA, "aggregate", lambda layout, device: [b"\xaa" * 96])
    got = TI.TorchImpl(device="cpu").threshold_aggregate_verify_submit(
        _batch(1), [b"pk"], [b"m"]).result(timeout=30)
    assert got == ([b"\xaa" * 96], False)


def test_host_emit_invalid_lane_raises_through_the_future(monkeypatch):
    """The real emit (plane_agg.host_emit): an ok mask with a bad lane
    raises the serial path's indexed ValueError through the Future."""
    host = (np.array([True, False, True]), None, None, None, None, None)
    monkeypatch.setattr(PA, "fused_slot", lambda layout, pks, msgs, device, cache: "pending")
    monkeypatch.setattr(PA, "readback", lambda state: ("host", 3, [], host))
    exc = TI.TorchImpl(device="cpu").threshold_aggregate_verify_submit(
        _batch(1), [b"pk"], [b"m"]).exception(timeout=30)
    assert isinstance(exc, ValueError) and "index 1" in str(exc)


def test_the_facade_submit_reaches_torchimpl(monkeypatch):
    """With TorchImpl installed behind the tbls seam, the facade's submit
    and overlapped are the impl's (its slot thread), not the facade's
    inline fallback."""
    callers = []

    def finish(batches):
        callers.append(threading.current_thread())
        return [_tag(batches)], True

    _stub_slot(monkeypatch, finish)
    prev = RT.get_implementation()
    RT.set_implementation(TI.TorchImpl(device="cpu", verify="native"))
    try:
        fut = RT.threshold_aggregate_verify_submit(_batch(4), [b"pk"], [b"m"])
        assert fut.result(timeout=30) == ([_tag(_batch(4))], True)
        assert RT.threshold_aggregate_verify_overlapped(_batch(5), [b"pk"], [b"m"]) == (
            [_tag(_batch(5))], True)
    finally:
        RT.set_implementation(prev)
    assert callers and all(t is not threading.current_thread() for t in callers)


def test_one_slot_thread_per_device():
    assert TI.slot_thread("cpu") is TI.slot_thread(torch.device("cpu"))
    assert TI.slot_thread("cuda:1") is not TI.slot_thread("cpu")
    assert TI.slot_thread("cpu")._max_workers == 1


def _cluster(V: int, threshold: int, total: int, seed: int):
    native = NativeImpl()
    rng = random.Random(seed)
    batches, pks, msgs = [], [], []
    for v in range(V):
        sk = rng.randrange(1, PF.R)
        coeffs = [sk] + [rng.randrange(PF.R) for _ in range(threshold - 1)]
        ids = sorted(rng.sample(range(1, total + 1), threshold))
        msg = bytes([0x30 + v]) * 32
        pks.append(bytes(native.secret_to_public_key(PrivateKey(sk.to_bytes(32, "big")))))
        batches.append({i: bytes(native.sign(PrivateKey(
            (sum(c * i ** k for k, c in enumerate(coeffs)) % PF.R).to_bytes(32, "big")), msg))
            for i in ids})
        msgs.append(msg)
    return batches, pks, msgs


def test_a_real_slot_through_submit_is_the_serial_slot():
    """V = 2 validators at 2-of-3 on the CPU, native rung: the submitted
    Future holds the serial call's aggregate bytes and verdict, and so does
    the overlapped call."""
    batches, pks, msgs = _cluster(2, 2, 3, 31)
    impl = TI.TorchImpl(device="cpu", verify="native")
    want, ok = impl.threshold_aggregate_verify_batch(batches, pks, msgs)
    got, ok_s = impl.threshold_aggregate_verify_submit(batches, pks, msgs).result(timeout=120)
    got_o, ok_o = impl.threshold_aggregate_verify_overlapped(batches, pks, msgs)
    assert ok is True and ok_s is True and ok_o is True
    assert [bytes(a) for a in got] == [bytes(a) for a in want] == [bytes(a) for a in got_o]
    assert impl.pairing_path == {"device": 0, "native": 9}


def test_launch_counters_are_exact_under_threads():
    """Kernel.count holds one lock: 16 threads counting at once, switching
    every microsecond, lose no update."""
    prev = sys.getswitchinterval()
    kern = CP.Kernel("fe_mul", "site")
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(2000):
                kern.count(1, 8, (1, 8, i % 4))
                kern.count(2, plain=True)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert kern.launches == {1: 32000, 2: 0} and kern.plain_calls == {1: 0, 2: 32000}
    assert kern.widths == {(1, 8): 32000} and sum(kern.cases.values()) == 32000


def test_the_port_policy_resolves_as_the_reference(monkeypatch):
    """The H(m) cache cap from the same environment variable and default as
    charon_tpu/ops/policy.py, and into a new TorchImpl's cache."""
    monkeypatch.delenv("CHARON_TPU_H2C_CACHE_CAP", raising=False)
    assert POL.h2c_cache_cap_default() == RPOL.h2c_cache_cap_default() == 4096
    for raw, want in (("17", 17), ("0", 0), ("x", 4096)):
        monkeypatch.setenv("CHARON_TPU_H2C_CACHE_CAP", raw)
        assert POL.h2c_cache_cap_default() == RPOL.h2c_cache_cap_default() == want
    monkeypatch.setenv("CHARON_TPU_H2C_CACHE_CAP", "0")
    assert TI.TorchImpl(device="cpu").h2c.cap == 0
