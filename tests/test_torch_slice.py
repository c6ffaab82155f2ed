"""The whole slice on the CPU: TorchImpl(device="cpu") against the JAX
package's TPUImpl (which routes a small batch to its native path on a CPU
host) on the same V=8, 4-of-6, two-message inputs — identical aggregate
bytes and verdicts, the bad_pk contract, the parse error, the tbls facade —
and the plain-path call counts of one slot, which pin that the slot goes
through every kernel."""

import random

import pytest
import torch

import charon_tpu.tbls as tbls
from charon_tpu.crypto import fields as RPF
from charon_tpu.ops import plane_agg as RPA
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.tbls.tpu_impl import TPUImpl
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.tbls.torch_impl import TorchImpl

V, N, T = 8, 6, 4
MSGS = [b"\x42" * 32, b"\x07" * 32]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cluster(native, seed, V, total, threshold):
    rng = random.Random(seed)
    batches, pks, datas = [], [], []
    for v in range(V):
        sk = rng.randrange(1, RPF.R)
        coeffs = [sk] + [rng.randrange(RPF.R) for _ in range(threshold - 1)]
        ids = sorted(rng.sample(range(1, total + 1), threshold))
        msg = MSGS[v % 2]
        pks.append(native.secret_to_public_key(PrivateKey(sk.to_bytes(32, "big"))))
        batches.append({i: native.sign(PrivateKey(
            (sum(c * i ** k for k, c in enumerate(coeffs)) % RPF.R).to_bytes(32, "big")), msg)
            for i in ids})
        datas.append(msg)
    return batches, pks, datas


@pytest.fixture(scope="module")
def slot():
    """One TorchImpl for the module (its pk cache is shared by the tests) and
    the first slot's plain-path call counts."""
    native = NativeImpl()
    batches, pks, datas = _cluster(native, 8, V, N, T)
    impl = TorchImpl(device="cpu")
    CP.reset_counts()
    aggs, ok = impl.threshold_aggregate_verify_batch(batches, pks, datas)
    calls = {k: dict(v.plain_calls) for k, v in CP.KERNELS.items()}
    launches = {k: dict(v.launches) for k, v in CP.KERNELS.items()}
    return dict(impl=impl, native=native, batches=batches, pks=pks, datas=datas,
                aggs=aggs, ok=ok, calls=calls, launches=launches)


def test_slot_bytes_and_verdict_match_the_jax_package(slot):
    ref_aggs, ref_ok = TPUImpl().threshold_aggregate_verify_batch(
        slot["batches"], slot["pks"], slot["datas"])
    assert slot["ok"] is True and ref_ok is True
    assert [bytes(a) for a in slot["aggs"]] == [bytes(a) for a in ref_aggs]
    assert slot["impl"].pairing_path["native"] >= 1


def test_tampered_partial_fails_on_both(slot):
    batches = [dict(b) for b in slot["batches"]]
    i = sorted(batches[3])[0]
    batches[3][i] = slot["batches"][4][sorted(slot["batches"][4])[0]]
    aggs, ok = slot["impl"].threshold_aggregate_verify_batch(batches, slot["pks"], slot["datas"])
    ref_aggs, ref_ok = TPUImpl().threshold_aggregate_verify_batch(
        batches, slot["pks"], slot["datas"])
    assert ok is False and ref_ok is False
    assert [bytes(a) for a in aggs] == [bytes(a) for a in ref_aggs]


def test_invalid_pubkey_keeps_the_aggregates_and_fails(slot):
    pks = list(slot["pks"])
    pks[5] = bytes([pks[5][0] & 0x7F]) + bytes(pks[5][1:])      # not compressed
    aggs, ok = slot["impl"].threshold_aggregate_verify_batch(slot["batches"], pks, slot["datas"])
    ref_aggs, ref_ok = TPUImpl().threshold_aggregate_verify_batch(slot["batches"], pks,
                                                                   slot["datas"])
    assert ok is False and ref_ok is False
    assert [bytes(a) for a in aggs] == [bytes(a) for a in ref_aggs] == \
        [bytes(a) for a in slot["aggs"]]


def test_bad_partial_encoding_raises_on_both(slot):
    batches = [dict(b) for b in slot["batches"]]
    i = sorted(batches[6])[2]
    batches[6][i] = bytes([batches[6][i][0] & 0x7F]) + bytes(batches[6][i][1:])
    with pytest.raises(ValueError) as device_text:
        RPA._parse_compressed([bytes(s) for b in batches for s in b.values()], 96, "G2",
                              False, 128)
    with pytest.raises(ValueError) as ours:
        slot["impl"].threshold_aggregate_verify_batch(batches, slot["pks"], slot["datas"])
    with pytest.raises(ValueError):
        TPUImpl().threshold_aggregate_verify_batch(batches, slot["pks"], slot["datas"])
    assert str(ours.value) == str(device_text.value) == "uncompressed G2 not supported"


def test_empty_and_mismatched_inputs_raise(slot):
    impl = slot["impl"]
    with pytest.raises(ValueError, match="no partial signatures"):
        impl.threshold_aggregate_verify_batch([{}], slot["pks"][:1], slot["datas"][:1])
    with pytest.raises(ValueError, match="length mismatch"):
        impl.threshold_aggregate_verify_batch(slot["batches"], slot["pks"][:3], slot["datas"])
    assert impl.threshold_aggregate_verify_batch([], [], []) == ([], True)


def test_facade_threshold_aggregate_gives_native_bytes():
    native = NativeImpl()
    batches, _pks, _datas = _cluster(native, 9, 1, 3, 2)
    prev = tbls.get_implementation()
    try:
        tbls.set_implementation(TorchImpl(device="cpu"))
        got = tbls.threshold_aggregate(batches[0])
    finally:
        tbls.set_implementation(prev)
    assert bytes(got) == bytes(native.threshold_aggregate(batches[0]))


def test_one_slot_goes_through_every_kernel(slot):
    """Plain-path calls of the first V=8 slot (pk plane decoded), by kernel
    and E. The point ops follow from the slot's structure (Vp=128, T=4,
    G=2 groups): pt_double<2> = (7 + 64·4) sweep + (7 + 16·4) MSM = 334;
    pt_add<2> = (7 + 64) sweep + 3 combine + (7 + 16) MSM + 3·(1 + 2)
    reduction trees = 106; pt_double<1> / pt_add<1> are [u²]P's 127
    doublings and 16 adds (the pk subgroup check). fe_mul<1> is dominated by
    four 494-product power scans (sqrt, (p−3)/4, p−2, G1 sqrt)."""
    assert slot["calls"] == {
        "fe_mul": {1: 2014, 2: 6}, "fe_add": {1: 6, 2: 1}, "fe_sub": {1: 7, 2: 1},
        "pt_double": {1: 127, 2: 334}, "pt_add": {1: 16, 2: 106}}
    u2 = RPF.X_ABS * RPF.X_ABS
    assert slot["calls"]["pt_double"][1] == u2.bit_length() - 1
    assert slot["calls"]["pt_add"][1] == bin(u2).count("1") - 1
    assert all(c == {1: 0, 2: 0} for c in slot["launches"].values())
