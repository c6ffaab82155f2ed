"""The whole slice on the CPU: TorchImpl(device="cpu") — verifying on the
device path by default, or on the native rung with verify="native" —
against the JAX package's TPUImpl (which routes a small batch to its native
path on a CPU host) on the same V=8, 4-of-6, two-message inputs: identical
aggregate bytes and verdicts, the bad_pk contract, the parse error, the tbls
facade; the pairs counted per rung; the dual-form H(m) cache's cap, cap-0
and upgrade-in-place semantics (tests/test_device_verify.py:259-305); the
degenerate pairing rules and the absence of any fallback; and the
plain-path call counts of one slot and of one verify, which pin that the
slot goes through every kernel and the verify through the rows kernels."""

import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import charon_tpu.tbls as tbls
from charon_tpu.crypto import fields as RPF
from charon_tpu.crypto.curve import Fq2Ops as RFq2Ops
from charon_tpu.crypto.curve import to_affine as r_to_affine
from charon_tpu.crypto.hash_to_curve import DST_ETH, hash_to_g2
from charon_tpu.ops import plane_agg as RPA
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.tbls.tpu_impl import TPUImpl
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch import native as PN
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import h2c as H
from charon_tpu_torch.ops import pairing as PR
from charon_tpu_torch.ops import plane_agg as PA
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
    """One TorchImpl for the module (its pk and H(m) caches are shared by the
    tests), the first slot's plain-path call counts, and the (S, group
    points) its verify received."""
    native = NativeImpl()
    batches, pks, datas = _cluster(native, 8, V, N, T)
    impl = TorchImpl(device="cpu")
    seen = []
    real = PA.pairing_finish
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PA, "pairing_finish", lambda S, pts, *a: seen.append((S, pts)) or real(S, pts, *a))
        CP.reset_counts()
        aggs, ok = impl.threshold_aggregate_verify_batch(batches, pks, datas)
    calls = {k: dict(v.plain_calls) for k, v in CP.KERNELS.items()}
    launches = {k: dict(v.launches) for k, v in CP.KERNELS.items()}
    cases = {k: dict(CP.KERNELS[k].cases)
             for k in ("pt_mul_shared", "pt_mul_windowed", "fe_mul", "fe_addsub", "pt_reduce_groups")}
    return dict(impl=impl, native=native, batches=batches, pks=pks, datas=datas,
                aggs=aggs, ok=ok, calls=calls, launches=launches, cases=cases, pairs=seen[0],
                pairing_path=dict(impl.pairing_path))


def _tampered(slot):
    batches = [dict(b) for b in slot["batches"]]
    i = sorted(batches[3])[0]
    batches[3][i] = slot["batches"][4][sorted(slot["batches"][4])[0]]
    return batches


def test_slot_bytes_and_verdict_match_the_jax_package(slot):
    ref_aggs, ref_ok = TPUImpl().threshold_aggregate_verify_batch(
        slot["batches"], slot["pks"], slot["datas"])
    assert slot["ok"] is True and ref_ok is True
    assert [bytes(a) for a in slot["aggs"]] == [bytes(a) for a in ref_aggs]
    assert slot["impl"].rung == "device"


def test_pairing_path_counts_pairs(slot):
    """Two message groups and the signature pair: 3 pairs on the device
    rung (the reference's ops_pairing_total{path} counts pairs, not calls)."""
    assert slot["pairing_path"] == {"device": 3, "native": 0}


def test_native_rung_gives_the_same_verdicts(slot):
    impl = TorchImpl(device="cpu", verify="native")
    impl.pk_cache = slot["impl"].pk_cache
    aggs, ok = impl.threshold_aggregate_verify_batch(slot["batches"], slot["pks"], slot["datas"])
    assert ok is True and [bytes(a) for a in aggs] == [bytes(a) for a in slot["aggs"]]
    assert impl.pairing_path == {"device": 0, "native": 3}
    batches = _tampered(slot)
    _aggs, ok_t = impl.threshold_aggregate_verify_batch(batches, slot["pks"], slot["datas"])
    _r, ref_ok = TPUImpl().threshold_aggregate_verify_batch(batches, slot["pks"], slot["datas"])
    assert ok_t is False and ref_ok is False
    assert impl.pairing_path == {"device": 0, "native": 6}
    assert impl.last_times.verify > 0


def test_unknown_verify_rung_raises():
    with pytest.raises(ValueError, match="verify"):
        TorchImpl(device="cpu", verify="tpu")
    with pytest.raises(ValueError, match="verify"):
        PA.pairing_finish(None, [], PA.H2CCache(), {}, "gpu")


def test_tampered_partial_fails_on_both(slot):
    batches = _tampered(slot)
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


# A verify of 3 pairs (bucket 4, H(m) cached): 63 doubling and 5 addition
# steps, the two-level Fq12 fold and one final exponentiation. The device
# hash-to-G2 of one batch: five p-sized power scans and the affine
# inversion's, one fe_pow<rows> each, plus the SSWU, isogeny and affine
# products. Plain calls by rows kernel, by E (fe_mul_rows<2> is a whole Fq2
# product, fe_add_rows also subtracts past its split, and at n_add = 0 is a
# subtraction) or, for fe_pow, by layout
VERIFY_CALLS = {"fe_mul_rows": {1: 70, 2: 700}, "fe_add_rows": {1: 4016},
                "fe_pow": {"plane": 0, "rows": 1}}
H2C_CALLS = {"fe_mul_rows": {1: 11, 2: 18}, "fe_add_rows": {1: 17},
             "fe_pow": {"plane": 0, "rows": 6}}


def test_one_slot_goes_through_every_kernel(slot):
    """Plain-path calls of the first V=8 slot (pk plane decoded, both
    messages hashed on the device path, device verify), by kernel and E.
    The scalar multiplications are one call each: the Lagrange sweep
    (Vp·T = 512 lanes, 64 windows) and the combined RLC MSM (256 lanes, 16
    windows) pt_mul_windowed<2>, the pk subgroup check's [u²]P
    pt_mul_shared<1> and the device hash-to-G2's cofactor clear
    pt_mul_shared<2>; the MSM's sums are one pt_reduce_groups<2> call (the
    signatures and G = 2 message groups); what is left of the point ops is
    pt_add<2>: 3 combine + hash-to-G2's q0 + q1 = 4. Everything else of
    the verify runs on the rows kernels.
    The four plane power scans (the G2 partials' sqrt and (p−3)/4, the
    affine p−2, the G1 sqrt) are one fe_pow<plane> call each. The plane
    field kernels take a level of independent operations a call: fe_mul 19
    levels at E = 1 and 5 at E = 2, fe_addsub 8 and 2. The DKG's group
    reduction at E = 1 is not called."""
    rows = {k: {E: c + H2C_CALLS[k][E] for E, c in v.items()} for k, v in VERIFY_CALLS.items()}
    rows["fe_pow"]["plane"] = 4
    assert slot["calls"] == {
        "fe_mul": {1: 19, 2: 5}, "fe_addsub": {1: 8, 2: 2},
        "pt_double": {1: 0, 2: 0}, "pt_add": {1: 0, 2: 4}, **rows,
        "pt_mul_shared": {1: 1, 2: 1}, "pt_mul_windowed": {1: 0, 2: 2},
        "pt_reduce_groups": {1: 0, 2: 1}}
    assert slot["cases"]["pt_mul_shared"] == {(1, 128, RPF.X_ABS * RPF.X_ABS): 1,
                                              (2, 2, H.H_EFF_G2): 1}
    assert slot["cases"]["pt_mul_windowed"] == {(2, 512, 64): 1, (2, 256, 16): 1}
    assert slot["cases"]["pt_reduce_groups"] == {(2, 256, 3): 1}
    assert all(c == {E: 0 for E in c} for c in slot["launches"].values())


def test_first_slot_dispatch_steps(slot):
    """The launches of a first slot's dispatch by step (pk plane decoded),
    one message as the 1000 × 4-of-6 headline: 50, of which pk plane 12
    (G1 decompression in 7 launches and the subgroup check's one
    pt_mul_shared<1>, a negation and 3 product levels), G2 decompression 19
    (17 field levels and 2 fe_pow), sweep + combine 4 (one
    pt_mul_windowed<2>, 3 pt_add<2>), the affine standard form 8 (7 field
    levels and one fe_pow) and MSM + group sums 2 (one pt_mul_windowed<2>
    and one pt_reduce_groups<2> call). Vp = 128 here and 1,024 at the
    headline launch the same, so the counts are the headline's."""
    steps = []

    def mark(name):
        steps.append((name, sum(sum(k.plain_calls.values()) for k in CP.KERNELS.values())))
        CP.reset_counts()

    CP.reset_counts()
    state = PA.fused_slot(PA.layout_slots(slot["batches"]), slot["pks"], [MSGS[0]] * V,
                          torch.device("cpu"), PA.PkPlaneCache(), mark=mark)
    assert state[0] == "pending"
    assert [c for _name, c in steps] == [0, 12, 0, 19, 4, 8, 2]
    assert steps[1][0].startswith("pk plane") and steps[4][0] == "Lagrange sweep + combine"


def test_the_field_levels_are_chip_smokes(slot):
    """The first slot's field levels, (kernel, E, shape) -> calls, are
    chip_smoke.slot_levels at this slot's widths (Vp = 128 validators a
    bucket, 512 partials), which FE_AB takes at the headline's to time every
    level the card launches."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.fe_cases(slot["cases"]) == chip_smoke.slot_levels(128, 512)


def test_one_verify_goes_through_the_rows_kernels(slot):
    """A steady verify (H(m) cached) runs on the rows kernels only."""
    S, pts = slot["pairs"]
    CP.reset_counts()
    assert PA.pairing_finish(S, pts, slot["impl"].h2c, {}, "device", torch.device("cpu"))
    calls = {k: dict(v.plain_calls) for k, v in CP.KERNELS.items()}
    assert calls == {"fe_mul": {1: 0, 2: 0}, "fe_addsub": {1: 0, 2: 0},
                     "pt_double": {1: 0, 2: 0}, "pt_add": {1: 0, 2: 0}, **VERIFY_CALLS,
                     "pt_mul_shared": {1: 0, 2: 0}, "pt_mul_windowed": {1: 0, 2: 0},
                     "pt_reduce_groups": {1: 0, 2: 0}}


# ---------------------------------------------------------------------------
# The dual-form H(m) cache (tests/test_device_verify.py:259-305)
# ---------------------------------------------------------------------------


def _host_affine(m: bytes):
    return r_to_affine(RFq2Ops, hash_to_g2(m, DST_ETH))


def _ints(row) -> tuple:
    return tuple(F.fq_ints(row.numpy()))


def test_device_h2c_entries_hold_both_forms(slot):
    """The slot's misses went to the device hash-to-G2 in one batch and were
    stored as [compressed, rows]: bytes equal native ct_hash_to_g2, rows the
    host reference's affine point; a second lookup is all hits."""
    h2c = slot["impl"].h2c
    for m in MSGS:
        comp, planes = h2c.entry(m)
        assert comp == PN.hash_to_g2(m)
        assert (_ints(planes[0]), _ints(planes[1])) == _host_affine(m)
    hits = h2c.hits
    hx, hy = h2c.planes(MSGS, "cpu")
    assert h2c.hits == hits + 2
    assert hx.shape == (2, 2, 12) and hx.dtype == torch.int32


def test_h2c_upgrades_a_bytes_entry_in_place():
    h2c = PA.H2CCache()
    m = b"upgrade-entry"
    comp = h2c.get(m)
    assert h2c.entry(m)[1] is None and h2c.misses == 1
    hx, hy = h2c.planes([m], "cpu")
    assert h2c.hits == 1 and h2c.misses == 1
    assert h2c.entry(m)[1] is not None
    assert (_ints(hx[0]), _ints(hy[0])) == _host_affine(m)
    assert h2c.get(m) == comp


def test_h2c_cap_and_cap_zero(monkeypatch):
    assert PA.H2CCache().cap == 4096
    h2c = PA.H2CCache(cap=2)
    for m in (b"a", b"b", b"c"):
        h2c.get(m)
    assert h2c.entry(b"a") is None and h2c.entry(b"c") is not None
    assert h2c.set_cap(1) == 2 and h2c.entry(b"b") is None
    # cap 0 stores nothing, through either accessor (the device map is
    # replaced by the host reference here)
    monkeypatch.setattr(H, "hash_to_g2_device", lambda msgs, device: tuple(
        torch.as_tensor(F.fq_rows([c for m in msgs for c in _host_affine(m)[k]]).reshape(-1, 2, 12))
        for k in (0, 1)))
    off = PA.H2CCache(cap=0)
    off.get(b"uncached")
    hx, _hy = off.planes([b"uncached"], "cpu")
    assert off.entry(b"uncached") is None and off.misses == 2
    assert _ints(hx[0]) == _host_affine(b"uncached")[0]
    assert off.planes([], "cpu")[0].shape == (0, 2, 12)


# ---------------------------------------------------------------------------
# Degenerate pairs and no fallback
# ---------------------------------------------------------------------------


def test_degenerate_pairing_rules(slot, monkeypatch):
    """An infinity P_m drops its pair; an infinity S verifies only when no
    pair is left — on either rung."""
    S, pts = slot["pairs"]
    inf1, inf2 = PC.jac_infinity(PC.FqOps), PC.jac_infinity(PC.Fq2Ops)
    for rung in ("device", "native"):
        path = {}
        assert PA.pairing_finish(inf2, [(b"m", inf1)], PA.H2CCache(), path, rung) is True
        assert PA.pairing_finish(inf2, pts, PA.H2CCache(), path, rung) is False
        assert path == {}
    seen = []
    monkeypatch.setattr(PA, "device_pairing_check", lambda S, live, h2c, dev: seen.append(live) or True)
    path = {}
    assert PA.pairing_finish(S, [(b"gone", inf1)] + list(pts), PA.H2CCache(), path, "device", "cpu")
    assert [m for m, _ in seen[0]] == [m for m, _ in pts] and path == {"device": 3}


def test_a_device_error_propagates(slot, monkeypatch):
    """No fallback from the device rung to the native one."""
    def boom(*_a):
        raise RuntimeError("device fault")

    native_calls = []
    monkeypatch.setattr(PR, "pairing_check_planes", boom)
    monkeypatch.setattr(PA, "native_pairing_check", lambda *a: native_calls.append(a) or True)
    S, pts = slot["pairs"]
    with pytest.raises(RuntimeError, match="device fault"):
        PA.pairing_finish(S, pts, slot["impl"].h2c, {}, "device", "cpu")
    assert native_calls == []
