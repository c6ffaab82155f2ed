"""The port's per-triple verify (TorchImpl.verify_batch_each over
plane_agg.verify_each and pairing.verify_triples) on the CPU: its verdicts
are the reference TPUImpl.verify_batch_each's and native ct_verify's per
triple on every case of the attribution after a failed batch (all good, a
tampered partial, a bad pubkey or signature encoding, an infinity, a
signature outside the subgroup, two messages), n = 0 and a length mismatch;
one call's pairing launches do not grow with its triples; the decompressed
points are the pairing's affine rows; an open breaker and a device-class
failure answer natively. Two device calls of at most 16 triples serve the
verdict cases (the lanes are independent), each a few seconds of plain
versions; H(m) comes from the cache's native bytes. The slow-marked test
holds the per-lane Miller loop and final exponentiation against the JAX
package's verify_batch_device, whose whole-loop graph takes minutes to
compile on the CPU."""

import numpy as np
import pytest
import torch

from charon_tpu.tbls.tpu_impl import TPUImpl
from charon_tpu_torch import native as PN
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.crypto import serialize as S
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import guard
from charon_tpu_torch.ops import pairing as PR
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.utils import faults

from test_torch_verify_batch import (CPU, INF48, INF96, MSGS, _off_g1, _one_thread,  # noqa: F401
                                     keys, native, off_g2)


def _flag_cleared(b: bytes) -> bytes:
    return bytes([b[0] & 0x7F]) + b[1:]


@pytest.fixture(scope="module")
def cases(keys, off_g2):
    """name -> (pk, msg, sig) triples, ≤ 8 a case; key i signs both
    messages."""
    pks, sigs = keys
    m0, m1 = MSGS
    good = [(pks[i], m0, sigs[m0][i]) for i in range(3)]
    return {
        "all good": good,
        "one tampered": [good[0], (pks[1], m0, sigs[m0][2]), good[2]],
        "bad pk encoding": [(_flag_cleared(pks[0]), m0, sigs[m0][0]), good[1],
                            (b"\x00" * 48, m0, sigs[m0][2])],
        "bad signature encoding": [good[0], (pks[1], m0, _flag_cleared(sigs[m0][1])),
                                   (pks[2], m0, b"\x00" * 96),
                                   (pks[3], m0, b"\x9f" + b"\xff" * 47 + sigs[m0][3][48:])],
        "infinity": [good[0], (pks[1], m0, INF96), (INF48, m0, sigs[m0][2])],
        "off-subgroup signature": [good[0], (pks[1], m0, off_g2[0]), (pks[0], m0, off_g2[1])],
        "off-subgroup pk": [(_off_g1(), m0, sigs[m0][0]), good[1]],
        "two messages": [(pks[0], m0, sigs[m0][0]), (pks[1], m1, sigs[m1][1]),
                         (pks[2], m1, sigs[m0][2]), (pks[3], m1, sigs[m1][3])],
    }


def _valid_pks(triples) -> bool:
    """Every pubkey a finite point of the subgroup (natively)."""
    return all(pk != INF48 and PN.g1_check(pk) for pk, _m, _s in triples)


def _columns(triples):
    return [list(c) for c in zip(*triples)] if triples else [[], [], []]


@pytest.fixture(scope="module")
def port(cases):
    """Two TorchImpl(device="cpu").verify_batch_each calls: the cases whose
    pubkeys all decode (the pk-plane cache's path), then the others (the
    lane-by-lane decode); each case's verdicts, and each call's plain calls
    by kernel."""
    impl = TorchImpl(device="cpu")
    for m in MSGS:
        impl.h2c.get(m)             # native bytes: the rows come from the host
    groups = {True: [], False: []}
    for name, triples in cases.items():
        groups[_valid_pks(triples)].append(name)
    out, calls = {}, {}
    for cached, names in groups.items():
        flat = [t for n in names for t in cases[n]]
        CP.reset_counts()
        got = impl.verify_batch_each(*_columns(flat))
        calls[cached] = {k: dict(v.plain_calls) for k, v in CP.KERNELS.items()}
        assert isinstance(got, np.ndarray) and got.dtype == np.bool_ and got.shape == (len(flat),)
        off = 0
        for n in names:
            out[n] = got[off:off + len(cases[n])].tolist()
            off += len(cases[n])
    assert groups[True] and groups[False]
    return {"verdicts": out, "calls": calls, "impl": impl}


WANT = {"all good": [True] * 3, "one tampered": [True, False, True],
        "bad pk encoding": [False, True, False],
        "bad signature encoding": [True, False, False, False],
        "infinity": [True, False, False], "off-subgroup signature": [True, False, False],
        "off-subgroup pk": [False, True], "two messages": [True, True, False, True]}


@pytest.mark.parametrize("name", list(WANT))
def test_verdicts_are_the_reference_and_native_per_triple(cases, port, name):
    """Each case's verdicts: the port's, the reference TPUImpl's
    verify_batch_each and native ct_verify of each triple agree."""
    triples = cases[name]
    ref = TPUImpl().verify_batch_each(*_columns(triples))
    nat = [PN.verify(*t) for t in triples]
    assert port["verdicts"][name] == ref.tolist() == nat == WANT[name]


def test_empty_and_length_mismatch(port):
    """n = 0 is an empty bool array with no launch; a length mismatch raises
    ValueError, as the reference's."""
    impl = port["impl"]
    CP.reset_counts()
    got = impl.verify_batch_each([], [], [])
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_ and got.shape == (0,)
    assert TPUImpl().verify_batch_each([], [], []).shape == (0,)
    assert sum(sum(k.plain_calls.values()) for k in CP.KERNELS.values()) == 0
    for fn in (impl.verify_batch_each, TPUImpl().verify_batch_each,
               lambda *a: PA.verify_each(*a, CPU, PA.PkPlaneCache(), PA.H2CCache())):
        with pytest.raises(ValueError, match="length mismatch"):
            fn([b"p" * 48], [MSGS[0]], [])


def test_one_call_is_one_pairings_launches(port):
    """The pairing's launches (the rows kernels and the final exponentiation's
    one inversion) are the same for 16 triples as for 7: one call is one
    pairing's worth whatever its width. The cached call decodes no pubkey
    (the cache's plane, one G1 decompression and subgroup check a chunk),
    the other one lane-by-lane decode a chunk; each one G2 decompression
    and subgroup check a chunk."""
    a, b = port["calls"][True], port["calls"][False]
    for name in ("fe_mul_rows", "fe_add_rows"):
        assert a[name] == b[name] and sum(a[name].values()) > 1000
    assert a["fe_pow"]["rows"] == b["fe_pow"]["rows"] == 1
    assert a["pt_mul_shared"] == b["pt_mul_shared"] == {1: 1, 2: 1}
    assert a["pt_reduce_groups"] == a["pt_mul_windowed"] == {1: 0, 2: 0}


def test_decompressed_points_are_the_pairings_affine_rows(keys):
    """verify_each feeds the decompression's planes (Z = 1) to the pairing as
    rows: they equal pairing.g1_rows / g2_rows of the affine points."""
    pks, sigs = keys
    sig = sigs[MSGS[0]][:3]
    body, sgn, usable = PA.parse_lanes(sig, 96, 128)
    X, Y, Z, ok = PA.g2_decompress(PA.raw_to_plane(body[:, 48:], 128, CPU),
                                   PA.raw_to_plane(body[:, :48], 128, CPU),
                                   torch.as_tensor(sgn), torch.as_tensor(usable))
    assert bool(ok[:3].all()) and usable[:3].all() and not usable[3:].any()
    hx, hy = PR.g2_rows([S.g2_affine_from_bytes(s) for s in sig], CPU)
    assert torch.equal(X[..., :3].permute(2, 0, 1), hx) and torch.equal(Y[..., :3].permute(2, 0, 1), hy)
    (gX, gY, _gZ), pk_ok = PA.g1_lanes(pks[:3] + [INF48], 128, CPU)
    px, py = PR.g1_rows([PC.to_affine(PC.FqOps, S.g1_from_bytes(p)) for p in pks[:3]], CPU)
    assert torch.equal(gX[0, :, :3].T, px) and torch.equal(gY[0, :, :3].T, py)
    assert pk_ok[:4].tolist() == [True, True, True, False]


def test_breaker_and_device_failure_answer_natively(monkeypatch, keys):
    """With the fallback on, an open breaker answers natively with no
    launch, and a device-class failure of the call lands natively, counted
    once as a verify landing; with it off the failure raises."""
    pks, sigs = keys
    triples = _columns([(pks[0], MSGS[0], sigs[MSGS[0]][0]), (pks[1], MSGS[0], sigs[MSGS[0]][2])])

    def lost(*_a, **_k):
        raise faults.DeviceLostFault("device lost")

    monkeypatch.setattr(PA, "verify_each", lost)
    guard.reset_for_testing()
    try:
        impl = TorchImpl(device="cpu")
        assert impl.verify_batch_each(*triples).tolist() == [True, False]
        assert guard.fallback_total("device_lost") == 1
        guard.configure(threshold=1, cooldown=3600)
        impl.verify_batch_each(*triples)
        assert guard.BREAKER.state == guard.OPEN
        monkeypatch.setattr(PA, "verify_each", lambda *a: pytest.fail("launched past the breaker"))
        assert impl.verify_batch_each(*triples).tolist() == [True, False]
        impl.fallback_on_device_error = False
        monkeypatch.setattr(PA, "verify_each", lost)
        with pytest.raises(faults.DeviceLostFault):
            impl.verify_batch_each(*triples)
        assert TorchImpl(device="cpu", verify="native").verify_batch_each(*triples).tolist() == \
            [True, False]
    finally:
        guard.reset_for_testing()


@pytest.mark.slow
def test_per_lane_pairing_is_the_jax_packages_verify_batch_device(keys):
    """The port's verify_triples on affine rows gives the verdicts of the JAX
    package's verify_batch_device (_compiled_verify) on the same affine
    ints: two good triples, a signature of another key, a signature over
    another message."""
    from charon_tpu.ops.pairing import verify_batch_device

    pks, sigs = keys
    m0, m1 = MSGS
    trip = [(pks[0], m0, sigs[m0][0]), (pks[1], m1, sigs[m1][1]), (pks[2], m0, sigs[m0][3]),
            (pks[3], m0, sigs[m1][3])]
    pk_aff = [PC.to_affine(PC.FqOps, S.g1_from_bytes(p)) for p, _m, _s in trip]
    h_aff = [S.g2_affine_from_bytes(PN.hash_to_g2(m)) for _p, m, _s in trip]
    s_aff = [S.g2_affine_from_bytes(s) for _p, _m, s in trip]
    px, py = PR.g1_rows(pk_aff, CPU)
    hx, hy = PR.g2_rows(h_aff, CPU)
    sx, sy = PR.g2_rows(s_aff, CPU)
    got = PR.verify_triples(px, py, hx, hy, sx, sy).tolist()
    want = verify_batch_device(pk_aff, h_aff, s_aff).tolist()
    assert got == want == [True, True, False, False]
