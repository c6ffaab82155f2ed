"""Port slot pieces vs the JAX package and the native oracle: G2/G1
decompression against plane_agg's _g2/_g1 decompression (their CPU path) and
ct_*_uncompress_bulk, the parse errors' texts, the aggregate bytes against
NativeImpl, the slot's RLC MSM sums (with injected randomizers) against
pure-Python sums, and the pk plane's subgroup and infinity rejection."""

import ctypes
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RPF
from charon_tpu.crypto.serialize import g1_from_bytes, g2_from_bytes
from charon_tpu.ops import plane_agg as RPA
from charon_tpu.tbls.native_impl import NativeImpl, load_library
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch.crypto import serialize as S
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.tbls.torch_impl import TorchImpl

BP = 128
CPU = torch.device("cpu")
INF96 = b"\xc0" + bytes(95)
INF48 = b"\xc0" + bytes(47)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def native():
    return NativeImpl()


def _sk(rng):
    return PrivateKey(rng.randrange(1, RPF.R).to_bytes(32, "big"))


@pytest.fixture(scope="module")
def keys(native):
    rng = random.Random(21)
    sks = [_sk(rng) for _ in range(40)]
    sigs = [bytes(native.sign(sk, bytes([i % 3]) * 32)) for i, sk in enumerate(sks)]
    pks = [bytes(native.secret_to_public_key(sk)) for sk in sks]
    return sigs, pks


def _ref_decompress_g2(items):
    body, _fin, sgn, loaded = RPA._parse_compressed(items, 96, "G2", False, BP)
    X0r = jnp.asarray(RPA._raw_to_plane(body[:, 48:], BP))
    X1r = jnp.asarray(RPA._raw_to_plane(body[:, :48], BP))
    return [np.asarray(c) for c in RPA._g2_decompress_jit(X0r, X1r, jnp.asarray(sgn),
                                                          jnp.asarray(loaded))]


def _port_decompress_g2(items):
    body, _fin, sgn, loaded = PA.parse_compressed(items, 96, "G2", False, BP)
    return PA.g2_decompress(PA.raw_to_plane(body[:, 48:], BP, CPU),
                            PA.raw_to_plane(body[:, :48], BP, CPU),
                            torch.as_tensor(sgn), torch.as_tensor(loaded))


def test_g2_decompression_matches_the_jax_package_and_native(keys):
    sigs = keys[0][:30] + [INF96] + keys[0][30:]
    X, Y, Z, ok = _port_decompress_g2(sigs)
    rX, rY, rZ, rok = _ref_decompress_g2(sigs)
    for got, want in ((X, rX), (Y, rY), (Z, rZ)):
        assert torch.equal(got, CV.planes_from_jax(want))
    assert ok.all() and np.asarray(rok).all()
    n = len(sigs)
    out = (ctypes.c_uint8 * (192 * n))()
    assert load_library().ct_g2_uncompress_bulk(b"".join(sigs), n, out, 0) == n
    aff = np.frombuffer(bytes(out), np.uint8).reshape(n, 4, 48)
    xs, ys = CV.ints_from_port(X)[:n], CV.ints_from_port(Y)[:n]
    for i in range(n):
        c = [int.from_bytes(aff[i, k].tobytes(), "big") for k in range(4)]
        assert (xs[i], ys[i]) == ((c[0], c[1]), (c[2], c[3]))


def test_g1_decompression_matches_the_jax_package_and_native(keys):
    pks = keys[1]
    body, _fin, sgn, loaded = RPA._parse_compressed(pks, 48, "G1", True, BP)
    ref = RPA._g1_decompress_jit(jnp.asarray(RPA._raw_to_plane(body, BP)), jnp.asarray(sgn),
                                 jnp.asarray(loaded))
    X, Y, Z = PA.g1_plane(pks, BP, CPU)
    for got, want in zip((X, Y, Z), ref[:3]):
        assert torch.equal(got, CV.planes_from_jax(np.asarray(want)))
    n = len(pks)
    out = (ctypes.c_uint8 * (96 * n))()
    assert load_library().ct_g1_uncompress_bulk(b"".join(pks), n, out, 1) == n
    aff = np.frombuffer(bytes(out), np.uint8).reshape(n, 2, 48)
    xs, ys = CV.ints_from_port(X)[:n], CV.ints_from_port(Y)[:n]
    for i in range(n):
        assert (xs[i], ys[i]) == tuple(int.from_bytes(aff[i, k].tobytes(), "big") for k in range(2))


def _bad_encodings(sigs):
    uncompressed = bytes([sigs[3][0] & 0x7F]) + sigs[3][1:]
    bad_inf = INF96[:50] + b"\x01" + INF96[51:]
    x_big = bytes([0x9F]) + b"\xff" * 95
    return {"uncompressed": uncompressed, "bad infinity": bad_inf, "x >= p": x_big}


@pytest.mark.parametrize("case", ["uncompressed", "bad infinity", "x >= p"])
def test_parse_errors_match_the_jax_package(keys, case):
    sigs = list(keys[0][:10])
    sigs[4] = _bad_encodings(keys[0])[case]
    with pytest.raises(ValueError) as ref:
        RPA._parse_compressed(sigs, 96, "G2", False, BP)
    with pytest.raises(ValueError) as ours:
        PA.parse_compressed(sigs, 96, "G2", False, BP)
    assert str(ours.value) == str(ref.value)


def _off_curve(sig: bytes) -> bytes:
    body = bytearray(sig)
    while True:
        body[95] = (body[95] + 1) % 256
        x1 = int.from_bytes(bytes([body[0] & 0x1F]) + bytes(body[1:48]), "big")
        x0 = int.from_bytes(bytes(body[48:]), "big")
        if RPF.fq2_sqrt(RPF.fq2_add(RPF.fq2_mul(RPF.fq2_sqr((x0, x1)), (x0, x1)), (4, 4))) is None:
            return bytes(body)


def test_off_curve_partial_raises_the_reference_index(keys):
    sigs = list(keys[0][:12])
    sigs[7] = _off_curve(sigs[7])
    ok = _ref_decompress_g2(sigs)[3]
    with pytest.raises(ValueError) as ref:
        RPA._raise_bad(np.asarray(ok), "G2")
    okm = _port_decompress_g2(sigs)[3].numpy()
    with pytest.raises(ValueError) as ours:
        PA.raise_bad(okm, "G2")
    assert str(ours.value) == str(ref.value) == "invalid G2 point at index 7"


def test_aggregates_match_native_threshold_aggregate(native):
    rng = random.Random(23)
    batches = []
    for v in range(3):
        sk = rng.randrange(1, RPF.R)
        coeffs = [sk] + [rng.randrange(RPF.R) for _ in range(3)]
        ids = sorted(rng.sample(range(1, 7), 4))
        share = {i: sum(c * i ** k for k, c in enumerate(coeffs)) % RPF.R for i in ids}
        batches.append({i: bytes(native.sign(PrivateKey(share[i].to_bytes(32, "big")), b"m" * 32))
                        for i in ids})
    batches[2][sorted(batches[2])[1]] = INF96     # an infinity partial
    got = TorchImpl(device="cpu").threshold_aggregate_batch(batches)
    assert [bytes(g) for g in got] == [bytes(native.threshold_aggregate(b)) for b in batches]


def test_slot_msm_with_injected_randomizers(keys):
    """One partial per validator (λ = 1, so each aggregate is its partial):
    the slot's folded RLC sums are Σ rᵢ·sigᵢ and, per message, Σ rᵢ·pkᵢ."""
    sigs, pks = keys[0][:10], keys[1][:10]
    msgs = [bytes([i % 3]) * 32 for i in range(10)]
    rands = np.asarray([random.Random(i).getrandbits(64) | 1 for i in range(10)], np.uint64)
    steps = []
    state = PA.fused_slot(PA.layout_slots([{1: s} for s in sigs]), pks, msgs, CPU,
                          PA.PkPlaneCache(), randomizers=rands, mark=steps.append)
    assert len(steps) == 7 and steps[3:] == [
        "G2 decompression", "Lagrange sweep + combine", "affine standard form",
        "combined RLC MSM + reduction trees"]
    out, S2, pts = PA.host_emit(PA.readback(state), CPU)
    assert out == sigs
    assert [m for m, _ in pts] == [bytes([i]) * 32 for i in range(3)] + [b""]   # G = 4
    want = RC.jac_infinity(RC.Fq2Ops)
    for s, r in zip(sigs, rands):
        want = RC.jac_add(RC.Fq2Ops, want, RC.jac_mul(RC.Fq2Ops, g2_from_bytes(s), int(r)))
    assert RC.to_affine(RC.Fq2Ops, S2) == RC.to_affine(RC.Fq2Ops, want)
    for m, got in pts:
        want = RC.jac_infinity(RC.FqOps)
        for p, r, mm in zip(pks, rands, msgs):
            if mm == m:
                want = RC.jac_add(RC.FqOps, want, RC.jac_mul(RC.FqOps, g1_from_bytes(p), int(r)))
        assert RC.to_affine(RC.FqOps, got) == RC.to_affine(RC.FqOps, want)


def _off_subgroup_g1() -> bytes:
    x = 5
    while True:
        y = RPF.fq_sqrt((x ** 3 + 4) % RPF.P)
        if y is not None and not RC.g1_in_subgroup((x, y, 1)):
            return S.g1_to_bytes((x, y, 1))
        x += 1


def test_pk_plane_rejects_off_subgroup_and_infinity_pubkeys(keys):
    pks = keys[1][:8]
    cache = PA.PkPlaneCache()
    X, _Y, _Z = cache.get(pks, BP, CPU)
    assert cache.get(pks, BP, CPU)[0] is X                   # second call is a hit
    with pytest.raises(ValueError, match="G1 pubkey not in subgroup"):
        cache.get(pks[:3] + [_off_subgroup_g1()] + pks[4:], BP, CPU)
    with pytest.raises(ValueError, match="infinity G1 point rejected"):
        cache.get(pks[:2] + [INF48] + pks[3:], BP, CPU)


def test_layout_matches_the_reference(keys):
    sigs = keys[0]
    batches = [{i + 1: sigs[(4 * v + i) % len(sigs)] for i in range(4)} for v in range(9)]
    assert PA.layout_slots(batches) == RPA._layout_slots(batches)
    assert PA.bucket_for_slots(1000, 4) == RPA._bucket_for_slots(1000, 4) == 1024


# ---------------------------------------------------------------------------
# The pk-plane cache against the reference's PlaneStore
# ---------------------------------------------------------------------------


def _stub_decoders(monkeypatch):
    """No plane is decoded: both caches get a token per decode."""
    from charon_tpu.ops import plane_store as RPS

    monkeypatch.setattr(RPA, "g1_plane_from_compressed", lambda pks, Bc, reject_infinity: ("plane",))
    monkeypatch.setattr(RPA, "g1_subgroup_ok", lambda plane: True)
    monkeypatch.setattr(PA, "g1_plane", lambda pks, Bp, device: ("plane",) * 3)
    monkeypatch.setattr(PA, "g1_subgroup_ok", lambda *plane: True)
    return RPS


def _drive(sequence, ref, port):
    """Run (action, set) steps on both caches; per step the (hits, misses,
    evictions) it added on each."""
    keys = ("hits", "misses", "evictions")
    out = []
    for action, pks in sequence:
        before = ref.stats(), port.stats()
        if action == "get":
            ref.full_plane(pks, BP)
            port.get(pks, BP, CPU)
        else:
            getattr(ref, action)(pks)
            getattr(port, action)(pks)
        after = ref.stats(), port.stats()
        out.append(tuple(tuple(a[k] - b[k] for k in keys) for a, b in zip(after, before)))
    return out


def test_pk_plane_cache_evicts_as_the_reference_plane_store(monkeypatch):
    """Fill to the cap (64 sets), hit set 1, insert a 65th set (set 2, the
    oldest after set 1's refresh, goes), pin set 3 and overflow again (set
    4 goes, not the pinned set 3); then set 1 and set 3 hit and set 2
    misses, on both."""
    RPS = _stub_decoders(monkeypatch)
    ref, port = RPS.PlaneStore(), PA.PkPlaneCache()
    assert port.MAX_ENTRIES == ref.max_entries == 64
    sets = {i: [b"pk-set-%d" % i] for i in range(1, 67)}
    seq = [("get", sets[i]) for i in range(1, 65)]
    seq += [("get", sets[1]), ("get", sets[65]), ("pin", sets[3]), ("get", sets[66])]
    seq += [("get", sets[1]), ("get", sets[3]), ("get", sets[4]), ("get", sets[2])]
    steps = _drive(seq, ref, port)
    assert all(r == p for r, p in steps)
    got = [p for _r, p in steps]
    assert got[:64] == [(0, 1, 0)] * 64
    assert got[64:] == [(1, 0, 0), (0, 1, 1), (0, 0, 0), (0, 1, 1),
                        (1, 0, 0), (1, 0, 0), (0, 1, 1), (0, 1, 1)]
    assert port.stats() == {"hits": 3, "misses": 68, "evictions": 4, "entries": 64,
                            "pinned_sets": 1}


def test_pk_plane_cache_grows_rather_than_drop_a_pin(monkeypatch):
    """At the cap of 64 sets, every resident pinned: a pinned 65th set is
    added past the cap (the cache grows) and an unpinned one evicted at
    once; after set 1's unpin a new set's insert evicts set 1 and then
    itself, back to the 65 pinned sets."""
    RPS = _stub_decoders(monkeypatch)
    ref, port = RPS.PlaneStore(), PA.PkPlaneCache()
    assert port.MAX_ENTRIES == ref.max_entries == 64
    sets = {i: [b"pk-set-%d" % i] for i in range(1, 68)}
    seq = [("get", sets[i]) for i in range(1, 65)] + [("pin", sets[i]) for i in range(1, 66)]
    seq += [("get", sets[65]), ("get", sets[66]), ("get", sets[66]), ("unpin", sets[1]),
            ("get", sets[1]), ("get", sets[67]), ("get", sets[1])]
    steps = _drive(seq, ref, port)
    assert all(r == p for r, p in steps)
    assert [p for _r, p in steps][129:] == [(0, 1, 0), (0, 1, 1), (0, 1, 1), (0, 0, 0),
                                           (1, 0, 0), (0, 1, 2), (0, 1, 1)]
    assert port.stats() == {"hits": 1, "misses": 69, "evictions": 5, "entries": 64,
                            "pinned_sets": 64}
