"""The chunked bulk verify's parts on the CPU: the G2 subgroup check
psi(P) == [x]P (plane_agg.g2_subgroup_mask) lane for lane against native
ct_g2_check and the JAX package's crypto oracle, with its launches; the
chunk combine (chunks of 2: 5 triples in 3 chunks) against pure-Python sums
with fixed randomizers, and its launches by chunk, which chip_smoke.py pins
on the card; and PkPlaneCache.chunk_planes' hits, pins and ValueErrors."""

import importlib.util
import os

import pytest
import torch

from charon_tpu.crypto import curve as RC
from charon_tpu.crypto.serialize import g1_from_bytes, g2_from_bytes
from charon_tpu.tbls.native_impl import load_library
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.crypto import serialize as S
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import plane_agg as PA

from test_torch_verify_batch import (BP, CPU, INF48, INF96, MSGS, _off_g1, _one_thread,  # noqa: F401
                                     keys, native, off_g2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_g2_subgroup_mask_matches_native_and_the_jax_package(keys, off_g2):
    """Per lane at a 128-lane bucket: signatures (in the subgroup), infinity,
    a raw curve point and a signature with an order-13 component, and the
    padding lanes, which pass; the launches: one pt_mul_shared<2> at k =
    X_ABS, one fe_addsub level of 5 negations, 3 fe_mul<2> levels."""
    items = keys[1][MSGS[0]][:3] + [INF96, off_g2[0], off_g2[1], keys[1][MSGS[1]][3]]
    body, _fin, sgn, loaded = PA.parse_compressed(items, 96, "G2", False, BP)
    X, Y, Z, ok = PA.g2_decompress(PA.raw_to_plane(body[:, 48:], BP, CPU),
                                   PA.raw_to_plane(body[:, :48], BP, CPU),
                                   torch.as_tensor(sgn), torch.as_tensor(loaded))
    assert bool(ok.all())
    CP.reset_counts()
    mask = PA.g2_subgroup_mask(X, Y, Z)
    lib = load_library()
    want = [lib.ct_g2_check(s) == 1 for s in items]
    oracle = [RC.g2_in_subgroup(g2_from_bytes(s, subgroup_check=False)) for s in items]
    assert want == oracle == [True, True, True, True, False, False, True]
    assert mask.tolist() == want + [True] * (BP - len(items))
    assert CP.KERNELS["pt_mul_shared"].cases == {(2, BP, PF.X_ABS): 1}
    assert CP.KERNELS["fe_addsub"].cases == {(1, 5 * BP, (("neg", BP),) * 5): 1}
    assert CP.KERNELS["fe_mul"].plain_calls == {1: 0, 2: 3}
    sub = tuple(c[..., :4].contiguous() for c in (X, Y, Z))
    assert PA.g2_subgroup_ok(*sub) is True
    assert PA.g2_subgroup_ok(X, Y, Z) is False


# ---------------------------------------------------------------------------
# The chunk combine
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chunks_fold_to_the_rlc_sums(monkeypatch, keys):
    """Chunks of 2: 5 triples over two messages are 3 chunks (2, 2, 1) that
    share one group index. With fixed randomizers the folded S and the
    per-message pk sums equal Σ rᵢ·sigᵢ and Σ rᵢ·pkᵢ on the host; each
    chunk's launches are chip_smoke.VERIFY_CHUNK_LAUNCHES (and each pk
    chunk's on a miss); the verdict is True, and False with the last chunk's
    signature replaced."""
    monkeypatch.setattr(PA, "VERIFY_CHUNK", 2)
    pks, sigs = keys
    pks = pks + pks[:1]
    msgs = [MSGS[0], MSGS[1], MSGS[0], MSGS[0], MSGS[1]]
    t_sigs = [sigs[m][i % 4] for i, m in enumerate(msgs)]
    r = [0xDEADBEEF12345671, 3, 0xFFFFFFFFFFFFFFFF, 0x8000000000000001, 0x1234567890ABCDEF]
    steps = []

    def mark(name):
        steps.append((name, {k: {v: c for v, c in kern.plain_calls.items() if c}
                             for k, kern in CP.KERNELS.items() if sum(kern.plain_calls.values())}))
        CP.reset_counts()

    cache = PA.PkPlaneCache()
    CP.reset_counts()
    state = PA.rlc_verify_dispatch(pks, msgs, t_sigs, CPU, cache, randomizers=r, mark=mark)
    cs = _chip_smoke()
    assert [name for name, _ in steps] == ["pk planes", "chunk 1", "chunk 2", "chunk 3"]
    pk_calls = cs.VERIFY_CHUNK_LAUNCHES["pk plane"]
    assert steps[0][1] == {k: {v: 3 * c for v, c in per.items()} for k, per in pk_calls.items()}
    assert all(calls == cs.VERIFY_CHUNK_LAUNCHES["chunk"] for _name, calls in steps[1:])
    S_fold, pts = PA.rlc_fold(state)
    S_want, P_want = PC.jac_infinity(PC.Fq2Ops), {m: PC.jac_infinity(PC.FqOps) for m in MSGS}
    for pk, m, sig, ri in zip(pks, msgs, t_sigs, r):
        S_want = PC.jac_add(PC.Fq2Ops, S_want, PC.jac_mul(
            PC.Fq2Ops, PC.to_jacobian(PC.Fq2Ops, S.g2_affine_from_bytes(sig)), ri))
        P_want[m] = PC.jac_add(PC.FqOps, P_want[m], PC.jac_mul(PC.FqOps, g1_from_bytes(pk), ri))
    assert PC.to_affine(PC.Fq2Ops, S_fold) == PC.to_affine(PC.Fq2Ops, S_want)
    assert [m for m, _ in pts] == list(MSGS)
    assert [PC.to_affine(PC.FqOps, P) for _m, P in pts] == \
        [PC.to_affine(PC.FqOps, P_want[m]) for m in MSGS]
    assert PA.pairing_finish(S_fold, pts, PA.H2CCache(), {}, "native") is True
    t_sigs[4] = sigs[MSGS[1]][1]          # key 1's partial in key 0's triple
    assert PA.rlc_verify_batch(pks, msgs, t_sigs, CPU, cache, PA.H2CCache(), {}, "native",
                               randomizers=r) is False
    assert cache.stats()["hits"] == 3 and cache.stats()["misses"] == 3


# ---------------------------------------------------------------------------
# chunk_planes: hits, pins, ValueErrors
# ---------------------------------------------------------------------------


def test_chunk_planes_hits_pins_and_errors(monkeypatch):
    """Entries are keyed on the full set's digest and the span: a repeat is
    all hits, the whole set's plane is another entry, a pin of the set
    protects its chunk entries through an overflow, and a chunk that fails
    its subgroup check raises and caches nothing of the call (the chunk
    decoded before it neither)."""
    decoded = []
    monkeypatch.setattr(PA, "g1_plane", lambda pks, Bp, device: decoded.append(tuple(pks))
                        or (tuple(pks), Bp, str(device)))
    monkeypatch.setattr(PA, "g1_subgroup_ok", lambda X, Y, Z: b"rogue" not in X)
    cache = PA.PkPlaneCache()
    pks = [b"pk-%d" % i for i in range(5)]
    chunks, buckets = [(0, 2), (2, 4), (4, 5)], [128, 128, 128]
    first = cache.chunk_planes(pks, chunks, buckets, CPU)
    assert [p[0] for p in first] == [tuple(pks[0:2]), tuple(pks[2:4]), (pks[4],)]
    assert cache.chunk_planes(pks, chunks, buckets, CPU) == first
    assert cache.stats() == {"hits": 3, "misses": 3, "evictions": 0, "entries": 3,
                            "pinned_sets": 0}
    cache.get(pks, 128, CPU)
    assert cache.stats()["misses"] == 4 and len(decoded) == 4
    cache.pin(pks)
    for i in range(PA.PkPlaneCache.MAX_ENTRIES):
        cache.get([b"other-%d" % i], 128, CPU)
    assert cache.chunk_planes(pks, chunks, buckets, CPU) == first
    assert cache.stats()["hits"] == 6
    bad = pks[:3] + [b"rogue"] + pks[4:]
    n_entries = cache.stats()["entries"]
    with pytest.raises(ValueError, match="G1 pubkey not in subgroup"):
        cache.chunk_planes(bad, chunks, buckets, CPU)
    assert cache.stats()["entries"] == n_entries


def test_chunk_planes_reject_infinity_and_off_subgroup_pubkeys(keys):
    """The real decode: an infinity pubkey in a chunk raises the reference's
    text, one outside the subgroup its own; nothing is cached."""
    cache = PA.PkPlaneCache()
    pks = keys[0][:3]
    with pytest.raises(ValueError, match="infinity G1 point rejected"):
        cache.chunk_planes(pks + [INF48], [(0, 2), (2, 4)], [BP, BP], CPU)
    with pytest.raises(ValueError, match="G1 pubkey not in subgroup"):
        cache.chunk_planes(pks + [_off_g1()], [(0, 2), (2, 4)], [BP, BP], CPU)
    assert cache.stats()["entries"] == 0
