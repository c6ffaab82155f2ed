"""Port device hash-to-G2 (ops/h2c.py, plain rows and plane path) vs the JAX
package and the native oracle: one device map over the RFC 9380 J.10.1
vector and three messages, against the vector and against the host
charon_tpu.crypto.hash_to_curve.hash_to_g2 and native ct_hash_to_g2 bytes;
`_sswu` and `_iso_map` against charon_tpu.ops.h2c's on the same seeded
batch-2 inputs, limb for limb; the host half; and hash_to_g2_device's
MAX_BATCH chunking (its whole path, against the same oracles, runs in
tests/test_torch_slice.py through the H(m) cache).

The reference's SSWU and isogeny run eagerly with its field primitives
under jax.jit (its power scans then compile only their small scan body);
its bucketed whole-map graph (_compiled_h2c) is not called: it takes minutes
to compile on XLA:CPU."""

import ctypes
import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.crypto.curve import Fq2Ops, to_affine
from charon_tpu.crypto.hash_to_curve import DST_ETH, hash_to_g2
from charon_tpu.ops import field as RF
from charon_tpu.ops import h2c as RH
from charon_tpu.tbls.native_impl import load_library
from charon_tpu_torch.crypto.serialize import g2_affine_to_bytes
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import h2c as H

P = RF.P_INT
CPU = torch.device("cpu")
RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
RFC_P = ((0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
          0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D),
         (0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
          0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jit_field():
    mp = pytest.MonkeyPatch()
    for name in ("fq_add", "fq_sub", "fq_neg", "fq_mont_mul"):
        mp.setattr(RF, name, jax.jit(getattr(RF, name)))
    yield
    mp.undo()


def _affine(hx, hy):
    """(B, 2, 12) rows -> [((x0, x1), (y0, y1)), ...] ints."""
    ints = F.fq_ints(torch.stack([hx, hy], 1).numpy())
    return [((ints[i], ints[i + 1]), (ints[i + 2], ints[i + 3])) for i in range(0, len(ints), 4)]


MSGS = [b"h2c-a", b"\x42" * 32, b"h2c-c" * 20]


@pytest.fixture(scope="module")
def mapped():
    """ONE device map over four lanes: the RFC 9380 J.10.1 message under its
    test DST, then MSGS under the ETH DST; and the plain calls it made."""
    planes = [np.concatenate(p) for p in zip(H.hash_to_field_planes([b""], RFC_DST),
                                               H.hash_to_field_planes(MSGS))]
    CP.reset_counts()
    hx, hy = H.map_to_g2_device(*(torch.as_tensor(p) for p in planes))
    calls = {k: dict(v.plain_calls) for k, v in CP.KERNELS.items()}
    return _affine(hx, hy), calls


def test_rfc9380_vector_through_the_device_map(mapped):
    aff, calls = mapped
    assert aff[0] == RFC_P
    # q0 + q1 on pt_add<2>, the cofactor clear one pt_mul_shared<2> (its 635
    # doublings and 304 additions in the kernel), the rest on rows
    assert calls["pt_double"] == {1: 0, 2: 0}
    assert calls["pt_add"] == {1: 0, 2: 1}
    assert calls["pt_mul_shared"] == {1: 0, 2: 1}
    assert calls["fe_mul_rows"][1] > 0
    # its six power scans (five p-sized, the affine inversion) one fe_pow each
    assert calls["fe_pow"] == {"plane": 0, "rows": 6}
    # 54 launches in all: a first verify (H(m) hashed) takes 4,778 + 54
    assert sum(sum(c.values()) for c in calls.values()) == 54


def test_device_map_matches_host_and_native(mapped):
    aff, _calls = mapped
    lib = load_library()
    for m, a in zip(MSGS, aff[1:]):
        assert a == to_affine(Fq2Ops, hash_to_g2(m, DST_ETH))
        out = (ctypes.c_uint8 * 96)()
        lib.ct_hash_to_g2(m, len(m), out)
        assert g2_affine_to_bytes(a) == bytes(out)


def test_hash_to_g2_device_chunks_beyond_max_batch(monkeypatch):
    """Batches beyond MAX_BATCH run as successive chunks, in order (the map
    is replaced by a stub that returns its u rows)."""
    calls = []

    def stub(u0, u1, s0, s1):
        calls.append(u0.shape[0])
        return u0, u1

    monkeypatch.setattr(H, "MAX_BATCH", 2)
    monkeypatch.setattr(H, "map_to_g2_device", stub)
    msgs = [b"m%d" % i for i in range(5)]
    hx, hy = H.hash_to_g2_device(msgs, CPU)
    assert calls == [2, 2, 1]
    u0, u1, _s0, _s1 = H.hash_to_field_planes(msgs)
    assert np.array_equal(hx.numpy(), u0) and np.array_equal(hy.numpy(), u1)
    e0, e1 = H.hash_to_g2_device([], CPU)
    assert e0.shape == e1.shape == (0, 2, 12)


def test_map_rejects_oversized_batches(monkeypatch):
    monkeypatch.setattr(H, "MAX_BATCH", 2)
    u = torch.zeros(3, 2, 12, dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="MAX_BATCH"):
        H.map_to_g2_device(u, u, s, s)


def test_sswu_matches_the_jax_package(jit_field):
    u0, u1, s0, s1 = RH.hash_to_field_planes([b"sswu-a", b"sswu-b"])
    # one lane per message's u0, the second lane its u1 (both sgn0 values)
    u = np.stack([u0[0], u1[1]])
    s = np.asarray([s0[0], s1[1]], np.int32)
    want = RH._sswu(jnp.asarray(u), jnp.asarray(s))
    got = H._sswu(CV.rows_from_jax(u), torch.as_tensor(s))
    for g, w in zip(got, want):
        assert np.array_equal(CV.rows_to_jax(g), np.asarray(w))


def test_iso_map_matches_the_jax_package(jit_field):
    rng = random.Random(51)
    x, y = (np.stack([RF.fq2_from_ints(rng.randrange(P), rng.randrange(P)) for _ in range(2)])
            for _ in range(2))
    want = RH._iso_map(jnp.asarray(x), jnp.asarray(y))
    got = H._iso_map(CV.rows_from_jax(x), CV.rows_from_jax(y))
    for g, w in zip(got, want):
        assert np.array_equal(CV.rows_to_jax(g), np.asarray(w))


def test_host_half_matches_the_jax_package():
    msgs = [b"", b"abc", b"\x00" * 64]
    want = RH.hash_to_field_planes(msgs)
    got = H.hash_to_field_planes(msgs)
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(CV.rows_to_jax(torch.as_tensor(g)), w)
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g, w)
