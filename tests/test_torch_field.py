"""Port field layer vs the JAX package: the plain versions of the fe_mul,
fe_add and fe_sub kernels against charon_tpu.ops.pallas_plane's fe_* (their
CPU path) on the same seeded inputs, through ops/convert.py, with exact
equality; plus the limb conversions and byte loaders."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.ops import field as RF
from charon_tpu.ops import pallas_plane as PP
from charon_tpu.ops import plane_agg as RPA
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F

B = 128   # one MIN_TILE bucket: (8, 16) reference planes
P = F.P_INT
EDGES = [0, 1, P - 1, (1 << 384) % P]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _values(seed: int, E: int):
    rng = random.Random(seed)
    if E == 1:
        vals = [rng.randrange(P) for _ in range(B)]
        vals[:4] = EDGES
    else:
        vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(B)]
        vals[:4] = [(e, EDGES[-1 - i]) for i, e in enumerate(EDGES)]
    return vals


def _ref_plane(vals, E: int) -> np.ndarray:
    rows = (np.stack([RF.fq_from_int(v) for v in vals]) if E == 1
            else np.stack([RF.fq2_from_ints(*v) for v in vals]))
    return PP.to_plane(rows, E)


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("op", ["mul", "square", "add", "sub", "neg"])
def test_plain_field_ops_match_the_jax_package(op, E):
    a_np = _ref_plane(_values(10 + E, E), E)
    b_np = _ref_plane(_values(20 + E, E), E)
    a, b = CV.planes_from_jax(a_np), CV.planes_from_jax(b_np)
    A, Bj = jnp.asarray(a_np), jnp.asarray(b_np)
    if op == "mul":
        want, got = PP.fe_mul(A, Bj, E), CP.fe_mul(a, b, E)
    elif op == "square":
        want, got = PP.fe_mul(A, A, E), CP.fe_mul(a, a, E)
    elif op == "add":
        want, got = PP.fe_add(A, Bj, E), CP.fe_add(a, b, E)
    elif op == "sub":
        want, got = PP.fe_sub(A, Bj, E), CP.fe_sub(a, b, E)
    else:
        want, got = PP.fe_neg(A, E), CP.fe_neg(a, E)
    assert np.array_equal(CV.planes_to_jax(got), np.asarray(want))


def test_plane_conversion_round_trips():
    for E in (1, 2):
        plane = _ref_plane(_values(30 + E, E), E)
        t = CV.planes_from_jax(plane)
        assert t.shape == (E, 12, B) and t.dtype == torch.int32
        assert np.array_equal(CV.planes_to_jax(t), plane)
        assert CV.ints_from_port(t) == _values(30 + E, E)
        assert torch.equal(CV.port_from_ints(_values(30 + E, E), E), t)


def test_padding_columns_can_be_cleared():
    plane = _ref_plane(_values(41, 1), 1)
    out = CV.planes_to_jax(CV.planes_from_jax(plane), B=100)
    flat = out.reshape(1, 32, -1)
    assert not flat[..., 100:].any()
    assert np.array_equal(flat[..., :100], plane.reshape(1, 32, -1)[..., :100])


def test_montgomery_constants_agree_with_the_reference():
    assert F.R_MONT == RF.R_MONT and F.R2_INT == RF.R2_INT and F.P_INT == RF.P_INT
    assert (F.N0_INV * P) % (1 << 32) == (1 << 32) - 1
    for v in EDGES + [12345]:
        assert F.fq_to_int(F.fq_from_int(v)) == v == RF.fq_to_int(RF.fq_from_int(v))
        assert F.int_from_limbs(F.fq_from_int(v)) == RF.int_from_limbs(RF.fq_from_int(v))


def test_byte_loaders_match_the_reference():
    rng = np.random.default_rng(5)
    be = rng.integers(0, 256, (64, 48), dtype=np.uint8)
    be[:, 0] &= 0x1F
    be[0] = 0
    be[1] = np.frombuffer((P - 1).to_bytes(48, "big"), np.uint8)
    ours = F.fp_limbs_raw(be)
    ref = RPA._fp_limbs_raw(be)
    for i in range(len(be)):
        assert F.int_from_limbs(ours[i]) == RF.int_from_limbs(ref[i]) == int.from_bytes(be[i], "big")
    assert np.array_equal(F.fp_limbs_to_be(ours), be)
    assert np.array_equal(F.fp_limbs_to_be(ours), RPA._fp_limbs_to_be(ref))


def test_wrappers_count_plain_calls_on_the_cpu():
    CP.reset_counts()
    a = CV.port_from_ints(_values(50, 2), 2)
    CP.fe_mul(a, a, 2)
    CP.fe_neg(a, 2)
    assert CP.KERNELS["fe_mul"].plain_calls == {1: 0, 2: 1}
    assert CP.KERNELS["fe_addsub"].plain_calls == {1: 0, 2: 1}
    assert all(k.launches == {E: 0 for E in k.variants} for k in CP.KERNELS.values())
