"""Port Fq6/Fq12 tower vs the JAX package: fq12_mul, fq12_mul_sparse,
fq12_frobenius(·, 1 | 2), fq6_inv, fq12_inv, fq2_inv, fq12_conj and
fq12_is_one of ops/tower.py (plain rows path, CPU tensors) against
charon_tpu.ops.tower's on the same seeded batch-2 inputs, limb for limb.

The reference runs eagerly with its field primitives under jax.jit (each
compiled once per shape; the same functions, whose scans would otherwise
recompile on every eager call)."""

import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.ops import field as RF
from charon_tpu.ops import tower as RT
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import tower as T

P = RF.P_INT


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


def _fq2(rng, n=2):
    return np.stack([RF.fq2_from_ints(rng.randrange(P), rng.randrange(P)) for _ in range(n)])


def _fq12(rng):
    return tuple(tuple(_fq2(rng) for _ in range(3)) for _ in range(2))


def _jax(x):
    if isinstance(x, tuple):
        return tuple(_jax(c) for c in x)
    return jnp.asarray(x)


def _port(x):
    if isinstance(x, tuple):
        return tuple(_port(c) for c in x)
    return CV.rows_from_jax(x)


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert np.array_equal(CV.rows_to_jax(got), np.asarray(want))


CASES = {
    "fq12_mul": lambda M, a, b, c: M.fq12_mul(a, b),
    "fq12_sqr": lambda M, a, b, c: M.fq12_sqr(a),
    "fq12_mul_sparse": lambda M, a, b, c: M.fq12_mul_sparse(a, c[0], c[1], c[2]),
    "fq12_frobenius_1": lambda M, a, b, c: M.fq12_frobenius(a, 1),
    "fq12_frobenius_2": lambda M, a, b, c: M.fq12_frobenius(a, 2),
    "fq12_conj": lambda M, a, b, c: M.fq12_conj(a),
    "fq6_inv": lambda M, a, b, c: M.fq6_inv(a[0]),
    "fq12_inv": lambda M, a, b, c: M.fq12_inv(a),
    "fq2_inv": lambda M, a, b, c: M.fq2_inv(c[0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tower_matches_the_jax_package(name, jit_field):
    rng = random.Random(sum(map(ord, name)))
    a, b, c = _fq12(rng), _fq12(rng), tuple(_fq2(rng) for _ in range(3))
    want = CASES[name](RT, _jax(a), _jax(b), _jax(c))
    CP.reset_counts()
    got = CASES[name](T, _port(a), _port(b), _port(c))
    _same(got, want)
    assert sum(sum(k.plain_calls.values()) for k in CP.KERNELS.values()
               if k.name.endswith("_rows")) > 0


def test_fq2_inv_of_zero_is_zero_as_in_the_reference(jit_field):
    z = np.zeros((2, 2, RF.LIMBS), np.int32)
    _same(T.fq2_inv(CV.rows_from_jax(z)), RT.fq2_inv(jnp.asarray(z)))


def test_fq12_is_one_matches_the_jax_package(jit_field):
    rng = random.Random(7)
    one = RT.fq12_one_like(jnp.asarray(_fq2(rng)))
    one_np = tuple(tuple(np.asarray(c) for c in h) for h in one)
    mixed = tuple(tuple(c.copy() for c in h) for h in one_np)
    mixed[1][2][1] = _fq2(rng, 1)[0]                 # lane 1 is no longer one
    for f in (one_np, mixed):
        want = np.asarray(RT.fq12_is_one(_jax(f)))
        got = T.fq12_is_one(_port(f)).numpy()
        assert got.tolist() == want.tolist()
    assert T.fq12_is_one(_port(mixed)).tolist() == [True, False]
