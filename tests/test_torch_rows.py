"""Port rows field plane vs the JAX package: the plain versions of the
fe_mul_rows, fe_add_rows and fe_sub_rows kernels (ops/rows.py on CPU
tensors) against charon_tpu.ops.field's fq_mont_mul / fq_add / fq_sub /
fq_neg, and the port's seam (_fq_mul_many, _fq2_mul_many) against
charon_tpu.ops.curve's, on the same seeded inputs through ops/convert.py,
with exact equality; plus the wrappers' input checks and the windowed power.

The reference's field primitives are run under jax.jit (each compiled once
per shape): they are the same functions, and called eagerly their scans
would recompile on every call."""

import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.ops import curve as RC
from charon_tpu.ops import field as RF
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import field as F
from charon_tpu_torch.ops import rows as R

P = RF.P_INT
EDGES = [0, 1, P - 1, (1 << 384) % P]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jit_field():
    """The reference's field primitives under jax.jit, for this module."""
    mp = pytest.MonkeyPatch()
    for name in ("fq_add", "fq_sub", "fq_neg", "fq_mont_mul"):
        mp.setattr(RF, name, jax.jit(getattr(RF, name)))
    yield
    mp.undo()


def _ref_rows(vals, shape):
    return np.stack([RF.fq_from_int(v) for v in vals]).reshape(*shape, RF.LIMBS)


def _pair(seed: int, shape=(2, 3, 4)):
    """Seeded (a, b) reference rows of `shape`, the edges against each other
    (0·(R mod p), 1·(p−1), ...) in the first lanes."""
    rng = random.Random(seed)
    n = int(np.prod(shape))
    a = [rng.randrange(P) for _ in range(n)]
    b = [rng.randrange(P) for _ in range(n)]
    a[:4], b[:4] = EDGES, EDGES[::-1]
    a[4:8], b[4:8] = EDGES, EDGES
    return _ref_rows(a, shape), _ref_rows(b, shape)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_rows_ops_match_the_jax_package(op, jit_field):
    a_np, b_np = _pair(30)
    a, b = CV.rows_from_jax(a_np), CV.rows_from_jax(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    CP.reset_counts()
    if op == "mul":
        got, want = R.mont_mul_rows(a, b), RF.fq_mont_mul(ja, jb)
    elif op == "add":
        got, want = R.add_rows(a, b), RF.fq_add(ja, jb)
    elif op == "sub":
        got, want = R.sub_rows(a, b), RF.fq_sub(ja, jb)
    else:
        got, want = R.fq_neg(a), RF.fq_neg(ja)
    assert got.shape == a.shape and got.dtype == torch.int32
    assert np.array_equal(CV.rows_to_jax(got), np.asarray(want))
    name = {"mul": "fe_mul_rows", "add": "fe_add_rows"}.get(op, "fe_sub_rows")
    assert CP.KERNELS[name].plain_calls == {1: 1}
    assert CP.KERNELS[name].launches == {1: 0}


def test_seam_matches_the_jax_package(jit_field):
    a1, b1 = _pair(31, (8,))
    a2, b2 = _pair(32, (4, 2))
    c2, d2 = _pair(33, (4, 2))
    want1 = RC._fq_mul_many([(jnp.asarray(a1), jnp.asarray(b1)), (jnp.asarray(b1), jnp.asarray(b1))])
    want2 = RC._fq2_mul_many([(jnp.asarray(a2), jnp.asarray(b2)), (jnp.asarray(c2), jnp.asarray(c2)),
                              (jnp.asarray(d2), jnp.asarray(a2))])
    t = {k: CV.rows_from_jax(v) for k, v in dict(a1=a1, b1=b1, a2=a2, b2=b2, c2=c2, d2=d2).items()}
    CP.reset_counts()
    got1 = R._fq_mul_many([(t["a1"], t["b1"]), (t["b1"], t["b1"])])
    assert CP.KERNELS["fe_mul_rows"].plain_calls[1] == 1          # one product launch
    CP.reset_counts()
    got2 = R._fq2_mul_many([(t["a2"], t["b2"]), (t["c2"], t["c2"]), (t["d2"], t["a2"])])
    # one add launch for the Karatsuba sums, one product launch, two subs
    assert {k: CP.KERNELS[k].plain_calls[1] for k in ("fe_add_rows", "fe_mul_rows", "fe_sub_rows")} \
        == {"fe_add_rows": 1, "fe_mul_rows": 1, "fe_sub_rows": 2}
    for g, w in zip(got1 + got2, want1 + want2):
        assert np.array_equal(CV.rows_to_jax(g), np.asarray(w))


def test_pow_rows_matches_host_powers():
    rng = random.Random(34)
    vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(5)]
    a = torch.as_tensor(F.fq_rows(vals))
    for e in (P - 2, (P + 1) // 4, 0x10, 3):
        assert F.fq_ints(R.pow_rows(a, e).numpy()) == [pow(v, e, P) for v in vals]
    with pytest.raises(ValueError):
        R.pow_rows(a, 0)


def test_row_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 12, dtype=torch.int32)
    with pytest.raises(TypeError):
        R.mont_mul_rows(a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError, match="differ"):
        R.add_rows(a, torch.zeros(5, 12, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        R.sub_rows(torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.int32))
    strided = torch.zeros(4, 24, dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        R.mont_mul_rows(strided, strided)
    meta = torch.zeros(4, 12, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        R.add_rows(meta, meta)
    with pytest.raises(ValueError):
        R.add_rows(torch.zeros(0, 12, dtype=torch.int32), torch.zeros(0, 12, dtype=torch.int32))
