"""Port Miller loop and multi-pairing check vs the JAX package and the native
oracle: one `_dbl_step` and one `_add_step` of ops/pairing.py (plain rows
path) against charon_tpu.ops.pairing's on the same seeded batch-2 inputs,
f and T limb for limb; then `pairing_check_planes` on 2 and 3 pairs, valid
and tampered, against native ct_pairing_check (through
charon_tpu.tbls.native_impl's library), and the chunked path with a 2-pair
tile against the same verdicts.

The reference's Miller steps run eagerly with its field primitives under
jax.jit; its whole-loop functions (miller_loop_pairs, final_exp_is_one,
pairing_check_planes) are not called: their lax.scan graphs take minutes to
compile on XLA:CPU."""

import ctypes
import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RPF
from charon_tpu.crypto.serialize import g1_to_bytes, g2_to_bytes
from charon_tpu.ops import field as RF
from charon_tpu.ops import pairing as RPR
from charon_tpu.tbls.native_impl import load_library
from charon_tpu_torch.crypto.serialize import g2_affine_from_bytes
from charon_tpu_torch.ops import convert as CV
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.ops import pairing as PR

P = RF.P_INT
CPU = torch.device("cpu")


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


def _fq(rng, n=2):
    return np.stack([RF.fq_from_int(rng.randrange(P)) for _ in range(n)])


def _tree(x, fn):
    return tuple(_tree(c, fn) for c in x) if isinstance(x, tuple) else fn(x)


def _same(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert np.array_equal(CV.rows_to_jax(got), np.asarray(want))


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_step_matches_the_jax_package(step, jit_field):
    rng = random.Random(41 if step == "dbl" else 42)
    f = tuple(tuple(_fq2(rng) for _ in range(3)) for _ in range(2))
    Tp = tuple(_fq2(rng) for _ in range(3))
    xq, yq, xp, yp = _fq2(rng), _fq2(rng), _fq(rng), _fq(rng)
    j, t = (lambda x: _tree(x, jnp.asarray)), (lambda x: _tree(x, CV.rows_from_jax))
    if step == "dbl":
        want = RPR._dbl_step(j(f), j(Tp), j(xp), j(yp))
        got = PR._dbl_step(t(f), t(Tp), t(xp), t(yp))
    else:
        want = RPR._add_step(j(f), j(Tp), j(xq), j(yq), j(xp), j(yp))
        got = PR._add_step(t(f), t(Tp), t(xq), t(yq), t(xp), t(yp))
    _same(got, want)


# ---------------------------------------------------------------------------
# Whole checks against native ct_pairing_check
# ---------------------------------------------------------------------------


def _h(msg: bytes):
    out = (ctypes.c_uint8 * 96)()
    load_library().ct_hash_to_g2(msg, len(msg), out)
    return RC.to_jacobian(RC.Fq2Ops, g2_affine_from_bytes(bytes(out)))


@pytest.fixture(scope="module")
def pair_sets():
    """(g1 Jacobians, g2 Jacobians) for the 2- and 3-pair checks, each
    Π e(pk_i, H(m_i)) · e(−g1, Σ sk_i·H(m_i)) == 1."""
    rng = random.Random(43)
    neg_g1 = RC.jac_neg(RC.FqOps, RC.g1_generator())
    sets = {}
    for n in (2, 3):
        g1, g2, S = [], [], RC.jac_infinity(RC.Fq2Ops)
        for i in range(n - 1):
            sk = rng.randrange(1, RPF.R)
            H = _h(b"pairing-%d-%d" % (n, i))
            g1.append(RC.jac_mul(RC.FqOps, RC.g1_generator(), sk))
            g2.append(H)
            S = RC.jac_add(RC.Fq2Ops, S, RC.jac_mul(RC.Fq2Ops, H, sk))
        sets[n] = (g1 + [neg_g1], g2 + [S])
    return sets


def _tamper(g2):
    """The last pair's G2 point doubled."""
    return g2[:-1] + [RC.jac_double(RC.Fq2Ops, g2[-1])]


def _native(g1, g2) -> bool:
    rc = load_library().ct_pairing_check(b"".join(g1_to_bytes(p) for p in g1),
                                         b"".join(g2_to_bytes(q) for q in g2),
                                         bytes(len(g1)), len(g1), 0)
    assert rc >= 0
    return rc == 1


def _port(g1, g2) -> bool:
    px, py = PR.g1_rows([RC.to_affine(RC.FqOps, p) for p in g1], CPU)
    qx, qy = PR.g2_rows([RC.to_affine(RC.Fq2Ops, q) for q in g2], CPU)
    return PR.pairing_check_planes(px, py, qx, qy)


@pytest.mark.parametrize("n,tampered", [(2, False), (2, True), (3, False), (3, True)])
def test_pairing_check_matches_native(n, tampered, pair_sets):
    g1, g2 = pair_sets[n]
    if tampered:
        g2 = _tamper(g2)
    CP.reset_counts()
    got = _port(g1, g2)
    assert got is (not tampered)
    assert got == _native(g1, g2)
    if n == 2:
        # one steady 2-pair device verify: 4,778 rows calls, each a launch on
        # the card (an Fq2 product is one fe_mul_rows<2>; a level's
        # independent adds, ξ products and subs one split fe_add_rows, a
        # subtraction fe_add_rows at n_add = 0; the Fq inversion one fe_pow)
        assert {k: dict(CP.KERNELS[k].plain_calls)
                for k in ("fe_mul_rows", "fe_add_rows", "fe_pow")} == {
            "fe_mul_rows": {1: 70, 2: 699}, "fe_add_rows": {1: 4008},
            "fe_pow": {"plane": 0, "rows": 1}}
        splits = CP.KERNELS["fe_add_rows"].cases
        assert sum(c for (_E, _n, k), c in splits.items() if k > 0) == 1519
        assert sum(c for (_E, _n, k), c in splits.items() if k == 0) == 920
    assert CP.KERNELS["fe_mul_rows"].plain_calls[2] > 0


@pytest.mark.parametrize("tampered", [False, True])
def test_chunked_check_matches_the_monolithic_verdict(tampered, pair_sets, monkeypatch):
    """Three pairs with a 2-pair tile: chunks [2, 1], folded across chunks
    before the one final exponentiation; a tamper in the last chunk is
    caught."""
    g1, g2 = pair_sets[3]
    if tampered:
        g2 = _tamper(g2)
    chunks = []
    real = PR.miller_fold_chunk
    monkeypatch.setattr(PR, "MAX_PAIR_TILE", 2)
    monkeypatch.setattr(PR, "miller_fold_chunk", lambda *a: chunks.append(a[0].shape[0]) or real(*a))
    assert _port(g1, g2) is (not tampered) is _native(g1, g2)
    assert chunks == [2, 1]


def test_empty_pair_set_is_true():
    z = torch.zeros(0, 12, dtype=torch.int32)
    assert PR.pairing_check_planes(z, z, z.view(0, 1, 12).expand(0, 2, 12), z.view(0, 1, 12).expand(0, 2, 12))
