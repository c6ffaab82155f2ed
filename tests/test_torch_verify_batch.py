"""The port's bulk verify of (pk, msg, sig) triples (plane_agg.rlc_verify_batch,
TorchImpl.verify_batch) on the CPU, against the JAX package's
NativeImpl().verify_batch on every soundness case chip_smoke.py's
bulk-verify phase gates: valid, a partial of another share, an infinity
signature, a signature outside the subgroup, a bad flag byte, an infinity
or out-of-subgroup pubkey, at n = 0, 1 and 3 with one and two messages, on
the native rung and (valid) on the device rung. The chunks, the G2 subgroup
check and the chunked pk planes are tests/test_torch_verify_chunks.py's."""

import random

import pytest
import torch

from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RPF
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch.crypto import curve as PC
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.crypto import serialize as S
from charon_tpu_torch.ops import plane_agg as PA
from charon_tpu_torch.tbls.torch_impl import TorchImpl

CPU = torch.device("cpu")
BP = 128
INF96 = b"\xc0" + bytes(95)
INF48 = b"\xc0" + bytes(47)
MSGS = (b"\x11" * 32, b"\x22" * 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def native():
    return NativeImpl()


@pytest.fixture(scope="module")
def keys(native):
    """Four keys; each signs both messages."""
    rng = random.Random(41)
    sks = [PrivateKey(rng.randrange(1, RPF.R).to_bytes(32, "big")) for _ in range(4)]
    pks = [bytes(native.secret_to_public_key(sk)) for sk in sks]
    sigs = {m: [bytes(native.sign(sk, m)) for sk in sks] for m in MSGS}
    return pks, sigs


def _g2_bytes(pt) -> bytes:
    return S.g2_to_bytes(pt)


def _curve_points_g2():
    """Points of G2's curve from the x = (x0, 1) that decompress, not
    cofactor-cleared (so outside the subgroup)."""
    x0 = 1
    while True:
        x = (x0, 1)
        y = PF.fq2_sqrt(PF.fq2_add(PF.fq2_mul(PF.fq2_sqr(x), x), PC.B_G2))
        if y is not None:
            yield (x, y, (1, 0))
        x0 += 1


def _mul(ops, pt, k: int):
    acc = PC.jac_infinity(ops)
    for bit in bin(k)[2:]:
        acc = PC.jac_double(ops, acc)
        if bit == "1":
            acc = PC.jac_add(ops, acc, pt)
    return acc


G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5


@pytest.fixture(scope="module")
def off_g2(keys):
    """Two encodings outside G2's subgroup: a raw curve point, and a valid
    signature plus a point of order 13 (G2's cofactor has no factor 3; 13
    is its smallest prime)."""
    for raw in _curve_points_g2():
        # the curve's group exponent is r·h2/13 (13² divides h2), so a
        # point of order 13 is [r·h2/13²]P where that is not ∞
        t13 = _mul(PC.Fq2Ops, raw, PF.R * G2_COFACTOR // 169)
        if not PC.jac_is_infinity(PC.Fq2Ops, t13):
            break
    assert PC.jac_is_infinity(PC.Fq2Ops, _mul(PC.Fq2Ops, t13, 13))
    sig = S.g2_affine_from_bytes(keys[1][MSGS[0]][0])
    mixed = PC.jac_add(PC.Fq2Ops, PC.to_jacobian(PC.Fq2Ops, sig), t13)
    return _g2_bytes(raw), _g2_bytes(mixed)


def _off_g1() -> bytes:
    x = 5
    while True:
        y = RPF.fq_sqrt((x ** 3 + 4) % RPF.P)
        if y is not None and not RC.g1_in_subgroup((x, y, 1)):
            return S.g1_to_bytes((x, y, 1))
        x += 1


# ---------------------------------------------------------------------------
# Verdicts against the native verifier
# ---------------------------------------------------------------------------

# (name, triples, messages)
CONFIGS = [("n1", 1, 1), ("n3 one message", 3, 1), ("n3 two messages", 3, 2)]
CASES = ["valid", "another share", "infinity sig", "sig outside the subgroup", "bad flag",
         "infinity pk", "pk outside the subgroup"]


def _triples(keys, off_g2, n: int, n_msgs: int, case: str):
    """n triples of keys 0..n-1 over the messages (key i signs message
    i % n_msgs), the last one altered by `case`."""
    pks, sigs = keys
    msgs = [MSGS[i % n_msgs] for i in range(n)]
    t_pks = list(pks[:n])
    t_sigs = [sigs[m][i] for i, m in enumerate(msgs)]
    k = n - 1
    if case == "another share":
        t_sigs[k] = sigs[msgs[k]][3]
    elif case == "infinity sig":
        t_sigs[k] = INF96
    elif case == "sig outside the subgroup":
        t_sigs[k] = off_g2[1]
    elif case == "bad flag":
        t_sigs[k] = bytes([t_sigs[k][0] & 0x7F]) + t_sigs[k][1:]
    elif case == "infinity pk":
        t_pks[k] = INF48
    elif case == "pk outside the subgroup":
        t_pks[k] = _off_g1()
    return t_pks, msgs, t_sigs


@pytest.fixture(scope="module")
def impl():
    """One native-rung TorchImpl for the matrix: its pk planes are shared."""
    return TorchImpl(device="cpu", verify="native")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_verdicts_match_the_native_verifier(native, keys, off_g2, impl, config, case):
    _name, n, n_msgs = config
    pks, msgs, sigs = _triples(keys, off_g2, n, n_msgs, case)
    want = native.verify_batch(pks, msgs, sigs)
    assert want is (case == "valid")
    assert impl.verify_batch(pks, msgs, sigs) is want


def test_empty_and_mismatched_batches(native, impl, keys):
    assert impl.verify_batch([], [], []) is True and native.verify_batch([], [], []) is True
    with pytest.raises(ValueError, match="length mismatch"):
        impl.verify_batch(keys[0][:2], [MSGS[0]], keys[1][MSGS[0]][:2])
    with pytest.raises(ValueError, match="length mismatch"):
        PA.rlc_verify_batch(keys[0][:2], [MSGS[0]], keys[1][MSGS[0]][:1], CPU,
                            PA.PkPlaneCache(), PA.H2CCache(), {})


def test_device_rung_verdict(keys, impl):
    """TorchImpl(device="cpu") checks the pairing on the device path by
    default: the same verdicts, the pairs counted on the device rung (one
    message group and the signature pair). H(m) is filled natively first,
    so its rows come from the host decompression of the cached bytes."""
    dev = TorchImpl(device="cpu")
    dev.pk_cache = impl.pk_cache
    dev.h2c.get(MSGS[0])
    pks, sigs = keys
    assert dev.verify_batch(pks[:1], [MSGS[0]], sigs[MSGS[0]][:1]) is True
    assert dev.pairing_path == {"device": 2, "native": 0}
    assert dev.rung == "device" and dev.h2c.misses == 1
