"""The port's FROST (charon_tpu_torch/dkg/frost.py) on the CPU against the
JAX package's (charon_tpu/dkg/frost.py) and native: round1_batch with device
keygen on the replay path (fixed coefficients and nonces) gives the
reference's broadcasts and shares, finalize its KeygenResult bytes; the
device share check (_verify_shares_device, verify_shares_batch with the
size gate monkeypatched) accepts exactly what the reference's verify_share
accepts, with a batch of one evaluation point (g1_groups_msm) and of two
(g1_lincomb_is_infinity); a corrupted share, an order-3 commitment and an
infinity commitment raise the reference's CharonError, message and fields;
the errors print as the reference's. t <= 3, <= 3 dealers and validators:
every plane stays at one 128-lane bucket."""

import random

import pytest
import torch

from charon_tpu.crypto import curve as RC
from charon_tpu.crypto import fields as RF
from charon_tpu.crypto.serialize import g1_from_bytes, g1_to_bytes
from charon_tpu.dkg import frost as RFROST
from charon_tpu.utils import errors as RERR
from charon_tpu_torch.dkg import frost as TF
from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.utils import errors as TERR

from test_torch_g1_msm import INF48, _launches, _order3, chip_smoke  # noqa: F401

CPU = torch.device("cpu")
N, T = 3, 3                     # 3 dealers at threshold 3


@pytest.fixture
def device_paths(monkeypatch):
    """Device keygen on and both gates open at these sizes."""
    monkeypatch.setattr(TF, "DEVICE_KEYGEN", True)
    monkeypatch.setattr(TF, "_DEVICE_MIN_KEYGEN", 0)
    monkeypatch.setattr(TF, "_DEVICE_MIN_POINTS", 0)


def _coeffs(seed: str, validators: int):
    rng = random.Random(seed)
    return ([[rng.randrange(1, RF.R) for _ in range(T)] for _ in range(validators)],
            [rng.randrange(1, RF.R) for _ in range(validators)])


def _ceremony(node: int, validators: int, port: bool):
    """Node `node`'s round 1 over `validators` validators with seeded
    coefficients and nonces, through the port or the reference."""
    mod = TF if port else RFROST
    coeffs, nonces = _coeffs(f"node {node}", validators)
    parts = [mod.Participant(node, T, N, b"ctx %d" % v, list(coeffs[v])) for v in range(validators)]
    if port:
        return TF.round1_batch(parts, nonces, CPU)
    return RFROST.round1_batch(parts, nonces)


def test_round1_batch_and_finalize_match_the_reference(device_paths, chip_smoke):
    """Node 1's round 1 of 2 validators with device keygen (8 generator
    multiplications, one keygen call) gives the reference's broadcasts
    (to_json) and shares; the other nodes' (native keygen) too; finalize on
    every node and validator gives the reference's KeygenResult bytes."""
    CP.reset_counts()
    port = {1: _ceremony(1, 2, True)}
    assert _launches() == chip_smoke.DKG_KEYGEN_LAUNCHES
    TF.DEVICE_KEYGEN = False
    port.update({j: _ceremony(j, 2, True) for j in (2, 3)})
    ref = {j: _ceremony(j, 2, False) for j in (1, 2, 3)}
    for j in ref:
        assert [b.to_json() for b, _ in port[j]] == [b.to_json() for b, _ in ref[j]]
        assert [s for _, s in port[j]] == [s for _, s in ref[j]]
    for j in (1, 2, 3):
        for v in range(2):
            got = TF.finalize(j, N, {i: port[i][v][0] for i in port}, {i: port[i][v][1][j] for i in port})
            want = RFROST.finalize(j, N, {i: ref[i][v][0] for i in ref}, {i: ref[i][v][1][j] for i in ref})
            assert bytes(got.share_secret) == bytes(want.share_secret)
            assert bytes(got.group_pubkey) == bytes(want.group_pubkey)
            assert {i: bytes(p) for i, p in got.share_pubkeys.items()} == \
                {i: bytes(p) for i, p in want.share_pubkeys.items()}


def _items(x: int, validators: int = 2, seed: bytes = b"vs"):
    """(x, dealer d's share to x, d's commitments) for 3 dealers a validator,
    from the reference's round 1."""
    out = []
    for v in range(validators):
        for d in range(1, N + 1):
            b, shares = RFROST.Participant(d, T, N, seed + bytes([v])).round1()
            out.append((x, shares[x], b.commitments))
    return out


def _per_item(items) -> str | None:
    """The reference's per-item verdict: None, or the error it raises."""
    try:
        for it in items:
            RFROST.verify_share(*it)
    except RERR.CharonError as exc:
        return str(exc)
    return None


def test_verify_shares_batch_takes_the_device_path_and_attributes(device_paths):
    """One evaluation point (6 checks, 18 points): the device path accepts
    what verify_share accepts and counts every check under "device"; with a
    share corrupted the device equation fails and the batch raises the
    reference's CharonError at that item, after the checks before it pass
    natively."""
    items = _items(2)
    assert _per_item(items) is None
    before = dict(TF.MSM_PATHS)
    TF.verify_shares_batch(items, CPU)
    assert TF.MSM_PATHS["device"] - before.get("device", 0) == len(items)
    bad = list(items)
    mi, sh, cm = bad[4]
    bad[4] = (mi, (sh + 1) % RF.R, cm)
    want = _per_item(bad)
    assert want == "share does not match commitments: index=2"
    before = TF.MSM_PATHS["native"]
    with pytest.raises(TERR.CharonError) as exc:
        TF.verify_shares_batch(bad, CPU)
    assert str(exc.value) == want and exc.value.fields == {"index": 2}
    assert TF.MSM_PATHS["native"] - before == 4
    with pytest.raises(RERR.CharonError):
        RFROST.verify_shares_batch(bad)


def test_mixed_points_take_the_generic_lincomb(monkeypatch):
    """Two evaluation points (nodes 2 and 3): with the reference's fixed
    randomizers the port builds the reference's RLC equation, and the
    device check (g1_lincomb_is_infinity) is True, and False with a share
    corrupted, as verify_share per item."""
    items = _items(2, 1, b"mx") + _items(3, 1, b"mx")
    rng = random.Random(5)
    rands = [rng.randrange(1, 1 << 64) for _ in range(len(items))]
    assert TF._rlc_share_equation(items, iter(rands).__next__) == \
        RFROST._rlc_share_equation(items, iter(rands).__next__)
    bad = list(items)
    mi, sh, cm = bad[4]
    bad[4] = (mi, (sh + 1) % RF.R, cm)
    for batch, want in ((items, True), (bad, False)):
        monkeypatch.setattr(TF, "sample_randomizer", iter(rands).__next__)
        CP.reset_counts()
        assert TF._verify_shares_device(batch, CPU) is want
        assert (_per_item(batch) is None) is want
        assert CP.KERNELS["pt_reduce_groups"].cases == {(1, 128, 1): 1}
        assert CP.KERNELS["pt_mul_windowed"].cases == {(1, 128, 64): 1}


def test_order3_and_infinity_commitments_are_attributed(device_paths):
    """tests/test_dkg.py's order-3 dealer (C0 plus a point of order 3, the
    share still matching modulo it) and an infinity C0: the device path
    raises its ValueError, then the batch raises the reference's
    CharonError; verify_round1 rejects the infinity commitment as the
    reference does."""
    b, shares = RFROST.Participant(1, 2, 2, b"ctx").round1()
    evil = g1_to_bytes(RC.jac_add(RC.FqOps, g1_from_bytes(b.commitments[0]), _order3()))
    for c0, text in ((evil, "G1 point not in subgroup"), (INF48, "infinity G1 point rejected")):
        items = [(2, shares[2], [c0] + b.commitments[1:])]
        with pytest.raises(ValueError, match=f"^{text}$"):
            TF._verify_shares_device(items, CPU)
        want = _per_item(items)
        with pytest.raises(TERR.CharonError) as exc:
            TF.verify_shares_batch(items, CPU)
        assert str(exc.value) == want == "share does not match commitments: index=2"
    bc = TF.Round1Broadcast(1, [INF48] + b.commitments[1:], b.pok_r, b.pok_mu)
    with pytest.raises(TERR.CharonError) as exc:
        TF.verify_round1(bc, 2, b"ctx")
    with pytest.raises(RERR.CharonError) as ref:
        RFROST.verify_round1(RFROST.Round1Broadcast.from_json(bc.to_json()), 2, b"ctx")
    assert str(exc.value) == str(ref.value) == "infinity or malformed commitment: degree=0 participant=1"


def test_round1_proofs_and_gates():
    """verify_round1 accepts the reference's broadcasts and rejects a bad
    proof with its text; the size gate is one TILE; device keygen is off by
    default, so round 1 uses native generator multiplications."""
    b, _ = RFROST.Participant(2, 2, 3, b"ctx").round1()
    tb = TF.Round1Broadcast.from_json(b.to_json())
    TF.verify_round1(tb, 2, b"ctx")
    tb.pok_mu = (tb.pok_mu + 1) % RF.R
    with pytest.raises(TERR.CharonError, match="^invalid proof of knowledge: participant=2$"):
        TF.verify_round1(tb, 2, b"ctx")
    assert TF._DEVICE_MIN_POINTS == CP.TILE
    assert not TF.device_gate(CP.TILE - 1) and TF.device_gate(CP.TILE)
    assert TF.DEVICE_KEYGEN is False
    CP.reset_counts()
    TF.Participant(1, 2, 3, b"ctx").round1()
    assert _launches() == {}


def test_errors_print_as_the_reference():
    """CharonError: message, sorted fields, a wrapped cause and its fields."""
    for mod in (TERR, RERR):
        inner = mod.new("inner", b=2)
        outer = mod.CharonError("outer", cause=inner, a=1, b=3)
        assert str(outer) == "outer: a=1 b=2: cause: inner: b=2"
        assert outer.fields == {"a": 1, "b": 2}
        assert str(mod.new("plain")) == "plain"


def test_entry_points_default_to_cuda(device_paths):
    """device=None means the card: with the device paths on and no card,
    round 1 and the share check fail instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None runs there")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        TF.Participant(1, 2, 3, b"ctx").round1()
    b, shares = RFROST.Participant(1, 2, 3, b"ctx").round1()
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        TF._verify_shares_device([(2, shares[2], b.commitments)])
