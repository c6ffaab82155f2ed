"""The duty pipeline's signing back half, the port against the reference:
node 1 of a cluster — ParSigEx with the coalesced batch verifier, ParSigDB,
SigAgg through the coalescer, AggSigDB — wired as chip_smoke.DutyNode wires
it (the wiring of charon_tpu/app/app.py:413-426), fed the same seeded keys
and partial signatures. The reference's components run on NativeImpl, the
port's on TorchImpl(device="cpu") behind the port's tbls facade. AggSigDB's
contents, every verdict, the error text of a tampered partial and the
coalescer's flushes must be equal, exactly; every aggregate is the root
key's own signature."""

import asyncio
import importlib.util
import json
import os
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from charon_tpu import tbls as ref_tbls
from charon_tpu.core import aggsigdb as r_aggsigdb
from charon_tpu.core import coalesce as r_coalesce
from charon_tpu.core import deadline as r_deadline
from charon_tpu.core import gater as r_gater
from charon_tpu.core import keyshares as r_keyshares
from charon_tpu.core import parsigdb as r_parsigdb
from charon_tpu.core import parsigex as r_parsigex
from charon_tpu.core import sigagg as r_sigagg
from charon_tpu.core import signeddata as r_signeddata
from charon_tpu.core import types as r_types
from charon_tpu.eth2 import spec as r_spec
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.utils import aio as r_aio
from charon_tpu_torch import native
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.core import keyshares
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.tbls.torch_impl import TorchImpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT0 = 2048
# the same coalescer on both sides: an explicit flush count (the
# reference's default depends on its mesh), and no admission budget (a CPU
# dispatch of the device-path plain versions takes seconds)
COALESCER = {"flush_at": 1024, "deadline_budget_s": None}


@pytest.fixture(scope="module")
def CS():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DUTY_TIMEOUT_S = 600.0
    return mod


def ref_modules():
    return types.SimpleNamespace(aggsigdb=r_aggsigdb, aio=r_aio, coalesce=r_coalesce,
                                 deadline=r_deadline, gater=r_gater, parsigdb=r_parsigdb,
                                 parsigex=r_parsigex, sigagg=r_sigagg, signeddata=r_signeddata,
                                 spec=r_spec, types=r_types)


def _scalar(rng) -> int:
    return int.from_bytes(rng.bytes(32), "big") % (PF.R - 1) + 1


def cluster(n: int, total: int, threshold: int, seed: int) -> dict:
    """chip_smoke.duty_cluster's form from a numpy seed: root and share
    secrets (Shamir over Fr), their pubkeys by native ct_pubkey."""
    rng = np.random.default_rng(seed)
    roots, shares = [], []
    for _ in range(n):
        coeffs = [_scalar(rng) for _ in range(threshold)]
        roots.append(coeffs[0])
        shares.append({i: sum(c * i ** k for k, c in enumerate(coeffs)) % PF.R
                       for i in range(1, total + 1)})
    return {"root_sk": roots, "share_sk": shares,
            "root_pk": [native.pubkey(sk.to_bytes(32, "big")) for sk in roots],
            "share_pk": [{i: native.pubkey(s.to_bytes(32, "big")) for i, s in sh.items()}
                         for sh in shares]}


def ref_keys(cl: dict, threshold: int) -> r_keyshares.KeyShares:
    return r_keyshares.KeyShares(
        my_share_idx=1, threshold=threshold,
        share_pubkeys={r_types.pubkey_from_bytes(pk): {i: ref_tbls.PublicKey(s) for i, s in sh.items()}
                       for pk, sh in zip(cl["root_pk"], cl["share_pk"])},
        my_share_secrets={r_types.pubkey_from_bytes(pk): ref_tbls.PrivateKey(sh[1].to_bytes(32, "big"))
                          for pk, sh in zip(cl["root_pk"], cl["share_sk"])})


def port_keys(ref: r_keyshares.KeyShares) -> keyshares.KeyShares:
    """The port's KeyShares filled from the reference's object."""
    return keyshares.KeyShares.from_bytes(
        ref.my_share_idx, ref.threshold,
        {r: {i: bytes(pk) for i, pk in sh.items()} for r, sh in ref.share_pubkeys.items()},
        {r: bytes(sk) for r, sk in ref.my_share_secrets.items()})


def chain(m, genesis: float):
    return m.spec.ChainSpec(genesis_time=genesis, genesis_validators_root=b"\x5a" * 32)


def run_node(CS, m, tbls, impl, keys, cl, genesis, duties, tamper):
    """Node 1 of `keys` with `impl` installed in `tbls` (restored after):
    deliver `duties` [(kind, slot)] in one window, peer `tamper`'s partial
    of validator 0 of the first duty signed over another root. Returns
    what both packages must agree on, in package-free terms."""
    prev = tbls._impl
    tbls.set_implementation(impl)
    try:
        ch = chain(m, genesis)
        node = CS.DutyNode(m, keys, ch, **COALESCER)
        n = len(cl["root_sk"])
        with ThreadPoolExecutor(4) as pool:
            sets = [CS.duty_sets(m, pool, cl, ch, kind, slot, n, tamper=tamper if j == 0 else None)
                    for j, (kind, slot) in enumerate(duties)]
            got = asyncio.run(node.deliver([s[:3] for s in sets]))
            want = CS.duty_expected(pool, cl, sets, n)
    finally:
        tbls.set_implementation(prev)

    def key(duty):
        return duty.slot, int(duty.type)

    stored = {(key(d), pk): {r.hex(): json.dumps(m.types.encode_signed(v), sort_keys=True)
                             for r, v in by_root.items()}
              for (d, pk), by_root in node.adb._data.items()}
    return {"aggregates": {(key(d), pk): s for (d, pk), s in got.items()},
            "want": {(key(d), pk): s for (d, pk), s in want.items()},
            "stored": stored,
            "errors": sorted((key(d), s, str(e), e.fields.get("share_idx"))
                             for d, s, e in node.errors),
            "verified": sorted((key(d), s) for d, s, _t0, _t1 in node.verifies
                               if not any(e[:2] == (d, s) for e in node.errors)),
            # the verify window's flushes; the slots' grouping of duties
            # follows the backend's timing (a duty reaches its threshold as
            # its own sets' verdicts arrive), their items do not
            "verify_flushes": [(reqs, items) for kind, reqs, items, _t0, _t1 in node.flushes
                               if kind == "verify"],
            "agg_items": sum(items for kind, _r, items, _t0, _t1 in node.flushes if kind == "agg"),
            "fired": sorted(key(d) for d in node.threshold_at)}


# (total, threshold, the window's duties, the tampering peer). Each
# device-path call on the CPU runs plain versions for seconds, and after a
# failed window every peer's re-verify decodes that peer's pk set: the
# tampered window is the slow test below, the tampered set alone through the
# verifier the one after.
CASES = {"2-of-3": (3, 2, ("sync_message", "attester"), None),
         "4-of-6": (6, 4, ("attester",), None),
         "2-of-3, peer 3 tampered": (3, 2, ("sync_message", "attester"), 3)}


def check_back_half(CS, case):
    total, t, kinds, tamper = CASES[case]
    cl = cluster(2, total, t, seed=total)
    rk = ref_keys(cl, t)
    genesis = time.time() - SLOT0 * 12.0 - 6.0
    duties = [(k, SLOT0 + 1) for k in kinds]
    ref = run_node(CS, ref_modules(), ref_tbls, NativeImpl(), rk, cl, genesis, duties, tamper)
    impl = TorchImpl(device="cpu", verify="native")
    port = run_node(CS, CS.duty_modules(), port_tbls, impl, port_keys(rk), cl, genesis, duties,
                    tamper)
    assert port == ref
    assert port["aggregates"] == port["want"] and len(port["want"]) == 2 * len(kinds)
    sets = len(kinds) * (total - 1)
    if tamper:
        (_duty, sender, text, share_idx), = port["errors"]
        assert sender == share_idx == tamper and "invalid partial signature" in text
    else:
        assert not port["errors"]
    assert len(port["verified"]) == sets - bool(tamper)
    assert port["fired"] == sorted((SLOT0 + 1, int(r_types.DutyType[CS.DUTY_TYPES[k]]))
                                   for k in kinds)
    # one verify flush of every peer's sets, closed on the quorum (after a
    # failure, each peer's re-verify inside it attributes the verdicts)
    assert port["verify_flushes"] == [(sets, sets * 2)] and port["agg_items"] == 2 * len(kinds)
    # SigAgg pinned the root set and each share set; the native rung only
    assert impl.pk_cache.stats()["pinned_sets"] == total + 1
    assert impl.pairing_path["native"] > 0 and impl.pairing_path["device"] == 0


@pytest.mark.parametrize("case", ["2-of-3", "4-of-6"])
def test_back_half_matches_the_reference(CS, case):
    check_back_half(CS, case)


@pytest.mark.slow
def test_back_half_attributes_a_tampered_partial_in_the_window(CS):
    """A sync-committee duty with peer 3's partial tampered beside an
    attestation duty in one window: the window's verify fails, each peer's
    set is re-verified, peer 3's set is dropped with the reference's error,
    and both duties aggregate (~50 s of CPU)."""
    check_back_half(CS, "2-of-3, peer 3 tampered")


@pytest.mark.parametrize("total,threshold", [(3, 2), (6, 4)], ids=["2-of-3", "4-of-6"])
def test_tampered_partial_raises_the_reference_error(CS, total, threshold):
    """Peer 3's set with validator 0's partial over another root, through
    the batch verifier of each package: the reference's error, attributed to
    share 3."""
    cl = cluster(2, total, threshold, seed=total)
    rk = ref_keys(cl, threshold)
    genesis = time.time() - SLOT0 * 12.0 - 6.0
    errs = []
    for m, tbls, impl, keys in ((ref_modules(), ref_tbls, NativeImpl(), rk),
                                (CS.duty_modules(), port_tbls,
                                 TorchImpl(device="cpu", verify="native"), port_keys(rk))):
        ch = chain(m, genesis)
        with ThreadPoolExecutor(4) as pool:
            duty, _own, peers, _root = CS.duty_sets(m, pool, cl, ch, "attester", SLOT0 + 3, 2,
                                                    tamper=3)
        prev = tbls._impl
        tbls.set_implementation(impl)
        try:
            verify = m.parsigex.new_batch_eth2_verifier(ch, keys)
            with pytest.raises(Exception) as exc:
                asyncio.run(verify(duty, peers[3]))
        finally:
            tbls.set_implementation(prev)
        errs.append((type(exc.value).__name__, str(exc.value), exc.value.fields["share_idx"]))
    assert errs[0] == errs[1]
    assert "invalid partial signature" in errs[1][1] and errs[1][2] == 3


@pytest.mark.slow
def test_back_half_on_the_device_verify_rung(CS):
    """One validator at 2-of-3 through the port with verify="device": the
    device hash-to-G2 and pairing (their plain versions on the CPU) give
    the reference's aggregates and verdicts."""
    cl = cluster(1, 3, 2, seed=11)
    rk = ref_keys(cl, 2)
    genesis = time.time() - SLOT0 * 12.0 - 6.0
    duties = [("attester", SLOT0 + 2)]
    ref = run_node(CS, ref_modules(), ref_tbls, NativeImpl(), rk, cl, genesis, duties, None)
    impl = TorchImpl(device="cpu", verify="device")
    port = run_node(CS, CS.duty_modules(), port_tbls, impl, port_keys(rk), cl, genesis, duties,
                    None)
    assert port == ref and port["aggregates"] == port["want"] and not port["errors"]
    assert impl.pairing_path["device"] > 0 and impl.pairing_path["native"] == 0


def test_gater_and_deadliner_keep_current_slots(CS):
    """The phase's and the tests' genesis puts their slots in the gater's
    window and before their deadlines; a slot past its deadline is dropped
    by both packages' stores alike."""
    genesis = time.time() - SLOT0 * 12.0 - 6.0
    for m in (ref_modules(), CS.duty_modules()):
        ch = chain(m, genesis)
        gate = m.gater.new_duty_gater(ch)
        dl = m.deadline.Deadliner(m.deadline.new_duty_deadline_func(ch))
        duty = m.types.Duty(SLOT0 + 1, m.types.DutyType.ATTESTER)
        assert gate(duty) and dl.add(duty)
        assert not gate(m.types.Duty(SLOT0 + 2 * 32 + 1, m.types.DutyType.ATTESTER))
        assert not dl.add(m.types.Duty(SLOT0 - 6, m.types.DutyType.ATTESTER))
        assert dl.add(m.types.Duty(0, m.types.DutyType.EXIT))   # no deadline


def test_facade_defaults_to_the_card_and_never_to_the_cpu(monkeypatch):
    """The port's facade makes TorchImpl() on cuda:0 at its first call; with
    no CUDA that call raises, and nothing was installed."""
    import torch

    monkeypatch.setattr(port_tbls, "_impl", None)
    if torch.cuda.is_available():
        assert port_tbls.get_implementation().device == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tbls.sign(port_tbls.PrivateKey(b"\x01" * 32), b"m")
    assert port_tbls._impl is None
    impl = TorchImpl(device="cpu", verify="native")
    port_tbls.set_implementation(impl)
    assert port_tbls.get_implementation() is impl
    sk = port_tbls.PrivateKey((5).to_bytes(32, "big"))
    assert bytes(port_tbls.sign(sk, b"\x11" * 32)) == native.sign(bytes(sk), b"\x11" * 32)
    # the facade's submit and pin calls reach TorchImpl's own
    assert port_tbls.pin_pubkeys([port_tbls.secret_to_public_key(sk)]) is None
    assert impl.pk_cache.stats()["pinned_sets"] == 1
