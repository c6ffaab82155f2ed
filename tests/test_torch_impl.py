"""TorchImpl as a whole tbls backend on the CPU: every method of the
charon_tpu.tbls.Implementation protocol with the reference's signature, and
the four the facade and the duty pipeline reach besides (overlapped, submit,
pin_pubkeys, verify_batch_each) with TPUImpl's; the key material byte- and
verdict-identical to NativeImpl; split and recover; and the duty pipeline
with TorchImpl(device="cpu", verify="native") installed behind
tbls.set_implementation: core/sigagg's aggregate of one duty (2 validators
at 2-of-3) and parsigex's batch verifier give NativeImpl's signed data, and
a bad partial raises "invalid partial signature"."""

import asyncio
import inspect
import random

import numpy as np
import pytest
import torch

import charon_tpu.tbls as tbls
from charon_tpu.core import parsigex, sigagg, types
from charon_tpu.core.keyshares import new_cluster_for_t
from charon_tpu.core.signeddata import SignedAttestation
from charon_tpu.eth2 import spec
from charon_tpu.tbls.native_impl import NativeImpl
from charon_tpu.tbls.tpu_impl import TPUImpl
from charon_tpu.tbls.types import PrivateKey
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.tbls.torch_impl import TorchImpl

EXTRA = ("threshold_aggregate_verify_overlapped", "threshold_aggregate_verify_submit",
         "pin_pubkeys", "verify_batch_each")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", [n for n, v in vars(tbls.Implementation).items()
                                  if inspect.isfunction(v) and not n.startswith("_")] + list(EXTRA))
def test_every_method_has_the_reference_signature(name):
    ref = getattr(tbls.Implementation if name not in EXTRA else TPUImpl, name)
    assert _params(getattr(TorchImpl, name)) == _params(ref)


def test_key_material_is_native_byte_for_byte():
    native, impl = NativeImpl(), TorchImpl(device="cpu")
    sks = [impl.generate_secret_key() for _ in range(3)]
    pks = [impl.secret_to_public_key(sk) for sk in sks]
    assert [bytes(p) for p in pks] == [bytes(native.secret_to_public_key(PrivateKey(bytes(sk))))
                                       for sk in sks]
    msg = b"\x42" * 32
    sigs = [impl.sign(sk, msg) for sk in sks]
    assert [bytes(s) for s in sigs] == [bytes(native.sign(PrivateKey(bytes(sk)), msg))
                                        for sk in sks]
    checks = [(pks[0], msg, sigs[0]), (pks[0], msg, sigs[1]), (pks[1], b"other", sigs[1]),
              (b"\x00" * 48, msg, sigs[0]), (pks[0], msg, b"\xc0" + bytes(95))]
    assert [impl.verify(*c) for c in checks] == [native.verify(*c) for c in checks] == \
        [True, False, False, False, False]
    assert bytes(impl.aggregate(sigs)) == bytes(native.aggregate(sigs))
    agg = impl.aggregate(sigs)
    for keys in (pks, pks[:2], [], [pks[0], b"\xc0" + bytes(47)]):
        assert impl.verify_aggregate(keys, msg, agg) == native.verify_aggregate(keys, msg, agg)
    assert impl.verify_aggregate(pks, msg, agg) is True
    for bad in ([], [b"\x00" * 96]):
        with pytest.raises(ValueError):
            native.aggregate(bad)
        with pytest.raises(ValueError):
            impl.aggregate(bad)
    with pytest.raises(ValueError, match="invalid secret scalar"):
        impl.sign(PrivateKey(bytes(32)), msg)
    each = impl.verify_batch_each([c[0] for c in checks], [c[1] for c in checks],
                                  [c[2] for c in checks])
    assert each.dtype == np.bool_ and each.tolist() == [True, False, False, False, False]


def test_split_recovers_the_secret():
    native, impl = NativeImpl(), TorchImpl(device="cpu")
    sk = impl.generate_secret_key()
    shares = impl.threshold_split(sk, 6, 4)
    assert sorted(shares) == [1, 2, 3, 4, 5, 6]
    pick = {i: shares[i] for i in random.Random(3).sample(range(1, 7), 4)}
    assert bytes(impl.recover_secret(pick, 6, 4)) == bytes(sk)
    assert bytes(native.recover_secret({i: PrivateKey(bytes(s)) for i, s in pick.items()},
                                       6, 4)) == bytes(sk)
    with pytest.raises(ValueError, match="insufficient"):
        impl.recover_secret(dict(list(pick.items())[:3]), 6, 4)
    with pytest.raises(ValueError, match="invalid threshold"):
        impl.threshold_split(sk, 3, 4)
    with pytest.raises(ValueError, match="invalid secret scalar"):
        impl.threshold_split(PrivateKey(PF.R.to_bytes(32, "big")), 3, 2)


# ---------------------------------------------------------------------------
# The duty pipeline behind tbls.set_implementation
# ---------------------------------------------------------------------------


def _att_data(slot=5):
    return spec.AttestationData(slot, 0, b"\x01" * 32, spec.Checkpoint(0, b"\x02" * 32),
                                spec.Checkpoint(1, b"\x03" * 32))


def _psd(chain, secret, share_idx, data=None, sign_data=None):
    """A partial attestation of `data`, signed over `sign_data` (the same
    data unless given: a bad partial otherwise)."""
    unsigned = SignedAttestation(spec.Attestation([True], data or _att_data(), b"\x00" * 96))
    over = SignedAttestation(spec.Attestation([True], sign_data or data or _att_data(),
                                              b"\x00" * 96))
    sig = tbls.sign(secret, over.signing_root(chain))
    return types.ParSignedData(unsigned.set_signature(sig), share_idx)


@pytest.fixture(scope="module")
def duty_inputs():
    """2 validators at 2-of-3, made through the default (native) backend:
    the partials of shares 1 and 2 (sigagg's input), peer 2's inbound set,
    and the same set with validator 1's partial signed over other data."""
    chain = spec.ChainSpec(genesis_time=0)
    _roots, nodes = new_cluster_for_t(2, 2, 3)
    keys = nodes[0]
    parsigs = {root: [_psd(chain, nodes[i].my_share_secrets[root], i + 1) for i in range(2)]
               for root in keys.root_pubkeys}
    inbound = {root: _psd(chain, nodes[1].my_share_secrets[root], 2) for root in keys.root_pubkeys}
    bad = dict(inbound)
    r1 = keys.root_pubkeys[1]
    bad[r1] = _psd(chain, nodes[1].my_share_secrets[r1], 2, sign_data=_att_data(slot=6))
    return chain, keys, parsigs, inbound, bad


def _run_duty(impl, chain, keys, parsigs, inbound, bad):
    """sigagg's aggregate of the duty and parsigex's batch verifier on both
    sets, with `impl` installed (restored after); returns the aggregate
    signatures by root and the bad set's error."""
    prev = tbls.get_implementation()
    tbls.set_implementation(impl)
    try:
        duty = types.Duty(5, types.DutyType.ATTESTER)
        agg = sigagg.SigAgg(keys, chain)
        out = []

        async def collect(d, signed):
            out.append(signed)

        agg.subscribe(collect)
        verify_set = parsigex.new_batch_eth2_verifier(chain, keys)

        async def run():
            await agg.aggregate(duty, parsigs)
            await verify_set(duty, inbound)
            with pytest.raises(Exception) as exc:
                await verify_set(duty, bad)
            return exc.value

        err = asyncio.run(run())
    finally:
        tbls.set_implementation(prev)
    assert len(out) == 1
    return {root: bytes(data.signature()) for root, data in out[0].items()}, err


def test_the_duty_pipeline_runs_on_torchimpl_as_on_native(duty_inputs):
    chain, keys, parsigs, inbound, bad = duty_inputs
    want, want_err = _run_duty(NativeImpl(), *duty_inputs)
    impl = TorchImpl(device="cpu", verify="native")
    got, err = _run_duty(impl, *duty_inputs)
    assert got == want and len(got) == 2
    assert "invalid partial signature" in str(err) and "invalid partial signature" in str(want_err)
    # the cluster's root set and each share set were pinned at construction
    assert impl.pk_cache.stats()["pinned_sets"] == 4
    assert impl.pairing_path["native"] > 0 and impl.pairing_path["device"] == 0
