"""The port's eth2 and core value layer against the reference's: SSZ roots,
the signing root of each of the ten signed types, the JSON codec, KeyShares
and the ParSigDB threshold matrix (tests/test_parsigdb_matrix.py), on the
same seeded inputs in both packages; exact equality throughout."""

import asyncio
import json

import numpy as np
import pytest

from charon_tpu.core import keyshares as ref_keyshares
from charon_tpu.core import parsigdb as ref_parsigdb
from charon_tpu.core import signeddata as ref_signeddata
from charon_tpu.core import types as ref_types
from charon_tpu.eth2 import signing as ref_signing
from charon_tpu.eth2 import spec as ref_spec
from charon_tpu.eth2 import ssz as ref_ssz
from charon_tpu_torch.core import keyshares, parsigdb, signeddata
from charon_tpu_torch.core import types as port_types
from charon_tpu_torch.eth2 import signing as port_signing
from charon_tpu_torch.eth2 import spec as port_spec
from charon_tpu_torch.eth2 import ssz as port_ssz

REF = (ref_spec, ref_signeddata, ref_types)
PORT = (port_spec, signeddata, port_types)

KINDS = ("attestation", "randao", "block", "voluntary_exit", "aggregate_and_proof",
         "sync_message", "contribution_and_proof", "beacon_committee_selection",
         "sync_committee_selection", "validator_registration")


def _values(kind: str, seed: int) -> dict:
    """The primitive fields of one signed value of `kind`, from a numpy seed."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])

    def b(n):
        return rng.bytes(n)

    def u(hi=1 << 40):
        return int(rng.integers(0, hi))

    return {"slot": u(1 << 20), "epoch": u(1 << 15), "index": u(64), "vidx": u(),
            "roots": [b(32) for _ in range(5)], "sig": b(96), "sig2": b(96), "sig3": b(96),
            "bits": [bool(x) for x in rng.integers(0, 2, int(rng.integers(1, 40)))],
            "bits128": [bool(x) for x in rng.integers(0, 2, 128)], "sub": u(4),
            "fee": b(20), "gas": u(), "ts": u(), "pk": b(48), "blinded": bool(u(2))}


def _make(pkg, kind: str, v: dict):
    spec, sd, _types = pkg
    r = v["roots"]

    def att(bits):
        data = spec.AttestationData(v["slot"], v["index"], r[0], spec.Checkpoint(v["epoch"], r[1]),
                                    spec.Checkpoint(v["epoch"] + 1, r[2]))
        return spec.Attestation(list(bits), data, v["sig"])

    if kind == "attestation":
        return sd.SignedAttestation(att(v["bits"]))
    if kind == "randao":
        return sd.SignedRandao(v["epoch"], v["sig"])
    if kind == "block":
        return sd.SignedProposal(spec.BeaconBlock(v["slot"], v["vidx"], r[0], r[1], r[2],
                                                  blinded=v["blinded"]), v["sig"])
    if kind == "voluntary_exit":
        return sd.SignedExit(spec.VoluntaryExit(v["epoch"], v["vidx"]), v["sig"])
    if kind == "aggregate_and_proof":
        return sd.SignedAggregateAndProof(
            spec.AggregateAndProof(v["vidx"], att(v["bits"]), v["sig2"]), v["sig"])
    if kind == "sync_message":
        return sd.SignedSyncMessage(spec.SyncCommitteeMessage(v["slot"], r[3], v["vidx"], v["sig"]))
    if kind == "contribution_and_proof":
        contrib = spec.SyncCommitteeContribution(v["slot"], r[3], v["sub"], v["bits128"], v["sig2"])
        return sd.SignedSyncContributionAndProof(
            spec.ContributionAndProof(v["vidx"], contrib, v["sig3"]), v["sig"])
    if kind == "beacon_committee_selection":
        return sd.BeaconCommitteeSelection(v["vidx"], v["slot"], v["sig"])
    if kind == "sync_committee_selection":
        return sd.SyncCommitteeSelection(v["vidx"], v["slot"], v["sub"], v["sig"])
    return sd.SignedRegistration(spec.ValidatorRegistration(v["fee"], v["gas"], v["ts"], v["pk"]),
                                 v["sig"])


def _chain(spec):
    """Two forks, so that signing roots pick the fork of their epoch, and
    EIP-7044's Capella domain for exits."""
    rng = np.random.default_rng(7)
    return spec.ChainSpec(genesis_time=0, genesis_validators_root=rng.bytes(32),
                          fork_schedule=((0, b"\x00\x00\x00\x01"), (1 << 10, b"\x01\x00\x00\x01")),
                          capella_fork_version=b"\x03\x00\x00\x01")


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_message_and_signing_roots_match_the_reference(kind, seed):
    v = _values(kind, seed)
    ref, port = _make(REF, kind, v), _make(PORT, kind, v)
    assert port.message_root() == ref.message_root()
    assert port.signing_root(_chain(port_spec)) == ref.signing_root(_chain(ref_spec))
    assert port.epoch(_chain(port_spec)) == ref.epoch(_chain(ref_spec))
    assert bytes(port.signature()) == bytes(ref.signature())


@pytest.mark.parametrize("kind", KINDS)
def test_codec_round_trips_byte_equal_to_the_reference(kind):
    v = _values(kind, 3)
    ref, port = _make(REF, kind, v), _make(PORT, kind, v)
    enc = port_types.encode_signed(port)
    assert json.dumps(enc, sort_keys=True) == json.dumps(ref_types.encode_signed(ref), sort_keys=True)
    back = port_types.decode_signed(json.loads(json.dumps(enc)))
    assert type(back) is type(port) and back.message_root() == port.message_root()
    # the reference's JSON decodes in the port's registry, and a partial's too
    psd = port_types.ParSignedData.from_json(ref_types.ParSignedData(ref, 4).to_json())
    assert psd.share_idx == 4 and psd.data.to_json() == port.to_json()
    # the registries are separate
    assert port_types._signed_types[kind] is type(port)
    assert ref_types._signed_types[kind] is type(ref)
    swapped = _make(REF, kind, v).set_signature(v["sig2"])
    assert bytes(_make(PORT, kind, v).set_signature(v["sig2"]).signature()) == bytes(swapped.signature())


SSZ_CASES = [
    ("uint64", lambda m: m.uint64, 2 ** 63 + 5),
    ("bytes48", lambda m: m.Bytes48, bytes(range(48))),
    ("bytelist", lambda m: m.ByteList(100), bytes(range(70))),
    ("bitlist", lambda m: m.Bitlist(2048), [bool(i % 3) for i in range(300)]),
    ("bitvector", lambda m: m.Bitvector(128), [bool(i % 5) for i in range(128)]),
    ("list_uint64", lambda m: m.List(m.uint64, 1000), list(range(37))),
    ("vector_bytes32", lambda m: m.Vector(m.Bytes32, 3), [bytes([i]) * 32 for i in range(3)]),
    ("list_bytes32", lambda m: m.List(m.Bytes32, 64), [bytes([i]) * 32 for i in range(9)]),
]


@pytest.mark.parametrize("name,typ,value", SSZ_CASES, ids=[c[0] for c in SSZ_CASES])
def test_ssz_types_match_the_reference(name, typ, value):
    assert typ(port_ssz).hash_tree_root(value) == typ(ref_ssz).hash_tree_root(value)
    assert typ(port_ssz).serialize(value) == typ(ref_ssz).serialize(value)


def test_domains_and_helpers_match_the_reference():
    pc, rc = _chain(port_spec), _chain(ref_spec)
    for slot in (0, 31, 1 << 15, (1 << 15) + 7):
        assert port_signing.slot_selection_root(pc, slot) == ref_signing.slot_selection_root(rc, slot)
        assert port_signing.randao_signing_root(pc, slot) == ref_signing.randao_signing_root(rc, slot)
    for dt in (port_signing.DOMAIN_DEPOSIT, port_signing.DOMAIN_VOLUNTARY_EXIT,
               port_signing.DOMAIN_APPLICATION_BUILDER, port_signing.DOMAIN_SYNC_COMMITTEE):
        for epoch in (0, 2000):
            assert port_signing.get_domain(pc, dt, epoch) == ref_signing.get_domain(rc, dt, epoch)
    hdr = port_spec.DepositData(b"\x01" * 48, b"\x02" * 32, 32 * 10 ** 9, b"\x03" * 96)
    ref_hdr = ref_spec.DepositData(b"\x01" * 48, b"\x02" * 32, 32 * 10 ** 9, b"\x03" * 96)
    assert hdr.hash_tree_root() == ref_hdr.hash_tree_root()
    assert hdr.ssz_serialize() == ref_hdr.ssz_serialize()


def _key_maps(n_vals: int, total: int, seed: int):
    """Share topology from a numpy seed (random 48-byte keys: KeyShares
    never decodes them)."""
    rng = np.random.default_rng(seed)
    roots = [rng.bytes(48) for _ in range(n_vals)]
    shares = {r: {i: rng.bytes(48) for i in range(1, total + 1)} for r in roots}
    secrets = {r: rng.bytes(32) for r in roots}
    return shares, secrets


@pytest.mark.parametrize("total,threshold", [(3, 2), (6, 4)])
def test_keyshares_lookups_match_the_reference(total, threshold):
    shares, secrets = _key_maps(4, total, total)
    ref = ref_keyshares.KeyShares(
        my_share_idx=2, threshold=threshold,
        share_pubkeys={ref_types.pubkey_from_bytes(r): {i: ref_types.tbls.PublicKey(pk)
                                                        for i, pk in s.items()}
                       for r, s in shares.items()},
        my_share_secrets={ref_types.pubkey_from_bytes(r): ref_types.tbls.PrivateKey(sk)
                          for r, sk in secrets.items()})
    # filled from the reference's object, and from the raw bytes maps
    port = keyshares.KeyShares.from_bytes(
        ref.my_share_idx, ref.threshold,
        {r: {i: bytes(pk) for i, pk in s.items()} for r, s in ref.share_pubkeys.items()},
        {r: bytes(sk) for r, sk in ref.my_share_secrets.items()})
    assert port == keyshares.KeyShares.from_bytes(2, threshold, shares, secrets)
    assert port.root_pubkeys == ref.root_pubkeys and port.num_shares == ref.num_shares == total
    assert port.my_share_pubkeys == ref.my_share_pubkeys
    for root in ref.root_pubkeys:
        assert bytes(port.my_share_pubkey(root)) == bytes(ref.my_share_pubkey(root))
        for i in range(1, total + 1):
            pk = port.share_pubkey(root, i)
            assert bytes(pk) == bytes(ref.share_pubkey(root, i))
            assert isinstance(pk, port_types.tbls.PublicKey)
    for pk in ref.my_share_pubkeys:
        assert port.root_by_share_pubkey(pk) == ref.root_by_share_pubkey(pk)
    errs = []
    for ks in (ref, port):
        with pytest.raises(Exception) as exc:
            ks.share_pubkey(ref.root_pubkeys[0], total + 1)
        with pytest.raises(Exception) as exc2:
            ks.root_by_share_pubkey(b"\x09" * 48)
        errs.append((str(exc.value), str(exc2.value)))
    assert errs[0] == errs[1]


# ParSigDB's threshold matrix (tests/test_parsigdb_matrix.py), run on both
# packages: n = 4, threshold 3, sync-committee messages and beacon-committee
# selections
ROOTS = [b"\x01" * 32, b"\x02" * 32]
MATRIX = [
    ("empty", [], None),
    ("all_identical_exact_threshold", [0, 0, 0], {1, 2, 3}),
    ("all_identical_above_threshold_fires_once", [0, 0, 0, 0], {1, 2, 3}),
    ("one_odd", [0, 0, 1, 0], {1, 2, 4}),
    ("two_odd", [0, 0, 1, 1], None),
]
PACKAGES = {"reference": (ref_parsigdb,) + REF, "port": (parsigdb,) + PORT}


def _provider(pkg, name):
    _db, spec, sd, types = pkg
    if name == "sync_message":
        return types.DutyType.SYNC_MESSAGE, lambda i, r: types.ParSignedData(
            sd.SignedSyncMessage(spec.SyncCommitteeMessage(9, ROOTS[r], 3, bytes([i]) * 96)), i)
    return types.DutyType.PREPARE_AGGREGATOR, lambda i, r: types.ParSignedData(
        sd.BeaconCommitteeSelection(3, 100 + r, bytes([i]) * 96), i)


def _fires(pkg, pname, inputs, threshold=3, stores=None):
    db_mod, _spec, _sd, types = pkg
    duty_type, provider = _provider(pkg, pname)
    pubkey = types.pubkey_from_bytes(b"\xaa" * 48)

    async def run():
        db = db_mod.MemDB(threshold)
        fires = []

        async def on_threshold(duty, payload):
            fires.append(sorted((p.share_idx, p.message_root()) for p in payload[pubkey]))

        db.subscribe_threshold(on_threshold)
        duty = types.Duty(9, duty_type)
        for i, r in stores or [(i + 1, r) for i, r in enumerate(inputs)]:
            await db.store_external(duty, {pubkey: provider(i, r)})
        return fires

    return asyncio.run(run())


@pytest.mark.parametrize("pname", ["sync_message", "selection"])
@pytest.mark.parametrize("name,inputs,expect", MATRIX, ids=[m[0] for m in MATRIX])
def test_parsigdb_threshold_matrix_on_both_packages(pname, name, inputs, expect):
    got = {p: _fires(pkg, pname, inputs) for p, pkg in PACKAGES.items()}
    assert got["port"] == got["reference"]
    if expect is None:
        assert got["port"] == []
    else:
        assert len(got["port"]) == 1 and {i for i, _r in got["port"][0]} == expect
        assert len({r for _i, r in got["port"][0]}) == 1


@pytest.mark.parametrize("case", ["late_partial", "multi_root", "equivocation"])
def test_parsigdb_edges_on_both_packages(case):
    stores, pname, threshold = {
        # a 4th matching partial after the fire: stored, not re-fired
        "late_partial": ([(i, 0) for i in range(1, 5)], "sync_message", 3),
        # PREPARE_* duties fire per root group
        "multi_root": ([(1, 0), (2, 0), (1, 1), (2, 1)], "selection", 2),
        # one share signing two payloads of a single-payload duty is dropped
        "equivocation": ([(1, 0), (1, 1), (2, 1), (3, 0)], "sync_message", 2),
    }[case]
    got = {p: _fires(pkg, pname, None, threshold, stores) for p, pkg in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert len(got["port"]) == {"late_partial": 1, "multi_root": 2, "equivocation": 1}[case]
