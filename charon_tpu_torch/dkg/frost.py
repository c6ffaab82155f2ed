"""FROST distributed key generation, the port's copy of
charon_tpu/dkg/frost.py (reference dkg/frost.go:50-210 via coinbase/
kryptology's DkgParticipant): Pedersen-style 2-round VSS keygen over
BLS12-381, secret shares in Fr and commitments in G1, run for all of a
node's validators in parallel.

  Round 1: participant i samples a degree-(t-1) polynomial f_i, broadcasts
    C_i = [a_i0·G .. a_i(t-1)·G] with a Schnorr proof of knowledge of a_i0
    bound to a context string, and sends f_i(j) to each participant j.
  Round 2: j verifies every proof and its share against the commitments,
    f_i(j)·G == Σ_k C_ik·j^k, then x_j = Σ_i f_i(j); the group pubkey is
    Σ_i C_i0 and the share pubkeys come from the summed commitments.

The device paths (BASELINE config 4: 6 operators, 200 validators) run on the
port's kernels (ops/plane_agg.py): the batched generator multiplications of
round 1 (`g1_mul_gen_batch`, opt-in, see the trust-boundary note), and the
batched share check (`g1_groups_msm` when every check shares its evaluation
point, `g1_lincomb_is_infinity` otherwise). Their entry points take
`device=None`, which means "cuda". The per-item checks and the proofs go
through native `ct_g1_lincomb` / `ct_pubkey` (native.py). As in the
reference, the device paths sit behind ops/guard.py: the share check takes
the device only while the plane breaker allows it (`device_gate`), and a
device-class failure of the batched share check (the fault site
frost.msm) or of the batched keygen degrades to the native path with the
same results, noted through guard.note_ceremony_fallback (the breaker and
its fallback counter) and counted in FALLBACKS. Any other error of a
device path propagates; a ValueError of the share check (a bad encoding,
∞, a point outside the subgroup) routes the batch to the exact per-item
check, which attributes the dealer. `MSM_PATHS` counts the share checks
completed per path, as the reference's dkg_msm_total.
"""

from __future__ import annotations

import collections
import hashlib
import secrets as _secrets
import threading
from dataclasses import dataclass, field

import torch

from .. import native
from ..crypto import fields as F
from ..crypto.curve import FqOps, g1_generator, jac_add, jac_is_infinity, jac_mul
from ..crypto.rlc import sample_randomizer
from ..crypto.serialize import g1_finite_compressed
from ..ops import guard, plane_agg
from ..tbls.types import PrivateKey, PublicKey
from ..utils import errors, faults

# share checks completed per path: "device" (the batched MSM) or "native"
# (the per-item lincomb)
MSM_PATHS: collections.Counter = collections.Counter()
# device-class failures degraded to native, by (path, reason): path
# "frost.msm" (the batched share check) or "keygen"
FALLBACKS: collections.Counter = collections.Counter()
_paths_lock = threading.Lock()


def _count(path: str, amount: int) -> None:
    with _paths_lock:
        MSM_PATHS[path] += amount


def _degraded(path: str, exc: BaseException) -> None:
    """A device path failed device-class: the breaker and the guard's
    counter hear of it, and FALLBACKS counts it."""
    reason = guard.device_reason(exc)
    guard.note_ceremony_fallback(reason, exc)
    with _paths_lock:
        FALLBACKS[path, reason] += 1


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _g1_mul_gen(scalar: int) -> bytes:
    """scalar·G1 compressed (scalar 1..r-1)."""
    return native.pubkey((scalar % F.R).to_bytes(32, "big"))


def _g1_lincomb(points: list[bytes], scalars: list[int]) -> bytes:
    if len(points) != len(scalars):
        raise errors.new("lincomb length mismatch", points=len(points), scalars=len(scalars))
    out = native.g1_lincomb(points, scalars)
    if out is None:
        raise errors.new("invalid commitment point encoding")
    return out


def _g1_add(a: bytes, b: bytes) -> bytes:
    return _g1_lincomb([a, b], [1, 1])


# -- Schnorr proof of knowledge of the polynomial constant term ----------------

def _pok_challenge(participant: int, context: bytes, a0_commit: bytes, r_commit: bytes) -> int:
    h = hashlib.sha256(b"charon-tpu/frost-pok" + participant.to_bytes(4, "big")
                       + context + a0_commit + r_commit).digest()
    return int.from_bytes(h, "big") % F.R


@dataclass
class Round1Broadcast:
    participant: int              # 1-based index
    commitments: list[bytes]      # t G1 points
    pok_r: bytes                  # Schnorr commitment R = k*G
    pok_mu: int                   # k + a0*challenge mod r

    def to_json(self) -> dict:
        return {"participant": self.participant,
                "commitments": [c.hex() for c in self.commitments],
                "pok_r": self.pok_r.hex(), "pok_mu": str(self.pok_mu)}

    @staticmethod
    def from_json(o: dict) -> "Round1Broadcast":
        return Round1Broadcast(int(o["participant"]),
                               [bytes.fromhex(c) for c in o["commitments"]],
                               bytes.fromhex(o["pok_r"]), int(o["pok_mu"]))


@dataclass
class Participant:
    """One participant's state for ONE validator's keygen
    (reference kryptology DkgParticipant)."""

    index: int                    # 1-based
    threshold: int
    total: int
    context: bytes                # session binding (cluster def hash etc.)
    _coeffs: list[int] = field(default_factory=list)

    def round1(self, device=None) -> tuple[Round1Broadcast, dict[int, int]]:
        """Returns (broadcast, {participant_j -> share f_i(j)}): one
        participant of round1_batch."""
        return round1_batch([self], device=device)[0]

    def _eval(self, x: int) -> int:
        acc = 0
        for a in reversed(self._coeffs):
            acc = (acc * x + a) % F.R
        return acc

    @staticmethod
    def _rand_scalar() -> int:
        while True:
            s = _secrets.randbelow(F.R)
            if s:
                return s


def round1_batch(parts: list[Participant], nonces: list[int] | None = None, device=None
                 ) -> list[tuple[Round1Broadcast, dict[int, int]]]:
    """Round 1 for many participants (a node's whole validator set), the
    commitments C_ik = a_ik·G and PoK nonce commitments k·G of the batch in
    one batched generator multiplication (`_mul_gen_many`). Replay: a
    participant whose `_coeffs` are set keeps them, and the caller supplies
    the matching `nonces`, so a resumed node re-derives bit-identical
    broadcasts and shares."""
    for p in parts:
        if not p._coeffs:
            p._coeffs = [p._rand_scalar() for _ in range(p.threshold)]
    if nonces is None:
        nonces = [p._rand_scalar() for p in parts]
    scalars = [a for p in parts for a in p._coeffs] + nonces
    pts = _mul_gen_many(scalars, device)
    out = []
    off = 0
    for i, p in enumerate(parts):
        commitments = pts[off:off + p.threshold]
        off += p.threshold
        r_commit = pts[len(scalars) - len(parts) + i]
        c = _pok_challenge(p.index, p.context, commitments[0], r_commit)
        mu = (nonces[i] + p._coeffs[0] * c) % F.R
        shares = {j: p._eval(j) for j in range(1, p.total + 1)}
        out.append((Round1Broadcast(p.index, commitments, r_commit, mu), shares))
    return out


# TRUST BOUNDARY: batched device keygen ships the secret polynomial
# coefficients and PoK nonces to the device as digit planes. On a machine
# whose accelerator is in the host's trust domain that is equivalent to host
# memory, but a remote or shared accelerator hands key material to whatever
# carries it, defeating the DKG's no-single-party-learns-the-key property.
# So it is OFF by default (native keygen; secrets never leave the process)
# and opt-in for trusted-device deployments through enable_device_keygen().
DEVICE_KEYGEN = False
_DEVICE_MIN_KEYGEN = 256


def enable_device_keygen() -> None:
    """Opt in to batched on-device generator multiplications for round-1
    keygen — ONLY for deployments whose accelerator (and the path to it) is
    inside the operator's trust domain; see the trust-boundary note."""
    global DEVICE_KEYGEN
    DEVICE_KEYGEN = True


def _mul_gen_many(scalars: list[int], device=None) -> list[bytes]:
    if DEVICE_KEYGEN and len(scalars) >= _DEVICE_MIN_KEYGEN:
        try:
            return plane_agg.g1_mul_gen_batch(scalars, _device(device))
        except Exception as exc:
            if not guard.is_device_error(exc):
                raise
            _degraded("keygen", exc)    # the serial native keygen below
    return [_g1_mul_gen(s) for s in scalars]


def verify_round1(bcast: Round1Broadcast, threshold: int, context: bytes) -> None:
    """Verify the Schnorr PoK mu·G == R + challenge·C0, after rejecting ∞
    commitments: C_ik = ∞ is a zero coefficient, a degenerate dealer, and
    the RLC identity that the batched share check must never see."""
    if len(bcast.commitments) != threshold:
        raise errors.new("wrong commitment count", participant=bcast.participant)
    for k, c in enumerate(bcast.commitments):
        if not g1_finite_compressed(c):
            raise errors.new("infinity or malformed commitment",
                             participant=bcast.participant, degree=k)
    c = _pok_challenge(bcast.participant, context, bcast.commitments[0], bcast.pok_r)
    lhs = _g1_mul_gen(bcast.pok_mu)
    rhs = _g1_lincomb([bcast.pok_r, bcast.commitments[0]], [1, c])
    if lhs != rhs:
        raise errors.new("invalid proof of knowledge", participant=bcast.participant)


def verify_share(my_index: int, share: int, commitments: list[bytes]) -> None:
    """Check f_i(j)·G == Σ_k C_ik·j^k (VSS consistency)."""
    powers = []
    x = 1
    for _ in commitments:
        powers.append(x)
        x = (x * my_index) % F.R
    expect = _g1_lincomb(commitments, powers)
    got = _g1_mul_gen(share)
    if expect != got:
        raise errors.new("share does not match commitments", index=my_index)


# One TILE of commitment points (plane_agg's chunk, cuda_plane.TILE) is the
# smallest batch that fills a whole chunk of the device MSM; the reference
# keeps the gate equal to its TILE too.
_DEVICE_MIN_POINTS = 1024


def device_gate(total: int) -> bool:
    """Should a batch of `total` commitment points take the device MSM? The
    size gate (at least one full chunk) and the plane breaker (an open
    breaker means the device is known to fail: no doomed dispatch
    mid-ceremony; a half-open one admits this batch as its probe). The
    reference's platform gate has no counterpart: the device is the
    caller's `device`."""
    return total >= _DEVICE_MIN_POINTS and guard.allow_device_dispatch()


def verify_shares_batch(items: list[tuple[int, int, list[bytes]]], device=None) -> None:
    """Verify many share/commitment checks at once (my_index, share,
    commitments), one per (dealer, validator) pair. The M checks
    f_m·G − Σ_k C_mk·x_m^k == ∞ collapse under random weights r_m
    (2^-RLC_BITS soundness) into one G1 MSM on the device; when it fails,
    raises a ValueError (a bad or ∞ point, one outside the subgroup), fails
    device-class (guard.note_ceremony_fallback) or the batch is below the
    gate, every item is checked on its own, which attributes the offending
    dealer. Raises like verify_share. A device check that ends in neither a
    True verdict nor a device-class failure releases the breaker's probe,
    if it was the probe."""
    total = sum(len(c) for _, _, c in items)
    if device_gate(total):
        try:
            faults.check("frost.msm")
            ok = _verify_shares_device(items, device)
        except ValueError:
            ok = False  # invalid encoding: attribute below
        except Exception as exc:
            if not guard.is_device_error(exc):
                guard.BREAKER.release_probe()
                raise
            _degraded("frost.msm", exc)
            ok = None
        if ok:
            guard.BREAKER.record_success()
            _count("device", len(items))
            return
        if ok is False:
            guard.BREAKER.release_probe()
    for my_index, share, commitments in items:
        verify_share(my_index, share, commitments)
        _count("native", 1)


def _verify_shares_device(items, device=None) -> bool:
    """The RLC equation on the device. When every check shares its
    evaluation point x (a node verifying its own shares, the ceremony's
    case) it factors as (Σ_m r_m·f_m)·G == Σ_k x^k·(Σ_m r_m·C_mk): one sweep
    on the 64-bit r_m digits with one group a degree k (g1_groups_msm), then
    t host scalar multiplications. Mixed points take the generic MSM
    (g1_lincomb_is_infinity)."""
    device = _device(device)
    xs = {mi for mi, _, _ in items}
    if len(xs) != 1:
        points, scalars = _rlc_share_equation(items)
        return plane_agg.g1_lincomb_is_infinity(points, scalars, device)
    x = xs.pop()
    t = max(len(c) for _, _, c in items)
    points: list[bytes] = []
    scalars: list[int] = []
    groups: list[int] = []
    gen_scalar = 0
    for _mi, share, commitments in items:
        r = sample_randomizer()
        gen_scalar = (gen_scalar + r * share) % F.R
        for k, c in enumerate(commitments):
            points.append(c)
            scalars.append(r)
            groups.append(k)
    sums = plane_agg.g1_groups_msm(points, scalars, groups, t, device)
    # host: Σ_k x^k·P_k − gen_scalar·G == ∞
    acc = None
    xk = 1
    for k in range(t):
        term = jac_mul(FqOps, sums[k], xk)
        acc = term if acc is None else jac_add(FqOps, acc, term)
        xk = (xk * x) % F.R
    lhs = jac_mul(FqOps, g1_generator(), gen_scalar)
    neg = (lhs[0], (-lhs[1]) % F.P, lhs[2])
    return jac_is_infinity(FqOps, jac_add(FqOps, acc, neg))


def _rlc_share_equation(items: list[tuple[int, int, list[bytes]]],
                        rand=None) -> tuple[list[bytes], list[int]]:
    """The single-MSM RLC equation of verify_shares_batch: (points,
    scalars) with Σ kᵢ·Pᵢ == ∞ iff (whp over the r_m) every check holds."""
    rand = rand or sample_randomizer
    points: list[bytes] = []
    scalars: list[int] = []
    gen_scalar = 0
    for my_index, share, commitments in items:
        r = rand()
        gen_scalar = (gen_scalar + r * share) % F.R
        x = 1
        for c in commitments:
            points.append(c)
            scalars.append((-r * x) % F.R)
            x = (x * my_index) % F.R
    points.append(_g1_mul_gen(1))
    scalars.append(gen_scalar)
    return points, scalars


@dataclass
class KeygenResult:
    share_secret: PrivateKey                 # x_j
    group_pubkey: PublicKey                  # sum_i C_i0
    share_pubkeys: dict[int, PublicKey]      # all participants' share pubkeys


def finalize(my_index: int, total: int, broadcasts: dict[int, Round1Broadcast],
             my_shares: dict[int, int]) -> KeygenResult:
    """Round 2: aggregate shares and derive the group and share public keys.
    `my_shares[i]` is f_i(my_index) received from participant i."""
    if set(broadcasts) != set(range(1, total + 1)) or set(my_shares) != set(broadcasts):
        raise errors.new("missing round1 contributions")
    x_j = sum(my_shares.values()) % F.R
    if x_j == 0:
        raise errors.new("degenerate zero share")
    group = None
    for b in broadcasts.values():
        group = b.commitments[0] if group is None else _g1_add(group, b.commitments[0])
    # summed commitment polynomial D_k = Σ_i C_ik, then each share pubkey is
    # the t-term evaluation Σ_k D_k·j^k
    threshold = len(broadcasts[my_index].commitments)
    summed = []
    for k in range(threshold):
        pts = [b.commitments[k] for b in broadcasts.values()]
        summed.append(_g1_lincomb(pts, [1] * len(pts)))
    share_pubkeys = {}
    for j in range(1, total + 1):
        powers = []
        x = 1
        for _ in range(threshold):
            powers.append(x)
            x = (x * j) % F.R
        share_pubkeys[j] = PublicKey(_g1_lincomb(summed, powers))
    result = KeygenResult(share_secret=PrivateKey(x_j.to_bytes(32, "big")),
                          group_pubkey=PublicKey(group), share_pubkeys=share_pubkeys)
    # sanity: our own share must match our share pubkey
    if native.pubkey(result.share_secret) != bytes(share_pubkeys[my_index]):
        raise errors.new("aggregated share does not match derived pubkey")
    return result
