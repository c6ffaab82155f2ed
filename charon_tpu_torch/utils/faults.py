"""Deterministic fault-injection seam, the port's copy of
charon_tpu/utils/faults.py.

A site is a cheap `faults.check("sigagg.execute")` call on the real code
path. Disarmed (the default) the check is one module global read and a
compare: no lock, no counter, no allocation. Armed, each call counts the
site's invocations under a lock and raises the planned exception when an
armed (site, index) window matches, adding one to `INJECTED[site]`.

Plans are keyed on (site, invocation index) and armed in code
(`faults.arm([...])`, or the same list as JSON text). Entry shape:

    {"site": "sigagg.execute",   # one of SITES
     "index": 2,                 # 0-based invocation that fires
     "count": 1,                 # optional: consecutive firings (default 1)
     "kind": "device_lost",      # one of KINDS (default "device_lost")
     "msg": "..."}               # optional exception text

SITES is the reference's whole tuple, so one plan is accepted or rejected
alike by both packages. The port reaches five of them:
sigagg.pack, sigagg.execute, sigagg.readback and sigagg.finish on the slot
(ops/plane_agg.py) and frost.msm on the ceremony's share check
(dkg/frost.py). The kind picks the exception class, which is what
`ops.guard.classify` keys on: `device_lost` and `timeout` land on the native
rung, `input` is a deterministic error that propagates.
"""

from __future__ import annotations

import collections
import json
import threading

# Every named injection site of the reference's pipeline. A plan naming
# anything else is rejected at arm time: a mistyped site would never fire.
SITES = (
    "sigagg.pack",      # host parse + device dispatch
    "sigagg.execute",   # device fence
    "sigagg.readback",  # device -> host copies
    "sigagg.finish",    # host back half (emit)
    "mesh.resolve",     # the reference's topology probe
    "beacon.http",      # the reference's beacon node requests
    "parsigex.recv",    # the reference's inbound partial signatures
    "dkg.round",        # the reference's ceremony round boundary
    "dkg.sync_barrier",  # the reference's stepped rendezvous
    "p2p.send",         # the reference's outbound p2p sends
    "frost.msm",        # the ceremony's device share-check MSM
)


class DeviceLostFault(RuntimeError):
    """Injected stand-in for a lost device or a failed launch:
    `ops.guard.classify` treats it as it treats a CUDA error."""


KINDS = {
    "device_lost": DeviceLostFault,
    "timeout": TimeoutError,
    "input": ValueError,
    "connection": ConnectionError,
    "error": RuntimeError,
}

# planned faults raised, by site (the reference's faults_injected_total)
INJECTED: collections.Counter = collections.Counter()

_lock = threading.Lock()
_plan: "FaultPlan | None" = None  # None == disarmed: check() is a no-op
_counts: dict[str, int] = {}      # site -> invocations since arm()


class FaultPlan:
    """A validated, immutable set of (site, index window) -> exception."""

    def __init__(self, entries) -> None:
        self._by_site: dict[str, list[tuple[int, int, str, str]]] = {}
        for e in entries:
            site = e.get("site")
            if site not in SITES:
                raise ValueError(f"unknown fault site: {site!r}")
            kind = e.get("kind", "device_lost")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind: {kind!r}")
            index = int(e.get("index", 0))
            count = int(e.get("count", 1))
            if index < 0 or count < 1:
                raise ValueError("fault index must be >= 0, count >= 1")
            msg = e.get("msg", "")
            self._by_site.setdefault(site, []).append((index, index + count, kind, msg))

    def spec_for(self, site: str, idx: int):
        """(kind, msg) when invocation `idx` of `site` is armed, else None."""
        for start, end, kind, msg in self._by_site.get(site, ()):
            if start <= idx < end:
                return kind, msg
        return None

    @property
    def sites(self) -> tuple[str, ...]:
        return tuple(sorted(self._by_site))


def parse_plan(spec) -> FaultPlan:
    """A FaultPlan from a JSON string, a list of entry dicts, an
    {"entries": [...]} dict, or a FaultPlan (passed through)."""
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, dict):
        spec = spec.get("entries", [])
    return FaultPlan(spec)


def arm(spec) -> FaultPlan:
    """Arm a plan and reset the per-site invocation counts, so that a run
    is reproducible."""
    global _plan
    plan = parse_plan(spec)
    with _lock:
        _counts.clear()
        _plan = plan
    return plan


def disarm() -> None:
    """Back to the no-op state."""
    global _plan
    with _lock:
        _plan = None
        _counts.clear()


def active() -> bool:
    return _plan is not None


def invocations(site: str) -> int:
    """How many times `site` was reached since arm() (0 when disarmed)."""
    with _lock:
        return _counts.get(site, 0)


def injected(site: str) -> int:
    """Planned faults raised at `site` since the process started."""
    with _lock:
        return INJECTED[site]


def check(site: str) -> None:
    """The injection site. Disarmed: one global read. Armed: count this
    invocation and raise the planned exception if one matches."""
    if _plan is None:
        return
    _raise_if_armed(site)


def _raise_if_armed(site: str) -> None:
    with _lock:
        plan = _plan
        if plan is None:  # disarmed between the fast check and the lock
            return
        idx = _counts.get(site, 0)
        _counts[site] = idx + 1
        spec = plan.spec_for(site, idx)
        if spec is not None:
            INJECTED[site] += 1
    if spec is None:
        return
    kind, msg = spec
    raise KINDS[kind](msg or f"injected {kind} fault at {site}[{idx}]")
