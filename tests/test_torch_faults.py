"""The port's fault-injection seam (charon_tpu_torch/utils/faults.py) against
the reference's (charon_tpu/utils/faults.py): the same plans are accepted
or rejected alike, with the same error text, the same invocation windows
fire with the same exception kinds and texts, and the environment variable
arms both alike. Exact: equal outcomes, equal texts."""

import json

import pytest

from charon_tpu.utils import faults as RF
from charon_tpu_torch.utils import faults as TF


@pytest.fixture(autouse=True)
def _disarmed():
    RF.disarm()
    TF.disarm()
    yield
    RF.disarm()
    TF.disarm()


def _outcome(mod, spec):
    """("ok", sites) or ("error", type name, text) of mod.parse_plan(spec)."""
    try:
        return ("ok", mod.parse_plan(spec).sites)
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return ("error", type(exc).__name__, str(exc))


PLANS = {
    "one entry": [{"site": "sigagg.execute"}],
    "json string": json.dumps([{"site": "sigagg.pack", "index": 2, "count": 3}]),
    "dict wrapper": {"entries": [{"site": "frost.msm", "kind": "timeout"}]},
    "every site": [{"site": s, "index": k} for k, s in enumerate(RF.SITES)],
    "every kind": [{"site": "sigagg.finish", "kind": k, "index": i}
                   for i, k in enumerate(sorted(RF.KINDS))],
    "empty": [],
    "unknown site": [{"site": "sigagg.nowhere"}],
    "no site": [{"index": 1}],
    "unknown kind": [{"site": "sigagg.readback", "kind": "meltdown"}],
    "negative index": [{"site": "sigagg.readback", "index": -1}],
    "zero count": [{"site": "sigagg.readback", "count": 0}],
    "bad json": "[{\"site\": ",
    "index not a number": [{"site": "sigagg.pack", "index": "two"}],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_are_accepted_or_rejected_alike(name):
    assert _outcome(TF, PLANS[name]) == _outcome(RF, PLANS[name])


def test_the_sites_and_kinds_are_the_reference_s():
    assert TF.SITES == RF.SITES
    assert sorted(TF.KINDS) == sorted(RF.KINDS)
    for kind, cls in TF.KINDS.items():
        if kind == "device_lost":
            assert cls is TF.DeviceLostFault and issubclass(cls, RuntimeError)
        else:
            assert cls is RF.KINDS[kind]


def _fires(mod, plan, calls):
    """Arm `plan` and call mod.check over `calls` (sites in order): per call
    None, or the raised exception's kind and text."""
    mod.arm(plan)
    got = []
    for site in calls:
        try:
            mod.check(site)
            got.append(None)
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            kind = "device_lost" if isinstance(exc, mod.DeviceLostFault) else type(exc).__name__
            got.append((kind, str(exc)))
    return got, {s: mod.invocations(s) for s in set(calls)}


WINDOWS = {
    "first call": ([{"site": "sigagg.execute"}], ["sigagg.execute"] * 3),
    "a window of three": ([{"site": "sigagg.pack", "index": 1, "count": 3}],
                          ["sigagg.pack"] * 6),
    "two sites interleaved": ([{"site": "sigagg.readback", "index": 1, "kind": "timeout"},
                               {"site": "sigagg.finish", "index": 0, "msg": "planned"}],
                              ["sigagg.readback", "sigagg.finish"] * 3),
    "every kind in turn": ([{"site": "frost.msm", "index": i, "kind": k}
                            for i, k in enumerate(sorted(RF.KINDS))], ["frost.msm"] * 7),
    "overlapping windows": ([{"site": "sigagg.pack", "index": 0, "count": 2, "kind": "input"},
                             {"site": "sigagg.pack", "index": 1, "count": 2}],
                            ["sigagg.pack"] * 4),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_the_same_invocations_fire(name):
    plan, calls = WINDOWS[name]
    assert _fires(TF, plan, calls) == _fires(RF, plan, calls)


def test_a_json_plan_and_disarm():
    plan = json.dumps([{"site": "sigagg.finish", "index": 1}])
    assert TF.arm(plan).sites == RF.arm(plan).sites == ("sigagg.finish",)
    assert TF.active() and RF.active()
    calls = ["sigagg.finish"] * 3
    assert _fires(TF, plan, calls) == _fires(RF, plan, calls)
    TF.disarm()
    RF.disarm()
    assert not TF.active()
    TF.check("sigagg.finish")                      # disarmed: a no-op
    assert TF.invocations("sigagg.finish") == 0


def test_injected_counts_each_firing_by_site():
    before = TF.injected("sigagg.readback")
    TF.arm([{"site": "sigagg.readback", "index": 1, "count": 2}])
    raised = 0
    for _ in range(5):
        try:
            TF.check("sigagg.readback")
        except TF.DeviceLostFault as exc:
            raised += 1
            assert str(exc).startswith("injected device_lost fault at sigagg.readback[")
    assert raised == 2 and TF.injected("sigagg.readback") == before + 2
    assert TF.invocations("sigagg.readback") == 5
    TF.arm([{"site": "sigagg.readback"}])          # arm resets the invocation counts
    assert TF.invocations("sigagg.readback") == 0
