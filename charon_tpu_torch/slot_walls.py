#!/usr/bin/env python3
"""Walls of the headline fused slot on the card, for one checkout of the port.

    python3 charon_tpu_torch/slot_walls.py [--tree DIR] [--rounds N]
    python3 charon_tpu_torch/slot_walls.py --submit [--deadlines 600,0] [--tree DIR] [--rounds N]
    python3 charon_tpu_torch/slot_walls.py --window [--tree DIR] [--rounds N]

Builds the tree's kernels, signs chip_smoke.py's probe natively (1000
validators x 4-of-6, seed 99, message 0x42 x 32), warms a device-verified
and a native-verified TorchImpl by one slot each (pk plane decoded, H(m)
hashed), then runs N rounds of one steady slot on each rung. It prints one
JSON line: per rung the wall of every round and the slot's phases
(`SlotTimes`: dispatch, readback, emit, verify), each with its median.
With --submit it runs N rounds of four device-verified slots submitted
back to back through threshold_aggregate_verify_submit (the submit front
door) instead, once a round at each watchdog deadline of --deadlines
(CHARON_TPU_SLOT_DEADLINE_S; 0 turns the watchdog off; the order turns
each round), and prints per deadline the milliseconds the four submit
calls took to return and the wall until the fourth result.
With --window it drives the tree's chip_smoke.py duty back half (phase
10's DutyNode, node 1 of 4-of-6) at each of its DUTY_CONFIGS through
the two-duty window of phase 10's tampered round, one warm window and
then N rounds of a clean window and one with peer 3's partial of
validator 0 tampered (the order turns each round), and prints per config
each window's wall from the first set's delivery to the last aggregate
stored, its tbls verify calls (name, items, s) and its flushes.
Run it by its path, so that `--tree` decides which package and which
chip_smoke.py are imported: an older checkout (for instance unpacked with
`git archive`) and this one in turns, on one card, compare
two trees.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

PHASES = ("dispatch", "readback", "emit", "verify")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--submit", action="store_true")
    ap.add_argument("--deadlines", default="600")
    ap.add_argument("--window", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("slot_walls: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from charon_tpu_torch.ops import cuda_plane as CP

    CP.build(force=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"tree": tree, "rounds": args.rounds, "card": smi.strip()}
    if args.window:
        print(json.dumps({**head, "window": window_walls(CS, args.rounds)}))
        return 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        batches, pubkeys, _jobs = CS.gen_cluster(pool)
    datas = [CS.MSG] * CS.N_VALIDATORS
    if args.submit:
        print(json.dumps({**head, "submit": submit_walls(CS, batches, pubkeys, datas, args)}))
        return 0
    impls = {"device": CS.TorchImpl(), "native": CS.TorchImpl(verify="native")}
    got = {rung: {"wall": [], **{p: [] for p in PHASES}} for rung in impls}
    want = None
    for r in range(-1, args.rounds):            # round -1 warms both caches
        for rung, impl in impls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aggs, ok = impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)
            wall = time.perf_counter() - t0
            want = want or [bytes(a) for a in aggs]
            if not ok or [bytes(a) for a in aggs] != want:
                raise SystemExit(f"slot_walls: {rung} slot verdict {ok} or aggregates differ")
            if r >= 0:
                got[rung]["wall"].append(wall)
                for p in PHASES:
                    got[rung][p].append(getattr(impl.last_times, p))
    print(json.dumps({
        **head,
        **{rung: {m: {"median": statistics.median(v), "runs": v} for m, v in by.items()}
           for rung, by in got.items()}}))
    return 0


def submit_walls(CS, batches, pubkeys, datas, args) -> dict:
    """--submit: per deadline, the submit calls' return ms and the wall."""
    import torch

    impl = CS.TorchImpl()
    want = [bytes(a) for a in impl.threshold_aggregate_verify_batch(batches, pubkeys, datas)[0]]
    deadlines = args.deadlines.split(",")
    got = {d: {"return_ms": [], "wall": []} for d in deadlines}
    for r in range(args.rounds):
        for d in deadlines[::1 - 2 * (r % 2)]:
            os.environ["CHARON_TPU_SLOT_DEADLINE_S"] = d
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = [impl.threshold_aggregate_verify_submit(batches, pubkeys, datas)
                    for _ in range(4)]
            returned = time.perf_counter() - t0
            for aggs, ok in (f.result() for f in futs):
                if not ok or [bytes(a) for a in aggs] != want:
                    raise SystemExit(f"slot_walls: a submitted slot (deadline {d}) differs")
            got[d]["return_ms"].append(returned * 1e3)
            got[d]["wall"].append(time.perf_counter() - t0)
    return {d: {m: {"median": statistics.median(v), "runs": v} for m, v in by.items()}
            for d, by in got.items()}


def window_walls(CS, rounds: int) -> dict:
    """--window: per config, the clean and the tampered windows' walls."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        cluster = CS.duty_cluster(pool, max(n for _l, n, _k in CS.DUTY_CONFIGS))
        prev, out = CS.TB._impl, {}
        try:
            for c, (label, n, kinds) in enumerate(CS.DUTY_CONFIGS):
                out[label] = config_windows(CS, pool, cluster, n, kinds,
                                            CS.DUTY_SLOT0 + 64 * c, rounds)
        finally:
            CS.TB._impl = prev
    return out


def config_windows(CS, pool, cluster, n: int, kinds, slot: int, rounds: int) -> dict:
    """One config's windows on a fresh TorchImpl and DutyNode: each holds
    the config's duties of one slot, or its duty and the next slot's, as
    phase 10's tampered round does. Every aggregate must be the root key's
    native signature, and the tampered window's one error peer 3's."""
    import asyncio

    impl = CS.TorchImpl()
    CS.TB.set_implementation(impl)
    calls = []
    for name in ("verify_batch", "verify_batch_each"):
        def counted(*args, _fn=getattr(impl, name), _name=name):
            t0 = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                calls.append((_name, len(args[0]), time.perf_counter() - t0))
        setattr(impl, name, counted)
    chain = CS.duty_chain()
    node = CS.DutyNode(CS.duty_modules(), CS.duty_keys(cluster, n), chain)
    order = ["warm"] + [k for r in range(rounds)
                        for k in (("clean", "tampered"), ("tampered", "clean"))[r % 2]]
    got = {"clean": [], "tampered": []}
    for i, kind in enumerate(order):
        s = slot + 2 * i
        duties = [(k, s) for k in kinds] + ([] if len(kinds) > 1 else [(kinds[0], s + 1)])
        sets = [CS.duty_sets(node.m, pool, cluster, chain, k, ds, n,
                             tamper=3 if kind == "tampered" and j == 0 else None)
                for j, (k, ds) in enumerate(duties)]
        node.errors.clear()
        calls.clear()
        flushed = len(node.flushes)
        t0 = time.perf_counter()
        aggs = asyncio.run(node.deliver([x[:3] for x in sets]))
        wall = time.perf_counter() - t0
        if aggs != CS.duty_expected(pool, cluster, sets, n):
            raise SystemExit(f"slot_walls: a {kind} window's aggregates are not the root keys'")
        errs = [(d, sender) for d, sender, _e in node.errors]
        if errs != ([(sets[0][0], 3)] if kind == "tampered" else []):
            raise SystemExit(f"slot_walls: a {kind} window's verify errors {errs}")
        if kind != "warm":
            got[kind].append({
                "wall_s": wall, "verify_calls": list(calls),
                "flushes": [(k, c, m, round(a - t0, 6), round(b - t0, 6))
                            for k, c, m, a, b in node.flushes[flushed:]]})
    med = {k: statistics.median(r["wall_s"] for r in v) for k, v in got.items()}
    return {"validators": n, "duties": len(duties), "median_s": med,
            "tampered_excess_s": med["tampered"] - med["clean"], **got}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
