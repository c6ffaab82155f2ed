#!/usr/bin/env python3
"""Walls of the headline fused slot on the card, for one checkout of the port.

    python3 charon_tpu_torch/slot_walls.py [--tree DIR] [--rounds N]
    python3 charon_tpu_torch/slot_walls.py --submit [--deadlines 600,0] [--tree DIR] [--rounds N]

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
    with ThreadPoolExecutor(max_workers=8) as pool:
        batches, pubkeys, _jobs = CS.gen_cluster(pool)
    datas = [CS.MSG] * CS.N_VALIDATORS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"tree": tree, "rounds": args.rounds, "card": smi.strip()}
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
