#!/usr/bin/env python3
"""Host PyTorch ops and kernel launches of the port's slot dispatch, by step.

    python3 charon_tpu_torch/dispatch_ops.py [--tree DIR] [--validators V] [--device D]

Runs a first and a steady fused slot (V validators x 4-of-6, one message,
signed with the native library) through `plane_agg.fused_slot` on the card,
with each step of its step hook in a `torch.profiler.record_function` range,
and prints each step's kernel launches (the wrapper counters) and the
PyTorch ops the host dispatched in it (the CPU events directly inside the
step's range, by name, the runtime's kernel launches among them). On the
card the wrappers launch through ctypes and run no PyTorch op of their own
beyond their output allocations, so the ops counted are the step's own:
allocations, selects, cats, copies, memsets. Run it by its path, so that
`--tree` decides which package is imported.
`--tree` runs another checkout's `charon_tpu_torch` (for instance an older
commit unpacked with `git archive`), built there. `--device cpu` runs the
plain versions, whose own ops are then counted too: a rehearsal only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import random
import sys


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--validators", type=int, default=64)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from charon_tpu_torch import native
    from charon_tpu_torch.crypto import fields as PF
    from charon_tpu_torch.ops import cuda_plane as CP
    from charon_tpu_torch.ops import plane_agg as PA

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("port_dispatch_ops: no CUDA card", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    lib = native.load_library()
    rng = random.Random(7)
    msg = b"\x42" * 32

    def call(fn, *a, size):
        out = (ctypes.c_uint8 * size)()
        fn(*a, out)
        return bytes(out)

    batches, pks = [], []
    for _ in range(args.validators):
        sk = rng.randrange(1, PF.R)
        coeffs = [sk] + [rng.randrange(PF.R) for _ in range(3)]
        ids = sorted(rng.sample(range(1, 7), 4))
        shares = {i: sum(c * i ** k for k, c in enumerate(coeffs)) % PF.R for i in ids}
        pks.append(call(lib.ct_pubkey, sk.to_bytes(32, "big"), size=48))
        batches.append({i: call(lib.ct_sign, s.to_bytes(32, "big"), msg, len(msg), size=96)
                        for i, s in shares.items()})
    cache = PA.PkPlaneCache()
    layout = PA.layout_slots(batches)
    msgs = [msg] * args.validators
    PA.fused_slot(layout, pks, msgs, device, PA.PkPlaneCache())       # build and warm
    sync()
    for kind in ("first", "steady"):
        steps, launches, open_range = [], [], []

        def mark(name):
            open_range.pop().__exit__(None, None, None)
            sync()
            launches.append(sum(launches_of(k) for k in CP.KERNELS.values()))
            CP.reset_counts()
            steps.append(name)
            rf = record_function(f"step {len(steps)}")
            rf.__enter__()
            open_range.append(rf)

        CP.reset_counts()
        launches_of = (lambda k: sum(k.launches.values())) if device.type == "cuda" else \
            (lambda k: sum(k.plain_calls.values()))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rf = record_function("step 0")
            rf.__enter__()
            open_range.append(rf)
            state = PA.fused_slot(layout, pks, msgs, device, cache, mark=mark)
            open_range.pop().__exit__(None, None, None)
        if state[0] != "pending":
            raise SystemExit(f"the slot ended as {state[0]!r}")
        ops = collections.defaultdict(collections.Counter)
        for ev in prof.events():
            parent = ev.cpu_parent
            if parent is not None and parent.name.startswith("step "):
                ops[int(parent.name.split()[1])][ev.name] += 1
        for k, name in enumerate(steps):
            every = ", ".join(f"{op} {c}" for op, c in ops[k].most_common())
            print(f"{kind} slot, {name}: {launches[k]} launches, {sum(ops[k].values())} host "
                  f"PyTorch ops ({every})")
    print(f"tree {os.path.abspath(args.tree)}; "
          f"{torch.cuda.get_device_name(0) if device.type == 'cuda' else 'CPU'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
